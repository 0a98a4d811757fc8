"""TorchSolver.warmup: after a warm-up, a solve at a warmed shape meets no
first-use event (`karpenter_tpu_torch.solver.firstuse`: kernel builds and
loads, catalog uploads, pinned staging slots, new launch configurations,
mask-table tiers) — the port's counterpart of the JAX package's
zero-retrace checks (`tests/test_solver_pipeline.py` TestWarmup,
`tests/test_mesh_solver.py` TestMeshWarmupGate, `tests/test_solver_delta.py`
TestDeltaWarmup).  On the CPU the wrappers run their plain versions; the
launch configurations are counted all the same, so the lattice's coverage
is held here and its cost on the card in chip_smoke.py phase 18.

Inputs come from the JAX package's test helpers, rebuilt from the port's
classes by `to_port` with one memo per test, so every input of a test
shares one catalog list (the solver's catalog cache keys on its
identity, as the instance-type provider's list keeps it).
"""

import pytest

from karpenter_tpu_torch.solver import TorchSolver, firstuse
from tests import test_solver_delta as sd
from tests import test_solver_pipeline as sp
from tests.test_torch_solve import canon
from tests.test_torch_sweep import to_port


def port(obj, memo):
    """`to_port` with the test's memo, keeping the JAX object alive: the
    memo keys on object ids, which a freed object would hand on."""
    memo.setdefault("keep", []).append(obj)
    return to_port(obj, memo)


def _pipe_input(prefix, n, existing=0, memo=None, **pod):
    nodes = sp.mkcluster(existing) if existing else []
    return port(sp.mkinput([sp.mkpod(f"{prefix}{i}", **pod)
                            for i in range(n)], existing_nodes=nodes),
                memo)


def test_zero_first_use_after_warmup():
    memo = {}
    inp = _pipe_input("wu", 30, existing=5, memo=memo, cpu="1", mem="2Gi")
    solver = TorchSolver(device="cpu", max_nodes=64)
    assert solver.warmup(inp) > 0
    before = firstuse.snapshot()
    res = solver.solve(inp)
    assert not res.unschedulable
    assert firstuse.snapshot() == before
    # the second solve starts from the node-axis warm start: still warm
    res = solver.solve(inp)
    assert not res.unschedulable
    assert firstuse.snapshot() == before


def test_a_cold_solver_counts_its_first_uses():
    memo = {}
    inp = _pipe_input("cf", 12, memo=memo)
    before = firstuse.total()
    TorchSolver(device="cpu", max_nodes=64).solve(inp)
    # at least the catalog upload of the new solver
    assert firstuse.total() > before


def test_warmup_covers_extra_shape_buckets():
    memo = {}
    inp = _pipe_input("wx", 4, memo=memo, cpu="1", mem="2Gi")
    solver = TorchSolver(device="cpu", max_nodes=64)
    solver.warmup(inp, shapes=((20, 0),))
    # 20 distinct pod classes land in the G bucket the shapes= point
    # covered, not the tiny bucket `inp` itself lands in
    big = port(sp.mkinput([sp.mkpod(f"wy{g}-{i}", cpu=f"{100 + g * 50}m",
                                       mem="1Gi")
                              for g in range(20) for i in range(2)]), memo)
    before = firstuse.snapshot()
    res = solver.solve(big)
    assert not res.unschedulable
    assert firstuse.snapshot() == before


def test_warmup_batch_lane():
    memo = {}
    inp = _pipe_input("wb", 6, memo=memo, cpu="1", mem="2Gi")
    solver = TorchSolver(device="cpu", max_nodes=64)
    solver.warmup(inp, batch_sizes=(3,))
    before = firstuse.snapshot()
    out = solver.solve_batch([inp, inp, inp])
    assert all(not r.unschedulable for r in out)
    assert firstuse.snapshot() == before


def test_warmup_never_poisons_solver_state():
    memo = {}
    inp = _pipe_input("wp", 10, memo=memo)
    ref = TorchSolver(device="cpu").solve(inp)
    solver = TorchSolver(device="cpu", max_nodes=64)
    solver.warmup(inp)
    assert solver._last_active is None
    assert solver._delta_cache.last_outcome is None
    assert canon(solver.solve(inp)) == canon(ref)


def test_warmup_under_a_mesh():
    # the mesh executor's launch configurations and the mask-row table's
    # tier are paid by the warm-up: two solves after it meet none
    memo = {}
    inp = _pipe_input("w", 24, existing=3, memo=memo, cpu="1", mem="2Gi")
    solver = TorchSolver(device="cpu", mesh=8, max_nodes=64)
    assert solver.warmup(inp) > 0
    before = firstuse.snapshot()
    for _ in range(2):
        assert not solver.solve(inp).unschedulable
    assert firstuse.snapshot() == before


def test_warmup_batch_sizes_under_a_mesh():
    # the batched solve reads the dense masks under a mesh too: its warm
    # problem is the dense one, and the results still match mesh off
    memo = {}
    inp = _pipe_input("b", 10, existing=2, memo=memo)
    solver = TorchSolver(device="cpu", mesh=8, max_nodes=64)
    assert solver.warmup(inp, batch_sizes=(1,)) > 0
    ref = TorchSolver(device="cpu", mesh="off").solve_batch([inp],
                                                            max_nodes=64)
    got = solver.solve_batch([inp], max_nodes=64)
    assert [canon(x) for x in got] == [canon(x) for x in ref]


def test_delta_shapes_warm_the_seeded_scan():
    memo = {}
    existing = sd.mknodes(3)
    on = TorchSolver(device="cpu", max_nodes=64, delta="on")
    inp = port(sd.mkinput(list(sd.churn_pods(0)), existing), memo)
    on.solve(inp)  # fills the delta record
    rec = on._delta_cache.get(on._catalog_encoding(inp))
    assert rec is not None
    assert on.warmup(inp, delta_shapes=((3, rec.num_active),)) > 0
    before = firstuse.snapshot()
    res = on.solve(port(sd.mkinput(list(sd.churn_pods(1)), existing),
                        memo))
    assert on._delta_cache.last_outcome == "delta"
    assert not res.unschedulable
    assert firstuse.snapshot() == before


def test_gated_solver_warmup_is_best_effort():
    from karpenter_tpu_torch.controllers.state import GatedSolver

    class _Opts:
        class feature_gates:
            tpu_solver = True
    gs = GatedSolver.__new__(GatedSolver)
    gs.options = _Opts()

    class _Boom:
        def warmup(self, inp, shapes=()):
            raise RuntimeError("device fell over")
    gs.tpu = _Boom()
    assert gs.warmup(None) == 0  # degrade, never raise
    gs.tpu = object()            # no warmup at all
    assert gs.warmup(None) == 0
    _Opts.feature_gates.tpu_solver = False
    assert gs.warmup(None) == 0


def test_gated_solver_warmup_raises_on_the_card():
    """On the card a warm-up failure (a kernel that does not build or
    launch) reaches the caller: it is not degraded to a cold start."""
    import torch

    from karpenter_tpu_torch.controllers.state import GatedSolver

    class _Opts:
        class feature_gates:
            tpu_solver = True
    gs = GatedSolver.__new__(GatedSolver)
    gs.options = _Opts()

    class _Boom:
        device = torch.device("cuda")

        def warmup(self, inp, shapes=()):
            raise RuntimeError("nvcc failed")
    gs.tpu = _Boom()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gs.warmup(None)


def test_firstuse_rejects_unknown_kinds():
    with pytest.raises(ValueError):
        firstuse.note("compile")
