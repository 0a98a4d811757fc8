"""The soft-term relaxation loop of TorchSolver against TPUSolver's.

Pods with soft terms (preferred node affinity, preferred pod affinity,
ScheduleAnyway spread) are solved with every soft term enforced, and the
pods that strand get their weakest term dropped and the whole input
re-solved, round by round, bounded by the total count of soft terms and
by a per-solve wall-clock budget (KARPENTER_TPU_RELAX_BUDGET) that the
split path's nested solves inherit.  Every comparison here is exact: the
canonical result of `tests/test_torch_solve.py` (claims, existing-node
assignments, unschedulable pods with their reason codes, the total price
as a float hex) must be equal.
"""

import pytest
import torch

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu_torch.solver import TorchSolver
from tests.test_solver_fuzz import _gen_problem_mixed
from tests.test_torch_encode import JAX, PORT
from tests.test_torch_solve import canon, headline, jax_solver
from tests.test_torch_sweep import _port_inputs, _unsupported_inputs

SEEDS = range(1000, 1024)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scans on one intra-op thread, restored after the module
    (the other test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_mixed_fuzz_matches_reference(seed):
    """`_gen_problem_mixed` (preferences, preferred affinity, ScheduleAnyway
    spread among hard terms): the port no longer refuses any of them and
    gives the reference's canonical result, price hex and reason codes."""
    ref = jax_solver().solve(_gen_problem_mixed(seed))
    port = TorchSolver(device="cpu")
    got = port.solve(_port_inputs([_gen_problem_mixed(seed)])[0])
    assert canon(got) == canon(ref)
    assert float(got.total_price()).hex() == float(ref.total_price()).hex()
    assert port._relax_deadline is None


def _stranding_soft(ns, n=40):
    """Pods whose preferred zone no pool offers stay unschedulable until
    the preference is dropped: at least two rounds."""
    M, wk = ns.M, ns.M.wellknown
    inp = headline(ns, n)
    for p in inp.pods[:6]:
        p.preferences = [
            (50, M.Requirements(M.Requirement.make(
                wk.ZONE_LABEL, "In", "nowhere-1"))),
            (10, M.Requirements(M.Requirement.make(
                wk.ZONE_LABEL, "In", "nowhere-2")))]
    return inp


@pytest.mark.parametrize("budget", ["0", "off"])
def test_budget_exit_matches_reference(monkeypatch, budget):
    """KARPENTER_TPU_RELAX_BUDGET=0 ends the loop after its first round
    with stragglers left: they go to the rescue oracle on their original
    soft semantics, as in the reference ("off" is unbounded)."""
    monkeypatch.setenv("KARPENTER_TPU_RELAX_BUDGET", budget)
    ref = jax_solver().solve(_stranding_soft(JAX))
    port = TorchSolver(device="cpu")
    assert port.relax_budget_s == (0.0 if budget == "0" else None)
    got = port.solve(_stranding_soft(PORT))
    assert canon(got) == canon(ref)
    assert port.relax_counts["solves"] == 1
    assert port.relax_counts["budget_exceeded"] == (budget == "0")
    assert port.relax_counts["rounds"] == (1 if budget == "0" else 3)


def test_relax_budget_knob_grammar(monkeypatch):
    """The knob as the reference reads it: seconds, "", none or off for
    unbounded, the default for a malformed value."""
    for raw, want in (("2.5", 2.5), ("", None), ("none", None),
                      ("OFF", None), ("soon", 30.0)):
        monkeypatch.setenv("KARPENTER_TPU_RELAX_BUDGET", raw)
        assert TorchSolver(device="cpu").relax_budget_s == want
        assert TPUSolver(mesh="off").relax_budget_s == want
    monkeypatch.delenv("KARPENTER_TPU_RELAX_BUDGET")
    assert TorchSolver(device="cpu").relax_budget_s == 30.0


def _split_soft(ns):
    """A soft-term class beside a class the encoding cannot express (a
    custom topology key): each round's attempt takes the split path, whose
    device half solves the soft class through a nested relaxation loop."""
    M = ns.M
    inp = _stranding_soft(ns, 60)
    for p in inp.pods[-3:]:
        p.meta.labels["app"] = "rack"
        p.topology_spread = [M.TopologySpreadConstraint(
            topology_key="example.com/rack", max_skew=1,
            label_selector={"app": "rack"})]
    return inp


def test_split_path_inherits_the_deadline(monkeypatch):
    """The deadline is per solve: the outermost call sets it, the split
    path's nested calls see the same value and set none of their own, and
    it is cleared when the solve returns."""
    ref = jax_solver().solve(_split_soft(JAX))
    port = TorchSolver(device="cpu")
    real = port._solve_relaxed
    seen = []

    def spy(inp, max_nodes=None):
        seen.append(port._relax_deadline)
        return real(inp, max_nodes=max_nodes)

    monkeypatch.setattr(port, "_solve_relaxed", spy)
    got = port.solve(_split_soft(PORT))
    assert canon(got) == canon(ref)
    assert port._used_split
    assert seen[0] is None and len(seen) > 1
    assert all(d is not None and d == seen[1] for d in seen[1:])
    assert port._relax_deadline is None
    assert port.relax_counts["solves"] == 1


@pytest.mark.parametrize("max_nodes", [8, None], ids=["capped", "uncapped"])
def test_solve_batch_with_soft_inputs(max_nodes):
    """solve_batch batches round 0 (every soft term enforced) and sends
    the stragglers through solve's relaxation loop, as the reference."""
    name = "soft-term-straggler"
    ref = TPUSolver(mesh="off", delta="off", spec="off", incr="off"
                    ).solve_batch(_unsupported_inputs("karpenter_tpu")[name],
                                  max_nodes=max_nodes)
    port = TorchSolver(device="cpu")
    got = port.solve_batch(_unsupported_inputs()[name], max_nodes=max_nodes)
    assert [canon(r) for r in got] == [canon(r) for r in ref]
    assert port.relax_counts["solves"] == 1


def test_chip_smoke_soft_input_is_the_reference():
    """chip_smoke.SOFT is the JAX answer on `workloads.build_soft_terms`
    built from the JAX package's classes; the port gives it in rounds."""
    import chip_smoke
    import karpenter_tpu.models as jm
    import karpenter_tpu.scheduling as js
    from karpenter_tpu.providers import generate_catalog
    from karpenter_tpu_torch.workloads import build_soft_terms
    ref = jax_solver().solve(build_soft_terms(jm, js, generate_catalog()))
    port = TorchSolver(device="cpu")
    got = port.solve(build_soft_terms())
    nodes, unsched, price_hex, digest = chip_smoke.SOFT
    for res in (ref, got):
        assert (res.node_count(), len(res.unschedulable),
                float(res.total_price()).hex()) == (nodes, unsched,
                                                    price_hex)
        assert chip_smoke.result_digest(res) == digest
    assert canon(got) == canon(ref)
    assert port.relax_counts["rounds"] == 3
