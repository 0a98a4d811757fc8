"""Gang units in the port against the JAX package, on the CPU, where the
port's kernel wrappers run their plain PyTorch versions.

  * the scan: seeded gang problems (`random_problem(gang=True)`: gangs over
    zones, capacity types and no domain, existing nodes in and out of the
    domain, binding pool limits, tied trial ranks, slot exhaustion, gangs
    larger than any domain) through the JAX `ffd.solve_ffd` and
    `solve_ffd_batch` with `with_gang=1` and the port's `solve_ffd` and
    `solve_ffd_batch` (K5's gang instance's plain version, and K2's with
    the with_gang whole class): the flat result rows must be equal as
    uint32;
  * the solve: the scenarios of `tests/test_solver_gang.py`
    `TestGangKernel` and `TestGangRepairNet` and seeds of
    `tests/test_solver_fuzz.py` `_gen_problem_gang`, built with the JAX
    package's classes and rebuilt with the port's (`to_port`), through
    `TPUSolver` and `TorchSolver(device="cpu")`: canonical results (reason
    codes included) and gang audits equal;
  * BASELINE config #9 at full scale, against the JAX package's answer
    and `chip_smoke.py`'s constants.
"""

import numpy as np
import pytest

import chip_smoke
from karpenter_tpu.scheduling.types import gang_placement_audit as jaudit
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.scheduling.types import gang_placement_audit
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.problems import random_batch, random_problem
from tests import test_solver_fuzz, test_solver_gang as sg
from tests.test_torch_ffd import _jax_args
from tests.test_torch_solve import canon, jax_solver
from tests.test_torch_sweep import _port_inputs

GANG = dict(gang=True, D=4)
# (id, seed, random_problem kwargs, N): one padded shape but for the
# slot-exhaustion case, so the JAX program compiles twice
SCAN_CASES = [
    ("zone-rack-free", 2, dict(GANG, topology=True), 64),
    ("existing-in-domain", 4, GANG, 64),
    ("binding-limits", 5, dict(GANG, limits="finite"), 64),
    ("beyond-any-domain", 7, dict(GANG, limits="finite"), 64),
    ("tied-ranks", 4, dict(GANG, tied_ranks=True), 64),
    ("slot-exhaustion", 6, GANG, 8),
]


def _scan_both(seed, kw, N):
    prob, cat = random_problem(seed, **kw)
    ref = np.asarray(jffd.solve_ffd(
        *_jax_args(prob, cat, False), max_nodes=N, zc=cat["zc"],
        explain=1, with_gang=1))
    p, c = tffd.problem_from_numpy(prob, cat, "cpu")
    out = tffd.solve_ffd(p, c, N, explain=1, with_gang=1).numpy()
    G, E, D = prob[0].shape[0], prob[4].shape[0], prob[8].shape[1]
    return prob, ref, out, tffd.unpack(out, G, E, N, 6, D, explain=1)


def _gangs(prob, u):
    """Per gang group: (dsel, count, placed, existing take, dom_placed)."""
    return [(int(prob[7][g]), int(prob[1][g]), u["unsched"][g] == 0,
             u["take_exist"][g].sum(), u["dom_placed"][g])
            for g in np.nonzero(prob[14])[0]]


@pytest.mark.parametrize("case", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_gang_scan_matches_jax_bitwise(case):
    name, seed, kw, N = case
    prob, ref, out, u = _scan_both(seed, kw, N)
    assert out.dtype == np.float32 and out.shape == ref.shape
    differ = np.nonzero(ref.view(np.uint32) != out.view(np.uint32))[0]
    assert differ.size == 0, (name, differ[:10], ref[differ[:10]],
                              out[differ[:10]])
    gangs = _gangs(prob, u)
    assert gangs
    # every gang all-or-nothing: placed whole or stranded whole
    for g in np.nonzero(prob[14])[0]:
        assert u["unsched"][g] in (0, prob[1][g])
    if name == "zone-rack-free":
        assert {d for d, _, placed, _, _ in gangs if placed} == {0, 1, 2}
    if name == "existing-in-domain":
        assert any(placed and te > 0 and d > 0
                   for d, _, placed, te, _ in gangs)
    if name == "binding-limits":
        assert np.isfinite(prob[5]).any()
        assert any(not placed and 0 < dp.max() < cnt and cnt < 150
                   for _, cnt, placed, _, dp in gangs)
    if name == "beyond-any-domain":
        assert any(not placed and cnt > dp.max() and cnt > 150
                   for _, cnt, placed, _, dp in gangs)
    if name == "tied-ranks":
        assert not prob[8][prob[14]].any()
    if name == "slot-exhaustion":
        assert u["num_active"] == N
        assert any(not placed and cnt < 150 for _, cnt, placed, _, _ in gangs)


def test_gang_rows_are_pinned_to_the_winner():
    """A placed zone or capacity-type gang pins every node it touched to
    its one domain, and reports each domain's candidate total saturated at
    the gang size."""
    prob, _, _, u = _scan_both(2, dict(GANG, topology=True), 64)
    seen = 0
    for g in np.nonzero(prob[14])[0]:
        dsel, cnt = int(prob[7][g]), int(prob[1][g])
        nodes = np.nonzero(u["take_new"][g])[0]
        if dsel == 0 or u["unsched"][g] or not len(nodes):
            continue
        pins = u["node_zone" if dsel == 1 else "node_ct"][nodes]
        assert len(set(pins.tolist())) == 1
        assert u["dom_placed"][g].max() == cnt
        seen += 1
    assert seen


def test_gang_batch_matches_jax_bitwise():
    """`solve_ffd_batch` with the gang static: three seeded gang problems
    stacked, against the JAX batched program."""
    probs, cat = random_batch(2, 3, **GANG)
    per = [_jax_args(p, cat, False) for p in probs]
    args = [np.stack([a[i] for a in per]) if ax == 0 else per[0][i]
            for i, ax in enumerate(jffd._BATCH_AXES)]
    ref = np.asarray(jffd.solve_ffd_batch(*args, max_nodes=64,
                                          zc=cat["zc"], explain=1,
                                          with_gang=1))
    c = tffd.catalog_tensors(cat, "cpu")
    out = tffd.solve_ffd_batch(tffd.batch_tensors(probs, c.O, "cpu"), c, 64,
                               1, with_gang=1).numpy()
    assert np.array_equal(ref.view(np.uint32), out.view(np.uint32))
    assert sum(int(p[14].sum()) for p in probs) >= 3


def test_gang_free_problems_keep_the_gang_free_instance(monkeypatch):
    """A problem without a gang group launches the gang-free instance (the
    reference's with_gang=0 program) through the solver; one with a gang
    the gang instance."""
    calls = []
    real = tffd.batch_scan

    def spy(*a, **kw):
        calls.append(a[7] if len(a) > 7 else kw.get("with_gang", 0))
        return real(*a, **kw)

    monkeypatch.setattr(tffd, "batch_scan", spy)
    solver = TorchSolver(device="cpu")
    solver.solve(_port_inputs([sg.mkinp([sg.singleton(f"s-{i}")
                                         for i in range(6)])])[0])
    solver.solve(_port_inputs([sg.mkinp([sg.gang_pod(f"g-{i}", "mpi", 4)
                                         for i in range(4)])])[0])
    assert calls == [0, 1]


# -- the solve ------------------------------------------------------------------
def _kernel_scenarios():
    """The inputs of tests/test_solver_gang.py TestGangKernel, built with
    the JAX package's classes (the test's own helpers)."""
    from karpenter_tpu.models import (Requirement, Requirements, Resources,
                                      TopologySpreadConstraint, wellknown)
    gp, single, mk = sg.gang_pod, sg.singleton, sg.mkinp

    def zone_req():
        pods = [gp(f"g-{i}", "mpi", 4) for i in range(4)]
        for p in pods:
            p.requirements = Requirements(
                Requirement.make(sg.ZONE, "In", "tpu-west-1b"))
        return mk(pods)

    return {
        "single-node": lambda: mk([gp(f"g-{i}", "mpi", 4)
                                   for i in range(4)]),
        "multi-node-single-zone": lambda: mk([
            gp(f"g-{i}", "mpi", 16, cpu="12", mem="24Gi")
            for i in range(16)]),
        "rack-axis": lambda: mk([gp(f"g-{i}", "mpi", 6, dom="rack")
                                 for i in range(6)]),
        "domain-free": lambda: mk([gp(f"g-{i}", "mpi", 4, dom="none")
                                   for i in range(4)]),
        "mixed-gangs-singletons": lambda: mk(
            [gp(f"a-{i}", "mpi-a", 8) for i in range(8)]
            + [gp(f"b-{i}", "mpi-b", 3, cpu="4", mem="8Gi")
               for i in range(3)]
            + [single(f"s-{i}") for i in range(40)]),
        "member-zone-requirement": zone_req,
        "incomplete-waits": lambda: mk([gp(f"g-{i}", "mpi", 8)
                                        for i in range(5)]),
        "too-large": lambda: mk(
            [gp(f"g-{i}", "mpi", 6, cpu="4", mem="9000Gi")
             for i in range(6)] + [single(f"s-{i}") for i in range(5)]),
        "partial-capacity-limit": lambda: mk(
            [gp(f"g-{i}", "mpi", 8, cpu="4", mem="8Gi") for i in range(8)],
            remaining_limits={"default": Resources.limits(cpu=14000)}),
        "heterogeneous-split": lambda: mk(
            [gp(f"a-{i}", "mix", 6) for i in range(4)]
            + [gp(f"b-{i}", "mix", 6, cpu="4", mem="8Gi")
               for i in range(2)]
            + [single(f"s-{i}") for i in range(6)]),
        "gang-with-spread-split": lambda: mk(
            [gp(f"g-{i}", "mpi", 4, topology_spread=[
                TopologySpreadConstraint(
                    topology_key=wellknown.HOSTNAME_LABEL, max_skew=2,
                    label_selector={})]) for i in range(4)]
            + [single(f"s-{i}") for i in range(4)]),
    }


SCENARIOS = _kernel_scenarios()


def _audit_canon(audit):
    return sorted((g, a["total"], a["placed"], sorted(a["stranded"]),
                   sorted(a["domains"], key=str), sorted(a["unpinned"]))
                  for g, a in audit.items())


def _assert_same(inp, ref, got, port_inp):
    assert canon(got) == canon(ref)
    assert _audit_canon(gang_placement_audit(port_inp, got)) \
        == _audit_canon(jaudit(inp, ref))
    for a in gang_placement_audit(port_inp, got).values():
        assert a["placed"] in (0, a["total"])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gang_solve_matches_reference(name):
    inp = SCENARIOS[name]()
    ref = jax_solver().solve(inp)
    port_inp = _port_inputs([inp])[0]
    port = TorchSolver(device="cpu")
    got = port.solve(port_inp)
    _assert_same(inp, ref, got, port_inp)
    assert port.gang_repairs == 0
    if name == "too-large":
        tree = got.unschedulable["g-0"].tree
        gt = tree.get("gang") or tree.get("kernel", {}).get("gang")
        assert gt and gt["deficit_members"] == 6
        assert tree == ref.unschedulable["g-0"].tree
    if name.endswith("-split"):
        assert port._used_split


def test_gang_knob_off_places_independently(monkeypatch):
    """With KARPENTER_TPU_GANG=off the gang annotations are inert on both
    sides: an incomplete gang places as plain pods."""
    monkeypatch.setenv("KARPENTER_TPU_GANG", "off")
    inp = sg.mkinp([sg.gang_pod(f"g-{i}", "mpi", 8) for i in range(5)])
    ref = jax_solver().solve(inp)
    got = TorchSolver(device="cpu").solve(_port_inputs([inp])[0])
    assert canon(got) == canon(ref) and not got.unschedulable


def _repair_case(cross_domain: bool):
    """TestGangRepairNet's fabricated partial (or cross-domain) gang rows
    from a real encoding of the same input on each side."""
    from karpenter_tpu.solver.encode import encode, encode_catalog
    from karpenter_tpu_torch.solver.encode import encode as tencode
    from karpenter_tpu_torch.solver.encode import encode_catalog as tcat
    inp = sg.mkinp([sg.gang_pod(f"g-{i}", "mpi", 4) for i in range(4)])
    port_inp = _port_inputs([inp])[0]
    outs = []
    for enc in (encode(inp, encode_catalog(inp)),
                tencode(port_inp, tcat(port_inp))):
        N = 8
        out = {
            "take_exist": np.zeros((1, 0), np.float32),
            "take_new": np.zeros((1, N), np.float32),
            "unsched": np.zeros(1, np.float32),
            "used": np.zeros((N, enc.group_req.shape[1]), np.float32),
            "node_pool": np.zeros(N, np.int32),
            "node_zone": np.zeros(N, np.int32),
            "node_ct": np.zeros(N, np.int32),
            "num_active": 2 if cross_domain else 1,
            "dom_placed": np.zeros((1, enc.n_domains), np.float32),
        }
        out["take_new"][0, 0] = 2
        out["used"][0] = 2 * enc.group_req[0]
        if cross_domain:
            out["take_new"][0, 1] = 2
            out["used"][1] = 2 * enc.group_req[0]
            out["node_zone"][1] = 1
        outs.append((enc, out))
    return outs


@pytest.mark.parametrize("cross_domain", [False, True],
                         ids=["partial", "cross-domain"])
def test_gang_repair_net_matches_reference(cross_domain):
    """The host atomicity net rolls a partial or cross-domain gang back
    exactly as the reference's does: takes zeroed, used released, the
    members stranded, one repair counted."""
    (jenc, jout), (tenc, tout) = _repair_case(cross_domain)
    jax_solver()._repair_gang(jenc, jout)
    port = TorchSolver(device="cpu")
    port._repair_gang(tenc, tout)
    for k in jout:
        assert np.array_equal(np.asarray(jout[k]), np.asarray(tout[k])), k
    assert tout["take_new"][0].sum() == 0
    assert tout["unsched"][0] == (4 if cross_domain else 2)
    assert port.gang_repairs == 1


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_gang_fuzz_seed_matches_reference(seed):
    inp = test_solver_fuzz._gen_problem_gang(seed)
    ref = jax_solver().solve(inp)
    port_inp = _port_inputs([inp])[0]
    got = TorchSolver(device="cpu").solve(port_inp)
    _assert_same(inp, ref, got, port_inp)


def test_config9_matches_reference():
    """BASELINE config #9 at full scale (1,082 pods: 10 gangs of 2-64
    members, an 8-of-9 waiting gang, 800 singletons): the port's
    workloads.build_config9 and the benchmark's make_input solve to the
    JAX package's answer — the one chip_smoke.py holds the card to —
    with jumbo and waiting stranded whole and every other gang placed in
    one domain."""
    from benchmarks.config9_gang import make_input
    from karpenter_tpu_torch.workloads import build_config9
    jinp = make_input()
    ref = TPUSolver(max_nodes=chip_smoke.CONFIG_MAX_NODES, mesh="off",
                    delta="off", spec="off", incr="off").solve(jinp)
    port = TorchSolver(max_nodes=chip_smoke.CONFIG_MAX_NODES, device="cpu")
    inp = build_config9()
    assert [(p.meta.name, tuple(p.requests.v),
             sorted(p.meta.annotations.items())) for p in inp.pods] == [
        (p.meta.name, tuple(p.requests.v),
         sorted(p.meta.annotations.items())) for p in jinp.pods]
    got = port.solve(inp)
    nodes, unsched, price_hex, digest, trees = chip_smoke.CONFIG9
    assert canon(got) == canon(ref)
    assert (got.node_count(), len(got.unschedulable),
            float(got.total_price()).hex()) == (nodes, unsched, price_hex)
    assert chip_smoke.result_digest(got) == digest \
        == chip_smoke.result_digest(ref)
    assert chip_smoke.trees_digest(got) == trees \
        == chip_smoke.trees_digest(ref)
    audit = gang_placement_audit(inp, got)
    assert tuple(sorted(g for g, a in audit.items() if a["placed"] == 0)) \
        == chip_smoke.CONFIG9_STRANDED_GANGS
    for a in audit.values():
        assert a["placed"] in (0, a["total"])
        if a["placed"] and a["spec"].domain_key is not None:
            assert not a["unpinned"] and len(a["domains"]) == 1
    assert port.gang_repairs == 0
