"""Priority bands and preemption in the port against the JAX package, on
the CPU, where the port's kernel wrappers run their plain PyTorch
versions.

  * the witness: seeded problems in the 18-slot priority-band form
    (`random_problem(priority=True)`) through the JAX `ffd.solve_ffd` and
    `solve_ffd_batch` with `with_priority=1` and the port's: the flat
    rows, the inversion witness last, equal as uint32;
  * the verdicts: the `PriorityBandExhausted` reclassification the
    witness gates, on one encoding from each package;
  * the planner: the scenarios of `tests/test_priority.py`
    `TestBandPacking` and `TestPreemptionPlanner`, built with the JAX
    package's classes and rebuilt with the port's, through `TPUSolver`
    or the JAX oracle and `TorchSolver(device="cpu")` or the port's
    oracle: canonical results and preemption plans (ids, targets,
    victims) equal;
  * BASELINE config #10 at full scale — its spot storm recorded by both
    packages' risk models alike — against the JAX package's answer,
    plans and `chip_smoke.py`'s constants, with an empty priority
    inversion audit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from karpenter_tpu.scheduling import Scheduler as JScheduler
from karpenter_tpu.scheduling import risk as jrisk
from karpenter_tpu.scheduling.types import PRIORITY_CLASSES
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.scheduling import Scheduler, risk
from karpenter_tpu_torch.scheduling.types import priority_inversion_audit
from karpenter_tpu_torch.scheduling.types import \
    PRIORITY_CLASSES as T_PRIORITY_CLASSES
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import explain as explainmod
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.problems import random_batch, random_problem
from tests import test_priority as tp
from tests.test_torch_ffd import _jax_args
from tests.test_torch_solve import canon, jax_solver
from tests.test_torch_sweep import _port_inputs

SYSTEM_CLASSES = {"system-cluster-critical", "system-node-critical"}


@pytest.fixture(autouse=True)
def _clean_model():
    """Both packages' spot-risk models empty and their priority-class
    tables at the shipped classes, before and after each test."""
    def clean():
        for r in (jrisk, risk):
            r.reset()
        for table in (PRIORITY_CLASSES, T_PRIORITY_CLASSES):
            for k in set(table) - SYSTEM_CLASSES:
                table.pop(k, None)
    clean()
    yield
    clean()


# -- the witness ------------------------------------------------------------------
PRIO = dict(priority=True, limits="finite")
# (id, seed, random_problem kwargs)
WITNESS_CASES = [
    ("bands-strand", 12, dict(PRIO, pod_scale=300)),
    ("bands-topology", 3, dict(PRIO, topology=True, D=4, pod_scale=300)),
    ("bands-gangs", 7, dict(PRIO, gang=True, topology=True, D=4)),
]


def _witness_case(seed, kw):
    prob, cat = random_problem(seed, **kw)
    wg = int(prob[14].any())
    ref = np.asarray(jffd.solve_ffd(
        *_jax_args(prob, cat, False), prob[17], max_nodes=64, zc=cat["zc"],
        explain=1, with_gang=wg, with_priority=1))
    p, c = tffd.problem_from_numpy(prob, cat, "cpu")
    out = tffd.solve_ffd(p, c, 64, explain=1, with_gang=wg,
                         with_priority=1).numpy()
    G, E, D = prob[0].shape[0], prob[4].shape[0], prob[8].shape[1]
    return prob, ref, out, tffd.unpack(out, G, E, 64, 6, D, explain=1,
                                       with_priority=1)


@pytest.mark.parametrize("case", WITNESS_CASES,
                         ids=[c[0] for c in WITNESS_CASES])
def test_witness_matches_jax_bitwise(case):
    name, seed, kw = case
    prob, ref, out, u = _witness_case(seed, kw)
    assert np.array_equal(ref.view(np.uint32), out.view(np.uint32)), name
    # the witness row is the reference's definition on the unpacked rows
    G = prob[0].shape[0]
    expect = tffd.priority_witness(
        torch.from_numpy(prob[1]), torch.from_numpy(
            u["unsched"].astype(np.int32)), torch.from_numpy(prob[17]))
    assert np.array_equal(u["prio_inv"], expect.numpy())
    assert u["prio_inv"].shape == (G,)
    assert len(set(prob[17].tolist())) > 1


def test_witness_cases_fire():
    """Across the cases the witness marks at least one group placed after
    a higher band stranded, and leaves single-band rows clear."""
    fired = sum(int(_witness_case(seed, kw)[3]["prio_inv"].sum())
                for _, seed, kw in WITNESS_CASES)
    assert fired > 0


def test_witness_plain_version():
    count = torch.tensor([4, 3, 5, 2, 6, 0], dtype=torch.int32)
    unsched = torch.tensor([0, 3, 2, 0, 0, 0], dtype=torch.int32)
    prio = torch.tensor([9, 7, 7, 5, 7, 0], dtype=torch.int32)
    # group 2 placed 3 after group 1 (7) stranded: not strictly lower;
    # group 3 (5) placed after a 7 stranded: inversion; group 4 (7): no;
    # group 5 placed nothing
    assert tffd.priority_witness(count, unsched, prio).tolist() == [
        False, False, False, True, False, False]


def test_witness_batch_with_a_single_band_entry():
    """A batch whose entries mix the 18-slot and the 17-slot form: the
    17-slot entry rides with a zero priority row, inert, as the
    reference's batched lane stacks it."""
    probs, cat = random_batch(12, 3, **dict(PRIO, pod_scale=300))
    probs[1] = probs[1][:17]
    zeros = np.zeros(probs[0][0].shape[0], np.int32)
    full = [p if len(p) > 17 else p + (zeros,) for p in probs]
    per = [_jax_args(p, cat, False) + (p[17],) for p in full]
    axes = jffd._BATCH_AXES + (0,)
    args = [np.stack([a[i] for a in per]) if ax == 0 else per[0][i]
            for i, ax in enumerate(axes)]
    ref = np.asarray(jffd.solve_ffd_batch(*args, max_nodes=64,
                                          zc=cat["zc"], explain=1,
                                          with_priority=1))
    c = tffd.catalog_tensors(cat, "cpu")
    out = tffd.solve_ffd_batch(tffd.batch_tensors(probs, c.O, "cpu"), c, 64,
                               1, with_priority=1).numpy()
    assert np.array_equal(ref.view(np.uint32), out.view(np.uint32))
    lay = tffd.flat_layout(probs[0][0].shape[0], probs[0][4].shape[0], 64,
                           probs[0][8].shape[1], 1, 0, c.O, 1)
    assert not tffd._region(torch.from_numpy(out), lay, "prio_inv")[1].any()


# -- the verdicts -----------------------------------------------------------------
def _band_input():
    """tests/test_priority.py test_band_exhausted_witness_and_plan's input:
    a resident low holds capacity a pinned high needs, and a same-pass low
    seats after the high strands."""
    resid = tp.mkpod("low-res", cpu="6", annot=1)
    exist = tp.mknode("edge-1", cpu="16", residents=[resid])
    pods = [tp.pinned(tp.mkpod("hi-0", cpu="6", annot=1000)),
            tp.pinned(tp.mkpod("hi-1", cpu="6", annot=1000)),
            tp.pinned(tp.mkpod("lo-0", cpu="4", annot=1))]
    return tp.mkinput(pods, existing=[exist])


def test_band_exhausted_reclassification(monkeypatch):
    """The witness gates PriorityBandExhausted: on both packages' kernel
    verdicts (the tree's `kernel` half under explain=full — the rescue
    oracle names the final code) and on `_unsched_reason` of one encoding
    from each package."""
    monkeypatch.setenv("KARPENTER_TPU_EXPLAIN", "full")
    inp = _band_input()
    ref_solver = jax_solver()
    ref = ref_solver.solve(inp)
    port = TorchSolver(device="cpu")
    got = port.solve(_port_inputs([inp])[0])
    assert canon(got) == canon(ref)
    assert chip_smoke.plans_canon(got) == chip_smoke.plans_canon(ref)
    tree = got.unschedulable["hi-1"].tree
    assert tree == ref.unschedulable["hi-1"].tree
    assert tree["kernel"]["code"] == explainmod.PRIORITY_BAND_EXHAUSTED
    assert got.preemptions[0].victim_pod_names() == ["low-res"]

    # the reclassification on its own: group 0 (the highs) strands one,
    # group 1 (the low) places after it
    from karpenter_tpu.solver.encode import encode, encode_catalog
    from karpenter_tpu_torch.solver.encode import encode as tencode
    from karpenter_tpu_torch.solver.encode import encode_catalog as tcat
    pinp = _port_inputs([inp])[0]
    codes = []
    for solver, enc in ((ref_solver, encode(inp, encode_catalog(inp))),
                        (port, tencode(pinp, tcat(pinp)))):
        G = enc.n_groups
        assert G == 2 and enc.group_priority[0] > enc.group_priority[1]
        for pi in (np.array([False, True]), np.array([False, False])):
            out = {"prio_inv": pi, "unsched": np.array([1.0, 0.0]),
                   "dom_placed": np.zeros((G, max(enc.n_domains, 1)))}
            codes.append(explainmod.code_of(
                solver._unsched_reason(enc, 0, out)))
    assert codes[:2] == codes[2:]
    assert codes[0] == explainmod.PRIORITY_BAND_EXHAUSTED
    assert codes[1] != explainmod.PRIORITY_BAND_EXHAUSTED


# -- the planner ------------------------------------------------------------------
def _gang_residents():
    gang = []
    for i in range(2):
        m = tp.mkpod(f"g-{i}", cpu="3", annot=1)
        m.meta.annotations[tp.wellknown.GANG_NAME_ANNOTATION] = "ring"
        m.meta.annotations[tp.wellknown.GANG_SIZE_ANNOTATION] = "2"
        gang.append(m)
    return gang


def _ds_dnd():
    ds = tp.mkpod("ds", cpu="6", annot=1)
    ds.is_daemonset = True
    dnd = tp.mkpod("dnd", cpu="6", annot=1)
    dnd.meta.annotations[tp.wellknown.DO_NOT_DISRUPT_ANNOTATION] = "true"
    return [tp.mknode("edge-1", cpu="8", residents=[ds]),
            tp.mknode("edge-2", cpu="8", residents=[dnd])]


def _hi(cpu="6", name="hi", annot=100):
    return [tp.pinned(tp.mkpod(name, cpu=cpu, annot=annot))]


# name -> (build, engine): "solver" runs TPUSolver / TorchSolver, "oracle"
# the two packages' Scheduler
PLAN_SCENARIOS = {
    "band-contended-capacity": (lambda: tp.mkinput(
        [tp.pinned(tp.mkpod(f"hi{i}", cpu="3", annot=1000))
         for i in range(2)]
        + [tp.pinned(tp.mkpod(f"lo{i}", cpu="3", annot=1))
           for i in range(2)],
        existing=[tp.mknode("edge-1", cpu="8")]), "solver"),
    "band-contended-capacity-oracle": (lambda: tp.mkinput(
        [tp.pinned(tp.mkpod(f"hi{i}", cpu="3", annot=1000))
         for i in range(2)]
        + [tp.pinned(tp.mkpod(f"lo{i}", cpu="3", annot=1))
           for i in range(2)],
        existing=[tp.mknode("edge-1", cpu="8")]), "oracle"),
    "band-insufficient": (lambda: tp.mkinput(
        [tp.pinned(tp.mkpod("hi-0", cpu="5", annot=1000)),
         tp.pinned(tp.mkpod("hi-1", cpu="5", annot=1000)),
         tp.pinned(tp.mkpod("lo-0", cpu="3", annot=1))],
        existing=[tp.mknode("edge-1", cpu="8")]), "solver"),
    "band-exhausted-plan": (_band_input, "solver"),
    "band-resident-victim": (lambda: tp.mkinput(
        _hi(name="crit", annot=1000)
        + [tp.mkpod(f"fill{i}", cpu="1", annot=1) for i in range(4)],
        existing=[tp.mknode("edge-1", cpu="8", residents=[
            tp.mkpod("victim-low", cpu="6", annot=1)])]), "solver"),
    "planner-minimal-victims": (lambda: tp.mkinput(
        _hi(cpu="4"), existing=[tp.mknode("edge-1", cpu="8", residents=[
            tp.mkpod(f"low-{i}", cpu="2", annot=i + 1)
            for i in range(3)])]), "oracle"),
    "planner-gang-victim-whole": (lambda: tp.mkinput(
        _hi(cpu="3"), existing=[tp.mknode("edge-1", cpu="8",
                                          residents=_gang_residents())]),
        "oracle"),
    "planner-insufficient": (lambda: tp.mkinput(
        _hi(cpu="32", name="giant"),
        existing=[tp.mknode("edge-1", cpu="8", residents=[
            tp.mkpod("low", cpu="2", annot=1)])]), "oracle"),
    "planner-daemonset-dnd": (lambda: tp.mkinput(
        _hi(), existing=_ds_dnd()), "oracle"),
    "planner-same-band": (lambda: tp.mkinput(
        _hi(), existing=[tp.mknode("edge-1", cpu="8", residents=[
            tp.mkpod("peer", cpu="6", annot=100)])]), "oracle"),
    "planner-resident-through-solver": (lambda: tp.mkinput(
        _hi(), existing=[tp.mknode("edge-1", cpu="8", residents=[
            tp.mkpod("low", cpu="6", annot=1)])]), "solver"),
}


def _victims(res):
    return [[(u.name, u.priority, u.cost, u.pod_names, u.node_names, u.gang)
             for u in p.victims] for p in res.preemptions]


@pytest.mark.parametrize("name", sorted(PLAN_SCENARIOS))
def test_preemption_plans_match_reference(name):
    build, engine = PLAN_SCENARIOS[name]
    inp = build()
    pinp = _port_inputs([inp])[0]
    if engine == "solver":
        ref = jax_solver().solve(inp)
        got = TorchSolver(device="cpu").solve(pinp)
    else:
        ref = JScheduler(inp).solve()
        got = Scheduler(pinp).solve()
    assert canon(got) == canon(ref)
    assert chip_smoke.plans_canon(got) == chip_smoke.plans_canon(ref)
    assert _victims(got) == _victims(ref)
    assert priority_inversion_audit(pinp, got, got.preemptions) == []
    if name == "planner-gang-victim-whole":
        assert sorted(got.preemptions[0].victim_pod_names()) \
            == ["g-0", "g-1"] and got.preemptions[0].victims[0].gang == "ring"
    if name in ("band-insufficient", "planner-insufficient"):
        assert explainmod.PREEMPTION_INSUFFICIENT in {
            explainmod.code_of(r) for r in got.unschedulable.values()}


def test_plan_attach_is_idempotent_and_deterministic():
    from karpenter_tpu_torch.solver import preempt

    def build():
        return _port_inputs([tp.mkinput(
            _hi(), existing=[tp.mknode("edge-1", cpu="8", residents=[
                tp.mkpod("low", cpu="6", annot=1)])])])[0]
    inp = build()
    res = Scheduler(inp).solve()
    assert len(res.preemptions) == 1
    preempt.attach(inp, res)
    assert len(res.preemptions) == 1
    assert res.preemptions[0].plan_id == \
        Scheduler(build()).solve().preemptions[0].plan_id
    assert res.preemptions[0].plan_id.startswith("preempt-")


# -- config #10 ------------------------------------------------------------------
def test_config10_matches_reference():
    """BASELINE config #10 at full scale (650 pods in 4 bands and the
    pinned 12-cpu high): the port's workloads.build_config10 records the
    benchmark's spot storm in the port's risk model as make_input does in
    the JAX package's, and solves to the JAX answer — the one
    chip_smoke.py holds the card to — with the plan evicting the edge
    gang whole and no priority inversion."""
    from benchmarks.config10_priority import make_input
    from karpenter_tpu_torch.workloads import build_config10
    jinp = make_input()
    inp = build_config10()
    assert [(p.meta.name, tuple(p.requests.v),
             sorted(p.meta.annotations.items())) for p in inp.pods] == [
        (p.meta.name, tuple(p.requests.v),
         sorted(p.meta.annotations.items())) for p in jinp.pods]
    # the storm: the same observations, the same probabilities and risk
    # key in both models
    assert risk.model_key() == jrisk.model_key()
    assert risk._observed == jrisk._observed and risk._observed
    for (it, zone) in risk._observed:
        assert risk.interruption_probability(it, zone, "spot") \
            == jrisk.interruption_probability(it, zone, "spot") \
            > risk.base_rate(it, zone)
    ref = TPUSolver(max_nodes=chip_smoke.CONFIG_MAX_NODES, mesh="off",
                    delta="off", spec="off", incr="off").solve(jinp)
    got = TorchSolver(max_nodes=chip_smoke.CONFIG_MAX_NODES,
                      device="cpu").solve(inp)
    nodes, unsched, price_hex, digest, trees = chip_smoke.CONFIG10
    assert canon(got) == canon(ref)
    assert (got.node_count(), len(got.unschedulable),
            float(got.total_price()).hex()) == (nodes, unsched, price_hex)
    assert chip_smoke.result_digest(got) == digest
    assert chip_smoke.trees_digest(got) == trees \
        == chip_smoke.trees_digest(ref)
    assert chip_smoke.plans_canon(got) == chip_smoke.plans_canon(ref) \
        == chip_smoke.CONFIG10_PLANS
    assert _victims(got) == _victims(ref)
    assert priority_inversion_audit(inp, got, got.preemptions) == []
    assert not any(n.startswith("sys-") for n in got.unschedulable)
