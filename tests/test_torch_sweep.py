"""The consolidation simulator in the port against the JAX package.

Three levels, all on the CPU, where the port's kernel wrappers run their
plain PyTorch versions:

  * the kernels: seeded batched problems (`solver/problems.py`
    `random_sweep`, `random_batch`) through the JAX `ffd.solve_ffd_sweep`,
    `solve_ffd_sweep_topo` and `solve_ffd_batch` and the port's
    `ffd.solve_ffd_sweep` / `solve_ffd_batch` (K4's and K5's plain
    versions, the take_exist compaction with sparse_k > 0, K2's for
    explain=1): the [B, total] result rows must be equal as uint32 —
    bit-exact, because both sides do the same IEEE float32 operations in
    the same order on integer-valued inputs;
  * the sweep's snapshot encodings (`SharedExistEncoding`,
    `SweepTopologyTables`) equal to the JAX ones on the same inputs;
  * the solve: `TorchSolver(device="cpu").solve_batch` against
    `TPUSolver.solve_batch` on reduced config #4 and #4b and on the batch,
    sweep and fuzz scenarios of `tests/test_solver_parity.py` and
    `tests/test_solver_fuzz.py`, whose inputs are recorded from those
    tests themselves as they run (their JAX solver wrapped, nothing
    edited) and rebuilt from the port's classes: canonical results, price
    as a float hex, must be equal simulation for simulation.
"""

import importlib

import numpy as np
import pytest
import torch

import karpenter_tpu.solver as jsolver_pkg
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import encode as jenc
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.solver import TorchSolver, UnsupportedPods
from karpenter_tpu_torch.solver import encode as tenc
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver import pipeline as tpipe
from karpenter_tpu_torch.solver.problems import random_batch, random_sweep
from tests import test_solver_fuzz, test_solver_parity
from tests.test_torch_ffd import _jax_args
from tests.test_torch_solve import canon, jax_solver


def to_port(obj, memo=None):
    """The same object graph rebuilt from karpenter_tpu_torch's classes
    (the port's models and scheduling types are copies of the JAX
    package's, field for field).  Shared objects stay shared: the sweep
    keys on the identity of the snapshot list and its nodes."""
    memo = {} if memo is None else memo
    if id(obj) in memo:
        return memo[id(obj)]
    if obj is None or isinstance(obj, (bool, int, float, str, bytes,
                                       np.ndarray, np.generic)):
        return obj
    if isinstance(obj, list):
        out = []
        memo[id(obj)] = out
        out.extend(to_port(x, memo) for x in obj)
        return out
    if isinstance(obj, (tuple, set, frozenset)):
        out = type(obj)(to_port(x, memo) for x in obj)
        memo[id(obj)] = out
        return out
    if isinstance(obj, dict):
        out = {}
        memo[id(obj)] = out
        for k, v in obj.items():
            out[to_port(k, memo)] = to_port(v, memo)
        return out
    mod = type(obj).__module__
    assert mod.startswith("karpenter_tpu."), type(obj)
    cls = getattr(importlib.import_module(
        "karpenter_tpu_torch." + mod[len("karpenter_tpu."):]),
        type(obj).__name__)
    out = cls.__new__(cls)
    memo[id(obj)] = out
    for k, v in getattr(obj, "__dict__", {}).items():
        object.__setattr__(out, k, to_port(v, memo))
    for k in getattr(type(obj), "__slots__", ()):
        if hasattr(obj, k):
            object.__setattr__(out, k, to_port(getattr(obj, k), memo))
    return out


# converted instance-type lists, by the identity of the JAX list: (the
# list, its offerings when converted, the port's list).  The scenarios
# share one catalog list across many inputs and calls; a list whose
# offerings changed since (other tests on the worker reprice the memoized
# default catalog) is converted again.
_CATALOGS = {}


def _offerings(types):
    return tuple((it.name, tuple((o.zone, o.capacity_type, o.price,
                                  o.available) for o in it.offerings))
                 for it in types)


def _port_inputs(inps):
    """to_port of a list of ScheduleInputs, each catalog list converted
    once per process."""
    memo = {}
    for inp in inps:
        for types in inp.instance_types.values():
            if id(types) in memo:
                continue
            offers = _offerings(types)
            hit = _CATALOGS.get(id(types))
            if hit is None or hit[0] is not types or hit[1] != offers:
                hit = (types, offers, to_port(types, {}))
                _CATALOGS[id(types)] = hit
            memo[id(types)] = hit[2]
    return to_port(inps, memo)


def _differ(ref, out):
    assert out.dtype == np.float32 and out.shape == ref.shape, (
        out.shape, ref.shape)
    return np.nonzero(ref.view(np.uint32) != out.view(np.uint32))


# -- the kernels ----------------------------------------------------------------
def _jax_sweep(rows, shared, cat, N, K, packed):
    cm = shared["class_mask"]
    if packed:
        cm = np.packbits(cm, axis=-1, bitorder="little")
    args = [rows[n] for n in tffd.SWEEP_ROWS]
    fn = jffd.solve_ffd_sweep
    if "group_dsel" in rows:
        args += ([rows[n] for n in tffd.SWEEP_TOPO_ROWS[:-1]]
                 + [rows["group_delig"].astype(bool)])
        fn = jffd.solve_ffd_sweep_topo
    args += [cm, shared["class_cap"], shared["exist_remaining"],
             shared["exist_zone"], shared["exist_ct"], cat["col_alloc"],
             cat["col_daemon"], cat["pt_alloc"], cat["col_pool"],
             cat["pool_daemon"], shared["col_price"], cat["col_zone"],
             cat["col_ct"]]
    return np.asarray(fn(*args, max_nodes=N, zc=cat["zc"], sparse_k=K,
                         mask_packed=packed))


def _port_sweep(rows, shared, cat, N, K):
    c = tffd.catalog_tensors(cat, "cpu")
    sw = tffd.sweep_tensors(rows, tffd.sweep_shared_tensors(shared, c.O,
                                                            "cpu"), "cpu")
    return sw, tffd.solve_ffd_sweep(sw, c, N, K).numpy()


# (id, seed, heavy, sparse_k, N, mask_packed, random_sweep kwargs).  Cases
# of one lane share shapes and static arguments where they can, so the
# JAX programs they compile are reused.
SWEEP_CASES = [
    ("light", 1, False, 0, 8, False, {}),
    ("light-sparse", 2, False, 8, 8, True, dict(pod_scale=8)),
    ("light-leave-two-out", 3, False, 8, 8, True, dict(X=2, pod_scale=6)),
    ("light-finite-pools-strand", 5, False, 0, 8, False,
     dict(limits="finite", pod_scale=400)),
    ("light-slot-exhaustion", 9, False, 0, 2, False,
     dict(limits="none", pod_scale=600, E=16)),
    ("light-wide-exclusions", 4, False, 32, 8, False,
     dict(X=8, E=256, pod_scale=30, G=4, C=6)),
    ("heavy", 3, True, 0, 8, False, {}),
    ("heavy-sparse-d8", 4, True, 8, 16, True, dict(D=8, ZC=12,
                                                   pod_scale=8)),
    ("heavy-many-classes", 6, True, 32, 8, False, dict(G=4, C=6)),
    ("heavy-finite-pools", 8, True, 0, 8, False, dict(limits="finite")),
]


@pytest.mark.parametrize("case", SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_sweep_scan_matches_jax_bitwise(case):
    name, seed, heavy, K, N, packed, kw = case
    rows, shared, cat = random_sweep(seed, 6, heavy=heavy, **kw)
    ref = _jax_sweep(rows, shared, cat, N, K, packed)
    sw, out = _port_sweep(rows, shared, cat, N, K)
    differ = _differ(ref, out)
    assert differ[0].size == 0, (name, differ)
    # the case exercises what its name claims
    us = [tffd.unpack(out[b], sw.G, sw.E, N, 6, sw.D, sparse_k=K)
          for b in range(sw.B)]
    assert sw.heavy == heavy
    if K:
        # the compaction is exact: every take_exist row fits its K slots
        assert all(((u["take_exist"] > 0).sum(axis=1) <= K).all()
                   for u in us)
        assert any(u["take_exist"].any() for u in us)
    if "strand" in name or "exhaustion" in name:
        assert any(u["unsched"].sum() > 0 for u in us)
    if "exhaustion" in name:
        assert any(u["num_active"] == N and u["unsched"].sum() > 0
                   for u in us)
    if name == "light":
        # a simulation that opens a new node under N=8, one capped
        assert any(u["num_active"] > 0 for u in us)
        assert np.isfinite(rows["price_cap"]).any()
    if "two-out" in name or "wide-exclusions" in name:
        assert ((rows["exclude_idx"] >= 0).sum(axis=1) >= 2).any()
    if heavy:
        assert (rows["group_dsel"] > 0).any()
        assert any(u["dom_placed"].sum() > 0 for u in us)


def test_sweep_price_cap_removes_columns():
    """The price cap is applied on the card's side of the gather: a cap
    below every column price strands what the existing nodes cannot
    take, +inf admits the class's columns (JAX and port agree on both)."""
    rows, shared, cat = random_sweep(11, 4, pod_scale=200, E=4)
    rows["price_cap"][:] = [0.0, np.inf, 0.0, np.inf]
    ref = _jax_sweep(rows, shared, cat, 8, 0, False)
    sw, out = _port_sweep(rows, shared, cat, 8, 0)
    assert _differ(ref, out)[0].size == 0
    us = [tffd.unpack(out[b], sw.G, sw.E, 8, 6, 1) for b in range(4)]
    assert us[0]["num_active"] == 0 and us[2]["num_active"] == 0
    assert us[0]["unsched"].sum() > 0
    assert us[1]["num_active"] > 0 or us[3]["num_active"] > 0


# (id, seed, random_problem kwargs, N, sparse_k, explain, mask_packed)
BATCH_CASES = [
    ("light", 1, {}, 64, 0, 1, False),
    ("light-sparse-packed", 2, dict(pod_scale=6), 64, 8, 0, True),
    ("topology", 3, dict(topology=True, D=4), 64, 0, 1, False),
    ("topology-sparse", 4, dict(topology=True, D=8, ZC=12, pod_scale=8),
     32, 8, 1, True),
    ("slot-exhaustion", 5, dict(P=1, limits="none", pod_scale=300), 16,
     0, 1, False),
]


@pytest.mark.parametrize("case", BATCH_CASES, ids=[c[0] for c in BATCH_CASES])
def test_batch_scan_matches_jax_bitwise(case):
    name, seed, kw, N, K, ex, packed = case
    probs, cat = random_batch(seed, 3, **kw)
    per = [_jax_args(p, cat, packed) for p in probs]
    args = [np.stack([a[i] for a in per]) if ax == 0 else per[0][i]
            for i, ax in enumerate(jffd._BATCH_AXES)]
    ref = np.asarray(jffd.solve_ffd_batch(
        *args, max_nodes=N, zc=cat["zc"], sparse_k=K, mask_packed=packed,
        explain=ex))
    c = tffd.catalog_tensors(cat, "cpu")
    out = tffd.solve_ffd_batch(tffd.batch_tensors(probs, c.O, "cpu"), c, N,
                               ex, K).numpy()
    differ = _differ(ref, out)
    assert differ[0].size == 0, (name, differ)
    G, E, D = probs[0][0].shape[0], probs[0][4].shape[0], probs[0][8].shape[1]
    us = [tffd.unpack(out[b], G, E, N, 6, D, sparse_k=K, explain=ex)
          for b in range(3)]
    if name == "slot-exhaustion":
        assert any(u["num_active"] == N and u["unsched"].sum() > 0
                   for u in us)
    if name.startswith("topology"):
        assert any(u["dom_placed"].sum() > 0 for u in us)


def test_compaction_is_the_reference_scatter():
    """compact_take_exist keeps each group's first K nonzero entries in
    index order, zero-padded, and unpack rebuilds the dense rows; an entry
    at index 0 survives the pad slots' (0, 0)."""
    te = torch.tensor([[0, 3, 0, 1, 2], [5, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
                      dtype=torch.float32)
    cnt, idx = tffd.compact_take_exist(te, 2)
    assert cnt.tolist() == [[3, 1], [5, 0], [0, 0]]
    assert idx.tolist() == [[1, 3], [0, 0], [0, 0]]
    lay = tffd.flat_layout(3, 5, 1, 1, sparse_k=2)
    flat = np.zeros(lay["total"][1], np.float32)
    flat[:12] = np.concatenate([cnt.reshape(-1), idx.reshape(-1)])
    u = tffd.unpack(flat, 3, 5, 1, 6, 1, sparse_k=2)
    assert u["take_exist"].tolist() == [[0, 3, 0, 1, 0], [5, 0, 0, 0, 0],
                                        [0] * 5]


def test_sweep_wrapper_checks_arguments():
    rows, shared, cat = random_sweep(1, 2)
    c = tffd.catalog_tensors(cat, "cpu")
    sh = tffd.sweep_shared_tensors(shared, c.O, "cpu")
    sw = tffd.sweep_tensors(rows, sh, "cpu")
    lay = tffd.flat_layout(sw.G, sw.E, 8, 1)
    flat = torch.zeros(2, lay["total"][1])
    lim = torch.zeros(2, sw.P, 6)
    with pytest.raises(ValueError, match="heavy lane needs"):
        tffd.sweep_topo_scan(sw, c, 8, flat, lay, lim)
    with pytest.raises(ValueError, match="sparse_k"):
        tffd.sweep_scan(sw, c, 8, flat, lay, lim, sparse_k=8)
    wide = dict(rows, exclude_idx=np.full((2, 9), -1, np.int32))
    with pytest.raises(ValueError, match="exclusions"):
        tffd.sweep_scan(tffd.sweep_tensors(wide, sh, "cpu"), c, 8, flat, lay,
                        lim)


# -- the snapshot encodings ---------------------------------------------------
def _sweep_snapshot(heavy):
    """A recorded sweep input list (JAX classes) with resident
    anti-affinity and spread pods when `heavy`."""
    return _recorded("fuzz-sweep-topology-1" if heavy
                     else "fuzz-sweep-0")[0][0]


@pytest.mark.parametrize("heavy", [False, True], ids=["light", "heavy"])
def test_sweep_encodings_match_jax(heavy):
    inps = _sweep_snapshot(heavy)
    pinps = to_port(inps)
    base, pbase = inps[0].exist_base, pinps[0].exist_base
    jcat = jenc.encode_catalog(inps[0])
    tcat = tenc.encode_catalog(pinps[0])
    js, ts = jenc.SharedExistEncoding(jcat), tenc.SharedExistEncoding(tcat)
    js.add_nodes(base)
    ts.add_nodes(pbase)
    js.freeze()
    ts.freeze()
    for k in ("zone", "ct", "usable", "res_anti", "_avail"):
        assert np.array_equal(getattr(js, k), getattr(ts, k)), k
    assert js.zone_ids == ts.zone_ids and js.ct_ids == ts.ct_ids
    assert np.array_equal(js.rows(inps[1].existing_nodes),
                          ts.rows(pinps[1].existing_nodes))
    jt = jenc.SweepTopologyTables(base, js.zone, js.ct, js.zone_ids,
                                  js.ct_ids)
    tt = tenc.SweepTopologyTables(pbase, ts.zone, ts.ct, ts.zone_ids,
                                  ts.ct_ids)
    assert jt.D == tt.D
    assert sorted(jt._res_anti) == sorted(tt._res_anti)
    n_topo = 0
    for inp, pinp in zip(inps, pinps):
        for jp, tp in zip(inp.pods, pinp.pods):
            assert np.array_equal(js.group_ok(jp), ts.group_ok(tp))
            try:
                ji = jt.class_topo(jp)
            except jenc.Unsupported:
                with pytest.raises(tenc.Unsupported):
                    tt.class_topo(tp)
                continue
            ti = tt.class_topo(tp)
            n_topo += ji["dyn"] is not None
            assert ji["ncap"] == ti["ncap"] and ji["dsel"] == ti["dsel"]
            for k in ("hostcap", "delig"):
                assert np.array_equal(ji[k], ti[k]), k
            for excl in (inp.exist_excluded, (0, 1), ()):
                for a, b in zip(jt.sim_tensors(ji, excl),
                                tt.sim_tensors(ti, excl)):
                    assert np.array_equal(a, b)
    assert n_topo > 0 if heavy else True


# -- the solve ----------------------------------------------------------------
class _Recorder:
    """Stands in for TPUSolver inside a JAX test as it runs: delegates
    every call, and records each solve_batch's inputs, cap and results."""
    calls = None

    def __init__(self, *a, **kw):
        self._s = _REAL_TPUSOLVER(*a, **kw)

    def solve_batch(self, inps, max_nodes=None):
        res = self._s.solve_batch(inps, max_nodes=max_nodes)
        type(self).calls.append((list(inps), max_nodes, res))
        return res

    def __getattr__(self, name):
        return getattr(self._s, name)


_REAL_TPUSOLVER = TPUSolver


def _record(run):
    """Run a JAX test body with TPUSolver recorded; return its calls."""
    mp = pytest.MonkeyPatch()
    _Recorder.calls = []
    try:
        mp.setattr(test_solver_parity, "TPUSolver", _Recorder)
        mp.setattr(jsolver_pkg, "TPUSolver", _Recorder)
        run()
    finally:
        mp.undo()
    return _Recorder.calls


def _assert_port_matches(calls):
    assert calls
    for inps, max_nodes, ref in calls:
        port = TorchSolver(device="cpu")
        got = port.solve_batch(_port_inputs(inps), max_nodes=max_nodes)
        assert len(got) == len(ref)
        for i, (a, b) in enumerate(zip(ref, got)):
            assert canon(b) == canon(a), i


PARITY = {
    "batch-matches-sequential": lambda: test_solver_parity.TestSolveBatch()
    .test_batch_matches_sequential(),
    "batch-price-cap": lambda: test_solver_parity.TestSolveBatch()
    .test_batch_price_cap(),
    "batch-shared-exist-cache": lambda: test_solver_parity.TestSolveBatch()
    .test_batch_shared_exist_cache_matches_sequential(),
    "batch-empty-and-topology": lambda: test_solver_parity.TestSolveBatch()
    .test_batch_empty_and_topology(),
    "sweep-matches-generic": lambda: test_solver_parity.TestSweepFastPath()
    .test_sweep_matches_generic(),
    "sweep-price-cap-heterogeneous": lambda: (
        test_solver_parity.TestSweepFastPath()
        .test_sweep_price_cap_and_heterogeneous_pods()),
    "sweep-pool-limits": lambda: test_solver_parity.TestSweepFastPath()
    .test_sweep_respects_pool_limits(),
    "sweep-leave-two-out": lambda: test_solver_parity.TestSweepFastPath()
    .test_sweep_leave_two_out(),
    "sweep-topology-heavy-lane": lambda: (
        test_solver_parity.TestSweepFastPath()
        .test_sweep_topology_pods_ride_heavy_lane()),
    "sweep-preference-pods": lambda: test_solver_parity.TestSweepFastPath()
    .test_sweep_preference_pods_fall_back(),
    "partial-sweep-with-holes": lambda: (
        test_solver_parity.TestSweepFastPath()
        .test_partial_sweep_mixed_batch()),
    "baseless-first-input": lambda: test_solver_parity.TestSweepFastPath()
    .test_baseless_first_input_does_not_demote_batch(),
    "fuzz-sweep-0": lambda: test_solver_fuzz.TestFuzzSweep()
    .test_seeded_sweep_matches_generic(0),
    "fuzz-sweep-5": lambda: test_solver_fuzz.TestFuzzSweep()
    .test_seeded_sweep_matches_generic(5),
    "fuzz-sweep-topology-1": lambda: test_solver_fuzz.TestFuzzSweep()
    .test_seeded_sweep_topology_matches_generic(1),
    "fuzz-sweep-topology-4": lambda: test_solver_fuzz.TestFuzzSweep()
    .test_seeded_sweep_topology_matches_generic(4),
}


_RECORDED = {}


def _recorded(name):
    """The calls of PARITY scenario `name`, recorded once per process."""
    if name not in _RECORDED:
        _RECORDED[name] = _record(PARITY[name])
    return _RECORDED[name]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_solve_batch_matches_reference(name):
    """Every solve_batch call the JAX scenario makes, replayed through the
    port on the same inputs: the same results, simulation for
    simulation."""
    _assert_port_matches(_recorded(name))


def _config4(n, spread):
    """Config #4 (#4b with `spread`) at n nodes and n candidates, built
    with the JAX package's classes as the benchmarks build it."""
    from karpenter_tpu.models import (Node, NodePool, ObjectMeta, Pod,
                                      Resources, TopologySpreadConstraint,
                                      wellknown)
    from karpenter_tpu.scheduling import ExistingNode, ScheduleInput
    from tests.test_torch_encode import JAX
    from tests.test_torch_solve import default_catalog
    shared = list(default_catalog(JAX))
    zones = ["tpu-west-1a", "tpu-west-1b", "tpu-west-1c"]
    nodes = []
    for i in range(n):
        node = Node(meta=ObjectMeta(name=f"n{i}", labels={
            wellknown.ZONE_LABEL: zones[i % 3],
            wellknown.CAPACITY_TYPE_LABEL: ["spot", "on-demand"][i % 2],
            wellknown.NODEPOOL_LABEL: "default",
            wellknown.ARCH_LABEL: "amd64", wellknown.OS_LABEL: "linux",
            wellknown.HOSTNAME_LABEL: f"n{i}"}),
            allocatable=Resources.of(cpu=16000, memory=32768, pods=58),
            ready=True)
        grp = i % 10
        kw = {}
        labels = {}
        if spread and grp < 8 and i % 5 != 4:
            labels = {"app": f"dep{grp}"}
            kw["topology_spread"] = [TopologySpreadConstraint(
                topology_key=wellknown.ZONE_LABEL, max_skew=2,
                label_selector={"app": f"dep{grp}"})]
        p = Pod(meta=ObjectMeta(name=f"p{i}", labels=labels),
                requests=Resources.parse({"cpu": "500m", "memory": "1Gi"}),
                node_name=f"n{i}", **kw)
        nodes.append(ExistingNode(node=node,
                                  available=node.allocatable - p.requests,
                                  pods=[p]))
    pool = NodePool(meta=ObjectMeta(name="default"))
    return [ScheduleInput(
        pods=list(nodes[i].pods), nodepools=[pool],
        instance_types={"default": shared},
        existing_nodes=nodes[:i] + nodes[i + 1:], price_cap=0.5,
        exist_base=nodes, exist_excluded=(i,)) for i in range(n)]


@pytest.mark.parametrize("spread", [False, True],
                         ids=["config4-64", "config4b-64"])
def test_config4_reduced_matches_reference(spread):
    """Config #4 and #4b at 64 nodes and 64 candidates (the benchmarks'
    shapes, cut in scale only): every simulation a feasible delete, as at
    full scale, and the port's answer is the JAX package's, also through
    chip_smoke.py's digest of the canonical results; #4b runs both
    lanes."""
    import chip_smoke
    inps = _config4(64, spread)
    ref = jax_solver().solve_batch(inps, max_nodes=8)
    calls = {"light": 0, "heavy": 0}
    real = tffd.solve_ffd_sweep

    def counted(sw, *a, **kw):
        calls["heavy" if sw.heavy else "light"] += 1
        return real(sw, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tffd, "solve_ffd_sweep", counted)
    try:
        port = TorchSolver(device="cpu")
        got = port.solve_batch(_port_inputs(inps), max_nodes=8)
    finally:
        mp.undo()
    assert [canon(r) for r in got] == [canon(r) for r in ref]
    assert all(not r.unschedulable and not r.new_claims for r in got)
    assert calls["light"] > 0 and (calls["heavy"] > 0) == spread
    assert set(port.last_phase_ms) == {"encode", "device", "decode",
                                       "per_sim"}
    assert [chip_smoke.sweep_canon(r) for r in got] == [canon(r)
                                                        for r in got]
    assert chip_smoke.sweep_digest(got) == chip_smoke.sweep_digest(ref)


def _sweep_summary(inps):
    """What a consolidation sweep's inputs hold, in plain values: the
    shared snapshot's nodes (labels, allocatable, remainder, pods), and
    per simulation its pods (labels, requests, spread), exclusions,
    price cap, pools and catalog."""
    base = inps[0].exist_base

    def vals(r):
        return [float(x) for x in r.v]

    def pod(p):
        return (p.meta.name, sorted(p.meta.labels.items()),
                vals(p.requests), p.node_name,
                [(c.topology_key, c.max_skew, sorted(c.label_selector.items()),
                  c.when_unsatisfiable) for c in p.topology_spread])

    nodes = [(en.node.meta.name, sorted(en.node.meta.labels.items()),
              vals(en.node.allocatable), vals(en.available),
              en.node.ready, [pod(p) for p in en.pods]) for en in base]
    sims = []
    for inp in inps:
        assert inp.exist_base is base
        ex = set(inp.exist_excluded)
        assert len(inp.existing_nodes) == len(base) - len(ex)
        sims.append(([pod(p) for p in inp.pods], inp.exist_excluded,
                     inp.price_cap, [np.meta.name for np in inp.nodepools],
                     {k: len(v) for k, v in inp.instance_types.items()}))
    return nodes, sims


@pytest.mark.parametrize("spread", [False, True],
                         ids=["config4", "config4b"])
def test_chip_smoke_config4_inputs_are_the_benchmarks(spread):
    """chip_smoke.py's config #4 and #4b phases hold the port's
    `build_config4`/`build_config4b` to digests of the JAX answer on the
    benchmarks' `make_input`: both make the same 2,000 simulations."""
    from benchmarks import config4_consolidation as c4
    from benchmarks import config4b_consolidation_spread as c4b
    from karpenter_tpu_torch import workloads
    ref = (c4b if spread else c4).make_input()
    port = (workloads.build_config4b if spread
            else workloads.build_config4)()
    assert len(port) == len(ref) == 2000
    assert _sweep_summary(port) == _sweep_summary(ref)


def test_sweep_releases_the_names_cache_on_every_exit(monkeypatch):
    """The sweep's decode caches the snapshot's node names; the cache is
    gone when solve_batch returns, and when a decode raises."""
    inps = _port_inputs(_config4(8, False))
    port = TorchSolver(device="cpu")
    port.solve_batch(inps, max_nodes=8)
    assert port._exist_names_cache is None and not port._in_sweep_decode
    real = port._decode
    seen = []

    def failing(enc, out):
        res = real(enc, out)
        seen.append(port._exist_names_cache is not None)
        raise RuntimeError("decode failed")

    monkeypatch.setattr(port, "_decode", failing)
    with pytest.raises(RuntimeError, match="decode failed"):
        port.solve_batch(inps, max_nodes=8)
    assert seen == [True]
    assert port._exist_names_cache is None and not port._in_sweep_decode


# -- what later slices bring ------------------------------------------------------
def _unsupported_inputs():
    from karpenter_tpu_torch import models as M
    from karpenter_tpu_torch.providers import generate_catalog
    from karpenter_tpu_torch.providers.catalog import CatalogSpec
    from karpenter_tpu_torch.scheduling import ScheduleInput
    catalog = generate_catalog(CatalogSpec(max_types=24, include_gpu=False))
    pool = M.NodePool(meta=M.ObjectMeta(name="default"))

    def pod(name, **kw):
        return M.Pod(meta=M.ObjectMeta(name=name,
                                       labels=kw.pop("labels", {}),
                                       annotations=kw.pop("annotations",
                                                          {})),
                     requests=M.Resources.parse({"cpu": "500m",
                                                 "memory": "1Gi"}), **kw)

    def inp(pods):
        return ScheduleInput(pods=pods, nodepools=[pool],
                             instance_types={"default": catalog})

    wk = M.wellknown
    gang = [pod(f"g{i}", annotations={wk.GANG_NAME_ANNOTATION: "job",
                                      wk.GANG_SIZE_ANNOTATION: "2"})
            for i in range(2)]
    prios = [pod("hi", priority=1000), pod("lo", priority=0)]
    # a required zone term no zone satisfies, preferred away by a soft
    # term: round 0 strands it, the straggler needs the relaxation loop
    soft = [pod("s", requirements=M.Requirements(M.Requirement.make(
        M.wellknown.ZONE_LABEL, "In", "nowhere")),
        preferences=[(10, M.Requirements(M.Requirement.make(
            M.wellknown.ZONE_LABEL, "In", "tpu-west-1a")))])]
    return {"gang-in-batch": [inp([pod("x")]), inp(gang)],
            "priority-bands": [inp(prios)],
            "soft-term-straggler": [inp([pod("y")]), inp(soft)]}


@pytest.mark.parametrize("name", sorted(_unsupported_inputs()))
def test_later_slices_raise_unsupported(name):
    inps = _unsupported_inputs()[name]
    with pytest.raises(UnsupportedPods, match="slice 2b"):
        TorchSolver(device="cpu").solve_batch(inps, max_nodes=8)


# -- the pipeline ---------------------------------------------------------------
@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_run_pipeline_order(enabled):
    log = []
    tpipe.run_pipeline(
        [1, 2, 3], lambda i: log.append(f"d{i}") or i * 10,
        lambda i, h: log.append(f"c{i}:{h}"), enabled=enabled)
    if enabled:
        assert log == ["d1", "d2", "c1:10", "d3", "c2:20", "c3:30"]
    else:
        assert log == ["d1", "c1:10", "d2", "c2:20", "d3", "c3:30"]


def test_pipeline_gate(monkeypatch):
    monkeypatch.delenv("KARPENTER_TPU_PIPELINE", raising=False)
    assert tpipe.pipeline_enabled(torch.device("cuda"))
    assert not tpipe.pipeline_enabled(torch.device("cpu"))
    for raw, want in (("off", False), ("0", False), ("on", True),
                      ("1", True), ("bogus", False)):
        monkeypatch.setenv("KARPENTER_TPU_PIPELINE", raw)
        assert tpipe.pipeline_enabled(torch.device("cpu")) is want, raw


def test_pipelined_batch_matches_synchronous(monkeypatch):
    """The chunk pipeline forced on (on the CPU it keeps the blocking
    pull) gives the synchronous answer across several chunks."""
    inps = test_solver_parity.TestSweepFastPath()._sweep_inputs(
        test_solver_parity.TestSweepFastPath()._cluster(6))
    pinps = _port_inputs(inps)
    want = [canon(r) for r in TorchSolver(device="cpu").solve_batch(
        pinps, max_nodes=8)]
    monkeypatch.setenv("KARPENTER_TPU_PIPELINE", "on")
    monkeypatch.setattr("karpenter_tpu_torch.solver.solve.B_BUCKETS",
                        (1, 2))
    got = [canon(r) for r in TorchSolver(device="cpu").solve_batch(
        pinps, max_nodes=8)]
    assert got == want


def test_new_modules_are_in_the_import_boundary_scan():
    from tests.test_torch_imports import _modules
    mods = set(_modules())
    assert {"karpenter_tpu_torch.solver.pipeline",
            "karpenter_tpu_torch.solver.problems",
            "karpenter_tpu_torch.workloads"} <= mods
