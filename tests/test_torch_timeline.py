"""The port's cluster timeline (`karpenter_tpu_torch/timeline/`) against
the JAX package's.

The loops of `tests/test_torch_ledger.py` (the 40-node disruption loop's
three waves and a small provisioning loop) and a gang and priority
scenario run in both packages, each package's timeline ring reset before
and wide enough to hold the whole stream.  The streams must match event
for event: kind, name, data (a pod's replayable spec), ``seq`` and the
cross-links ``flight_seq`` and ``ledger_seq``.  Stripped, because they
differ from run to run:

  * ``ts`` — the wall-clock time of the event;
  * ``pid`` — the recording process;
  * ``trace_id`` — a random id (None here: tracing is off).

The gang and priority arrival markers must match, the per-kind counters
(`TIMELINE_EVENTS`) too, and the trajectory judges' verdicts
(`TrajectoryAuditor.report`, with `SolveProbe` around each package's
solver in the gang scenario) must be equal.  The seeded generators must
give the same streams.

The unit cases follow `tests/test_timeline.py`'s registry, recorder,
spill, store-hook, generator and invariant-helper cases, parametrised
over both packages.
"""

import importlib
import json
import os
import threading
from types import SimpleNamespace

import pytest
import torch

from karpenter_tpu_torch import workloads
from tests import test_torch_provisioning as prov
from tests.test_torch_disruption import (
    JAX,
    PORT,
    fresh_catalog,
    loop_pkg,
    mkenv,
)

STRIPPED = ("ts", "pid", "trace_id")
SMALL_FLEET = 40


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, ev=imp("timeline.events"), rec=imp("timeline.recorder"),
        gen=imp("timeline.generators"), inv=imp("timeline.invariants"),
        ledger=imp("utils.ledger"), flight=imp("utils.flightrecorder"),
        metrics=imp("utils.metrics"), wk=imp("models.wellknown"),
        cluster=imp("cluster"), M=imp("models"),
        obs=workloads.Observability(
            metrics=imp("utils.metrics"), ledger=imp("utils.ledger"),
            invariants=imp("timeline.invariants"),
            flightrecorder=imp("utils.flightrecorder"),
            timeline=imp("timeline.recorder")))


TL = {"jax": _pkg("karpenter_tpu"), "port": _pkg("karpenter_tpu_torch")}
LOOPS = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scans on one intra-op thread (beside JAX in one process
    torch's default threads are ~15x slower); restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_all():
    for t in TL.values():
        t.rec.RECORDER.reset()
        t.ledger.LEDGER.reset()
        t.flight.RECORDER.reset()


@pytest.fixture(autouse=True)
def fresh_rings(monkeypatch):
    """Both packages' process-global rings reset before and after each
    test (any order gives the same answers), the knobs at their
    defaults."""
    for k in ("KARPENTER_TPU_TIMELINE", "KARPENTER_TPU_TIMELINE_DIR",
              "KARPENTER_TPU_TIMELINE_BUFFER", "KARPENTER_TPU_LEDGER_DIR"):
        monkeypatch.delenv(k, raising=False)
    _reset_all()
    yield
    _reset_all()


def _stream(t):
    """The package's whole timeline ring, stripped."""
    r = t.rec.RECORDER
    return [{k: v for k, v in e.items() if k not in STRIPPED}
            for e in r.tail(len(r))]


def _wide_rings():
    """Rings that hold a whole loop: set the buffers, reset."""
    os.environ["KARPENTER_TPU_TIMELINE_BUFFER"] = "1000000"
    os.environ["KARPENTER_TPU_LEDGER_BUFFER"] = "100000"
    _reset_all()


def _narrow_rings():
    os.environ.pop("KARPENTER_TPU_TIMELINE_BUFFER", None)
    os.environ.pop("KARPENTER_TPU_LEDGER_BUFFER", None)
    _reset_all()


def _disruption(name):
    ns, t = LOOPS[name], TL[name]
    watch = workloads.WaveObserver(t.obs)
    env = workloads.disruption_loop(
        SMALL_FLEET, options=ns.Options(batch_idle_duration=0,
                                        solver_mesh="off"),
        catalog=fresh_catalog(ns), pkg=loop_pkg(ns))
    w = workloads.DisruptionWaves(env)
    obs = []
    # the events before wave 1 (the pools, the NodeClass, the pods)
    # precede every observation
    pre = len(t.rec.RECORDER)
    for wave in (w.wave1, w.wave2, w.wave3):
        watch.start(env.cluster)
        wave()
        obs.append(watch.finish(env.cluster))
    return _stream(t), obs, pre


@pytest.fixture(scope="module")
def disruption_streams():
    _wide_rings()
    try:
        return {name: _disruption(name) for name in LOOPS}
    finally:
        _narrow_rings()


def test_disruption_loop_stream_matches_reference(disruption_streams):
    ref, ref_obs, ref_pre = disruption_streams["jax"]
    got, obs, pre = disruption_streams["port"]
    assert pre == ref_pre
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"event {i}: {a} != {b}"
    assert obs == ref_obs
    kinds = {e["kind"] for e in got}
    assert {"store.pods.added", "store.pods.modified",
            "store.nodeclaims.added", "store.nodes.deleted",
            "spot.reclaim"} <= kinds
    # the counters agree with the stream
    counts, seen = {}, {}
    for o in obs:
        for k, v in o["timeline"].items():
            counts[k] = counts.get(k, 0) + v
    for e in got[pre:]:
        seen[e["kind"]] = seen.get(e["kind"], 0) + 1
    assert counts == seen
    assert all(o["verdict"]["zero_lost_pods"]
               and o["verdict"]["ledger_hex_exact"] for o in obs)


def _provisioning(name):
    t = TL[name]
    watch = workloads.WaveObserver(t.obs)
    loop = prov.build_loop(prov.JAX if name == "jax" else prov.PORT, 300)
    obs = []
    for wave in (1, 2):
        if wave == 2:
            prov.add_pods(loop, 30, "w", workloads.WAVE2_SIZES)
        watch.start(loop.cluster)
        loop.manager.run_until_idle()
        obs.append(watch.finish(loop.cluster))
    return _stream(t), obs


def test_provisioning_loop_stream_matches_reference():
    _wide_rings()
    try:
        ref, ref_obs = _provisioning("jax")
        _reset_all()
        got, obs = _provisioning("port")
    finally:
        _narrow_rings()
    assert got == ref
    assert obs == ref_obs
    added = [e for e in got if e["kind"] == "store.pods.added"]
    assert len(added) == 330
    assert added[0]["data"]["requests"]  # the replayable spec
    # the pods were added before each wave's observation began
    assert obs[0]["timeline"]["store.pods.modified"] >= 300
    assert "store.pods.added" not in obs[1]["timeline"]


def _gang_scenario(name):
    """Three gangs, one of them in a priority band, and a band of
    singles, into `name`'s environment with SolveProbe around its solver;
    (stream, the probe's verdict, the markers)."""
    ns, t = LOOPS[name], TL[name]
    env = mkenv(ns)
    auditor = t.inv.TrajectoryAuditor()
    probe = t.inv.SolveProbe(env.solver, auditor)
    env.provisioner.solver = probe
    M, wk = ns.M, t.wk
    req = M.Resources.parse({"cpu": "500m", "memory": "1Gi"})
    for g in range(3):
        ann = {wk.GANG_NAME_ANNOTATION: f"ring-{g}",
               wk.GANG_SIZE_ANNOTATION: "3"}
        if g == 1:
            ann[wk.PRIORITY_ANNOTATION] = "1000"
        for m in range(3):
            env.cluster.pods.create(M.Pod(
                meta=M.ObjectMeta(name=f"g{g}-m{m}", annotations=dict(ann)),
                requests=req))
    for i in range(4):
        env.cluster.pods.create(M.Pod(
            meta=M.ObjectMeta(name=f"low-{i}", annotations={
                wk.PRIORITY_ANNOTATION: "-10"}), requests=req))
    auditor.expected_pods = {p.meta.name for p in env.cluster.pods.list()}
    env.settle()
    led = t.ledger.LEDGER
    verdict = auditor.report(env.cluster, led.tail(len(led)), {})
    markers = [(e["kind"], e["name"], e["data"])
               for e in t.rec.RECORDER.tail(10_000)
               if e["kind"] in (t.ev.GANG_ARRIVAL, t.ev.PRIORITY_ARRIVAL)]
    return _stream(t), verdict, markers


def test_gang_and_priority_markers_match_reference():
    _wide_rings()
    try:
        ref = _gang_scenario("jax")
        _reset_all()
        got = _gang_scenario("port")
    finally:
        _narrow_rings()
    stream, verdict, markers = got
    assert stream == ref[0]
    assert markers == ref[2]
    assert verdict == ref[1]
    assert [(k, n) for k, n, _ in markers] == [
        ("gang.arrival", "ring-0"), ("gang.arrival", "ring-1"),
        ("priority.arrival", "1000"), ("gang.arrival", "ring-2"),
        ("priority.arrival", "-10")]
    assert verdict["solves"] >= 1
    assert verdict["zero_gang_atomicity_violations"]
    assert verdict["zero_priority_inversions"]
    assert verdict["zero_lost_pods"] and verdict["ledger_hex_exact"]


def _generated(t, seed):
    g = t.gen
    return g.compose(
        g.diurnal_load(seed=seed, duration=2400.0, step=300.0),
        g.spot_storm(at=600.0, reclaims=5, seed=seed),
        g.gang_burst(at=900.0, gangs=2, size=3, topology="zone",
                     seed=seed),
        g.priority_wave(at=1200.0, seed=seed),
        g.crash_schedule(1500.0, restart_after=90.0))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generators_match_reference(seed):
    ref = _generated(TL["jax"], seed)
    got = _generated(TL["port"], seed)
    assert json.dumps(got) == json.dumps(ref)
    assert {e["kind"] for e in got} >= {"pod.add", "spot.reclaim",
                                         "worker.crash"}


# -- tests/test_timeline.py's unit cases, for both packages ------------------
@pytest.fixture(params=sorted(TL))
def t(request):
    return TL[request.param]


def test_catalogue_is_closed_and_classified(t):
    ev = t.ev
    assert set(ev.DRIVE_KINDS) == {
        ev.POD_ADD, ev.POD_REMOVE, ev.SPOT_RECLAIM, ev.PRICE_REFRESH,
        ev.FAULT_INJECT, ev.WORKER_CRASH, ev.WORKER_RESTART,
        ev.GANG_ARRIVAL, ev.PRIORITY_ARRIVAL, ev.CHECKPOINT}
    for k in ev.DRIVE_KINDS:
        assert ev.is_drive(k) and not ev.is_store(k)
        assert ev.describe(k) and k in ev.KINDS
    k = ev.store_event("nodeclaims", "added")
    assert k == "store.nodeclaims.added"
    assert ev.is_store(k) and not ev.is_drive(k)


def test_kinds_match_reference():
    # the kinds, spelled the same (the descriptions are documentation)
    assert list(TL["port"].ev.KINDS) == list(TL["jax"].ev.KINDS)
    assert list(TL["port"].ev.DRIVE_KINDS) == list(TL["jax"].ev.DRIVE_KINDS)


def test_gate_off_emits_nothing(t, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_TIMELINE", "off")
    assert t.rec.emit(t.ev.POD_ADD, name="p0") is None
    assert len(t.rec.RECORDER) == 0


def test_seq_monotonic_and_ring_bound(t, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_TIMELINE_BUFFER", "8")
    t.rec.RECORDER.reset()  # re-reads the buffer knob
    for i in range(20):
        t.rec.emit(t.ev.POD_ADD, name=f"p{i}")
    assert len(t.rec.RECORDER) == 8
    assert [e["seq"] for e in t.rec.RECORDER.tail(64)] == \
        list(range(13, 21))
    assert t.rec.RECORDER.last_seq() == 20


def test_cross_links_stamped(t):
    e = t.rec.emit(t.ev.PRICE_REFRESH)
    # empty neighbour rings stamp None, never a fake 0
    assert e.flight_seq is None and e.ledger_seq is None
    t.flight.RECORDER.record(kind="solve")
    t.ledger.LEDGER.record("provisioning", "launch")
    e2 = t.rec.emit(t.ev.PRICE_REFRESH)
    assert e2.flight_seq == t.flight.RECORDER.last_seq() == 1
    assert e2.ledger_seq == t.ledger.LEDGER.last_seq() == 1


def test_tail_kind_filter(t):
    t.rec.emit(t.ev.POD_ADD, name="a")
    t.rec.emit(t.ev.SPOT_RECLAIM, name="i-1")
    t.rec.emit(t.ev.POD_ADD, name="b")
    got = t.rec.RECORDER.tail(64, kind=t.ev.POD_ADD)
    assert [e["name"] for e in got] == ["a", "b"]
    assert t.rec.RECORDER.tail(0) == []


def test_spill_and_torn_tail_load(t, monkeypatch, tmp_path):
    monkeypatch.setenv("KARPENTER_TPU_TIMELINE_DIR", str(tmp_path))
    for i in range(4):
        t.rec.emit(t.ev.POD_ADD, name=f"p{i}", data={"cpu": "250m"})
    path = tmp_path / f"timeline-{os.getpid()}.jsonl"
    assert path.exists()
    assert [r["name"] for r in t.rec.load_events(str(path))] == \
        ["p0", "p1", "p2", "p3"]
    with open(path, "a") as f:
        f.write('{"kind": "pod.add", "torn')
    assert len(t.rec.load_events(str(path))) == 4


def test_concurrent_emitters_lose_nothing(t, monkeypatch, tmp_path):
    monkeypatch.setenv("KARPENTER_TPU_TIMELINE_DIR", str(tmp_path))
    writers, per = 6, 30
    barrier = threading.Barrier(writers)

    def hammer(w):
        barrier.wait()
        for i in range(per):
            t.rec.emit(t.ev.POD_ADD, name=f"w{w}-{i}")

    threads = [threading.Thread(target=hammer, args=(w,))
               for w in range(writers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rows = t.rec.load_events(str(tmp_path / f"timeline-{os.getpid()}.jsonl"))
    assert len(rows) == writers * per
    assert sorted(r["seq"] for r in rows) == \
        list(range(1, writers * per + 1))


def test_pod_add_captures_replayable_spec(t):
    M = t.M
    c = t.cluster.Cluster()
    c.pods.create(M.Pod(meta=M.ObjectMeta(name="w-0"),
                        requests=M.Resources.parse(
                            {"cpu": "500m", "memory": "1Gi"})))
    added = t.rec.RECORDER.tail(64, kind=t.ev.store_event("pods", "added"))
    assert [e["name"] for e in added] == ["w-0"]
    assert added[0]["data"]["requests"]  # the dense vector
    c.pods.delete("w-0")
    assert t.rec.RECORDER.tail(64, kind=t.ev.store_event("pods",
                                                         "deleted"))


def test_first_member_markers(t):
    M, wk = t.M, t.wk
    c = t.cluster.Cluster()
    req = M.Resources.parse({"cpu": "250m", "memory": "512Mi"})
    for i in range(3):
        c.pods.create(M.Pod(meta=M.ObjectMeta(
            name=f"g-{i}",
            annotations={wk.GANG_NAME_ANNOTATION: "ring",
                         wk.GANG_SIZE_ANNOTATION: "3",
                         wk.PRIORITY_ANNOTATION: "100"}), requests=req))
    gangs = t.rec.RECORDER.tail(64, kind=t.ev.GANG_ARRIVAL)
    prios = t.rec.RECORDER.tail(64, kind=t.ev.PRIORITY_ARRIVAL)
    # one marker per distinct gang / band, not per member
    assert [e["name"] for e in gangs] == ["ring"]
    assert gangs[0]["data"]["first_member"] == "g-0"
    assert [e["name"] for e in prios] == ["100"]


def test_seeded_determinism(t):
    g = t.gen
    a = g.diurnal_load(seed=3, duration=1200.0, step=300.0)
    assert a == g.diurnal_load(seed=3, duration=1200.0, step=300.0)
    assert a != g.diurnal_load(seed=4, duration=1200.0, step=300.0)
    s = g.diurnal_load(seed=1, duration=2400.0, step=300.0, lifetime=600.0)
    adds = {e["name"] for e in s if e["kind"] == t.ev.POD_ADD}
    removes = {e["name"] for e in s if e["kind"] == t.ev.POD_REMOVE}
    assert removes and removes <= adds
    a = g.gang_burst(at=100.0, gangs=2, size=3, seed=5)
    b = g.spot_storm(at=200.0, reclaims=3, seed=5)
    assert g.compose(a, b) == g.compose(b, a)


def test_import_trace_skeleton(t, tmp_path):
    p = tmp_path / "trace.jsonl"
    p.write_text('{"ts": 10, "name": "t0", "cpu": "1", "end": 50}\n'
                 'not json\n'
                 '{"ts": 20, "name": "t1"}\n')
    s = t.gen.import_trace(str(p))
    assert t.gen.import_trace.skipped == 1
    names = [(e["kind"], e["name"]) for e in s]
    assert (t.ev.POD_ADD, "t0") in names
    assert (t.ev.POD_REMOVE, "t0") in names
    assert (t.ev.POD_ADD, "t1") in names


def test_ledger_check_hex_exact(t):
    good = {"seq": 1, "cost_delta": 0.25, "cost_delta_hex": (0.25).hex(),
            "fleet_cost_before": 1.0, "fleet_cost_after": 1.25}
    out = t.inv.TrajectoryAuditor.ledger_check([good])
    assert out["exact"] and out["checked"] == 1
    bad = dict(good, seq=2, fleet_cost_after=1.2500000001)
    out = t.inv.TrajectoryAuditor.ledger_check([good, bad])
    assert not out["exact"] and out["broken"][0]["seq"] == 2


def test_audit_deltas_and_probe(t):
    d = t.inv.audit_deltas({"match": 10.0, "diverged": 1.0},
                           {"match": 14.0, "diverged": 1.0, "error": 2.0})
    assert d == {"match": 4, "diverged": 0, "error": 2}

    class Inner:
        feature = "x"

        def solve(self, inp, source="solver", max_nodes=None):
            return None

    probe = t.inv.SolveProbe(Inner(), t.inv.TrajectoryAuditor())
    assert probe.feature == "x"
    assert probe.solve(object()) is None  # a None result is not scored


def test_directory_load_stitches_oldest_first(t, tmp_path):
    for name, names, mtime in (("timeline-200.jsonl", ["c", "d"], 2000.0),
                               ("timeline-100.jsonl", ["a", "b"], 1000.0),
                               ("flight-1.jsonl", ["zzz"], 1000.0)):
        p = tmp_path / name
        with open(p, "w") as f:
            for n in names:
                f.write(json.dumps({"kind": "pod.add", "name": n}) + "\n")
        os.utime(p, (mtime, mtime))
    rows = t.rec.load_events(str(tmp_path))
    assert [r["name"] for r in rows] == ["a", "b", "c", "d"]


def test_state_digest_matches_reference():
    """`state_digest` over the same settled environment in both packages
    (with the fleet $/hr): equal."""
    out = []
    for name in ("jax", "port"):
        ns, tl = LOOPS[name], TL[name]
        env = mkenv(ns)
        for i in range(5):
            env.cluster.pods.create(ns.M.Pod(
                meta=ns.M.ObjectMeta(name=f"p{i}"),
                requests=ns.M.Resources.parse({"cpu": "1",
                                               "memory": "2Gi"})))
        env.settle()
        out.append(tl.inv.state_digest(env.cluster, env.pricing))
    assert out[0] == out[1]
