"""The port's rewind engine (`timeline/rewind.py`) against the JAX
package's.

The plumbing — `normalize`, `ticks_of`, `snap_to_tick`, `make_pod` —
gives equal output on both packages.  `tests/test_timeline.py`'s
`TestReplaySmall` stream, and a small composed day with every scenario of
BASELINE config #11 (spot storm, gang burst, priority wave, worker
crash), replay through both packages' manager drivers (the port's on the
CPU, where its kernels' plain versions run) to equal checkpoint digests
(`invariants.state_digest`), equal ledger records with their prices as
IEEE hex and equal timeline streams, with the fields that differ from run
to run (`ts`, `pid`, `trace_id`, the ledger's own) stripped; seek gives
the straight-line digest bit for bit.  A short operator-driver replay
gives the same invariant verdicts on both packages.

On the card a failed device solve raises instead of falling back to the
oracle: with `GatedSolver._on_card` forced true, the day's worker crash
(an armed `solver.dispatch` fault) must not end the replay — the manager
driver records a `ReconcileError` and settles the tick again, and every
pod binds with no `SolverFallback` event.
"""

import importlib
import json
from types import SimpleNamespace

import pytest
import torch

from karpenter_tpu_torch import workloads
from tests.test_torch_disruption import JAX as LJAX
from tests.test_torch_disruption import PORT as LPORT
from tests.test_torch_disruption import fresh_catalog

STRIPPED = ("ts", "pid", "trace_id")


def _pkg(root, loop):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, rewind=imp("timeline.rewind"), gen=imp(
            "timeline.generators"), rec=imp("timeline.recorder"),
        ledger=imp("utils.ledger"), flight=imp("utils.flightrecorder"),
        audit=imp("solver.audit"), faults=imp("utils.faults"),
        catalog=imp("providers.catalog"), M=imp("models"),
        state=imp("controllers.state"), loop=loop)


JAX = _pkg("karpenter_tpu", LJAX)
PORT = _pkg("karpenter_tpu_torch", LPORT)
PKGS = {"jax": JAX, "port": PORT}
DEVICE = {"jax": {}, "port": {"device": "cpu"}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Both packages' rings, the port's sampler and fault registry reset
    (tests/conftest.py resets the JAX package's), wide rings, and each
    package's default catalog read anew: another module's price refresh
    changes the JAX package's memoized copy in place."""
    for k in ("KARPENTER_TPU_TIMELINE", "KARPENTER_TPU_TIMELINE_DIR",
              "KARPENTER_TPU_LEDGER_DIR", "KARPENTER_TPU_AUDIT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KARPENTER_TPU_TIMELINE_BUFFER", "1000000")
    for p in PKGS.values():
        monkeypatch.setattr(p.catalog, "_loaded_catalog",
                            fresh_catalog(p.loop))

    def reset():
        for p in PKGS.values():
            p.rec.RECORDER.reset()
            p.ledger.LEDGER.reset()
            p.flight.RECORDER.reset()
        PORT.audit.SAMPLER.reset()
        PORT.faults.disarm()
    reset()
    yield
    reset()


def _small_stream(g):
    """tests/test_timeline.py TestReplaySmall's stream."""
    return g.compose(
        g.diurnal_load(seed=11, duration=900.0, step=300.0,
                       base=1, peak=2, lifetime=600.0),
        g.priority_wave(at=300.0, bands=((50, 1), (0, 1)), seed=11))


def _small_day(g, tick=240.0, day=1440.0):
    """BASELINE config #11's day cut to six ticks and a tenth of its
    load: the diurnal hum, a spot storm, a gang burst, a priority wave and
    one worker crash with its restart."""
    return g.compose(
        g.diurnal_load(seed=1107, duration=day, step=tick, base=2, peak=4,
                       lifetime=720.0),
        g.spot_storm(at=day * 0.45, reclaims=3, spacing=20.0, seed=1108),
        g.gang_burst(at=day * 0.6, gangs=2, size=3, spacing=8.0,
                     seed=1109),
        g.priority_wave(at=day * 0.75, bands=((1000, 2), (0, 2)),
                        seed=1110),
        g.crash_schedule(day * 0.3, restart_after=tick))


def _stream(p):
    r = p.rec.RECORDER
    return [{k: v for k, v in e.items() if k not in STRIPPED}
            for e in r.tail(len(r))]


def _ledger(p):
    out = []
    for r in p.ledger.LEDGER.tail(1 << 20):
        r = {k: v for k, v in r.items()
             if k not in workloads.LEDGER_NONDETERMINISTIC}
        for k in ("fleet_cost_before", "fleet_cost_after", "cost_delta"):
            if r.get(k) is not None:
                r[k] = float(r[k]).hex()
        out.append(r)
    return out


# -- the plumbing ---------------------------------------------------------------
def test_normalize_and_ticks_match():
    raw = [
        {"kind": "store.pods.added", "name": "b", "ts": 105.5,
         "data": {"cpu": "1"}},
        {"kind": "store.pods.modified", "name": "b", "ts": 106.0},
        {"kind": "store.pods.deleted", "name": "b", "ts": 300.0},
        {"kind": "pod.add", "name": "a", "at": 5.0},
        {"kind": "spot.reclaim", "name": "", "at": 5.0,
         "data": {"pick": 3}},
        {"kind": "price.refresh", "name": "", "ts": 100.0},
        "not-an-event", {"no": "kind"},
    ]
    outs = {}
    for name, p in PKGS.items():
        evs = p.rewind.normalize(raw)
        ticks = p.rewind.ticks_of(evs)
        snaps = [p.rewind.snap_to_tick(ticks, k) for k in range(8)]
        outs[name] = (evs, ticks, snaps)
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0]) == 5 and len(outs["port"][1]) == 4


def test_make_pod_matches():
    from karpenter_tpu.models import wellknown
    specs = [None, {"cpu": "750m", "memory": "2Gi"},
             {"requests": [1500.0, 4096.0, 0, 0, 1],
              "labels": {"team": "infra"},
              "annotations": {wellknown.PRIORITY_ANNOTATION: "10"}}]
    for spec in specs:
        a = JAX.rewind.make_pod("r-0", spec)
        b = PORT.rewind.make_pod("r-0", spec)
        assert list(b.requests.v) == list(a.requests.v)
        assert (b.meta.name, b.meta.labels, b.meta.annotations) == \
            (a.meta.name, a.meta.labels, a.meta.annotations)


def test_recorded_pod_spec_round_trips_on_the_port():
    M = PORT.M
    pod = M.Pod(meta=M.ObjectMeta(name="r-1", labels={"app": "x"}),
                requests=M.Resources.parse({"cpu": "750m",
                                            "memory": "2Gi"}))
    back = PORT.rewind.make_pod("r-1", PORT.rec.pod_spec(pod))
    assert list(back.requests.v) == list(pod.requests.v)
    assert back.meta.labels == pod.meta.labels


# -- the manager driver against the JAX package's ----------------------------------
def _seek_check(name, stream, resolution):
    p = PKGS[name]
    for q in PKGS.values():
        q.rec.RECORDER.reset()
        q.ledger.LEDGER.reset()
    chk = p.rewind.seek_check(stream, len(stream) // 2,
                              resolution=resolution, audit=False,
                              **DEVICE[name])
    return chk, _stream(p), _ledger(p)


@pytest.mark.parametrize("scenario", ["replay-small", "small-day"])
def test_manager_replay_matches_reference(scenario):
    make, res = {"replay-small": (_small_stream, 300.0),
                 "small-day": (_small_day, 240.0)}[scenario]
    out = {}
    for name, p in PKGS.items():
        stream = make(p.gen)
        out[name] = _seek_check(name, stream, res)
    (cj, tj, lj), (cp, tp, lp) = out["jax"], out["port"]
    assert cp["bit_identical"] and cj["bit_identical"]
    assert cp["k"] == cj["k"]
    assert cp["straight"]["checkpoints"] == cj["straight"]["checkpoints"]
    assert cp["straight_digest"] == cj["straight_digest"]
    for key in ("digest", "events_total", "events_applied", "solves",
                "pods_final", "scheduled_final", "nodes_final",
                "events_skipped", "ledger_rows_checked", "ledger_hex_exact",
                "zero_gang_atomicity_violations",
                "zero_priority_inversions", "zero_lost_pods"):
        assert cp["straight"][key] == cj["straight"][key], key
    assert cp["straight"]["events_applied"] == \
        cp["straight"]["events_total"]
    assert cp["straight"]["solves"] > 0
    assert lp == lj and lp
    assert tp == tj and tp


def test_operator_replay_matches_reference_verdicts():
    """A short replay through each package's real Operator (its own
    thread, the shadow audit at rate 1): the same invariant verdicts."""
    out = {}
    for name, p in PKGS.items():
        rep = p.rewind.replay(_small_stream(p.gen), driver="operator",
                              resolution=300.0, **DEVICE[name])
        out[name] = {k: rep[k] for k in (
            "ledger_hex_exact", "zero_gang_atomicity_violations",
            "zero_priority_inversions", "audit_clean", "zero_lost_pods",
            "invariants_held", "events_applied", "events_total",
            "pods_final", "scheduled_final")}
        assert rep["solves"] > 0
        assert rep["audit_verdict_deltas"].get("match", 0) > 0, name
    assert out["port"] == out["jax"]
    assert out["port"]["invariants_held"] is True


# -- the card's answer to a failed device solve -------------------------------------
def test_crash_tick_retries_on_the_card(monkeypatch):
    """The small day on a GatedSolver that acts as the card's: the worker
    crash's armed `solver.dispatch` error raises out of the solve, the
    manager driver records one `ReconcileError` and settles the tick
    again, no oracle answers it, and the replay ends with every pod bound
    and every invariant held."""
    monkeypatch.setattr(PORT.state.GatedSolver, "_on_card",
                        lambda self: True)
    eng = PORT.rewind.RewindEngine(_small_day(PORT.gen), resolution=240.0,
                                   audit=False, device="cpu")
    rep = eng.run(driver="manager")
    assert PORT.faults.fire_count("solver.dispatch") == 0  # disarmed after
    events = [e[3] for e in eng.env.cluster.events]
    assert rep["reconcile_errors"] == 1
    assert events.count("ReconcileError") == 1
    assert "SolverFallback" not in events
    assert rep["events_applied"] == rep["events_total"]
    assert rep["scheduled_final"] == rep["pods_final"] > 0
    assert rep["invariants_held"], json.dumps(rep, default=str)


# -- config #11's day ------------------------------------------------------------
def _config11_build_day():
    """`build_day` of benchmarks/config11_rewind.py, read from the file
    (not imported: importing it scrubs knobs from this process's
    environment), its constants with it, over the JAX package's
    generators."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "config11_rewind.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name == "build_day")
            or (isinstance(n, ast.Assign) and all(
                isinstance(t, ast.Name) and t.id.isupper()
                for t in n.targets))]
    ns = {"g": JAX.gen}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns


def test_rewind_day_is_config11s():
    """`workloads.build_rewind_day` (the port's generators) is config
    #11's day event for event, with its tick, length and floor."""
    ns = _config11_build_day()
    assert (workloads.REWIND_TICK, workloads.REWIND_DAY,
            workloads.REWIND_MIN_EVENTS) == (ns["TICK"], ns["DAY"],
                                             ns["MIN_EVENTS"])
    day = workloads.build_rewind_day()
    assert day == ns["build_day"](1107)
    assert len(day) >= workloads.REWIND_MIN_EVENTS
    kinds = {e["kind"] for e in day}
    assert {"pod.add", "pod.remove", "spot.reclaim", "worker.crash",
            "worker.restart"} <= kinds
