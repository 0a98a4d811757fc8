"""The port's fault-injection harness (`utils/faults.py`) against the JAX
package's.

- The registry units of `tests/test_faults.py` (env parsing and its
  errors, the disarmed no-op, budgets, delay, truncate then stream kill,
  `after`), run on both packages; `arm` writes the same `fault.inject`
  timeline event in both, and `KARPENTER_TPU_FAULTS` arms the port at
  import.
- The `solver.dispatch` point at its three solver sites (the solve's
  `execute`, the delta seam, the chunk chain's dispatch): a solve fires
  it as often in the port as in the JAX package, and an armed error
  raises out of the delta seam in both.
- `GatedSolver` under an armed one-shot `solver.dispatch` error: both
  packages fall back to the oracle with the same answer, the same
  `SolverFallback` event and the same `fault.inject` event, and the next
  solve takes the device path again; both answers are
  `chip_smoke.FAULT_SOLVES`, the second of which phase 20(c) holds the
  card to.  With `_on_card` patched to True (the port's solver on the
  card) the injected fault raises like every other failure, with no
  oracle solve and no SolverFallback event, and the next solve takes the
  device path; it, a `RuntimeError` and a fault of another point raise
  from `solve`, `solve_batch` and `warmup`.
"""

import importlib
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from tests import test_solver_delta as sd
from tests import test_spec as ts
from tests.test_torch_delta import Twin
from tests.test_torch_solve import JAX as SJAX
from tests.test_torch_solve import PORT as SPORT
from tests.test_torch_solve import canon, headline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIPPED = ("ts", "pid", "trace_id")


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, faults=imp("utils.faults"), timeline=imp(
            "timeline.recorder"), flight=imp("utils.flightrecorder"),
        ledger=imp("utils.ledger"), metrics=imp("utils.metrics"),
        state=imp("controllers.state"), cluster=imp("cluster"),
        clock=imp("utils.clock"), opts=imp("operator.options"),
        solve=SJAX if root == "karpenter_tpu" else SPORT)


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")
PKGS = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scans on one intra-op thread (beside JAX in one process
    torch's default threads are ~15x slower); restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_faults_disarmed():
    """tests/conftest.py disarms the JAX package's fault registry around
    every test; the port keeps its own, disarmed here the same way."""
    PORT.faults.disarm()
    yield
    PORT.faults.disarm()


@pytest.fixture(params=sorted(PKGS))
def faults(request):
    return PKGS[request.param].faults


# -- the registry units of tests/test_faults.py, on both packages -------------
def test_env_parsing(faults):
    n = faults.load_env("service.client.send=delay:0.01,"
                        "solverd.handle_batch=crash::1")
    assert n == 2
    assert faults.armed("service.client.send")
    assert faults.armed("solverd.handle_batch")
    faults.disarm("service.client.send")
    assert not faults.armed("service.client.send")
    assert faults.armed()  # the crash spec is still there


def test_env_parsing_rejects_garbage(faults):
    with pytest.raises(ValueError):
        faults.load_env("not-a-spec")
    with pytest.raises(ValueError):
        faults.load_env("point=warp-core-breach")


def test_disarmed_fire_is_a_noop(faults):
    payload = b"abc"
    assert faults.fire("anything", payload) is payload


def test_times_budget(faults):
    faults.arm("p", "drop", times=2)
    for _ in range(2):
        with pytest.raises(faults.FaultInjected):
            faults.fire("p")
    # budget spent: inert
    assert faults.fire("p", b"x") == b"x"
    assert faults.fire_count("p") == 2


def test_delay_sleeps(faults):
    faults.arm("p", "delay", arg=0.05, times=1)
    t0 = time.perf_counter()
    faults.fire("p")
    assert time.perf_counter() - t0 >= 0.04


def test_truncate_then_stream_kill(faults):
    faults.arm("p", "truncate", times=1)
    out = faults.fire("p", b"0123456789")
    assert out == b"01234"  # default: half
    # the follow-up kills the stream even though the budget is spent
    with pytest.raises(faults.FaultInjected):
        faults.fire("p", b"more")
    # ...exactly once: the spec is retired afterwards
    assert faults.fire("p", b"again") == b"again"


def test_after_skips_leading_hits(faults):
    faults.arm("p", "drop", times=1, after=2)
    assert faults.fire("p", b"1") == b"1"
    assert faults.fire("p", b"2") == b"2"
    with pytest.raises(faults.FaultInjected):
        faults.fire("p")
    assert faults.fire("p", b"4") == b"4"


def _empty_rings(ns):
    """The package's timeline, flight and ledger rings emptied: a timeline
    event carries the newest flight and ledger seq, which earlier tests
    in the process advance."""
    ns.timeline.RECORDER.reset()
    ns.flight.RECORDER.reset()
    ns.ledger.LEDGER.reset()


def _injects(ns):
    r = ns.timeline.RECORDER
    return [{k: v for k, v in e.items() if k not in STRIPPED}
            for e in r.tail(len(r)) if e["kind"] == "fault.inject"]


def test_arm_writes_the_reference_timeline_event():
    out = {}
    for name, ns in PKGS.items():
        _empty_rings(ns)
        ns.faults.arm("solver.dispatch", "error", times=1)
        ns.faults.arm("store.remote.rpc", "delay", arg=0.5, after=3)
        out[name] = _injects(ns)
        ns.faults.disarm()
        ns.timeline.RECORDER.reset()
    assert out["port"] == out["jax"]
    assert [(e["name"], e["data"]) for e in out["port"]] == [
        ("solver.dispatch",
         {"mode": "error", "arg": None, "times": 1, "after": 0}),
        ("store.remote.rpc",
         {"mode": "delay", "arg": 0.5, "times": None, "after": 3})]


def test_environment_arms_the_port_at_import():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from karpenter_tpu_torch.utils import faults\n"
        "from karpenter_tpu_torch.timeline import recorder\n"
        "r = recorder.RECORDER\n"
        "print(faults.armed('store.remote.rpc'), faults.armed('x.y'),\n"
        "      [e['name'] for e in r.tail(len(r))\n"
        "       if e['kind'] == 'fault.inject'])\n")
    env = dict(os.environ, KARPENTER_TPU_FAULTS="store.remote.rpc=drop::2,"
               "x.y=delay:0.1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == (
        "True True ['store.remote.rpc', 'x.y']")


# -- the solver.dispatch sites --------------------------------------------------
def _count_fires(tw, inp):
    """Solve `inp` on both sides of a Twin with a zero-delay spec on
    `solver.dispatch` armed in each package: (port fires, JAX fires)."""
    fires = []
    for ns in (PORT, JAX):
        ns.faults.arm("solver.dispatch", "delay", arg=0.0)
    try:
        tw.solve(inp)
        fires = (PORT.faults.fire_count("solver.dispatch"),
                 JAX.faults.fire_count("solver.dispatch"))
    finally:
        for ns in (PORT, JAX):
            ns.faults.disarm()
    return fires


def test_dispatch_fires_at_the_solve_and_the_delta_seam():
    existing = sd.mknodes(4)
    tw = Twin(delta="on")
    cold = _count_fires(tw, sd.mkinput(sd.churn_pods(0), existing))
    assert tw.outcome() == ("fallback", "cold")
    delta = _count_fires(tw, sd.mkinput(sd.churn_pods(1), existing))
    assert tw.outcome() == ("delta", None)
    assert cold[0] == cold[1] >= 1
    assert delta[0] == delta[1] >= 1
    # an armed error raises out of the delta seam in both packages, and
    # the pass succeeds once the fault is gone.  The JAX side solves
    # first, as in `Twin.solve`: the port's copies of its pods carry the
    # group ids the JAX package interned for them
    nxt = sd.mkinput(sd.churn_pods(2), existing)
    for side, ns in (("j", JAX), ("t", PORT)):
        ns.faults.arm("solver.dispatch", "error", times=1)
        solver = tw.t if side == "t" else tw.j
        with pytest.raises(ns.faults.FaultInjected):
            solver.solve(tw.port(nxt) if side == "t" else nxt)
        assert ns.faults.fire_count("solver.dispatch") == 1
        ns.faults.disarm()
    tw.solve(nxt)
    assert tw.outcome() == ("delta", None)


def test_dispatch_fires_at_each_chunk_of_the_chain():
    tw = Twin(max_nodes=512, spec="on")
    fires = _count_fires(tw, ts.mkinput(ts.huge_pods()))
    chunks = tw.t.last_spec["chunks"]
    assert tw.t.last_spec["outcome"] == "spec" and chunks >= 2
    assert fires[0] == fires[1] >= chunks


# -- GatedSolver under an injected dispatch fault --------------------------------
def _gated(ns):
    opts = ns.opts.Options(solver_mesh="off")
    cluster = ns.cluster.Cluster(clock=ns.clock.FakeClock())
    kw = {"device": "cpu"} if ns is PORT else {}
    return ns.state.GatedSolver(opts, cluster, **kw), cluster


def _armed_solves(ns, n):
    """A fresh GatedSolver solves the headline's first `n` pods twice with
    a one-shot `solver.dispatch` error armed: each answer, the
    SolverFallback events, the fault.inject events, the fire count and
    the oracle solves."""
    _empty_rings(ns)
    gs, cluster = _gated(ns)
    inp = headline(ns.solve, n)
    oracle0 = ns.metrics.SOLVER_SOLVES.value(path="oracle")
    ns.faults.arm("solver.dispatch", "error", times=1)
    try:
        first = gs.solve(inp, source="provisioning")
        fallbacks = [tuple(e[1:5]) for e in cluster.events
                     if e[3] == "SolverFallback"]
        oracle1 = ns.metrics.SOLVER_SOLVES.value(path="oracle") - oracle0
        second = gs.solve(inp, source="provisioning")
        fired = ns.faults.fire_count("solver.dispatch")
    finally:
        ns.faults.disarm()
    pins = tuple((len(r.new_claims), len(r.unschedulable),
                  float(r.total_price()).hex(), chip_smoke.result_digest(r))
                 for r in (first, second))
    return {"answers": (canon(first), canon(second)), "pins": pins,
            "fallbacks": fallbacks, "injects": _injects(ns), "fired": fired,
            "oracle": (oracle1, ns.metrics.SOLVER_SOLVES.value(
                path="oracle") - oracle0),
            "events": len(cluster.events)}


def test_armed_dispatch_error_falls_back_as_the_reference():
    ref = _armed_solves(JAX, 2000)
    got = _armed_solves(PORT, 2000)
    assert got == ref
    # the answers chip_smoke.py phase 20(c) holds the card to
    assert got["pins"] == chip_smoke.FAULT_SOLVES
    assert got["fallbacks"] == [
        ("Provisioner", "provisioning", "SolverFallback",
         "injected fault at 'solver.dispatch' (error)")]
    assert [e["name"] for e in got["injects"]] == ["solver.dispatch"]
    assert got["fired"] == 1
    # the first solve was the oracle's, the second the device path's
    assert got["oracle"] == (1, 1) and got["events"] == 1
    unsched = got["answers"][1][2]
    assert unsched == [] and got["answers"][0][2] == []


def test_on_the_card_an_injected_dispatch_fault_raises(monkeypatch):
    gs, cluster = _gated(PORT)
    monkeypatch.setattr(gs, "_on_card", lambda: True)
    inp = headline(SPORT, 64)
    plain = canon(gs.solve(inp))
    _empty_rings(PORT)
    oracle0 = PORT.metrics.SOLVER_SOLVES.value(path="oracle")
    PORT.faults.arm("solver.dispatch", "error", times=1)
    with pytest.raises(PORT.faults.FaultInjected) as e:
        gs.solve(inp, source="provisioning")
    assert e.value.point == "solver.dispatch"
    assert PORT.faults.fire_count("solver.dispatch") == 1
    assert [x["name"] for x in _injects(PORT)] == ["solver.dispatch"]
    # the next solve takes the device path and gives its answer
    assert canon(gs.solve(inp, source="provisioning")) == plain
    assert PORT.metrics.SOLVER_SOLVES.value(path="oracle") == oracle0
    assert cluster.events == []
    PORT.faults.disarm()
    # every failure on the card raises, the injected dispatch fault too:
    # no oracle, no event
    for exc in (RuntimeError("kernel launch failed"),
                PORT.faults.FaultInjected("store.remote.rpc", "error"),
                PORT.faults.FaultInjected("solver.dispatch", "error")):
        def boom(*a, exc=exc, **kw):
            raise exc
        for attr in ("solve", "solve_batch", "warmup"):
            monkeypatch.setattr(gs.tpu, attr, boom)
        with pytest.raises(type(exc)):
            gs.solve(inp, source="provisioning")
        with pytest.raises(type(exc)):
            list(gs.solve_batch([inp]))
        with pytest.raises(type(exc)):
            gs.warmup(inp)
    assert PORT.metrics.SOLVER_SOLVES.value(path="oracle") == oracle0
    assert cluster.events == []
