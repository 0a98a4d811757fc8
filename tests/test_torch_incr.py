"""The port's incremental group index against the JAX package's.

`TorchSolver(device="cpu", delta="on", incr=...)` and `TPUSolver(mesh=
"off", delta="on", incr=...)` take the scenarios of
`tests/test_solver_incr.py` (imported, not edited) in lockstep, the churn
fed to both as watch events through `delta_invalidate(pod_objs=...)`:
every pass's canonical result and hex price equal, the index's verdict
(`last_incr_reason`: None when it resolved the pass, else the counted
fallback reason) and the delta seam's outcome equal, on the engage paths
and on every fallback class.
"""

import pytest

from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import incr as tincr
from karpenter_tpu_torch.solver.encode import group_pods
from tests import test_solver_incr as si
from tests.test_torch_delta import Twin, one_torch_thread  # noqa: F401
from tests.test_torch_solve import canon
from tests.test_torch_sweep import to_port


def _incr(tw):
    r = tw.t._delta_cache.last_incr_reason
    assert r == tw.j._delta_cache.last_incr_reason
    return r


def _feed(tw, prev, cur):
    objs = si.churn_events(prev, cur)
    tw.invalidate(pods=set(objs), pod_objs=objs)


def test_engages_and_matches_walk_and_full():
    on = Twin(delta="on", incr="on")
    walk = TorchSolver(device="cpu", delta="on", incr="off")
    off = TorchSolver(device="cpu", delta="off", incr="off")
    prev = None
    verdicts = []
    for gen in range(4):
        pods = si.churn_pods(gen)
        if prev is not None:
            _feed(on, prev, pods)
        _, rt = on.solve(si.mkinput(list(pods)), f"gen {gen}")
        verdicts.append((_incr(on), on.outcome()))
        inp = to_port(si.mkinput(list(pods)))
        assert canon(walk.solve(inp)) == canon(rt) == canon(off.solve(inp))
        prev = pods
    assert verdicts == [("cold", ("fallback", "cold"))] + [
        (None, ("delta", None))] * 3
    assert on.t.incr_passes == {"fallback": 1, "incr": 3}


def test_identical_input_is_pure_reuse():
    tw = Twin(delta="on", incr="on")
    pods = si.churn_pods(0)
    tw.solve(si.mkinput(list(pods)))
    tw.solve(si.mkinput(list(pods)))
    assert _incr(tw) is None and tw.outcome() == ("delta", None)


def test_auto_unarmed_is_silent_and_arm_engages():
    tw = Twin(delta="on", incr="auto")
    for gen in range(2):
        tw.solve(si.mkinput(list(si.churn_pods(gen))))
    assert tw.t.incr_passes == {} and tw.outcome() == ("delta", None)
    armed = Twin(delta="on", incr="auto")
    armed.j.incr_arm()
    armed.t.incr_arm()
    pods = si.churn_pods(0)
    armed.solve(si.mkinput(list(pods)))
    armed.solve(si.mkinput(list(pods)))
    assert armed.t.incr_passes == {"fallback": 1, "incr": 1}


def test_env_knob(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_INCR", "off")
    s = TorchSolver(device="cpu", delta="on", incr="on")
    s.solve(to_port(si.mkinput(list(si.churn_pods(0)))))
    assert s.incr_passes == {}
    monkeypatch.setenv("KARPENTER_TPU_INCR", "on")
    s = TorchSolver(device="cpu", delta="on", incr="off")
    s.solve(to_port(si.mkinput(list(si.churn_pods(0)))))
    assert s.incr_passes == {"fallback": 1}
    assert s._delta_cache.last_incr_reason == "cold"
    monkeypatch.setenv("KARPENTER_TPU_INCR", "bogus")
    assert TorchSolver(device="cpu", incr="off")._resolve_incr() is False


def _warm():
    tw = Twin(delta="on", incr="on")
    pods = si.churn_pods(0)
    tw.solve(si.mkinput(list(pods)))
    assert _incr(tw) == "cold"
    return tw, pods


def test_flood_then_recovers():
    tw, pods = _warm()
    tw.invalidate(flood=True)
    tw.solve(si.mkinput(list(pods)))
    assert _incr(tw) == "flood"
    tw.solve(si.mkinput(list(pods)))
    assert _incr(tw) is None


def _bound_pod():
    p = si.mkpod("bound-1", cpu_m=100)
    p.node_name = "dn0"
    return p


@pytest.mark.parametrize("kind,reason", [
    ("names-only", "pods"), ("node-dirt", "nodes"),
    ("bound-pod", "nodes"), ("drift", "drift"), ("new-key", "order"),
    ("same-name", "order")])
def test_fallbacks_match_reference(kind, reason):
    tw, pods = _warm()
    inp_pods = list(pods)
    if kind == "names-only":
        tw.invalidate(pods=[pods[-1].meta.name])
    elif kind == "node-dirt":
        tw.invalidate(nodes=["some-node"])
    elif kind == "bound-pod":
        tw.invalidate(pods={"bound-1"}, pod_objs={"bound-1": _bound_pod()})
    elif kind == "drift":
        inp_pods.append(si.mkpod("ghost-1", cpu_m=90))
    elif kind == "new-key":
        novel = si.mkpod("novel-1", cpu_m=777)
        tw.invalidate(pods={"novel-1"}, pod_objs={"novel-1": novel})
        inp_pods.append(novel)
    elif kind == "same-name":
        name = pods[-1].meta.name
        tw.invalidate(pods={name},
                      pod_objs={name: si.mkpod(name, cpu_m=650)})
    tw.solve(si.mkinput(inp_pods))
    assert _incr(tw) == reason
    assert tw.t.incr_fallbacks.get(reason) == 1


def test_index_rebuild_and_advance():
    tw, pods = _warm()
    rec = tw.t._delta_cache.get_any()
    idx = tincr.index_from_record(rec)
    tin = to_port(si.mkinput(list(pods)))
    groups, m, reuse = tincr.build_groups(idx.snapshot(), tin)
    walk = group_pods(tin.pods)
    assert [[p.meta.name for p in g] for g in groups] == \
        [[p.meta.name for p in g] for g in walk]
    assert m == len(groups) and reuse == []
    # an engaged pass advances the same index object in place
    idx0 = tw.t._delta_cache.incr
    cur = si.churn_pods(1)
    _feed(tw, pods, cur)
    tw.solve(si.mkinput(list(cur)))
    assert _incr(tw) is None
    assert tw.t._delta_cache.incr is idx0 and idx0.dirty_count() == 0


def test_raced_store_retires_the_index():
    tw, pods = _warm()
    cache = tw.t._delta_cache
    stale = cache.dirty_snapshot()
    cache.invalidate(pods={"raced-pod"}, pod_objs={"raced-pod": None})
    rec = cache.get_any()
    cache.put(rec.cat, rec, consumed=stale)
    assert cache.incr is None
    # the JAX side takes the same race, so the verdicts stay in lockstep
    jc = tw.j._delta_cache
    jstale = jc.dirty_snapshot()
    jc.invalidate(pods={"raced-pod"}, pod_objs={"raced-pod": None})
    jrec = jc.get_any()
    jc.put(jrec.cat, jrec, consumed=jstale)
    tw.solve(si.mkinput(list(pods)))
    assert _incr(tw) == "cold"
    tw.solve(si.mkinput(list(pods)))
    assert _incr(tw) is None
