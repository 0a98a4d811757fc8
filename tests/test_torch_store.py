"""The port's external cluster stores against the JAX package's.

Every case runs one scenario on both packages — each package's own store
daemon (`store/remote.py`) or fake apiserver (`store/http.py`), and its
own backends and `Cluster` — and holds what the port observes to what
the JAX package observes, and both to the contract of
`tests/test_store_backend.py` and `tests/test_store_http.py`:

- the backends' protocol and contract: round trip, echo suppression,
  peer events, conflicts, the deleting verb, relist recovery, two
  replicas converging, finalizers replicating, stale updates that cannot
  resurrect — one test parametrised by backend where a case applies to
  both; the 410 relist that synthesizes deletes and the three relist
  race windows (`http`), and `wait_events` failing fast on a dead watch
  stream (`remote`);
- the fake apiserver's wire transcripts, status and document for each
  request, equal between the packages;
- the loops through an external store: the provisioning loop at 300
  pods through `remote` and at 24 through `http` (about 44 ms a request:
  the server writes each response in two sends, and the second waits on
  the client's delayed ACK), and `test_torch_disruption.fuzz_run` through
  `remote`.  Each gives the JAX loop's answer, decision-ledger records
  and timeline stream through the same backend; the JAX loop's records
  through the store equal its records in memory;
- what a store holds: every kind the port's `Cluster` stores comes back
  from the daemon with no torch class in its pickle, and the daemon runs
  in a process of its own (`python -m karpenter_tpu_torch.store`).

`python3 tests/test_torch_store.py --pin` prints the JAX loop's answers
and records through the http store at chip_smoke.py's reduced size
(HTTP_LOOP_PODS, HTTP_LOOP_WAVE2), the constants chip_smoke.py pins as
`HTTP_LOOP` and `HTTP_LOOP_OBSERVED`.
"""

import http.client
import importlib
import io
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import pytest
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

from karpenter_tpu_torch import workloads  # noqa: E402
from tests import test_torch_disruption as dis  # noqa: E402
from tests import test_torch_provisioning as prov  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, store=imp("store"), http=imp("store.http"),
        cluster=imp("cluster"), clock=imp("utils.clock"), M=imp("models"),
        objects=imp("models.objects"), faults=imp("utils.faults"),
        metrics=imp("utils.metrics"), ledger=imp("utils.ledger"),
        timeline=imp("timeline.recorder"),
        obs=workloads.Observability(
            metrics=imp("utils.metrics"), ledger=imp("utils.ledger"),
            invariants=imp("timeline.invariants"),
            flightrecorder=imp("utils.flightrecorder"),
            timeline=imp("timeline.recorder")))


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")
KINDS = ("remote", "http")


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


class Stores:
    """One package's store server of one kind and the backends opened on
    it, closed together."""

    def __init__(self, ns, kind, retain_events=4096):
        self.ns, self.kind = ns, kind
        if kind == "remote":
            self.server = ns.store.StoreDaemon(tempfile.mktemp(
                prefix="kt_store_test_", suffix=".sock"))
        else:
            self.server = ns.store.FakeApiServer(retain_events=retain_events)
        self._open = []

    def backend(self):
        if self.kind == "remote":
            b = self.ns.store.RemoteBackend(self.server.path)
        else:
            b = self.ns.store.HttpBackend(self.server.url)
        self._open.append(b)
        return b

    def cluster(self):
        return self.ns.cluster.Cluster(clock=self.ns.clock.FakeClock(),
                                       backend=self.backend())

    def close(self):
        for b in self._open:
            b.close()
        self.server.close()


@pytest.fixture()
def stores():
    opened = []

    def make(ns, kind, **kw):
        s = Stores(ns, kind, **kw)
        opened.append(s)
        return s
    yield make
    for s in opened:
        s.close()


def mkpod(ns, name, cpu="500m", mem="1Gi"):
    return ns.M.Pod(meta=ns.M.ObjectMeta(name=name),
                    requests=ns.M.Resources.parse({"cpu": cpu,
                                                   "memory": mem}))


def both(fn, *args):
    """`fn(ns, *args)` for the port and for the JAX package."""
    return fn(PORT, *args), fn(JAX, *args)


def _watching(be, kind):
    """An HttpBackend's watch on `kind` starts with its first load (as an
    informer's reflector does); a RemoteBackend watches from its
    constructor."""
    if hasattr(be, "_watchers"):
        be.load(kind)
    return be


def _collect(be, n, timeout=10.0):
    evs, deadline = [], time.time() + timeout
    while len(evs) < n and time.time() < deadline:
        evs += be.events()
        time.sleep(0.01)
    return evs


# -- the backends' contract, both kinds -----------------------------------------
def _roundtrip(ns, stores, kind):
    be = stores(ns, kind).backend()
    pod = mkpod(ns, "p1")
    ok = be.put("pods", "p1", pod, verb="added")
    loaded = be.load("pods")
    got = loaded["p1"]
    out = (ok, sorted(loaded), got is not pod, got.meta.name,
           [float(x) for x in got.requests.v])
    be.delete("pods", "p1")
    return out + (be.load("pods"),)


@pytest.mark.parametrize("kind", KINDS)
def test_put_list_delete_roundtrip(kind, stores):
    got, ref = both(_roundtrip, stores, kind)
    assert got == ref
    assert got[:4] == (True, ["p1"], True, "p1") and got[5] == {}
    assert got[4] == [float(x) for x in mkpod(PORT, "x").requests.v]


def _echo(ns, stores, kind):
    be = _watching(stores(ns, kind).backend(), "pods")
    be.put("pods", "p1", mkpod(ns, "p1"), verb="added")
    if hasattr(be, "wait_events"):
        # event-driven absence check: False = no echo came
        quiet = be.wait_events(1, timeout=0.25) is False
    else:
        time.sleep(0.3)
        quiet = True
    return quiet, be.events()


@pytest.mark.parametrize("kind", KINDS)
def test_echo_suppression(kind, stores):
    got, ref = both(_echo, stores, kind)
    assert got == ref == (True, [])


def _peer(ns, stores, kind):
    s = stores(ns, kind)
    a, b = s.backend(), _watching(s.backend(), "nodes")
    a.put("nodes", "n1", mkpod(ns, "n1"), verb="added")
    a.delete("nodes", "n1")
    return [(k, v, n) for k, v, n, _ in _collect(b, 2)]


@pytest.mark.parametrize("kind", KINDS)
def test_peer_events_flow(kind, stores):
    got, ref = both(_peer, stores, kind)
    assert got == ref == [("nodes", "added", "n1"),
                          ("nodes", "deleted", "n1")]


def _conflicts(ns, stores, kind):
    be = stores(ns, kind).backend()
    out = [be.put("pods", "p1", mkpod(ns, "p1"), verb="added"),
           # create of an existing name: rejected (apiserver 409)
           be.put("pods", "p1", mkpod(ns, "p1"), verb="added")]
    be.delete("pods", "p1")
    # modify of a deleted name: rejected (apiserver 404), no resurrection
    out.append(be.put("pods", "p1", mkpod(ns, "p1"), verb="modified"))
    return out, sorted(be.load("pods"))


@pytest.mark.parametrize("kind", KINDS)
def test_conflict_semantics(kind, stores):
    got, ref = both(_conflicts, stores, kind)
    assert got == ref == ([True, False, False], [])


def _deleting(ns, stores, kind):
    s = stores(ns, kind)
    a, b = s.backend(), _watching(s.backend(), "pods")
    pod = mkpod(ns, "f1")
    a.put("pods", "f1", pod, verb="added")
    pod.meta.deletion_time = 1.0
    a.put("pods", "f1", pod, verb="deleting")
    evs = _collect(b, 2)
    return [(v, n) for _, v, n, _ in evs], evs[-1][3].meta.deleting


@pytest.mark.parametrize("kind", KINDS)
def test_deleting_verb_reaches_peers(kind, stores):
    got, ref = both(_deleting, stores, kind)
    assert got == ref == ([("added", "f1"), ("deleting", "f1")], True)


def _relist(ns, stores, kind):
    s = stores(ns, kind)
    c1 = s.cluster()
    c1.nodepools.create(ns.M.NodePool(meta=ns.M.ObjectMeta(name="default")))
    c1.pods.create(mkpod(ns, "p1"))
    c2 = s.cluster()
    return (c2.nodepools.get("default") is not None,
            c2.pods.get("p1") is not None,
            c2.pods.get("p1") is not c1.pods.get("p1"))


@pytest.mark.parametrize("kind", KINDS)
def test_relist_recovery(kind, stores):
    """Recovery = relist: a fresh cluster hydrates its informer cache from
    the store's authoritative copies, as distinct objects."""
    got, ref = both(_relist, stores, kind)
    assert got == ref == (True, True, True)


def _converge(ns, stores, kind):
    s = stores(ns, kind)
    a, b = s.cluster(), s.cluster()
    a.pods.create(mkpod(ns, "p1"))
    seen = b.wait_synced(lambda: b.pods.get("p1") is not None, timeout=10.0)
    pod_b = b.pods.get("p1")
    pod_b.phase = "Running"
    b.pods.update(pod_b)
    back = a.wait_synced(lambda: a.pods.get("p1").phase == "Running",
                         timeout=10.0)
    return seen, back


@pytest.mark.parametrize("kind", KINDS)
def test_two_replicas_converge(kind, stores):
    got, ref = both(_converge, stores, kind)
    assert got == ref == (True, True)


def _finalizers(ns, stores, kind):
    s = stores(ns, kind)
    a, b = s.cluster(), s.cluster()
    pod = mkpod(ns, "f1")
    pod.meta.finalizers = ["test/finalizer"]
    a.pods.create(pod)
    a.pods.delete("f1")  # only marks deleting

    def deleting_visible():
        got = b.pods.get("f1")
        return got is not None and got.meta.deleting

    marked = b.wait_synced(deleting_visible, timeout=10.0)
    a.pods.remove_finalizer("f1", "test/finalizer")
    gone = b.wait_synced(lambda: b.pods.get("f1") is None, timeout=10.0)
    return marked, gone


@pytest.mark.parametrize("kind", KINDS)
def test_finalizer_flow_replicates(kind, stores):
    got, ref = both(_finalizers, stores, kind)
    assert got == ref == (True, True)


def _stale(ns, stores, kind):
    s = stores(ns, kind)
    a, b = s.cluster(), s.cluster()
    a.pods.create(mkpod(ns, "z1"))
    seen = b.wait_synced(lambda: b.pods.get("z1") is not None, timeout=10.0)
    stale = b.pods.get("z1")
    a.pods.delete("z1")
    # b's cache still holds z1: the guard that matters is the store's
    stale.phase = "Running"
    b.pods.update(stale)
    gone = b.wait_synced(lambda: b.pods.get("z1") is None, timeout=10.0)
    authoritative = sorted(s.backend().load("pods"))
    # a LOCAL stale update (the cache already dropped it) is a no-op
    a.pods.update(stale)
    return seen, gone, authoritative, a.pods.get("z1")


@pytest.mark.parametrize("kind", KINDS)
def test_stale_update_cannot_resurrect(kind, stores):
    got, ref = both(_stale, stores, kind)
    assert got == ref == (True, True, [], None)


# -- the remote store's own cases ----------------------------------------------
def _dead_stream(ns, stores):
    s = stores(ns, "remote")
    b = s.backend()
    s.server.close()
    deadline = time.time() + 5
    while not b._watch_dead and time.time() < deadline:
        time.sleep(0.01)
    t0 = time.monotonic()
    ok = b.wait_events(1, timeout=30.0)
    return ok, time.monotonic() - t0 < 5.0


def test_wait_events_fails_fast_on_dead_stream(stores):
    """A dead watch stream fails a late waiter at once instead of letting
    it sleep out its timeout."""
    got, ref = both(_dead_stream, stores)
    assert got == ref == (False, True)


def _rpc_fault(ns, stores):
    be = stores(ns, "remote").backend()
    ns.faults.arm("store.remote.rpc", "drop", times=1)
    try:
        with pytest.raises(ConnectionError, match="injected fault"):
            be.put("pods", "p1", mkpod(ns, "p1"), verb="added")
        # the budget is spent: the next RPC goes through
        ok = be.put("pods", "p1", mkpod(ns, "p1"), verb="added")
        return ok, ns.faults.fire_count("store.remote.rpc"), sorted(
            be.load("pods"))
    finally:
        ns.faults.disarm()


def test_rpc_fault_is_a_connection_error(stores):
    """The `store.remote.rpc` fault point turns an injected drop into the
    store's own failure type."""
    got, ref = both(_rpc_fault, stores)
    assert got == ref == (True, 1, ["p1"])


# -- the kube list/watch store's own cases --------------------------------------
def _req(server, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    payload = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=payload,
                 headers={"Content-Type": "application/json"} if payload
                 else {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, (json.loads(data) if data else {})


def _item(name, data="payload"):
    return {"apiVersion": "karpenter.tpu/v1", "kind": "Pod",
            "metadata": {"name": name}, "data": data}


def _transcript(ns, stores):
    """Status and document of each request of a fixed sequence against a
    fresh fake apiserver."""
    s = stores(ns, "http").server
    g = ns.http.GROUP_PATH
    seq = [("POST", f"{g}/pods", _item("a")), ("GET", f"{g}/pods", None),
           ("POST", f"{g}/pods", _item("a")),
           ("PUT", f"{g}/pods/ghost", _item("ghost")),
           ("DELETE", f"{g}/pods/ghost", None),
           ("POST", f"{g}/pods", _item("b")),
           ("POST", f"{g}/pods", _item("c")),
           ("PUT", f"{g}/pods/a", _item("a", "v2")),
           ("GET", f"{g}/pods/a", None), ("DELETE", f"{g}/pods/a", None),
           ("GET", f"{g}/pods", None), ("GET", f"{g}/nodes", None),
           ("GET", "/api/v1/pods", None), ("PUT", f"{g}/pods", _item("x")),
           ("POST", f"{g}/pods", {"metadata": {}})]
    return [_req(s, m, p, b) for m, p, b in seq]


def test_wire_transcript_matches_reference(stores):
    got, ref = both(_transcript, stores)
    assert got == ref
    assert [st for st, _ in got] == [201, 200, 409, 404, 404, 201, 201,
                                     200, 200, 200, 200, 200, 404, 405,
                                     422]
    # the kube list envelope and monotonic resourceVersions
    doc = got[1][1]
    assert (doc["kind"], doc["apiVersion"]) == ("PodsList",
                                                "karpenter.tpu/v1")
    # the writes' resourceVersions (POST a, b, c, PUT a, DELETE a)
    rvs = [int(got[i][1]["metadata"]["resourceVersion"])
           for i in (0, 5, 6, 7, 9)]
    assert rvs == [1, 2, 3, 4, 5]
    assert got[8][1]["metadata"]["resourceVersion"] == "4"


def _watch_stream(ns, stores):
    s = stores(ns, "http").server
    g = ns.http.GROUP_PATH
    _, doc = _req(s, "POST", f"{g}/pods", _item("a"))
    rv0 = int(doc["metadata"]["resourceVersion"])
    conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=10)
    conn.request("GET", f"{g}/pods?watch=true&resourceVersion={rv0}")
    resp = conn.getresponse()
    head = (resp.status, resp.headers.get("Transfer-Encoding"))
    _req(s, "PUT", f"{g}/pods/a", _item("a", "v2"))
    _req(s, "DELETE", f"{g}/pods/a")
    evs = [json.loads(resp.readline()) for _ in range(2)]
    conn.close()
    return head, evs


def test_watch_stream_is_chunked_json_events(stores):
    got, ref = both(_watch_stream, stores)
    assert got == ref
    head, (ev1, ev2) = got
    assert head == (200, "chunked")
    assert ev1["type"] == "MODIFIED" and ev1["object"]["data"] == "v2"
    assert ev2["type"] == "DELETED" and ev2["object"]["metadata"][
        "name"] == "a"


def _gone(ns, stores):
    s = stores(ns, "http", retain_events=4).server
    g = ns.http.GROUP_PATH
    for i in range(10):
        _req(s, "POST", f"{g}/pods", _item(f"p{i}"))
    conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=10)
    conn.request("GET", f"{g}/pods?watch=true&resourceVersion=1")
    status = conn.getresponse().status
    conn.close()
    return status


def test_watch_gone_when_log_trimmed(stores):
    got, ref = both(_gone, stores)
    assert got == ref == 410  # Gone: the client must relist


def _gap(ns, stores):
    s = stores(ns, "http", retain_events=4)
    a, b = s.backend(), s.backend()
    a.put("pods", "keep", mkpod(ns, "keep"), verb="added")
    a.put("pods", "gone", mkpod(ns, "gone"), verb="added")
    listed = sorted(b.load("pods"))
    # push b's watch horizon off the log, deleting "gone" inside the gap
    a.delete("pods", "gone")
    for i in range(8):
        a.put("pods", f"x{i}", mkpod(ns, f"x{i}"), verb="added")
    deadline, seen = time.time() + 10, {}
    while time.time() < deadline:
        for _, v, n, _ in b.events():
            seen[n] = v
        if "gone" in seen and seen.get("x7") is not None:
            break
        time.sleep(0.02)
    return listed, seen.get("gone"), sorted(
        n for n in seen if n.startswith("x")
        and seen[n] in ("added", "modified"))


def test_410_gap_recovery_synthesizes_deletes(stores):
    got, ref = both(_gap, stores)
    assert got == ref
    assert got == (["gone", "keep"], "deleted", [f"x{i}" for i in range(8)])


def _raced_backend(ns, stores, names):
    b = stores(ns, "http").backend()
    for n in names:
        b.put("pods", n, mkpod(ns, n), verb="added")
    with b._lock:
        b._known["pods"] = set(names)
    return b


def _racing(b, action):
    """Run `action` between the relist's list GET and its diff."""
    orig, raced = b._request, []

    def racy(method, path, body=None):
        status, doc = orig(method, path, body)
        if method == "GET" and path.endswith("/pods") and not raced:
            raced.append(action())
        return status, doc
    b._request = racy
    return raced


def _put_during_relist(ns, stores):
    b = _raced_backend(ns, stores, ["keep"])
    raced = _racing(b, lambda: b.put("pods", "fresh", mkpod(ns, "fresh"),
                                     verb="added"))
    rv = b._relist_after_gap("pods")
    return (raced, rv > 0, [e[:3] for e in b.events()],
            "fresh" in b._known["pods"])


def test_put_committing_during_relist_is_not_synthesized_deleted(stores):
    """A create racing the list snapshot is not synthesized into a
    delete."""
    got, ref = both(_put_during_relist, stores)
    assert got == ref
    raced, fresh_rv, evs, known = got
    assert raced == [True] and fresh_rv and known
    assert ("pods", "deleted", "fresh") not in evs


def _delete_before_relist(ns, stores):
    b = _raced_backend(ns, stores, ["gone", "keep"])
    b._watchers["pods"] = None  # the marker path needs a live watcher
    b.delete("pods", "gone")
    marked = b._pending_deletes[("pods", "gone")] > 0
    rv = b._relist_after_gap("pods")
    return (marked, rv > 0, ("pods", "gone") in b._pending_deletes,
            [e[:3] for e in b.events()])


def test_own_delete_completing_before_relist_drops_its_marker(stores):
    got, ref = both(_delete_before_relist, stores)
    assert got == ref
    marked, fresh_rv, kept, evs = got
    assert marked and fresh_rv and not kept
    assert all(n != "gone" for _, _, n in evs)


def _delete_during_relist(ns, stores):
    b = _raced_backend(ns, stores, ["doomed", "keep"])
    b._watchers["pods"] = None
    _racing(b, lambda: b.delete("pods", "doomed"))
    rv = b._relist_after_gap("pods")
    return (rv > 0, b._pending_deletes[("pods", "doomed")] > rv,
            [e[:3] for e in b.events()])


def test_own_delete_committing_during_relist_keeps_its_marker(stores):
    got, ref = both(_delete_during_relist, stores)
    assert got == ref
    fresh_rv, ahead, evs = got
    assert fresh_rv and ahead
    assert all(n != "doomed" for _, _, n in evs)


# -- the loops through an external store ------------------------------------------
def _strip(rows):
    return [{k: v for k, v in r.items()
             if k not in workloads.LEDGER_NONDETERMINISTIC} for r in rows]


def _records(ns):
    """The package's whole ledger and timeline rings, stripped."""
    led, tl = ns.ledger.LEDGER, ns.timeline.RECORDER
    return _strip(led.tail(len(led))), _strip(tl.tail(len(tl)))


@pytest.fixture()
def wide_rings(monkeypatch):
    """Rings that hold a whole loop, emptied before and after."""
    monkeypatch.setenv("KARPENTER_TPU_TIMELINE_BUFFER", "1000000")
    monkeypatch.setenv("KARPENTER_TPU_LEDGER_BUFFER", "100000")
    for k in ("KARPENTER_TPU_TIMELINE_DIR", "KARPENTER_TPU_LEDGER_DIR",
              "KARPENTER_TPU_TIMELINE", "KARPENTER_TPU_LEDGER"):
        monkeypatch.delenv(k, raising=False)
    yield
    for ns in (JAX, PORT):
        ns.obs.reset()


def _provisioning(ns, stores, kind, n, n2):
    """The provisioning loop of `tests/test_torch_provisioning.py` through
    `kind` ("memory", "remote" or "http") at `n` pods, then `n2` of the
    two smallest sizes: per wave the loop's answer, the delta seam's
    verdict and what the ledger and timeline recorded; the whole rings;
    the oracle solves and SolverFallback events."""
    ns.obs.reset()
    backend = None if kind == "memory" else stores(ns, kind).backend()
    loop = prov.build_loop(prov.JAX if ns is JAX else prov.PORT, n,
                           store_backend=backend)
    watch = workloads.WaveObserver(ns.obs)
    oracle0 = prov.oracle_solves(loop.ns)
    waves = []
    for wave in (1, 2):
        if wave == 2:
            prov.add_pods(loop, n2, "w", workloads.WAVE2_SIZES)
        watch.start(loop.cluster)
        rounds = loop.manager.run_until_idle()
        c = loop.solver.tpu._delta_cache
        waves.append((workloads.loop_answer(loop.cluster, loop.cloud,
                                            rounds),
                      (c.last_outcome, c.last_reason, c.last_incr_reason),
                      watch.finish(loop.cluster)))
    fallbacks = [e for e in loop.cluster.events if e[3] == "SolverFallback"]
    return (waves, _records(ns),
            (prov.oracle_solves(loop.ns) - oracle0, len(fallbacks)))


@pytest.mark.parametrize("kind,n,n2", [("remote", 300, 30),
                                       ("http", 24, 3)])
def test_provisioning_loop_through_store_matches_reference(
        kind, n, n2, stores, wide_rings):
    ref_memory = _provisioning(JAX, stores, "memory", n, n2)
    ref = _provisioning(JAX, stores, kind, n, n2)
    got = _provisioning(PORT, stores, kind, n, n2)
    # the JAX loop records the same through the store as in memory, so
    # the in-memory pins (chip_smoke.LOOP, LOOP_OBSERVED) hold for it
    assert ref == ref_memory
    assert got == ref
    (w1, _, obs1), (w2, _, _) = got[0]
    assert (w1["bound"], w2["bound"], w1["unbound"], w2["unbound"]) == (
        n, n + n2, 0, 0)
    assert obs1["ledger"]["records"] == {"provisioning": 1}
    assert got[2] == (0, 0)  # the device path answered: no oracle


def _fuzz(ns, seed):
    ns.obs.reset()
    out, prices, _, env = dis.fuzz_run(dis.JAX if ns is JAX else dis.PORT,
                                       seed)
    backend = type(env.store_backend).__name__
    env.close()
    return out, [p.hex() for p in prices], _records(ns), backend


@pytest.mark.parametrize("seed", [0, 1])
def test_disruption_fuzz_run_through_remote_matches_reference(
        seed, monkeypatch, wide_rings):
    """`test_torch_disruption.fuzz_run` with every Environment on its own
    store daemon (KARPENTER_TPU_STORE_BACKEND=remote): the JAX loop's
    trace, hex prices, ledger records and timeline stream."""
    monkeypatch.setenv("KARPENTER_TPU_STORE_BACKEND", "remote")
    got, ref = both(_fuzz, seed)
    assert got[3] == ref[3] == "RemoteBackend"
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    assert got[2][0] and got[2][1]


def _disruption(ns, stores, n):
    """`workloads.disruption_loop` at `n` nodes with its Environment on an
    explicit RemoteBackend: its waves and the records."""
    ns.obs.reset()
    be = stores(ns, "remote").backend()
    dns = dis.JAX if ns is JAX else dis.PORT
    env = workloads.disruption_loop(
        n, options=dns.Options(batch_idle_duration=0, solver_mesh="off"),
        catalog=dis.fresh_catalog(dns), pkg=dis.loop_pkg(dns),
        store_backend=be)
    w = workloads.DisruptionWaves(env)
    waves = [w.wave1(), w.wave2()]
    return waves, _records(ns), env.store_backend is be


def test_disruption_loop_on_an_explicit_store_matches_reference(
        stores, wide_rings):
    got, ref = both(_disruption, stores, 12)
    assert got == ref
    waves, _, explicit = got
    assert explicit and waves[0]["instances"] == 12
    assert waves[1]["disruption"]["acts"] and waves[1]["instances"] < 12


# -- what a store holds -------------------------------------------------------------
class _NoTorch(pickle.Unpickler):
    """Unpickles what the port's models pickle, and refuses any class of
    torch (a tensor, or the solver that holds them)."""

    def find_class(self, module, name):
        assert module.split(".")[0] in ("karpenter_tpu_torch", "builtins",
                                        "collections", "copyreg",
                                        "datetime"), (module, name)
        return super().find_class(module, name)


def test_every_stored_kind_pickles_without_torch(monkeypatch, stores):
    """A settled environment on a store daemon, with an object of each of
    the Cluster's kinds: every stored pickle loads with no torch class,
    and round-trips to the same bytes."""
    monkeypatch.setenv("KARPENTER_TPU_STORE_BACKEND", "remote")
    env = dis.mkenv(dis.PORT)
    try:
        for i in range(6):
            env.cluster.pods.create(dis.mkpod(dis.PORT, f"p{i}", cpu="2"))
        env.cluster.pdbs.create(PORT.objects.PodDisruptionBudget(
            meta=PORT.M.ObjectMeta(name="pdb0"), selector={"app": "x"}))
        env.settle()
        raw = stores(PORT, "remote")  # a second client on env's daemon
        be = PORT.store.RemoteBackend(env.store_daemon.path)
        raw._open.append(be)
        counts = {}
        for kind in env.cluster._stores:
            items = be._call({"op": "list", "kind": kind})["items"]
            counts[kind] = len(items)
            for name, data in items.items():
                obj = _NoTorch(io.BytesIO(data)).load()
                assert obj.meta.name == name
                assert pickle.loads(pickle.dumps(
                    obj, protocol=pickle.HIGHEST_PROTOCOL)) is not obj
        assert counts == {
            "pods": 6, "nodes": len(env.cluster.nodes.list()),
            "nodeclaims": len(env.cluster.nodeclaims.list()),
            "nodepools": 1, "nodeclasses": 1, "pdbs": 1}
        assert counts["nodes"] > 0
    finally:
        env.close()


def test_store_daemon_runs_in_a_process_of_its_own():
    """`python -m karpenter_tpu_torch.store <socket>`: clients on two
    backends see each other's writes through it, and SIGTERM stops it
    with exit code 0."""
    sock = tempfile.mktemp(prefix="kt_store_test_", suffix=".sock")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.store", sock],
        stdout=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        assert proc.stdout.readline().strip().endswith(sock)
        a = PORT.store.RemoteBackend(sock)
        b = PORT.store.RemoteBackend(sock)
        a.put("pods", "p1", mkpod(PORT, "p1"), verb="added")
        assert b.wait_events(1, timeout=10.0)
        assert [e[:3] for e in b.events()] == [("pods", "added", "p1")]
        assert sorted(b.load("pods")) == ["p1"]
        a.close()
        b.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        proc.stdout.close()
    assert rc == 0
    assert not os.path.exists(sock)


def _pin():
    """The JAX package's answers for chip_smoke.py phase 20(b): its
    provisioning loop through the http store at HTTP_LOOP_PODS and
    HTTP_LOOP_WAVE2 pods, per wave `loop_answer` (HTTP_LOOP), then what
    its ledger and timeline recorded (HTTP_LOOP_OBSERVED)."""
    import chip_smoke
    os.environ["KARPENTER_TPU_LEDGER_BUFFER"] = "100000"
    opened = []

    def make(ns, kind, **kw):
        opened.append(Stores(ns, kind, **kw))
        return opened[-1]
    try:
        waves, _, fell = _provisioning(JAX, make, "http",
                                       chip_smoke.HTTP_LOOP_PODS,
                                       chip_smoke.HTTP_LOOP_WAVE2)
        writes = [s.server._rv for s in opened]
    finally:
        for s in opened:
            s.close()
    for answer, seams, _ in waves:
        print(answer, seams)
    for _, _, observed in waves:
        print(observed)
    print("oracle solves, SolverFallback events:", fell)
    print("writes the server took (its last resourceVersion):", writes)


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin"]:
        _pin()
