"""The port's multi-tenant solverd dispatch layer
(`karpenter_tpu_torch/service/scheduler.py`) against the JAX package's:
the 28 cases of `tests/test_tenant_scheduler.py` on the port —
TenantScheduler unit semantics (DRR fairness, weights, priority
admission, deadline sheds, bucket fusion), the client-side
shed/backpressure contract, and the end-to-end loopback topology (real
framing + real window + the port's backend on the CPU) — plus one
differential case feeding both packages' `handle_batch` the same payload
lists in the same order.
"""

import os
import threading
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu_torch import workloads  # noqa: E402
from karpenter_tpu_torch.models import NodePool, ObjectMeta, Pod, Resources  # noqa: E402
from karpenter_tpu_torch.providers import generate_catalog  # noqa: E402
from karpenter_tpu_torch.providers.catalog import CatalogSpec  # noqa: E402
from karpenter_tpu_torch.scheduling import ScheduleInput, Scheduler  # noqa: E402
from karpenter_tpu_torch.service import (  # noqa: E402
    CircuitBreaker,
    RetryPolicy,
    SolverServiceClient,
    SolverServiceShed,
    SolverServiceTransportError,
    TenantScheduler,
)
from karpenter_tpu_torch.service.scheduler import parse_weights  # noqa: E402

CATALOG = generate_catalog(CatalogSpec(max_types=12, include_gpu=False))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # torch beside JAX in one process: one intra-op thread
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
POOL = NodePool(meta=ObjectMeta(name="default"))


def mkinp(tag, n=10, classes=1):
    pods = [Pod(meta=ObjectMeta(name=f"{tag}-p{c}-{i}"),
                requests=Resources.parse(
                    {"cpu": f"{500 + 10 * c}m", "memory": "1Gi"}))
            for c in range(classes) for i in range(n)]
    return ScheduleInput(pods=pods, nodepools=[POOL],
                         instance_types={"default": CATALOG})


# --------------------------------------------------------------------------
# TenantScheduler units (no device, fake dispatch)
# --------------------------------------------------------------------------
class _Collector:
    """Records dispatch batches and answers each item."""

    def __init__(self, delay=0.0):
        self.batches = []
        self.delay = delay

    def __call__(self, key, batch):
        self.batches.append([(it.tenant, it.payload) for it in batch])
        if self.delay:
            time.sleep(self.delay)
        return [("result", it.payload) for it in batch]


def _submit(sched, resp, tenant, payload, key="K", priority=0,
            deadline=None):
    return sched.submit(key=key, tenant=tenant, priority=priority,
                        deadline=deadline, payload=payload,
                        respond=lambda r, p=payload: resp.__setitem__(p, r))


class TestSchedulerUnits:
    def test_cross_tenant_fusion_same_bucket(self):
        sched = TenantScheduler(quantum=8, max_fuse=64,
                                batch_tiers=(8, 64))
        resp, coll = {}, _Collector()
        items = [_submit(sched, resp, t, f"{t}-{i}")
                 for t in ("a", "b", "c") for i in range(2)]
        sched.pump(items, coll)
        # one compatible bucket, three tenants → ONE fused dispatch
        assert len(coll.batches) == 1
        assert {t for t, _ in coll.batches[0]} == {"a", "b", "c"}
        assert all(resp[f"{t}-{i}"][0] == "result"
                   for t in ("a", "b", "c") for i in range(2))
        st = sched.stats()
        assert st["cross_tenant_batches"] == 1
        assert st["tenants"]["a"]["dispatched"] == 2

    def test_batches_trim_to_kernel_tiers(self):
        """Demand-weighted batch sizing: a 9-deep compatible backlog
        dispatches as exact kernel tiers (4,4,1), never a 9-wide batch
        the device would pad to 16."""
        sched = TenantScheduler(quantum=16, max_fuse=64,
                                batch_tiers=(4, 16, 64))
        resp, coll = {}, _Collector()
        items = [_submit(sched, resp, "a", f"a{i}") for i in range(9)]
        sched.pump(items, coll)
        assert [len(b) for b in coll.batches] == [4, 4, 1]
        # trimmed items kept their arrival order across requeues
        served = [p for b in coll.batches for _, p in b]
        assert served == [f"a{i}" for i in range(9)]

    def test_incompatible_buckets_never_fuse(self):
        sched = TenantScheduler(quantum=8)
        resp, coll = {}, _Collector()
        items = [_submit(sched, resp, "a", "a0", key="K1"),
                 _submit(sched, resp, "b", "b0", key="K2")]
        sched.pump(items, coll)
        assert len(coll.batches) == 2
        assert all(len(b) == 1 for b in coll.batches)

    def test_fuse_off_knob_dispatches_singly(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_TPU_TENANT_FUSE", "off")
        sched = TenantScheduler(quantum=8)
        resp, coll = {}, _Collector()
        items = [_submit(sched, resp, "a", f"a{i}") for i in range(4)]
        sched.pump(items, coll)
        assert len(coll.batches) == 4
        assert all(len(b) == 1 for b in coll.batches)

    def test_single_tenant_wide_batch_not_fragmented(self):
        """A lone tenant's 64-deep compatible backlog (the consolidation
        sweep shape) rides ONE fused dispatch — fairness credit must not
        fragment it when there is nobody to be fair to; and 63 stays
        whole too (pad waste under the keep threshold)."""
        sched = TenantScheduler(quantum=8, max_fuse=64,
                                batch_tiers=(4, 16, 64))
        resp, coll = {}, _Collector()
        items = [_submit(sched, resp, "a", f"a{i}") for i in range(64)]
        sched.pump(items, coll)
        assert [len(b) for b in coll.batches] == [64]
        resp2, coll2 = {}, _Collector()
        items = [_submit(sched, resp2, "a", f"b{i}") for i in range(63)]
        sched.pump(items, coll2)
        assert [len(b) for b in coll2.batches] == [63]

    def test_conn_tenant_state_is_garbage_collected(self, monkeypatch):
        from karpenter_tpu_torch.service import scheduler as sched_mod
        from karpenter_tpu_torch.utils import metrics
        monkeypatch.setattr(sched_mod, "TENANT_GC_CAP", 4)
        sched = TenantScheduler(quantum=8)
        resp, coll = {}, _Collector()
        for i in range(12):
            items = [_submit(sched, resp, f"conn-{i}", f"c{i}")]
            sched.pump(items, coll)
        st = sched.stats()
        # old empty conn queues evicted, rotation/cursor consistent
        assert len(st["tenants"]) <= 5
        assert "conn-11" in st["tenants"]
        # their gauge/counter series went with them
        series = metrics.SERVICE_TENANT_QUEUE_DEPTH._values
        with metrics.SERVICE_TENANT_QUEUE_DEPTH._lock:
            assert ("conn-0",) not in series

    def test_admission_rejected_arrival_not_counted_as_admitted(self):
        from karpenter_tpu_torch.utils import metrics
        sched = TenantScheduler(queue_bound=1)
        resp = {}
        before = metrics.SERVICE_TENANT_REQUESTS.value(tenant="denom")
        _submit(sched, resp, "denom", "ok")
        _submit(sched, resp, "denom", "rejected")  # same priority: shed
        after = metrics.SERVICE_TENANT_REQUESTS.value(tenant="denom")
        # the fairness denominator counts ADMITTED requests only
        assert after == before + 1
        assert resp["rejected"][0] == "shed"

    def test_drr_fairness_light_tenant_not_starved(self, monkeypatch):
        # incompatible buckets force one dispatch per request, so the
        # DISPATCH ORDER is the fairness signal: the heavy tenant's 6
        # queued requests must not all run before the light tenant's 2
        monkeypatch.setenv("KARPENTER_TPU_TENANT_FUSE", "off")
        sched = TenantScheduler(quantum=1)
        resp, coll = {}, _Collector()
        items = [_submit(sched, resp, "heavy", f"h{i}") for i in range(6)]
        items += [_submit(sched, resp, "light", f"l{i}") for i in range(2)]
        sched.pump(items, coll)
        order = [b[0][0] for b in coll.batches]
        # both light requests served within the first four dispatches
        assert order[:4].count("light") == 2, order

    def test_weighted_share(self, monkeypatch):
        # weight 3 vs 1 with per-request dispatches: gold gets ~3x the
        # early service slots
        monkeypatch.setenv("KARPENTER_TPU_TENANT_FUSE", "off")
        sched = TenantScheduler(quantum=1,
                                weights={"gold": 3.0, "free": 1.0})
        resp, coll = {}, _Collector()
        items = [_submit(sched, resp, "gold", f"g{i}") for i in range(6)]
        items += [_submit(sched, resp, "free", f"f{i}") for i in range(6)]
        sched.pump(items, coll)
        order = [b[0][0] for b in coll.batches]
        first8 = order[:8]
        assert first8.count("gold") >= 5, order
        assert sched.stats()["tenants"]["gold"]["weight"] == 3.0

    def test_admission_sheds_lowest_priority_first(self):
        sched = TenantScheduler(queue_bound=2)
        resp = {}
        _submit(sched, resp, "a", "low1", priority=1)
        _submit(sched, resp, "a", "low2", priority=1)
        # queue full: an even-lower arrival is shed itself...
        it3 = _submit(sched, resp, "a", "lower", priority=0)
        assert it3.answered
        assert resp["lower"][0] == "shed"
        assert resp["lower"][1]["reason"] == "admission"
        assert "retry_after_ms" in resp["lower"][1]
        # ...while a HIGHER-priority arrival evicts a queued low one
        it4 = _submit(sched, resp, "a", "high", priority=9)
        assert not it4.answered
        shed_low = [p for p in ("low1", "low2") if p in resp]
        assert len(shed_low) == 1
        assert resp[shed_low[0]][0] == "shed"
        st = sched.stats()
        assert st["tenants"]["a"]["shed"]["admission"] == 2
        # the queue still holds exactly queue_bound entries
        assert st["tenants"]["a"]["queued"] == 2

    def test_deadline_shed_while_queued(self):
        """A request whose deadline passes WHILE QUEUED behind a slow
        dispatch is shed (counted, reason=deadline), never solved."""
        now = time.time()
        sched = TenantScheduler(quantum=8)
        resp = {}
        coll = _Collector(delay=0.6)
        # same tenant, different buckets: the first seeds the first
        # batch; the second waits out the slow dispatch and expires
        items = [_submit(sched, resp, "a", "slow", key="K1"),
                 _submit(sched, resp, "a", "doomed", key="K2",
                         deadline=now + 0.4)]
        sched.pump(items, coll)
        assert resp["slow"][0] == "result"
        assert resp["doomed"][0] == "shed"
        assert resp["doomed"][1]["reason"] == "deadline"
        assert sched.stats()["tenants"]["a"]["shed"]["deadline"] == 1
        # the doomed request never reached the device
        assert all("doomed" not in [p for _, p in b] for b in coll.batches)

    def test_deadline_pressure_seeds_early_dispatch(self):
        """A request whose deadline is INSIDE the pressure window ships
        first (partial bucket) even when another tenant is ahead in the
        rotation."""
        now = time.time()
        sched = TenantScheduler(quantum=8)
        resp, coll = {}, _Collector()
        items = [_submit(sched, resp, "a", "calm", key="K1"),
                 _submit(sched, resp, "b", "pressed", key="K2",
                         deadline=now + 0.05)]
        sched.pump(items, coll)
        assert coll.batches[0][0][1] == "pressed"
        assert resp["pressed"][0] == "result"

    def test_backpressure_hint_and_ewma(self):
        sched = TenantScheduler()
        resp, coll = {}, _Collector(delay=0.05)
        sched.note_backlog(7)
        hint = sched.backpressure()
        assert hint["queue_depth"] == 7
        items = [_submit(sched, resp, "a", "x")]
        sched.pump(items, coll)
        st = sched.stats()
        assert st["ewma_dispatch_ms"] >= 40.0
        assert sched.backpressure()["eta_ms"] > 0

    def test_parse_weights(self):
        assert parse_weights("gold=4, free=1") == {"gold": 4.0, "free": 1.0}
        assert parse_weights("bad, x=0, y=oops") == {"x": 0.1}
        assert parse_weights(None) == {}

    def test_weights_file_config_surface(self, tmp_path, monkeypatch):
        # weights from the config file
        # (operator-options surface), env knob stays the OVERRIDE
        from karpenter_tpu_torch.service.scheduler import load_weights
        f = tmp_path / "weights.conf"
        f.write_text(
            "# tiers\n"
            "gold=4, silver=2\n"
            "free=1   # the rest\n"
            "typo-no-equals\n")
        monkeypatch.setenv("KARPENTER_TPU_TENANT_WEIGHTS_FILE", str(f))
        monkeypatch.delenv("KARPENTER_TPU_TENANT_WEIGHTS",
                           raising=False)
        assert load_weights() == {"gold": 4.0, "silver": 2.0,
                                  "free": 1.0}
        # env OVERRIDES per tenant, file entries it doesn't name stay
        monkeypatch.setenv("KARPENTER_TPU_TENANT_WEIGHTS",
                           "gold=8,platinum=16")
        assert load_weights() == {"gold": 8.0, "silver": 2.0,
                                  "free": 1.0, "platinum": 16.0}
        # the scheduler picks the merged view up by default
        sched = TenantScheduler()
        assert sched._weights["gold"] == 8.0
        assert sched._weights["silver"] == 2.0

    def test_weights_file_missing_degrades(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_TPU_TENANT_WEIGHTS_FILE",
                           "/nonexistent/weights.conf")
        monkeypatch.setenv("KARPENTER_TPU_TENANT_WEIGHTS", "a=2")
        from karpenter_tpu_torch.service.scheduler import load_weights
        assert load_weights() == {"a": 2.0}

    def test_weights_file_bad_bytes_degrades(self, tmp_path, monkeypatch):
        # code-review regression: UnicodeDecodeError is not an OSError —
        # a binary/latin-1 file must degrade, not crash the daemon
        f = tmp_path / "weights.bin"
        f.write_bytes(b"gold=\xff\xfe4\n")
        monkeypatch.setenv("KARPENTER_TPU_TENANT_WEIGHTS_FILE", str(f))
        monkeypatch.setenv("KARPENTER_TPU_TENANT_WEIGHTS", "a=2")
        from karpenter_tpu_torch.service.scheduler import load_weights
        assert load_weights() == {"a": 2.0}

    def test_supervisor_flag_exports_weights_file(self, monkeypatch):
        # --tenant-weights-file lands in the WORKER env (export-only;
        # the scheduler inside the worker owns the parse)
        captured = {}
        from karpenter_tpu_torch.service import supervisor as sup_mod

        class FakeSup:
            def __init__(self, *a, **kw):
                captured.update(kw)
                raise KeyboardInterrupt  # stop main() before start()

        monkeypatch.setattr(sup_mod, "SolverdSupervisor", FakeSup)
        try:
            sup_mod.main(["--socket", "/tmp/x.sock",
                          "--tenant-weights-file", "/etc/kt/weights"])
        except KeyboardInterrupt:
            pass
        assert captured["env"]["KARPENTER_TPU_TENANT_WEIGHTS_FILE"] \
            == "/etc/kt/weights"

    def test_concurrent_pumps_fuse_across_threads(self):
        """Two threads submitting compatible items concurrently: one
        becomes the dispatcher and carries the other's items; both pumps
        return with everything answered."""
        sched = TenantScheduler(quantum=8)
        resp = {}
        coll = _Collector(delay=0.05)
        barrier = threading.Barrier(2)

        def run(tenant):
            barrier.wait()
            items = [_submit(sched, resp, tenant, f"{tenant}-{i}")
                     for i in range(3)]
            sched.pump(items, coll)

        ts = [threading.Thread(target=run, args=(t,)) for t in ("a", "b")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert len(resp) == 6
        assert all(r[0] == "result" for r in resp.values())


# --------------------------------------------------------------------------
# RetryPolicy backpressure hint
# --------------------------------------------------------------------------
class TestRetryAfter:
    def test_retry_after_replaces_exponential_ladder(self):
        p = RetryPolicy(base_backoff=0.05, multiplier=2.0, max_backoff=2.0,
                        jitter=0.0)
        assert p.backoff(3) == pytest.approx(0.2)
        # the server hint wins over the ladder...
        assert p.backoff(3, retry_after=0.7) == pytest.approx(0.7)
        # ...clamped to max_backoff and floored at base_backoff
        assert p.backoff(1, retry_after=60.0) == pytest.approx(2.0)
        assert p.backoff(1, retry_after=1e-6) == pytest.approx(0.05)
        # absent/zero hint falls back to the ladder
        assert p.backoff(2, retry_after=None) == pytest.approx(0.1)
        assert p.backoff(2, retry_after=0) == pytest.approx(0.1)

    def test_jitter_still_applies_to_hint(self):
        p = RetryPolicy(jitter=0.2, max_backoff=10.0)
        vals = {round(p.backoff(1, retry_after=1.0), 6)
                for _ in range(32)}
        assert len(vals) > 1
        assert all(0.8 <= v <= 1.2 for v in vals)


class TestShedClass:
    def test_from_body_and_classes(self):
        e = SolverServiceShed.from_body(
            {"reason": "admission", "tenant": "a", "queue_depth": 3,
             "eta_ms": 120.0, "retry_after_ms": 120.0})
        assert isinstance(e, SolverServiceTransportError)
        assert e.reason == "admission"
        assert e.retry_after == pytest.approx(0.12)
        assert e.backpressure["queue_depth"] == 3


# --------------------------------------------------------------------------
# End-to-end: real framing + window + backend via the loopback daemon
# --------------------------------------------------------------------------
@pytest.fixture(scope="class")
def small_backend():
    """Pin the in-process backend to a small single-device solver so the
    loopback solves stay in the service tests' warmed shape class."""
    from karpenter_tpu_torch.service import backend
    from karpenter_tpu_torch.solver import TorchSolver
    saved = backend._solver
    backend._solver = TorchSolver(max_nodes=128, device="cpu", mesh="off",
                                  delta="off")
    yield backend
    backend._solver = saved


@pytest.fixture()
def loopback(small_backend, tmp_path):
    from karpenter_tpu_torch.service.loopback import LoopbackSolverd
    d = LoopbackSolverd(str(tmp_path / "lb.sock"), idle_ms=20, max_ms=400)
    yield d
    d.close()


@pytest.fixture()
def wide_loopback(small_backend, tmp_path):
    """The loopback daemon with a coalescing window wide enough that six
    requests started together land in one window on a loaded machine
    (the tier-1 run's six workers): a 250 ms idle gap, at most 2 s."""
    from karpenter_tpu_torch.service.loopback import LoopbackSolverd
    d = LoopbackSolverd(str(tmp_path / "lb.sock"), idle_ms=250, max_ms=2000)
    yield d
    d.close()


class TestLoopbackEndToEnd:
    def test_multi_tenant_traffic_fuses_with_parity(self, wide_loopback):
        loopback = wide_loopback
        clients = {t: SolverServiceClient(loopback.socket_path, timeout=120,
                                          tenant=t)
                   for t in ("alpha", "beta", "gamma")}
        try:
            clients["alpha"].solve(mkinp("warm"))  # compile out of the way
            outs = {}
            start = threading.Barrier(6)

            def call(t, i):
                inp = mkinp(f"{t}{i}", n=10 + i)
                start.wait(timeout=60)  # the six requests leave together
                outs[(t, i)] = clients[t].solve(inp)

            threads = [threading.Thread(target=call, args=(t, i))
                       for t in clients for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert len(outs) == 6
            assert all(not r.unschedulable for r in outs.values())
            # bit-exact parity vs a solo local solve
            local = Scheduler(mkinp("alpha0", 10)).solve()
            remote = outs[("alpha", 0)]
            assert remote.node_count() == local.node_count()
            assert abs(remote.total_price() - local.total_price()) < 1e-9
            st = clients["alpha"].stats()
            sched = st["scheduler"]
            assert set(sched["tenants"]) >= {"alpha", "beta", "gamma"}
            # the window coalesced concurrent compatible tenants
            assert sched["cross_tenant_batches"] >= 1
            # every result carried the backpressure hint
            assert clients["alpha"].last_backpressure is not None
            assert "eta_ms" in clients["alpha"].last_backpressure
        finally:
            for c in clients.values():
                c.close()

    def test_connection_derived_tenant_default(self, loopback):
        c = SolverServiceClient(loopback.socket_path, timeout=120)
        try:
            c.solve(mkinp("anon"))
            sched = c.stats()["scheduler"]
            assert any(t.startswith("conn-") for t in sched["tenants"])
        finally:
            c.close()

    def test_admission_shed_is_transport_class_and_breaker_neutral(
            self, loopback, small_backend):
        """Queue bound 0: every schedule is admission-shed.  The client
        must see the transport-class SolverServiceShed (fallback paths
        engage), retry at the server's pace, and leave the breaker
        CLOSED — a shedding daemon is alive, not down."""
        saved = small_backend._scheduler
        small_backend._scheduler = TenantScheduler(queue_bound=0)
        br = CircuitBreaker(threshold=2, cooldown=30.0)
        c = SolverServiceClient(
            loopback.socket_path, timeout=20,
            retry=RetryPolicy(attempts=2, base_backoff=0.01, jitter=0.0,
                              deadline=20),
            breaker=br, tenant="shedme")
        try:
            with pytest.raises(SolverServiceShed) as ei:
                c.solve(mkinp("sh"))
            assert isinstance(ei.value, SolverServiceTransportError)
            assert ei.value.reason == "admission"
            # two attempts, both shed — and the breaker saw SUCCESSES
            assert br.state == "closed"
            assert c.last_backpressure is not None
            st = c.stats()
            assert st["shed"] >= 2
            sh = st["scheduler"]["tenants"]["shedme"]["shed"]
            assert sh["admission"] >= 2
        finally:
            c.close()
            small_backend._scheduler = saved

    def test_partial_shed_retries_only_missing_inputs(self, loopback,
                                                      small_backend):
        """One shed inside a multi-request solve_batch keeps the results
        that DID arrive and retries only the shed inputs — a batch with
        one admission-shed member must not double the offered load
        exactly when the daemon asked for pacing."""
        saved = small_backend._scheduler
        small_backend._scheduler = TenantScheduler(queue_bound=2)
        c = SolverServiceClient(
            loopback.socket_path, timeout=120,
            retry=RetryPolicy(attempts=3, base_backoff=0.01, jitter=0.0,
                              deadline=120),
            tenant="partial")
        try:
            c.solve(mkinp("pwarm"))  # catalog + compile, bound 2 is fine
            results = c.solve_batch([mkinp(f"pt{i}", n=8 + i)
                                     for i in range(4)])
            assert len(results) == 4
            assert all(not r.unschedulable for r in results)
            st = c.stats()["scheduler"]["tenants"]["partial"]
            # the overflow was shed once and re-sent alone — 4 requests
            # dispatched in total, not 4 + a full-batch retry
            assert st["shed"].get("admission", 0) >= 1
            assert st["dispatched"] == 5  # warm + the 4 batch members
        finally:
            c.close()
            small_backend._scheduler = saved

    def test_deadline_shed_while_queued_end_to_end(self, loopback,
                                                   small_backend,
                                                   monkeypatch):
        """A request expiring WHILE QUEUED behind a
        slow dispatch is shed daemon-side (counted), the caller gets a
        transport-class error (its own deadline passed too), and the
        breaker does not trip."""
        import karpenter_tpu_torch.service.backend as backend_mod
        real = backend_mod._solve_group

        def slow_group(inps, max_nodes=None):
            time.sleep(1.2)
            return [Scheduler(i).solve() for i in inps]

        try:
            br = CircuitBreaker(threshold=5, cooldown=30.0)
            slow_c = SolverServiceClient(loopback.socket_path, timeout=30,
                                         tenant="slowpoke")
            fast_c = SolverServiceClient(
                loopback.socket_path, timeout=0.8,
                retry=RetryPolicy(attempts=1, deadline=0.8),
                breaker=br, tenant="doomed")
            # warm BOTH clients' catalog ledgers and the pod-class
            # buckets while the daemon is idle and dispatch is real:
            # the doomed request below must spend its whole budget
            # QUEUED, not on a catalog upload or a cold trace
            slow_c.solve(mkinp("wm", n=10))
            # the 4-class bucket's first trace is seconds; pay it on the
            # patient client so the fast client's warm is warm indeed
            slow_c.solve(mkinp("wm4", n=3, classes=4))
            fast_c.solve(mkinp("wm2", n=3, classes=4))
            shed0 = small_backend._shed_count
            monkeypatch.setattr(backend_mod, "_solve_group", slow_group)
            outs = {}

            def slow_call():
                outs["slow"] = slow_c.solve(mkinp("sl", n=10))

            t = threading.Thread(target=slow_call)
            t.start()
            time.sleep(0.25)  # land in the same window, behind the slow one
            # different bucket (4 pod classes) so it queues behind the
            # slow request's dispatch instead of fusing with it
            with pytest.raises(SolverServiceTransportError):
                fast_c.solve(mkinp("dm", n=3, classes=4))
            t.join(timeout=60)
            assert outs["slow"].node_count() >= 1
            assert br.state == "closed"
            # the daemon counted the queued-expiry shed
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                sh = slow_c.stats()["scheduler"]["tenants"] \
                    .get("doomed", {}).get("shed", {})
                if sh.get("deadline", 0) >= 1:
                    break
                time.sleep(0.1)
            assert sh.get("deadline", 0) >= 1
            assert small_backend._shed_count > shed0
            slow_c.close()
            fast_c.close()
        finally:
            monkeypatch.setattr(backend_mod, "_solve_group", real)

    def test_reset_worker_state_clears_dispatch_history(self, loopback):
        c = SolverServiceClient(loopback.socket_path, timeout=120,
                                tenant="r")
        try:
            c.solve(mkinp("rst"))
            from karpenter_tpu_torch.service import backend
            assert c.stats()["batch_sizes"]
            backend.reset_worker_state()
            st = c.stats()
            assert st["batch_sizes"] == []
            assert st["shed"] == 0
            # catalogs survive a logical reset (content-addressed; the
            # need_catalog handshake re-validates) so the next solve on
            # the same connection still works
            assert c.solve(mkinp("rst2")).node_count() >= 1
        finally:
            c.close()


# --------------------------------------------------------------------------
# Differential: both packages' handle_batch on the same frames
# --------------------------------------------------------------------------
def _frames(pkg_root, fp):
    """The same frame lists in each package's classes: a window holding
    a catalog upload, four schedule requests from three tenants in two
    buckets (1 and 3 pod classes), one for an unknown catalog and a
    malformed frame; then a window of two more compatible requests."""
    import importlib
    import pickle
    M = importlib.import_module(f"{pkg_root}.models")
    prov = importlib.import_module(f"{pkg_root}.providers")
    spec = importlib.import_module(f"{pkg_root}.providers.catalog")
    catalog = prov.generate_catalog(spec.CatalogSpec(max_types=12,
                                                     include_gpu=False))
    pool = M.NodePool(meta=M.ObjectMeta(name="default"))

    def pods(tag, n, classes):
        return [M.Pod(meta=M.ObjectMeta(name=f"{tag}-p{c}-{i}"),
                      requests=M.Resources.parse(
                          {"cpu": f"{500 + 10 * c}m", "memory": "1Gi"}))
                for c in range(classes) for i in range(n)]

    def sched(tag, n, classes, tenant, f=fp):
        return pickle.dumps(("schedule", {
            "fingerprint": f, "pods": pods(tag, n, classes),
            "tenant": tenant, "max_nodes": None}))
    first = [pickle.dumps(("catalog", {"fingerprint": fp,
                                       "nodepools": [pool],
                                       "instance_types": {"default":
                                                          catalog}})),
             sched("a0", 10, 1, "a"), sched("b0", 12, 1, "b"),
             sched("a1", 3, 3, "a"), sched("c0", 4, 3, "c"),
             sched("x0", 2, 1, "c", f="nope"), b"\x00garbage"]
    second = [sched("a2", 7, 1, "a"), sched("b1", 9, 1, "b")]
    return [first, second]


def _answers(backend, windows):
    import pickle
    out = []
    for payloads in windows:
        for raw in backend.handle_batch(payloads, [1] * len(payloads), 0):
            kind, body = pickle.loads(raw)
            if kind == "result":
                body = workloads.config8_canon(body)
            elif kind == "error":
                body = body.split(":")[0]
            out.append((kind, body))
    return out, list(backend._batch_log)


def test_handle_batch_matches_the_reference_frame_by_frame():
    from karpenter_tpu.service import backend as jax_backend
    from karpenter_tpu.solver import TPUSolver
    from karpenter_tpu_torch.service import backend as port_backend
    from karpenter_tpu_torch.solver import TorchSolver
    got = {}
    for name, be, solver in (
            ("jax", jax_backend, lambda: TPUSolver(
                max_nodes=128, mesh="off", delta="off")),
            ("port", port_backend, lambda: TorchSolver(
                max_nodes=128, device="cpu", mesh="off", delta="off"))):
        saved = (be._solver, dict(be._catalogs))
        be._solver = solver()
        be._catalogs.clear()
        be.reset_worker_state()
        try:
            got[name] = _answers(be, _frames(
                "karpenter_tpu" if name == "jax" else "karpenter_tpu_torch",
                "fp-diff"))
        finally:
            be.reset_worker_state()
            be._solver = saved[0]
            be._catalogs.clear()
            be._catalogs.update(saved[1])
    answers, sizes = got["port"]
    assert [k for k, _ in answers] == ["ok", "result", "result", "result",
                                       "result", "need_catalog", "error",
                                       "result", "result"]
    assert got["port"] == got["jax"]
    # one cross-tenant fused launch a bucket in each window
    assert sizes == [2, 2, 2]
