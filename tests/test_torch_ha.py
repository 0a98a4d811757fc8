"""The port's leader election (`operator/leaderelection.py`) and its
replica pairs against the JAX package's: the `TestLeases` and
`TestElector` cases of `tests/test_ha.py` on both packages, one lease
file shared by a replica of each package (the file format is one, so
mixed replicas exclude each other), and `tests/test_ha.py`'s
`TestReplicaPairE2E` and `TestTwoReplicaExternalStore` on both packages'
Operators (the port's environments on the CPU), and its
`TestFullProductionTopology` on the port: a store daemon, kt_solverd
with the port's backend as a supervised worker, two replicas and one
lease.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest
import torch

PKGS = {name: importlib.import_module(f"{root}.operator.leaderelection")
        for name, root in (("jax", "karpenter_tpu"),
                           ("port", "karpenter_tpu_torch"))}


def _stack(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, M=imp("models"), env=imp("env"), le=imp(
            "operator.leaderelection"), op=imp("operator.operator"),
        Options=imp("operator.options").Options, clock=imp("utils.clock"),
        store=imp("store"), fake_cloud=imp("providers.fake_cloud"),
        faults=imp("utils.faults"))


STACKS = {"jax": _stack("karpenter_tpu"), "port": _stack("karpenter_tpu_torch")}


@pytest.fixture(autouse=True)
def _port_faults_disarmed():
    """tests/conftest.py disarms the JAX package's fault registry around
    every test; the port keeps its own, disarmed here the same way."""
    from karpenter_tpu_torch.utils import faults
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(params=sorted(PKGS))
def le(request):
    return PKGS[request.param]


class TestLeases:
    def test_inmemory_mutual_exclusion(self, le):
        lease = le.InMemoryLease()
        assert lease.try_acquire("a", 10.0, now=100.0)
        assert not lease.try_acquire("b", 10.0, now=105.0)
        assert lease.holder(now=105.0) == "a"
        # expiry frees it
        assert lease.try_acquire("b", 10.0, now=111.0)
        assert lease.holder(now=112.0) == "b"
        # release frees it immediately
        lease.release("b")
        assert lease.holder(now=112.0) is None

    def test_inmemory_reacquire_extends(self, le):
        lease = le.InMemoryLease()
        assert lease.try_acquire("a", 10.0, now=0.0)
        assert lease.try_acquire("a", 10.0, now=8.0)  # renew
        assert not lease.try_acquire("b", 10.0, now=12.0)  # extended to 18

    def test_file_lease_across_instances(self, le, tmp_path):
        path = str(tmp_path / "lease.json")
        a, b = le.FileLease(path), le.FileLease(path)
        assert a.try_acquire("rep-a", 10.0, now=100.0)
        assert not b.try_acquire("rep-b", 10.0, now=104.0)
        assert b.holder(now=104.0) == "rep-a"
        assert b.try_acquire("rep-b", 10.0, now=111.0)  # expired
        assert a.holder(now=112.0) == "rep-b"
        b.release("rep-b")
        assert a.holder(now=112.0) is None


class TestElector:
    def test_takeover_on_expiry_and_demotion(self, le):
        lease = le.InMemoryLease()
        t = {"now": 0.0}
        e1 = le.LeaderElector(lease, identity="rep-1", lease_duration=10.0,
                              renew_interval=3.0, now=lambda: t["now"])
        e2 = le.LeaderElector(lease, identity="rep-2", lease_duration=10.0,
                              renew_interval=3.0, now=lambda: t["now"])
        assert e1.try_acquire_or_renew()
        assert not e2.try_acquire_or_renew()
        # leader renews within the window: standby stays out
        t["now"] = 5.0
        assert e1.try_acquire_or_renew()
        t["now"] = 12.0
        assert not e2.try_acquire_or_renew()  # lease runs to 15
        # leader goes silent; lease expires; standby takes over
        t["now"] = 16.0
        assert e2.try_acquire_or_renew()
        assert e2.is_leader
        # the comatose leader wakes up and finds itself demoted
        t["now"] = 17.0
        assert not e1.try_acquire_or_renew()
        assert not e1.is_leader


def test_one_lease_file_excludes_across_packages(tmp_path):
    """A JAX replica and a port replica on one lease file: the same
    sequence of holders as two replicas of one package, and the same
    bytes on disk after each step."""
    def run(make_a, make_b, path):
        a, b = make_a(path), make_b(path)
        steps = [a.try_acquire("rep-a", 10.0, now=100.0),
                 b.try_acquire("rep-b", 10.0, now=104.0),
                 b.holder(now=104.0), b.try_acquire("rep-b", 10.0, now=111.0),
                 a.holder(now=112.0)]
        with open(path) as f:
            disk = f.read()
        b.release("rep-b")
        return steps + [a.holder(now=112.0)], disk

    jax, port = PKGS["jax"], PKGS["port"]
    mixed = run(jax.FileLease, port.FileLease, str(tmp_path / "mixed.json"))
    ref = run(jax.FileLease, jax.FileLease, str(tmp_path / "jax.json"))
    assert mixed == ref
    assert mixed[0] == [True, False, "rep-a", True, "rep-b", None]


# -- the replica pairs of tests/test_ha.py, on both packages' Operators -------
@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=sorted(STACKS))
def st(request):
    return STACKS[request.param]


def mkpod(st, name):
    return st.M.Pod(meta=st.M.ObjectMeta(name=name),
                    requests=st.M.Resources.parse({"cpu": "500m",
                                                   "memory": "1Gi"}))


def mkenv(st, opts, **kw):
    if st.root == "karpenter_tpu_torch":
        kw["device"] = "cpu"
    return st.env.Environment(clock=st.clock.RealClock(), options=opts, **kw)


def wait_scheduled(env, name, timeout=20.0):
    """tests/test_ha.py's event-driven wait for one pod to schedule."""
    w = env.cluster.watch()
    try:
        deadline = time.monotonic() + timeout
        while True:
            p = env.cluster.pods.get(name)
            if p is not None and p.scheduled:
                return True
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            w.wait(timeout=min(left, 0.5))
            w.drain()
    finally:
        env.cluster.unwatch(w)


def pair(st, opts, lease, envs):
    ops = []
    for ident, env in zip(("rep-1", "rep-2"), envs):
        op = st.op.Operator(options=opts, env=env, lease=lease,
                            identity=ident, metrics_port=0, health_port=0,
                            reconcile_interval=0.05)
        op.elector.lease_duration = 1.2
        op.elector.renew_interval = 0.3
        op.elector.retry_period = 0.1
        ops.append(op)
    threads = [threading.Thread(target=op.run, daemon=True) for op in ops]
    for th in threads:
        th.start()
    return ops, threads


class TestReplicaPairE2E:
    def test_standby_takes_over_provisioning(self, st):
        """Two replicas share one cluster and one lease; the leader dies
        WITHOUT releasing; the standby must acquire and provision new
        pods."""
        opts = st.Options(batch_idle_duration=0)
        env = mkenv(st, opts)
        env.add_default_nodeclass()
        env.cluster.nodepools.create(
            st.M.NodePool(meta=st.M.ObjectMeta(name="default")))
        ops, threads = pair(st, opts, st.le.InMemoryLease(), (env, env))
        try:
            env.cluster.pods.create(mkpod(st, "before"))
            assert wait_scheduled(env, "before")
            deadline = time.monotonic() + 20
            leaders = []
            while time.monotonic() < deadline:
                leaders = [op for op in ops if op._leadership.is_set()]
                if len(leaders) == 1:
                    break
                time.sleep(0.05)
            assert len(leaders) == 1
            leader = leaders[0]
            standby = next(op for op in ops if op is not leader)
            leader.elector.release = lambda: None  # sudden death
            leader.stop()
            env.cluster.pods.create(mkpod(st, "after"))
            assert wait_scheduled(env, "after"), \
                "standby never took over provisioning"
            assert standby._leadership.wait(5.0)
            assert standby.elector.is_leader
        finally:
            for op in ops:
                op.stop()
            for th in threads:
                th.join(timeout=5)


class TestTwoReplicaExternalStore:
    def test_leader_killed_mid_provisioning_loses_no_pods(self, st,
                                                          tmp_path):
        """Two replicas, each with its OWN informer cache, sharing one
        store daemon, one cloud and one file lease; the leader is killed
        mid-provisioning without releasing its lease; the standby takes
        over and finishes: every pod scheduled, none lost."""
        opts = st.Options(batch_idle_duration=0)
        daemon = st.store.StoreDaemon(str(tmp_path / "store.sock"))
        cloud = st.fake_cloud.FakeCloud(clock=st.clock.RealClock())
        envs = [mkenv(st, opts, cloud=cloud,
                      store_backend=st.store.RemoteBackend(daemon.path))
                for _ in range(2)]
        envs[0].add_default_nodeclass()
        envs[0].cluster.nodepools.create(
            st.M.NodePool(meta=st.M.ObjectMeta(name="default")))
        ops, threads = pair(st, opts,
                            st.le.FileLease(str(tmp_path / "lease.json")),
                            envs)
        try:
            deadline = time.time() + 20
            while time.time() < deadline:
                leaders = [op for op in ops if op.elector.is_leader]
                if len(leaders) == 1:
                    break
                time.sleep(0.05)
            assert len(leaders) == 1
            leader = leaders[0]
            standby = next(op for op in ops if op is not leader)
            for i in range(6):
                standby.env.cluster.pods.create(mkpod(st, f"p{i}"))
            deadline = time.time() + 20
            while time.time() < deadline:
                if leader.env.cluster.nodeclaims.list():
                    break
                time.sleep(0.02)
            assert leader.env.cluster.nodeclaims.list(), \
                "leader never began provisioning"
            leader.elector.release = lambda: None  # sudden death
            leader.stop()
            deadline = time.time() + 30
            while time.time() < deadline:
                pods = standby.env.cluster.pods.list()
                if len(pods) == 6 and all(p.scheduled for p in pods):
                    break
                time.sleep(0.05)
            pods = standby.env.cluster.pods.list()
            assert len(pods) == 6, "pods were lost across failover"
            assert all(p.scheduled for p in pods), \
                "standby never finished provisioning"
            assert standby.elector.is_leader
        finally:
            for op in ops:
                op.stop()
            for th in threads:
                th.join(timeout=5)
            for env in envs:
                env.cluster.backend.close()
            daemon.close()


class TestFullProductionTopology:
    def test_store_daemon_solverd_and_two_replicas(self, tmp_path):
        """tests/test_ha.py's complete deployment shape on the port, in
        process: one store daemon (apiserver analogue), one kt_solverd
        worker running the port's backend on the CPU under
        `SolverdSupervisor`, shared by both replicas over its coalescing
        socket, and two Operators with separate informer caches racing
        one file lease.  Pods created through the standby provision via
        leader → solverd → the shared cloud; failover keeps the stack
        working; and a SIGKILLed worker is restarted by the supervisor
        while the surviving replica keeps placing pods (degraded mode in
        the gap, the service again after the need_catalog re-upload)."""
        st = STACKS["port"]
        from karpenter_tpu_torch.service import SolverdSupervisor
        from karpenter_tpu_torch.service import supervisor as sup_mod
        try:
            sup_mod.build_binary()
        except RuntimeError as e:
            pytest.skip(f"native toolchain unavailable: {e}")
        import os
        env = dict(os.environ, KARPENTER_TPU_FORCE_CPU="1",
                   KARPENTER_TPU_MAX_NODES="128", OMP_NUM_THREADS="1")
        env.pop("KARPENTER_TPU_FAULTS", None)
        solver_sock = str(tmp_path / "kt.sock")
        stderr_path = str(tmp_path / "solverd.stderr")
        sup = SolverdSupervisor(
            solver_sock, env=env,
            extra_args=["--idle-ms", "20", "--max-ms", "200"],
            stderr_path=stderr_path, backoff_base=0.2, backoff_max=2.0)
        sup.start(wait_for_socket=True, timeout=120)

        def dump():
            try:
                with open(stderr_path, "rb") as f:
                    return f.read().decode(errors="replace")[-4000:]
            except OSError:
                return "<no stderr>"

        store = st.store.StoreDaemon(str(tmp_path / "store.sock"))
        lease = st.le.FileLease(str(tmp_path / "lease.json"))
        cloud = st.fake_cloud.FakeCloud(clock=st.clock.RealClock())
        opts = st.Options(batch_idle_duration=0, solver_endpoint=solver_sock,
                          service_breaker_cooldown=0.5)
        envs = [mkenv(st, opts, cloud=cloud,
                      store_backend=st.store.RemoteBackend(store.path))
                for _ in range(2)]
        envs[0].add_default_nodeclass()
        envs[0].cluster.nodepools.create(
            st.M.NodePool(meta=st.M.ObjectMeta(name="default")))
        ops, threads = pair(st, opts, lease, envs)
        for op in ops:
            op.elector.lease_duration = 1.5

        def scheduled(env, name):
            p = env.cluster.pods.get(name)
            return p is not None and p.scheduled

        def wait(pred, timeout):
            deadline = time.time() + timeout
            while time.time() < deadline and not pred():
                time.sleep(0.1)
            return pred()
        try:
            assert wait(lambda: len([op for op in ops
                                     if op.elector.is_leader]) == 1, 30)
            leader = next(op for op in ops if op.elector.is_leader)
            standby = next(op for op in ops if op is not leader)
            # pods through the standby; the leader schedules them through
            # the worker
            for i in range(4):
                standby.env.cluster.pods.create(mkpod(st, f"s{i}"))
            assert wait(lambda: len(leader.env.cluster.pods.list()) == 4
                        and all(p.scheduled
                                for p in leader.env.cluster.pods.list()),
                        120), f"--- solverd stderr ---\n{dump()}"
            assert leader.env.solver._local is None  # served remotely
            # kill the leader without release; the standby finishes new
            # work over the SAME worker
            leader.elector.release = lambda: None
            leader.stop()
            standby.env.cluster.pods.create(mkpod(st, "after"))
            assert wait(lambda: scheduled(standby.env, "after"), 60), \
                f"--- solverd stderr ---\n{dump()}"
            assert standby.elector.is_leader
            # SIGKILL the worker: the supervisor brings a fresh one up,
            # and the surviving replica keeps placing pods throughout
            restarts_before = sup.restarts
            sup.kill_worker()
            standby.env.cluster.pods.create(mkpod(st, "post-crash"))
            assert wait(lambda: scheduled(standby.env, "post-crash"), 120), \
                f"--- solverd stderr ---\n{dump()}"
            assert wait(lambda: sup.restarts > restarts_before, 60), \
                "supervisor never restarted the killed worker"
            sup.wait_ready(timeout=120)
            # the same replica's client is served by the new worker once
            # its breaker's cooldown lets a probe through
            client = standby.env.solver.tpu
            inp = _probe_input(standby.env)

            def served():
                try:
                    return client.solve(inp).node_count() >= 1
                except Exception:  # noqa: BLE001 — breaker still open
                    return False
            assert wait(served, 60)
            assert client.stats()["catalogs"] == 1
        finally:
            for op in ops:
                op.stop()
            for th in threads:
                th.join(timeout=10)
            for env in envs:
                env.cluster.backend.close()
            store.close()
            sup.stop()


def _probe_input(env):
    """A two-pod input on the environment's own pools and catalog."""
    from karpenter_tpu_torch.controllers.state import build_schedule_input
    M = STACKS["port"].M
    pods = [M.Pod(meta=M.ObjectMeta(name=f"probe{i}"),
                  requests=M.Resources.parse({"cpu": "500m",
                                              "memory": "1Gi"}))
            for i in range(2)]
    return build_schedule_input(env.cluster, env.cloud_provider, pods)

