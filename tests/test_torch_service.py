"""The port's solver service (`karpenter_tpu_torch/service/`) against the
JAX package's: the cases of `tests/test_solver_service.py` on the port.

The daemon is the repository's `native/build/kt_solverd` (`make -s
solverd`), started with `--module karpenter_tpu_torch.service.backend`
and KARPENTER_TPU_FORCE_CPU=1, so its embedded interpreter runs the
port's backend on the CPU (the kernels' plain versions); one daemon
serves the module, and the restart class starts its own.  Each answer is
held to the JAX package's on the same inputs, through the JAX package's
`LoopbackSolverd` and client over its backend (`TPUSolver(max_nodes=128,
mesh="off", delta="off")`, the shapes its own service tests compile), as
the canonical result with every price as its IEEE hex.  Skipped only if
the toolchain cannot produce the binary.
"""

import os
import pickle
import socket
import struct
import subprocess
import threading
import time

import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.models import NodePool, ObjectMeta, Pod, Resources
from karpenter_tpu_torch.providers import generate_catalog
from karpenter_tpu_torch.providers.catalog import CatalogSpec
from karpenter_tpu_torch.scheduling import ScheduleInput, Scheduler
from karpenter_tpu_torch.service import SolverServiceClient
from karpenter_tpu_torch.service import supervisor as sup_mod

# small catalog and node axis: the JAX reference's service shapes
CATALOG = generate_catalog(CatalogSpec(max_types=12, include_gpu=False))
POOL = NodePool(meta=ObjectMeta(name="default"))
canon = workloads.config8_canon


def _jax_models():
    from karpenter_tpu import models as M
    from karpenter_tpu.providers import generate_catalog as gen
    from karpenter_tpu.providers.catalog import CatalogSpec as Spec
    return M, gen(Spec(max_types=12, include_gpu=False))


_JAX = {}


def mkinp(tag, n=20, cpu="500m", pkg="port", classes=1):
    """`n` pods a class, `classes` classes, in the port's classes or (pkg
    "jax") the JAX package's, on one pool and the 12-type catalog."""
    if pkg == "jax":
        if not _JAX:
            M, cat = _jax_models()
            _JAX.update(M=M, catalog=cat, pool=M.NodePool(
                meta=M.ObjectMeta(name="default")))
        M, cat, pool = _JAX["M"], _JAX["catalog"], _JAX["pool"]
        from karpenter_tpu.scheduling import ScheduleInput as SI
    else:
        import karpenter_tpu_torch.models as M
        cat, pool, SI = CATALOG, POOL, ScheduleInput
    pods = [M.Pod(meta=M.ObjectMeta(name=f"{tag}-p{i}" if classes == 1
                                    else f"{tag}-{c}-{i}"),
                  requests=M.Resources.parse(
                      {"cpu": cpu if classes == 1 else f"{500 + 10 * c}m",
                       "memory": "1Gi"}))
            for c in range(classes) for i in range(n)]
    return SI(pods=pods, nodepools=[pool], instance_types={"default": cat})


def worker_env(extra=None):
    """The port's worker on the CPU: the supervisor's environment (this
    checkout and this interpreter's path), one torch thread, the
    reference's node axis."""
    env = sup_mod.worker_env()
    env["KARPENTER_TPU_FORCE_CPU"] = "1"
    env["KARPENTER_TPU_MAX_NODES"] = "128"
    env["OMP_NUM_THREADS"] = "1"
    env.pop("KARPENTER_TPU_FAULTS", None)
    if extra:
        env.update(extra)
    return env


def build_daemon():
    try:
        return sup_mod.build_binary()
    except RuntimeError as e:
        pytest.skip(f"native toolchain unavailable: {e}")


def spawn_daemon(sock: str, extra=None):
    """Start kt_solverd with the port's backend on `sock`; returns (proc,
    dump_fn)."""
    binary = build_daemon()
    if os.path.exists(sock):
        os.unlink(sock)  # a dead daemon's socket file blocks rebinding
    stderr_path = sock + ".stderr"
    with open(stderr_path, "ab") as stderr_f:
        proc = subprocess.Popen(
            [binary, "--socket", sock, "--idle-ms", "20", "--max-ms", "200",
             "--module", sup_mod.BACKEND_MODULE],
            env=worker_env(extra), stderr=stderr_f)

    def dump():
        with open(stderr_path, "rb") as f:
            return f.read().decode(errors="replace")[-4000:]

    for _ in range(600):
        if os.path.exists(sock):
            break
        if proc.poll() is not None:
            pytest.fail(f"daemon died: {dump()}")
        time.sleep(0.1)
    return proc, dump


def stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("svc") / "kt.sock")
    proc, dump = spawn_daemon(sock)
    yield sock
    stop(proc)
    print(f"--- kt_solverd stderr ---\n{dump()}")


@pytest.fixture(scope="module")
def client(daemon):
    c = SolverServiceClient(daemon, timeout=120)
    yield c
    c.close()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's service in this process: its LoopbackSolverd over
    its backend with the reference's small solver, and a client."""
    from karpenter_tpu.service import SolverServiceClient as JaxClient
    from karpenter_tpu.service import backend
    from karpenter_tpu.service.loopback import LoopbackSolverd
    from karpenter_tpu.solver import TPUSolver
    saved = backend._solver
    backend._solver = TPUSolver(max_nodes=128, mesh="off", delta="off")
    d = LoopbackSolverd(str(tmp_path_factory.mktemp("ref") / "ref.sock"),
                        idle_ms=20, max_ms=200)
    c = JaxClient(d.socket_path, timeout=120)
    yield c
    c.close()
    d.close()
    backend._solver = saved


class TestSolverService:
    def test_solve_parity_with_local(self, client, ref):
        inp = mkinp("par", 30)
        remote = client.solve(inp)
        local = Scheduler(inp).solve()
        assert not remote.unschedulable
        assert remote.node_count() == local.node_count()
        assert abs(remote.total_price() - local.total_price()) < 1e-6
        assert {p.meta.name for c in remote.new_claims for p in c.pods} == {
            p.meta.name for p in inp.pods}
        assert canon(remote) == canon(ref.solve(mkinp("par", 30, pkg="jax")))

    def test_catalog_uploaded_once(self, client):
        before = client.stats()["catalogs"]
        client.solve(mkinp("c1"))
        client.solve(mkinp("c2"))
        assert client.stats()["catalogs"] == before  # fingerprint reused

    def test_concurrent_requests_coalesce(self, client, ref):
        client.solve(mkinp("warm"))  # ensure catalog + first use are warm
        base_batches = len(client.stats()["batch_sizes"])
        outs = {}

        def call(i):
            outs[i] = client.solve(mkinp(f"cc{i}", n=10 + i))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(not outs[i].unschedulable for i in range(6))
        sizes = client.stats()["batch_sizes"][base_batches:]
        # the daemon's window fused the 6 concurrent solves into few device
        # batches — the whole point of the native batcher
        assert sum(sizes) == 6
        assert len(sizes) <= 3, sizes
        assert max(sizes) >= 2, sizes
        for i in (0, 5):
            assert canon(outs[i]) == canon(
                ref.solve(mkinp(f"cc{i}", n=10 + i, pkg="jax")))

    def test_solve_batch_roundtrip(self, client, ref):
        inps = [mkinp(f"sb{i}", n=5 * (i + 1)) for i in range(3)]
        results = client.solve_batch(inps)
        want = ref.solve_batch([mkinp(f"sb{i}", n=5 * (i + 1), pkg="jax")
                                for i in range(3)])
        for inp, res, w in zip(inps, results, want):
            assert not res.unschedulable
            local = Scheduler(inp).solve()
            assert res.node_count() == local.node_count()
            assert canon(res) == canon(w)

    def test_sweep_batch_through_daemon(self, client, ref):
        """The leave-one-out provenance (ScheduleInput.exist_base) must
        survive the pickle boundary: inputs serialized in ONE request keep
        their shared snapshot identity after unpickling, so the daemon's
        backend takes the sweep path — and the results must match a local
        in-process solve and the JAX package's service exactly."""
        from karpenter_tpu_torch.solver import TorchSolver

        def sweep(pkg):
            if pkg == "jax":
                M = _jax_models()[0]
                from karpenter_tpu.scheduling import ExistingNode as EN
                from karpenter_tpu.scheduling import ScheduleInput as SI
                mkinp("x", 1, pkg="jax")  # the JAX catalog and pool
                cat, pool = _JAX["catalog"], _JAX["pool"]
            else:
                import karpenter_tpu_torch.models as M
                from karpenter_tpu_torch.scheduling import ExistingNode as EN
                SI, cat, pool = ScheduleInput, CATALOG, POOL
            wk = M.wellknown
            nodes = []
            for i in range(8):
                n = M.Node(meta=M.ObjectMeta(name=f"sw{i}", labels={
                    wk.ZONE_LABEL: f"tpu-west-1{'abc'[i % 3]}",
                    wk.CAPACITY_TYPE_LABEL: "spot",
                    wk.NODEPOOL_LABEL: "default",
                    wk.ARCH_LABEL: "amd64",
                    wk.OS_LABEL: "linux",
                    wk.HOSTNAME_LABEL: f"sw{i}"}),
                    allocatable=M.Resources.of(cpu=16000, memory=32768,
                                               pods=58),
                    ready=True)
                p = M.Pod(meta=M.ObjectMeta(name=f"swr{i}"),
                          requests=M.Resources.parse({"cpu": "500m",
                                                      "memory": "1Gi"}),
                          node_name=f"sw{i}")
                nodes.append(EN(node=n, available=n.allocatable - p.requests,
                                pods=[p]))
            return [SI(pods=list(nodes[i].pods), nodepools=[pool],
                       instance_types={"default": cat},
                       existing_nodes=nodes[:i] + nodes[i + 1:],
                       price_cap=0.5, exist_base=nodes, exist_excluded=(i,))
                    for i in range(8)]
        inps = sweep("port")
        remote = client.solve_batch(inps, max_nodes=8)
        local = TorchSolver(device="cpu", mesh="off").solve_batch(
            inps, max_nodes=8)
        want = ref.solve_batch(sweep("jax"), max_nodes=8)
        for i, (r, l, w) in enumerate(zip(remote, local, want)):
            assert canon(r) == canon(l) == canon(w), i

    def test_survives_repeated_fresh_lowerings(self, client, ref):
        """Each distinct class count lands in a fresh (G, E, N) padding
        bucket, so every request below is a first launch configuration for
        the daemon's batcher thread, whose thread state persists across
        batches (the daemon's own regression)."""
        for classes in (3, 6):
            res = client.solve(mkinp(f"ml{classes}", n=2, classes=classes))
            assert not res.unschedulable, f"shape #{classes} wedged"
            assert canon(res) == canon(ref.solve(
                mkinp(f"ml{classes}", n=2, classes=classes, pkg="jax")))

    def test_cross_tenant_requests_fuse_in_one_batch(self, daemon, client):
        """Two DIFFERENT tenants (separate clients/connections) issuing
        bucket-compatible solves concurrently must fuse into a
        cross-tenant device batch, with per-tenant accounting in the
        stats RPC and a backpressure hint on every result."""
        client.solve(mkinp("xwarm"))
        a = SolverServiceClient(daemon, timeout=120, tenant="cluster-a")
        b = SolverServiceClient(daemon, timeout=120, tenant="cluster-b")
        try:
            before = a.stats()["scheduler"] or {}
            cross0 = before.get("cross_tenant_batches", 0)
            outs = {}
            start = threading.Barrier(2)

            def call(c, tag):
                start.wait()
                outs[tag] = c.solve_batch(
                    [mkinp(f"{tag}{i}", n=10 + i) for i in range(2)])

            ts = [threading.Thread(target=call, args=(a, "ta")),
                  threading.Thread(target=call, args=(b, "tb"))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert all(not r.unschedulable
                       for rs in outs.values() for r in rs)
            st = a.stats()["scheduler"]
            assert {"cluster-a", "cluster-b"} <= set(st["tenants"])
            assert st["tenants"]["cluster-a"]["dispatched"] >= 2
            assert st["cross_tenant_batches"] >= cross0 + 1
            assert a.last_backpressure is not None
        finally:
            a.close()
            b.close()

    def test_error_response_on_garbage(self, daemon):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(daemon)
        payload = b"\x00not-a-pickle"
        s.sendall(struct.pack("<IQ", len(payload), 7) + payload)
        header = b""
        while len(header) < 12:
            header += s.recv(12 - len(header))
        plen, rid = struct.unpack("<IQ", header)
        assert rid == 7
        body = b""
        while len(body) < plen:
            body += s.recv(plen - len(body))
        kind, msg = pickle.loads(body)
        assert kind == "error" and "unpicklable" in msg
        s.close()

    def test_worker_runs_the_ports_backend(self, client):
        """The worker reports its interpreter, torch and device over stats:
        the port's backend on the CPU, with the frames' bytes counted."""
        st = client.stats()
        w = st["worker"]
        assert w["device"] == "cpu" and w["torch"] == torch.__version__
        assert w["launches"]["ffd_batch_scan"] == 0  # the plain versions
        assert client.bytes_sent > 0 and client.bytes_received > 0

    def test_gated_solver_endpoint(self, daemon):
        # the control plane pointed at the remote solver: provisioning
        # end-to-end through the service; with the service gone, degraded
        # mode (the in-process solver), never a failure (SURVEY §5)
        from karpenter_tpu_torch.cluster import Cluster
        from karpenter_tpu_torch.controllers.state import GatedSolver
        from karpenter_tpu_torch.operator.options import Options

        cluster = Cluster()
        gs = GatedSolver(Options(solver_endpoint=daemon), cluster,
                         device="cpu")
        res = gs.solve(mkinp("gate", 10))
        assert not res.unschedulable and res.node_count() == 1
        assert gs._local is None
        gs.tpu.close()
        gs.tpu.socket_path = "/nonexistent/kt.sock"
        res2 = gs.solve(mkinp("gate2", 10))
        assert not res2.unschedulable and res2.node_count() == 1
        assert gs._local is not None
        assert [e for e in cluster.events if e[3] == "SolverFallback"]


class TestDaemonRestart:
    def test_client_reconnects_and_reuploads_after_restart(self, tmp_path):
        """Replica-survives-solver-restart: kill the daemon hard, assert
        the control plane degrades (never fails), restart on the same
        socket, and assert the SAME client reconnects and re-uploads the
        catalog (the daemon restarted empty — the need_catalog handshake
        must recover it transparently)."""
        from karpenter_tpu_torch.cluster import Cluster
        from karpenter_tpu_torch.controllers.state import GatedSolver
        from karpenter_tpu_torch.operator.options import Options

        sock = str(tmp_path / "kt.sock")
        proc1, dump1 = spawn_daemon(sock)
        try:
            gs = GatedSolver(Options(solver_endpoint=sock), Cluster(),
                             device="cpu")
            gs.tpu.timeout = 120
            res = gs.solve(mkinp("before", 10))
            assert not res.unschedulable and res.node_count() == 1
            assert gs.tpu.stats()["catalogs"] == 1
        finally:
            proc1.kill()
            proc1.wait()

        # daemon down: degrade, never fail (SURVEY §5)
        res = gs.solve(mkinp("down", 10))
        assert not res.unschedulable and res.node_count() == 1

        proc2, dump2 = spawn_daemon(sock)
        try:
            # same client object: must reconnect AND re-upload the catalog
            res = gs.tpu.solve(mkinp("after", 10))
            assert not res.unschedulable and res.node_count() == 1
            assert gs.tpu.stats()["catalogs"] == 1  # fresh daemon, one upload
        finally:
            gs.tpu.close()
            stop(proc2)


# -- the pins of chip_smoke.py phase 24 ---------------------------------------
def test_config8_pin_is_the_references():
    """`chip_smoke.CONFIG8_PIN`: tenant-0's warm steps of config #8 (the
    JAX benchmark's `Workload`) on the JAX package's TPUSolver(max_nodes=
    128, mesh off, delta off), and on the port's `Config8Traffic` through
    a CPU TorchSolver, solve by solve."""
    import chip_smoke
    from benchmarks.config8_saturation import Workload
    from karpenter_tpu.solver import TPUSolver
    from karpenter_tpu_torch.solver import TorchSolver
    M, cat = _jax_models()
    w = Workload(cat, M.NodePool(meta=M.ObjectMeta(name="default")))

    class Rec:
        def solve(self, inp):
            self.inps = [inp]

        def solve_batch(self, inps):
            self.inps = list(inps)
            return [None] * len(inps)
    js = TPUSolver(max_nodes=128, mesh="off", delta="off")
    ps = TorchSolver(max_nodes=128, device="cpu", mesh="off", delta="off")
    traffic = workloads.Config8Traffic()
    tenant = f"{chip_smoke.CONFIG8_PIN_TENANT}-warm"
    jax_res, port_res = [], []
    for it in workloads.CONFIG8_WARM_STEPS:
        r = Rec()
        w.call(r, tenant, it)
        jax_res += [js.solve(i) for i in r.inps]
        port_res += [ps.solve(i) for i in traffic.inputs(tenant, it)]
    assert len(jax_res) == 4
    assert chip_smoke.config8_digest(jax_res) == chip_smoke.CONFIG8_PIN
    assert chip_smoke.config8_digest(port_res) == chip_smoke.CONFIG8_PIN


def test_loop_through_the_service_gives_the_reference_answer(daemon):
    """Phase 24(c)'s loop at a reduced size: `workloads.provisioning_loop`
    with `Options(solver_endpoint=...)` on the module's daemon (a worker
    process of its own, as on the card) gives the JAX loop's answers wave
    by wave, and records what the in-memory port loop records
    (`WaveObserver`: ledger records and digest — each record's
    `flight_seq` names the client's request record —, timeline events,
    verdict): the service changes neither."""
    from karpenter_tpu_torch.operator.options import Options
    from tests.test_torch_provisioning import JAX, build_loop, run_waves
    ref = [a for a, _ in run_waves(build_loop(JAX, 300), 30)]

    def run(opts):
        obs = workloads.port_observability()
        obs.reset()
        watch = workloads.WaveObserver(obs)
        lp = workloads.provisioning_loop(300, opts, device="cpu")
        out = []
        for wave in (1, 2):
            if wave == 2:
                lp.add_pods(workloads.headline_pods(
                    30, prefix="w", sizes=workloads.WAVE2_SIZES))
            watch.start(lp.cluster)
            rounds = lp.settle()
            out.append((workloads.loop_answer(lp.cluster, lp.cloud, rounds),
                        watch.finish(lp.cluster)))
        return out, lp
    mem, _ = run(Options(batch_idle_duration=0, solver_mesh="off"))
    svc, lp = run(Options(batch_idle_duration=0, solver_mesh="off",
                          solver_endpoint=daemon))
    lp.solver.tpu.close()
    assert [a for a, _ in svc] == ref == [a for a, _ in mem]
    assert [o for _, o in svc] == [o for _, o in mem]
    assert lp.solver._local is None
    assert not [e for e in lp.cluster.events if e[3] == "SolverFallback"]
