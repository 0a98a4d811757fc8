"""The port's `GatedSolver` with a `solver_endpoint`: the remote client of
a solver service and its degraded mode (`controllers/state.py`), through
the port's `LoopbackSolverd` (the daemon's window and the port's backend
in this process, its solver `TorchSolver(device="cpu", max_nodes=128)`).

Remote solves and batches equal the in-process port's and the JAX
package's GatedSolver through its own loopback; the client's breaker
opens after its threshold of transport failures; a degraded solve
answers on the in-process solver and records `SolverFallback` and the
`solver.degraded_local` span; a degraded solve that fails on a solver on
the card raises, with no oracle solve; the operator's dashboard reads the
worker's stats.
"""

import threading

import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.controllers.state import GatedSolver
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.service import (
    SolverServiceTransportError,
    SolverServiceUnavailable,
)
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.utils import metrics, tracing

canon = workloads.config8_canon
TRAFFIC = workloads.Config8Traffic()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_faults_disarmed():
    from karpenter_tpu_torch.utils import faults
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def loopback(tmp_path_factory):
    from karpenter_tpu_torch.service import backend
    from karpenter_tpu_torch.service.loopback import LoopbackSolverd
    saved = backend._solver
    backend._solver = TorchSolver(max_nodes=128, device="cpu", mesh="off",
                                  delta="off")
    d = LoopbackSolverd(str(tmp_path_factory.mktemp("rg") / "lb.sock"),
                        idle_ms=20, max_ms=200)
    yield d
    d.close()
    backend._solver = saved


def remote(sock, **kw):
    opts = Options(solver_endpoint=sock, solver_max_nodes=128,
                   solver_mesh="off", solver_delta="off", **kw)
    return GatedSolver(opts, Cluster(), device="cpu")


def local():
    return TorchSolver(max_nodes=128, device="cpu", mesh="off", delta="off")


def jax_inputs(tenant, it):
    """config #8's step in the JAX package's classes (its benchmark's
    Workload)."""
    from benchmarks.config8_saturation import Workload
    from karpenter_tpu.models import NodePool, ObjectMeta
    from karpenter_tpu.providers import generate_catalog
    from karpenter_tpu.providers.catalog import CatalogSpec
    w = Workload(generate_catalog(CatalogSpec(max_types=12,
                                              include_gpu=False)),
                 NodePool(meta=ObjectMeta(name="default")))

    class Rec:
        def solve(self, inp):
            self.inps = [inp]
            return None

        def solve_batch(self, inps):
            self.inps = list(inps)
            return [None] * len(inps)
    r = Rec()
    w.call(r, tenant, it)
    return r.inps


def test_remote_solve_and_batch_equal_the_in_process_port_and_jax(loopback):
    from karpenter_tpu.cluster import Cluster as JaxCluster
    from karpenter_tpu.controllers.state import GatedSolver as JaxGated
    from karpenter_tpu.operator.options import Options as JaxOptions
    gs = remote(loopback.socket_path)
    assert type(gs.tpu).__name__ == "SolverServiceClient"
    jax_gs = JaxGated(JaxOptions(solver_mesh="off", solver_delta="off",
                                 solver_max_nodes=128), JaxCluster())
    solo = local()
    for it in (0, 3, 7):
        inps = TRAFFIC.inputs("t0", it)
        got = gs.solve_batch(inps) if len(inps) > 1 else [gs.solve(inps[0])]
        want = [solo.solve(i) for i in inps]
        ref = [jax_gs.solve(i) for i in jax_inputs("t0", it)]
        assert [canon(r) for r in got] == [canon(r) for r in want] \
            == [canon(r) for r in ref]
    assert gs._local is None  # the service answered: no degraded solver


def test_remote_warmup_reaches_the_worker(loopback):
    gs = remote(loopback.socket_path)
    assert gs.warmup(TRAFFIC.inputs("w", 0)[0], shapes=((12, 0),)) > 0


def test_the_breaker_opens_after_its_threshold(tmp_path):
    gs = remote(str(tmp_path / "absent.sock"), service_breaker_threshold=2,
                service_retry_attempts=1, service_local_fallback=False)
    for _ in range(2):
        with pytest.raises(SolverServiceTransportError):
            gs.tpu.solve(TRAFFIC.inputs("b", 0)[0])
    assert gs.tpu.breaker.state == "open"
    assert metrics.SERVICE_BREAKER_STATE.value() == 1
    with pytest.raises(SolverServiceUnavailable):
        gs.tpu.solve(TRAFFIC.inputs("b", 1)[0])


def test_a_degraded_solve_answers_and_is_recorded(tmp_path):
    gs = remote(str(tmp_path / "absent.sock"), service_breaker_threshold=1,
                service_retry_attempts=1)
    inp = TRAFFIC.inputs("d", 0)[0]
    o0 = metrics.SOLVER_SOLVES.value(path="oracle")
    tracing.set_enabled(True)
    tracing.reset()
    try:
        res = gs.solve(inp, source="provisioning")
        spans = {sp.name for _, sps in tracing.finished_traces()
                 for sp in sps}
    finally:
        tracing.set_enabled(None)
        tracing.reset()
    assert canon(res) == canon(local().solve(inp))
    assert isinstance(gs._local, TorchSolver) and gs._local.device.type == "cpu"
    assert gs._local._incr_armed is False
    assert [e for e in gs.cluster.events if e[3] == "SolverFallback"]
    assert "solver.degraded_local" in spans
    assert metrics.SOLVER_SOLVES.value(path="oracle") == o0
    # the breaker is open now: the next solve fails fast into degraded mode
    assert gs.tpu.breaker.state == "open"
    batch = TRAFFIC.inputs("d", 3)
    got = list(gs.solve_batch(batch))
    assert [canon(r) for r in got] == [canon(r) for r in
                                       local().solve_batch(batch)]
    assert metrics.SOLVER_SOLVES.value(path="oracle") == o0


def test_a_degraded_solve_that_fails_on_the_card_raises(tmp_path,
                                                        monkeypatch):
    from karpenter_tpu_torch.utils import faults
    gs = remote(str(tmp_path / "absent.sock"), service_retry_attempts=1)
    lo = gs._local_solver()
    monkeypatch.setattr(lo, "device", torch.device("cuda"))
    monkeypatch.setattr(lo, "solve", lambda *a, **k: (_ for _ in ()).throw(
        faults.FaultInjected("solver.dispatch", "error")))
    monkeypatch.setattr(lo, "solve_batch",
                        lambda *a, **k: (_ for _ in ()).throw(
                            faults.FaultInjected("solver.dispatch",
                                                 "error")))
    o0 = metrics.SOLVER_SOLVES.value(path="oracle")
    with pytest.raises(faults.FaultInjected):
        gs.solve(TRAFFIC.inputs("c", 0)[0], source="provisioning")
    with pytest.raises(faults.FaultInjected):
        gs.solve_batch(TRAFFIC.inputs("c", 3))
    assert metrics.SOLVER_SOLVES.value(path="oracle") == o0


def test_a_degraded_solve_on_the_cpu_degrades_to_the_oracle(tmp_path,
                                                             monkeypatch):
    gs = remote(str(tmp_path / "absent.sock"), service_retry_attempts=1)
    lo = gs._local_solver()

    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(lo, "solve", boom)
    o0 = metrics.SOLVER_SOLVES.value(path="oracle")
    res = gs.solve(TRAFFIC.inputs("o", 0)[0], source="provisioning")
    assert res.node_count() >= 1
    assert metrics.SOLVER_SOLVES.value(path="oracle") == o0 + 1


def test_concurrent_degraded_solves_build_one_solver(tmp_path):
    gs = remote(str(tmp_path / "absent.sock"), service_retry_attempts=1)
    got = []
    ts = [threading.Thread(target=lambda: got.append(gs._local_solver()))
          for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len({id(s) for s in got}) == 1


def test_the_operator_dashboard_reads_the_worker(loopback):
    from karpenter_tpu_torch.env import Environment
    from karpenter_tpu_torch.operator.operator import Operator
    from karpenter_tpu_torch.utils.clock import RealClock
    opts = Options(solver_endpoint=loopback.socket_path, solver_mesh="off")
    op = Operator(options=opts, env=Environment(clock=RealClock(),
                                                options=opts, device="cpu"),
                  metrics_port=0, health_port=0)
    op.env.solver.solve(TRAFFIC.inputs("dash", 0)[0])
    snap = op._worker_snapshot()
    assert snap["breaker"] == "closed" and snap["in_flight"] == 0
    assert snap["stats"]["catalogs"] >= 1
    assert snap["stats"]["worker"]["device"] == "cpu"
    assert "solves" in snap  # the worker's telemetry snapshot
    # the in-process topology has no worker to ask
    plain = Operator(options=Options(), env=Environment(
        clock=RealClock(), options=Options(), device="cpu"),
        metrics_port=0, health_port=0)
    assert plain._worker_snapshot() is None
