"""The port's provisioning control loop against the JAX package's.

One constructor, parameterised by the package, wires the loop as the JAX
package's `env.py` does, cut to the controllers the port has: the fake
cloud over the 605-type catalog, the pricing and instance-type providers,
the unavailable-offerings cache, the metrics-decorated cloud provider,
the cluster store, `GatedSolver` (JAX `TPUSolver`, or the port's
`TorchSolver` on the CPU) and a `ControllerManager` over the provisioner,
the NodeClaim lifecycle, the fake kubelet and the pod binder.  Both
loops take the headline's pods, settle, take a second wave of the two
smallest sizes, and settle again; `workloads.loop_answer` (the launched
instances, the pods bound per node, the hex price, the rounds) and the
steady-state seams' verdicts must be equal wave by wave.

Under pytest, `tests/conftest.py` gives JAX 8 CPU devices, so both loops
run `Options(solver_mesh="off")`: the answer does not depend on the mesh
(chip_smoke.py runs mesh "auto", one card), and the JAX mesh would only
add compile time.

`python3 tests/test_torch_provisioning.py --pin` prints the JAX loop's
answers at chip_smoke.py's size (LOOP_PODS, LOOP_WAVE2), the constants
chip_smoke.py pins as `LOOP`.
"""

import importlib
import os
import sys
from types import SimpleNamespace

import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

from karpenter_tpu_torch import workloads  # noqa: E402
from karpenter_tpu_torch.models.objects import (  # noqa: E402
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
)


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, M=imp("models"), prov=imp("providers"),
        clock=imp("utils.clock"), cache=imp("utils.cache"),
        metrics=imp("utils.metrics"), cluster=imp("cluster"),
        cp=imp("cloudprovider"), state=imp("controllers.state"),
        ctl=imp("controllers"), opts=imp("operator.options"))


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")


def _fresh_catalog(ns):
    """The default catalog of `ns`'s package read anew from its table.
    The JAX package's own tests change the memoized copy in place (a
    price refresh doubles every offering's price), so a loop compared
    across packages builds its cloud from an unshared copy on both
    sides; None when the package has no table (the cloud synthesises
    the default then)."""
    import json
    cat = importlib.import_module(f"{ns.root}.providers.catalog")
    if not os.path.exists(cat.GENERATED_CATALOG_PATH):
        return None
    with open(cat.GENERATED_CATALOG_PATH) as f:
        return cat.catalog_from_table(json.load(f))


def build_loop(ns, n_pods, store_backend=None, **options):
    """The loop of `ns`'s package holding the headline's first `n_pods`
    pods (not yet reconciled), its cluster on `store_backend` (a backend
    of `ns`'s `store` package; the in-memory store by default);
    `options` override Options(batch idle 0, mesh off)."""
    opts = ns.opts.Options(**{"batch_idle_duration": 0,
                              "solver_mesh": "off", **options})
    clock = ns.clock.FakeClock()
    cloud = ns.prov.FakeCloud(catalog=_fresh_catalog(ns), clock=clock)
    pricing = ns.prov.PricingProvider(cloud)
    unavailable = ns.cache.UnavailableOfferings(clock=clock)
    its = ns.prov.InstanceTypeProvider(cloud, pricing, unavailable,
                                       clock=clock)
    cluster = ns.cluster.Cluster(clock=clock, backend=store_backend)
    cp = ns.metrics.DecoratedCloudProvider(ns.cp.TPUCloudProvider(
        cloud=cloud, instance_types=its, unavailable=unavailable,
        node_classes=cluster.nodeclasses, cluster_name=opts.cluster_name))
    if ns is PORT:
        solver = ns.state.GatedSolver(opts, cluster, device="cpu")
    else:
        solver = ns.state.GatedSolver(opts, cluster)
    ctl = ns.ctl
    manager = ctl.ControllerManager(cluster, [
        ctl.Provisioner(cluster, cp, opts, clock, solver=solver),
        ctl.NodeClaimLifecycle(cluster, cp, opts, clock),
        ctl.FakeKubelet(cluster, cp), ctl.PodBinder(cluster)])
    M = ns.M
    cluster.nodeclasses.create(M.NodeClass(meta=M.ObjectMeta(name="default")))
    cluster.nodepools.create(M.NodePool(meta=M.ObjectMeta(name="default")))
    loop = SimpleNamespace(ns=ns, clock=clock, cloud=cloud, cluster=cluster,
                           solver=solver, manager=manager)
    add_pods(loop, n_pods, "p", workloads.HEADLINE_SIZES)
    return loop


def add_pods(loop, n, prefix, sizes):
    M = loop.ns.M
    for i in range(n):
        loop.cluster.pods.create(M.Pod(
            meta=M.ObjectMeta(name=f"{prefix}{i}"),
            requests=M.Resources.parse(sizes[i % len(sizes)])))


def run_waves(loop, n_wave2):
    """Settle, add the second wave, settle: per wave the loop's answer and
    the delta seam's verdict (outcome, reason, incr reason)."""
    out = []
    for wave in (1, 2):
        if wave == 2:
            add_pods(loop, n_wave2, "w", workloads.WAVE2_SIZES)
        rounds = loop.manager.run_until_idle()
        c = loop.solver.tpu._delta_cache
        out.append((workloads.loop_answer(loop.cluster, loop.cloud, rounds),
                    (c.last_outcome, c.last_reason, c.last_incr_reason)))
    return out


def oracle_solves(ns):
    return ns.metrics.SOLVER_SOLVES.value(path="oracle")


def test_loop_matches_reference_wave_by_wave():
    ref = run_waves(build_loop(JAX, 2000), 200)
    o0 = oracle_solves(PORT)
    loop = build_loop(PORT, 2000)
    got = run_waves(loop, 200)
    assert got == ref
    assert got[0][0]["bound"] == 2000 and got[1][0]["bound"] == 2200
    assert got[0][0]["unbound"] == got[1][0]["unbound"] == 0
    # the device path answered both waves: no oracle solve, no fallback
    assert oracle_solves(PORT) == o0
    assert not [e for e in loop.cluster.events if e[3] == "SolverFallback"]
    assert loop.solver.tpu.last_phase_ms["decode"] >= 0
    assert not loop.solver.tpu._used_split


def test_workloads_loop_gives_the_reference_answer():
    """`workloads.provisioning_loop` (chip_smoke.py phase 18's loop) gives
    the JAX loop's answer."""
    ref = run_waves(build_loop(JAX, 300), 30)
    from karpenter_tpu_torch.operator.options import Options
    lp = workloads.provisioning_loop(
        300, Options(batch_idle_duration=0, solver_mesh="off"),
        device="cpu")
    got = []
    for wave in (1, 2):
        if wave == 2:
            lp.add_pods(workloads.headline_pods(
                30, prefix="w", sizes=workloads.WAVE2_SIZES))
        rounds = lp.settle()
        got.append(workloads.loop_answer(lp.cluster, lp.cloud, rounds))
    assert got == [a for a, _ in ref]


# -- the provisioning cases of tests/test_e2e.py that need only this
# -- slice's controllers
def _mkpod(ns, name, cpu="500m", mem="1Gi"):
    M = ns.M
    return M.Pod(meta=M.ObjectMeta(name=name),
                 requests=M.Resources.parse({"cpu": cpu, "memory": mem}))


def test_pending_pods_become_running():
    loop = build_loop(PORT, 0)
    for i in range(10):
        loop.cluster.pods.create(_mkpod(PORT, f"p{i}"))
    loop.manager.run_until_idle()
    pods = loop.cluster.pods.list()
    assert all(p.scheduled and p.phase == "Running" for p in pods)
    claims = loop.cluster.nodeclaims.list()
    assert len(claims) == 1
    claim = claims[0]
    assert claim.is_(COND_LAUNCHED) and claim.is_(COND_REGISTERED) \
        and claim.is_(COND_INITIALIZED)
    node = loop.cluster.nodes.get(claim.node_name)
    assert node.ready
    inst = loop.cloud.get_instance(claim.provider_id)
    assert inst is not None and inst.tags["karpenter.sh/nodepool"] == \
        "default"
    # spot preferred when the claim is capacity-type-flexible
    assert inst.capacity_type == "spot"


def test_existing_capacity_reused():
    loop = build_loop(PORT, 0)
    loop.cluster.pods.create(_mkpod(PORT, "first"))
    loop.manager.run_until_idle()
    assert len(loop.cluster.nodeclaims.list()) == 1
    # a tiny second pod fits the first node's leftover: no new claim
    loop.cluster.pods.create(_mkpod(PORT, "second", cpu="50m", mem="64Mi"))
    loop.manager.run_until_idle()
    assert len(loop.cluster.nodeclaims.list()) == 1
    assert loop.cluster.pods.get("second").scheduled


def test_batch_window_delays_solve():
    loop = build_loop(PORT, 0, batch_idle_duration=1.0,
                      batch_max_duration=10.0)
    loop.cluster.pods.create(_mkpod(PORT, "p0"))
    loop.manager.run_once()
    assert len(loop.cluster.nodeclaims.list()) == 0  # window still open
    loop.clock.step(1.1)  # the idle period passes
    loop.manager.run_until_idle()
    assert len(loop.cluster.nodeclaims.list()) == 1


class _FailingSolver:
    """A device solver whose every solve fails, on `device`."""

    def __init__(self, device):
        import torch
        self.device = torch.device(device)

    def solve(self, inp, max_nodes=None):
        raise RuntimeError("kernel launch failed")

    def solve_batch(self, inps, max_nodes=None):
        raise RuntimeError("kernel launch failed")


def test_a_failing_device_solve_falls_back_to_the_oracle_on_the_cpu():
    """The device path is the one that answers (the test above); when a
    solver on the CPU raises, GatedSolver records SolverFallback and the
    oracle answers, counted on the oracle path."""
    loop = build_loop(PORT, 0)
    loop.solver.tpu = _FailingSolver("cpu")
    loop.cluster.pods.create(_mkpod(PORT, "p0"))
    o0 = oracle_solves(PORT)
    loop.manager.run_until_idle()
    assert loop.cluster.pods.get("p0").scheduled
    assert oracle_solves(PORT) == o0 + 1
    assert [e[3] for e in loop.cluster.events].count("SolverFallback") == 1


def test_a_failing_solve_on_the_card_raises():
    """A solver on the card never hands a failed solve to the oracle: the
    error reaches the caller of `solve`, `solve_batch` and the
    provisioning pass, and no oracle solve or SolverFallback is
    recorded."""
    loop = build_loop(PORT, 0)
    loop.solver.tpu = _FailingSolver("cuda")
    loop.cluster.pods.create(_mkpod(PORT, "p0"))
    o0 = oracle_solves(PORT)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        loop.manager.run_until_idle()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        loop.solver.solve(None)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        loop.solver.solve_batch([None])
    assert not loop.cluster.pods.get("p0").scheduled
    assert oracle_solves(PORT) == o0
    assert "SolverFallback" not in [e[3] for e in loop.cluster.events]


def test_startup_warmup_pays_the_first_uses(monkeypatch):
    """With KARPENTER_TPU_WARMUP set, the provisioner's first pass warms
    its solver once, at the reference's shapes, before its first solve;
    that solve then meets no first-use event."""
    from karpenter_tpu_torch.solver import firstuse
    monkeypatch.setenv("KARPENTER_TPU_WARMUP", "1")
    loop = build_loop(PORT, 200)
    shapes, fresh = [], []
    warmup, solve = loop.solver.tpu.warmup, loop.solver.tpu.solve

    def counted_warmup(inp, **kw):
        shapes.append(kw.get("shapes"))
        return warmup(inp, **kw)

    def counted_solve(inp, **kw):
        f0 = firstuse.total()
        res = solve(inp, **kw)
        fresh.append(firstuse.total() - f0)
        return res
    loop.solver.tpu.warmup = counted_warmup
    loop.solver.tpu.solve = counted_solve
    loop.manager.run_until_idle()
    assert shapes == [((8, 0), (512, 0))]
    assert fresh and fresh[0] == 0
    assert all(p.scheduled for p in loop.cluster.pods.list())


def test_remote_solver_endpoint_waits_for_slice_6():
    """With an endpoint the loop's GatedSolver is the solver service's
    client, as the reference's (connecting only at the first solve);
    the in-process solver is built only in degraded mode."""
    from karpenter_tpu_torch.service import SolverServiceClient
    loop = build_loop(PORT, 0, solver_endpoint="/tmp/solverd.sock")
    assert isinstance(loop.solver.tpu, SolverServiceClient)
    assert loop.solver.tpu.socket_path == "/tmp/solverd.sock"
    assert loop.solver._remote and loop.solver._local is None
    assert not hasattr(loop.solver, "_delta_feed")


def _pin():
    """The JAX loop's answers at chip_smoke.py's size (chip_smoke.LOOP),
    then what its decision ledger and timeline recorded over each wave
    (`workloads.WaveObserver`, chip_smoke.LOOP_OBSERVED)."""
    import chip_smoke
    from karpenter_tpu.timeline import invariants, recorder
    from karpenter_tpu.utils import flightrecorder, ledger, metrics
    for answer, seams in run_waves(build_loop(JAX, chip_smoke.LOOP_PODS),
                                   chip_smoke.LOOP_WAVE2):
        print(answer, seams)
    obs = workloads.Observability(
        metrics=metrics, ledger=ledger, invariants=invariants,
        flightrecorder=flightrecorder, timeline=recorder)
    obs.reset()
    watch = workloads.WaveObserver(obs)
    loop = build_loop(JAX, chip_smoke.LOOP_PODS)
    for wave in (1, 2):
        if wave == 2:
            add_pods(loop, chip_smoke.LOOP_WAVE2, "w", workloads.WAVE2_SIZES)
        watch.start(loop.cluster)
        loop.manager.run_until_idle()
        print(watch.finish(loop.cluster))


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin"]:
        _pin()
