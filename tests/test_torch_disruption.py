"""The port's disruption control loop against the JAX package's.

One builder, parameterised by the package, wires each package's own
`env.Environment` (JAX `TPUSolver`, or the port's `TorchSolver` on the
CPU) over an unshared copy of the 605-type catalog: `mkenv` for the
controller scenarios (`tests/test_torch_controllers.py`), and
`workloads.disruption_loop` with the package's modules for chip_smoke.py
phase 19's loop.  `workloads.DisruptionWaves` drives both loops through
the same three waves (provision; resize every pod in place and settle
until a settle changes nothing; spot interruptions), stepping both
FakeClocks identically, and reads each package's objects by attribute
only: `loop_answer` plus the disruption record (the ordered Disrupted*
events with their candidates and replacements, the Unconsolidatable
verdicts by code, the IEEE-hex sums of retired and added prices, the
settles and rounds) must be equal wave by wave.

Six seeds of `tests/test_disruption_fuzz.py`'s generator run through
both packages too: the whole trace (every event, claim, pod and
instance) must be equal, and the port's cluster must keep that file's
four invariants.

Under pytest, `tests/conftest.py` gives JAX 8 CPU devices, so both sides
run `Options(solver_mesh="off")`.

`python3 tests/test_torch_disruption.py --pin` prints the JAX loop's
answers at chip_smoke.py's size (`workloads.DISRUPTION_NODES`), the
constants chip_smoke.py pins as `DISRUPTION_LOOP`.
"""

import functools
import importlib
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

from karpenter_tpu_torch import workloads  # noqa: E402


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, M=imp("models"), env=imp("env"), objects=imp(
            "models.objects"), Options=imp("operator.options").Options,
        ctl=imp("controllers"), fake_cloud=imp("providers.fake_cloud"),
        catalog=imp("providers.catalog"), metrics=imp("utils.metrics"),
        explain=imp("solver.explain"), cron=imp("utils.cron"))


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scans run thousands of small tensor operations: on one
    intra-op thread they do not contend with JAX's threads in the same
    process or the other test workers' (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fresh_catalog(ns):
    """The default catalog of `ns`'s package read anew from its table: the
    JAX package's own tests change the memoized copy in place (a price
    refresh doubles every offering's price)."""
    with open(ns.catalog.GENERATED_CATALOG_PATH) as f:
        return ns.catalog.catalog_from_table(json.load(f))


def _options(ns, **kw):
    return ns.Options(**{"batch_idle_duration": 0, "solver_mesh": "off",
                         **kw})


def mkenv(ns, pool=True, **options):
    """`ns`'s Environment (the port's on the CPU) with the default
    NodeClass and, with `pool`, one NodePool `default`."""
    kw = {"device": "cpu"} if ns is PORT else {}
    env = ns.env.Environment(options=_options(ns, **options),
                             catalog=fresh_catalog(ns), **kw)
    env.add_default_nodeclass()
    if pool:
        env.cluster.nodepools.create(
            ns.M.NodePool(meta=ns.M.ObjectMeta(name="default")))
    return env


def mkpod(ns, name, cpu="500m", mem="1Gi", **kw):
    M = ns.M
    return M.Pod(meta=M.ObjectMeta(name=name, labels=kw.pop("labels", {})),
                 requests=M.Resources.parse({"cpu": cpu, "memory": mem}),
                 **kw)


def trace(env):
    """Everything the controllers did, by attribute: the events (time,
    kind, object, reason, message), the claims (name, pool, deleting,
    node), the pods (name, node, phase) and the instances (id, type,
    zone, capacity type, state, subnet, image)."""
    return {
        "events": [tuple(e[:5]) for e in env.cluster.events],
        "claims": sorted((c.name, c.nodepool, c.meta.deleting, c.node_name)
                         for c in env.cluster.nodeclaims.list()),
        "pods": sorted((p.meta.name, p.node_name, p.phase)
                       for p in env.cluster.pods.list()),
        "instances": sorted(
            (i.instance_id, i.instance_type, i.zone, i.capacity_type,
             i.state, i.subnet_id, i.image_id)
            for i in env.cloud.instances.values())}


def loop_pkg(ns):
    """`ns`'s package for `workloads.disruption_loop` (the port's solver
    on the CPU)."""
    env = ns.env.Environment
    if ns is PORT:
        env = functools.partial(env, device="cpu")
    return workloads.Package(M=ns.M, Environment=env, Options=ns.Options)


def run_loop(ns, n_pods, budget=None, consolidate_after=None):
    """The disruption loop of `ns`'s package at `n_pods`, through its three
    waves: (the waves' answers, the environment).  `budget` (a nodes
    string) and `consolidate_after` (seconds), when given, replace every
    pool's before wave 1."""
    env = workloads.disruption_loop(
        n_pods, options=_options(ns), catalog=fresh_catalog(ns),
        pkg=loop_pkg(ns))
    for pool in env.cluster.nodepools.list():
        if budget is not None:
            pool.disruption.budgets = [ns.M.Budget(nodes=budget)]
        if consolidate_after is not None:
            pool.disruption.consolidate_after = consolidate_after
        env.cluster.nodepools.update(pool)
    w = workloads.DisruptionWaves(env)
    return [w.wave1(), w.wave2(), w.wave3()], env


class _Routes:
    """Counts the port's simulations by the kernel that answered them:
    K4's sweep chunks and K5's batched launches (`ffd.solve_ffd_sweep`,
    `ffd.solve_ffd_batch`), with each launch's shape."""

    def __init__(self):
        from karpenter_tpu_torch.solver import ffd
        self.ffd = ffd
        self.sweep, self.batch = [], []

    def __enter__(self):
        ffd = self.ffd
        self.real = (ffd.solve_ffd_sweep, ffd.solve_ffd_batch)
        real_sweep, real_batch = self.real

        def sweep(sw, c, n, k=0):
            self.sweep.append((sw.B, sw.G, sw.E))
            return real_sweep(sw, c, n, k)

        def batch(b, c, n, *a, **kw):
            self.batch.append((b.B, b.G, b.E))
            return real_batch(b, c, n, *a, **kw)
        ffd.solve_ffd_sweep, ffd.solve_ffd_batch = sweep, batch
        return self

    def __exit__(self, *exc):
        self.ffd.solve_ffd_sweep, self.ffd.solve_ffd_batch = self.real


SMALL_FLEET = 40


def test_small_fleet_waves_match_reference():
    """Phase 19's three waves at 40 nodes: the JAX loop's answer and
    disruption record, wave by wave, with the device path answering every
    simulation (no oracle solve, no SolverFallback)."""
    ref, _ = run_loop(JAX, SMALL_FLEET)
    o0 = PORT.metrics.SOLVER_SOLVES.value(path="oracle")
    with _Routes() as routes:
        got, env = run_loop(PORT, SMALL_FLEET)
    assert got == ref
    w1, w2, w3 = got
    assert w1["instances"] == SMALL_FLEET and w1["bound"] == SMALL_FLEET
    acts = w2["disruption"]["acts"]
    # multi-node deletes, single-node deletes and a cheaper replacement
    assert max(a[1] for a in acts) > 1
    assert any(a[1] == 1 and not a[3] for a in acts)
    assert any(a[3] for a in acts)
    assert w2["instances"] < SMALL_FLEET // 4 and w2["unbound"] == 0
    assert w3["bound"] == SMALL_FLEET and w3["unbound"] == 0
    assert w3["instances_digest"] != w2["instances_digest"]
    # the simulations took K4's sweep (at 40 nodes no exclusion set is
    # wider than the sweep's 8), the provisioner's solves K5
    assert routes.sweep and routes.batch
    assert PORT.metrics.SOLVER_SOLVES.value(path="oracle") == o0
    assert not [e for e in env.cluster.events if e[3] == "SolverFallback"]


def test_workloads_loop_is_the_test_builder():
    """`workloads.disruption_loop` with its defaults (the port's package)
    builds the loop the test builder builds for the port."""
    from karpenter_tpu_torch.operator.options import Options
    a = workloads.disruption_loop(
        6, options=Options(batch_idle_duration=0, solver_mesh="off"),
        device="cpu", catalog=fresh_catalog(PORT))
    b = workloads.disruption_loop(
        6, options=_options(PORT), catalog=fresh_catalog(PORT),
        pkg=loop_pkg(PORT))
    for env in (a, b):
        assert type(env).__module__ == "karpenter_tpu_torch.env"
    wa, wb = (workloads.DisruptionWaves(e) for e in (a, b))
    assert [wa.wave1(), wa.wave2()] == [wb.wave1(), wb.wave2()]
    pools = {p.name: p for p in a.cluster.nodepools.list()}
    assert pools["spot"].weight == 100 and pools["on-demand"].weight == 10
    assert pools["spot"].limits.get("cpu") == PORT.M.Resources.limits(
        {"cpu": 16 * 3}).get("cpu")


def test_tiny_fleet_matches_reference():
    """Eight nodes: every pool's 10% budget rounds up to one node, so each
    multi-node prefix is over budget and single-node acts carry wave 2."""
    ref, _ = run_loop(JAX, 8)
    got, _ = run_loop(PORT, 8)
    assert got == ref
    assert got[1]["disruption"]["acts"]
    assert all(a[1] == 1 for a in got[1]["disruption"]["acts"])


def test_wide_prefixes_match_reference():
    """40 nodes under a 100% budget: multi-node prefixes wider than the
    sweep's 8 nodes are holes that the same `solve_batch` sends to K5's
    generic batch (B > 1; the provisioner's solves are B=1), and the
    loop still gives the JAX answer wave by wave."""
    ref, _ = run_loop(JAX, SMALL_FLEET, budget="100%")
    with _Routes() as routes:
        got, _ = run_loop(PORT, SMALL_FLEET, budget="100%")
    assert got == ref
    assert max(a[1] for a in got[1]["disruption"]["acts"]) > 8
    assert any(b > 1 for b, _, _ in routes.batch)


def test_consolidate_after_zero_matches_reference(monkeypatch):
    """The models' default consolidateAfter of 0: wave 1's disruption
    passes see every node as it launches, their simulations strand and
    the host oracle re-judges each (the path chip_smoke.py's loop, at one
    clock step, does not drive); the JAX answer wave by wave."""
    from karpenter_tpu_torch.solver import solve
    rescued = []
    real = solve.TorchSolver._rescue_stranded

    def counted(self, inp, res):
        rescued.append(len(inp.pods))
        return real(self, inp, res)
    monkeypatch.setattr(solve.TorchSolver, "_rescue_stranded", counted)
    ref, _ = run_loop(JAX, 12, consolidate_after=0.0)
    got, _ = run_loop(PORT, 12, consolidate_after=0.0)
    assert got == ref
    assert got[0]["disruption"]["verdicts"] == {
        "Unconsolidatable:CandidateNotReschedulable": 12}
    assert rescued


# -- tests/test_disruption_fuzz.py's generator through both packages --------
FUZZ_SEEDS = range(6)


def _cluster_price(env, instance_running):
    catalog = {it.name: it for it in env.cloud.describe_instance_types()}
    total = 0.0
    for inst in env.cloud.instances.values():
        if inst.state != instance_running:
            continue
        total += min(o.price for o in catalog[inst.instance_type].offerings
                     if o.zone == inst.zone
                     and o.capacity_type == inst.capacity_type)
    return total


def _no_leaks(env, instance_running):
    claims = env.cluster.nodeclaims.list()
    running = {i.instance_id for i in env.cloud.instances.values()
               if i.state == instance_running}
    assert {c.provider_id for c in claims} == running
    assert {n.name for n in env.cluster.nodes.list()} == {
        c.node_name for c in claims}


def fuzz_run(ns, seed):
    """`test_consolidation_invariants`'s workload for `seed` on `ns`'s
    package: (the trace after provisioning, after consolidating the
    shrunk workload and after one more settle; the three fleet prices;
    the pods dropped)."""
    rng = np.random.RandomState(7_000 + seed)
    env = mkenv(ns)
    running = ns.fake_cloud.INSTANCE_RUNNING
    n_classes = rng.randint(2, 5)
    names = []
    for g in range(n_classes):
        cpu = int(rng.choice([250, 500, 1000, 2000, 4000, 8000]))
        mem = int(rng.choice([512, 1024, 2048, 8192]))
        for i in range(rng.randint(3, 20)):
            name = f"g{g}-p{i}"
            env.cluster.pods.create(mkpod(ns, name, f"{cpu}m", f"{mem}Mi"))
            names.append(name)
    out, prices = [], []
    env.settle()
    assert all(p.scheduled and p.phase == "Running"
               for p in env.cluster.pods.list())
    _no_leaks(env, running)
    out.append(trace(env))
    prices.append(_cluster_price(env, running))
    drop = rng.choice(names, size=max(1, int(
        len(names) * rng.uniform(0.4, 0.8))), replace=False)
    for name in drop:
        env.cluster.pods.get(name).node_name = None
        env.cluster.pods.delete(name)
    for _ in range(2):
        env.settle()
        out.append(trace(env))
        prices.append(_cluster_price(env, running))
        _no_leaks(env, running)
    return out, prices, set(names) - set(drop), env


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_seed_matches_reference(seed):
    ref, ref_prices, _, _ = fuzz_run(JAX, seed)
    got, prices, survivors, env = fuzz_run(PORT, seed)
    assert got == ref
    assert [p.hex() for p in prices] == [p.hex() for p in ref_prices]
    # the four invariants of tests/test_disruption_fuzz.py
    pods = env.cluster.pods.list()
    assert {p.meta.name for p in pods} == survivors
    assert all(p.scheduled and p.phase == "Running" for p in pods)
    assert prices[1] <= prices[0] + 1e-9
    assert got[2]["claims"] == got[1]["claims"]
    assert abs(prices[2] - prices[1]) < 1e-9


def _pin():
    """The JAX loop's answers at chip_smoke.py's size, in the form
    chip_smoke.py pins them (chip_smoke.DISRUPTION_LOOP)."""
    import chip_smoke
    waves, _ = run_loop(JAX, workloads.DISRUPTION_NODES)
    for answer in waves:
        print(chip_smoke.disruption_pin(answer))


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin"]:
        _pin()
