"""The port's controllers against the JAX package's, scenario by scenario.

The scenarios of `tests/test_disruption.py`,
`tests/test_lifecycle_controllers.py` and
`tests/test_nodeclass_controllers.py`, each written once against a
package namespace and run on both packages' `Environment`s (the test
builder `mkenv` of `tests/test_torch_disruption.py`: the JAX package's
`TPUSolver`, the port's `TorchSolver` on the CPU).  The whole trace —
every event with its time and message, every claim, pod and instance —
and what the scenario observes must be equal; the port's outcome must
also hold the reference test's own assertions.
"""

import pytest
import torch

from tests.test_torch_disruption import JAX, PORT, mkenv, mkpod, trace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the plain scans, as in
    tests/test_torch_disruption.py (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(scenario, **env_kw):
    """Run `scenario(ns, env)` on each package; the two traces and
    observations must be equal.  Returns the port's (env, observation)."""
    out = {}
    for ns in (JAX, PORT):
        env = mkenv(ns, **env_kw)
        obs = scenario(ns, env)
        out[ns.root] = (env, obs, trace(env))
    (_, jobs, jtrace), (penv, pobs, ptrace) = (out[JAX.root],
                                               out[PORT.root])
    assert ptrace == jtrace
    assert pobs == jobs
    return penv, pobs


def reasons(env):
    return {e[3] for e in env.cluster.events}


def claim_names(env):
    return {c.name for c in env.cluster.nodeclaims.list()}


# -- disruption -------------------------------------------------------------
def two_underutilized_nodes(ns, env):
    """tests/test_disruption.py's two nearly empty nodes, each holding one
    small pod once the anchors scale away."""
    env.cluster.pods.create(mkpod(ns, "anchor-1", cpu="15", mem="20Gi"))
    env.cluster.pods.create(mkpod(ns, "small-1", cpu="700m", mem="512Mi"))
    env.settle()
    env.cluster.pods.create(mkpod(ns, "anchor-2", cpu="15", mem="20Gi"))
    env.cluster.pods.create(mkpod(ns, "small-2", cpu="700m", mem="512Mi"))
    env.settle()
    assert len(env.cluster.nodeclaims.list()) == 2
    for name in ("anchor-1", "anchor-2"):
        env.cluster.pods.get(name).node_name = None
        env.cluster.pods.delete(name)


def test_empty_node_deleted():
    def scenario(ns, env):
        env.cluster.pods.create(mkpod(ns, "p"))
        env.settle()
        env.cluster.pods.get("p").node_name = None
        env.cluster.pods.delete("p")
        env.settle()
        return len(env.cluster.nodeclaims.list())
    env, n = both(scenario)
    assert n == 0
    assert all(i.state == "terminated" for i in env.cloud.instances.values())
    assert "DisruptedEmpty" in reasons(env)


def test_multi_or_single_node_consolidation():
    def scenario(ns, env):
        two_underutilized_nodes(ns, env)
        env.settle()
        return sorted({p.node_name for p in env.cluster.pods.list()})
    env, nodes = both(scenario)
    assert len(env.cluster.nodeclaims.list()) == 1 and len(nodes) == 1
    assert all(p.scheduled for p in env.cluster.pods.list())


def test_single_node_replace():
    """One node whose pod fits a cheaper replacement: the pre-spin
    replacement initializes, then the candidate goes."""
    def scenario(ns, env):
        env.cluster.pods.create(mkpod(ns, "big", cpu="15", mem="20Gi"))
        env.cluster.pods.create(mkpod(ns, "small", cpu="700m",
                                      mem="512Mi"))
        env.settle()
        env.cluster.pods.get("big").node_name = None
        env.cluster.pods.delete("big")
        env.settle()
        return sorted(claim_names(env))
    env, names = both(scenario)
    assert names == ["default-replace-1"]
    assert "DisruptedUnderutilized" in reasons(env)
    assert env.cluster.pods.get("small").scheduled


def test_unconsolidatable_event():
    def scenario(ns, env):
        env.cluster.pods.create(mkpod(ns, "p"))
        env.settle()
        env.settle()
        return len(env.cluster.nodeclaims.list())
    env, n = both(scenario)
    assert n == 1 and "Unconsolidatable" in reasons(env)


@pytest.mark.parametrize("where", ["pods", "nodes", "nodeclaims"])
def test_do_not_disrupt_blocks(where):
    def scenario(ns, env):
        two_underutilized_nodes(ns, env)
        for o in getattr(env.cluster, where).list():
            o.meta.annotations[
                ns.M.wellknown.DO_NOT_DISRUPT_ANNOTATION] = "true"
        env.settle()
        return len(env.cluster.nodeclaims.list())
    assert both(scenario)[1] == 2


def test_zero_budget_blocks():
    def scenario(ns, env):
        env.cluster.nodepools.get("default").disruption.budgets = [
            ns.objects.Budget(nodes="0")]
        two_underutilized_nodes(ns, env)
        env.settle()
        return len(env.cluster.nodeclaims.list())
    assert both(scenario)[1] == 2


def test_multi_node_respects_subset_budget():
    def scenario(ns, env):
        env.cluster.nodepools.get("default").disruption.budgets = [
            ns.objects.Budget(nodes="1")]
        two_underutilized_nodes(ns, env)
        env.manager.run_once()
        sizes = [len(c.candidate_names) for c in env.disruption.commands]
        env.settle()
        return sizes, len(env.cluster.nodeclaims.list())
    (sizes, n) = both(scenario)[1]
    assert all(s <= 1 for s in sizes) and n == 1


def test_replacement_protected_from_emptiness():
    def scenario(ns, env):
        env.cluster.nodepools.get("default").disruption.budgets = [
            ns.objects.Budget(nodes="100%")]
        two_underutilized_nodes(ns, env)
        env.settle()
        return len(env.cloud.instances)
    env, launched = both(scenario)
    claims = env.cluster.nodeclaims.list()
    assert len(claims) == 1 and launched == 3
    assert {p.node_name for p in env.cluster.pods.list()} == {
        claims[0].node_name}


def test_consolidate_after_delays():
    def scenario(ns, env):
        env.cluster.nodepools.get(
            "default").disruption.consolidate_after = 300.0
        two_underutilized_nodes(ns, env)
        env.settle()
        young = len(env.cluster.nodeclaims.list())
        env.clock.step(301)
        env.settle()
        return young, len(env.cluster.nodeclaims.list())
    assert both(scenario)[1] == (2, 1)


def test_cron_window_blocks_then_releases():
    def scenario(ns, env):
        env.cluster.nodepools.get("default").disruption.budgets = [
            ns.objects.Budget(nodes="0", schedule="0 * * * *",
                              duration=1800.0)]
        two_underutilized_nodes(ns, env)
        now = env.clock.now()
        env.clock.step(3600.0 - (now % 3600.0) + 60.0)
        env.settle()
        frozen = len(env.cluster.nodeclaims.list())
        env.clock.step(1800.0)
        env.settle()
        return frozen, len(env.cluster.nodeclaims.list())
    assert both(scenario)[1] == (2, 1)


def test_invalid_schedule_binds():
    def scenario(ns, env):
        env.cluster.nodepools.get("default").disruption.budgets = [
            ns.objects.Budget(nodes="0", schedule="not a cron",
                              duration=60.0)]
        two_underutilized_nodes(ns, env)
        env.settle()
        return len(env.cluster.nodeclaims.list())
    env, n = both(scenario)
    assert n == 2 and "InvalidBudgetSchedule" in reasons(env)


@pytest.mark.parametrize("expr,t", [
    ("0 0 * * *", 0.0), ("0 0 * * *", 86399.0), ("0 0 * * *", 86400.0),
    ("*/15 * * * *", 960.0), ("0 0 * * 4", 3600.0), ("0 0 * * 5", 3600.0),
    ("0 0 1 1 *", 365 * 86400.0 + 90 * 86400.0), ("30 2 * 1-6 MON-FRI",
                                                   5 * 86400.0 + 9000.0)])
def test_cron_matches_reference(expr, t):
    assert PORT.cron.last_fire(expr, t) == JAX.cron.last_fire(expr, t)
    for dur in (None, 3600.0, 180 * 86400.0):
        assert PORT.cron.in_window(expr, dur, t) == \
            JAX.cron.in_window(expr, dur, t)
    with pytest.raises(PORT.cron.CronError):
        PORT.cron.parse("not a cron")


def test_drift_replaces_node():
    def scenario(ns, env):
        env.cluster.pods.create(mkpod(ns, "p"))
        env.settle()
        old = env.cluster.nodeclaims.list()[0].name
        env.cluster.nodeclasses.get("default").boot_config["image"] = "v2"
        env.cluster.mutated()
        env.settle()
        return old, sorted(claim_names(env))
    env, (old, names) = both(scenario)
    assert len(names) == 1 and names[0] != old
    assert env.cluster.pods.get("p").scheduled


@pytest.mark.parametrize("gate", [True, False])
def test_spot_to_spot_gate_and_flexibility(gate):
    """The spot-to-spot rule on hand-built candidates (the reference's
    TestSpotToSpot): a spot replacement keeps at least 15 types, and only
    with its feature gate on."""
    def scenario(ns, env):
        from importlib import import_module
        dis = import_module(f"{ns.root}.controllers.disruption")
        types = import_module(f"{ns.root}.scheduling.types")
        M = ns.M
        env.options.feature_gates.spot_to_spot_consolidation = gate
        node = M.Node(meta=M.ObjectMeta(name="n", labels={
            M.wellknown.CAPACITY_TYPE_LABEL: "spot"}))
        cand = dis.Candidate(claim=None, node=node, pool=None, price=1.0)
        out = []
        for names in (["a"] * 5, [f"t{i}" for i in range(
                dis.SPOT_TO_SPOT_MIN_TYPES)]):
            sim = types.ScheduleResult(new_claims=[types.NewNodeClaim(
                nodepool="default", node_class_ref="default",
                requirements=M.Requirements(M.Requirement.make(
                    M.wellknown.CAPACITY_TYPE_LABEL, "In", "spot")),
                instance_type_names=names, price=0.5)])
            r = env.disruption._unacceptable_reason([cand], sim)
            out.append(None if r is None else (r.code, str(r)))
        return out
    out = both(scenario)[1]
    if gate:
        assert out[0][0] == "SpotFlexibilityTooLow" and out[1] is None
    else:
        assert [o[0] for o in out] == ["SpotToSpotDisabled"] * 2


def test_aborted_command_on_failed_replacement():
    """A replacement that fails to launch aborts its command: the
    replacement claim goes and the candidate stays."""
    def scenario(ns, env):
        from importlib import import_module
        env.cluster.pods.create(mkpod(ns, "big", cpu="15", mem="20Gi"))
        env.cluster.pods.create(mkpod(ns, "small", cpu="700m",
                                      mem="512Mi"))
        env.settle()
        first = sorted(claim_names(env))
        env.cluster.pods.get("big").node_name = None
        env.cluster.pods.delete("big")
        # every launch fails terminally from here: the replacement claim
        # is removed before it initializes
        err = import_module(f"{ns.root}.cloudprovider").CloudProviderError

        def fail(claim):
            raise err("launch refused")
        env.cloud_provider.create = fail
        env.manager.run_once()
        cmds = [(c.reason, c.candidate_names, c.replacement_names)
                for c in env.disruption.commands]
        env.clock.step(601.0)
        env.manager.run_once()
        tainted = [t.key for n in env.cluster.nodes.list() for t in n.taints]
        return first, cmds, tainted, sorted(claim_names(env))
    env, (first, cmds, tainted, names) = both(scenario)
    assert cmds and cmds[0][2] == ["default-replace-1"]
    assert "DisruptionAborted" in reasons(env)
    # the candidate stays; the failed replacement is gone (the same pass
    # then tries again, tainting the candidate anew)
    assert set(first) <= set(names) and "default-replace-1" not in names
    assert PORT.M.wellknown.DISRUPTION_TAINT_KEY in tainted


# -- termination, interruption, gc, expiration, preemption ------------------
def provision(ns, env, n=3):
    for i in range(n):
        env.cluster.pods.create(mkpod(ns, f"p{i}"))
    env.settle()
    return env.cluster.nodeclaims.list()


def test_termination_drains_and_releases():
    def scenario(ns, env):
        claim = provision(ns, env)[0]
        env.cluster.nodeclaims.delete(claim.name)
        env.settle()
        return claim.name, env.cloud.instances[claim.provider_id].state
    env, (name, state) = both(scenario)
    assert env.cluster.nodeclaims.get(name) is None and state == "terminated"
    assert all(p.scheduled for p in env.cluster.pods.list())


def test_termination_under_pdb_and_its_grace():
    """The drain holds while a PDB allows no disruption, then the pool's
    terminationGracePeriod force-drains it."""
    def scenario(ns, env):
        env.cluster.nodepools.get("default").termination_grace_period = 600.0
        for i in range(3):
            env.cluster.pods.create(mkpod(ns, f"g{i}",
                                          labels={"app": "held"}))
        env.settle()
        env.cluster.pdbs.create(ns.objects.PodDisruptionBudget(
            meta=ns.M.ObjectMeta(name="pdb0"), selector={"app": "held"},
            max_unavailable=0))
        claim = env.cluster.nodeclaims.list()[0]
        env.cluster.nodeclaims.delete(claim.name)
        env.settle()
        held = env.cluster.nodeclaims.get(claim.name)
        node = env.cluster.nodes.get(claim.node_name)
        blocked = (held is not None and held.meta.deleting,
                   sorted(t.key for t in node.taints),
                   len(env.cluster.pods_on_node(node.name)))
        env.clock.step(601.0)
        env.settle()
        return blocked, env.cluster.nodeclaims.get(claim.name) is None
    env, ((deleting, taints, on_node), gone) = both(scenario)
    assert deleting and on_node == 3 and gone
    assert PORT.M.wellknown.DISRUPTED_TAINT_KEY in taints
    assert "TerminationGraceElapsed" in reasons(env)
    assert all(p.scheduled for p in env.cluster.pods.list())


def test_expiration_replaces_claims():
    def scenario(ns, env):
        env.cluster.nodepools.get("default").expire_after = 3600.0
        old = {c.name for c in provision(ns, env)}
        env.clock.step(3601)
        env.settle()
        return sorted(old), sorted(claim_names(env))
    env, (old, now) = both(scenario)
    assert not set(old) & set(now) and "Expired" in reasons(env)


def test_gc_reclaims_a_leaked_instance():
    def scenario(ns, env):
        leaked, _ = env.cloud.create_fleet(
            [ns.fake_cloud.FleetCandidate("m5.large", "tpu-west-1a",
                                          "on-demand", 0.1)],
            tags={"karpenter.sh/discovery": env.options.cluster_name})
        env.settle()
        return env.cloud.instances[leaked.instance_id].state
    env, state = both(scenario)
    assert state == "terminated" and "LeakedInstanceReclaimed" in reasons(env)


def test_gc_reschedules_a_vanished_instance():
    def scenario(ns, env):
        claim = provision(ns, env)[0]
        env.cloud.terminate_instances([claim.provider_id])
        env.settle()
        return env.cluster.nodeclaims.get(claim.name) is None
    env, gone = both(scenario)
    assert gone and all(p.scheduled for p in env.cluster.pods.list())


@pytest.mark.parametrize("kind", ["spot_interruption",
                                  "rebalance_recommendation",
                                  "scheduled_change", "state_change"])
def test_interruption_kinds(kind):
    def scenario(ns, env):
        claim = provision(ns, env)[0]
        inst = env.cloud.get_instance(claim.provider_id)
        iid = inst.instance_id
        if kind == "spot_interruption":
            env.cloud.interrupt_spot(iid)
        elif kind == "rebalance_recommendation":
            env.cloud.send_rebalance_recommendation(iid)
        elif kind == "scheduled_change":
            env.cloud.send_scheduled_change(iid)
        else:
            env.cloud.send_state_change(iid, "stopping")
        env.settle()
        return (claim.name in claim_names(env), env.unavailable.is_unavailable(
            "spot", inst.instance_type, inst.zone), len(
                env.cloud.interruption_queue))
    env, (kept, unavailable, queued) = both(scenario)
    assert queued == 0 and kept == (kind == "rebalance_recommendation")
    assert unavailable == (kind == "spot_interruption")
    assert all(p.scheduled for p in env.cluster.pods.list())


def test_preemption_executes_and_blocks_plans():
    """A stamped plan evicts its victims back to Pending; a plan with a
    do-not-disrupt victim evicts none."""
    def scenario(ns, env):
        provision(ns, env, n=4)
        wk = ns.M.wellknown
        pods = sorted(env.cluster.pods.list(), key=lambda p: p.meta.name)
        for p in pods[:2]:
            p.meta.annotations[wk.PREEMPT_PLAN_ANNOTATION] = "plan-a"
            p.meta.annotations[wk.PREEMPT_FOR_ANNOTATION] = "hi"
        for p in pods[2:]:
            p.meta.annotations[wk.PREEMPT_PLAN_ANNOTATION] = "plan-b"
            p.meta.annotations[wk.PREEMPT_FOR_ANNOTATION] = "hi"
        pods[3].meta.annotations[wk.DO_NOT_DISRUPT_ANNOTATION] = "true"
        env.preemption.reconcile()
        return [(p.meta.name, p.node_name is None, p.phase) for p in pods]
    env, pods = both(scenario)
    assert [evicted for _, evicted, _ in pods] == [True, True, False, False]
    assert {"Preempted", "PreemptionBlocked"} <= reasons(env)


# -- nodeclass, tagging, refresh ----------------------------------------------
def test_nodeclass_hash_and_status():
    def scenario(ns, env):
        env.settle()
        nc = env.cluster.nodeclasses.get("default")
        wk = ns.M.wellknown
        stamped = nc.meta.annotations[wk.NODECLASS_HASH_ANNOTATION]
        nc.role = "new-role"
        env.manager.run_once()
        return (stamped, nc.meta.annotations[wk.NODECLASS_HASH_ANNOTATION],
                nc.static_hash(), nc.discovered_subnets,
                nc.discovered_security_groups, sorted(nc.discovered_images),
                sorted(nc.discovered_zones), nc.instance_profile,
                sorted(nc.status_conditions.items()), nc.meta.finalizers)
    env, obs = both(scenario)
    assert obs[1] == obs[2] != obs[0]
    assert obs[4] == ["sg-cluster"] and "img-cos-v121" in obs[5]


def test_nodeclass_not_ready_then_recovers():
    def scenario(ns, env):
        nc = ns.objects.NodeClass(meta=ns.M.ObjectMeta(name="late"),
                                  image_family="custom")
        env.cluster.nodeclasses.create(nc)
        env.settle()
        before = nc.ready
        nc.image_family = "cos"
        env.clock.step(120)
        env.settle()
        return before, nc.ready
    env, obs = both(scenario)
    assert obs == (False, True) and "NotReady" in reasons(env)


def test_nodeclass_termination():
    def scenario(ns, env):
        env.cluster.pods.create(mkpod(ns, "p"))
        env.settle()
        env.cluster.nodeclasses.delete("default")
        env.manager.run_once()
        blocked = env.cluster.nodeclasses.get("default") is not None
        profile = env.cluster.nodeclasses.get("default").instance_profile
        for p in env.cluster.pods.list():
            p.meta.finalizers.clear()
            env.cluster.pods.delete(p.meta.name)
        for c in env.cluster.nodeclaims.list():
            env.cluster.nodeclaims.delete(c.name)
        env.settle()
        return (blocked, env.cluster.nodeclasses.get("default") is None,
                len(env.cloud.list_launch_templates(
                    tag_filter={"karpenter.tpu/nodeclass": "default"})),
                profile in env.cloud.instance_profiles)
    env, obs = both(scenario)
    assert obs == (True, True, 0, False)
    assert "TerminationBlocked" in reasons(env)


def test_tagging_and_refresh():
    def scenario(ns, env):
        env.cluster.pods.create(mkpod(ns, "p"))
        env.settle()
        claim = env.cluster.nodeclaims.list()[0]
        tags = dict(env.cloud.get_instance(claim.provider_id).tags)
        nc = env.cluster.nodeclasses.get("default")
        first = env.instance_types.list(nc)
        seq = env.pricing.seqnum
        for it in env.cloud._catalog:
            for o in it.offerings:
                o.price *= 2
        env.clock.step(400)
        env.manager.run_once()
        return (tags.get("Name") == claim.node_name,
                tags.get("karpenter.tpu/managed-by"),
                env.pricing.seqnum > seq,
                env.instance_types.list(nc) is not first)
    env, obs = both(scenario)
    assert obs == (True, "default-cluster", True, True)
