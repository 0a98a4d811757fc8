"""The port's `env.Environment` against the JAX package's.

Construction on the card by default (with no card a settle raises the
"pass device='cpu'" error), a settle on the CPU that gives the JAX
package's answer, the reference's controller order, the external store
variables that wait for slice 5c, and the cloud plumbing providers that
now reach `TPUCloudProvider` — each provider scenario of
`tests/test_plumbing_providers.py` run on both packages.
"""

import pytest
import torch

from karpenter_tpu_torch import workloads
from tests.test_torch_disruption import JAX, PORT, mkenv, mkpod, trace


def test_environment_without_a_card_raises(monkeypatch):
    from karpenter_tpu_torch.env import Environment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = Environment(options=PORT.Options(batch_idle_duration=0))
    assert env.solver.tpu.device.type == "cuda"
    env.add_default_nodeclass()
    env.cluster.nodepools.create(
        PORT.M.NodePool(meta=PORT.M.ObjectMeta(name="default")))
    env.cluster.pods.create(mkpod(PORT, "p"))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        env.settle()


def test_environment_on_the_cpu_settles_as_the_reference():
    out = {}
    for ns in (JAX, PORT):
        env = mkenv(ns)
        for i in range(12):
            env.cluster.pods.create(mkpod(ns, f"p{i}", cpu=f"{i + 1}"))
        rounds = env.settle()
        out[ns.root] = (workloads.loop_answer(env.cluster, env.cloud, rounds),
                        trace(env))
    assert out[PORT.root] == out[JAX.root]
    assert out[PORT.root][0]["bound"] == 12


def test_controller_order_is_the_reference():
    envs = [mkenv(ns, pool=False) for ns in (JAX, PORT)]
    names = [[(c.name, type(c).__name__) for c in e.manager.controllers]
             for e in envs]
    assert names[0] == names[1] and len(names[1]) == 16
    port = envs[1]
    assert port.manager.controllers[4] is port.provisioner
    assert port.manager.controllers[12] is port.disruption
    # one GatedSolver behind both hot paths
    assert port.disruption.solver is port.provisioner.solver is port.solver


@pytest.mark.parametrize("kind", ["remote", "http"])
def test_external_stores_wait_for_slice_5c(kind, monkeypatch):
    from karpenter_tpu_torch.env import Environment
    monkeypatch.setenv("KARPENTER_TPU_STORE_BACKEND", kind)
    with pytest.raises(NotImplementedError, match="slice 5c"):
        Environment(device="cpu")
    # an explicit backend takes precedence over the variable
    from karpenter_tpu_torch.store import InMemoryBackend
    backend = InMemoryBackend()
    assert Environment(device="cpu",
                       store_backend=backend).store_backend is backend


def test_plumbing_providers_reach_the_cloud_provider():
    env = mkenv(PORT)
    inner = env.cloud_provider._inner
    assert inner.subnets is env.subnets
    assert inner.launch_templates is env.launch_templates
    assert inner.security_groups is env.security_groups
    assert inner.images is env.images
    env.cluster.pods.create(mkpod(PORT, "p0"))
    env.settle()
    claim = env.cluster.nodeclaims.list()[0]
    inst = env.cloud.get_instance(claim.provider_id)
    assert inst.subnet_id == f"subnet-{inst.zone}"
    assert inst.image_id == "img-cos-v121"
    assert inst.security_group_ids == ["sg-cluster"]
    assert env.subnets._inflight.get(inst.subnet_id) == 1
    assert env.cloud.launch_templates


# -- tests/test_plumbing_providers.py's provider scenarios on both packages --
def _subnets(ns, env):
    nc = env.cluster.nodeclasses.get("default")
    zone = env.cloud.zones[0]
    picky = ns.objects.NodeClass(meta=ns.M.ObjectMeta(name="picky"),
                                 subnet_selector_terms=[
                                     ns.objects.SelectorTerm(
                                         id=f"subnet-{zone}")])
    by_id = [s.subnet_id for s in env.subnets.list(picky)]
    sid = f"subnet-{zone}"
    env.cloud.subnets["subnet-extra"] = ns.fake_cloud.Subnet(
        subnet_id="subnet-extra", zone=zone,
        available_ips=env.cloud.subnets[sid].available_ips + 1,
        tags={"karpenter.sh/discovery": "default-cluster"})
    first = env.subnets.zonal_subnets_for_launch(nc)[zone].subnet_id
    env.subnets.update_inflight_ips("subnet-extra", 2)
    after = env.subnets.zonal_subnets_for_launch(nc)[zone].subnet_id
    found = sorted(s.subnet_id for s in env.subnets.list(nc))
    return found, by_id, first, after


def _security_groups(ns, env):
    nc = env.cluster.nodeclasses.get("default")
    named = ns.objects.NodeClass(
        meta=ns.M.ObjectMeta(name="named"),
        security_group_selector_terms=[
            ns.objects.SelectorTerm(name="cluster-default")])
    none = ns.objects.NodeClass(
        meta=ns.M.ObjectMeta(name="none"),
        security_group_selector_terms=[ns.objects.SelectorTerm(
            id="sg-nope")])
    return [[g.group_id for g in env.security_groups.list(c)]
            for c in (nc, named, none)]


def _launch_templates(ns, env):
    nc = env.cluster.nodeclasses.get("default")
    types = env.instance_types.list(nc)[:5]
    first = env.launch_templates.ensure_all(nc, types)
    calls = len(env.cloud.api_calls)
    second = env.launch_templates.ensure_all(nc, types)
    creates = [c[0] for c in env.cloud.api_calls[calls:]
               if c[0] == "CreateLaunchTemplate"]
    lts = env.cloud.list_launch_templates()
    shape = sorted((lt.security_group_ids, "kubelet --bootstrap" in
                    lt.user_data) for lt in lts)
    env.clock.step(700)
    env.launch_templates.sweep()
    return sorted(first) == sorted(second), creates, shape, len(
        env.cloud.launch_templates)


def _instance_profiles_and_versions(ns, env):
    nc = env.cluster.nodeclasses.get("default")
    name = env.instance_profiles.create(nc)
    again = env.instance_profiles.create(nc)
    other = ns.objects.NodeClass(meta=ns.M.ObjectMeta(name="other"),
                                 role="other-role")
    deleted = env.instance_profiles.delete(nc)
    v = [env.versions.get()]
    env.cloud.cluster_version = "1.31"
    v.append(env.versions.get())
    env.clock.step(1000)
    v.append(env.versions.get())
    return (name == again, env.instance_profiles.profile_name(other) != name,
            deleted, env.instance_profiles.get(nc), v)


def _queue(ns, env):
    q = env.queue
    q.send({"kind": "state_change", "instance_id": "i-1",
            "state": "stopping"})
    got = q.receive()
    for m in got:
        q.delete(m)
    return got, q.receive()


@pytest.mark.parametrize("scenario", [_subnets, _security_groups,
                                      _launch_templates,
                                      _instance_profiles_and_versions,
                                      _queue],
                         ids=lambda f: f.__name__.strip("_"))
def test_provider_matches_reference(scenario):
    ref = scenario(JAX, mkenv(JAX))
    got = scenario(PORT, mkenv(PORT))
    assert got == ref
    if scenario is _subnets:
        assert got[2] == "subnet-extra" and got[3] != "subnet-extra"
    elif scenario is _security_groups:
        assert got == [["sg-cluster"], ["sg-cluster"], []]
    elif scenario is _launch_templates:
        assert got[0] and got[1] == [] and got[3] == 0
    elif scenario is _instance_profiles_and_versions:
        assert got[:4] == (True, True, True, None)
        assert got[4] == ["1.30", "1.30", "1.31"]
