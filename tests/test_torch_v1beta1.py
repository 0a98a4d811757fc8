"""The port's v1beta1 → v1 conversion (`models/v1beta1.py`) and
transcribed EC2 catalog (`providers/ec2_catalog.py`) against the JAX
package's.

- The cases of `tests/test_v1beta1.py` on both packages (the port's
  Environment on the CPU), the converted objects equal field by field
  between the packages, and the admitted v1beta1 manifests settling to
  the JAX package's answer.
- `transcribe_catalog` equal to the JAX package's type by type, and
  `dump_catalog(transcribe_catalog())` serialised as `hack/gen_catalog.py`
  serialises it: the bytes of the port's
  `providers/generated/catalog_default.json` (`tests/test_codegen.py`).
"""

import dataclasses
import importlib
import json
from types import SimpleNamespace

import pytest
import torch

from karpenter_tpu_torch import workloads


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, M=imp("models"), O=imp("models.objects"),
        V=imp("models.v1beta1"), env=imp("env"), cat=imp(
            "providers.catalog"), ec2=imp("providers.ec2_catalog"),
        Options=imp("operator.options").Options)


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")
PKGS = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True)
def _port_faults_disarmed():
    """tests/conftest.py disarms the JAX package's fault registry around
    every test; the port keeps its own, disarmed here the same way."""
    from karpenter_tpu_torch.utils import faults
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scans on one intra-op thread (beside JAX in one process
    torch's default threads are ~15x slower); restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=sorted(PKGS))
def ns(request):
    return PKGS[request.param]


def mkenv(ns):
    kw = {"device": "cpu"} if ns is PORT else {}
    return ns.env.Environment(options=ns.Options(batch_idle_duration=0),
                              **kw)


def _fields(obj):
    """An object as plain data, its class names kept: equal between the
    packages when every field is (but `uid`, a per-process counter)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, tuple(
            (f.name, _fields(getattr(obj, f.name)))
            for f in dataclasses.fields(obj) if f.name != "uid"))
    if isinstance(obj, dict):
        return tuple(sorted((k, _fields(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_fields(v) for v in obj)
    if hasattr(obj, "v") and type(obj).__name__ == "Resources":
        return ("Resources", tuple(obj.v))
    if type(obj).__name__ == "Requirements":
        return ("Requirements", repr(obj))
    return obj


# -- tests/test_v1beta1.py, on both packages ----------------------------------
def test_expire_after_moves_and_policy_renames(ns):
    O, V = ns.O, ns.V
    b = V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="old"),
        disruption=V.V1Beta1Disruption(
            consolidation_policy=O.CONSOLIDATE_WHEN_UNDERUTILIZED,
            consolidate_after=120.0,
            expire_after=3600.0,
            budgets=[O.Budget(nodes="20%")]),
        weight=5)
    v1 = V.nodepool_to_v1(b)
    assert v1.expire_after == 3600.0  # disruption → template-level
    assert (v1.disruption.consolidation_policy
            == O.CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED)
    assert v1.disruption.consolidate_after == 120.0
    assert v1.weight == 5
    # round trip is lossless
    back = V.nodepool_from_v1(v1)
    assert back.disruption.expire_after == 3600.0
    assert (back.disruption.consolidation_policy
            == O.CONSOLIDATE_WHEN_UNDERUTILIZED)
    assert back.disruption.budgets[0].nodes == "20%"


def test_kubelet_rides_compat_annotation(ns):
    O, V = ns.O, ns.V
    b = V.V1Beta1NodePool(meta=O.ObjectMeta(name="k"),
                          kubelet=O.KubeletConfiguration(max_pods=42))
    v1 = V.nodepool_to_v1(b)
    assert V.KUBELET_COMPAT_ANNOTATION in v1.meta.annotations


def test_ami_spellings_and_metadata_default(ns):
    O, V = ns.O, ns.V
    b = V.V1Beta1NodeClass(
        meta=O.ObjectMeta(name="old"),
        ami_family="ubuntu",
        ami_selector_terms=[O.SelectorTerm(tags={"team": "ml"})],
        metadata_http_tokens="optional")
    v1 = V.nodeclass_to_v1(b)
    assert v1.image_family == "ubuntu"
    assert v1.image_selector_terms[0].tags == {"team": "ml"}
    # the old optional-tokens behaviour is pinned explicitly
    assert v1.metadata_options.http_tokens == "optional"
    back = V.nodeclass_from_v1(v1)
    assert back.ami_family == "ubuntu"
    assert back.metadata_http_tokens == "optional"


def test_kubelet_attaches_at_conversion(ns):
    O, V = ns.O, ns.V
    b = V.V1Beta1NodeClass(meta=O.ObjectMeta(name="k"))
    v1 = V.nodeclass_to_v1(b, kubelet=O.KubeletConfiguration(max_pods=9))
    assert v1.kubelet.max_pods == 9


def test_v1_objects_pass_through(ns):
    env = mkenv(ns)
    env.add_default_nodeclass()
    ns.V.admit(env.cluster, ns.O.NodePool(meta=ns.O.ObjectMeta(name="plain")))
    assert env.cluster.nodepools.get("plain") is not None


def test_meta_annotations_preserved_and_unaliased(ns):
    O, V = ns.O, ns.V
    b = V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="m", annotations={"owner": "ml-team"}),
        annotations={"tmpl": "1"},
        kubelet=O.KubeletConfiguration(max_pods=5))
    v1 = V.nodepool_to_v1(b)
    assert v1.meta.annotations["owner"] == "ml-team"
    assert v1.annotations == {"tmpl": "1"}
    assert v1.meta.annotations is not v1.annotations
    v1.annotations["x"] = "y"
    assert "x" not in v1.meta.annotations


def test_kubelet_round_trip_is_lossless(ns):
    O, V = ns.O, ns.V
    kub = O.KubeletConfiguration(
        max_pods=5, pods_per_core=2,
        kube_reserved={"cpu": "100m"},
        eviction_hard={"memory.available": "5%"})
    b = V.V1Beta1NodePool(meta=O.ObjectMeta(name="rt"), kubelet=kub)
    back = V.nodepool_from_v1(V.nodepool_to_v1(b))
    assert back.kubelet == kub
    assert V.KUBELET_COMPAT_ANNOTATION not in back.meta.annotations


def test_pool_before_class_admission_order(ns):
    O, V = ns.O, ns.V
    env = mkenv(ns)
    V.admit(env.cluster, V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="default"),
        kubelet=O.KubeletConfiguration(max_pods=7)))
    V.admit(env.cluster, V.V1Beta1NodeClass(meta=O.ObjectMeta(name="default")))
    nc = env.cluster.nodeclasses.get("default")
    assert nc.kubelet is not None and nc.kubelet.max_pods == 7


def test_explicit_v1_kubelet_wins(ns):
    O, V = ns.O, ns.V
    env = mkenv(ns)
    nc = env.add_default_nodeclass()
    nc.kubelet = O.KubeletConfiguration(max_pods=99)
    env.cluster.nodeclasses.update(nc)
    V.admit(env.cluster, V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="default"),
        kubelet=O.KubeletConfiguration(max_pods=7)))
    assert env.cluster.nodeclasses.get("default").kubelet.max_pods == 99


def test_annotated_v1_pool_attaches_after_class(ns):
    O, V = ns.O, ns.V
    env = mkenv(ns)
    V.admit(env.cluster, V.V1Beta1NodeClass(meta=O.ObjectMeta(name="default")))
    v1pool = V.nodepool_to_v1(V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="default"),
        kubelet=O.KubeletConfiguration(max_pods=7)))
    V.admit(env.cluster, v1pool)
    assert env.cluster.nodeclasses.get("default").kubelet.max_pods == 7


def test_divergent_pool_kubelets_raise_conflict_event(ns):
    O, V = ns.O, ns.V
    env = mkenv(ns)
    V.admit(env.cluster, V.V1Beta1NodeClass(meta=O.ObjectMeta(name="default")))
    V.admit(env.cluster, V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="a"),
        kubelet=O.KubeletConfiguration(max_pods=10)))
    V.admit(env.cluster, V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="b"),
        kubelet=O.KubeletConfiguration(max_pods=200)))
    assert env.cluster.nodeclasses.get("default").kubelet.max_pods == 10
    reasons = {r for _, _, _, r, _ in env.cluster.events}
    assert "KubeletConversionConflict" in reasons


# -- held against the JAX package ------------------------------------------------
def _conversions(ns):
    O, V = ns.O, ns.V
    kub = O.KubeletConfiguration(max_pods=5, pods_per_core=2,
                                 kube_reserved={"cpu": "100m"})
    pool = V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="p", annotations={"owner": "ml"}),
        disruption=V.V1Beta1Disruption(
            consolidation_policy=O.CONSOLIDATE_WHEN_UNDERUTILIZED,
            consolidate_after=60.0, expire_after=7200.0,
            budgets=[O.Budget(nodes="10%")]),
        kubelet=kub, weight=3, annotations={"t": "1"})
    cls = V.V1Beta1NodeClass(
        meta=O.ObjectMeta(name="c"), ami_family="ubuntu",
        ami_selector_terms=[O.SelectorTerm(tags={"team": "ml"})],
        metadata_http_tokens="optional")
    v1pool, v1cls = V.nodepool_to_v1(pool), V.nodeclass_to_v1(cls, kubelet=kub)
    return [_fields(x) for x in (
        v1pool, V.nodepool_from_v1(v1pool), v1cls, V.nodeclass_from_v1(v1cls))]


def test_conversions_equal_the_reference():
    assert _conversions(PORT) == _conversions(JAX)


def _admitted(ns):
    """Pre-v1 manifests admitted and settled (the end-to-end case of
    tests/test_v1beta1.py): the loop's answer and the converted class."""
    O, V = ns.O, ns.V
    env = mkenv(ns)
    V.admit(env.cluster, V.V1Beta1NodeClass(meta=O.ObjectMeta(name="default")))
    V.admit(env.cluster, V.V1Beta1NodePool(
        meta=O.ObjectMeta(name="default"),
        kubelet=O.KubeletConfiguration(max_pods=3),
        disruption=V.V1Beta1Disruption(expire_after=86400.0)))
    pool = env.cluster.nodepools.get("default")
    nc = env.cluster.nodeclasses.get("default")
    for i in range(7):
        env.cluster.pods.create(ns.M.Pod(
            meta=O.ObjectMeta(name=f"p{i}"),
            requests=ns.M.Resources.parse({"cpu": "10m", "memory": "16Mi"})))
    rounds = env.settle()
    return (pool.expire_after, nc.kubelet.max_pods,
            len(env.cluster.nodeclaims.list()),
            workloads.loop_answer(env.cluster, env.cloud, rounds))


def test_v1beta1_objects_provision_as_the_reference():
    got, ref = _admitted(PORT), _admitted(JAX)
    assert got == ref
    expire, max_pods, claims, answer = got
    assert (expire, max_pods) == (86400.0, 3)
    # max_pods=3 from the v1beta1 template binds
    assert claims >= 3 and answer["bound"] == 7 and answer["unbound"] == 0


# -- the transcribed catalog ------------------------------------------------------
def _offerings(it):
    return [(o.zone, o.capacity_type, float(o.price).hex(), o.available)
            for o in it.offerings]


def test_transcribed_catalog_equals_the_reference():
    got, ref = PORT.ec2.transcribe_catalog(), JAX.ec2.transcribe_catalog()
    assert len(got) == len(ref) > 600
    for a, b in zip(got, ref):
        assert a.name == b.name
        assert a.capacity.v == b.capacity.v
        assert a.overhead.v == b.overhead.v
        assert repr(a.requirements) == repr(b.requirements)
        assert _offerings(a) == _offerings(b)
    assert PORT.cat.dump_catalog(got) == JAX.cat.dump_catalog(ref)


def test_transcribed_catalog_is_the_generated_table_byte_for_byte():
    """hack/gen_catalog.py's serialisation of the port's transcription is
    the port's checked-in table."""
    table = PORT.cat.dump_catalog(PORT.ec2.transcribe_catalog())
    payload = json.dumps(table, indent=None, sort_keys=True,
                         separators=(",", ":")) + "\n"
    with open(PORT.cat.GENERATED_CATALOG_PATH) as f:
        assert f.read() == payload
    loaded = PORT.cat.load_generated_catalog()
    assert [it.name for it in loaded] == [it.name for it in
                                          PORT.ec2.transcribe_catalog()]
