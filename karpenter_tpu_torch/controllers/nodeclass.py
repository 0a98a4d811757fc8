"""NodeClass controllers — hash, status (discovery → readiness), termination.

Mirrors pkg/controllers/nodeclass:
  hash        stamps the nodeclass-hash annotation used for drift detection,
              with hash-version migration (hash/controller.go:48-128)
  status      reconciles discovered subnets / security groups / images and
              the instance profile into NodeClass.status and derives the
              Ready condition — Create() refuses non-Ready nodeclasses
              (status/{controller,subnet,securitygroup,ami,instanceprofile,
              readiness}.go; pkg/cloudprovider/cloudprovider.go:99-102)
  termination finalizer: on NodeClass delete, blocks while NodeClaims still
              reference it, then deletes instance profiles + launch
              templates and strips the finalizer
              (termination/controller.go:137)
"""

from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import NodeClass
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

NODECLASS_FINALIZER = "karpenter.tpu/termination"
HASH_VERSION = "v1"

COND_SUBNETS_READY = "SubnetsReady"
COND_SECURITY_GROUPS_READY = "SecurityGroupsReady"
COND_IMAGES_READY = "ImagesReady"
COND_INSTANCE_PROFILE_READY = "InstanceProfileReady"
COND_READY = "Ready"


class NodeClassHash:
    name = "nodeclass-hash"

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self) -> None:
        for nc in self.cluster.nodeclasses.list():
            if nc.meta.deleting:
                continue
            want = nc.static_hash()
            ann = nc.meta.annotations
            changed = False
            # hash-version migration: when the hash algorithm version bumps,
            # re-stamp instead of reporting spurious drift
            # (hash/controller.go:48-128)
            if ann.get(wellknown.NODECLASS_HASH_VERSION_ANNOTATION) \
                    != HASH_VERSION:
                ann[wellknown.NODECLASS_HASH_VERSION_ANNOTATION] = HASH_VERSION
                changed = True
            if ann.get(wellknown.NODECLASS_HASH_ANNOTATION) != want:
                ann[wellknown.NODECLASS_HASH_ANNOTATION] = want
                changed = True
            if changed:
                self.cluster.nodeclasses.update(nc)


class NodeClassStatus:
    name = "nodeclass-status"

    def __init__(self, cluster: Cluster, subnets, security_groups, images,
                 instance_profiles):
        self.cluster = cluster
        self.subnets = subnets
        self.security_groups = security_groups
        self.images = images
        self.instance_profiles = instance_profiles

    def reconcile(self) -> None:
        for nc in self.cluster.nodeclasses.list():
            if nc.meta.deleting:
                continue
            self._reconcile_one(nc)

    def _reconcile_one(self, nc: NodeClass) -> None:
        subnets = self._safe(lambda: self.subnets.list(nc)) or []
        sgs = self._safe(lambda: self.security_groups.list(nc)) or []
        images = self._safe(lambda: self.images.list(nc)) or []
        profile = self._safe(lambda: self.instance_profiles.create(nc)) or ""

        conds = {
            COND_SUBNETS_READY: bool(subnets),
            COND_SECURITY_GROUPS_READY: bool(sgs),
            COND_IMAGES_READY: bool(images),
            COND_INSTANCE_PROFILE_READY: bool(profile),
        }
        conds[COND_READY] = all(conds.values())

        status = (
            sorted(s.subnet_id for s in subnets),
            sorted(g.group_id for g in sgs),
            [i.image_id for i in images],
            sorted({s.zone for s in subnets}),
            profile,
            conds,
        )
        current = (nc.discovered_subnets, nc.discovered_security_groups,
                   nc.discovered_images, nc.discovered_zones,
                   nc.instance_profile, nc.status_conditions)
        if status == current and nc.ready == conds[COND_READY] \
                and NODECLASS_FINALIZER in nc.meta.finalizers:
            return
        was_ready = nc.ready
        (nc.discovered_subnets, nc.discovered_security_groups,
         nc.discovered_images, nc.discovered_zones,
         nc.instance_profile, nc.status_conditions) = status
        nc.ready = conds[COND_READY]
        if NODECLASS_FINALIZER not in nc.meta.finalizers:
            nc.meta.finalizers.append(NODECLASS_FINALIZER)
        if nc.ready != was_ready:
            self.cluster.record_event(
                "NodeClass", nc.name,
                "Ready" if nc.ready else "NotReady",
                ", ".join(k for k, v in conds.items() if not v))
        self.cluster.nodeclasses.update(nc)

    def _safe(self, fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — discovery failure ⇒ not
            # ready; recorded, not silent: a
            # nodeclass stuck NotReady must be attributable to the
            # discovery call that keeps failing
            get_logger(self.name).warn(
                "nodeclass discovery call failed", error=str(e)[:200])
            metrics.RECONCILE_ERRORS.inc(controller=self.name)
            return None


class NodeClassTermination:
    name = "nodeclass-termination"

    def __init__(self, cluster: Cluster, launch_templates, instance_profiles,
                 instance_types=None):
        self.cluster = cluster
        self.launch_templates = launch_templates
        self.instance_profiles = instance_profiles
        self.instance_types = instance_types

    def reconcile(self) -> None:
        for nc in self.cluster.nodeclasses.list():
            if not nc.meta.deleting:
                continue
            # block while NodeClaims still reference this nodeclass — their
            # instances depend on its launch config
            refs = self.cluster.nodeclaims.list(
                lambda c: c.node_class_ref == nc.name)
            if refs:
                self.cluster.record_event(
                    "NodeClass", nc.name, "TerminationBlocked",
                    f"{len(refs)} nodeclaims still reference it")
                continue
            self.launch_templates.delete_all(nc)
            self.instance_profiles.delete(nc)
            if self.instance_types is not None:
                # drop the view's catalog gauge series (series another
                # nodeclass still exports survive)
                self.instance_types.forget(nc.name)
            self.cluster.record_event("NodeClass", nc.name, "Terminated", "")
            self.cluster.nodeclasses.remove_finalizer(
                nc.name, NODECLASS_FINALIZER)
