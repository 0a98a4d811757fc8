"""Synthetic machine catalog.

The reference materializes ~750-800 EC2 instance types from
DescribeInstanceTypes (pkg/providers/instancetype/instancetype.go:184-220)
and ships generated fixture tables for tests
(pkg/fake/zz_generated.describe_instance_types.go). We have no cloud to
describe, so this module *is* the cloud's catalog: a deterministic generator
producing a realistically shaped fleet — families × generations × variants ×
sizes across compute/general/memory/burstable/GPU categories — with
EC2-plausible capacities, overheads, labels, and prices.

Determinism matters: prices and spot discounts are hashed from the type name
so benchmarks and parity tests are reproducible without stored fixtures.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import InstanceType, Offering
from karpenter_tpu_torch.models.requirements import Requirement, Requirements
from karpenter_tpu_torch.models.resources import Resources

DEFAULT_REGION = "tpu-west-1"
DEFAULT_ZONES = ["tpu-west-1a", "tpu-west-1b", "tpu-west-1c"]

# (suffix, vCPUs). Mirrors EC2 size ladder.
_SIZES = [
    ("large", 2), ("xlarge", 4), ("2xlarge", 8), ("4xlarge", 16),
    ("8xlarge", 32), ("12xlarge", 48), ("16xlarge", 64), ("24xlarge", 96),
]
_BIG_SIZES = _SIZES + [("32xlarge", 128), ("48xlarge", 192)]

# category → (GiB memory per vCPU, $/vCPU-hour base)
_CATEGORIES = {
    "c": (2.0, 0.0425),   # compute optimized
    "m": (4.0, 0.048),    # general purpose
    "r": (8.0, 0.063),    # memory optimized
}
_VARIANTS = {
    "": dict(arch="amd64", price_mult=1.00, nvme=False),
    "a": dict(arch="amd64", price_mult=0.90, nvme=False),   # AMD
    "i": dict(arch="amd64", price_mult=1.05, nvme=False),   # premium intel
    "g": dict(arch="arm64", price_mult=0.80, nvme=False),   # ARM
    "gd": dict(arch="arm64", price_mult=0.93, nvme=True),   # ARM + local NVMe
    "d": dict(arch="amd64", price_mult=1.16, nvme=True),    # local NVMe
    "n": dict(arch="amd64", price_mult=1.26, nvme=False),   # network optimized
}
_GENERATIONS = [4, 5, 6, 7]

# GPU families: family → (gpu model, gpus per 8 vCPUs nominal, $/gpu-hour)
_GPU_FAMILIES = {
    "g4": ("t4", [("xlarge", 4, 1), ("2xlarge", 8, 1), ("4xlarge", 16, 1),
                  ("12xlarge", 48, 4), ("16xlarge", 64, 1)], 0.21),
    "g5": ("a10g", [("xlarge", 4, 1), ("2xlarge", 8, 1), ("4xlarge", 16, 1),
                    ("12xlarge", 48, 4), ("24xlarge", 96, 4), ("48xlarge", 192, 8)], 0.40),
    "p3": ("v100", [("2xlarge", 8, 1), ("8xlarge", 32, 4), ("16xlarge", 64, 8)], 2.64),
    "p4": ("a100", [("24xlarge", 96, 8)], 4.10),
}


@dataclass
class CatalogSpec:
    region: str = DEFAULT_REGION
    zones: List[str] = field(default_factory=lambda: list(DEFAULT_ZONES))
    generations: List[int] = field(default_factory=lambda: list(_GENERATIONS))
    include_gpu: bool = True
    include_burstable: bool = True
    # deterministic knob to shrink the catalog for small tests
    max_types: Optional[int] = None


def _det_unit(name: str, salt: str) -> float:
    """Deterministic pseudo-random in [0, 1) from a name."""
    h = hashlib.sha256(f"{name}:{salt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


def _max_pods(vcpus: int) -> int:
    # ENI-style max-pods ladder (role of zz_generated.vpclimits.go)
    if vcpus <= 2:
        return 29
    if vcpus <= 8:
        return 58
    if vcpus <= 16:
        return 110
    if vcpus <= 48:
        return 234
    return 737


def _overhead(vcpus: int, max_pods: int, ephemeral_mib: float) -> Resources:
    """kube-reserved + eviction threshold, shaped like the reference
    (pkg/providers/instancetype/types.go:369-431): CPU reserved on a
    sliding scale of cores, memory 255Mi + 11Mi/pod + 100Mi eviction,
    ephemeral 1Gi kube-reserved + 10% nodefs eviction. The SAME terms as
    providers/instancetype.apply_node_class's defaults, so equivalent
    NodeClass spellings (legacy scalar vs mapping list, kubelet set vs
    unset) yield identical allocatable."""
    cores = vcpus
    cpu_reserved = 0.0  # millicores
    ladder = [(1, 0.06), (1, 0.01), (2, 0.005)]
    remaining = cores
    for n, frac in ladder:
        take = min(remaining, n)
        cpu_reserved += take * 1000 * frac
        remaining -= take
    cpu_reserved += max(remaining, 0) * 1000 * 0.0025
    mem_reserved = 255.0 + 11.0 * max_pods
    eviction = 100.0
    return Resources.of(cpu=cpu_reserved, memory=mem_reserved + eviction,
                        ephemeral_storage=1024.0 + ephemeral_mib * 0.10)


def _bandwidth_mbps(vcpus: int, variant_network_optimized: bool) -> int:
    """Network bandwidth ladder (role of the reference's measured
    zz_generated.bandwidth.go table): ~ linear in vCPUs, network-optimized
    variants ~2x, capped at 100 Gbps, floored at 750 Mbps like the small
    EC2 shapes."""
    per_cpu = 1250 if variant_network_optimized else 600
    return max(750, min(100_000, vcpus * per_cpu))


def _vm_overhead(mem_gib: float) -> float:
    """MiB the hypervisor/OS eats before k8s sees it — the reference's
    vm-memory-overhead-percent, default 7.5%
    (pkg/operator/options/options.go:48).
    """
    return mem_gib * 1024 * 0.075


def _make_type(
    name: str,
    category: str,
    family: str,
    generation: int,
    vcpus: int,
    mem_gib: float,
    arch: str,
    size: str,
    zones: List[str],
    od_price: float,
    nvme: bool = False,
    gpus: int = 0,
    gpu_name: str = "",
    network_optimized: bool = False,
) -> InstanceType:
    mem_mib = mem_gib * 1024 - _vm_overhead(mem_gib)
    max_pods = _max_pods(vcpus)
    ephemeral_gib = 900 if nvme else 100
    capacity = Resources.of(
        cpu=vcpus * 1000.0,
        memory=mem_mib,
        ephemeral_storage=ephemeral_gib * 1024.0,
        pods=float(max_pods),
        gpu=float(gpus),
        # attachable persistent-volume slots (ENI-style ladder, the role
        # of the reference's per-type volume limits — scheduling.md:381+)
        volumes=float(24 if vcpus <= 16 else 40),
    )
    labels = {
        wellknown.INSTANCE_TYPE_LABEL: name,
        wellknown.ARCH_LABEL: arch,
        wellknown.OS_LABEL: wellknown.OS_LINUX,
        wellknown.INSTANCE_CATEGORY_LABEL: category,
        wellknown.INSTANCE_FAMILY_LABEL: family,
        wellknown.INSTANCE_GENERATION_LABEL: str(generation),
        wellknown.INSTANCE_SIZE_LABEL: size,
        wellknown.INSTANCE_CPU_LABEL: str(vcpus),
        wellknown.INSTANCE_MEMORY_LABEL: str(int(mem_gib * 1024)),
        wellknown.INSTANCE_LOCAL_NVME_LABEL: str(ephemeral_gib) if nvme else "0",
        wellknown.INSTANCE_NETWORK_BANDWIDTH_LABEL:
            str(_bandwidth_mbps(vcpus, network_optimized)),
    }
    if gpus:
        labels[wellknown.INSTANCE_GPU_COUNT_LABEL] = str(gpus)
        labels[wellknown.INSTANCE_GPU_NAME_LABEL] = gpu_name
    reqs = Requirements(
        *(Requirement.single(k, v) for k, v in labels.items())
    )
    offerings: List[Offering] = []
    for zone in zones:
        # zonal on-demand price wiggle ±2%
        z_od = od_price * (0.98 + 0.04 * _det_unit(name, zone))
        offerings.append(Offering(zone, wellknown.CAPACITY_TYPE_ON_DEMAND,
                                  round(z_od, 5)))
        # spot discount 55-75% off, varies by (type, zone)
        spot = z_od * (0.25 + 0.20 * _det_unit(name, zone + ":spot"))
        offerings.append(Offering(zone, wellknown.CAPACITY_TYPE_SPOT,
                                  round(spot, 5)))
    # zone requirement = union of offering zones; capacity-type likewise
    reqs.add(Requirement.make(wellknown.ZONE_LABEL, "In", *zones))
    reqs.add(Requirement.make(
        wellknown.CAPACITY_TYPE_LABEL, "In",
        wellknown.CAPACITY_TYPE_SPOT, wellknown.CAPACITY_TYPE_ON_DEMAND))
    return InstanceType(
        name=name,
        capacity=capacity,
        requirements=reqs,
        offerings=offerings,
        overhead=_overhead(vcpus, max_pods, ephemeral_gib * 1024.0),
    )


def generate_catalog(spec: Optional[CatalogSpec] = None) -> List[InstanceType]:
    """The catalog for a spec. The DEFAULT catalog loads from the
    checked-in generated table (hack/gen_catalog.py — the codegen
    pipeline, role of `make codegen` + zz_generated tables,
    the reference Makefile codegen target); the synthesis formulas below are
    the GENERATOR's internals and serve non-default specs (tests that
    shrink/reshape the fleet)."""
    if spec is None or spec == CatalogSpec():
        loaded = load_generated_catalog()
        if loaded is not None:
            return loaded
    return synthesize_catalog(spec)


def synthesize_catalog(spec: Optional[CatalogSpec] = None) -> List[InstanceType]:
    spec = spec or CatalogSpec()
    out: List[InstanceType] = []

    for category, (gib_per_cpu, cpu_price) in _CATEGORIES.items():
        for gen in spec.generations:
            for variant, vinfo in _VARIANTS.items():
                if vinfo["arch"] == "arm64" and gen < 6:
                    continue  # ARM starts at gen 6, like graviton2
                family = f"{category}{gen}{variant}"
                sizes = _BIG_SIZES if gen >= 6 else _SIZES
                for size, vcpus in sizes:
                    mem_gib = vcpus * gib_per_cpu
                    # newer generations are slightly cheaper per vCPU
                    gen_mult = {4: 1.06, 5: 1.0, 6: 0.98, 7: 1.02}.get(gen, 1.0)
                    price = vcpus * cpu_price * vinfo["price_mult"] * gen_mult
                    out.append(_make_type(
                        name=f"{family}.{size}", category=category,
                        family=family, generation=gen, vcpus=vcpus,
                        mem_gib=mem_gib, arch=vinfo["arch"], size=size,
                        zones=spec.zones, od_price=price, nvme=vinfo["nvme"],
                        network_optimized=(variant == "n"),
                    ))

    if spec.include_burstable:
        for gen in spec.generations:
            family = f"t{gen}"
            for size, vcpus, mem_gib in [
                ("micro", 2, 1.0), ("small", 2, 2.0), ("medium", 2, 4.0),
                ("large", 2, 8.0), ("xlarge", 4, 16.0), ("2xlarge", 8, 32.0),
            ]:
                price = 0.0135 * mem_gib  # burstable pricing tracks memory
                out.append(_make_type(
                    name=f"{family}.{size}", category="t", family=family,
                    generation=gen, vcpus=vcpus, mem_gib=mem_gib,
                    arch="amd64", size=size, zones=spec.zones,
                    od_price=max(price, 0.008),
                ))

    if spec.include_gpu:
        for family, (gpu_name, shapes, gpu_price) in _GPU_FAMILIES.items():
            gen = int(family[1])
            category = family[0]
            for size, vcpus, gpus in shapes:
                mem_gib = vcpus * 4.0
                price = vcpus * 0.05 + gpus * gpu_price
                out.append(_make_type(
                    name=f"{family}.{size}", category=category, family=family,
                    generation=gen, vcpus=vcpus, mem_gib=mem_gib,
                    arch="amd64", size=size, zones=spec.zones,
                    od_price=price, gpus=gpus, gpu_name=gpu_name,
                ))

    out.sort(key=lambda it: it.name)
    if spec.max_types is not None:
        out = out[: spec.max_types]
    return out


def catalog_by_name(catalog: List[InstanceType]) -> Dict[str, InstanceType]:
    return {it.name: it for it in catalog}


# ---------------------------------------------------------------------------
# Generated-table plumbing (the codegen pipeline's data side). The table is
# written by hack/gen_catalog.py and checked in, replacing formula-only
# synthesis for the default catalog — the role of the reference's
# zz_generated.{vpclimits,bandwidth,pricing}.go regenerated by hack/code/
# (the reference Makefile codegen target).
# ---------------------------------------------------------------------------

GENERATED_CATALOG_PATH = __import__("os").path.join(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__)),
    "generated", "catalog_default.json")
_loaded_catalog: Optional[List[InstanceType]] = None
_loaded_failed = False


def dump_catalog(catalog: List[InstanceType]) -> dict:
    """Serializable table: per type — capacity/overhead vectors (solver
    units), the single-valued labels (incl. the max-pods and bandwidth
    ladders' outputs), and per-offering prices."""
    types = []
    for it in catalog:
        labels = {}
        for req in it.requirements:
            if req.is_finite() and len(req.values()) == 1:
                (labels[req.key],) = req.values()
        types.append({
            "name": it.name,
            "capacity": it.capacity.to_dict_solver(),
            "overhead": it.overhead.to_dict_solver(),
            "labels": labels,
            "offerings": [[o.zone, o.capacity_type, o.price, o.available]
                          for o in it.offerings],
        })
    return {"version": 1, "types": types}


def catalog_from_table(table: dict) -> List[InstanceType]:
    from karpenter_tpu_torch.models.resources import AXIS_INDEX
    out = []
    for rec in table["types"]:
        cap = Resources()
        for k, v in rec["capacity"].items():
            cap.v[AXIS_INDEX[k]] = float(v)
        ovh = Resources()
        for k, v in rec["overhead"].items():
            ovh.v[AXIS_INDEX[k]] = float(v)
        reqs = Requirements(*(Requirement.single(k, v)
                              for k, v in rec["labels"].items()))
        zones = sorted({o[0] for o in rec["offerings"]})
        cts = sorted({o[1] for o in rec["offerings"]})
        reqs.add(Requirement.make(wellknown.ZONE_LABEL, "In", *zones))
        reqs.add(Requirement.make(wellknown.CAPACITY_TYPE_LABEL, "In", *cts))
        out.append(InstanceType(
            name=rec["name"], capacity=cap, requirements=reqs,
            offerings=[Offering(z, ct, price, avail)
                       for z, ct, price, avail in rec["offerings"]],
            overhead=ovh))
    return out


def load_generated_catalog(path: Optional[str] = None) -> Optional[List[InstanceType]]:
    """The checked-in default catalog, memoized (None when the table is
    absent — synthesis then serves the default too, so a fresh checkout
    without generated data still works)."""
    global _loaded_catalog, _loaded_failed
    if path is None:
        if _loaded_catalog is not None:
            return _loaded_catalog
        if _loaded_failed:
            return None
        path = GENERATED_CATALOG_PATH
    import json
    import os
    if not os.path.exists(path):
        _loaded_failed = True
        return None
    with open(path) as f:
        table = json.load(f)
    cat = catalog_from_table(table)
    if path == GENERATED_CATALOG_PATH:
        _loaded_catalog = cat
    return cat
