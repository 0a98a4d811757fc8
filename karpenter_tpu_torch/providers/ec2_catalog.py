"""Transcribed real-machine catalog — the measured-data side of the
codegen pipeline.

The reference ships MEASURED per-type data: ENI/IP limits
(pkg/providers/instancetype/zz_generated.vpclimits.go),
network bandwidth (zz_generated.bandwidth.go) and prices
(pkg/providers/pricing/zz_generated.pricing_aws.go).  The synthesis
formulas in catalog.py produce a smooth fleet that never exhibits the
lumpy, adversarial structure of the real one — metal types with huge
max-pods, max-pods ladders that go DOWN with size (g4dn.16xlarge:58 vs
g4dn.12xlarge:234), price inversions within a family (g5.16xlarge
$4.096/h < g5.12xlarge $5.672/h), odd memory ratios (p3: 61/244/488 GiB,
x1e: 30.5 GiB/vCPU), sparse zonal offerings and missing spot pools.

This module transcribes public EC2 machine shapes: per-family size
ladders with real vCPU/memory, the real ENI formula
``max_pods = eni_count × (ipv4_per_eni − 1) + 2`` with per-size ENI/IP
limits, per-size baseline bandwidth ladders, and on-demand prices that
are linear in vCPU within a family (as the real price sheet is) anchored
at well-known us-east-1-class bases.  Values are transcribed from public
spec sheets (approximate where noted); the STRUCTURE (formula, ladders, inversions,
sparsity) is the faithful part and is what the solver must survive.

On-demand prices are uniform across zones (as in the real price sheet);
spot varies per (type, zone) with family-class discount bands, and ~2%
of spot pools are inverted above on-demand or absent entirely —
deterministic via name hashing so benchmarks stay reproducible.

The port's copy of `karpenter_tpu/providers/ec2_catalog.py`: the same
table, so `dump_catalog(transcribe_catalog())` serialises to the bytes
of `providers/generated/catalog_default.json`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.providers.catalog import (
    CatalogSpec,
    _det_unit,
    _overhead,
    _vm_overhead,
)
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import InstanceType, Offering
from karpenter_tpu_torch.models.requirements import Requirement, Requirements
from karpenter_tpu_torch.models.resources import Resources

# vCPUs per size suffix (the real EC2 ladder; "metal" matches the
# family's largest virtualized size and is overridden per family)
SIZE_VCPUS = {
    "medium": 1, "large": 2, "xlarge": 4, "2xlarge": 8, "3xlarge": 12,
    "4xlarge": 16, "6xlarge": 24, "8xlarge": 32, "9xlarge": 36,
    "12xlarge": 48, "16xlarge": 64, "18xlarge": 72, "24xlarge": 96,
    "32xlarge": 128, "48xlarge": 192,
}

# Real ENI/IPv4-per-ENI limits for nitro sizes
# (zz_generated.vpclimits.go's role).  max_pods = eni*(ip-1)+2:
# large → 3*(10-1)+2 = 29, xlarge → 4*(15-1)+2 = 58,
# 4xlarge → 8*(30-1)+2 = 234, 16xlarge+ → 15*(50-1)+2 = 737.
NITRO_ENI: Dict[str, Tuple[int, int]] = {
    "medium": (2, 4), "large": (3, 10), "xlarge": (4, 15),
    "2xlarge": (4, 15), "3xlarge": (8, 30), "4xlarge": (8, 30),
    "6xlarge": (8, 30), "8xlarge": (8, 30), "9xlarge": (8, 30),
    "12xlarge": (8, 30), "16xlarge": (15, 50), "18xlarge": (15, 50),
    "24xlarge": (15, 50), "32xlarge": (15, 50), "48xlarge": (15, 50),
    "metal": (15, 50),
}
# Burstable sizes have their own (smaller) ENI ladder: t3.micro 4 pods,
# t3.small 11, t3.medium 17, t3.large 35 — the real numbers.
BURST_ENI: Dict[str, Tuple[int, int]] = {
    "micro": (2, 2), "small": (3, 4), "medium": (3, 6), "large": (3, 12),
    "xlarge": (4, 15), "2xlarge": (4, 15),
}

# Baseline network bandwidth ladders in Mbps per size suffix
# (zz_generated.bandwidth.go's role).
BW_STD = {
    "medium": 750, "large": 750, "xlarge": 1250, "2xlarge": 2500,
    "3xlarge": 3750, "4xlarge": 5000, "6xlarge": 7500, "8xlarge": 10000,
    "9xlarge": 10000, "12xlarge": 12000, "16xlarge": 20000,
    "18xlarge": 25000, "24xlarge": 25000, "32xlarge": 50000,
    "48xlarge": 50000, "metal": 25000,
}
BW_NET = {  # the *n network-optimized families (c5n/m5n/r5n/c6gn/...)
    "medium": 1600, "large": 3000, "xlarge": 5000, "2xlarge": 10000,
    "3xlarge": 15000, "4xlarge": 15000, "6xlarge": 25000,
    "8xlarge": 25000, "9xlarge": 50000, "12xlarge": 50000,
    "16xlarge": 75000, "18xlarge": 100000, "24xlarge": 100000,
    "32xlarge": 100000, "48xlarge": 100000, "metal": 100000,
}
BW_GEN7 = {  # 7th-gen uplift
    "medium": 780, "large": 780, "xlarge": 1560, "2xlarge": 3120,
    "3xlarge": 4680, "4xlarge": 6250, "6xlarge": 9370,
    "8xlarge": 12500, "12xlarge": 18750, "16xlarge": 25000,
    "24xlarge": 37500, "32xlarge": 50000, "48xlarge": 50000,
    "metal": 50000,
}

STD8 = ["large", "xlarge", "2xlarge", "4xlarge", "8xlarge", "12xlarge",
        "16xlarge", "24xlarge"]
STD9_32 = STD8 + ["32xlarge"]
STD10_48 = STD8 + ["32xlarge", "48xlarge"]
ARM7 = ["medium"] + STD8[:-1]  # graviton ladders stop at 16xlarge


@dataclass(frozen=True)
class Family:
    """One real instance family: shared shape, linear pricing."""
    name: str
    category: str          # c/m/r/t/i/z/x/d/g/p — first letter class
    generation: int
    arch: str
    mem_per_vcpu: float    # GiB per vCPU (None → per-size override)
    vcpu_price: float      # $/vCPU-hour (family base; price = vcpus × this)
    sizes: tuple
    nvme_gb_per_vcpu: float = 0.0
    bw: str = "std"        # std | net | gen7
    metal_vcpus: int = 0   # 0 = no metal size
    zones: tuple = ()      # () = all spec zones; else explicit subset


def _f(name, cat, gen, arch, ratio, large_price, sizes, **kw) -> Family:
    """Family from its .large price (the commonly quoted anchor)."""
    return Family(name=name, category=cat, generation=gen, arch=arch,
                  mem_per_vcpu=ratio, vcpu_price=large_price / 2.0,
                  sizes=tuple(sizes), **kw)


# ---------------------------------------------------------------------------
# The transcription.  Anchor prices are public us-east-1 on-demand
# $/hour for the .large size (or stated size); shapes are the public
# vCPU/memory ladders.
# ---------------------------------------------------------------------------

FAMILIES: List[Family] = [
    # ---- general purpose (4 GiB/vCPU) --------------------------------
    _f("m4", "m", 4, "amd64", 4.0, 0.10, ["large", "xlarge", "2xlarge",
                                          "4xlarge", "16xlarge"]),
    _f("m5", "m", 5, "amd64", 4.0, 0.096, STD8, metal_vcpus=96),
    _f("m5a", "m", 5, "amd64", 4.0, 0.086, STD8),
    _f("m5ad", "m", 5, "amd64", 4.0, 0.103, STD8, nvme_gb_per_vcpu=37.5),
    _f("m5d", "m", 5, "amd64", 4.0, 0.113, STD8, nvme_gb_per_vcpu=37.5,
       metal_vcpus=96),
    _f("m5n", "m", 5, "amd64", 4.0, 0.119, STD8, bw="net", metal_vcpus=96),
    _f("m5dn", "m", 5, "amd64", 4.0, 0.136, STD8, bw="net",
       nvme_gb_per_vcpu=37.5),
    _f("m5zn", "m", 5, "amd64", 4.0, 0.1652,
       ["large", "xlarge", "2xlarge", "3xlarge", "6xlarge", "12xlarge"],
       bw="net"),
    _f("m6i", "m", 6, "amd64", 4.0, 0.096, STD9_32, metal_vcpus=128),
    _f("m6a", "m", 6, "amd64", 4.0, 0.0864, STD10_48),
    _f("m6id", "m", 6, "amd64", 4.0, 0.11865, STD9_32,
       nvme_gb_per_vcpu=37.5),
    _f("m6in", "m", 6, "amd64", 4.0, 0.13362, STD9_32, bw="net"),
    _f("m6idn", "m", 6, "amd64", 4.0, 0.15594, STD9_32, bw="net",
       nvme_gb_per_vcpu=37.5),
    _f("m6g", "m", 6, "arm64", 4.0, 0.077, ARM7, metal_vcpus=64),
    _f("m6gd", "m", 6, "arm64", 4.0, 0.0904, ARM7, nvme_gb_per_vcpu=37.5),
    _f("m7i", "m", 7, "amd64", 4.0, 0.1008, STD10_48, bw="gen7",
       metal_vcpus=192, zones=("a", "b")),
    _f("m7a", "m", 7, "amd64", 4.0, 0.11592, STD10_48, bw="gen7",
       zones=("a", "b")),
    _f("m7g", "m", 7, "arm64", 4.0, 0.0816, ARM7, bw="gen7",
       zones=("a", "b")),
    _f("m7gd", "m", 7, "arm64", 4.0, 0.1068, ARM7, bw="gen7",
       nvme_gb_per_vcpu=37.5, zones=("a", "b")),
    # ---- compute optimized (2 GiB/vCPU) ------------------------------
    _f("c4", "c", 4, "amd64", 1.875, 0.10, ["large", "xlarge", "2xlarge",
                                            "4xlarge", "8xlarge"]),
    _f("c5", "c", 5, "amd64", 2.0, 0.085,
       ["large", "xlarge", "2xlarge", "4xlarge", "9xlarge", "12xlarge",
        "18xlarge", "24xlarge"], metal_vcpus=96),
    _f("c5a", "c", 5, "amd64", 2.0, 0.077, STD8),
    _f("c5ad", "c", 5, "amd64", 2.0, 0.086, STD8, nvme_gb_per_vcpu=29.0),
    _f("c5d", "c", 5, "amd64", 2.0, 0.096,
       ["large", "xlarge", "2xlarge", "4xlarge", "9xlarge", "12xlarge",
        "18xlarge", "24xlarge"], nvme_gb_per_vcpu=25.0, metal_vcpus=96),
    _f("c5n", "c", 5, "amd64", 2.625, 0.108,
       ["large", "xlarge", "2xlarge", "4xlarge", "9xlarge", "18xlarge"],
       bw="net", metal_vcpus=72),
    _f("c6i", "c", 6, "amd64", 2.0, 0.085, STD9_32, metal_vcpus=128),
    _f("c6a", "c", 6, "amd64", 2.0, 0.0765, STD10_48),
    _f("c6id", "c", 6, "amd64", 2.0, 0.1008, STD9_32,
       nvme_gb_per_vcpu=29.0),
    _f("c6in", "c", 6, "amd64", 2.0, 0.1134, STD9_32, bw="net"),
    _f("c6g", "c", 6, "arm64", 2.0, 0.068, ARM7, metal_vcpus=64),
    _f("c6gd", "c", 6, "arm64", 2.0, 0.0768, ARM7, nvme_gb_per_vcpu=29.0),
    _f("c6gn", "c", 6, "arm64", 2.0, 0.0864, ARM7, bw="net"),
    _f("c7i", "c", 7, "amd64", 2.0, 0.08925, STD10_48, bw="gen7",
       zones=("a", "b")),
    _f("c7a", "c", 7, "amd64", 2.0, 0.10257, STD10_48, bw="gen7",
       zones=("a", "b")),
    _f("c7g", "c", 7, "arm64", 2.0, 0.0725, ARM7, bw="gen7",
       zones=("a", "b")),
    _f("c7gd", "c", 7, "arm64", 2.0, 0.0908, ARM7, bw="gen7",
       nvme_gb_per_vcpu=29.0, zones=("a", "b")),
    _f("c7gn", "c", 7, "arm64", 2.0, 0.0998, ARM7, bw="net",
       zones=("a", "b")),
    # ---- memory optimized (8 GiB/vCPU) -------------------------------
    _f("r4", "r", 4, "amd64", 7.625, 0.133, ["large", "xlarge", "2xlarge",
                                             "4xlarge", "8xlarge",
                                             "16xlarge"]),
    _f("r5", "r", 5, "amd64", 8.0, 0.126, STD8, metal_vcpus=96),
    _f("r5a", "r", 5, "amd64", 8.0, 0.113, STD8),
    _f("r5ad", "r", 5, "amd64", 8.0, 0.131, STD8, nvme_gb_per_vcpu=37.5),
    _f("r5b", "r", 5, "amd64", 8.0, 0.149, STD8, metal_vcpus=96),
    _f("r5d", "r", 5, "amd64", 8.0, 0.144, STD8, nvme_gb_per_vcpu=37.5,
       metal_vcpus=96),
    _f("r5n", "r", 5, "amd64", 8.0, 0.149, STD8, bw="net"),
    _f("r5dn", "r", 5, "amd64", 8.0, 0.167, STD8, bw="net",
       nvme_gb_per_vcpu=37.5),
    _f("r6i", "r", 6, "amd64", 8.0, 0.126, STD9_32, metal_vcpus=128),
    _f("r6a", "r", 6, "amd64", 8.0, 0.1134, STD10_48),
    _f("r6id", "r", 6, "amd64", 8.0, 0.1512, STD9_32,
       nvme_gb_per_vcpu=59.0),
    _f("r6in", "r", 6, "amd64", 8.0, 0.17457, STD9_32, bw="net"),
    _f("r6idn", "r", 6, "amd64", 8.0, 0.19503, STD9_32, bw="net",
       nvme_gb_per_vcpu=59.0),
    _f("r6g", "r", 6, "arm64", 8.0, 0.1008, ARM7, metal_vcpus=64),
    _f("r6gd", "r", 6, "arm64", 8.0, 0.1152, ARM7, nvme_gb_per_vcpu=59.0),
    _f("r7i", "r", 7, "amd64", 8.0, 0.1323, STD10_48, bw="gen7",
       zones=("a", "b")),
    _f("r7a", "r", 7, "amd64", 8.0, 0.15225, STD10_48, bw="gen7",
       zones=("a", "b")),
    _f("r7g", "r", 7, "arm64", 8.0, 0.107, ARM7, bw="gen7",
       zones=("a", "b")),
    _f("r7gd", "r", 7, "arm64", 8.0, 0.1361, ARM7, bw="gen7",
       nvme_gb_per_vcpu=59.0, zones=("a", "b")),
    # ---- storage / specialty -----------------------------------------
    _f("i3", "i", 3, "amd64", 7.625, 0.156, ["large", "xlarge", "2xlarge",
                                             "4xlarge", "8xlarge",
                                             "16xlarge"],
       nvme_gb_per_vcpu=237.5, metal_vcpus=72),
    _f("i3en", "i", 3, "amd64", 8.0, 0.226, ["large", "xlarge", "2xlarge",
                                             "3xlarge", "6xlarge",
                                             "12xlarge", "24xlarge"],
       nvme_gb_per_vcpu=625.0, bw="net", zones=("a", "b")),
    _f("i4i", "i", 4, "amd64", 8.0, 0.172, STD9_32,
       nvme_gb_per_vcpu=234.0, metal_vcpus=128),
    _f("im4gn", "i", 4, "arm64", 4.0, 0.1516, ["large", "xlarge",
                                               "2xlarge", "4xlarge",
                                               "8xlarge", "16xlarge"],
       nvme_gb_per_vcpu=468.0),
    _f("z1d", "z", 1, "amd64", 8.0, 0.186, ["large", "xlarge", "2xlarge",
                                            "3xlarge", "6xlarge",
                                            "12xlarge"],
       nvme_gb_per_vcpu=37.5, metal_vcpus=48, zones=("a", "b")),
    _f("x2gd", "x", 2, "arm64", 16.0, 0.1672, ["medium", "large", "xlarge",
                                               "2xlarge", "4xlarge",
                                               "8xlarge", "16xlarge"],
       nvme_gb_per_vcpu=59.0, metal_vcpus=64, zones=("a", "b")),
    _f("x1e", "x", 1, "amd64", 30.5, 0.834 / 2, ["xlarge", "2xlarge",
                                                 "4xlarge", "8xlarge",
                                                 "16xlarge", "32xlarge"],
       nvme_gb_per_vcpu=30.0, zones=("a",)),
    # anchors quoted per the public sheet: d3.xlarge $0.499 (4 vCPU),
    # h1.2xlarge $0.468 (8 vCPU) — normalized to the .large-equivalent
    # the _f helper expects
    _f("d3", "d", 3, "amd64", 8.0, 0.499 / 2, ["xlarge", "2xlarge",
                                               "4xlarge", "8xlarge"],
       nvme_gb_per_vcpu=1485.0, zones=("a", "b")),
    _f("h1", "h", 1, "amd64", 4.0, 0.468 / 4, ["2xlarge", "4xlarge",
                                               "8xlarge", "16xlarge"],
       nvme_gb_per_vcpu=250.0, zones=("a", "b")),
    _f("a1", "a", 1, "arm64", 2.0, 0.051, ["medium", "large", "xlarge",
                                           "2xlarge", "4xlarge"]),
]

# Burstable: (size, vcpus, mem GiB); price anchors: t3 large = $0.0832,
# family multipliers t3a ×0.90, t4g ×0.80 — the real ratios.
BURST_SHAPES = [("micro", 2, 1.0), ("small", 2, 2.0), ("medium", 2, 4.0),
                ("large", 2, 8.0), ("xlarge", 4, 16.0), ("2xlarge", 8, 32.0)]
BURST_FAMILIES = [("t2", 4, "amd64", 1.115), ("t3", 5, "amd64", 1.0),
                  ("t3a", 5, "amd64", 0.90), ("t4g", 5, "arm64", 0.80)]
T3_PRICES = {"micro": 0.0104, "small": 0.0208, "medium": 0.0416,
             "large": 0.0832, "xlarge": 0.1664, "2xlarge": 0.3328}

# GPU shapes: name → (gpu model, rows).  Row: (size, vcpus, mem GiB,
# gpus, $/h, (eni, ip), bandwidth Mbps, nvme GB, zones).
# Real adversarial structure preserved: g4dn.16xlarge max-pods 58 <
# g4dn.12xlarge 234; g5.16xlarge $4.096 < g5.12xlarge $5.672.
GPU_FAMILIES: Dict[str, Tuple[str, list]] = {
    "g4dn": ("t4", [
        ("xlarge", 4, 16, 1, 0.526, (3, 10), 5000, 125, "abc"),
        ("2xlarge", 8, 32, 1, 0.752, (3, 10), 10000, 225, "abc"),
        ("4xlarge", 16, 64, 1, 1.204, (3, 10), 20000, 225, "abc"),
        ("8xlarge", 32, 128, 1, 2.176, (4, 15), 50000, 900, "abc"),
        ("12xlarge", 48, 192, 4, 3.912, (8, 30), 50000, 900, "ab"),
        ("16xlarge", 64, 256, 1, 4.352, (4, 15), 50000, 900, "ab"),
    ]),
    "g4ad": ("radeon-v520", [
        ("xlarge", 4, 16, 1, 0.379, (3, 10), 2500, 150, "ab"),
        ("2xlarge", 8, 32, 1, 0.541, (3, 10), 5000, 300, "ab"),
        ("4xlarge", 16, 64, 1, 0.867, (3, 10), 10000, 600, "ab"),
        ("8xlarge", 32, 128, 2, 1.734, (4, 15), 15000, 1200, "ab"),
        ("16xlarge", 64, 256, 4, 3.468, (8, 30), 25000, 2400, "ab"),
    ]),
    "g5": ("a10g", [
        ("xlarge", 4, 16, 1, 1.006, (4, 15), 2500, 250, "abc"),
        ("2xlarge", 8, 32, 1, 1.212, (4, 15), 5000, 450, "abc"),
        ("4xlarge", 16, 64, 1, 1.624, (8, 30), 10000, 600, "abc"),
        ("8xlarge", 32, 128, 1, 2.448, (8, 30), 25000, 900, "abc"),
        ("12xlarge", 48, 192, 4, 5.672, (8, 30), 40000, 3800, "ab"),
        ("16xlarge", 64, 256, 1, 4.096, (15, 50), 25000, 1900, "ab"),
        ("24xlarge", 96, 384, 4, 8.144, (15, 50), 50000, 3800, "ab"),
        ("48xlarge", 192, 768, 8, 16.288, (15, 50), 100000, 7600, "a"),
    ]),
    "g6": ("l4", [
        ("xlarge", 4, 16, 1, 0.805, (4, 15), 10000, 250, "ab"),
        ("2xlarge", 8, 32, 1, 0.978, (4, 15), 10000, 450, "ab"),
        ("4xlarge", 16, 64, 1, 1.323, (8, 30), 25000, 600, "ab"),
        ("8xlarge", 32, 128, 1, 2.014, (8, 30), 25000, 900, "ab"),
        ("12xlarge", 48, 192, 4, 4.602, (8, 30), 40000, 3800, "a"),
        ("16xlarge", 64, 256, 1, 3.397, (15, 50), 25000, 1900, "a"),
        ("24xlarge", 96, 384, 4, 6.675, (15, 50), 50000, 3800, "a"),
        ("48xlarge", 192, 768, 8, 13.35, (15, 50), 100000, 7600, "a"),
    ]),
    "g3": ("m60", [
        ("4xlarge", 16, 122, 1, 1.14, (8, 30), 5000, 0, "ab"),
        ("8xlarge", 32, 244, 2, 2.28, (8, 30), 10000, 0, "ab"),
        ("16xlarge", 64, 488, 4, 4.56, (15, 50), 20000, 0, "ab"),
    ]),
    "p2": ("k80", [
        ("xlarge", 4, 61, 1, 0.90, (4, 15), 1250, 0, "ab"),
        ("8xlarge", 32, 488, 8, 7.20, (8, 30), 10000, 0, "ab"),
        ("16xlarge", 64, 732, 16, 14.40, (8, 30), 20000, 0, "ab"),
    ]),
    "p3": ("v100", [
        ("2xlarge", 8, 61, 1, 3.06, (4, 15), 10000, 0, "ab"),
        ("8xlarge", 32, 244, 4, 12.24, (8, 30), 10000, 0, "ab"),
        ("16xlarge", 64, 488, 8, 24.48, (8, 30), 25000, 0, "ab"),
    ]),
    "p4d": ("a100", [
        ("24xlarge", 96, 1152, 8, 32.7726, (15, 50), 400000, 8000, "a"),
    ]),
    "p5": ("h100", [
        ("48xlarge", 192, 2048, 8, 98.32, (15, 50), 3200000, 30720, "a"),
    ]),
}

# Spot discount bands (fraction OFF on-demand) by family class — real
# spot markets discount commodity x86 deepest and constrained
# accelerators least.
_SPOT_BANDS = {
    "amd64": (0.50, 0.72), "arm64": (0.35, 0.60),
    "gpu": (0.30, 0.65), "burst": (0.66, 0.72), "storage": (0.45, 0.65),
}
# ~1.5% of spot pools are priced ABOVE on-demand (capacity crunch) and a
# further ~1.5% have no spot pool at all in a given zone.
_SPOT_MISSING_P = 0.015
_SPOT_INVERTED_P = 0.015


def _spot_price(name: str, zone: str, od: float, band: str) -> Optional[float]:
    u = _det_unit(name, zone + ":spotstruct")
    if u < _SPOT_MISSING_P:
        return None  # no spot capacity pool in this zone
    if u < _SPOT_MISSING_P + _SPOT_INVERTED_P:
        # inverted: spot clearing above on-demand
        return round(od * (1.02 + 0.10 * _det_unit(name, zone + ":inv")), 5)
    lo, hi = _SPOT_BANDS[band]
    off = lo + (hi - lo) * _det_unit(name, zone + ":spot")
    return round(od * (1.0 - off), 5)


def _zones_for(fam_zones: tuple, spec_zones: List[str]) -> List[str]:
    """Map a family's zone-letter subset onto the spec's zone names (the
    real catalog's sparse zonal availability: new generations and
    constrained hardware roll out to a subset of zones)."""
    if not fam_zones:
        return list(spec_zones)
    out = []
    for letter in fam_zones:
        for z in spec_zones:
            if z.endswith(letter):
                out.append(z)
    return out or list(spec_zones)[:1]


def _build_type(name: str, category: str, family: str, generation: int,
                vcpus: int, mem_gib: float, arch: str, size: str,
                zones: List[str], od_price: float, eni: Tuple[int, int],
                bandwidth: int, nvme_gb: float, band: str,
                gpus: int = 0, gpu_name: str = "") -> InstanceType:
    mem_mib = mem_gib * 1024 - _vm_overhead(mem_gib)
    max_pods = eni[0] * (eni[1] - 1) + 2
    ephemeral_gib = nvme_gb if nvme_gb else 100  # EBS-only default volume
    capacity = Resources.of(
        cpu=vcpus * 1000.0,
        memory=mem_mib,
        ephemeral_storage=ephemeral_gib * 1024.0,
        pods=float(max_pods),
        gpu=float(gpus),
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
        wellknown.INSTANCE_LOCAL_NVME_LABEL:
            str(int(nvme_gb)) if nvme_gb else "0",
        wellknown.INSTANCE_NETWORK_BANDWIDTH_LABEL: str(bandwidth),
    }
    if gpus:
        labels[wellknown.INSTANCE_GPU_COUNT_LABEL] = str(gpus)
        labels[wellknown.INSTANCE_GPU_NAME_LABEL] = gpu_name
    reqs = Requirements(*(Requirement.single(k, v)
                          for k, v in labels.items()))
    offerings: List[Offering] = []
    od = round(od_price, 5)
    for zone in zones:
        # on-demand price is region-wide (the real price sheet has no
        # zonal OD variation)
        offerings.append(Offering(zone, wellknown.CAPACITY_TYPE_ON_DEMAND,
                                  od))
        spot = _spot_price(name, zone, od, band)
        if spot is not None:
            offerings.append(Offering(zone, wellknown.CAPACITY_TYPE_SPOT,
                                      spot))
    zs = sorted({o.zone for o in offerings})
    cts = sorted({o.capacity_type for o in offerings})
    reqs.add(Requirement.make(wellknown.ZONE_LABEL, "In", *zs))
    reqs.add(Requirement.make(wellknown.CAPACITY_TYPE_LABEL, "In", *cts))
    return InstanceType(
        name=name, capacity=capacity, requirements=reqs,
        offerings=offerings,
        overhead=_overhead(vcpus, max_pods, ephemeral_gib * 1024.0),
    )


def transcribe_catalog(spec: Optional[CatalogSpec] = None) -> List[InstanceType]:
    """The real-shaped default catalog (role of the reference's
    zz_generated data trio).  Honors spec.zones / include_gpu /
    include_burstable / max_types so tests can reshape it the same way
    they reshape the synthetic generator."""
    spec = spec or CatalogSpec()
    out: List[InstanceType] = []

    for fam in FAMILIES:
        zones = _zones_for(fam.zones, spec.zones)
        band = ("storage" if fam.category in ("i", "z", "x", "d", "h")
                else fam.arch)
        for size in fam.sizes:
            vcpus = SIZE_VCPUS[size]
            mem_gib = vcpus * fam.mem_per_vcpu
            eni = NITRO_ENI[size]
            bw_tab = {"std": BW_STD, "net": BW_NET, "gen7": BW_GEN7}[fam.bw]
            out.append(_build_type(
                name=f"{fam.name}.{size}", category=fam.category,
                family=fam.name, generation=fam.generation, vcpus=vcpus,
                mem_gib=mem_gib, arch=fam.arch, size=size, zones=zones,
                od_price=vcpus * fam.vcpu_price, eni=eni,
                bandwidth=bw_tab.get(size, BW_STD[size]),
                nvme_gb=fam.nvme_gb_per_vcpu * vcpus, band=band))
        if fam.metal_vcpus:
            vcpus = fam.metal_vcpus
            mem_gib = vcpus * fam.mem_per_vcpu
            bw_tab = {"std": BW_STD, "net": BW_NET, "gen7": BW_GEN7}[fam.bw]
            out.append(_build_type(
                name=f"{fam.name}.metal", category=fam.category,
                family=fam.name, generation=fam.generation, vcpus=vcpus,
                mem_gib=mem_gib, arch=fam.arch, size="metal", zones=zones,
                od_price=vcpus * fam.vcpu_price, eni=NITRO_ENI["metal"],
                bandwidth=bw_tab["metal"],
                nvme_gb=fam.nvme_gb_per_vcpu * vcpus, band=band))

    if spec.include_burstable:
        for fname, gen, arch, mult in BURST_FAMILIES:
            zones = _zones_for((), spec.zones)
            for size, vcpus, mem_gib in BURST_SHAPES:
                if fname == "t2" and size in ("xlarge", "2xlarge"):
                    continue  # t2 tops out at t2.large in this ladder
                out.append(_build_type(
                    name=f"{fname}.{size}", category="t", family=fname,
                    generation=gen, arch=arch, size=size, vcpus=vcpus,
                    mem_gib=mem_gib, zones=zones,
                    od_price=T3_PRICES[size] * mult,
                    eni=BURST_ENI[size],
                    bandwidth=BW_STD.get(size, 750) if vcpus > 2 else 750,
                    nvme_gb=0.0, band="burst"))

    if spec.include_gpu:
        for fname, (gpu_name, rows) in GPU_FAMILIES.items():
            gen = int("".join(ch for ch in fname if ch.isdigit()))
            for (size, vcpus, mem_gib, gpus, price, eni, bw, nvme_gb,
                 zletters) in rows:
                zones = _zones_for(tuple(zletters), spec.zones)
                out.append(_build_type(
                    name=f"{fname}.{size}", category=fname[0],
                    family=fname, generation=gen, vcpus=vcpus,
                    mem_gib=float(mem_gib), arch="amd64", size=size,
                    zones=zones, od_price=price, eni=eni, bandwidth=bw,
                    nvme_gb=float(nvme_gb), band="gpu",
                    gpus=gpus, gpu_name=gpu_name))

    out.sort(key=lambda it: it.name)
    if spec.max_types is not None:
        out = out[: spec.max_types]
    return out
