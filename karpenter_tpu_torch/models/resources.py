"""Resource quantities and the canonical resource axis.

The reference models node capacity/allocatable as k8s `v1.ResourceList`
(reference: pkg/providers/instancetype/types.go:193-210 builds cpu, memory,
ephemeral-storage, pods, and extended resources like nvidia.com/gpu).

For the TPU solver every resource must live on a fixed tensor axis, so we
define a canonical ordering (`RESOURCE_AXIS`) covering the resources the
reference computes, plus a small number of extended-resource slots that are
interned on demand. Quantities are held as floats in solver-friendly units:

  cpu               millicores
  memory            MiB   (keeps f32-exact at TPU precision for TB-range nodes)
  ephemeral-storage MiB
  pods              count
  accelerators      count

Parsing follows k8s quantity syntax ("100m", "1.5Gi", "2T", plain ints).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

# Canonical dense axis. Extended resources beyond these are interned into
# EXTENDED slots (the reference similarly special-cases gpu/neuron/efa —
# pkg/providers/instancetype/types.go:193-210).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL = "ephemeral-storage"
PODS = "pods"
GPU = "gpu"  # generic accelerator slot (nvidia.com/gpu et al. map here)
# attachable persistent-volume slots: the reference enforces per-node
# volume attach limits during scheduling (scheduling.md:381-417 /
# instance-store policy ec2nodeclass.go:384-394); modeling them as a
# resource axis rides the same pods×types capacity tensors as cpu/memory
VOLUMES = "volumes"

RESOURCE_AXIS: tuple[str, ...] = (CPU, MEMORY, EPHEMERAL, PODS, GPU, VOLUMES)
AXIS_INDEX: dict[str, int] = {name: i for i, name in enumerate(RESOURCE_AXIS)}

# Names that alias onto the canonical axis.
_ALIASES = {
    "nvidia.com/gpu": GPU,
    "amd.com/gpu": GPU,
    "google.com/tpu": GPU,
    "aws.amazon.com/neuron": GPU,
}

_SUFFIX = {
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}

_QTY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]*)$")


def parse_quantity(value: "str | int | float") -> float:
    """Parse a k8s quantity into a raw float (bytes / cores / count)."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _QTY_RE.match(value.strip())
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    num, suffix = m.groups()
    base = float(num)
    if suffix == "":
        return base
    if suffix == "m":
        return base / 1000.0
    if suffix in _SUFFIX:
        return base * _SUFFIX[suffix]
    raise ValueError(f"invalid quantity suffix {suffix!r} in {value!r}")


def format_quantity(value: float) -> str:
    if value == int(value):
        return str(int(value))
    return f"{value:g}"


def _to_solver_units(name: str, raw: float) -> float:
    """raw (cores / bytes / count) → solver units (millicores / MiB / count)."""
    if name == CPU:
        return raw * 1000.0
    if name in (MEMORY, EPHEMERAL):
        return raw / 2**20
    return raw


def _from_solver_units(name: str, val: float) -> float:
    if name == CPU:
        return val / 1000.0
    if name in (MEMORY, EPHEMERAL):
        return val * 2**20
    return val


class Resources:
    """A dense resource vector over RESOURCE_AXIS, in solver units.

    Arithmetic mirrors the reference's resources helpers
    (sigs.k8s.io/karpenter/pkg/utils/resources: Merge, Subtract, Fits).
    """

    __slots__ = ("v", "_cached_key")

    def __init__(self, v: "list[float] | None" = None):
        self.v = list(v) if v is not None else [0.0] * len(RESOURCE_AXIS)
        self._cached_key = None

    # -- constructors ----------------------------------------------------
    @classmethod
    def parse(cls, spec: Mapping[str, "str | int | float"]) -> "Resources":
        """From a k8s-style resource map, e.g. {"cpu": "100m", "memory": "1Gi"}."""
        r = cls()
        for name, q in spec.items():
            canon = _ALIASES.get(name, name)
            if canon not in AXIS_INDEX:
                raise ValueError(f"unknown resource {name!r}")
            r.v[AXIS_INDEX[canon]] += _to_solver_units(canon, parse_quantity(q))
        return r

    @classmethod
    def limits(cls, spec: "Mapping[str, str | int | float] | None" = None,
               **kw: float) -> "Resources":
        """A limits vector: axes not named are unconstrained (+inf), so a
        cpu-only NodePool limit doesn't implicitly zero out memory
        (reference: NodePool.spec.limits constrains only listed resources).
        Named axes may be zero to forbid a resource entirely.
        """
        r = cls([float("inf")] * len(RESOURCE_AXIS))
        if spec:
            for name, q in spec.items():
                canon = _ALIASES.get(name, name)
                r.v[AXIS_INDEX[canon]] = _to_solver_units(canon, parse_quantity(q))
        for name, val in kw.items():
            r.v[AXIS_INDEX[name.replace("_", "-")]] = float(val)
        return r

    @classmethod
    def of(cls, **kw: float) -> "Resources":
        """From solver units directly: Resources.of(cpu=2000, memory=4096)."""
        r = cls()
        for name, val in kw.items():
            name = name.replace("_", "-")
            r.v[AXIS_INDEX[name]] = float(val)
        return r

    def copy(self) -> "Resources":
        return Resources(self.v)

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other: "Resources") -> "Resources":
        return Resources([a + b for a, b in zip(self.v, other.v)])

    def __sub__(self, other: "Resources") -> "Resources":
        return Resources([a - b for a, b in zip(self.v, other.v)])

    def __iadd__(self, other: "Resources") -> "Resources":
        for i, b in enumerate(other.v):
            self.v[i] += b
        self._cached_key = None
        return self

    def __mul__(self, k: float) -> "Resources":
        return Resources([a * k for a in self.v])

    def fits(self, capacity: "Resources", eps: float = 1e-9) -> bool:
        """True if self ≤ capacity elementwise (with float slack). Plain
        indexed loop: this is the oracle's innermost check (~1M calls per
        5k-pod solve) and the generator+zip form cost ~2x."""
        a, b = self.v, capacity.v
        for i in range(len(a)):
            if a[i] > b[i] + eps:
                return False
        return True

    def any_negative(self) -> bool:
        return any(a < -1e-9 for a in self.v)

    def is_zero(self) -> bool:
        return all(abs(a) < 1e-9 for a in self.v)

    # -- accessors -------------------------------------------------------
    def get(self, name: str) -> float:
        return self.v[AXIS_INDEX[_ALIASES.get(name, name)]]

    def set(self, name: str, val: float) -> None:
        self.v[AXIS_INDEX[_ALIASES.get(name, name)]] = float(val)
        self._cached_key = None

    @property
    def cpu(self) -> float:
        return self.v[AXIS_INDEX[CPU]]

    @property
    def memory(self) -> float:
        return self.v[AXIS_INDEX[MEMORY]]

    @property
    def pods(self) -> float:
        return self.v[AXIS_INDEX[PODS]]

    def to_dict(self) -> Dict[str, float]:
        """Back to k8s-style raw units (cores / bytes / count)."""
        return {
            name: _from_solver_units(name, val)
            for name, val in zip(RESOURCE_AXIS, self.v)
            if val != 0.0
        }

    def to_dict_solver(self) -> Dict[str, float]:
        """Solver units as-is (millicores / MiB / count) — the catalog
        table's lossless serialization (providers/catalog.py dump_catalog)."""
        return {name: val for name, val in zip(RESOURCE_AXIS, self.v)
                if val != 0.0}

    # magnitude used for FFD descending sort (reference sorts pods by
    # resource size — designs/bin-packing.md:28-29; core uses cpu then mem).
    def sort_key(self) -> tuple[float, float]:
        return (self.cpu, self.memory)

    # eq/hash quantize to 1e-6 solver units so the pair is consistent
    # (Resources participates in Pod.scheduling_key equivalence classes).
    # Cached: grouping 50k pods hashes/compares these in the hot path; every
    # mutating method below invalidates.
    def _key(self) -> tuple:
        if self._cached_key is None:
            self._cached_key = tuple(round(a, 6) for a in self.v)
        return self._cached_key

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Resources) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{n}={v:g}" for n, v in zip(RESOURCE_AXIS, self.v) if v
        )
        return f"Resources({parts})"


def merge(items: Iterable[Resources]) -> Resources:
    out = Resources()
    for it in items:
        out += it
    return out
