"""Label-requirement set algebra.

This is the constraint engine of the whole framework — the reference's
`scheduling.Requirements` (sigs.k8s.io/karpenter/pkg/scheduling; behavior
documented at website/content/en/preview/concepts/nodepools.md:240-304 and
exercised via the NodePool CRD `spec.template.spec.requirements` —
pkg/apis/crds/karpenter.sh_nodepools.yaml).

A `Requirement` is, per label key, a (possibly complemented) value set plus
optional integer bounds:

  In [a,b]        vals={a,b}, complement=False
  NotIn [a,b]     vals={a,b}, complement=True
  Exists          vals={},    complement=True,  requires existence
  DoesNotExist    vals={},    complement=False  (allowed set empty, absent ok)
  Gt n / Lt n     complement=True + integer bound, requires existence

Set intersection follows the standard complement algebra; bounds tighten by
max(gt) / min(lt). `requires_existence` is tracked separately so that
closed-world matching against a concrete node's labels can honor k8s
node-affinity semantics (NotIn / DoesNotExist match a missing label; In /
Exists / Gt / Lt do not).

`min_values` carries the NodePool `minValues` field (per-key floor on the
number of distinct values among the instance types chosen for a claim —
nodepools.md:240-304); it is enforced at instance-type selection time, not in
the set algebra.
"""

from __future__ import annotations

import enum
from typing import Dict, Iterable, Iterator, Optional


class Operator(str, enum.Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


class Requirement:
    __slots__ = ("key", "vals", "complement", "greater_than", "less_than",
                 "requires_existence", "min_values", "_h")

    def __init__(
        self,
        key: str,
        vals: Iterable[str] = (),
        complement: bool = False,
        greater_than: Optional[int] = None,
        less_than: Optional[int] = None,
        requires_existence: bool = True,
        min_values: Optional[int] = None,
    ):
        self.key = key
        self.vals = frozenset(vals)
        self.complement = complement
        self.greater_than = greater_than
        self.less_than = less_than
        self.requires_existence = requires_existence
        self.min_values = min_values
        self._h: Optional[int] = None  # Requirement is immutable; hash cached

    # -- constructors ----------------------------------------------------
    @classmethod
    def make(cls, key: str, op: "Operator | str", *vals: str,
             min_values: Optional[int] = None) -> "Requirement":
        op = Operator(op)
        svals = [str(v) for v in vals]
        if op is Operator.IN:
            return cls(key, svals, min_values=min_values)
        if op is Operator.NOT_IN:
            return cls(key, svals, complement=True, requires_existence=False)
        if op is Operator.EXISTS:
            return cls(key, (), complement=True)
        if op is Operator.DOES_NOT_EXIST:
            return cls(key, (), complement=False, requires_existence=False)
        if op is Operator.GT:
            return cls(key, (), complement=True, greater_than=int(svals[0]))
        if op is Operator.LT:
            return cls(key, (), complement=True, less_than=int(svals[0]))
        raise ValueError(op)

    @classmethod
    def single(cls, key: str, value: str) -> "Requirement":
        """A node label: key In [value]."""
        return cls(key, (value,))

    # -- predicates ------------------------------------------------------
    def _in_bounds(self, value: str) -> bool:
        if self.greater_than is None and self.less_than is None:
            return True
        try:
            n = int(value)
        except ValueError:
            return False
        if self.greater_than is not None and not n > self.greater_than:
            return False
        if self.less_than is not None and not n < self.less_than:
            return False
        return True

    def matches(self, value: str) -> bool:
        """Does a concrete label value satisfy this requirement?"""
        if not self._in_bounds(value):
            return False
        if self.complement:
            return value not in self.vals
        return value in self.vals

    def matches_absent(self) -> bool:
        """Does a node *without* this label satisfy this requirement?"""
        return not self.requires_existence

    def is_empty(self) -> bool:
        """No concrete value can ever satisfy this requirement. Note a
        requirement may be empty yet still satisfiable by *absence*
        (DoesNotExist) — see is_unsatisfiable().
        """
        if not self.complement:
            if not self.vals:
                return True  # DoesNotExist-shaped: empty allowed set
            return not any(self._in_bounds(v) for v in self.vals)
        if self.greater_than is not None and self.less_than is not None:
            return self.greater_than + 1 > self.less_than - 1
        return False

    def is_unsatisfiable(self) -> bool:
        """Nothing — no concrete value and not even label absence — can
        satisfy this requirement.
        """
        return self.is_empty() and not self.matches_absent()

    def values(self) -> frozenset[str]:
        """Concrete allowed values (only meaningful for non-complement sets)."""
        if self.complement:
            raise ValueError(f"requirement on {self.key} has no finite value set")
        return frozenset(v for v in self.vals if self._in_bounds(v))

    def is_finite(self) -> bool:
        return not self.complement

    # -- algebra ---------------------------------------------------------
    def intersect(self, other: "Requirement") -> "Requirement":
        assert self.key == other.key
        gt = max(
            (x for x in (self.greater_than, other.greater_than) if x is not None),
            default=None,
        )
        lt = min(
            (x for x in (self.less_than, other.less_than) if x is not None),
            default=None,
        )
        if self.complement and other.complement:
            vals, comp = self.vals | other.vals, True
        elif not self.complement and not other.complement:
            vals, comp = self.vals & other.vals, False
        elif not self.complement:
            vals, comp = self.vals - other.vals, False
        else:
            vals, comp = other.vals - self.vals, False
        mv_candidates = [x for x in (self.min_values, other.min_values) if x is not None]
        return Requirement(
            self.key, vals, comp, gt, lt,
            requires_existence=self.requires_existence or other.requires_existence,
            min_values=max(mv_candidates) if mv_candidates else None,
        )

    def intersects(self, other: "Requirement") -> bool:
        return not self.intersect(other).is_unsatisfiable()

    # -- misc ------------------------------------------------------------
    def _identity(self):
        return (self.key, self.vals, self.complement, self.greater_than,
                self.less_than, self.requires_existence, self.min_values)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Requirement) and self._identity() == other._identity()

    def __hash__(self) -> int:
        if self._h is None:
            self._h = hash(self._identity())
        return self._h

    def __repr__(self) -> str:
        if self.complement and not self.vals and self.greater_than is None \
                and self.less_than is None:
            body = "Exists"
        elif self.complement and self.vals:
            body = f"NotIn{sorted(self.vals)}"
        elif not self.complement and not self.vals:
            body = "DoesNotExist"
        else:
            body = f"In{sorted(self.vals)}"
        if self.greater_than is not None:
            body += f" >{self.greater_than}"
        if self.less_than is not None:
            body += f" <{self.less_than}"
        return f"Req({self.key} {body})"


class Requirements:
    """A conjunction of per-key Requirements, with open-world semantics:
    a key not present is unconstrained (any value, or absent).

    Mirrors sigs.k8s.io/karpenter/pkg/scheduling.Requirements: NewRequirements,
    Add (intersect-in-place), Compatible (pairwise nonempty intersection over
    shared keys), Intersects.
    """

    __slots__ = ("_reqs", "_hash", "_sat")

    def __init__(self, *reqs: Requirement):
        self._reqs: Dict[str, Requirement] = {}
        self._hash: Optional[int] = None
        # memoized "no key is unsatisfiable" verdict: compatible() re-scans
        # every own requirement per call, and instance-type requirement sets
        # are immutable in practice — the oracle's per-(pod×type) checks
        # were ~1M is_unsatisfiable calls per 5k-pod solve without this
        self._sat: Optional[bool] = None
        for r in reqs:
            self.add(r)

    @classmethod
    def from_labels(cls, labels: "Dict[str, str]") -> "Requirements":
        return cls(*(Requirement.single(k, v) for k, v in labels.items()))

    @classmethod
    def from_node_selector(cls, selector: "Dict[str, str]") -> "Requirements":
        return cls(*(Requirement.single(k, v) for k, v in selector.items()))

    # -- container protocol ---------------------------------------------
    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._reqs.values())

    def __len__(self) -> int:
        return len(self._reqs)

    def __contains__(self, key: str) -> bool:
        return key in self._reqs

    def get(self, key: str) -> Optional[Requirement]:
        return self._reqs.get(key)

    def keys(self):
        return self._reqs.keys()

    # -- mutation --------------------------------------------------------
    def add(self, req: Requirement) -> None:
        """Tighten: intersect with any existing requirement on the same key."""
        cur = self._reqs.get(req.key)
        self._reqs[req.key] = cur.intersect(req) if cur is not None else req
        self._hash = None
        self._sat = None

    def update(self, other: "Requirements") -> None:
        for r in other:
            self.add(r)

    def copy(self) -> "Requirements":
        out = Requirements()
        out._reqs = dict(self._reqs)
        out._hash = self._hash
        out._sat = self._sat
        return out

    # -- algebra ---------------------------------------------------------
    def intersection(self, other: "Requirements") -> "Requirements":
        out = self.copy()
        out.update(other)
        return out

    def compatible(self, other: "Requirements") -> bool:
        """Open-world compatibility: every shared key's intersection is
        nonempty and no key becomes unsatisfiable. A key present on only one
        side is unconstrained on the other (the missing side can still take
        any value) — this is how a NodePool template that says nothing about
        `zone` remains compatible with a pod that pins a zone.
        """
        for key, req in other._reqs.items():
            cur = self._reqs.get(key)
            if cur is None:
                if req.is_unsatisfiable():
                    return False
                continue
            if not cur.intersects(req):
                return False
        if self._sat is None:
            self._sat = not any(
                r.is_unsatisfiable() for r in self._reqs.values())
        return self._sat

    def conflict_key(self, other: "Requirements") -> Optional[str]:
        """First key whose intersection is empty, for error messages."""
        for key, req in other._reqs.items():
            cur = self._reqs.get(key)
            if cur is not None and not cur.intersects(req):
                return key
            if cur is None and req.is_unsatisfiable():
                return key
        for key, r in self._reqs.items():
            if r.is_unsatisfiable():
                return key
        return None

    # -- closed-world matching (concrete node labels) --------------------
    def matched_by_labels(self, labels: "Dict[str, str]") -> bool:
        """k8s node-affinity semantics against a concrete label set: every
        requirement must be satisfied by the node's value for the key, or —
        if the label is absent — the requirement must tolerate absence
        (NotIn / DoesNotExist).
        """
        for key, req in self._reqs.items():
            val = labels.get(key)
            if val is None:
                if not req.matches_absent():
                    return False
            elif not req.matches(val):
                return False
        return True

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Requirements) and self._reqs == other._reqs

    def __hash__(self) -> int:
        if self._hash is None:
            self._hash = hash(frozenset(self._reqs.values()))
        return self._hash

    def __repr__(self) -> str:
        return f"Requirements({', '.join(map(repr, self._reqs.values()))})"
