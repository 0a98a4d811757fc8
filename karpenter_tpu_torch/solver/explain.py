"""Placement provenance vocabulary: the fit-slack epsilon, the constraint
classes, the reason codes the solve path emits, and the explain-mode gate.

The port's copy of the parts of `karpenter_tpu/solver/explain.py` that the
single-problem solve reads.  Codes, constraint names and the
``KARPENTER_TPU_EXPLAIN`` grammar are identical, so a verdict from either
package carries the same `.code`.  The per-pod reason trees
(``build_tree``) are not carried yet; the oracle's verdicts carry the
codes and per-nodepool causes it registers (`scheduling/oracle.py`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

# the fit-slack epsilon: every fit test (`floor((avail + EPS) / req)` and
# the `>= -EPS` subtract-compares) uses this one value, as float32
EPS = 1e-3

# -- constraint classes (canonical order) ---------------------------------
# The kernel's aux counts rows use KERNEL_CONSTRAINTS order, and the
# reason bitset's bit i is KERNEL_CONSTRAINTS[i].
HOST_CONSTRAINTS = ("compat", "price")
KERNEL_CONSTRAINTS = ("fit", "limit", "topology", "whole_node", "slots")
CONSTRAINTS = HOST_CONSTRAINTS + KERNEL_CONSTRAINTS + ("gang", "priority")


# -- reason codes ----------------------------------------------------------
class ReasonSpec:
    __slots__ = ("code", "constraint", "summary")

    def __init__(self, code: str, constraint: str, summary: str):
        assert constraint in CONSTRAINTS + ("none",), constraint
        self.code = code
        self.constraint = constraint
        self.summary = summary


REGISTRY: Dict[str, ReasonSpec] = {}


def _register(code: str, constraint: str, summary: str) -> str:
    REGISTRY[code] = ReasonSpec(code, constraint, summary)
    return code


# kernel strands (solver/solve.py _unsched_reason + decode)
NO_NODEPOOL = _register(
    "NoNodepoolCompatible", "compat",
    "no nodepool's template/taints/types are compatible with the pod")
TOPOLOGY = _register(
    "TopologyUnsatisfiable", "topology",
    "every allowed domain is at its skew ceiling or out of capacity")
CAPACITY = _register(
    "CapacityExhausted", "fit",
    "every compatible node/instance-type combination is exhausted or "
    "over limits")
NO_INSTANCE_TYPES = _register(
    "NoInstanceTypes", "compat",
    "no purchasable instance types and existing capacity is full")
NO_SURVIVING_TYPE = _register(
    "NoSurvivingType", "fit",
    "no instance type survives the node's accumulated requirements")
MIN_VALUES = _register(
    "MinValuesViolated", "compat",
    "the surviving type set exposes fewer distinct label values than "
    "the nodepool's minValues")
# oracle verdicts (scheduling/oracle.py)
POOL_LIMIT = _register(
    "PoolLimitExceeded", "limit",
    "a binding nodepool limit blocked the placement (oracle authority)")
# gang scheduling verdicts of the oracle's atomic gang pre-pass, always
# for the WHOLE gang (one member's verdict is every member's verdict)
GANG_PARTIAL = _register(
    "GangPartiallyPlaceable", "gang",
    "the best adjacency domain can hold some but not all gang members "
    "— the gang strands whole rather than split (tree carries the "
    "nearest domain and the deficit)")
GANG_DOMAIN = _register(
    "GangDomainExhausted", "gang",
    "no adjacency domain can currently hold any gang member — every "
    "eligible domain is out of capacity or ineligible")
GANG_TOO_LARGE = _register(
    "GangTooLarge", "gang",
    "the gang's member count exceeds what any single adjacency domain "
    "could hold even on an empty fleet at the solver's node ceiling")
GANG_INCOMPLETE = _register(
    "GangIncomplete", "gang",
    "the pending member count (plus members already bound on live "
    "nodes) does not match the gang-size annotation (fewer: placement "
    "waits for the full gang; more: fix gang-size — an over-full gang "
    "never self-heals by waiting)")
GANG_CODES = frozenset((GANG_PARTIAL, GANG_DOMAIN, GANG_TOO_LARGE,
                        GANG_INCOMPLETE))
LEGACY = "Legacy"  # unregistered plain-string reason (should not occur)

# per-nodepool cause vocabulary for the oracle's open-new cascade
# (scheduling/oracle.py `_open_new`): each blocked pool names exactly one
# of these in the reason tree
CAUSE_NO_TYPES = "NoInstanceTypes"
CAUSE_TAINTS = "TaintsNotTolerated"
CAUSE_UNKNOWN_LABEL = "UnknownLabel"
CAUSE_INCOMPATIBLE = "IncompatibleRequirements"
CAUSE_LIMITS = "LimitsExceeded"
CAUSE_NO_FIT = "NoFittingType"
CAUSE_TOPOLOGY = "TopologyUnsatisfiable"


class Reason(str):
    """An unschedulability reason: the human-readable string plus the
    structured `.code` and an optional `.tree`."""

    def __new__(cls, code: str, detail: str, tree: Optional[dict] = None):
        s = super().__new__(cls, detail)
        s.code = code
        s.tree = tree
        return s

    def __reduce__(self):
        return (Reason, (self.code, str(self), self.tree))


def make(code: str, detail: str, tree: Optional[dict] = None) -> Reason:
    """The one constructor verdict emitters use; unregistered codes raise."""
    if code not in REGISTRY:
        raise ValueError(f"unregistered reason code {code!r}")
    return Reason(code, detail, tree)


def code_of(reason) -> str:
    """The structured code of any reason value; plain strings map to
    LEGACY rather than raising."""
    return getattr(reason, "code", LEGACY)


def constraint_of(code: str) -> str:
    spec = REGISTRY.get(code)
    return spec.constraint if spec is not None else "none"


# -- the gate --------------------------------------------------------------
MODE_OFF, MODE_COUNTS, MODE_FULL = 0, 1, 2
_ENV = "KARPENTER_TPU_EXPLAIN"
_MODE_NAMES = {MODE_OFF: "off", MODE_COUNTS: "counts", MODE_FULL: "full"}


def mode() -> int:
    """KARPENTER_TPU_EXPLAIN=off|counts|full (default counts).  Malformed
    values degrade to the default, never crash."""
    raw = os.environ.get(_ENV, "").strip().lower()
    if raw in ("off", "0", "false", "no", "none"):
        return MODE_OFF
    if raw == "full":
        return MODE_FULL
    return MODE_COUNTS


def mode_name(m: int) -> str:
    return _MODE_NAMES.get(m, "counts")
