"""Taints and tolerations — standard k8s semantics.

The reference relies on these for NodePool `spec.template.spec.taints` /
`startupTaints` (pkg/apis/crds/karpenter.sh_nodepools.yaml) and the
`karpenter.sh/disruption=disrupting:NoSchedule` disruption taint
(website/content/en/preview/concepts/disruption.md:29-36).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE

    def __str__(self) -> str:
        return f"{self.key}={self.value}:{self.effect}"


@dataclass(frozen=True)
class Toleration:
    key: str = ""            # "" tolerates every key (operator must be Exists)
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""         # "" tolerates every effect

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key == "":
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


def tolerates_all(taints: Iterable[Taint], tolerations: List[Toleration]) -> bool:
    """True if every hard taint (NoSchedule / NoExecute) is tolerated.
    PreferNoSchedule is soft and never blocks scheduling.
    """
    for taint in taints:
        if taint.effect == PREFER_NO_SCHEDULE:
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False
    return True


def untolerated(taints: Iterable[Taint], tolerations: List[Toleration]) -> List[Taint]:
    return [
        t for t in taints
        if t.effect != PREFER_NO_SCHEDULE
        and not any(tol.tolerates(t) for tol in tolerations)
    ]
