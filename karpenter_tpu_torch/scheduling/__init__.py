"""Scheduling: shared semantics (inputs, results, topology, spot risk).

The CPU oracle scheduler of `karpenter_tpu.scheduling.oracle` is not
ported yet; the solver reports what it would hand to the oracle as
`UnsupportedPods`.
"""

from karpenter_tpu_torch.scheduling.types import (
    ExistingNode,
    NewNodeClaim,
    ScheduleInput,
    ScheduleResult,
)

__all__ = [
    "ExistingNode",
    "NewNodeClaim",
    "ScheduleInput",
    "ScheduleResult",
]
