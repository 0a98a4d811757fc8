"""Scheduling: shared semantics (inputs, results, topology, spot risk) and
the CPU oracle scheduler, the reference first-fit-decreasing bin-packer
the solver hands its inexpressible groups and stranded pods to."""

from karpenter_tpu_torch.scheduling.types import (
    ExistingNode,
    NewNodeClaim,
    ScheduleInput,
    ScheduleResult,
)
from karpenter_tpu_torch.scheduling.oracle import Scheduler

__all__ = [
    "ExistingNode",
    "NewNodeClaim",
    "ScheduleInput",
    "ScheduleResult",
    "Scheduler",
]
