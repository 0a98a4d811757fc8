"""The solver service boundary: control-plane replicas talk to one
card-owning solver process over a framed unix socket.

The port's copy of `karpenter_tpu/service/`.  The daemon is the same
`native/solverd.cc` (C++: socket IO, threading and the request-coalescing
window), started with `--module karpenter_tpu_torch.service.backend`: its
embedded interpreter hands each window's batch to `backend.handle_batch`,
where bucket-compatible requests fuse, across tenants, into one
`TorchSolver.solve_batch` — one K5 launch of B problems on the card.

Crash isolation: the daemon runs as a disposable WORKER under
`SolverdSupervisor` (restart-on-crash with backoff); the client carries
the availability layer — shared `RetryPolicy`, `CircuitBreaker`, and
per-request deadlines — so the control plane degrades to its in-process
solver instead of hanging when the worker dies.
"""

from karpenter_tpu_torch.service.client import (
    SolverServiceClient,
    SolverServiceError,
    SolverServiceShed,
    SolverServiceTransportError,
    SolverServiceUnavailable,
)
from karpenter_tpu_torch.service.resilience import CircuitBreaker, RetryPolicy
from karpenter_tpu_torch.service.scheduler import TenantScheduler
from karpenter_tpu_torch.service.supervisor import SolverdSupervisor

__all__ = [
    "SolverServiceClient",
    "SolverServiceError",
    "SolverServiceShed",
    "SolverServiceTransportError",
    "SolverServiceUnavailable",
    "CircuitBreaker",
    "RetryPolicy",
    "SolverdSupervisor",
    "TenantScheduler",
]
