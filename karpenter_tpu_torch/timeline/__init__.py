"""Cluster timeline: the recorder, the event registry, the trajectory
invariants, the seeded generators and the rewind engine.

The package is split so the recorder half stays import-light (it is on
the `Cluster.mutated` hot path): this __init__ exposes only the event
registry and the recorder.  The heavyweight halves — `rewind` (builds an
Environment / Operator), `generators`, and `invariants` — are imported
explicitly by their consumers.  The port's copy of
`karpenter_tpu/timeline/`.
"""

from karpenter_tpu_torch.timeline import events  # noqa: F401
from karpenter_tpu_torch.timeline.recorder import (  # noqa: F401
    RECORDER,
    emit,
    load_events,
    pod_spec,
    record_store_mutation,
    recording_enabled,
)
