"""Operator: options, feature gates and leader election (reference:
pkg/operator/options; `leaderelection.py`'s leases and elector).

The operator's wiring (`operator.py`) is still to port (slice 5d)."""

from karpenter_tpu_torch.operator.options import FeatureGates, Options

__all__ = ["Options", "FeatureGates"]
