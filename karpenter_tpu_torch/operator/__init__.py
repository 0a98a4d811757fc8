"""Operator: options and feature gates (reference: pkg/operator/options).

The operator's wiring (`operator.py`) and leader election
(`leaderelection.py`) are still to port (slice 5c)."""

from karpenter_tpu_torch.operator.options import FeatureGates, Options

__all__ = ["Options", "FeatureGates"]
