"""Operator: options, feature gates, leader election and the runnable
operator process (reference: pkg/operator + pkg/operator/options;
`leaderelection.py`'s leases and elector, `operator.py`'s `Operator`)."""

from karpenter_tpu_torch.operator.options import FeatureGates, Options

__all__ = ["Options", "FeatureGates", "Operator"]


def __getattr__(name):
    # lazy: the operator imports the whole environment (and torch), which
    # the options' importers do not need
    if name == "Operator":
        from karpenter_tpu_torch.operator.operator import Operator
        return Operator
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
