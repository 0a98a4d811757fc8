"""The CloudProvider seam — the big interface between core controllers and
the cloud (reference: pkg/cloudprovider/cloudprovider.go:55-238).
"""

from karpenter_tpu_torch.cloudprovider.provider import (
    CloudProviderError,
    InsufficientCapacity,
    NodeClassNotReady,
    TPUCloudProvider,
    MAX_INSTANCE_TYPES,
)

__all__ = [
    "CloudProviderError",
    "InsufficientCapacity",
    "NodeClassNotReady",
    "TPUCloudProvider",
    "MAX_INSTANCE_TYPES",
]
