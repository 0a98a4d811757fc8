"""Cloud-resource providers: catalog, instance types, pricing, images and
the fake cloud (reference: pkg/providers/*).

The port has the generated instance-type catalog, the fake cloud, the
pricing and instance-type providers and the image-family resolver the
instance-type provider reads.  The batched cloud, the launch-template,
subnet, security-group, instance-profile, queue and version providers are
still to port (slice 5b)."""

from karpenter_tpu_torch.providers.catalog import CatalogSpec, generate_catalog
from karpenter_tpu_torch.providers.fake_cloud import CloudInstance, FakeCloud
from karpenter_tpu_torch.providers.imagefamily import ImageProvider
from karpenter_tpu_torch.providers.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.providers.pricing import PricingProvider

__all__ = [
    "generate_catalog",
    "CatalogSpec",
    "PricingProvider",
    "InstanceTypeProvider",
    "FakeCloud",
    "CloudInstance",
    "ImageProvider",
]
