"""Cloud-resource providers: catalog, instance types, pricing, fake cloud
and the cloud plumbing (reference: pkg/providers/*).

Each provider wraps one slice of cloud state behind caches, and the fake
cloud backend replaces AWS exactly the way pkg/fake does.  The port has
every provider of the reference, the batched cloud
(`providers/batched_cloud.py`) and the transcribed EC2 catalog
(`providers/ec2_catalog.py`) among them."""

from karpenter_tpu_torch.providers.catalog import CatalogSpec, generate_catalog
from karpenter_tpu_torch.providers.fake_cloud import CloudInstance, FakeCloud
from karpenter_tpu_torch.providers.batched_cloud import BatchedCloud
from karpenter_tpu_torch.providers.imagefamily import ImageProvider
from karpenter_tpu_torch.providers.instanceprofile import (
    InstanceProfileProvider,
)
from karpenter_tpu_torch.providers.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.providers.launchtemplate import (
    LaunchTemplateProvider,
)
from karpenter_tpu_torch.providers.pricing import PricingProvider
from karpenter_tpu_torch.providers.queue import QueueProvider
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider
from karpenter_tpu_torch.providers.version import VersionProvider

__all__ = [
    "generate_catalog",
    "CatalogSpec",
    "PricingProvider",
    "InstanceTypeProvider",
    "FakeCloud",
    "CloudInstance",
    "BatchedCloud",
    "ImageProvider",
    "InstanceProfileProvider",
    "LaunchTemplateProvider",
    "QueueProvider",
    "SecurityGroupProvider",
    "SubnetProvider",
    "VersionProvider",
]
