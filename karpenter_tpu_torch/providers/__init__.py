"""Cloud-resource providers: the instance-type catalog."""

from karpenter_tpu_torch.providers.catalog import CatalogSpec, generate_catalog

__all__ = ["generate_catalog", "CatalogSpec"]
