"""The port's model and catalog copies against the JAX package's: the same
generated catalog (names, allocatable, offerings, prices to the bit), the
same quantity parsing, and a catalog table round-trip between packages."""

import pytest

from karpenter_tpu.models import Resources as JResources
from karpenter_tpu.models.resources import parse_quantity as j_parse
from karpenter_tpu.providers import generate_catalog as j_generate
from karpenter_tpu.providers.catalog import CatalogSpec as JSpec
from karpenter_tpu.providers.catalog import dump_catalog as j_dump
from karpenter_tpu_torch.models import Resources as TResources
from karpenter_tpu_torch.models.resources import RESOURCE_AXIS as T_AXIS
from karpenter_tpu_torch.models.resources import parse_quantity as t_parse
from karpenter_tpu_torch.providers import CatalogSpec as TSpec
from karpenter_tpu_torch.providers import generate_catalog as t_generate
from karpenter_tpu_torch.providers.catalog import catalog_from_table
from karpenter_tpu_torch.providers.catalog import dump_catalog as t_dump


def _labels(it):
    out = {}
    for req in it.requirements:
        out[req.key] = (req.is_finite(), tuple(sorted(req.values()))
                        if req.is_finite() else None)
    return out


def _catalog_key(catalog):
    return [
        (it.name, tuple(x.hex() for x in it.allocatable().v),
         tuple(x.hex() for x in it.capacity.v),
         tuple(x.hex() for x in it.overhead.v),
         tuple((o.zone, o.capacity_type, float(o.price).hex(), o.available)
               for o in it.offerings),
         sorted(_labels(it).items()))
        for it in catalog]


SPECS = {
    "default": (None, None),
    "small-no-gpu": (dict(max_types=40, include_gpu=False),) * 2,
    "two-zones": (dict(zones=["z-a", "z-b"], generations=[6, 7]),) * 2,
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_generate_catalog_matches_reference(spec):
    jkw, tkw = SPECS[spec]
    jcat = j_generate(JSpec(**jkw) if jkw else None)
    tcat = t_generate(TSpec(**tkw) if tkw else None)
    assert len(tcat) == len(jcat)
    assert _catalog_key(tcat) == _catalog_key(jcat)


def test_default_catalog_has_605_types():
    assert len(t_generate()) == 605


def test_catalog_from_reference_table_round_trips():
    jcat = j_generate()
    tcat = catalog_from_table(j_dump(jcat))
    assert _catalog_key(tcat) == _catalog_key(jcat)
    assert t_dump(tcat) == j_dump(jcat)


@pytest.mark.parametrize("q", ["250m", "1", "1.5", "512Mi", "2Gi", "100k",
                               "3e2", "0.1", "7Ti", 4, 2.5])
def test_quantity_parsing_matches(q):
    assert t_parse(q).hex() == j_parse(q).hex()


def test_resource_axis_and_parse_match():
    spec = {"cpu": "500m", "memory": "1Gi", "nvidia.com/gpu": 1,
            "ephemeral-storage": "10Gi", "pods": 3}
    assert T_AXIS == ("cpu", "memory", "ephemeral-storage", "pods", "gpu",
                      "volumes")
    assert ([x.hex() for x in TResources.parse(spec).v]
            == [x.hex() for x in JResources.parse(spec).v])
