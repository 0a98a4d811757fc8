"""The instance-type catalog a cell runs against, as plain data.

`catalogs/generated605.json` is a frozen copy of the port's checked-in
default catalog (`karpenter_tpu_torch/providers/generated/
catalog_default.json`, written by `hack/gen_catalog.py`): 605 types in
name order, each offered on demand and as spot in 3 zones, standing for
the ~700 EC2 types the upstream provider describes.  The benchmark owns
this copy, so the yardstick does not move when the program's table does;
the program is handed the same table through its own loader
(`adapter.py`), the reference reads it here.

A type is {"name", "capacity": {axis: value}, "overhead": {...},
"labels": {key: value}, "offerings": [[zone, capacity_type, price,
available], ...]}; `vectors` turns the maps into lists over
`RESOURCE_AXIS` (cpu millicores, memory MiB, ephemeral storage MiB, pods,
gpus, volume slots).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

RESOURCE_AXIS = ("cpu", "memory", "ephemeral-storage", "pods", "gpu",
                 "volumes")
R = len(RESOURCE_AXIS)
AXIS = {name: i for i, name in enumerate(RESOURCE_AXIS)}

ZONE = "topology.kubernetes.io/zone"
CAPACITY_TYPE = "karpenter.sh/capacity-type"
NODEPOOL = "karpenter.sh/nodepool"
HOSTNAME = "kubernetes.io/hostname"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
ZONES = ("tpu-west-1a", "tpu-west-1b", "tpu-west-1c")

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "catalogs")


def load_table(name: str) -> Dict:
    """The raw table `catalogs/<name>.json` ({"types": [...]})."""
    with open(os.path.join(_DIR, f"{name}.json")) as f:
        return json.load(f)


def vector(m: Dict[str, float]) -> List[float]:
    v = [0.0] * R
    for k, x in m.items():
        v[AXIS[k]] = float(x)
    return v
