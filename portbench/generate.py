"""The one traffic generator: plain inputs from a configuration, a traffic
mix and a seed.

A configuration (`configs/<name>.json`) fixes the deployment: the catalog
table, the NodePools, the pod classes a burst is made of (requests in
solver units, a zone pin, whether the pods tolerate the dedicated taint,
and how many), or the fleet a consolidation pass judges.  A traffic mix
(`traffic/<mix>.json`) fixes how requests arrive: `"kind": "burst"` is a
closed loop of fresh bursts from a ring of `ring` seeded bursts, each
class's count moved by up to `count_jitter` of it in opposite directions
on paired bursts (so a whole ring holds the configuration's counts
exactly); `"kind": "consolidate"` is a closed loop of calls of `sims`
simulations, `"mode": "single"` one candidate node each, or `"mode":
"prefix"` the `sims` longest nested prefixes of a seed-drawn order of
`candidates` nodes.

Frozen copies, rewritten to make plain data from `--seed`:
`karpenter_tpu_torch/workloads.py` `build_input`/`headline_pods`
(`burst50k`), `build_config2` (`mixed5k`: the class counts are those of
its index rules over 5,000 pods), `_consolidation_cluster`/
`_consolidation_sweep` (`consolidate2k`).

A plain problem is a dict: `pods` {"name": [str], "requests": [n, 6]
float64, "zone": [str | None], "tolerate": [bool]}, `pools`,
`tolerations` (what a tolerating pod carries), `table` (the catalog's
name), `max_nodes`, `price_cap`, and for a simulation `existing`
{"name", "labels", "available", "pods"} and `excluded` (indices into the
fleet).  `adapter.py` turns one into the program's objects; the
reference reads it as it is.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from portbench import catalog

_DIR = os.path.dirname(os.path.abspath(__file__))
SEED_MOD = 2 ** 63


def load_config(name: str) -> Dict:
    with open(os.path.join(_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def load_traffic(name: str) -> Dict:
    with open(os.path.join(_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed (any whole number)."""
    return np.random.default_rng([int(seed) % SEED_MOD, *stream])


def _request_rows(classes: List[Dict]) -> np.ndarray:
    return np.array([catalog.vector(c["requests"]) for c in classes],
                    dtype=np.float64)


def _ring_counts(classes: List[Dict], ring: int, jitter: float,
                 g: np.random.Generator) -> List[np.ndarray]:
    """Per burst of the ring, each class's count: the configuration's,
    moved by a zero-sum draw of at most `jitter` of it, +d on one burst of
    a pair and -d on the other."""
    base = np.array([c["count"] for c in classes], dtype=np.int64)
    out = []
    for _ in range(0, ring, 2):
        lim = np.floor(base * jitter).astype(np.int64)
        d = np.array([g.integers(-x, x + 1) if x else 0 for x in lim],
                     dtype=np.int64)
        d[-1] -= d.sum()            # the burst keeps its size
        if abs(d[-1]) > base[-1]:
            d[:] = 0
        out += [base + d, base - d]
    return out[:ring]


def bursts(cfg: Dict, traffic: Dict, seed: int) -> List[Dict]:
    """The ring of seeded bursts of one run."""
    classes = cfg["classes"]
    rows = _request_rows(classes)
    g = rng(seed, 1)
    ring = int(traffic["ring"])
    out = []
    for slot, counts in enumerate(_ring_counts(
            classes, ring, float(traffic.get("count_jitter", 0.0)), g)):
        cls = np.repeat(np.arange(len(classes)), counts)
        cls = cls[g.permutation(len(cls))]
        zones = [c.get("zone") for c in classes]
        tols = [bool(c.get("tolerate", False)) for c in classes]
        out.append({
            "pods": {"name": [f"b{slot}-{i}" for i in range(len(cls))],
                     "requests": rows[cls],
                     "zone": [zones[k] for k in cls],
                     "tolerate": [tols[k] for k in cls]},
            "pools": cfg["pools"],
            "tolerations": cfg.get("tolerations", []),
            "table": cfg["catalog"],
            "max_nodes": int(cfg["max_nodes"]),
            "price_cap": cfg.get("price_cap"),
        })
    return out


def fleet(cfg: Dict) -> Dict:
    """The consolidation fleet: node i in zone i % zones, capacity types
    in turn, each holding one pod."""
    n = int(cfg["nodes"])
    alloc = np.array(catalog.vector(cfg["node_allocatable"]))
    req = np.array(catalog.vector(cfg["pod_requests"]))
    zones = catalog.ZONES[:int(cfg["zones"])]
    cts = cfg["capacity_types"]
    labels = [{catalog.ZONE: zones[i % len(zones)],
               catalog.CAPACITY_TYPE: cts[i % len(cts)],
               catalog.NODEPOOL: cfg["pools"][0]["name"],
               catalog.ARCH: "amd64", catalog.OS: "linux",
               catalog.HOSTNAME: f"n{i}"} for i in range(n)]
    return {"name": [f"n{i}" for i in range(n)], "labels": labels,
            "allocatable": np.tile(alloc, (n, 1)),
            "available": np.tile(alloc - req, (n, 1)),
            "pods": [f"p{i}" for i in range(n)],
            "pod_requests": req}


def candidate_sets(cfg: Dict, traffic: Dict, seed: int, call: int
                   ) -> List[List[int]]:
    """The candidate node indices of each simulation of call `call`."""
    g = rng(seed, 2, call)
    n = int(cfg["nodes"])
    sims = int(traffic["sims"])
    if traffic["mode"] == "single":
        return [[int(i)] for i in g.choice(n, sims, replace=False)]
    order = g.choice(n, int(traffic["candidates"]), replace=False)
    return [[int(i) for i in order[:k]]
            for k in range(len(order), len(order) - sims, -1)]


def simulation(cfg: Dict, fl: Dict, excluded: List[int]) -> Dict:
    """One simulation: the candidates' pods against the rest of the
    fleet."""
    keep = np.ones(len(fl["name"]), dtype=bool)
    keep[excluded] = False
    idx = np.nonzero(keep)[0]
    k = len(excluded)
    return {
        "pods": {"name": [fl["pods"][i] for i in excluded],
                 "requests": np.tile(fl["pod_requests"], (k, 1)),
                 "zone": [None] * k, "tolerate": [False] * k},
        "existing": {"name": [fl["name"][i] for i in idx],
                     "labels": [fl["labels"][i] for i in idx],
                     "available": fl["available"][idx]},
        "excluded": list(excluded),
        "pools": cfg["pools"],
        "tolerations": cfg.get("tolerations", []),
        "table": cfg["catalog"],
        "max_nodes": int(cfg["max_nodes"]),
        "price_cap": cfg.get("price_cap"),
    }
