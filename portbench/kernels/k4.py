"""K4, the consolidation sweep (`csrc/ffd_sweep_scan.cu`, its light
lane): one launch of B simulations of one cluster snapshot, each the
snapshot minus a few candidate nodes.

Bytes: the snapshot's node rows (remaining capacity, zone, capacity type)
and the catalog once for the launch; each simulation's class rows
(request, count, class index), exclusions and price cap; each output at
the size the answer needs (the placements onto existing nodes as
(count, index) pairs, strand counts, opened nodes).  Operations: the
reference's fits and tests of each simulation.
"""

from __future__ import annotations

from typing import Dict

from portbench import roofline
from portbench.kernels import k5

R = roofline.R


def sim_bytes(d: Dict[str, int]) -> int:
    G, X, N, placed = d["G"], d["X"], d["N"], d["placed"]
    inputs = 4 * (G * (R + 2) + X + 1)
    outputs = 4 * (2 * placed + G + G * N + N * (R + 3) + 1)
    return inputs + outputs


def bound_ms(sims, snapshot_nodes: int, classes: int,
             cat: Dict[str, int]) -> float:
    """One launch over `sims`, each (dims, work)."""
    W = (cat["O"] + 31) // 32
    nbytes = (k5.catalog_bytes(cat) + 4 * snapshot_nodes * (R + 2)
              + 4 * classes * (W + snapshot_nodes)
              + sum(sim_bytes(d) for d, _ in sims))
    ops = sum(roofline.work_ops(w) for _, w in sims)
    return roofline.bound_ms(nbytes, ops)[0]
