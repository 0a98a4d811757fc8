"""K5, the batched FFD scan (`csrc/ffd_batch_scan.cu`): one launch of B
problems that share a catalog; one solve is B = 1.

Bytes: each input the light scan reads, once — the catalog's columns
(allocatable and daemonset rows, pool, zone and capacity type) and its
(pool, type) rows, each class's request, count, column bits, node cap and
whole flag, each existing node's remaining capacity and per-class
allowance, the pool budgets — and each output once, at the size the
answer needs: the per-class takes of the existing and opened nodes,
strand counts, and the opened nodes' used rows, pool, zone and capacity
type.  Operations: the reference's fits and tests for these inputs.
"""

from __future__ import annotations

from typing import Dict

from portbench import roofline

R = roofline.R


def problem_bytes(d: Dict[str, int]) -> int:
    G, E, O, P, N = d["G"], d["E"], d["O"], d["P"], d["N"]
    W = (O + 31) // 32
    inputs = 4 * (G * (R + 4 + W) + G * E + E * R + P * R)
    outputs = 4 * (G * E + G * N + G + N * (R + 3) + 1)
    return inputs + outputs


def catalog_bytes(d: Dict[str, int]) -> int:
    O, PT, P = d["O"], d["PT"], d["P"]
    W = (O + 31) // 32
    return 4 * (O * (2 * R + 3) + PT * R + P * (R + W))


def bound_ms(problems, cat: Dict[str, int]) -> float:
    """One launch over `problems`, each (dims, work)."""
    nbytes = catalog_bytes(cat) + sum(problem_bytes(d) for d, _ in problems)
    ops = sum(roofline.work_ops(w) for _, w in problems)
    return roofline.bound_ms(nbytes, ops)[0]
