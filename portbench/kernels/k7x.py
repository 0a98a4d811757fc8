"""K7x, the column-sharded scan across the cards of one host
(`csrc/ffd_card_scan.cu`): one rank a card, each holding 1/S of the
catalog's columns, each column reduction an exchange over NVLink.

A rank's share of one solve: K5's bytes and operations for the problem
(`kernels/k5.py`), spread evenly over the S ranks, since every column's
row and every column's fit is one rank's; the per-class rows every rank
reads are counted once, on one rank, so the share stays a lower bound.
"""

from __future__ import annotations

from typing import Dict

from portbench import roofline
from portbench.kernels import k5


def rank_bound_ms(dims: Dict[str, int], work: Dict[str, int],
                  cat: Dict[str, int], S: int) -> float:
    nbytes = k5.catalog_bytes(cat) + k5.problem_bytes(dims)
    return roofline.bound_ms(nbytes / S, roofline.work_ops(work) / S)[0]
