"""The least time the card could take for a kernel's work.

A frozen copy of `chip_smoke.py`'s `bound_ms` and `_work_ops`, with
their constants: one NVIDIA H100 SXM's published HBM rate and float32
rate outside the tensor cores (NVIDIA's data sheet, at the 700 W power
limit).  The operations are counted by the benchmark's own reference
(`reference/ffd.py` `Answer.work`), never by the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
R = 6


def bound_ms(nbytes: float, ops: float) -> Tuple[float, str]:
    """(ms, which bound): the larger of bytes over the HBM rate and float
    operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def work_ops(work: Dict[str, int]) -> float:
    """Float operations of a scan's work count: 5 per resource for each
    fit (subtract, add, divide, floor, min) and 2 for each all-fits test
    (subtract, compare)."""
    return float((work["fit"] * 5 + work["test"] * 2) * R)
