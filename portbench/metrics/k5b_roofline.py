"""k5b_roofline: K5's share of its roofline at B = 64, the generic batch
of the multi-node consolidation cell: `kernels/k5.py` over 64 problems
against the device time of its launches in the traced run."""


def read(ctx):
    return ctx.roofline_pct("K5") if ctx.kind == "consolidate" else None
