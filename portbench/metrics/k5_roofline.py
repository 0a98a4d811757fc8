"""k5_roofline: K5's share of its roofline in the burst cells: the least
time the card could take for the window's K5 launches (`kernels/k5.py`)
over the device time of its `scan_kernel<true, false, false, false, 0>`
launches in the traced run."""


def read(ctx):
    return ctx.roofline_pct("K5") if ctx.kind == "burst" else None
