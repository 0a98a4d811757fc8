"""k7x_roofline: one rank's share of K7x's roofline: `kernels/k7x.py`'s
rank bound of each solve against the device time of the rank's
`scan_kernel<..., 2>` launches on its card, averaged over the cards."""


def read(ctx):
    return ctx.roofline_pct("K7x") if ctx.kind == "burst" else None
