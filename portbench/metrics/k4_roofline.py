"""k4_roofline: K4's share of its roofline: `kernels/k4.py` over a call's
64 simulations against the device time of its
`scan_kernel<false, true, false, false, 0>` launches in the traced run."""


def read(ctx):
    return ctx.roofline_pct("K4") if ctx.kind == "consolidate" else None
