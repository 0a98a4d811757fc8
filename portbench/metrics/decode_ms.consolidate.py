"""decode_ms.consolidate: host milliseconds a simulation spends being
decoded, from the phase histogram's decode phase on the sweep and batch
paths, over the window's simulations."""


def read(ctx):
    if ctx.kind != "consolidate" or not ctx.sims:
        return None
    s = ctx.phase_s(("decode",), ("sweep", "batch"))
    return s / ctx.sims * 1e3 if s > 0 else None
