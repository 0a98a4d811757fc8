"""encode_ms.consolidate: host milliseconds a simulation spends in the
sweep's and the generic batch's encode (`solver/solve.py` `_try_sweep`,
`solve_batch`), from the phase histogram's encode phase on the sweep and
batch paths, over the window's simulations."""


def read(ctx):
    if ctx.kind != "consolidate" or not ctx.sims:
        return None
    s = ctx.phase_s(("encode",), ("sweep", "batch"))
    return s / ctx.sims * 1e3 if s > 0 else None
