"""sweep_share_pct: the share of the window's simulations that the sweep
(K4) answered, from the program's kernel launch counters
(`ffd.launch_counts()`, read before and after each call): a call's
simulations count for the sweep in the proportion of its K4 launches to
its K4 and K5 launches."""


def read(ctx):
    if ctx.kind != "consolidate" or not ctx.sims:
        return None
    return 100.0 * ctx.sweep_sims / ctx.sims
