"""device_idle_pct.burst: the share of the traced window in which no
operation ran on the card, averaged over the cards the cell uses."""


def read(ctx):
    return ctx.idle_pct() if ctx.kind == "burst" else None
