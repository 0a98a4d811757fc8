"""device_idle_pct.consolidate: the share of the traced window in which no
operation ran on the card."""


def read(ctx):
    return ctx.idle_pct() if ctx.kind == "consolidate" else None
