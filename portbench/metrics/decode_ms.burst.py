"""decode_ms.burst: host milliseconds a solve spends pulling the kernel's
result and decoding it into node claims (`solver/ffd.py` `unpack`,
`solve.py` `_decode`, `solver/explain.py`), from the same histogram's
pull and decode phases on the solve path, over the window's solves."""


def read(ctx):
    if ctx.kind != "burst" or not ctx.calls:
        return None
    s = ctx.phase_s(("pull", "decode"), ("solve",))
    return s / ctx.calls * 1e3 if s > 0 else None
