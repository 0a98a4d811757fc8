"""encode_ms.burst: host milliseconds a solve spends grouping its pods and
encoding the problem (`solver/encode.py` via `solver/solve.py`), from the
program's `karpenter_tpu_solver_phase_duration_seconds` histogram: its
pregroup and encode phases on the solve path, summed over the window,
over the window's solves."""


def read(ctx):
    if ctx.kind != "burst" or not ctx.calls:
        return None
    s = ctx.phase_s(("pregroup", "encode"), ("solve",))
    return s / ctx.calls * 1e3 if s > 0 else None
