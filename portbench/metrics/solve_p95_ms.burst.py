"""solve_p95_ms.burst: the 95th percentile of every solve's wall time, from
the call to the answer on the host, over the untraced first half of a
traced run's window (the profiler and the program's spans are off there,
as in an untraced run): a tail over ~500 solves.  It spreads too widely
between runs on a shared host to carry a bound (see PERF.md §2), so it
stands here beside `pods_per_s`."""

import numpy as np


def read(ctx):
    if ctx.kind != "burst" or not ctx.call_s:
        return None
    return float(np.percentile(ctx.call_s, 95)) * 1e3
