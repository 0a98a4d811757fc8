"""The device trace of a `--trace 1` run, and what is read from it.

`DeviceTrace` holds `torch.profiler` (CPU and CUDA activities) open over
the measured window.  Afterwards `summary()` gives, per card, the device
operations (kernels, copies, sets) inside the window with their times,
the busy time (the union of those operations), and the idle gaps between
them, each split by the host span that was open at the time: the
innermost of the program's `tracing` spans (`solver.phase.*` and their
parents), or `host.outside_spans`.  Profiler times are aligned to the
host's wall clock by a marker: with every card idle, a one-element fill
on card 0 is enqueued right after a `time.time()` reading, so the
trace's first device operation starts at that reading (give or take the
launch's few microseconds).
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

_SCAN = re.compile(r"(?:witness_)?scan_kernel<([^>]*)>")


def kernel_class(name: str) -> Optional[str]:
    """K5, K4, K6, K7 or K7x for an instance of the scan template
    (`scan_kernel<TOPO, SWEEP, GANG, SEED, SHARDED>`), else None."""
    m = _SCAN.search(name.replace(" ", ""))
    if m is None:
        return None
    args = [a.split(")")[-1] for a in m.group(1).split(",")]
    flag = [a in ("true", "1") for a in args[:4]]
    shard = int(args[4]) if len(args) > 4 and args[4].isdigit() else 0
    if shard == 2:
        return "K7x"
    if shard == 1:
        return "K7"
    if flag[1]:
        return "K4"
    if flag[3]:
        return "K6"
    return "K5"


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _label_segments(spans: Sequence[Tuple[float, float, str]]
                    ) -> Tuple[List[float], List[str]]:
    """The host timeline cut where the innermost open span changes:
    boundaries and the label of each piece (None where no span is open)."""
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    labels: List[Optional[str]] = []
    by_start = sorted(spans)
    starts = [s[0] for s in by_start]
    for i in range(len(cuts) - 1):
        mid = (cuts[i] + cuts[i + 1]) / 2
        best = None
        # the open span that started last is the innermost
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0:
            a, b, name = by_start[j]
            if b > mid:
                best = name
                break
            j -= 1
        labels.append(best)
    return cuts, labels


class DeviceTrace:
    def __init__(self, cards: int):
        from torch.profiler import ProfilerActivity, profile
        self.cards = cards
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.wall0 = None
        self.wall1 = None

    def __enter__(self):
        import torch
        self._prof.__enter__()
        for d in range(self.cards):
            torch.cuda.synchronize(d)
        self.wall0 = time.time()
        if self.cards:
            torch.ones(1, device="cuda:0")
        return self

    def close_window(self) -> None:
        """The window's end, on the wall clock (call after the last
        synchronised answer)."""
        self.wall1 = time.time()

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def summary(self, spans: Sequence[Tuple[float, float, str]]) -> Dict:
        devices = range(max(self.cards, 1))
        evs = [e for e in self._prof.events()
               if getattr(e.device_type, "name", "") == "CUDA"]
        first = min((e.time_range.start for e in evs
                     if e.device_index == 0), default=0.0)
        off = self.wall0 - first / 1e6
        lo, hi = self.wall0, self.wall1
        ops: Dict[int, List[Tuple[float, float, str]]] = {d: [] for d in
                                                         devices}
        for e in evs:
            a = e.time_range.start / 1e6 + off
            b = e.time_range.end / 1e6 + off
            if b <= lo or a >= hi or e.device_index not in ops:
                continue
            ops[e.device_index].append((max(a, lo), min(b, hi), e.name))
        cuts, labels = _label_segments(spans)
        per_dev = {}
        for d, lst in ops.items():
            busy = _union([(a, b) for a, b, _ in lst])
            busy_s = sum(b - a for a, b in busy)
            gaps, t = [], lo
            for a, b in busy:
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if hi > t:
                gaps.append((t, hi))
            idle: Dict[str, float] = {}
            for a, b in gaps:
                pts = ([a] + cuts[bisect.bisect_right(cuts, a):
                                  bisect.bisect_left(cuts, b)] + [b])
                for x, y in zip(pts, pts[1:]):
                    i = bisect.bisect_right(cuts, (x + y) / 2) - 1
                    lab = labels[i] if 0 <= i < len(labels) else None
                    key = lab or "host.outside_spans"
                    idle[key] = idle.get(key, 0.0) + (y - x)
            per_dev[d] = {"ops": lst, "busy_s": busy_s, "idle": idle}
        return {"window_s": hi - lo, "devices": per_dev}
