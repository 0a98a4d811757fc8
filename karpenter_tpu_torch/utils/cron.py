"""Minimal 5-field cron evaluation for disruption-budget windows.

Reference: NodePool.spec.disruption.budgets carry `schedule` (standard
cron, UTC) + `duration`; a budget is ACTIVE while now lies within
[latest schedule fire, fire + duration] (karpenter.sh_nodepools.yaml
budget fields; website/.../disruption.md budget scheduling). The
reference uses robfig/cron; this is the dependency-free equivalent for
the subset the CRD allows: numbers, `*`, lists, ranges, and `*/step`,
with the standard OR rule when both day-of-month and day-of-week are
restricted.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import Optional, Set, Tuple

_BOUNDS = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))
# name forms the reference's robfig ParseStandard accepts
_MONTHS = {n: i + 1 for i, n in enumerate(
    ("JAN", "FEB", "MAR", "APR", "MAY", "JUN",
     "JUL", "AUG", "SEP", "OCT", "NOV", "DEC"))}
_DOWS = {n: i for i, n in enumerate(
    ("SUN", "MON", "TUE", "WED", "THU", "FRI", "SAT"))}
_MACROS = {
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
}


class CronError(ValueError):
    pass


def _to_int(tok: str, names: dict) -> int:
    up = tok.upper()
    if up in names:
        return names[up]
    try:
        return int(tok)
    except ValueError:
        raise CronError(f"bad cron token {tok!r}") from None


def _parse_field(spec: str, lo: int, hi: int, names: dict) -> Optional[Set[int]]:
    """None = unrestricted (`*`)."""
    if spec == "*":
        return None
    out: Set[int] = set()
    for part in spec.split(","):
        step = None
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = _to_int(step_s, {})
            if step <= 0:
                raise CronError(f"bad step in {spec!r}")
        if part == "*":
            lo_p, hi_p = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo_p, hi_p = _to_int(a, names), _to_int(b, names)
        else:
            lo_p = _to_int(part, names)
            # robfig semantics: 'N/step' means N through max, stepped;
            # a bare 'N' is the single value
            hi_p = hi if step is not None else lo_p
        if lo_p < lo or hi_p > hi or lo_p > hi_p:
            raise CronError(f"{spec!r} out of range [{lo},{hi}]")
        out.update(range(lo_p, hi_p + 1, step or 1))
    return out


def parse(schedule: str) -> Tuple[Optional[Set[int]], ...]:
    schedule = _MACROS.get(schedule.strip().lower(), schedule)
    fields = schedule.split()
    if len(fields) != 5:
        raise CronError(f"want 5 cron fields, got {len(fields)}: {schedule!r}")
    field_names = ({}, {}, {}, _MONTHS, _DOWS)
    return tuple(_parse_field(f, lo, hi, names)
                 for f, (lo, hi), names in zip(fields, _BOUNDS, field_names))


def _date_matches(parsed, d) -> bool:
    _, _, dom, month, dow = parsed
    if month is not None and d.month not in month:
        return False
    # standard cron OR rule: when BOTH dom and dow are restricted, either
    # matching suffices; otherwise the restricted one must match
    cron_dow = (d.weekday() + 1) % 7  # cron: 0 = Sunday
    dom_ok = dom is None or d.day in dom
    dow_ok = dow is None or cron_dow in dow
    if dom is not None and dow is not None:
        return dom_ok or dow_ok
    return dom_ok and dow_ok


def _best_time(minute, hour, before=None):
    """Latest (h, m) from the parsed sets, optionally at/before `before`;
    None when the day has no matching time early enough."""
    hours = sorted(hour, reverse=True) if hour is not None \
        else list(range(23, -1, -1))
    minutes = sorted(minute, reverse=True) if minute is not None \
        else list(range(59, -1, -1))
    if before is None:
        return hours[0], minutes[0]
    bh, bm = before
    for h in hours:
        if h > bh:
            continue
        if h < bh:
            return h, minutes[0]
        for m in minutes:
            if m <= bm:
                return h, m
    return None


_MAX_LOOKBACK_DAYS = 400  # covers yearly schedules (the sparsest the
# 5-field grammar can express: one date per year)
_last_fire_cache: dict = {}


def last_fire(schedule: str, now_ts: float,
              lookback_days: int = _MAX_LOOKBACK_DAYS) -> Optional[float]:
    """Epoch seconds of the most recent fire at/before now (UTC), or None
    if none within the lookback. Steps by DAY (date-field match first,
    then the latest in-day time arithmetically) instead of scanning
    minute-by-minute — a monthly schedule costs ~35 date checks, not
    ~50k datetime decrements. Cached per (schedule, lookback, minute).

    `lookback_days` exists for callers whose window extends further than
    a year past the fire (a duration like '9000h' is legal in the
    reference CRD): the in-window check must see a fire as old as its
    duration, or an open freeze silently reads as closed — the unsafe
    direction. The reference's robfig-based check has no horizon at all;
    ours is day-stepped, so a wide horizon costs one date check per day.
    """
    minute_bucket = int(now_ts // 60)
    key = (schedule, lookback_days, minute_bucket)
    if key in _last_fire_cache:
        return _last_fire_cache[key]
    parsed = parse(schedule)
    now_dt = datetime.fromtimestamp(now_ts, tz=timezone.utc)
    out: Optional[float] = None
    for day_off in range(lookback_days):
        d = (now_dt - timedelta(days=day_off)).date()
        if not _date_matches(parsed, d):
            continue
        before = (now_dt.hour, now_dt.minute) if day_off == 0 else None
        hm = _best_time(parsed[0], parsed[1], before)
        if hm is None:
            continue  # same-day fire hasn't happened yet; keep looking back
        out = datetime(d.year, d.month, d.day, hm[0], hm[1],
                       tzinfo=timezone.utc).timestamp()
        break
    if len(_last_fire_cache) > 4096:
        _last_fire_cache.clear()
    _last_fire_cache[key] = out
    return out


def in_window(schedule: Optional[str], duration: Optional[float],
              now_ts: float) -> bool:
    """Whether a budget's schedule window is open at now. No schedule =
    always open. Schedule WITHOUT duration is a config error the CRD
    would reject — fail safe by treating the window as always open (the
    budget binds) rather than silently dropping a freeze the user
    configured. Raises CronError on an unparseable schedule (callers
    fail safe the same way)."""
    if schedule is None:
        return True
    if duration is None:
        return True
    # the lookback must reach at least `duration` into the past: a fire
    # older than the default horizon can still hold the window open when
    # its duration spans months (a yearly schedule + multi-month
    # duration read as closed — the direction that silently drops a
    # configured disruption freeze)
    lookback = max(_MAX_LOOKBACK_DAYS, int(float(duration) // 86400) + 2)
    fire = last_fire(schedule, now_ts, lookback_days=lookback)
    if fire is None:
        return False
    return fire <= now_ts < fire + float(duration)
