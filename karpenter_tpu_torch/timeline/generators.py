"""Synthetic timeline generators.

Each generator returns a list of plain event dicts —
``{"at": <seconds from stream start>, "kind": <events.*>, "name": ...,
"data": {...}}`` — sorted by ``at`` and fully determined by its
``seed``: the scenario classes the related work motivates (KubePACS
spot-interruption storms, "Priority Matters" priority waves, diurnal
load from public cluster traces) as seeded, composable building
blocks.  `compose` merges streams into one ordered timeline; the JAX
package's `rewind.RewindEngine` applies it against a live
Environment/Operator (the port's comes with the operator).

Pod-carrying events put a human-readable request map in ``data``
(``{"cpu": "500m", "memory": "1Gi"}``) rather than the dense vector the
recorder captures — both shapes replay through `rewind.make_pod`.

The port's copy of `karpenter_tpu/timeline/generators.py`: one seed
gives the same stream in both packages.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.timeline import events as ev


def _pod(at: float, name: str, cpu: str, mem: str,
         annotations: Optional[Dict[str, str]] = None,
         labels: Optional[Dict[str, str]] = None) -> dict:
    return {"at": round(at, 3), "kind": ev.POD_ADD, "name": name,
            "data": {"cpu": cpu, "memory": mem,
                     "annotations": annotations or {},
                     "labels": labels or {}}}


def _remove(at: float, name: str) -> dict:
    return {"at": round(at, 3), "kind": ev.POD_REMOVE, "name": name,
            "data": None}


def diurnal_load(seed: int = 0, duration: float = 21600.0,
                 step: float = 120.0, base: int = 1, peak: int = 8,
                 lifetime: float = 1800.0, cpu: str = "500m",
                 mem: str = "1Gi", prefix: str = "diurnal") -> List[dict]:
    """A compressed day: per-step arrivals follow one sinusoidal cycle
    from ``base`` to ``peak`` pods, each living ``lifetime`` seconds
    (±25%, seeded) before its pod.remove.  The background hum every
    other scenario rides on top of."""
    rng = random.Random(seed)
    out: List[dict] = []
    i = 0
    t = 0.0
    while t < duration:
        phase = math.sin(math.pi * (t / duration))  # 0 → 1 → 0
        arrivals = base + int(round((peak - base) * phase))
        for _ in range(arrivals):
            name = f"{prefix}-{i}"
            i += 1
            at = t + rng.uniform(0.0, step)
            out.append(_pod(at, name, cpu, mem))
            life = lifetime * rng.uniform(0.75, 1.25)
            if at + life < duration:
                out.append(_remove(at + life, name))
        t += step
    out.sort(key=lambda e: (e["at"], e["kind"], e["name"]))
    return out


def spot_storm(at: float, reclaims: int = 12, spacing: float = 5.0,
               seed: int = 0) -> List[dict]:
    """A KubePACS-style interruption storm: ``reclaims`` spot
    terminations starting at ``at``, one every ``spacing`` seconds
    (±50%, seeded).  Each event carries a deterministic ``pick`` index;
    replay resolves it against the sorted list of live spot instances
    at fire time, so the storm is reproducible without knowing instance
    ids in advance (an unresolvable pick — no spot capacity up — is
    counted, not failed)."""
    rng = random.Random(seed)
    out = []
    t = at
    for i in range(reclaims):
        out.append({"at": round(t, 3), "kind": ev.SPOT_RECLAIM,
                    "name": f"storm-{i}", "data": {"pick": i}})
        t += spacing * rng.uniform(0.5, 1.5)
    return out


def gang_burst(at: float, gangs: int = 4, size: int = 4,
               topology: str = "", cpu: str = "500m", mem: str = "1Gi",
               spacing: float = 2.0, prefix: str = "gang",
               seed: int = 0) -> List[dict]:
    """``gangs`` all-or-nothing gangs of ``size`` members arriving in a
    burst — the tightly-coupled multi-node arrivals the gang atomicity
    audit exists for.  ``topology`` (e.g. a zone label key's domain
    semantics) pins adjacency when non-empty."""
    rng = random.Random(seed)
    out = []
    t = at
    for g in range(gangs):
        gname = f"{prefix}-{g}"
        ann = {wellknown.GANG_NAME_ANNOTATION: gname,
               wellknown.GANG_SIZE_ANNOTATION: str(size)}
        if topology:
            ann[wellknown.GANG_TOPOLOGY_ANNOTATION] = topology
        for m in range(size):
            out.append(_pod(t + rng.uniform(0.0, 0.5),
                            f"{gname}-m{m}", cpu, mem, annotations=ann))
        t += spacing
    out.sort(key=lambda e: (e["at"], e["kind"], e["name"]))
    return out


def priority_wave(at: float, bands=((1000, 4), (0, 8), (-10, 8)),
                  cpu: str = "500m", mem: str = "1Gi",
                  spacing: float = 1.0, prefix: str = "prio",
                  seed: int = 0) -> List[dict]:
    """A 'Priority Matters' wave: for each ``(priority, count)`` band,
    ``count`` pods carrying the priority annotation arrive together —
    high bands must never be stranded behind low ones
    (priority_inversion_audit is the replay judge)."""
    rng = random.Random(seed)
    out = []
    t = at
    for prio, count in bands:
        ann = {wellknown.PRIORITY_ANNOTATION: str(prio)}
        for i in range(count):
            out.append(_pod(t + rng.uniform(0.0, 0.5),
                            f"{prefix}-p{prio}-{i}", cpu, mem,
                            annotations=ann))
        t += spacing
    out.sort(key=lambda e: (e["at"], e["kind"], e["name"]))
    return out


def crash_schedule(crash_at: float, restart_after: float = 60.0,
                   worker: str = "solver") -> List[dict]:
    """One worker crash/restart pair: replayed as a one-shot
    `solver.dispatch` error fault (the fault point on the
    in-process solve path) armed at ``crash_at`` and disarmed
    ``restart_after`` seconds later.  The GatedSolver's degrade path
    must absorb it — pods stay pending and retry, never vanish."""
    return [
        {"at": round(crash_at, 3), "kind": ev.WORKER_CRASH,
         "name": worker, "data": {"point": "solver.dispatch",
                                  "mode": "error", "times": 1}},
        {"at": round(crash_at + restart_after, 3),
         "kind": ev.WORKER_RESTART, "name": worker, "data": None},
    ]


def compose(*streams: List[dict]) -> List[dict]:
    """Merge streams into one timeline ordered by (at, kind, name) —
    a total, input-order-independent sort so composed scenarios replay
    identically however they were assembled."""
    out = [dict(e) for s in streams for e in s]
    out.sort(key=lambda e: (e.get("at", 0.0), e.get("kind", ""),
                            e.get("name", "")))
    return out


def import_trace(path: str, time_key: str = "ts", name_key: str = "name",
                 cpu_key: str = "cpu", mem_key: str = "memory",
                 end_key: str = "end") -> List[dict]:
    """Importer skeleton for public cluster traces (Google/Alibaba-style
    task-event tables flattened to JSONL): each line with a timestamp
    and a name becomes a pod.add (requests from ``cpu_key``/``mem_key``,
    defaulting small), an ``end_key`` adds the matching pod.remove.
    Rows that don't parse are skipped and counted in the returned
    list's sidecar (``import_trace.skipped`` after the call) — the
    hook real trace adapters grow from, not a finished converter."""
    import json
    out: List[dict] = []
    skipped = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
                at = float(row[time_key])
                name = str(row[name_key])
            except (ValueError, KeyError, TypeError):
                skipped += 1
                continue
            out.append(_pod(at, name, str(row.get(cpu_key, "250m")),
                            str(row.get(mem_key, "512Mi"))))
            end = row.get(end_key)
            if end is not None:
                try:
                    out.append(_remove(float(end), name))
                except (TypeError, ValueError):
                    skipped += 1
    import_trace.skipped = skipped
    out.sort(key=lambda e: (e["at"], e["kind"], e["name"]))
    return out


import_trace.skipped = 0
