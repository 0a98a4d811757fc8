"""Canonical `KARPENTER_TPU_*` knob grammar.

Every boolean knob in this codebase is parsed HERE, through
:func:`env_bool`, so on/off synonyms are symmetric by construction:
``1/true/yes/on`` enable, ``0/false/no/off`` disable, anything else —
including the empty string — degrades to the knob's documented default
(the MESH/DELTA discipline: a typo is a no-op, never a crash and never
a silent enable).  Before this module, four gates parsed truthiness by
hand and disagreed: ``KARPENTER_TPU_FORCE_CPU=0`` *forced CPU* (bare
truthiness), ``KARPENTER_TPU_TRACE=on`` did nothing (on-set missing
``on``), ``KARPENTER_TPU_WARMUP=off`` worked but ``=no`` enabled a
compile storm.  kt-lint's `env-knob` rule now fails any boolean knob
read that bypasses this function (hack/analyze/rules/env_knobs.py).

The port's copy keeps the knobs its modules read; the names and the
grammar are the reference's, so one environment drives both packages.

Three of the reference's solver knobs have no reader here, and setting
them changes nothing in the port, answers included:

- ``KARPENTER_TPU_MASK_BITS`` and ``KARPENTER_TPU_COALESCE`` roll back the
  reference's device-link transforms (the bit-packed group mask and the
  one-buffer upload).  The port always ships the mask as column bits,
  which its kernels read as bits, and always uploads a problem in one
  pinned host-to-device copy, so there is no dense or per-array form to
  roll back to; either form gives the reference the same answer.
- ``KARPENTER_TPU_NEW_TOPK`` forces the reference's dense take_new rows
  in place of its top-K compaction.  The port's scans always write the
  dense rows; the compaction only shrank the pull over the reference's
  device tunnel, and its estimate survives only as the flight record's
  ``topk_segments``.

The fourth, ``KARPENTER_TPU_PROFILE_PORT``, is the reference's profiler
server port; `utils/profiling.py` says why the port has no server.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

# the symmetric synonym sets — the contract docs/operations.md documents
ON_WORDS = ("1", "true", "yes", "on")
OFF_WORDS = ("0", "false", "no", "off")


def env_bool(name: str, default: bool = False,
             environ: Optional[Mapping[str, str]] = None) -> bool:
    """Parse a boolean `KARPENTER_TPU_*` knob with the canonical
    symmetric grammar.  Unset, empty, or malformed values return
    `default` — rollback knobs must degrade to the configured behavior,
    never flip it on a typo."""
    env = os.environ if environ is None else environ
    raw = env.get(name)
    if raw is None:
        return default
    val = raw.strip().lower()
    if val in ON_WORDS:
        return True
    if val in OFF_WORDS:
        return False
    return default


def gang_enabled() -> bool:
    """`KARPENTER_TPU_GANG`: the gang-scheduling rollback lever
    (default on).  Off, gang annotations are inert — members schedule
    as ordinary independent pods (no atomicity, no adjacency).  Parsed
    here (not in the scheduling layer) because BOTH the jax-free
    oracle/model layer and the solver read it, and each knob keeps
    exactly one grammar owner."""
    return env_bool("KARPENTER_TPU_GANG", default=True)


def priority_enabled() -> bool:
    """`KARPENTER_TPU_PRIORITY`: the priority-scheduling rollback lever
    (default on).  Off, priority classes and the `karpenter.tpu/priority`
    annotation are inert — pods keep their spec `priority` field in the
    scheduling key (pre-existing behavior) but no band ordering, no
    preemption planning, and no PriorityBandExhausted reclassification
    happen.  Parsed here because the jax-free model/oracle layer, the
    solver, and the preemption controller all read it, and each knob
    keeps exactly one grammar owner.  (The service admission-rank knob
    that previously used this name is now
    `KARPENTER_TPU_SERVICE_PRIORITY` — operator/options.py.)"""
    return env_bool("KARPENTER_TPU_PRIORITY", default=True)


def spot_risk_enabled() -> bool:
    """`KARPENTER_TPU_SPOT_RISK`: the spot-risk-weighted objective mode
    (default off).  On, winner selection in BOTH engines ranks columns
    by interruption-risk-adjusted effective price
    (scheduling/risk.py) instead of pure price; claim prices stay the
    REAL offering prices.  One grammar owner: encode, decode, and the
    oracle all resolve the mode through this function."""
    return env_bool("KARPENTER_TPU_SPOT_RISK", default=False)


def bind_host() -> str:
    """`KARPENTER_TPU_BIND_HOST`: the metrics/health/probe bind address
    (default loopback; `0.0.0.0` in containers).  Shared by the
    operator's debug server and the supervisor's probe listener — one
    parsing owner so the two can never read different defaults."""
    return os.environ.get("KARPENTER_TPU_BIND_HOST", "127.0.0.1")


def relax_budget_s(environ: Optional[Mapping[str, str]] = None
                   ) -> Optional[float]:
    """`KARPENTER_TPU_RELAX_BUDGET`: the relaxation loop's wall-clock
    budget per solve, in seconds (default 30).  "", "none" and "off" mean
    unbounded (None); a malformed value falls back to the default — a
    config typo degrades the knob, it never crashes the solver."""
    env = os.environ if environ is None else environ
    raw = env.get("KARPENTER_TPU_RELAX_BUDGET", "30").strip()
    if raw.lower() in ("", "none", "off"):
        return None
    try:
        return float(raw)
    except ValueError:
        return 30.0


def sweep_topk_enabled(environ: Optional[Mapping[str, str]] = None) -> bool:
    """`KARPENTER_TPU_SWEEP_TOPK`: "0" forces the batched paths' dense
    take_exist rows (the top-K compaction off, a debug/rollback lever);
    any other integer leaves the compaction on, and a malformed value
    degrades to the default (on)."""
    env = os.environ if environ is None else environ
    try:
        return int(env.get("KARPENTER_TPU_SWEEP_TOPK", "1")) != 0
    except ValueError:
        return True


def mesh_spec(spec, environ: Optional[Mapping[str, str]] = None):
    """`KARPENTER_TPU_MESH` applied to a constructed mesh spec: "off",
    "0", "false" or "none" force one device (None), "auto" forces auto,
    an integer forces that shard count; unset or malformed leaves `spec`
    alone."""
    env = os.environ if environ is None else environ
    raw = env.get("KARPENTER_TPU_MESH", "").strip().lower()
    if not raw:
        return spec
    if raw in ("off", "0", "false", "none"):
        return None
    if raw == "auto":
        return "auto"
    try:
        return int(raw)
    except ValueError:
        return spec
