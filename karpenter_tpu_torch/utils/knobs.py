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

