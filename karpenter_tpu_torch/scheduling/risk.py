"""Spot-interruption risk model — the `KARPENTER_TPU_SPOT_RISK`
objective's probability source.

Pure price at full coverage treats a $0.90 spot offering as strictly
better than a $1.00 on-demand one even when the spot pool is being
reclaimed hourly.  KubePACS grounds the alternative: weight each spot
column by its interruption probability and penalize concentration, so
winner selection minimizes *expected* cost
``price * (1 + LAMBDA * p_interrupt)`` instead of sticker price.

The model here is deliberately simple and deterministic:

  * a **base rate** per (instance type, zone) derived from a stable
    hash — a stand-in for a provider feed, chosen so two processes (and
    the kernel-vs-oracle parity pair) always agree;
  * an **empirical bump** per observed reclaim: the interruption
    controller calls :func:`observe_interruption` on every
    spot_interruption message (the config6 interruption model feeding
    the objective), and each observation raises that pool's probability
    toward the cap.  Observations bump :func:`model_version`, which
    joins the solver's catalog-encoding cache key so a risk change
    invalidates the encoded ``col_price`` exactly like a price change.

On-demand capacity has probability 0 by definition.  Claim prices are
NEVER risk-adjusted — the effective price is a ranking key only; the
ledger and the claims keep the real offering prices.

jax-free on purpose: encode.py (numpy), the oracle, and the
interruption controller all import it.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Tuple

from karpenter_tpu_torch.models import wellknown

# expected-cost weight: eff = price * (1 + LAMBDA * p). 1.0 means one
# expected interruption doubles the effective price — the KubePACS
# shape, kept constant so both engines and the bench agree bit-for-bit.
LAMBDA = 1.0
# diversification penalty per already-selected spot claim in the same
# (instance type, zone) pool — host-side ranking shaping only (the
# oracle's finalize and the bench), never part of the encoded col_price
# (a dynamic term would break the catalog-encoding cache).
DIVERSIFY_PENALTY = 0.01
# base-rate band for the deterministic hash model, and the cap the
# empirical bump saturates at
_BASE_MIN, _BASE_MAX = 0.02, 0.18
_OBS_BUMP = 0.05
_P_CAP = 0.90

_lock = threading.Lock()
_observed: Dict[Tuple[str, str], int] = {}
_version = 0


def base_rate(instance_type: str, zone: str) -> float:
    """Deterministic per-(type, zone) base interruption probability in
    [_BASE_MIN, _BASE_MAX] — a stable stand-in for a provider feed."""
    h = zlib.crc32(f"{instance_type}/{zone}".encode()) & 0xFFFFFFFF
    return _BASE_MIN + (_BASE_MAX - _BASE_MIN) * (h / 0xFFFFFFFF)


def observe_interruption(instance_type: str, zone: str) -> None:
    """One observed spot reclaim for this pool: raises its probability
    by _OBS_BUMP (saturating at the cap) and bumps the model version so
    cached encodings rebuild."""
    global _version
    with _lock:
        key = (instance_type or "", zone or "")
        _observed[key] = _observed.get(key, 0) + 1
        _version += 1


def interruption_probability(instance_type: str, zone: str,
                             capacity_type: str) -> float:
    """P(interruption) for one offering; 0.0 for non-spot capacity."""
    if capacity_type != wellknown.CAPACITY_TYPE_SPOT:
        return 0.0
    with _lock:
        n = _observed.get((instance_type or "", zone or ""), 0)
    return min(_P_CAP, base_rate(instance_type, zone) + _OBS_BUMP * n)


def effective_price(price: float, instance_type: str, zone: str,
                    capacity_type: str) -> float:
    """The risk-adjusted ranking price: real price for on-demand,
    ``price * (1 + LAMBDA * p)`` for spot.  A RANKING key only — claims
    and the ledger always carry the real price."""
    p = interruption_probability(instance_type, zone, capacity_type)
    if p <= 0.0:
        return price
    return price * (1.0 + LAMBDA * p)


def expected_interruption_cost(price: float, instance_type: str,
                               zone: str, capacity_type: str) -> float:
    """The `karpenter_tpu_spot_risk_cost` contribution of one node:
    p * price — the $/hr at risk of reclaim."""
    return interruption_probability(
        instance_type, zone, capacity_type) * price


def model_version() -> int:
    """Monotonic model state counter; joins the solver's
    catalog-encoding cache key (with the knob state) so an observation
    invalidates encoded effective prices."""
    with _lock:
        return _version


def model_key() -> tuple:
    """(enabled, version) — the piece of cache identity the solver
    folds into its catalog key."""
    from karpenter_tpu_torch.utils.knobs import spot_risk_enabled
    enabled = spot_risk_enabled()
    return (enabled, model_version() if enabled else 0)


def reset() -> None:
    """Clear observed reclaims (tests and benches)."""
    global _version
    with _lock:
        _observed.clear()
        _version += 1
