"""Seeded kernel-level FFD problems for checking a kernel against its plain
version (and the port against the JAX reference).

`random_problem` returns the reference's 17-slot `_problem_args` tuple and
the padded catalog arrays, in numpy, shaped like an encoded solve: a PT x
ZC column grid with padded (pool,type) blocks, pools with daemon overhead
and finite or unlimited budgets, existing nodes with per-node caps,
hostname-style per-node caps, whole-node (all-or-nothing) groups and padded
group rows.  With ``topology=True`` it also carries zone and capacity-type
domain groups (the heavy scan branch) mixed with light ones.  Every float
is integer-valued (millicores, MiB, counts), as
encoded requests and capacities are, so the float arithmetic is exact and
the kernels must agree bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

BIG = 2 ** 29  # the encoder's "unbounded" cap (encode.BIG)
R = 6          # cpu (m), memory (MiB), ephemeral, pods, gpu, volumes


def random_problem(seed: int, *, G: int = 8, E: int = 16, PT: int = 64,
                   ZC: int = 6, P: int = 2, real_groups: Optional[int] = None,
                   pad_blocks: int = 8, limits: str = "mixed",
                   whole: bool = True, pod_scale: int = 60,
                   D: int = 2, topology: bool = False) -> Tuple[tuple, Dict]:
    """One problem.  `limits`: "none" (every pool unlimited), "finite"
    (every pool budgeted) or "mixed".  `pod_scale` sets group sizes:
    large values against a small node axis exhaust the slots.

    `topology`: the (zone, capacity-type) grid has ZC // 2 zones and 2
    capacity types (slot s is zone s % (ZC // 2), capacity type
    s // (ZC // 2)); each real group draws dsel from {0, 1, 2} — light,
    zone or capacity-type domain — and a domain group is a spread
    (base counts, skew 1 or 2, sometimes minDomains, sometimes a blocked
    domain) or an anti-affinity (at most one more pod per domain), over
    partly ineligible domains.  Existing nodes sit in random domains.  D
    (the padded domain width) must hold the zones."""
    rng = np.random.RandomState(seed)
    real_groups = G - 1 if real_groups is None else real_groups
    O = PT * ZC
    real_pt = PT - pad_blocks

    # -- catalog: (pool,type) blocks, allocatable per block ----------------
    vcpu = rng.choice([2, 4, 8, 16, 32, 48, 64, 96], size=real_pt)
    mem_per = rng.choice([2, 4, 8], size=real_pt)
    gpus = np.where(rng.rand(real_pt) < 0.15,
                    rng.choice([1, 4, 8], size=real_pt), 0)
    pt_alloc = np.zeros((PT, R), np.float32)
    pt_alloc[:real_pt, 0] = vcpu * 1000 - rng.randint(0, 4, real_pt) * 10
    pt_alloc[:real_pt, 1] = vcpu * mem_per * 1024 - rng.randint(
        0, 8, real_pt) * 64
    pt_alloc[:real_pt, 2] = rng.choice([20480, 102400], size=real_pt)
    pt_alloc[:real_pt, 3] = np.where(vcpu <= 8, 58, 234)
    pt_alloc[:real_pt, 4] = gpus
    pt_alloc[:real_pt, 5] = np.where(vcpu <= 16, 24, 40)
    col_alloc = np.repeat(pt_alloc, ZC, axis=0)
    # pools own contiguous runs of blocks, in priority order
    pt_pool = np.sort(rng.randint(0, P, size=PT)).astype(np.int32)
    pt_pool[real_pt:] = 0
    col_pool = np.repeat(pt_pool, ZC)
    pool_daemon = np.zeros((P, R), np.float32)
    pool_daemon[:, 0] = rng.choice([0, 100, 250], size=P)
    pool_daemon[:, 1] = rng.choice([0, 128, 512], size=P)
    pool_daemon[:, 3] = rng.choice([0, 1, 2], size=P)
    col_daemon = pool_daemon[col_pool].copy()
    col_daemon[real_pt * ZC:] = 0.0
    # a column exists only where its (zone, capacity-type) offering does
    col_valid = rng.rand(O) < 0.85
    col_valid[real_pt * ZC:] = False

    # -- groups --------------------------------------------------------------
    group_req = np.zeros((G, R), np.float32)
    group_count = np.zeros(G, np.int32)
    group_mask = np.zeros((G, O), bool)
    group_ncap = np.full(G, BIG, np.int32)
    group_whole = np.zeros(G, bool)
    for g in range(real_groups):
        group_req[g, 0] = rng.choice([100, 250, 500, 1000, 2000, 4000])
        group_req[g, 1] = rng.choice([128, 256, 512, 1024, 2048, 8192])
        group_req[g, 3] = 1
        if rng.rand() < 0.15:
            group_req[g, 4] = 1
        if rng.rand() < 0.1:
            group_req[g, 5] = 1
        group_count[g] = rng.randint(1, pod_scale + 1)
        # admitted columns: a few pools/zones, never the padding
        group_mask[g] = col_valid & (rng.rand(O) < rng.choice([0.3, 0.7,
                                                               1.0]))
        if rng.rand() < 0.2:
            group_ncap[g] = rng.randint(1, 6)
        if whole and rng.rand() < 0.25:
            group_whole[g] = True
            group_count[g] = rng.randint(1, 12)
    # FFD order: larger requests first
    order = np.lexsort((-group_req[:real_groups, 1],
                        -group_req[:real_groups, 0]))
    for a in (group_req, group_count, group_mask, group_ncap, group_whole):
        a[:real_groups] = a[:real_groups][order]

    # -- existing nodes ------------------------------------------------------
    exist_remaining = np.zeros((E, R), np.float32)
    exist_cap = np.zeros((G, E), np.int32)
    if E:
        e_real = max(E - 2, 0)
        exist_remaining[:e_real, 0] = rng.randint(0, 16, e_real) * 500
        exist_remaining[:e_real, 1] = rng.randint(0, 32, e_real) * 512
        exist_remaining[:e_real, 2] = 20480
        exist_remaining[:e_real, 3] = rng.randint(0, 30, e_real)
        exist_remaining[:e_real, 4] = rng.choice([0, 0, 0, 2], e_real)
        exist_remaining[:e_real, 5] = 10
        cap = np.where(rng.rand(real_groups, e_real) < 0.7, BIG,
                       rng.randint(0, 4, (real_groups, e_real)))
        exist_cap[:real_groups, :e_real] = cap

    # -- pool budgets ---------------------------------------------------------
    pool_limit = np.full((P, R), np.inf, np.float32)
    for p in range(P):
        if limits == "finite" or (limits == "mixed" and rng.rand() < 0.5):
            pool_limit[p, 0] = rng.randint(8, 160) * 1000
            pool_limit[p, 1] = rng.randint(16, 320) * 1024

    # -- topology domains ----------------------------------------------------
    nz = max(ZC // 2, 1)
    slot = np.arange(ZC, dtype=np.int32)
    col_zone = np.tile(slot % nz if topology else slot % 3, PT)
    col_ct = np.tile(slot // nz if topology else slot // 3, PT)
    group_dsel = np.zeros(G, np.int32)
    group_dbase = np.zeros((G, D), np.int32)
    group_dcap = np.full((G, D), BIG, np.int32)
    group_skew = np.full(G, BIG, np.int32)
    group_mindom = np.zeros(G, np.int32)
    group_delig = np.zeros((G, D), bool)
    exist_zone = np.full(E, -1, np.int32)
    exist_ct = np.full(E, -1, np.int32)
    if topology:
        assert nz <= D, (nz, D)
        e_real = max(E - 2, 0)
        exist_zone[:e_real] = rng.randint(-1, nz, e_real)
        exist_ct[:e_real] = rng.randint(-1, 2, e_real)
        for g in range(real_groups):
            dsel = rng.choice([0, 1, 2])
            if dsel == 0 or group_whole[g]:
                continue
            group_dsel[g] = dsel
            ndom = nz if dsel == 1 else 2
            group_dcap[g, ndom:] = 0   # pad domains take no quota
            elig = rng.rand(ndom) < 0.8
            elig[rng.randint(ndom)] = True
            group_delig[g, :ndom] = elig
            if rng.rand() < 0.25:
                # anti-affinity: one more pod per domain, unbounded skew
                group_dcap[g, :ndom] = (rng.rand(ndom) < 0.8).astype(
                    np.int32)
            else:
                group_skew[g] = rng.choice([1, 2])
                group_dbase[g, :ndom] = rng.randint(0, 4, ndom)
                if rng.rand() < 0.3:
                    group_mindom[g] = rng.randint(1, ndom + 1)
                if rng.rand() < 0.2:
                    group_dcap[g, rng.randint(ndom)] = 0

    prob = (
        group_req, group_count, group_mask, exist_cap, exist_remaining,
        pool_limit, group_ncap,
        group_dsel, group_dbase, group_dcap, group_skew, group_mindom,
        group_delig,
        group_whole,
        np.zeros(G, bool),                     # group_gang
        exist_zone, exist_ct,
    )
    cat = dict(col_alloc=col_alloc, col_daemon=col_daemon, pt_alloc=pt_alloc,
               col_pool=col_pool, pool_daemon=pool_daemon,
               col_zone=col_zone, col_ct=col_ct,
               zc=ZC)
    return prob, cat
