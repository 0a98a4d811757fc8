"""Seeded kernel-level FFD problems for checking a kernel against its plain
version (and the port against the JAX reference).

`random_problem` returns the reference's 17-slot `_problem_args` tuple and
the padded catalog arrays, in numpy, shaped like an encoded solve: a PT x
ZC column grid with padded (pool,type) blocks, pools with daemon overhead
and finite or unlimited budgets, existing nodes with per-node caps,
hostname-style per-node caps, whole-node (all-or-nothing) groups and padded
group rows.  With ``topology=True`` it also carries zone and capacity-type
domain groups (the heavy scan branch) mixed with light ones; with
``gang=True``, gang groups (the gang fill) over zone, capacity-type or no
domain; with ``priority=True``, the 18-slot form with a priority band per
group.  Every float
is integer-valued (millicores, MiB, counts), as
encoded requests and capacities are, so the float arithmetic is exact and
the kernels must agree bit for bit.

`random_delta_problem` adds a seeded start to a light problem (the delta
path's suffix scan): the first A node slots already open, each in a pool
with an integer-valued used vector and a random set of its pool's
columns that still fit, the colmask padded with empty rows to A_pad.

`random_batch` stacks B such problems against one catalog (the generic
batched scan), and `random_sweep` builds a consolidation sweep: a shared
snapshot (per-class column masks and node caps, existing nodes, column
prices) and B simulations that each exclude existing rows, pick classes,
cap the price and budget the pools — light, or with per-simulation
topology rows for the heavy lane.
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
                   D: int = 2, topology: bool = False, gang: bool = False,
                   tied_ranks: bool = False,
                   priority: bool = False) -> Tuple[tuple, Dict]:
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
    (the padded domain width) must hold the zones.

    `gang`: about half the real groups become gang units, as
    the encoder writes them: dsel 1 (zone), 2 (capacity type) or 0
    (domain-free: every column and node in domain 0), dbase the trial rank
    of each domain (all 0 with `tied_ranks`: the lowest index wins),
    delig a random non-empty (sometimes empty) subset of the real domains,
    no per-node cap, no spread; sizes from 2 to a few hundred members, so
    some fit one domain and some none; existing nodes sit in random zones
    and capacity types.  `priority`: an 18th slot `group_prio`, bands
    non-increasing along the group order (as the encoder sorts them).
    Both draw from their own generators, so a seed's other rows do not
    change with them."""
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

    group_gang = np.zeros(G, bool)
    if gang:
        grng = np.random.RandomState(seed + 104729)
        nz3 = nz if topology else 3            # zones of the column grid
        nct = 2
        assert max(nz3, nct) <= D, (nz3, D)
        if E and not topology:
            e_real = max(E - 2, 0)
            exist_zone[:e_real] = grng.randint(-1, nz3, e_real)
            exist_ct[:e_real] = grng.randint(-1, nct, e_real)
        for g in range(real_groups):
            if group_whole[g] or grng.rand() >= 0.5:
                continue
            group_gang[g] = True
            dsel = grng.choice([0, 1, 2])
            group_dsel[g] = dsel
            group_ncap[g] = BIG
            group_dcap[g] = BIG
            group_skew[g] = BIG
            group_mindom[g] = 0
            group_dbase[g] = 0
            group_delig[g] = False
            if E:
                exist_cap[g, :max(E - 2, 0)] = BIG
            group_count[g] = grng.choice([grng.randint(2, 13),
                                          grng.randint(13, 80),
                                          grng.randint(200, 600)])
            if dsel == 0:
                group_delig[g, 0] = True
                continue
            ndom = nz3 if dsel == 1 else nct
            if not tied_ranks:
                group_dbase[g, :ndom] = grng.permutation(ndom)
            elig = grng.rand(ndom) < 0.75
            if grng.rand() < 0.9:
                elig[grng.randint(ndom)] = True
            group_delig[g, :ndom] = elig

    prob = (
        group_req, group_count, group_mask, exist_cap, exist_remaining,
        pool_limit, group_ncap,
        group_dsel, group_dbase, group_dcap, group_skew, group_mindom,
        group_delig,
        group_whole,
        group_gang,
        exist_zone, exist_ct,
    )
    if priority:
        prng = np.random.RandomState(seed + 7919)
        bands = np.sort(prng.choice([0, 1, 100, 1000, 2_000_000_000],
                                    size=real_groups))[::-1]
        group_prio = np.zeros(G, np.int32)
        group_prio[:real_groups] = bands
        prob = prob + (group_prio,)
    cat = dict(col_alloc=col_alloc, col_daemon=col_daemon, pt_alloc=pt_alloc,
               col_pool=col_pool, pool_daemon=pool_daemon,
               col_zone=col_zone, col_ct=col_ct,
               zc=ZC)
    return prob, cat


def random_batch(seed: int, B: int, **kw) -> Tuple[list, Dict]:
    """B problems of common shapes against one catalog: the catalog and
    problem 0 of `random_problem(seed, **kw)`, then problems of other
    seeds with the same keyword arguments (their masks admit only real
    columns, which every catalog of these arguments holds)."""
    prob0, cat = random_problem(seed, **kw)
    probs = [prob0] + [random_problem(seed * 1000 + b, **kw)[0]
                       for b in range(1, B)]
    return probs, cat


def random_sweep(seed: int, B: int, *, C: int = 4, G: int = 2,
                 E: int = 64, X: int = 2, heavy: bool = False, D: int = 4,
                 PT: int = 64, ZC: int = 6, P: int = 2,
                 pod_scale: int = 40, limits: str = "mixed",
                 capped: float = 0.5) -> Tuple[Dict, Dict, Dict]:
    """A consolidation sweep: (per-simulation rows, shared snapshot,
    catalog arrays), numpy.

    The snapshot's C classes, existing rows and catalog are those of
    `random_problem(seed, G=C, E=E, ...)` (the last class row is padding,
    as an encoded class table's tail is); columns get prices, +inf on the
    padding.  Simulation b excludes 1..X distinct existing rows (the rest
    -1), runs G groups of random classes with random counts up to
    `pod_scale`, caps the price below a random column price with
    probability `capped` (else +inf) and budgets its pools ("none",
    "finite" or "mixed").  With `heavy`, each simulation also carries the
    heavy lane's topology rows: its groups' classes' domain constraints
    with base counts moved by the simulation, and sometimes a node cap."""
    rng = np.random.RandomState(seed)
    base, cat = random_problem(seed, G=C, E=E, PT=PT, ZC=ZC, P=P,
                               limits="none", whole=False,
                               pod_scale=pod_scale, D=D, topology=heavy)
    (creq, _, cmask, ccap, exist_remaining, _, _, cdsel, cdbase, cdcap,
     cskew, cmindom, cdelig, _, _, exist_zone, exist_ct) = base
    O = PT * ZC
    real_pt = PT - 8
    pt_price = np.zeros(PT, np.float32)
    pt_price[:real_pt] = (cat["pt_alloc"][:real_pt, 0] / 1000.0
                          * rng.choice([0.02, 0.03, 0.05], real_pt))
    col_price = np.repeat(pt_price, ZC).astype(np.float32)
    # spot-like slots are cheaper; padding columns are never bought
    col_price *= np.tile(np.where(np.arange(ZC) % 2 == 0, 1.0, 0.4),
                         PT).astype(np.float32)
    col_price[real_pt * ZC:] = np.inf
    real_c = C - 1
    group_class = rng.randint(0, real_c, size=(B, G)).astype(np.int32)
    group_req = creq[group_class].astype(np.float32)
    group_count = rng.randint(1, pod_scale + 1, size=(B, G)).astype(np.int32)
    # padded group rows: no pods, class 0
    pad = rng.rand(B, G) < 0.15
    pad[:, 0] = False
    group_count[pad] = 0
    group_req[pad] = 0.0
    group_class[pad] = 0
    exclude_idx = np.full((B, X), -1, np.int32)
    for b in range(B):
        k = rng.randint(1, X + 1)
        exclude_idx[b, :k] = rng.choice(E, size=k, replace=False)
    finite = col_price[np.isfinite(col_price) & (col_price > 0)]
    price_cap = np.where(rng.rand(B) < capped,
                         rng.choice(finite, size=B) if finite.size else 0.0,
                         np.inf).astype(np.float32)
    pool_limit = np.full((B, P, R), np.inf, np.float32)
    for b in range(B):
        for p in range(P):
            if limits == "finite" or (limits == "mixed" and rng.rand() < 0.5):
                pool_limit[b, p, 0] = rng.randint(2, 80) * 1000
                pool_limit[b, p, 1] = rng.randint(4, 160) * 1024
    rows = dict(group_req=group_req, group_count=group_count,
                group_class=group_class, exclude_idx=exclude_idx,
                price_cap=price_cap, pool_limit=pool_limit)
    if heavy:
        dsel = cdsel[group_class].copy()
        dsel[pad] = 0
        dbase = cdbase[group_class] + np.where(
            cdsel[group_class][..., None] > 0,
            rng.randint(0, 3, size=(B, G, D)), 0).astype(np.int32)
        ncap = np.where(rng.rand(B, G) < 0.2, rng.randint(1, 6, (B, G)),
                        BIG).astype(np.int32)
        rows.update(group_ncap=ncap, group_dsel=dsel.astype(np.int32),
                    group_dbase=dbase.astype(np.int32),
                    group_dcap=cdcap[group_class].astype(np.int32),
                    group_skew=cskew[group_class].astype(np.int32),
                    group_mindom=cmindom[group_class].astype(np.int32),
                    group_delig=cdelig[group_class].astype(np.int32))
    shared = dict(class_mask=cmask, class_cap=ccap.astype(np.int32),
                  exist_remaining=exist_remaining,
                  exist_zone=exist_zone, exist_ct=exist_ct,
                  col_price=col_price)
    return rows, shared, cat


def random_delta_problem(seed: int, *, A: int, A_pad: int, N: int = 64,
                         **kw) -> Tuple[tuple, Dict, tuple]:
    """A light, gang-free problem of `random_problem(seed, **kw)` and a
    seed for it: (problem tuple, catalog arrays, (seed_used [N, R],
    seed_pool [N], seed_active [N] bool, seed_colmask [A_pad, O] bool)).
    The first A slots are open: pool p, used = the pool's daemon plus k
    pods of one of the problem's requests (integer-valued), and a random
    half of the pool's valid columns whose block still holds `used`."""
    assert 0 <= A <= A_pad <= N, (A, A_pad, N)
    prob, cat = random_problem(seed, topology=False, gang=False,
                               priority=False, **kw)
    rng = np.random.RandomState(seed + 15485863)
    O = cat["col_alloc"].shape[0]
    ZC = cat["zc"]
    P = cat["pool_daemon"].shape[0]
    req = prob[0]
    real = np.nonzero(prob[1] > 0)[0]
    used = np.zeros((N, R), np.float32)
    pool = np.zeros(N, np.int32)
    active = np.arange(N) < A
    colmask = np.zeros((A_pad, O), bool)
    admitted = prob[2].any(axis=0)
    for n in range(A):
        p = rng.randint(P)
        g = real[rng.randint(len(real))] if len(real) else 0
        k = rng.randint(1, 6)
        used[n] = cat["pool_daemon"][p] + np.float32(k) * req[g]
        fits = np.all(cat["pt_alloc"] - used[n] >= -1e-3, axis=1)   # [PT]
        cols = ((cat["col_pool"] == p) & admitted & np.repeat(fits, ZC)
                & (rng.rand(O) < 0.5))
        colmask[n] = cols
        pool[n] = p
    return prob, cat, (used, pool, active, colmask)
