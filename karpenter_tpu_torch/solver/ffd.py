"""The grouped-FFD solve on the card: kernel wrappers and plain versions.

The JAX reference (`karpenter_tpu/solver/ffd.py` `_solve_ffd_impl`) is one
jitted `lax.scan` over pod equivalence classes; each step takes the light
branch (no zone/capacity-type domain constraint) or the heavy one
(`lax.cond(dsel > 0, heavy, light)`).  This module runs the scan for every
class without a gang as hand-written CUDA kernels:

  * ``light_scan`` (K1, `csrc/ffd_light_scan.cu`): the whole G-step scan
    of a problem whose classes are all light, in one launch; writes the
    dense result rows straight into the flat result buffer and leaves the
    final pool budgets in a small carry.
  * ``topo_scan`` (K3, `csrc/ffd_topo_scan.cu`): the same scan with the
    heavy step — per-domain water-fill quotas, domain-pinned fills — for
    problems with at least one domain class; light classes take K1's step.
  * ``pack`` (K2, `csrc/ffd_pack.cu`): the explain=1 elimination counts,
    topology class included, from the scan's final state, at the offsets
    `unpack` expects.

`solve_ffd` launches K3 when any class has a domain constraint, K1
otherwise.  Beside each kernel sits its plain PyTorch version
(``light_scan_reference``, ``topo_scan_reference``, ``pack_reference``), a
transcription of the reference with a Python loop over groups and pools;
the two scan versions share one light step.  A wrapper runs the kernel
for a CUDA tensor and the plain version for a CPU tensor; there is no
fallback from one to the other.  Each wrapper counts its kernel launches
in ``.launches``.

The flat result buffer has exactly the reference's layout (ffd.py:1258):

    take_exist G*E | take_new G*N
    | unsched G | dom_placed G*D | used N*R | node_pool N | node_zone N
    | node_ct N | num_active 1 | [explain: counts G*5, bits G]

(always the dense take_new rows: the reference's top-K take_new
compaction saves device-to-host bytes on a TPU link and bought nothing
on the card) and `unpack` splits it into the same named host arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.models.resources import RESOURCE_AXIS
from karpenter_tpu_torch.solver.explain import EPS, KERNEL_CONSTRAINTS

R = len(RESOURCE_AXIS)
EXPLAIN_C = len(KERNEL_CONSTRAINTS)
_CAP = 2 ** 30  # _fit_count's ceiling (ffd.py:116)
MAX_POOLS = 64  # the kernels' pool-axis capacity (csrc MAXP)
MAX_DOMAINS = 128  # the kernels' domain-axis capacity (csrc MAXD)


# -- tensors -----------------------------------------------------------------
@dataclass
class FFDCatalog:
    """The catalog half of the kernel arguments, resident on the device
    for one catalog identity.  Column axis O = PT * ZC, padded."""
    col_alloc: torch.Tensor    # [O, R] f32
    col_daemon: torch.Tensor   # [O, R] f32
    pt_alloc: torch.Tensor     # [PT, R] f32
    col_pool: torch.Tensor     # [O] i32
    pool_daemon: torch.Tensor  # [P, R] f32
    pool_bits: torch.Tensor    # [P, W] i32 — col_pool == p as column bits
    col_zone: torch.Tensor     # [O] i32 zone id; padded with the tiled
    col_ct: torch.Tensor       # [O] i32 capacity-type id; block pattern
    zc: int

    @property
    def O(self) -> int:
        return self.col_alloc.shape[0]

    @property
    def PT(self) -> int:
        return self.pt_alloc.shape[0]

    @property
    def W(self) -> int:
        return (self.O + 31) // 32


@dataclass
class FFDProblem:
    """The per-solve half of the kernel arguments."""
    group_req: torch.Tensor        # [G, R] f32
    group_count: torch.Tensor      # [G] i32
    mask_bits: torch.Tensor        # [G, W] i32, bit o%32 of word o//32
    exist_cap: torch.Tensor        # [G, E] i32
    exist_remaining: torch.Tensor  # [E, R] f32
    pool_limit: torch.Tensor       # [P, R] f32 (inf = unlimited)
    group_ncap: torch.Tensor       # [G] i32
    group_whole: torch.Tensor      # [G] i32 0/1
    group_dsel: torch.Tensor       # [G] i32 0 none / 1 zone / 2 cap. type
    group_dbase: torch.Tensor      # [G, D] i32 spread base counts
    group_dcap: torch.Tensor       # [G, D] i32 max additional per domain
    group_skew: torch.Tensor       # [G] i32
    group_mindom: torch.Tensor     # [G] i32 (0 = unset)
    group_delig: torch.Tensor      # [G, D] i32 0/1 eligible for skew min
    exist_zone: torch.Tensor       # [E] i32 (-1 = unlabeled)
    exist_ct: torch.Tensor         # [E] i32
    topology: bool                 # any class with dsel > 0 (K3, not K1)

    @property
    def D(self) -> int:
        """The padded domain width of dom_placed."""
        return self.group_dbase.shape[1]

    @property
    def G(self) -> int:
        return self.group_req.shape[0]

    @property
    def E(self) -> int:
        return self.exist_remaining.shape[0]

    @property
    def P(self) -> int:
        return self.pool_limit.shape[0]


def pack_mask_bits(mask: np.ndarray, O: int) -> np.ndarray:
    """[G, O] bool, or [G, ceil(O/8)] uint8 already packed with
    np.packbits(bitorder="little"), → [G, ceil(O/32)] int32 words: bit
    o % 32 of word o // 32 is column o."""
    if mask.dtype != np.uint8:
        assert mask.shape[-1] == O, (mask.shape, O)
        mask = np.packbits(mask.astype(bool), axis=-1, bitorder="little")
    W = (O + 31) // 32
    assert mask.shape[-1] == (O + 7) // 8, (mask.shape, O)
    out = np.zeros((mask.shape[0], W * 4), np.uint8)
    out[:, :mask.shape[-1]] = mask
    return out.view("<u4").view(np.int32).reshape(mask.shape[0], W)


def _upload(arrays: Sequence[np.ndarray],
            device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Ship 4-byte numpy arrays to `device` as ONE host buffer and ONE
    copy (pinned, asynchronous on a card); return typed views in order."""
    parts = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        assert a.dtype in (np.float32, np.int32), a.dtype
        parts.append(a.reshape(-1).view(np.int32))
    host = torch.from_numpy(np.concatenate(parts) if parts
                            else np.zeros(0, np.int32))
    if device.type == "cuda":
        buf = host.pin_memory().to(device, non_blocking=True)
    else:
        buf = host.to(device)
    out, off = [], 0
    for a in arrays:
        n = int(np.prod(a.shape))
        v = buf[off:off + n]
        if a.dtype == np.float32:
            v = v.view(torch.float32)
        out.append(v.view(a.shape))
        off += n
    return tuple(out)


def catalog_tensors(cat_arrays: Dict, device) -> FFDCatalog:
    """The padded catalog arrays (numpy: col_alloc, col_daemon, pt_alloc,
    col_pool, pool_daemon, col_zone, col_ct, and the grid stride ``zc``)
    as device tensors, plus the per-pool column bits the kernel ANDs into
    a new node's surviving columns."""
    device = torch.device(device)
    col_pool = np.asarray(cat_arrays["col_pool"], np.int32)
    pool_daemon = np.asarray(cat_arrays["pool_daemon"], np.float32)
    O = col_pool.shape[0]
    P = pool_daemon.shape[0]
    pool_bits = pack_mask_bits(
        col_pool[None, :] == np.arange(P, dtype=np.int32)[:, None], O)
    zc = int(cat_arrays["zc"])
    t = _upload([np.asarray(cat_arrays["col_alloc"], np.float32),
                 np.asarray(cat_arrays["col_daemon"], np.float32),
                 np.asarray(cat_arrays["pt_alloc"], np.float32),
                 col_pool, pool_daemon, pool_bits,
                 np.asarray(cat_arrays["col_zone"], np.int32),
                 np.asarray(cat_arrays["col_ct"], np.int32)], device)
    cat = FFDCatalog(*t, zc=zc)
    assert cat.O == cat.PT * zc, (cat.O, cat.PT, zc)
    return cat


def problem_tensors(prob: Sequence[np.ndarray], O: int,
                    device) -> FFDProblem:
    """The reference's 17-slot `_problem_args` tuple (numpy, padded;
    slot 2 a [G, O] bool mask or its packed [G, ceil(O/8)] bytes) as the
    scan's device arguments, in one host→device copy.  Rejects what no
    ported scan runs: gangs and the 18-slot priority-band form."""
    if len(prob) != 17:
        raise ValueError("priority-band problems (18 slots) are not "
                         "supported by the scan")
    (group_req, group_count, group_mask, exist_cap, exist_remaining,
     pool_limit, group_ncap, group_dsel, group_dbase, group_dcap,
     group_skew, group_mindom, group_delig, group_whole, group_gang,
     exist_zone, exist_ct) = prob
    if np.asarray(group_gang).any():
        raise ValueError("gang groups need the gang fill, not the scan")
    group_dsel = np.asarray(group_dsel, np.int32)
    t = _upload([np.asarray(group_req, np.float32),
                 np.asarray(group_count, np.int32),
                 pack_mask_bits(np.asarray(group_mask), O),
                 np.asarray(exist_cap, np.int32),
                 np.asarray(exist_remaining, np.float32),
                 np.asarray(pool_limit, np.float32),
                 np.asarray(group_ncap, np.int32),
                 np.asarray(group_whole).astype(np.int32),
                 group_dsel,
                 np.asarray(group_dbase, np.int32),
                 np.asarray(group_dcap, np.int32),
                 np.asarray(group_skew, np.int32),
                 np.asarray(group_mindom, np.int32),
                 np.asarray(group_delig).astype(np.int32),
                 np.asarray(exist_zone, np.int32),
                 np.asarray(exist_ct, np.int32)],
                torch.device(device))
    return FFDProblem(*t, topology=bool((group_dsel > 0).any()))


def problem_from_numpy(prob: Sequence[np.ndarray], cat_arrays: Dict,
                       device) -> Tuple[FFDProblem, FFDCatalog]:
    """The reference's 17-slot problem tuple and its catalog arrays
    (numpy) as the port's kernel arguments on `device`."""
    cat = catalog_tensors(cat_arrays, device)
    return problem_tensors(prob, cat.O, device), cat


# -- the flat result layout ---------------------------------------------------
def flat_layout(G: int, E: int, N: int, D: int,
                explain: int = 0) -> Dict[str, Tuple[int, int]]:
    """(offset, length) of every region of the flat result buffer, plus
    ("total", n)."""
    sizes = [("take_exist", G * E), ("take_new", G * N), ("unsched", G),
             ("dom_placed", G * D), ("used", N * R), ("node_pool", N),
             ("node_zone", N), ("node_ct", N), ("num_active", 1)]
    if explain:
        sizes += [("explain_counts", G * EXPLAIN_C), ("explain_bits", G)]
    out, off = {}, 0
    for name, n in sizes:
        out[name] = (off, n)
        off += n
    out["total"] = (0, off)
    return out


def _region(flat: torch.Tensor, lay: Dict, name: str) -> torch.Tensor:
    off, n = lay[name]
    return flat[off:off + n]


# -- plain PyTorch versions ---------------------------------------------------
def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _fit_count(avail: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """How many pods of per-pod request `req` [R] fit in `avail` [..., R]
    (ffd.py:116): floor((avail + EPS) / req) over req > 0, min, clipped to
    [0, 2^30] before the int32 conversion."""
    eps = _f32(EPS, avail.device)
    safe = torch.where(req > 0, req, torch.ones_like(req))
    counts = torch.floor((avail + eps) / safe)
    counts = torch.where(req > 0, counts, _f32(float(_CAP), avail.device))
    c = counts.min(dim=-1).values
    return torch.clamp(c, 0, _CAP).to(torch.int32)


def _fits(x: torch.Tensor) -> torch.Tensor:
    """all(x >= -EPS) over the resource axis."""
    return (x >= _f32(-EPS, x.device)).all(dim=-1)


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 cumsum with int32 wrap-around (torch accumulates in int64)."""
    return torch.cumsum(x.to(torch.int64), 0).to(torch.int32)


def _prefix_fill(cap: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Greedy fill in index order (ffd.py:125)."""
    before = _cumsum_i32(cap) - cap
    return torch.clamp(torch.minimum(cap, want - before), min=0)


def _atomic_fill(cap: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """ALL-or-nothing fill on the first slot holding all of `want`
    (ffd.py:134)."""
    elig = cap >= want
    first = torch.argmax(elig.to(torch.int32))
    idx = torch.arange(cap.shape[0], device=cap.device)
    take = torch.where((idx == first) & elig.any() & (want > 0), want, 0)
    return take.to(cap.dtype)


def _unpack_bits(bits: torch.Tensor, O: int) -> torch.Tensor:
    """[..., W] i32 words → [..., O] bool."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    b = (bits.unsqueeze(-1) >> shifts) & 1
    return b.reshape(*bits.shape[:-1], -1)[..., :O].to(torch.bool)


def _pt_expand(a_pt: torch.Tensor, zc: int) -> torch.Tensor:
    """[N, PT] → [N, PT*zc]: the (pool,type) axis is a reshape of the
    column axis."""
    n, pt = a_pt.shape
    return a_pt[:, :, None].expand(n, pt, zc).reshape(n, pt * zc)


def _ceil_div(t: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """-(-t // kf) on floor division."""
    return -torch.div(-t, kf, rounding_mode="floor")


def _w32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with the reference's int32 wrap-around."""
    return x.to(torch.int64).to(torch.int32)


def _sum_i32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """int32 sum with int32 wrap-around (torch accumulates in int64)."""
    x = x.to(torch.int64)
    return _w32(x.sum() if dim is None else x.sum(dim))


def _mul_i32(a, b) -> torch.Tensor:
    """int32 product with int32 wrap-around."""
    return _w32(torch.as_tensor(a).to(torch.int64)
                * torch.as_tensor(b).to(torch.int64))


def _slot_expand(a_slot: torch.Tensor, PT: int) -> torch.Tensor:
    """[N, ZC] → [N, PT*ZC]: tile a per-grid-slot mask across every
    (pool,type) block."""
    n, zc = a_slot.shape
    return a_slot[:, None, :].expand(n, PT, zc).reshape(n, PT * zc)


def water_fill(cnt: torch.Tensor, base: torch.Tensor, xmax: torch.Tensor,
               elig: torch.Tensor, skew: torch.Tensor,
               mindom: torch.Tensor) -> torch.Tensor:
    """Split `cnt` pods into per-domain quotas [D] (ffd.py:147
    `_water_fill`): the largest water level L whose final counts
    clip(L, base, base + xmax) respect the skew against the eligible
    minimum (0 while fewer than `mindom` domains are populated) and the
    count, found among the O(D) breakpoint candidates; then the integral
    repair hands the floored-away pods to domains that stay within the
    skew.  Float sums over domains run in index order, as the kernel's."""
    i32, f32 = torch.int32, torch.float32
    dev = base.device
    D = base.shape[0]
    eps = _f32(EPS, dev)
    cnt_f = cnt.to(f32)
    skew_f = skew.to(f32)
    c = base.to(f32)
    elig = elig.to(torch.bool)
    ub = torch.where(elig, _w32(base.to(torch.int64) + xmax).to(f32), c)

    def f_at(L):                                     # [K] → [K, D]
        return torch.minimum(torch.maximum(L[:, None], c[None, :]),
                             ub[None, :])

    def placed(L):                                   # [K]
        d = f_at(L) - c[None, :]
        acc = torch.zeros(L.shape[0], dtype=f32, device=dev)
        for j in range(D):
            acc = acc + d[:, j]
        return acc

    def minf(L):                                     # [K]
        f = f_at(L)
        inf = _f32(float("inf"), dev)
        m = torch.where(elig[None, :], f, inf).min(dim=-1).values
        pop = (torch.where(elig[None, :], f, _f32(0.0, dev))
               > _f32(0.5, dev)).sum(-1)
        return torch.where((mindom > 0) & (pop < mindom), _f32(0.0, dev), m)

    bps = torch.sort(torch.cat([c, ub])).values      # [2D]
    pl = placed(bps)
    slope = ((c[None, :] <= bps[:, None]) & (bps[:, None] < ub[None, :])
             & elig[None, :]).sum(-1)
    cands = torch.cat([
        bps,
        minf(bps) + skew_f,
        bps + (cnt_f - pl) / torch.clamp(slope, min=1).to(f32),
    ])
    ok = ((cands <= minf(cands) + skew_f + eps)
          & (placed(cands) <= cnt_f + eps))
    floor_val = c.min() if D else _f32(0.0, dev)
    L = torch.floor(torch.where(ok, cands, floor_val).max())
    fl = torch.minimum(torch.maximum(L, c), ub)
    x = (fl - c).to(i32)
    leftover = torch.clamp(cnt - _sum_i32(x), min=0)
    m = minf(L[None])[0]
    bumpable = (elig & (c + x.to(f32) < ub)
                & (fl + _f32(1.0, dev) - m <= skew_f + eps))
    x = x + _prefix_fill(bumpable.to(i32), leftover)
    return torch.minimum(x, cnt)


def _clamp_pool_limits(cap_n: torch.Tensor, node_pool: torch.Tensor,
                       limits: torch.Tensor, req: torch.Tensor,
                       P: int) -> torch.Tensor:
    """Pool limits are collective (ffd.py:442): each node's cap is clamped
    by what its pool's budget leaves after lower-index nodes of the same
    pool take theirs."""
    limit_cap = _fit_count(limits, req)                      # [P]
    for p in range(P):
        mask_p = node_pool == p
        cap_p = torch.where(mask_p, cap_n, 0).to(torch.int32)
        before_p = _cumsum_i32(cap_p) - cap_p
        allowed = torch.clamp(limit_cap[p] - before_p, min=0)
        cap_n = torch.where(mask_p, torch.minimum(cap_p, allowed), cap_n)
    return cap_n.to(torch.int32)


class _Scan:
    """One plain-version scan: the per-problem constants and the carry of
    the reference's `lax.scan` (ffd.py:430), updated in place step by
    step."""

    def __init__(self, prob: FFDProblem, cat: FFDCatalog, N: int,
                 work: Optional[Dict[str, int]]):
        dev = prob.group_req.device
        i32, f32 = torch.int32, torch.float32
        self.prob, self.cat, self.N, self.work = prob, cat, N, work
        self.dev = dev
        self.G, self.E, self.P, self.D = prob.G, prob.E, prob.P, prob.D
        self.zc, self.PT, self.O = cat.zc, cat.PT, cat.O
        self.gmask_all = _unpack_bits(prob.mask_bits, cat.O)
        self.col_avail = cat.col_alloc - cat.col_daemon
        self.pool_idx = [cat.col_pool == p for p in range(prob.P)]
        self.idx = torch.arange(N, dtype=i32, device=dev)
        # the carry
        self.exist_rem = prob.exist_remaining.clone()
        self.used = torch.zeros((N, R), dtype=f32, device=dev)
        self.colmask = torch.zeros((N, cat.O), dtype=torch.bool, device=dev)
        self.active = torch.zeros(N, dtype=torch.bool, device=dev)
        self.node_pool = torch.zeros(N, dtype=i32, device=dev)
        self.node_zone = torch.full((N,), -1, dtype=i32, device=dev)
        self.node_ct = torch.full((N,), -1, dtype=i32, device=dev)
        self.num_active = torch.zeros((), dtype=i32, device=dev)
        self.limits = prob.pool_limit.clone()

    def light(self, g: int):
        """The light step (ffd.py:460-587).  Returns (take_exist [E],
        take_new [N], unsched)."""
        prob, cat, work = self.prob, self.cat, self.work
        i32, f32 = torch.int32, torch.float32
        N, E, P, zc, PT = self.N, self.E, self.P, self.zc, self.PT
        idx = self.idx
        req = prob.group_req[g]
        cnt = prob.group_count[g]
        ncap = prob.group_ncap[g]
        whole = prob.group_whole[g] != 0
        gmask = self.gmask_all[g]
        used, colmask, active = self.used, self.colmask, self.active
        node_pool, num_active = self.node_pool, self.num_active

        # -- 1. existing nodes
        take_e = None
        if E:
            cap_e = torch.minimum(_fit_count(self.exist_rem, req),
                                  prob.exist_cap[g])
            take_e = torch.where(whole, _atomic_fill(cap_e, cnt),
                                 _prefix_fill(cap_e, cnt))
            self.exist_rem = self.exist_rem - take_e[:, None] * req
            c1 = cnt - take_e.sum().to(i32)
        else:
            c1 = cnt

        # -- 2. in-flight nodes
        cap_npt = _fit_count(cat.pt_alloc[None] - used[:, None], req)
        elig_pt = (colmask & gmask[None]).view(N, PT, zc).any(dim=-1)
        best = torch.where(elig_pt, cap_npt, 0).max(dim=1).values
        if work is not None:
            # existing rows, active nodes' eligible blocks, pool budgets,
            # the empty-node fit of each admitted column, and the cascade's
            # three fits and one test per pool
            work["fit"] += (E + P + 3 * P + int(gmask.sum())
                            + int((elig_pt & active[:, None]).sum()))
            work["test"] += P
        cap_n = torch.where(active, torch.minimum(best, ncap), 0).to(i32)
        cap_pfx = _clamp_pool_limits(cap_n, node_pool, self.limits, req, P)
        cap_full = torch.minimum(cap_n, _fit_count(self.limits, req)[
            node_pool.long()])
        cap_n = torch.where(whole, cap_full, cap_pfx)
        take_n = torch.where(whole, _atomic_fill(cap_n, c1),
                             _prefix_fill(cap_n, c1))
        used = used + take_n[:, None] * req
        touched = take_n > 0
        if work is not None:
            work["test"] += int((elig_pt & touched[:, None]).sum())
        colmask = torch.where(touched[:, None], colmask & gmask[None],
                              colmask)
        ok_pt = _fits(cat.pt_alloc[None] - used[:, None])       # [N, PT]
        colmask = colmask & _pt_expand(ok_pt, zc)
        # segment_sum of integer takes: exact in float32 below 2^24, so
        # the summation order does not matter
        pool_take = torch.zeros(P, dtype=f32, device=self.dev).index_add_(
            0, node_pool.long(), take_n.to(f32))
        limits = self.limits - pool_take[:, None] * req
        c2 = c1 - take_n.sum().to(i32)

        # -- 3. open new nodes, pools in priority order
        per_col = torch.minimum(_fit_count(self.col_avail, req), ncap)
        col_feas = gmask & (per_col >= 1)
        c_rem = c2
        k_new_total = torch.zeros(N, dtype=i32, device=self.dev)
        for p in range(P):
            cols_p = col_feas & self.pool_idx[p]
            k_full = torch.where(cols_p, per_col, 0).max().to(i32)
            pd = cat.pool_daemon[p]
            can = (cols_p.any() & _fits(limits[p] - pd - req)
                   & (c_rem > 0) & (k_full > 0))
            can = can & torch.where(
                whole,
                (k_full >= c_rem)
                & (_fit_count((limits[p] - pd)[None], req)[0] >= c_rem),
                True)
            kf = torch.clamp(k_full, min=1)
            t = torch.minimum(c_rem, _fit_count(limits[p][None], req)[0])
            m_t = _ceil_div(t, kf)
            t = torch.minimum(t, _fit_count(
                (limits[p] - m_t.to(f32) * pd)[None], req)[0])
            m_need = torch.where(can, _ceil_div(t, kf), 0).to(i32)
            m = torch.minimum(m_need, N - num_active)
            newmask = (idx >= num_active) & (idx < num_active + m)
            pos = idx - num_active
            taken_new = torch.minimum(t, _mul_i32(m, k_full))
            k_node = torch.where(
                newmask,
                torch.where(pos == m - 1,
                            taken_new - _mul_i32(m - 1, k_full), k_full),
                0).to(i32)
            new_used = pd[None] + k_node[:, None].to(f32) * req
            used = torch.where(newmask[:, None], new_used, used)
            new_ok_pt = _fits(cat.pt_alloc[None] - new_used[:, None])
            new_colmask = cols_p[None] & _pt_expand(new_ok_pt, zc)
            if work is not None:
                work["test"] += int(m) * int(
                    cols_p.view(PT, zc).any(dim=-1).sum())
            colmask = torch.where(newmask[:, None], new_colmask, colmask)
            active = active | newmask
            node_pool = torch.where(newmask, p, node_pool).to(i32)
            num_active = num_active + m
            limits = limits.clone()
            limits[p] = limits[p] + (-(m.to(f32) * pd
                                       + taken_new.to(f32) * req))
            k_new_total = k_new_total + k_node
            c_rem = c_rem - taken_new
        self.used, self.colmask, self.active = used, colmask, active
        self.node_pool, self.num_active, self.limits = (node_pool,
                                                        num_active, limits)
        return take_e, take_n + k_new_total, c_rem

    def heavy(self, g: int):
        """The heavy step (ffd.py:589-818): per-domain quotas by
        `water_fill`, then existing, in-flight and new-node fills per
        domain, each touched or opened node pinned to its domain.
        Returns (take_exist [E], take_new [N], unsched, dom_placed [D])."""
        prob, cat, work = self.prob, self.cat, self.work
        i32, f32 = torch.int32, torch.float32
        dev = self.dev
        N, E, P, D, zc, PT = self.N, self.E, self.P, self.D, self.zc, self.PT
        idx = self.idx
        req = prob.group_req[g]
        cnt = prob.group_count[g]
        ncap = prob.group_ncap[g]
        dsel = int(prob.group_dsel[g])
        gmask = self.gmask_all[g]
        used, colmask, active = self.used, self.colmask, self.active
        node_pool, num_active = self.node_pool, self.num_active
        dom_ids = torch.arange(D, dtype=i32, device=dev)

        col_dom = cat.col_zone if dsel == 1 else cat.col_ct          # [O]
        ex_dom = prob.exist_zone if dsel == 1 else prob.exist_ct     # [E]
        dom_cols = col_dom[None, :] == dom_ids[:, None]              # [D, O]
        dom_ex = ex_dom[None, :] == dom_ids[:, None]                 # [D, E]

        # -- capacity estimates per domain (for the water-fill)
        if E:
            cap_e = torch.minimum(_fit_count(self.exist_rem, req),
                                  prob.exist_cap[g])
            cap_ed = torch.where(dom_ex, cap_e[None, :], 0).to(i32)  # [D, E]
        else:
            cap_ed = torch.zeros((D, 0), dtype=i32, device=dev)
        cap_npt = _fit_count(cat.pt_alloc[None] - used[:, None], req)
        cap_no = torch.where(colmask & gmask[None],
                             _pt_expand(cap_npt, zc), 0)             # [N, O]
        zc_dom = col_dom[:zc]
        slotmax = cap_no.view(N, PT, zc).max(dim=1).values           # [N, ZC]
        cap_nd = torch.where(
            zc_dom[None, :, None] == dom_ids[None, None, :],
            slotmax[:, :, None], 0).max(dim=1).values.T              # [D, N]
        cap_nd = torch.minimum(cap_nd, ncap)
        cap_nd = torch.where(active[None, :], cap_nd, 0).to(i32)
        if work is not None:
            # existing rows, active nodes' eligible blocks, pool budgets,
            # the empty-node fit of each admitted column
            elig_pt = (colmask & gmask[None]).view(N, PT, zc).any(dim=-1)
            work["fit"] += (E + 2 * P + int(gmask.sum())
                            + int((elig_pt & active[:, None]).sum()))
            work["test"] += P
        # each in-flight node serves ONE domain: the best capacity, ties
        # rotated over the real domain count
        d_real = torch.clamp(col_dom.max() + 1, min=1)
        score = _w32(_mul_i32(torch.minimum(cap_nd, cnt), D + 1).to(
            torch.int64) + (idx[None, :] + dom_ids[:, None]) % d_real)
        bd = torch.argmax(score, dim=0).to(i32)                       # [N]
        sel_nd = dom_ids[:, None] == bd[None, :]
        cap_nd = torch.where(sel_nd, cap_nd, 0).to(i32)

        per_col = torch.minimum(_fit_count(self.col_avail, req), ncap)
        col_feas = gmask & (per_col >= 1)
        kfull_pd = torch.stack([
            torch.where(dom_cols & (col_feas & self.pool_idx[p])[None, :],
                        per_col[None, :], 0).max(-1).values
            for p in range(P)]).to(i32)                              # [P, D]
        limits = self.limits
        rooms = torch.stack([_fits(limits[p] - cat.pool_daemon[p] - req)
                             for p in range(P)])                    # [P]
        afford = torch.stack([_fit_count(limits[p][None], req)[0]
                              for p in range(P)])                   # [P]
        new_est = torch.where(
            rooms[:, None],
            torch.minimum(_mul_i32(N - num_active, kfull_pd),
                          afford[:, None]), 0).max(0).values        # [D]
        capacity = _w32(_sum_i32(cap_ed, -1).to(torch.int64)
                        + _sum_i32(cap_nd, -1) + new_est)           # [D]
        afford_total = _f32(0.0, dev)
        for p in range(P):
            afford_total = afford_total + afford[p].to(f32)
        cap_sum = (_sum_i32(cap_ed).to(f32) if E else _f32(0.0, dev))
        cnt_eff = torch.minimum(cnt.to(f32), cap_sum + afford_total).to(i32)
        if work is not None:
            # the water-fill: 16D evaluations of placed/minf, 3 scalar
            # operations per domain each
            work["flops"] = work.get("flops", 0) + 48 * D * D
        want = water_fill(cnt_eff, prob.group_dbase[g],
                          torch.minimum(capacity, prob.group_dcap[g]),
                          prob.group_delig[g], prob.group_skew[g],
                          prob.group_mindom[g])                      # [D]
        unplaceable = cnt - _sum_i32(want)

        # -- 1. existing nodes, per domain
        if E:
            take_ed = torch.stack([_prefix_fill(cap_ed[d], want[d])
                                   for d in range(D)])               # [D, E]
            take_e = _sum_i32(take_ed, 0)
            self.exist_rem = self.exist_rem - take_e[:, None] * req
            dom_exist = _sum_i32(take_ed, -1)
            want = want - dom_exist
        else:
            take_e = None
            dom_exist = torch.zeros(D, dtype=i32, device=dev)

        # -- 2. in-flight nodes, per domain
        cap_nd = torch.minimum(cap_nd, want[:, None])
        cap_n_flat = _clamp_pool_limits(_sum_i32(cap_nd, 0), node_pool,
                                        limits, req, P)
        cap_nd = torch.minimum(cap_nd, cap_n_flat[None, :])
        take_nd = torch.stack([_prefix_fill(cap_nd[d], want[d])
                               for d in range(D)])                   # [D, N]
        take_n = _sum_i32(take_nd, 0)
        used = used + take_n[:, None] * req
        touched = take_n > 0
        if work is not None:
            work["test"] += int(((colmask & gmask[None]).view(N, PT, zc)
                                 .any(dim=-1) & touched[:, None]).sum())
        node_dcols = _slot_expand(zc_dom[None, :] == bd[:, None], PT)
        colmask = torch.where(touched[:, None],
                              colmask & gmask[None] & node_dcols, colmask)
        ok_pt = _fits(cat.pt_alloc[None] - used[:, None])
        colmask = colmask & _pt_expand(ok_pt, zc)
        if dsel == 1:
            self.node_zone = torch.where(touched, bd, self.node_zone)
        else:
            self.node_ct = torch.where(touched, bd, self.node_ct)
        pool_take = torch.zeros(P, dtype=f32, device=dev).index_add_(
            0, node_pool.long(), take_n.to(f32))
        limits = limits - pool_take[:, None] * req
        dom_flight = _sum_i32(take_nd, -1)
        want = want - dom_flight

        # -- 3. open new nodes, per pool × domain
        k_new_total = torch.zeros(N, dtype=i32, device=dev)
        new_dom_placed = torch.zeros(D, dtype=i32, device=dev)
        for p in range(P):
            cols_p = col_feas & self.pool_idx[p]
            kfull_d = kfull_pd[p]
            pd = cat.pool_daemon[p]
            # the pool budget is shared over domains, in domain order
            rem_budget = limits[p]
            slots_left = N - num_active
            m_list, taken_list = [], []
            for d in range(D):
                can = (kfull_d[d] > 0) & (want[d] > 0)
                kf = torch.clamp(kfull_d[d], min=1)
                t = torch.minimum(want[d],
                                  _fit_count(rem_budget[None], req)[0])
                m_t = _ceil_div(t, kf)
                t = torch.minimum(t, _fit_count(
                    (rem_budget - m_t.to(f32) * pd)[None], req)[0])
                m_need = torch.where(can, _ceil_div(t, kf), 0).to(i32)
                m_d = torch.minimum(m_need, slots_left)
                taken_d = torch.minimum(t, _mul_i32(m_d, kfull_d[d]))
                if work is not None:
                    work["fit"] += 2
                rem_budget = rem_budget - (m_d.to(f32) * pd
                                           + taken_d.to(f32) * req)
                slots_left = slots_left - m_d
                m_list.append(m_d)
                taken_list.append(taken_d)
            m_d = torch.stack(m_list).to(i32)                        # [D]
            taken_d = torch.stack(taken_list).to(i32)                # [D]
            starts = num_active + _cumsum_i32(m_d) - m_d             # [D]
            in_dom = ((idx[None, :] >= starts[:, None])
                      & (idx[None, :] < (starts + m_d)[:, None]))     # [D, N]
            is_last = idx[None, :] == (starts + m_d - 1)[:, None]
            k_dn = torch.where(
                in_dom,
                torch.where(is_last,
                            (taken_d - _mul_i32(m_d - 1, kfull_d))[:, None],
                            kfull_d[:, None]),
                0)                                                   # [D, N]
            k_node = _sum_i32(k_dn, 0)
            newmask = in_dom.any(0)
            new_used = pd[None] + k_node[:, None].to(f32) * req
            used = torch.where(newmask[:, None], new_used, used)
            new_bd = _sum_i32(in_dom.to(i32) * dom_ids[:, None], 0)
            nd_cols = _slot_expand(zc_dom[None, :] == new_bd[:, None], PT)
            new_ok_pt = _fits(cat.pt_alloc[None] - new_used[:, None])
            if work is not None:
                work["test"] += int(m_d.sum()) * int(
                    cols_p.view(PT, zc).any(dim=-1).sum())
            new_colmask = nd_cols & cols_p[None] & _pt_expand(new_ok_pt, zc)
            colmask = torch.where(newmask[:, None], new_colmask, colmask)
            if dsel == 1:
                self.node_zone = torch.where(newmask, new_bd, self.node_zone)
            else:
                self.node_ct = torch.where(newmask, new_bd, self.node_ct)
            active = active | newmask
            node_pool = torch.where(newmask, p, node_pool).to(i32)
            num_active = num_active + _sum_i32(m_d)
            limits = limits.clone()
            limits[p] = limits[p] + (-(_sum_i32(m_d).to(f32) * pd
                                       + _sum_i32(taken_d).to(f32) * req))
            k_new_total = k_new_total + k_node
            new_dom_placed = new_dom_placed + taken_d
            want = want - taken_d

        self.used, self.colmask, self.active = used, colmask, active
        self.node_pool, self.num_active, self.limits = (node_pool,
                                                        num_active, limits)
        dom_placed = dom_exist + dom_flight + new_dom_placed
        return (take_e, take_n + k_new_total, unplaceable + _sum_i32(want),
                dom_placed)


def _scan_reference(prob: FFDProblem, cat: FFDCatalog, N: int,
                    flat: torch.Tensor, lay: Dict, limits_out: torch.Tensor,
                    work: Optional[Dict[str, int]], topology: bool) -> None:
    """The plain scan: per group the light step, or with `topology` the
    heavy step for a group with dsel > 0 (the reference's
    `lax.cond(dsel > 0, heavy, light)`, ffd.py:1057).  Writes the
    kernels' outputs."""
    f32 = torch.float32
    s = _Scan(prob, cat, N, work)
    dsel = prob.group_dsel.tolist()
    te_rows, tn_rows, un_rows, dp_rows = [], [], [], []
    zeros_d = torch.zeros(prob.D, dtype=torch.int32, device=flat.device)
    for g in range(prob.G):
        if topology and dsel[g] > 0:
            te, tn, un, dp = s.heavy(g)
        else:
            (te, tn, un), dp = s.light(g), zeros_d
        te_rows.append(te)
        tn_rows.append(tn)
        un_rows.append(un)
        dp_rows.append(dp)

    def put(name, value):
        _region(flat, lay, name).copy_(value.reshape(-1).to(f32))

    if s.E:
        put("take_exist", torch.stack(te_rows))
    put("take_new", torch.stack(tn_rows))
    put("unsched", torch.stack(un_rows))
    put("dom_placed", torch.stack(dp_rows))
    put("used", s.used)
    put("node_pool", s.node_pool)
    put("node_zone", s.node_zone)
    put("node_ct", s.node_ct)
    put("num_active", s.num_active)
    limits_out.copy_(s.limits)


def light_scan_reference(prob: FFDProblem, cat: FFDCatalog, N: int,
                         flat: torch.Tensor, lay: Dict,
                         limits_out: torch.Tensor,
                         work: Optional[Dict[str, int]] = None) -> None:
    """Plain PyTorch version of K1: `_solve_ffd_impl`'s light branch
    (ffd.py:460-587) transcribed step for step, a Python loop over groups
    and pools.  Writes the same outputs as the kernel.

    Given a `work` dict, adds to it what K1 computes on this data: "fit",
    the R-vector `_fit_count`s, and "test", the R-vector all-fits tests.
    K1 fits an in-flight node only against the (pool,type) blocks that
    still hold a surviving column the group admits, and narrows only
    touched and opened nodes, on the blocks their candidate columns
    span."""
    _scan_reference(prob, cat, N, flat, lay, limits_out, work,
                    topology=False)


def topo_scan_reference(prob: FFDProblem, cat: FFDCatalog, N: int,
                        flat: torch.Tensor, lay: Dict,
                        limits_out: torch.Tensor,
                        work: Optional[Dict[str, int]] = None) -> None:
    """Plain PyTorch version of K3: the whole scan, light or heavy step
    per group as the reference's `lax.cond` picks.  `work` counts as in
    `light_scan_reference`; the heavy step adds its per-pool budget fits,
    the per-(pool, domain) fits of the new-node loop, and the water-fill's
    scalar float operations under "flops"."""
    _scan_reference(prob, cat, N, flat, lay, limits_out, work,
                    topology=True)


def pack_reference(prob: FFDProblem, cat: FFDCatalog, N: int,
                   flat: torch.Tensor, lay: Dict,
                   limits: torch.Tensor) -> None:
    """Plain PyTorch version of K2: the explain=1 aux (ffd.py:1113-1214),
    the topology class (ffd.py:1141-1175) included."""
    dev = flat.device
    i32, f32 = torch.int32, torch.float32
    G = prob.G
    zc, PT = cat.zc, cat.PT
    gmask_pt = _unpack_bits(prob.mask_bits, cat.O).view(G, PT, zc)
    cols_per_block = gmask_pt.sum(dim=-1).to(i32)            # [G, PT]
    pt_daemon = cat.col_daemon.view(PT, zc, R)[:, 0]
    pt_pool = cat.col_pool.view(PT, zc)[:, 0].long()
    req = prob.group_req
    fits_pt = _fits(cat.pt_alloc[None] - pt_daemon[None]
                    - req[:, None])                          # [G, PT]
    lim_ok = _fits(limits[None] - cat.pool_daemon[None]
                   - req[:, None])                           # [G, P]
    lim_ok_pt = lim_ok[:, pt_pool]
    elim_fit = torch.where(~fits_pt, cols_per_block, 0).sum(-1)
    elim_limit = torch.where(fits_pt & ~lim_ok_pt,
                             cols_per_block, 0).sum(-1)
    # topology: admitted columns of fitting, fundable blocks whose
    # domain is ineligible or at the skew ceiling after the group's
    # own placements (dom_placed); domain of a column via its grid slot
    D = prob.D
    f_dom = prob.group_dbase + _region(flat, lay, "dom_placed").view(
        G, D).to(i32)                                        # [G, D]
    delig = prob.group_delig != 0
    big = torch.tensor(2 ** 29, dtype=i32, device=dev)
    m_elig = torch.where(delig, f_dom, big).min(-1).values   # [G]
    pop = (torch.where(delig, f_dom, 0) > 0).sum(-1)
    m_floor = torch.where((prob.group_mindom > 0)
                          & (pop < prob.group_mindom), 0, m_elig)
    ceiling = m_floor + prob.group_skew                      # [G]
    blocked_dom = (~delig) | (f_dom >= ceiling[:, None])     # [G, D]
    slot_dom = torch.where((prob.group_dsel == 1)[:, None],
                           cat.col_zone[None, :zc],
                           cat.col_ct[None, :zc])            # [G, ZC]
    slot_blocked = torch.gather(
        blocked_dom, 1, torch.clamp(slot_dom, 0, D - 1).long())
    ok_pt = fits_pt & lim_ok_pt                              # [G, PT]
    elim_topo = torch.where(
        (prob.group_dsel > 0)[:, None, None] & slot_blocked[:, None, :]
        & ok_pt[:, :, None], gmask_pt.to(i32), 0).sum((1, 2))
    stranded = _region(flat, lay, "unsched") > 0
    ok_cols = torch.where(ok_pt, cols_per_block, 0).sum(-1)
    elim_whole = torch.where((prob.group_whole != 0) & stranded,
                             ok_cols, 0)
    na = _region(flat, lay, "num_active")[0]
    slots = (stranded & (na >= N)).to(elim_fit.dtype)
    counts = torch.stack([elim_fit, elim_limit, elim_topo, elim_whole,
                          slots], dim=1)                     # [G, C]
    weights = torch.tensor([1 << i for i in range(EXPLAIN_C)],
                           device=dev, dtype=counts.dtype)
    bits = ((counts > 0).to(counts.dtype) * weights).sum(-1)
    _region(flat, lay, "explain_counts").copy_(
        counts.to(f32).reshape(-1))
    _region(flat, lay, "explain_bits").copy_(bits.to(f32))


# -- kernel wrappers ----------------------------------------------------------
def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_args(prob: FFDProblem, cat: FFDCatalog, N: int,
                device) -> None:
    G, E, P, W, D, O = prob.G, prob.E, prob.P, cat.W, prob.D, cat.O
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shp in (
            ("group_req", prob.group_req, f32, (G, R)),
            ("group_count", prob.group_count, i32, (G,)),
            ("mask_bits", prob.mask_bits, i32, (G, W)),
            ("exist_cap", prob.exist_cap, i32, (G, E)),
            ("exist_remaining", prob.exist_remaining, f32, (E, R)),
            ("pool_limit", prob.pool_limit, f32, (P, R)),
            ("group_ncap", prob.group_ncap, i32, (G,)),
            ("group_whole", prob.group_whole, i32, (G,)),
            ("group_dsel", prob.group_dsel, i32, (G,)),
            ("group_dbase", prob.group_dbase, i32, (G, D)),
            ("group_dcap", prob.group_dcap, i32, (G, D)),
            ("group_skew", prob.group_skew, i32, (G,)),
            ("group_mindom", prob.group_mindom, i32, (G,)),
            ("group_delig", prob.group_delig, i32, (G, D)),
            ("exist_zone", prob.exist_zone, i32, (E,)),
            ("exist_ct", prob.exist_ct, i32, (E,)),
            ("col_alloc", cat.col_alloc, f32, (O, R)),
            ("col_daemon", cat.col_daemon, f32, (O, R)),
            ("pt_alloc", cat.pt_alloc, f32, (cat.PT, R)),
            ("col_pool", cat.col_pool, i32, (O,)),
            ("pool_daemon", cat.pool_daemon, f32, (P, R)),
            ("pool_bits", cat.pool_bits, i32, (P, W)),
            ("col_zone", cat.col_zone, i32, (O,)),
            ("col_ct", cat.col_ct, i32, (O,))):
        _check(t, name, dt, shp, device)
    if N < 1 or G < 1 or D < 1:
        raise ValueError(f"empty problem: G={G}, N={N}, D={D}")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check_outputs(prob: FFDProblem, flat: torch.Tensor, lay: Dict,
                   limits_out: torch.Tensor) -> None:
    dev = flat.device
    _check(flat, "flat", torch.float32, (lay["total"][1],), dev)
    _check(limits_out, "limits_out", torch.float32, (prob.P, R), dev)


def _launch_scan(name: str, prob: FFDProblem, cat: FFDCatalog, N: int,
                 flat: torch.Tensor, lay: Dict,
                 limits_out: torch.Tensor) -> None:
    """Launch K1 or K3: both take the same argument list (K1 never reads
    the topology arguments)."""
    from karpenter_tpu_torch.solver import _cuda
    dev = flat.device
    G, E, P, D = prob.G, prob.E, prob.P, prob.D
    W = cat.W
    if P > MAX_POOLS:
        raise ValueError(f"{P} node pools: the kernels take at most "
                         f"{MAX_POOLS}")
    if D > MAX_DOMAINS:
        raise ValueError(f"{D} topology domains: the kernels take at most "
                         f"{MAX_DOMAINS}")
    scratch_f = torch.empty(E * R + N * R, dtype=torch.float32, device=dev)
    scratch_i = torch.empty(W * N + 4 * N + E, dtype=torch.int32,
                            device=dev)
    exist_rem, used = scratch_f[:E * R], scratch_f[E * R:]
    colmask = scratch_i[:W * N]
    rest = scratch_i[W * N:]
    active, node_pool = rest[:N], rest[N:2 * N]
    node_zone, node_ct = rest[2 * N:3 * N], rest[3 * N:4 * N]
    cap_e = rest[4 * N:]
    reg = lambda name_: _region(flat, lay, name_)  # noqa: E731
    ptrs = [
        prob.group_req, prob.group_count, prob.mask_bits, prob.exist_cap,
        prob.exist_remaining, prob.pool_limit, prob.group_ncap,
        prob.group_whole,
        cat.col_alloc, cat.col_daemon, cat.pt_alloc, cat.col_pool,
        cat.pool_daemon, cat.pool_bits,
        exist_rem, used, colmask, active, node_pool, cap_e, limits_out,
        reg("take_exist"), reg("take_new"), reg("unsched"),
        reg("dom_placed"),
        reg("used"), reg("node_pool"), reg("node_zone"), reg("node_ct"),
        reg("num_active"),
        prob.group_dsel, prob.group_dbase, prob.group_dcap,
        prob.group_skew, prob.group_mindom, prob.group_delig,
        prob.exist_zone, prob.exist_ct, cat.col_zone, cat.col_ct,
        node_zone, node_ct,
    ]
    dims = [G, E, N, cat.O, cat.PT, cat.zc, P, D, W]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.launch(name, [_ptr(t) for t in ptrs], dims, stream)


def light_scan(prob: FFDProblem, cat: FFDCatalog, N: int,
               flat: torch.Tensor, lay: Dict,
               limits_out: torch.Tensor) -> None:
    """K1: the light FFD scan over all groups.  Writes the flat regions
    take_exist, take_new, unsched, dom_placed, used, node_pool/zone/ct
    and num_active, and the final pool budgets into `limits_out`.
    Refuses a problem with a domain group (that is K3's).  CUDA tensors
    launch the kernel; CPU tensors run `light_scan_reference`."""
    dev = flat.device
    _check_args(prob, cat, N, dev)
    _check_outputs(prob, flat, lay, limits_out)
    if prob.topology:
        raise ValueError("zone/capacity-type domain groups need the heavy "
                         "step: topo_scan (K3), not light_scan (K1)")
    if dev.type != "cuda":
        light_scan_reference(prob, cat, N, flat, lay, limits_out)
        return
    _launch_scan("ffd_light_scan", prob, cat, N, flat, lay, limits_out)
    light_scan.launches += 1


light_scan.launches = 0


def topo_scan(prob: FFDProblem, cat: FFDCatalog, N: int,
              flat: torch.Tensor, lay: Dict,
              limits_out: torch.Tensor) -> None:
    """K3: the FFD scan with the heavy step for groups with dsel > 0 and
    the light step for the rest; writes what `light_scan` writes, plus
    the per-group dom_placed rows and the nodes' zone/capacity-type pins.
    CUDA tensors launch the kernel; CPU tensors run
    `topo_scan_reference`."""
    dev = flat.device
    _check_args(prob, cat, N, dev)
    _check_outputs(prob, flat, lay, limits_out)
    if dev.type != "cuda":
        topo_scan_reference(prob, cat, N, flat, lay, limits_out)
        return
    _launch_scan("ffd_topo_scan", prob, cat, N, flat, lay, limits_out)
    topo_scan.launches += 1


topo_scan.launches = 0


def pack(prob: FFDProblem, cat: FFDCatalog, N: int, flat: torch.Tensor,
         lay: Dict, limits: torch.Tensor) -> None:
    """K2: the explain=1 counts, written into the flat buffer (which must
    hold them) from the scan's outputs and final pool budgets `limits`.
    CUDA tensors launch the kernel; CPU tensors run `pack_reference`."""
    dev = flat.device
    _check_args(prob, cat, N, dev)
    _check_outputs(prob, flat, lay, limits)
    if "explain_counts" not in lay:
        raise ValueError("the flat layout holds no explain counts")
    if dev.type != "cuda":
        pack_reference(prob, cat, N, flat, lay, limits)
        return
    from karpenter_tpu_torch.solver import _cuda
    if prob.D > MAX_DOMAINS:
        raise ValueError(f"{prob.D} topology domains: the pack takes at "
                         f"most {MAX_DOMAINS}")
    reg = lambda name: _region(flat, lay, name)  # noqa: E731
    ptrs = [
        prob.mask_bits, prob.group_req, prob.group_whole,
        cat.pt_alloc, cat.col_daemon, cat.col_pool, cat.pool_daemon,
        limits, reg("unsched"), reg("num_active"),
        reg("explain_counts"), reg("explain_bits"),
        reg("dom_placed"), prob.group_dsel, prob.group_dbase,
        prob.group_skew, prob.group_mindom, prob.group_delig,
        cat.col_zone, cat.col_ct,
    ]
    dims = [prob.G, N, cat.PT, cat.zc, prob.P, cat.W, prob.D]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.launch("ffd_pack", [_ptr(t) for t in ptrs], dims, stream)
    pack.launches += 1


pack.launches = 0


def solve_ffd(prob: FFDProblem, cat: FFDCatalog, max_nodes: int,
              explain: int = 0) -> torch.Tensor:
    """One solve: the scan — K3 when any group has a zone/capacity-type
    domain constraint, K1 otherwise — then, with explain=1, K2.  Returns
    the flat f32 result buffer on the problem's device (not
    synchronised)."""
    if explain not in (0, 1):
        raise ValueError(f"explain={explain}: the pack computes counts "
                         "(1) or nothing (0)")
    dev = prob.group_req.device
    N = max_nodes
    lay = flat_layout(prob.G, prob.E, N, prob.D, explain)
    flat = torch.empty(lay["total"][1], dtype=torch.float32, device=dev)
    limits = torch.empty((prob.P, R), dtype=torch.float32, device=dev)
    scan = topo_scan if prob.topology else light_scan
    scan(prob, cat, N, flat, lay, limits)
    if explain:
        pack(prob, cat, N, flat, lay, limits)
    return flat


def unpack(packed, G: int, E: int, N: int, RDIM: int, D: int,
           explain: int = 0) -> Dict:
    """Split the flat result buffer into named host arrays (ffd.py:1677,
    dense take_new rows)."""
    flat = np.asarray(packed)
    if not flat.flags.writeable:
        flat = np.array(flat)
    lay = flat_layout(G, E, N, D, explain)
    assert RDIM == R and flat.shape == (lay["total"][1],), flat.shape

    def reg(name):
        off, n = lay[name]
        return flat[off:off + n]

    out = dict(
        take_exist=reg("take_exist").reshape(G, E),
        take_new=reg("take_new").reshape(G, N),
        unsched=reg("unsched"),
        dom_placed=reg("dom_placed").reshape(G, D),
        used=reg("used").reshape(N, RDIM),
        node_pool=reg("node_pool").astype(np.int32),
        node_zone=reg("node_zone").astype(np.int32),
        node_ct=reg("node_ct").astype(np.int32),
        num_active=reg("num_active")[0],
    )
    if explain:
        out["explain_counts"] = reg("explain_counts").reshape(
            G, EXPLAIN_C).astype(np.int64)
        out["explain_bits"] = reg("explain_bits").astype(np.int64)
    return out
