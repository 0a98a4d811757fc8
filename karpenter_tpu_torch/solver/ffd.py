"""The grouped-FFD solve on the card: kernel wrappers and plain versions.

The JAX reference (`karpenter_tpu/solver/ffd.py` `_solve_ffd_impl`) is one
jitted `lax.scan` over pod equivalence classes.  This module runs the
scan's light branch — every class without a zone/capacity-type domain
constraint and without a gang — as two hand-written CUDA kernels:

  * ``light_scan`` (K1, `csrc/ffd_light_scan.cu`): the whole G-step scan
    in one launch; writes the dense result rows straight into the flat
    result buffer and leaves the final pool budgets in a small carry.
  * ``pack`` (K2, `csrc/ffd_pack.cu`): the take_new top-K compaction
    (``sparse_n``) and the explain=1 elimination counts, from K1's final
    state, at the offsets `unpack` expects.

Beside each kernel sits its plain PyTorch version (``light_scan_reference``,
``pack_reference``), a transcription of the reference with a Python loop
over groups and pools.  A wrapper runs the kernel for a CUDA tensor and
the plain version for a CPU tensor; there is no fallback from one to the
other.  Each wrapper counts its kernel launches in ``.launches``.

The flat result buffer has exactly the reference's layout (ffd.py:1258):

    take_exist G*E | take_new G*N  (or cnt G*K, idx G*K, nnz G)
    | unsched G | dom_placed G*D | used N*R | node_pool N | node_zone N
    | node_ct N | num_active 1 | [explain: counts G*5, bits G]

and `unpack` splits it into the same named host arrays.
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
    """The per-solve half of the kernel arguments (light branch only)."""
    group_req: torch.Tensor        # [G, R] f32
    group_count: torch.Tensor      # [G] i32
    mask_bits: torch.Tensor        # [G, W] i32, bit o%32 of word o//32
    exist_cap: torch.Tensor        # [G, E] i32
    exist_remaining: torch.Tensor  # [E, R] f32
    pool_limit: torch.Tensor       # [P, R] f32 (inf = unlimited)
    group_ncap: torch.Tensor       # [G] i32
    group_whole: torch.Tensor      # [G] i32 0/1
    D: int                         # padded domain width of dom_placed

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
    col_pool, pool_daemon, and the grid stride ``zc``) as
    device tensors, plus the per-pool column bits the kernel ANDs into a
    new node's surviving columns."""
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
                 col_pool, pool_daemon, pool_bits], device)
    cat = FFDCatalog(*t, zc=zc)
    assert cat.O == cat.PT * zc, (cat.O, cat.PT, zc)
    return cat


def problem_tensors(prob: Sequence[np.ndarray], O: int,
                    device) -> FFDProblem:
    """The reference's 17-slot `_problem_args` tuple (numpy, padded;
    slot 2 a [G, O] bool mask or its packed [G, ceil(O/8)] bytes) as the
    light scan's device arguments, in one host→device copy.  Rejects what
    the light branch cannot run: zone/capacity-type domain groups, gangs,
    and the 18-slot priority-band form."""
    if len(prob) != 17:
        raise ValueError("priority-band problems (18 slots) are not "
                         "supported by the light scan")
    (group_req, group_count, group_mask, exist_cap, exist_remaining,
     pool_limit, group_ncap, group_dsel, group_dbase, _dcap, _skew,
     _mindom, _delig, group_whole, group_gang, _ez, _ect) = prob
    if np.asarray(group_dsel).any():
        raise ValueError("zone/capacity-type domain groups need the "
                         "heavy branch, not the light scan")
    if np.asarray(group_gang).any():
        raise ValueError("gang groups need the gang fill, not the light "
                         "scan")
    t = _upload([np.asarray(group_req, np.float32),
                 np.asarray(group_count, np.int32),
                 pack_mask_bits(np.asarray(group_mask), O),
                 np.asarray(exist_cap, np.int32),
                 np.asarray(exist_remaining, np.float32),
                 np.asarray(pool_limit, np.float32),
                 np.asarray(group_ncap, np.int32),
                 np.asarray(group_whole).astype(np.int32)],
                torch.device(device))
    return FFDProblem(*t, D=int(np.asarray(group_dbase).shape[1]))


def problem_from_numpy(prob: Sequence[np.ndarray], cat_arrays: Dict,
                       device) -> Tuple[FFDProblem, FFDCatalog]:
    """The reference's 17-slot problem tuple and its catalog arrays
    (numpy) as the port's kernel arguments on `device`."""
    cat = catalog_tensors(cat_arrays, device)
    return problem_tensors(prob, cat.O, device), cat


# -- the flat result layout ---------------------------------------------------
def flat_layout(G: int, E: int, N: int, D: int, sparse_n: int = 0,
                explain: int = 0) -> Dict[str, Tuple[int, int]]:
    """(offset, length) of every region of the flat result buffer, plus
    ("total", n)."""
    sizes = [("take_exist", G * E)]
    if sparse_n:
        sizes += [("sp_cnt", G * sparse_n), ("sp_idx", G * sparse_n),
                  ("sp_nnz", G)]
    else:
        sizes += [("take_new", G * N)]
    sizes += [("unsched", G), ("dom_placed", G * D), ("used", N * R),
              ("node_pool", N), ("node_zone", N), ("node_ct", N),
              ("num_active", 1)]
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


def light_scan_reference(prob: FFDProblem, cat: FFDCatalog, N: int,
                         flat: torch.Tensor, lay: Dict,
                         take_new: torch.Tensor,
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
    dev = flat.device
    i32, f32 = torch.int32, torch.float32
    G, E, P, zc = prob.G, prob.E, prob.P, cat.zc
    PT, O = cat.PT, cat.O
    gmask_all = _unpack_bits(prob.mask_bits, O)
    col_avail = cat.col_alloc - cat.col_daemon
    pool_idx = [cat.col_pool == p for p in range(P)]
    exist_rem = prob.exist_remaining.clone()
    used = torch.zeros((N, R), dtype=f32, device=dev)
    colmask = torch.zeros((N, O), dtype=torch.bool, device=dev)
    active = torch.zeros(N, dtype=torch.bool, device=dev)
    node_pool = torch.zeros(N, dtype=i32, device=dev)
    num_active = torch.zeros((), dtype=i32, device=dev)
    limits = prob.pool_limit.clone()
    idx = torch.arange(N, dtype=i32, device=dev)
    te_rows, tn_rows, un_rows = [], [], []
    for g in range(G):
        req = prob.group_req[g]
        cnt = prob.group_count[g]
        ncap = prob.group_ncap[g]
        whole = prob.group_whole[g] != 0
        gmask = gmask_all[g]

        # -- 1. existing nodes
        if E:
            cap_e = torch.minimum(_fit_count(exist_rem, req),
                                  prob.exist_cap[g])
            take_e = torch.where(whole, _atomic_fill(cap_e, cnt),
                                 _prefix_fill(cap_e, cnt))
            exist_rem = exist_rem - take_e[:, None] * req
            c1 = cnt - take_e.sum().to(i32)
            te_rows.append(take_e)
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
        limit_cap = _fit_count(limits, req)                      # [P]
        cap_pfx = cap_n
        for p in range(P):
            mask_p = node_pool == p
            cap_p = torch.where(mask_p, cap_pfx, 0).to(i32)
            before_p = _cumsum_i32(cap_p) - cap_p
            allowed = torch.clamp(limit_cap[p] - before_p, min=0)
            cap_pfx = torch.where(mask_p, torch.minimum(cap_p, allowed),
                                  cap_pfx)
        cap_full = torch.minimum(cap_n, limit_cap[node_pool.long()])
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
        pool_take = torch.zeros(P, dtype=f32, device=dev).index_add_(
            0, node_pool.long(), take_n.to(f32))
        limits = limits - pool_take[:, None] * req
        c2 = c1 - take_n.sum().to(i32)

        # -- 3. open new nodes, pools in priority order
        per_col = torch.minimum(_fit_count(col_avail, req), ncap)
        col_feas = gmask & (per_col >= 1)
        c_rem = c2
        k_new_total = torch.zeros(N, dtype=i32, device=dev)
        for p in range(P):
            cols_p = col_feas & pool_idx[p]
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
            taken_new = torch.minimum(t, m * k_full)
            k_node = torch.where(
                newmask,
                torch.where(pos == m - 1, taken_new - (m - 1) * k_full,
                            k_full),
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
        tn_rows.append(take_n + k_new_total)
        un_rows.append(c_rem)

    def put(name, value):
        _region(flat, lay, name).copy_(value.reshape(-1).to(f32))

    if E:
        put("take_exist", torch.stack(te_rows))
    take_new.copy_(torch.stack(tn_rows).to(f32).reshape(take_new.shape))
    put("unsched", torch.stack(un_rows))
    _region(flat, lay, "dom_placed").zero_()
    put("used", used)
    put("node_pool", node_pool)
    _region(flat, lay, "node_zone").fill_(-1.0)
    _region(flat, lay, "node_ct").fill_(-1.0)
    put("num_active", num_active)
    limits_out.copy_(limits)


def pack_reference(prob: FFDProblem, cat: FFDCatalog, N: int,
                   flat: torch.Tensor, lay: Dict, take_new: torch.Tensor,
                   limits: torch.Tensor, sparse_n: int,
                   explain: int) -> None:
    """Plain PyTorch version of K2: the sparse_n take_new compaction
    (ffd.py:1089-1109) and the explain=1 aux (ffd.py:1113-1214) for
    light-branch problems (topology class 0)."""
    dev = flat.device
    i32, f32 = torch.int32, torch.float32
    G = prob.G
    if sparse_n:
        K = sparse_n
        tn = take_new.view(G, N)
        nz = tn > 0
        rank = torch.cumsum(nz.to(torch.int64), dim=1) - 1
        slot = torch.where(nz & (rank < K), rank, K)         # K = dropped
        cols = torch.arange(N, device=dev, dtype=f32).expand(G, N)
        cnt = torch.zeros((G, K + 1), dtype=f32, device=dev).scatter_(
            1, slot, tn)
        idxs = torch.zeros((G, K + 1), dtype=f32, device=dev).scatter_(
            1, slot, cols)
        _region(flat, lay, "sp_cnt").copy_(cnt[:, :K].reshape(-1))
        _region(flat, lay, "sp_idx").copy_(idxs[:, :K].reshape(-1))
        _region(flat, lay, "sp_nnz").copy_(nz.sum(dim=1).to(f32))
    if explain:
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
        elim_topo = torch.zeros_like(elim_fit)
        stranded = _region(flat, lay, "unsched") > 0
        ok_cols = torch.where(fits_pt & lim_ok_pt,
                              cols_per_block, 0).sum(-1)
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
    G, E, P, W = prob.G, prob.E, prob.P, cat.W
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
            ("col_alloc", cat.col_alloc, f32, (cat.O, R)),
            ("col_daemon", cat.col_daemon, f32, (cat.O, R)),
            ("pt_alloc", cat.pt_alloc, f32, (cat.PT, R)),
            ("col_pool", cat.col_pool, i32, (cat.O,)),
            ("pool_daemon", cat.pool_daemon, f32, (P, R)),
            ("pool_bits", cat.pool_bits, i32, (P, W))):
        _check(t, name, dt, shp, device)
    if N < 1 or G < 1:
        raise ValueError(f"empty problem: G={G}, N={N}")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def light_scan(prob: FFDProblem, cat: FFDCatalog, N: int,
               flat: torch.Tensor, lay: Dict, take_new: torch.Tensor,
               limits_out: torch.Tensor) -> None:
    """K1: the light FFD scan over all groups.  Writes the flat regions
    take_exist, unsched, dom_placed, used, node_pool/zone/ct and
    num_active, the dense [G, N] take_new rows into `take_new` (a view of
    the flat buffer when uncompacted), and the final pool budgets into
    `limits_out`.  CUDA tensors launch the kernel; CPU tensors run
    `light_scan_reference`."""
    dev = flat.device
    _check_args(prob, cat, N, dev)
    _check(flat, "flat", torch.float32, (lay["total"][1],), dev)
    _check(take_new, "take_new", torch.float32, (prob.G * N,), dev)
    _check(limits_out, "limits_out", torch.float32, (prob.P, R), dev)
    if dev.type != "cuda":
        light_scan_reference(prob, cat, N, flat, lay, take_new, limits_out)
        return
    from karpenter_tpu_torch.solver import _cuda
    G, E, P = prob.G, prob.E, prob.P
    W = cat.W
    if P > MAX_POOLS:
        raise ValueError(f"{P} node pools: the kernel takes at most "
                         f"{MAX_POOLS}")
    scratch_f = torch.empty(E * R + N * R, dtype=torch.float32, device=dev)
    scratch_i = torch.empty(W * N + 2 * N + E, dtype=torch.int32,
                            device=dev)
    exist_rem, used = scratch_f[:E * R], scratch_f[E * R:]
    colmask = scratch_i[:W * N]
    active = scratch_i[W * N:W * N + N]
    node_pool = scratch_i[W * N + N:W * N + 2 * N]
    cap_e = scratch_i[W * N + 2 * N:]
    reg = lambda name: _region(flat, lay, name)  # noqa: E731
    ptrs = [
        prob.group_req, prob.group_count, prob.mask_bits, prob.exist_cap,
        prob.exist_remaining, prob.pool_limit, prob.group_ncap,
        prob.group_whole,
        cat.col_alloc, cat.col_daemon, cat.pt_alloc, cat.col_pool,
        cat.pool_daemon, cat.pool_bits,
        exist_rem, used, colmask, active, node_pool, cap_e, limits_out,
        reg("take_exist"), take_new, reg("unsched"), reg("dom_placed"),
        reg("used"), reg("node_pool"), reg("node_zone"), reg("node_ct"),
        reg("num_active"),
    ]
    dims = [G, E, N, cat.O, cat.PT, cat.zc, P, prob.D, W]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.launch("ffd_light_scan", [_ptr(t) for t in ptrs], dims, stream)
    light_scan.launches += 1


light_scan.launches = 0


def pack(prob: FFDProblem, cat: FFDCatalog, N: int, flat: torch.Tensor,
         lay: Dict, take_new: torch.Tensor, limits: torch.Tensor,
         sparse_n: int, explain: int) -> None:
    """K2: the take_new top-K compaction (sparse_n > 0) and the explain=1
    counts, written into the flat buffer from K1's outputs.  CUDA tensors
    launch the kernel; CPU tensors run `pack_reference`."""
    dev = flat.device
    _check_args(prob, cat, N, dev)
    _check(flat, "flat", torch.float32, (lay["total"][1],), dev)
    _check(take_new, "take_new", torch.float32, (prob.G * N,), dev)
    _check(limits, "limits", torch.float32, (prob.P, R), dev)
    if explain not in (0, 1):
        raise ValueError(f"explain={explain}: the pack computes counts "
                         "(1) or nothing (0)")
    if sparse_n < 0:
        raise ValueError(f"sparse_n={sparse_n}")
    if dev.type != "cuda":
        pack_reference(prob, cat, N, flat, lay, take_new, limits,
                       sparse_n, explain)
        return
    from karpenter_tpu_torch.solver import _cuda
    reg = lambda name: (_region(flat, lay, name)  # noqa: E731
                        if name in lay else None)
    ptrs = [
        take_new, prob.mask_bits, prob.group_req, prob.group_whole,
        cat.pt_alloc, cat.col_daemon, cat.col_pool, cat.pool_daemon,
        limits, reg("unsched"), reg("num_active"),
        reg("sp_cnt"), reg("sp_idx"), reg("sp_nnz"),
        reg("explain_counts"), reg("explain_bits"),
    ]
    dims = [prob.G, N, cat.PT, cat.zc, prob.P, cat.W, sparse_n, explain]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.launch("ffd_pack", [_ptr(t) for t in ptrs], dims, stream)
    pack.launches += 1


pack.launches = 0


def solve_ffd(prob: FFDProblem, cat: FFDCatalog, max_nodes: int,
              sparse_n: int = 0, explain: int = 0) -> torch.Tensor:
    """One light-branch solve: K1, then K2 when there is anything to pack.
    Returns the flat f32 result buffer on the problem's device (not
    synchronised)."""
    dev = prob.group_req.device
    N = max_nodes
    lay = flat_layout(prob.G, prob.E, N, prob.D, sparse_n, explain)
    flat = torch.empty(lay["total"][1], dtype=torch.float32, device=dev)
    take_new = (torch.empty(prob.G * N, dtype=torch.float32, device=dev)
                if sparse_n else _region(flat, lay, "take_new"))
    limits = torch.empty((prob.P, R), dtype=torch.float32, device=dev)
    light_scan(prob, cat, N, flat, lay, take_new, limits)
    if sparse_n or explain:
        pack(prob, cat, N, flat, lay, take_new, limits, sparse_n, explain)
    return flat


def unpack(packed, G: int, E: int, N: int, RDIM: int, D: int,
           sparse_n: int = 0, explain: int = 0) -> Dict:
    """Split the flat result buffer into named host arrays (ffd.py:1677).
    sparse_n > 0 rebuilds take_new from its (count, index) pairs and
    reports ``new_overflow`` when a group touched more than K nodes (the
    caller re-runs dense)."""
    flat = np.asarray(packed)
    if not flat.flags.writeable:
        flat = np.array(flat)
    Kn = sparse_n
    head = G * E
    mid = (2 * G * Kn + G) if Kn else G * N
    sizes = [head, mid, G, G * D, N * RDIM, N, N, N, 1]
    offs = np.cumsum([0] + sizes)
    take_exist = flat[offs[0]:offs[1]].reshape(G, E)
    new_overflow = False
    if Kn:
        cntn = flat[offs[1]:offs[1] + G * Kn].reshape(G, Kn)
        idxn = flat[offs[1] + G * Kn:
                    offs[1] + 2 * G * Kn].reshape(G, Kn).astype(np.int64)
        nnz = flat[offs[1] + 2 * G * Kn:offs[2]]
        new_overflow = bool((nnz > Kn).any())
        take_new = np.zeros((G, N), dtype=flat.dtype)
        mn_ = cntn > 0
        take_new[np.nonzero(mn_)[0], idxn[mn_]] = cntn[mn_]
    else:
        take_new = flat[offs[1]:offs[2]].reshape(G, N)
    out = dict(
        take_exist=take_exist,
        take_new=take_new,
        new_overflow=new_overflow,
        unsched=flat[offs[2]:offs[3]],
        dom_placed=flat[offs[3]:offs[4]].reshape(G, D),
        used=flat[offs[4]:offs[5]].reshape(N, RDIM),
        node_pool=flat[offs[5]:offs[6]].astype(np.int32),
        node_zone=flat[offs[6]:offs[7]].astype(np.int32),
        node_ct=flat[offs[7]:offs[8]].astype(np.int32),
        num_active=flat[offs[8]],
    )
    off = int(offs[-1])
    if explain:
        C = EXPLAIN_C
        out["explain_counts"] = \
            flat[off:off + G * C].reshape(G, C).astype(np.int64)
        off += G * C
        out["explain_bits"] = flat[off:off + G].astype(np.int64)
    return out
