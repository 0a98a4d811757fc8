"""The grouped-FFD solve on the card: kernel wrappers and plain versions.

The JAX reference (`karpenter_tpu/solver/ffd.py` `_solve_ffd_impl`) is one
jitted `lax.scan` over pod equivalence classes; each step takes the light
branch (no zone/capacity-type domain constraint) or the heavy one
(`lax.cond(dsel > 0, heavy, light)`).  Its batched entry points vmap that
scan over many problems.  This module runs them as hand-written CUDA
kernels, one thread block per problem:

  * ``batch_scan`` (K5, `csrc/ffd_batch_scan.cu`): the scan over B stacked
    problems that share a catalog (`_solve_ffd_batch_impl`, the
    consolidation simulator's generic path); one solve is the B=1 launch.
  * ``sweep_scan`` / ``sweep_topo_scan`` (K4, `csrc/ffd_sweep_scan.cu`,
    the light and the heavy lane): the scan over B simulations of one
    cluster snapshot (`_solve_ffd_sweep_impl`, `_solve_ffd_sweep_topo_impl`)
    — each simulation excludes a few existing nodes, gathers its classes'
    column masks and per-node caps from shared tables and caps the column
    price.
  * ``pack`` (K2, `csrc/ffd_pack.cu`): the explain=1 elimination counts,
    topology class included, from the scan's final state, at the offsets
    `unpack` expects.

With ``sparse_k`` > 0 the scans also compact each group's take_exist row
into K (count, index) pairs, the reference's prefix-rank scatter.  Beside
each kernel sits its plain PyTorch version (``batch_scan_reference``,
``sweep_scan_reference``, ``sweep_topo_scan_reference``,
``pack_reference``), a transcription of the reference with a Python loop
over problems, groups and pools; every scan shares one light and one heavy
step.  A wrapper runs the kernel for a CUDA tensor and the plain version
for a CPU tensor; there is no fallback from one to the other.  Each
wrapper counts its kernel launches in ``.launches``.

The flat result buffer of one problem has exactly the reference's layout
(ffd.py:1258):

    take_exist G*E  (sparse_k: counts G*K | indices G*K)
    | take_new G*N | unsched G | dom_placed G*D | used N*R | node_pool N
    | node_zone N | node_ct N | num_active 1 | [explain: counts G*5, bits G]

(always the dense take_new rows: the reference's top-K take_new
compaction saves device-to-host bytes on a TPU link and bought nothing
on the card); a batch is B such buffers, one row each, and `unpack`
splits a row into the same named host arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.models.resources import RESOURCE_AXIS
from karpenter_tpu_torch.solver.explain import EPS, KERNEL_CONSTRAINTS

R = len(RESOURCE_AXIS)
EXPLAIN_C = len(KERNEL_CONSTRAINTS)
_CAP = 2 ** 30  # _fit_count's ceiling (ffd.py:116)
BIG = 2 ** 29  # the encoder's "unbounded" cap (encode.BIG)
MAX_POOLS = 64  # the kernels' pool-axis capacity (csrc MAXP)
MAX_DOMAINS = 128  # the kernels' domain-axis capacity (csrc MAXD)
MAX_EXCLUDED = 8  # the sweep kernels' exclusions per simulation (csrc MAXX)


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
    """The per-solve half of the kernel arguments, for one problem."""
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

    @property
    def D(self) -> int:
        """The padded domain width of dom_placed."""
        return self.group_dbase.shape[-1]

    @property
    def G(self) -> int:
        return self.group_req.shape[-2]

    @property
    def E(self) -> int:
        return self.exist_remaining.shape[-2]

    @property
    def P(self) -> int:
        return self.pool_limit.shape[-2]


@dataclass
class FFDBatch(FFDProblem):
    """B problems stacked on a leading axis (every field [B, ...]), padded
    to common G, E, D; they share the catalog (the reference's
    `_BATCH_AXES`, ffd.py:1483)."""

    @property
    def B(self) -> int:
        return self.group_req.shape[0]

    def at(self, b: int) -> FFDProblem:
        return FFDProblem(*(getattr(self, f.name)[b] for f in fields(self)))

    @classmethod
    def of(cls, prob: FFDProblem) -> "FFDBatch":
        """One problem as a batch of one (views)."""
        return cls(*(getattr(prob, f.name).unsqueeze(0)
                     for f in fields(prob)))


@dataclass
class SweepShared:
    """The cluster snapshot a sweep's simulations share (uploaded once):
    per-class column masks and per-node caps, the existing nodes, and the
    column prices the per-simulation cap applies to."""
    class_bits: torch.Tensor       # [C, W] i32 column bits per pod class
    class_cap: torch.Tensor        # [C, E] i32 per-class per-node allowance
    exist_remaining: torch.Tensor  # [E, R] f32
    exist_zone: torch.Tensor       # [E] i32
    exist_ct: torch.Tensor         # [E] i32
    col_price: torch.Tensor        # [O] f32, padded with +inf


@dataclass
class SweepBatch:
    """B simulations of one snapshot (every field [B, ...]).  The heavy
    lane carries per-simulation topology rows; the light lane has none and
    runs every group with no node cap and no domain constraint."""
    group_req: torch.Tensor        # [B, G, R] f32
    group_count: torch.Tensor      # [B, G] i32
    group_class: torch.Tensor      # [B, G] i32 row of the class tables
    exclude_idx: torch.Tensor      # [B, X] i32 excluded rows (-1 = pad)
    price_cap: torch.Tensor        # [B] f32 (+inf = uncapped)
    pool_limit: torch.Tensor       # [B, P, R] f32
    shared: SweepShared
    group_ncap: Optional[torch.Tensor] = None    # [B, G] i32 (heavy)
    group_dsel: Optional[torch.Tensor] = None    # [B, G] i32
    group_dbase: Optional[torch.Tensor] = None   # [B, G, D] i32
    group_dcap: Optional[torch.Tensor] = None    # [B, G, D] i32
    group_skew: Optional[torch.Tensor] = None    # [B, G] i32
    group_mindom: Optional[torch.Tensor] = None  # [B, G] i32
    group_delig: Optional[torch.Tensor] = None   # [B, G, D] i32 0/1

    @property
    def heavy(self) -> bool:
        return self.group_dsel is not None

    @property
    def B(self) -> int:
        return self.group_req.shape[0]

    @property
    def G(self) -> int:
        return self.group_req.shape[1]

    @property
    def E(self) -> int:
        return self.shared.exist_remaining.shape[0]

    @property
    def P(self) -> int:
        return self.pool_limit.shape[1]

    @property
    def D(self) -> int:
        return self.group_dbase.shape[2] if self.heavy else 1

    @property
    def X(self) -> int:
        return self.exclude_idx.shape[1]


def pack_mask_bits(mask: np.ndarray, O: int) -> np.ndarray:
    """[..., O] bool, or [..., ceil(O/8)] uint8 already packed with
    np.packbits(bitorder="little"), → [..., ceil(O/32)] int32 words: bit
    o % 32 of word o // 32 is column o."""
    if mask.dtype != np.uint8:
        assert mask.shape[-1] == O, (mask.shape, O)
        mask = np.packbits(mask.astype(bool), axis=-1, bitorder="little")
    W = (O + 31) // 32
    assert mask.shape[-1] == (O + 7) // 8, (mask.shape, O)
    lead = mask.shape[:-1]
    out = np.zeros(lead + (W * 4,), np.uint8)
    out[..., :mask.shape[-1]] = mask
    return out.view("<u4").view(np.int32).reshape(lead + (W,))


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
    return typed_views(buf, arrays)


def typed_views(buf: torch.Tensor,
                arrays: Sequence[np.ndarray]) -> Tuple[torch.Tensor, ...]:
    """Views of the int32 buffer `buf` holding `arrays` back to back, each
    with its array's shape and 4-byte type."""
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


def problem_arrays(prob: Sequence[np.ndarray], O: int) -> list:
    """The reference's 17-slot `_problem_args` tuple (numpy, padded; slot
    2 a [G, O] bool mask or its packed [G, ceil(O/8)] bytes) as the
    scan's 16 host arrays in FFDProblem order.  Rejects what no ported
    scan runs: gangs and the 18-slot priority-band form."""
    if len(prob) != 17:
        raise ValueError("priority-band problems (18 slots) are not "
                         "supported by the scan")
    (group_req, group_count, group_mask, exist_cap, exist_remaining,
     pool_limit, group_ncap, group_dsel, group_dbase, group_dcap,
     group_skew, group_mindom, group_delig, group_whole, group_gang,
     exist_zone, exist_ct) = prob
    if np.asarray(group_gang).any():
        raise ValueError("gang groups need the gang fill, not the scan")
    return [np.asarray(group_req, np.float32),
            np.asarray(group_count, np.int32),
            pack_mask_bits(np.asarray(group_mask), O),
            np.asarray(exist_cap, np.int32),
            np.asarray(exist_remaining, np.float32),
            np.asarray(pool_limit, np.float32),
            np.asarray(group_ncap, np.int32),
            np.asarray(group_whole).astype(np.int32),
            np.asarray(group_dsel, np.int32),
            np.asarray(group_dbase, np.int32),
            np.asarray(group_dcap, np.int32),
            np.asarray(group_skew, np.int32),
            np.asarray(group_mindom, np.int32),
            np.asarray(group_delig).astype(np.int32),
            np.asarray(exist_zone, np.int32),
            np.asarray(exist_ct, np.int32)]


def problem_tensors(prob: Sequence[np.ndarray], O: int,
                    device) -> FFDProblem:
    """One 17-slot problem tuple as the scan's device arguments, in one
    host→device copy."""
    return FFDProblem(*_upload(problem_arrays(prob, O),
                               torch.device(device)))


def batch_tensors(probs: Sequence[Sequence[np.ndarray]], O: int, device,
                  upload=_upload) -> FFDBatch:
    """B problem tuples of common padded shapes, stacked, as the batched
    scan's device arguments, in one host→device copy (`upload`, the
    pipeline's staging buffers when it runs)."""
    per = [problem_arrays(p, O) for p in probs]
    stacked = [np.stack(parts) for parts in zip(*per)]
    return FFDBatch(*upload(stacked, torch.device(device)))


SWEEP_ROWS = ("group_req", "group_count", "group_class", "exclude_idx",
              "price_cap", "pool_limit")
SWEEP_TOPO_ROWS = ("group_ncap", "group_dsel", "group_dbase", "group_dcap",
                   "group_skew", "group_mindom", "group_delig")
_F32_ROWS = ("group_req", "price_cap", "pool_limit")


def sweep_shared_tensors(shared: Dict, O: int, device) -> SweepShared:
    """A sweep's snapshot (numpy: class_mask [C, O] bool, class_cap,
    exist_remaining, exist_zone, exist_ct, col_price) on `device`, the
    class masks as column bits, in one host→device copy."""
    return SweepShared(*_upload([
        pack_mask_bits(np.asarray(shared["class_mask"]), O),
        np.asarray(shared["class_cap"], np.int32),
        np.asarray(shared["exist_remaining"], np.float32),
        np.asarray(shared["exist_zone"], np.int32),
        np.asarray(shared["exist_ct"], np.int32),
        np.asarray(shared["col_price"], np.float32)], torch.device(device)))


def sweep_tensors(rows: Dict, shared: SweepShared, device,
                  upload=_upload) -> SweepBatch:
    """B simulations' rows (numpy, SWEEP_ROWS and, for the heavy lane,
    SWEEP_TOPO_ROWS) on `device` in one host→device copy (`upload`, the
    pipeline's staging buffers when it runs), against `shared`."""
    names = SWEEP_ROWS + (SWEEP_TOPO_ROWS if "group_dsel" in rows else ())
    arrays = [np.asarray(rows[n], np.float32 if n in _F32_ROWS
                         else np.int32) for n in names]
    t = upload(arrays, torch.device(device))
    return SweepBatch(shared=shared, **dict(zip(names, t)))


def problem_from_numpy(prob: Sequence[np.ndarray], cat_arrays: Dict,
                       device) -> Tuple[FFDProblem, FFDCatalog]:
    """The reference's 17-slot problem tuple and its catalog arrays
    (numpy) as the port's kernel arguments on `device`."""
    cat = catalog_tensors(cat_arrays, device)
    return problem_tensors(prob, cat.O, device), cat


# -- the flat result layout ---------------------------------------------------
def flat_layout(G: int, E: int, N: int, D: int, explain: int = 0,
                sparse_k: int = 0) -> Dict[str, Tuple[int, int]]:
    """(offset, length) of every region of one problem's flat result
    buffer, plus ("total", n).  With `sparse_k` the take_exist rows are
    replaced by K (count, index) pairs per group."""
    head = ([("te_cnt", G * sparse_k), ("te_idx", G * sparse_k)]
            if sparse_k else [("take_exist", G * E)])
    sizes = head + [("take_new", G * N), ("unsched", G),
                    ("dom_placed", G * D), ("used", N * R),
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
    """Region `name` of a flat buffer: [n] of one problem's row, or
    [B, n] of a batch's [B, total] buffer."""
    off, n = lay[name]
    return flat[..., off:off + n]


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
                    work: Optional[Dict[str, int]], topology: bool,
                    sparse_k: int = 0) -> None:
    """The plain scan of one problem: per group the light step, or with
    `topology` the heavy step for a group with dsel > 0 (the reference's
    `lax.cond(dsel > 0, heavy, light)`, ffd.py:1057).  Writes the
    kernels' outputs into the problem's flat row; with `sparse_k`, the
    take_exist rows compacted."""
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
        te = torch.stack(te_rows).to(f32)
        if sparse_k:
            cnt, idx = compact_take_exist(te, sparse_k)
            put("te_cnt", cnt)
            put("te_idx", idx)
        else:
            put("take_exist", te)
    elif sparse_k:
        put("te_cnt", torch.zeros(prob.G * sparse_k))
        put("te_idx", torch.zeros(prob.G * sparse_k))
    put("take_new", torch.stack(tn_rows))
    put("unsched", torch.stack(un_rows))
    put("dom_placed", torch.stack(dp_rows))
    put("used", s.used)
    put("node_pool", s.node_pool)
    put("node_zone", s.node_zone)
    put("node_ct", s.node_ct)
    put("num_active", s.num_active)
    limits_out.copy_(s.limits)


def compact_take_exist(te: torch.Tensor, K: int):
    """The reference's top-K take_exist compaction (ffd.py:1068-1086):
    each group's nonzero entries, in index order, ranked by a prefix sum
    and scattered into K (count, index) slots; empty slots hold (0, 0) and
    ranks past K are dropped.  `te` [G, E] f32 → ([G, K], [G, K]) f32."""
    G, E = te.shape
    nz = te > 0
    rank = torch.cumsum(nz.to(torch.int64), dim=1) - 1
    gi, ei = torch.nonzero(nz & (rank < K), as_tuple=True)
    cnt = torch.zeros((G, K), dtype=torch.float32, device=te.device)
    idx = torch.zeros((G, K), dtype=torch.float32, device=te.device)
    cnt[gi, rank[gi, ei]] = te[gi, ei]
    idx[gi, rank[gi, ei]] = ei.to(torch.float32)
    return cnt, idx


def batch_scan_reference(batch: FFDBatch, cat: FFDCatalog, N: int,
                         flat: torch.Tensor, lay: Dict,
                         limits_out: torch.Tensor, sparse_k: int = 0,
                         work: Optional[Dict[str, int]] = None) -> None:
    """Plain PyTorch version of K5: `_solve_ffd_batch_impl`
    (ffd.py:1492) — the scan with the heavy branch traced, per problem of
    the batch, transcribed step for step (a Python loop over problems,
    groups and pools).  Writes the kernel's outputs, one flat row per
    problem.

    Given a `work` dict, adds to it what the kernel computes on this
    data: "fit", the R-vector `_fit_count`s, "test", the R-vector
    all-fits tests, and "flops", the water-fill's scalar float
    operations.  The kernel fits an in-flight node only against the
    (pool,type) blocks that still hold a surviving column the group
    admits, and narrows only touched and opened nodes, on the blocks
    their candidate columns span."""
    for b in range(batch.B):
        _scan_reference(batch.at(b), cat, N, flat[b], lay, limits_out[b],
                        work, topology=True, sparse_k=sparse_k)


def _bits_of(mask: torch.Tensor) -> torch.Tensor:
    """[O] bool → [ceil(O/32)] i32 words (bit o%32 of word o//32)."""
    O = mask.shape[0]
    W = (O + 31) // 32
    m = torch.zeros(W * 32, dtype=torch.int64, device=mask.device)
    m[:O] = mask.to(torch.int64)
    w = (m.view(W, 32) << torch.arange(32, device=mask.device)).sum(-1)
    return _w32(w)


def _sweep_problem(sw: SweepBatch, b: int) -> FFDProblem:
    """Simulation b as one problem, as the reference's per-simulation
    `one` builds it (ffd.py:1570, :1644): the kept existing rows, the
    class rows of its groups, the price cap on the columns."""
    sh = sw.shared
    i32, f32 = torch.int32, torch.float32
    dev = sw.group_req.device
    E, G = sw.E, sw.G
    keep = (torch.arange(E, dtype=i32, device=dev)[None, :]
            != sw.exclude_idx[b][:, None]).all(dim=0)             # [E]
    er = sh.exist_remaining * keep[:, None].to(f32)
    gcls = sw.group_class[b].long()
    ecap = sh.class_cap[gcls] * keep[None, :].to(i32)
    pbits = _bits_of(sh.col_price < sw.price_cap[b])
    mask_bits = sh.class_bits[gcls] & pbits[None, :]
    zeros_g = torch.zeros(G, dtype=i32, device=dev)
    if sw.heavy:
        topo = (sw.group_ncap[b], sw.group_dsel[b], sw.group_dbase[b],
                sw.group_dcap[b], sw.group_skew[b], sw.group_mindom[b],
                sw.group_delig[b])
    else:
        big_g = torch.full((G,), BIG, dtype=i32, device=dev)
        topo = (big_g, zeros_g, torch.zeros((G, 1), dtype=i32, device=dev),
                torch.full((G, 1), BIG, dtype=i32, device=dev), big_g,
                zeros_g, torch.zeros((G, 1), dtype=i32, device=dev))
    ncap, dsel, dbase, dcap, skew, mindom, delig = topo
    return FFDProblem(sw.group_req[b], sw.group_count[b], mask_bits, ecap,
                      er, sw.pool_limit[b], ncap, zeros_g, dsel, dbase,
                      dcap, skew, mindom, delig, sh.exist_zone, sh.exist_ct)


def _sweep_reference(sw: SweepBatch, cat: FFDCatalog, N: int,
                     flat: torch.Tensor, lay: Dict, limits_out: torch.Tensor,
                     sparse_k: int, work: Optional[Dict[str, int]]) -> None:
    for b in range(sw.B):
        _scan_reference(_sweep_problem(sw, b), cat, N, flat[b], lay,
                        limits_out[b], work, topology=sw.heavy,
                        sparse_k=sparse_k)


def sweep_scan_reference(sw: SweepBatch, cat: FFDCatalog, N: int,
                         flat: torch.Tensor, lay: Dict,
                         limits_out: torch.Tensor, sparse_k: int = 0,
                         work: Optional[Dict[str, int]] = None) -> None:
    """Plain PyTorch version of K4's light lane: `_solve_ffd_sweep_impl`
    (ffd.py:1531) — per simulation, the kept existing rows, the gathered
    class rows and the price cap, then the light scan.  `work` counts as
    in `batch_scan_reference`."""
    if sw.heavy:
        raise ValueError("topology rows need the heavy lane "
                         "(sweep_topo_scan)")
    _sweep_reference(sw, cat, N, flat, lay, limits_out, sparse_k, work)


def sweep_topo_scan_reference(sw: SweepBatch, cat: FFDCatalog, N: int,
                              flat: torch.Tensor, lay: Dict,
                              limits_out: torch.Tensor, sparse_k: int = 0,
                              work: Optional[Dict[str, int]] = None
                              ) -> None:
    """Plain PyTorch version of K4's heavy lane:
    `_solve_ffd_sweep_topo_impl` (ffd.py:1610) — as the light lane, with
    per-simulation topology rows and the heavy step for dsel > 0."""
    if not sw.heavy:
        raise ValueError("the heavy lane needs per-simulation topology "
                         "rows")
    _sweep_reference(sw, cat, N, flat, lay, limits_out, sparse_k, work)


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


def _check_catalog(cat: FFDCatalog, P: int, device) -> None:
    O, W = cat.O, cat.W
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shp in (
            ("col_alloc", cat.col_alloc, f32, (O, R)),
            ("col_daemon", cat.col_daemon, f32, (O, R)),
            ("pt_alloc", cat.pt_alloc, f32, (cat.PT, R)),
            ("col_pool", cat.col_pool, i32, (O,)),
            ("pool_daemon", cat.pool_daemon, f32, (P, R)),
            ("pool_bits", cat.pool_bits, i32, (P, W)),
            ("col_zone", cat.col_zone, i32, (O,)),
            ("col_ct", cat.col_ct, i32, (O,))):
        _check(t, name, dt, shp, device)


def _check_problem(prob: FFDProblem, cat: FFDCatalog, N: int,
                   device) -> None:
    """Shapes, types, device and contiguity of one problem (FFDProblem) or
    of a batch (FFDBatch: every shape with its leading B)."""
    G, E, P, W, D = prob.G, prob.E, prob.P, cat.W, prob.D
    lead = (prob.B,) if isinstance(prob, FFDBatch) else ()
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
            ("exist_ct", prob.exist_ct, i32, (E,))):
        _check(t, name, dt, lead + shp, device)
    _check_catalog(cat, P, device)
    if N < 1 or G < 1 or D < 1:
        raise ValueError(f"empty problem: G={G}, N={N}, D={D}")


def _check_sweep(sw: SweepBatch, cat: FFDCatalog, N: int, device) -> None:
    B, G, E, P, X, W, D = sw.B, sw.G, sw.E, sw.P, sw.X, cat.W, sw.D
    f32, i32 = torch.float32, torch.int32
    sh = sw.shared
    C = sh.class_bits.shape[0]
    checks = [
        ("group_req", sw.group_req, f32, (B, G, R)),
        ("group_count", sw.group_count, i32, (B, G)),
        ("group_class", sw.group_class, i32, (B, G)),
        ("exclude_idx", sw.exclude_idx, i32, (B, X)),
        ("price_cap", sw.price_cap, f32, (B,)),
        ("pool_limit", sw.pool_limit, f32, (B, P, R)),
        ("class_bits", sh.class_bits, i32, (C, W)),
        ("class_cap", sh.class_cap, i32, (C, E)),
        ("exist_remaining", sh.exist_remaining, f32, (E, R)),
        ("exist_zone", sh.exist_zone, i32, (E,)),
        ("exist_ct", sh.exist_ct, i32, (E,)),
        ("col_price", sh.col_price, f32, (cat.O,))]
    if sw.heavy:
        checks += [
            ("group_ncap", sw.group_ncap, i32, (B, G)),
            ("group_dsel", sw.group_dsel, i32, (B, G)),
            ("group_dbase", sw.group_dbase, i32, (B, G, D)),
            ("group_dcap", sw.group_dcap, i32, (B, G, D)),
            ("group_skew", sw.group_skew, i32, (B, G)),
            ("group_mindom", sw.group_mindom, i32, (B, G)),
            ("group_delig", sw.group_delig, i32, (B, G, D))]
    for name, t, dt, shp in checks:
        _check(t, name, dt, shp, device)
    _check_catalog(cat, P, device)
    if N < 1 or G < 1 or B < 1 or C < 1:
        raise ValueError(f"empty sweep: B={B}, G={G}, N={N}, C={C}")
    if X > MAX_EXCLUDED:
        raise ValueError(f"{X} exclusions per simulation: the sweep "
                         f"kernels take at most {MAX_EXCLUDED}")


def _check_outputs(B: int, P: int, flat: torch.Tensor, lay: Dict,
                   limits_out: torch.Tensor, sparse_k: int) -> None:
    dev = flat.device
    _check(flat, "flat", torch.float32, (B, lay["total"][1]), dev)
    _check(limits_out, "limits_out", torch.float32, (B, P, R), dev)
    if ("te_cnt" in lay) != (sparse_k > 0) or (
            sparse_k and lay["te_cnt"][1] != lay["unsched"][1] * sparse_k):
        raise ValueError(f"the flat layout does not hold sparse_k="
                         f"{sparse_k} take_exist rows")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _launch_scan(entry: str, B: int, G: int, E: int, N: int, P: int,
                 D: int, X: int, cat: FFDCatalog, flat: torch.Tensor,
                 lay: Dict, limits_out: torch.Tensor, sparse_k: int,
                 inputs: Dict[str, Optional[torch.Tensor]]) -> None:
    """Launch one of the scan kernels (grid: one block per problem) with
    the argument list every instance takes (ScanArgs order); `inputs`
    holds the per-problem or per-simulation tensors, None where the
    instance reads nothing."""
    from karpenter_tpu_torch.solver import _cuda
    dev = flat.device
    W = cat.W
    if P > MAX_POOLS:
        raise ValueError(f"{P} node pools: the kernels take at most "
                         f"{MAX_POOLS}")
    if D > MAX_DOMAINS:
        raise ValueError(f"{D} topology domains: the kernels take at most "
                         f"{MAX_DOMAINS}")
    # per-block scratch (the scan's carry), one slice per problem
    scratch_f = torch.empty(B * (E * R + N * R + G * E * (sparse_k > 0)),
                            dtype=torch.float32, device=dev)
    scratch_i = torch.empty(B * (W * N + 4 * N + E), dtype=torch.int32,
                            device=dev)
    exist_rem = scratch_f[:B * E * R]
    used = scratch_f[B * E * R:B * (E * R + N * R)]
    te_dense = scratch_f[B * (E * R + N * R):] if sparse_k else None
    colmask = scratch_i[:B * W * N]
    rest = scratch_i[B * W * N:]
    active, node_pool = rest[:B * N], rest[B * N:2 * B * N]
    node_zone, node_ct = rest[2 * B * N:3 * B * N], rest[3 * B * N:4 * B * N]
    cap_e = rest[4 * B * N:]

    def reg(name):
        return flat[0, lay[name][0]:] if name in lay else None

    i = inputs
    ptrs = [
        i["group_req"], i["group_count"], i["mask_bits"], i["exist_cap"],
        i["exist_remaining"], i["pool_limit"], i.get("group_ncap"),
        i.get("group_whole"),
        cat.col_alloc, cat.col_daemon, cat.pt_alloc, cat.col_pool,
        cat.pool_daemon, cat.pool_bits,
        exist_rem, used, colmask, active, node_pool, cap_e, limits_out,
        reg("take_exist"), reg("take_new"), reg("unsched"),
        reg("dom_placed"),
        reg("used"), reg("node_pool"), reg("node_zone"), reg("node_ct"),
        reg("num_active"),
        i.get("group_dsel"), i.get("group_dbase"), i.get("group_dcap"),
        i.get("group_skew"), i.get("group_mindom"), i.get("group_delig"),
        i["exist_zone"], i["exist_ct"], cat.col_zone, cat.col_ct,
        node_zone, node_ct,
        i.get("group_class"), i.get("exclude_idx"), i.get("price_cap"),
        i.get("col_price"), te_dense, reg("te_cnt"),
    ]
    dims = [G, E, N, cat.O, cat.PT, cat.zc, P, D, W, B, X, sparse_k,
            lay["total"][1]]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.launch(entry, [_ptr(t) for t in ptrs], dims, stream)


def batch_scan(batch: FFDBatch, cat: FFDCatalog, N: int,
               flat: torch.Tensor, lay: Dict, limits_out: torch.Tensor,
               sparse_k: int = 0) -> None:
    """K5: the FFD scan of every problem of `batch` (the heavy step for
    groups with dsel > 0, the light step for the rest), one flat row each
    in `flat` [B, total]: take_exist (or its sparse_k compaction),
    take_new, unsched, dom_placed, used, node_pool/zone/ct and
    num_active; the final pool budgets in `limits_out` [B, P, R].  CUDA
    tensors launch the kernel; CPU tensors run `batch_scan_reference`."""
    dev = flat.device
    _check_problem(batch, cat, N, dev)
    _check_outputs(batch.B, batch.P, flat, lay, limits_out, sparse_k)
    if dev.type != "cuda":
        batch_scan_reference(batch, cat, N, flat, lay, limits_out, sparse_k)
        return
    _launch_scan("ffd_batch_scan", batch.B, batch.G, batch.E, N, batch.P,
                 batch.D, 0, cat, flat, lay, limits_out, sparse_k,
                 {f.name: getattr(batch, f.name) for f in fields(batch)})
    batch_scan.launches += 1


batch_scan.launches = 0


def _sweep_inputs(sw: SweepBatch) -> Dict[str, Optional[torch.Tensor]]:
    sh = sw.shared
    out = dict(group_req=sw.group_req, group_count=sw.group_count,
               mask_bits=sh.class_bits, exist_cap=sh.class_cap,
               exist_remaining=sh.exist_remaining,
               pool_limit=sw.pool_limit, exist_zone=sh.exist_zone,
               exist_ct=sh.exist_ct, group_class=sw.group_class,
               exclude_idx=sw.exclude_idx, price_cap=sw.price_cap,
               col_price=sh.col_price)
    if sw.heavy:
        out.update(group_ncap=sw.group_ncap, group_dsel=sw.group_dsel,
                   group_dbase=sw.group_dbase, group_dcap=sw.group_dcap,
                   group_skew=sw.group_skew, group_mindom=sw.group_mindom,
                   group_delig=sw.group_delig)
    return out


def sweep_scan(sw: SweepBatch, cat: FFDCatalog, N: int, flat: torch.Tensor,
               lay: Dict, limits_out: torch.Tensor,
               sparse_k: int = 0) -> None:
    """K4, light lane: the scan of every simulation of `sw` against the
    shared snapshot — its kept existing rows, its classes' column masks
    under its price cap — every group light; writes what `batch_scan`
    writes (dom_placed one zero column, node pins -1).  CUDA tensors
    launch the kernel; CPU tensors run `sweep_scan_reference`."""
    dev = flat.device
    _check_sweep(sw, cat, N, dev)
    _check_outputs(sw.B, sw.P, flat, lay, limits_out, sparse_k)
    if sw.heavy:
        raise ValueError("topology rows need the heavy lane "
                         "(sweep_topo_scan)")
    if dev.type != "cuda":
        sweep_scan_reference(sw, cat, N, flat, lay, limits_out, sparse_k)
        return
    _launch_scan("ffd_sweep_scan", sw.B, sw.G, sw.E, N, sw.P, 1, sw.X,
                 cat, flat, lay, limits_out, sparse_k, _sweep_inputs(sw))
    sweep_scan.launches += 1


sweep_scan.launches = 0


def sweep_topo_scan(sw: SweepBatch, cat: FFDCatalog, N: int,
                    flat: torch.Tensor, lay: Dict, limits_out: torch.Tensor,
                    sparse_k: int = 0) -> None:
    """K4, heavy lane: as `sweep_scan`, with each simulation's topology
    rows and the heavy step for its groups with dsel > 0.  CUDA tensors
    launch the kernel; CPU tensors run `sweep_topo_scan_reference`."""
    dev = flat.device
    _check_sweep(sw, cat, N, dev)
    _check_outputs(sw.B, sw.P, flat, lay, limits_out, sparse_k)
    if not sw.heavy:
        raise ValueError("the heavy lane needs per-simulation topology "
                         "rows")
    if dev.type != "cuda":
        sweep_topo_scan_reference(sw, cat, N, flat, lay, limits_out,
                                  sparse_k)
        return
    _launch_scan("ffd_sweep_topo_scan", sw.B, sw.G, sw.E, N, sw.P, sw.D,
                 sw.X, cat, flat, lay, limits_out, sparse_k,
                 _sweep_inputs(sw))
    sweep_topo_scan.launches += 1


sweep_topo_scan.launches = 0


def pack(prob: FFDProblem, cat: FFDCatalog, N: int, flat: torch.Tensor,
         lay: Dict, limits: torch.Tensor) -> None:
    """K2: the explain=1 counts of one problem, written into its flat row
    (which must hold them) from the scan's outputs and final pool budgets
    `limits`.  CUDA tensors launch the kernel; CPU tensors run
    `pack_reference`."""
    dev = flat.device
    _check_problem(prob, cat, N, dev)
    _check(flat, "flat", torch.float32, (lay["total"][1],), dev)
    _check(limits, "limits", torch.float32, (prob.P, R), dev)
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


def solve_ffd_batch(batch: FFDBatch, cat: FFDCatalog, max_nodes: int,
                    explain: int = 0, sparse_k: int = 0) -> torch.Tensor:
    """The generic batched solve (`solve_ffd_batch`, ffd.py:1514): K5 over
    the batch, then, with explain=1, K2 for each problem.  Returns the
    [B, total] f32 result rows on the batch's device (not
    synchronised)."""
    if explain not in (0, 1):
        raise ValueError(f"explain={explain}: the pack computes counts "
                         "(1) or nothing (0)")
    dev = batch.group_req.device
    N = max_nodes
    lay = flat_layout(batch.G, batch.E, N, batch.D, explain, sparse_k)
    flat = torch.empty((batch.B, lay["total"][1]), dtype=torch.float32,
                       device=dev)
    limits = torch.empty((batch.B, batch.P, R), dtype=torch.float32,
                         device=dev)
    batch_scan(batch, cat, N, flat, lay, limits, sparse_k)
    if explain:
        for b in range(batch.B):
            pack(batch.at(b), cat, N, flat[b], lay, limits[b])
    return flat


def solve_ffd(prob: FFDProblem, cat: FFDCatalog, max_nodes: int,
              explain: int = 0) -> torch.Tensor:
    """One solve: the batched scan at B=1, then, with explain=1, K2.
    Returns the flat f32 result buffer on the problem's device (not
    synchronised)."""
    return solve_ffd_batch(FFDBatch.of(prob), cat, max_nodes, explain)[0]


def solve_ffd_sweep(sw: SweepBatch, cat: FFDCatalog, max_nodes: int,
                    sparse_k: int = 0) -> torch.Tensor:
    """The consolidation sweep (`solve_ffd_sweep`, ffd.py:1601, or
    `solve_ffd_sweep_topo` :1668 when `sw` carries topology rows): K4's
    lane over the simulations.  Returns the [B, total] f32 result rows
    (not synchronised)."""
    dev = sw.group_req.device
    lay = flat_layout(sw.G, sw.E, max_nodes, sw.D, 0, sparse_k)
    flat = torch.empty((sw.B, lay["total"][1]), dtype=torch.float32,
                       device=dev)
    limits = torch.empty((sw.B, sw.P, R), dtype=torch.float32, device=dev)
    scan = sweep_topo_scan if sw.heavy else sweep_scan
    scan(sw, cat, max_nodes, flat, lay, limits, sparse_k)
    return flat


def unpack(packed, G: int, E: int, N: int, RDIM: int, D: int,
           sparse_k: int = 0, explain: int = 0) -> Dict:
    """Split one flat result row into named host arrays (ffd.py:1677,
    dense take_new rows).  With sparse_k the dense [G, E] take_exist rows
    are rebuilt from the (count, index) pairs; empty slots (count 0) are
    skipped, so a pad slot's index 0 never clears a real entry."""
    flat = np.asarray(packed)
    if not flat.flags.writeable:
        flat = np.array(flat)
    lay = flat_layout(G, E, N, D, explain, sparse_k)
    assert RDIM == R and flat.shape == (lay["total"][1],), flat.shape

    def reg(name):
        off, n = lay[name]
        return flat[off:off + n]

    if sparse_k:
        cnt = reg("te_cnt").reshape(G, sparse_k)
        idx = reg("te_idx").reshape(G, sparse_k).astype(np.int64)
        take_exist = np.zeros((G, E), dtype=flat.dtype)
        m = cnt > 0
        take_exist[np.nonzero(m)[0], idx[m]] = cnt[m]
    else:
        take_exist = reg("take_exist").reshape(G, E)
    out = dict(
        take_exist=take_exist,
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
