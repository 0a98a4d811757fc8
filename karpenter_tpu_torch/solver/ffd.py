"""The grouped-FFD solve on the card: kernel wrappers and plain versions.

The JAX reference (`karpenter_tpu/solver/ffd.py` `_solve_ffd_impl`) is one
jitted `lax.scan` over pod equivalence classes; each step takes the light
branch (no zone/capacity-type domain constraint), the heavy one
(`lax.cond(dsel > 0, heavy, light)`) or, with the `with_gang` static, the
atomic K-node gang fill for gang groups (`lax.cond(gang, gang_fill, ...)`).
Its batched entry points vmap that scan over many problems.  This module
runs them as hand-written CUDA kernels, one thread block per problem:

  * ``batch_scan`` (K5, `csrc/ffd_batch_scan.cu`): the scan over B stacked
    problems that share a catalog (`_solve_ffd_batch_impl`, the
    consolidation simulator's generic path); one solve is the B=1 launch.
    With ``with_gang`` it launches the gang instance of the template (the
    reference's `with_gang` static); gang-free problems launch the
    gang-free instance, so their rows stay those of the gang-free program.
    A problem carrying priority bands also gets the priority inversion
    witness (`with_priority`), written in each scan step beside the
    group's strand count (`csrc/ffd_witness.cuh`).
  * ``sweep_scan`` / ``sweep_topo_scan`` (K4, `csrc/ffd_sweep_scan.cu`,
    the light and the heavy lane): the scan over B simulations of one
    cluster snapshot (`_solve_ffd_sweep_impl`, `_solve_ffd_sweep_topo_impl`)
    — each simulation excludes a few existing nodes, gathers its classes'
    column masks and per-node caps from shared tables and caps the column
    price.
  * ``delta_scan`` (K6, `csrc/ffd_delta_scan.cu`): the delta path's
    seeded scan (`_solve_ffd_delta_impl`, ffd.py:1403) — one light-only
    problem started from a prefix's replayed carry (used, pool and active
    per node slot, the seeded slots' surviving columns) instead of zeros;
    the delta pass and every chunk of the speculative chunk chain run it.
  * ``sharded_scan`` (K7, `csrc/ffd_sharded_scan.cu`): the column-sharded
    scan of one problem (the reference's resident `shard_map` programs,
    ffd.py:1372 and the seeded :1446) — the offering columns and the
    (pool,type) blocks split over S shards (`ShardedCatalog`), each
    group's mask gathered from a resident row table, one thread-block
    cluster of S blocks whose column reductions combine through
    distributed shared memory.
  * ``card_scan`` (K7x, `csrc/ffd_card_scan.cu`): the same scan across
    the S cards of one host (`CardCatalog`, shard r on card r), one rank
    a card, each column reduction an exchange between the cards' kernels
    over NVLink (`CardExchange`, the protocol in `csrc/ffd_xcard.cuh`),
    every rank of a launch enqueued by one call into the kernel library
    (`CardLaunch`);
    ``card_scan_rehearsal`` launches the same instances as one
    cooperative grid of S blocks on one card, a check of the exchange
    where only one card exists.

Where the flat layout holds explain rows, K5, K6 and K7 write them in
their own launch: the scans' epilogue (`explain_pack`, the per-group
arithmetic in `csrc/ffd_explain.cuh`) computes the explain=1 elimination
counts, the topology class and the with_gang whole class included, and
with explain=2 (K5 only) the [G, O] per-column class map, from the scan's
final state, at the offsets `unpack` reads, as the reference computes
them inside the scan's program.

With ``sparse_k`` > 0 the scans also compact each group's take_exist row
into K (count, index) pairs, the reference's prefix-rank scatter.  Beside
each kernel sits its plain PyTorch version (``batch_scan_reference``,
``sweep_scan_reference``, ``sweep_topo_scan_reference``,
``delta_scan_reference``, ``sharded_scan_reference`` — K7x's too, on its
shards stacked —; ``pack_reference`` the epilogue's), a transcription of
the reference with a Python loop over problems, groups and pools; every
scan shares one light and one heavy step.  A wrapper runs the kernel for
a CUDA tensor and the plain version for a CPU tensor; there is no
fallback from one to the other.  Each wrapper counts its kernel launches
in ``.launches`` (and the launches that carried explain rows in
``.explain_launches``; ``batch_scan`` those with the map in
``.map_launches``); ``launch_counts()`` sums them by kernel instance, and
the metric family ``karpenter_tpu_solver_kernel_launches_total{kernel}``
reads it when scraped.

The flat result buffer of one problem has exactly the reference's layout
(ffd.py:1258):

    take_exist G*E  (sparse_k: counts G*K | indices G*K)
    | take_new G*N | unsched G | dom_placed G*D | used N*R | node_pool N
    | node_zone N | node_ct N | num_active 1 | [explain: counts G*5, bits G]
    | [explain=2: class map G*O] | [with_priority: prio_inv G]

(always the dense take_new rows: the reference's top-K take_new
compaction saves device-to-host bytes on a TPU link and bought nothing
on the card); a batch is B such buffers, one row each, and `unpack`
splits a row into the same named host arrays.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.models.resources import RESOURCE_AXIS
from karpenter_tpu_torch.solver import firstuse
from karpenter_tpu_torch.solver.explain import EPS, KERNEL_CONSTRAINTS

R = len(RESOURCE_AXIS)
EXPLAIN_C = len(KERNEL_CONSTRAINTS)
_CAP = 2 ** 30  # _fit_count's ceiling (ffd.py:116)
BIG = 2 ** 29  # the encoder's "unbounded" cap (encode.BIG)
MAX_POOLS = 64  # the kernels' pool-axis capacity (csrc MAXP)
MAX_DOMAINS = 128  # the kernels' domain-axis capacity (csrc MAXD)
MAX_EXCLUDED = 8  # the sweep kernels' exclusions per simulation (csrc MAXX)
MAX_SHARDS = 16  # K7's largest cluster (non-portable past 8)
MAX_CARDS = 8  # K7x's ranks, the cards of one host (csrc XMAXR)
XCH = 2048  # ints a slot of the card exchange (csrc ffd_xcard.cuh)


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
    group_gang: torch.Tensor       # [G] i32 0/1 gang unit (the gang fill)
    group_prio: torch.Tensor       # [G] i32 effective priority (0 = none)

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


@dataclass
class DeltaSeed:
    """The seeded start of one delta scan (ffd.py:406-427): the carry a
    prefix of the scan left, replayed on the host.  Slots past the seeded
    ones are unopened (zero used, inactive), and past the colmask's A rows
    have no surviving column."""
    seed_used: torch.Tensor     # [N, R] f32
    seed_pool: torch.Tensor     # [N] i32
    seed_active: torch.Tensor   # [N] i32 0/1
    seed_colmask: torch.Tensor  # [A, W] i32 surviving-column words per slot
                                # ([S, A, W_s] per shard on the mesh path,
                                # rank r's [A, W_s] in the cards form)

    @property
    def A(self) -> int:
        cm = self.seed_colmask
        return (cm[0] if isinstance(cm, (tuple, list)) else cm).shape[-2]


@dataclass
class ShardedCatalog:
    """The catalog split over S shards of the offering-column axis, on
    whole (pool,type) blocks (the reference's `P(ax)`/`P(ax, None)`
    shardings, parallel/mesh.py): every column-axis array stacked as
    [S, ...], shard r contiguous at [r]; each shard's pool column bits in
    its own words (W_s = ceil(O_s / 32), pad bits zero); pool_daemon
    replicated.  The shards in order are the full-width arrays, so `full()`
    is a view."""
    col_alloc: torch.Tensor       # [S, O_s, R] f32
    col_daemon: torch.Tensor      # [S, O_s, R] f32
    pt_alloc: torch.Tensor        # [S, PT_s, R] f32
    col_pool: torch.Tensor        # [S, O_s] i32
    pool_daemon: torch.Tensor     # [P, R] f32 (replicated)
    pool_bits: torch.Tensor       # [S, P, W_s] i32
    col_zone: torch.Tensor        # [S, O_s] i32 (tiled pattern on padding)
    col_ct: torch.Tensor          # [S, O_s] i32
    full_pool_bits: torch.Tensor  # [P, W] i32, the full-width words
    zc: int

    @property
    def S(self) -> int:
        return self.col_alloc.shape[0]

    @property
    def O_s(self) -> int:
        return self.col_alloc.shape[1]

    @property
    def PT_s(self) -> int:
        return self.pt_alloc.shape[1]

    @property
    def W_s(self) -> int:
        return (self.O_s + 31) // 32

    @property
    def O(self) -> int:
        return self.S * self.O_s

    @property
    def PT(self) -> int:
        return self.S * self.PT_s

    def full(self) -> FFDCatalog:
        """The same catalog at full width (views): what the unsharded
        kernels read (the batched and sweep paths under a mesh)."""
        return FFDCatalog(
            self.col_alloc.view(-1, R), self.col_daemon.view(-1, R),
            self.pt_alloc.view(-1, R), self.col_pool.view(-1),
            self.pool_daemon, self.full_pool_bits, self.col_zone.view(-1),
            self.col_ct.view(-1), zc=self.zc)


@dataclass
class CardCatalog:
    """The catalog split over S cards, one shard a card: the cards form of
    ShardedCatalog (the reference's shardings over the devices of a mesh,
    parallel/mesh.py).  Every column-axis field is a tuple whose [r] is
    shard r, [O_s, ...] on card r and nowhere else; pool_daemon has a
    replica on every card.  `full` is the full-width catalog on card 0
    that the unsharded kernels read (the batched and sweep paths under a
    mesh), gathered card to card once (`MeshExecutor.gather_full`).
    `slot_ids` is shard 0's leading block of grid-slot domains (the
    reference's all_gather(...)[0], ffd.py:631), a copy a card: K7x reads
    it as the slot->domain map."""
    col_alloc: Tuple[torch.Tensor, ...]    # [O_s, R] f32 on card r
    col_daemon: Tuple[torch.Tensor, ...]   # [O_s, R] f32
    pt_alloc: Tuple[torch.Tensor, ...]     # [PT_s, R] f32
    col_pool: Tuple[torch.Tensor, ...]     # [O_s] i32
    pool_daemon: Tuple[torch.Tensor, ...]  # [P, R] f32 (a replica a card)
    pool_bits: Tuple[torch.Tensor, ...]    # [P, W_s] i32
    col_zone: Tuple[torch.Tensor, ...]     # [O_s] i32
    col_ct: Tuple[torch.Tensor, ...]       # [O_s] i32
    zc: int
    full: Optional[FFDCatalog] = None
    slot_ids: Tuple[torch.Tensor, ...] = ()  # [2 zc] i32: zones, then
                                             # capacity types, on card r

    @property
    def S(self) -> int:
        return len(self.col_alloc)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(t.device for t in self.col_alloc)

    @property
    def O_s(self) -> int:
        return self.col_alloc[0].shape[0]

    @property
    def PT_s(self) -> int:
        return self.pt_alloc[0].shape[0]

    @property
    def W_s(self) -> int:
        return (self.O_s + 31) // 32

    @property
    def O(self) -> int:
        return self.S * self.O_s

    @property
    def PT(self) -> int:
        return self.S * self.PT_s

    def shard(self, r: int) -> ShardedCatalog:
        """Rank r's shard as a one-shard ShardedCatalog ([1, ...] views on
        card r): what rank r's launch reads."""
        return ShardedCatalog(
            self.col_alloc[r][None], self.col_daemon[r][None],
            self.pt_alloc[r][None], self.col_pool[r][None],
            self.pool_daemon[r], self.pool_bits[r][None],
            self.col_zone[r][None], self.col_ct[r][None],
            full_pool_bits=self.pool_bits[r], zc=self.zc)

    def stacked(self, device) -> ShardedCatalog:
        """The shards stacked on `device` as the one-card [S, ...] form
        (what the plain version reads; full_pool_bits left empty)."""
        def st(ts):
            return torch.stack([t.to(device) for t in ts])
        return ShardedCatalog(
            st(self.col_alloc), st(self.col_daemon), st(self.pt_alloc),
            st(self.col_pool), self.pool_daemon[0].to(device),
            st(self.pool_bits), st(self.col_zone), st(self.col_ct),
            full_pool_bits=torch.empty((0, 0), dtype=torch.int32,
                                       device=device), zc=self.zc)


def split_columns(a: np.ndarray, S: int, axis: int = 0) -> List[np.ndarray]:
    """S contiguous shards of `a` along `axis`, whose length S divides."""
    if a.shape[axis] % S:
        raise ValueError(f"axis of {a.shape[axis]} does not split over "
                         f"{S} shards")
    return [np.ascontiguousarray(x) for x in np.split(a, S, axis=axis)]


def shard_words(mask: np.ndarray, S: int) -> List[np.ndarray]:
    """[..., O] bool → S shards of [..., W_s] i32 words, each shard
    packing its own O/S columns from bit 0 (pad bits zero)."""
    O_s = mask.shape[-1] // S
    return [pack_mask_bits(m, O_s)
            for m in split_columns(np.asarray(mask, bool), S, axis=-1)]


def sharded_catalog_tensors(cat_arrays: Dict, S: int, ex):
    """The padded catalog arrays (numpy, as `catalog_tensors` takes
    them; PT a multiple of S) as a ShardedCatalog: each column-axis array
    committed shard by shard through `ex.put_sharded` (parallel.mesh
    MeshExecutor, which logs the bytes), pool_daemon and the full-width
    pool bits through `ex.put_replicated`.  On a mesh of cards (`ex.mesh.
    cards`) a CardCatalog: shard r committed to card r alone, pool_daemon
    on every card, shard 0's leading grid-slot ids on every card, no
    full-width pool bits (`gather_full` builds them)."""
    zc = int(cat_arrays["zc"])
    col_pool = np.asarray(cat_arrays["col_pool"], np.int32)
    pool_daemon = np.asarray(cat_arrays["pool_daemon"], np.float32)
    O, P = col_pool.shape[0], pool_daemon.shape[0]
    pt_alloc = np.asarray(cat_arrays["pt_alloc"], np.float32)
    if pt_alloc.shape[0] % S or O != pt_alloc.shape[0] * zc:
        raise ValueError(f"PT={pt_alloc.shape[0]} does not split over {S} "
                         f"shards on whole blocks")
    pool_cols = col_pool[None, :] == np.arange(P, dtype=np.int32)[:, None]

    def cols(name, dt):
        return ex.put_sharded(split_columns(
            np.asarray(cat_arrays[name], dt), S), "catalog")
    if ex.mesh.cards:
        return CardCatalog(
            col_alloc=cols("col_alloc", np.float32),
            col_daemon=cols("col_daemon", np.float32),
            pt_alloc=ex.put_sharded(split_columns(pt_alloc, S), "catalog"),
            col_pool=ex.put_sharded(split_columns(col_pool, S), "catalog"),
            pool_daemon=ex.put_replicated(pool_daemon),
            pool_bits=ex.put_sharded(shard_words(pool_cols, S), "catalog"),
            col_zone=cols("col_zone", np.int32),
            col_ct=cols("col_ct", np.int32), zc=zc,
            slot_ids=ex.put_replicated(np.concatenate([
                np.asarray(cat_arrays["col_zone"], np.int32)[:zc],
                np.asarray(cat_arrays["col_ct"], np.int32)[:zc]])))
    cat = ShardedCatalog(
        col_alloc=cols("col_alloc", np.float32),
        col_daemon=cols("col_daemon", np.float32),
        pt_alloc=ex.put_sharded(split_columns(pt_alloc, S), "catalog"),
        col_pool=ex.put_sharded(split_columns(col_pool, S), "catalog"),
        pool_daemon=ex.put_replicated(pool_daemon),
        pool_bits=ex.put_sharded(shard_words(pool_cols, S), "catalog"),
        col_zone=cols("col_zone", np.int32),
        col_ct=cols("col_ct", np.int32),
        full_pool_bits=ex.put_replicated(pack_mask_bits(pool_cols, O)),
        zc=zc)
    return cat


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
    """The reference's `_problem_args` tuple (numpy, padded; slot 2 a
    [G, O] bool mask or its packed [G, ceil(O/8)] bytes, or on the mesh
    path — `_problem_args_mesh` — the [G] rows of the resident mask table):
    17 slots, or 18 with the priority-band row `group_prio` — as the
    scan's 18 host arrays in FFDProblem order (a zero priority row for the
    17-slot form).  The mesh form's `mask_bits` holds the [G] row ids."""
    if len(prob) not in (17, 18):
        raise ValueError(f"a problem tuple has 17 or 18 slots, not "
                         f"{len(prob)}")
    (group_req, group_count, group_mask, exist_cap, exist_remaining,
     pool_limit, group_ncap, group_dsel, group_dbase, group_dcap,
     group_skew, group_mindom, group_delig, group_whole, group_gang,
     exist_zone, exist_ct) = prob[:17]
    group_prio = (np.asarray(prob[17], np.int32) if len(prob) > 17
                  else np.zeros(np.asarray(group_count).shape, np.int32))
    group_mask = np.asarray(group_mask)
    return [np.asarray(group_req, np.float32),
            np.asarray(group_count, np.int32),
            (group_mask.astype(np.int32) if group_mask.ndim == 1
             else pack_mask_bits(group_mask, O)),
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
            np.asarray(exist_ct, np.int32),
            np.asarray(group_gang).astype(np.int32),
            group_prio]


def problem_tensors(prob: Sequence[np.ndarray], O: int,
                    device) -> FFDProblem:
    """One problem tuple as the scan's device arguments, in one
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
    """The reference's problem tuple (17 or 18 slots) and its catalog
    arrays (numpy) as the port's kernel arguments on `device`."""
    cat = catalog_tensors(cat_arrays, device)
    return problem_tensors(prob, cat.O, device), cat


def delta_tensors(prob: Sequence[np.ndarray], seed_used: np.ndarray,
                  seed_pool: np.ndarray, seed_active: np.ndarray,
                  seed_colmask: np.ndarray, O: int, device,
                  upload=_upload) -> Tuple[FFDProblem, DeltaSeed]:
    """A delta problem (the reference's 17-slot suffix tuple, numpy) and its
    seed — seed_used [N, R], seed_pool [N], seed_active [N], seed_colmask
    [A, O] bool or its packed [A, ceil(O/8)] bytes — as K6's device
    arguments, in one host→device copy.  The seeded scan is light-only,
    gang-free and priority-free by contract (the reference's delta program
    runs with_topology False, with_gang 0, with_priority 0): a problem with
    a domain, gang or priority row is refused here, on the host, rather
    than solved as something else.  With `seed_colmask` None (the mesh
    path, whose seed words go per shard through the executor) the seed's
    `seed_colmask` is left for the caller to set."""
    if len(prob) != 17:
        raise ValueError("the seeded scan takes the 17-slot problem: it "
                         "has no priority witness")
    if np.asarray(prob[7]).any():
        raise ValueError("the seeded scan is light-only: a group has a "
                         "zone or capacity-type domain")
    if np.asarray(prob[14]).any():
        raise ValueError("the seeded scan is gang-free: a group is a gang")
    arrays = problem_arrays(prob, O) + [
        np.asarray(seed_used, np.float32),
        np.asarray(seed_pool, np.int32),
        np.asarray(seed_active).astype(np.int32)]
    if seed_colmask is None:
        t = upload(arrays, torch.device(device))
        return FFDProblem(*t[:-3]), DeltaSeed(*t[-3:], seed_colmask=None)
    t = upload(arrays + [pack_mask_bits(np.asarray(seed_colmask), O)],
               torch.device(device))
    return FFDProblem(*t[:-4]), DeltaSeed(*t[-4:])


# -- the flat result layout ---------------------------------------------------
def flat_layout(G: int, E: int, N: int, D: int, explain: int = 0,
                sparse_k: int = 0, explain_o: int = 0,
                with_priority: int = 0) -> Dict[str, Tuple[int, int]]:
    """(offset, length) of every region of one problem's flat result
    buffer, plus ("total", n).  With `sparse_k` the take_exist rows are
    replaced by K (count, index) pairs per group; explain=2 appends the
    [G, explain_o] class map after the counts, and `with_priority` the
    priority inversion witness [G] last (ffd.py:1677-1759)."""
    head = ([("te_cnt", G * sparse_k), ("te_idx", G * sparse_k)]
            if sparse_k else [("take_exist", G * E)])
    sizes = head + [("take_new", G * N), ("unsched", G),
                    ("dom_placed", G * D), ("used", N * R),
                    ("node_pool", N), ("node_zone", N), ("node_ct", N),
                    ("num_active", 1)]
    if explain:
        sizes += [("explain_counts", G * EXPLAIN_C), ("explain_bits", G)]
    if explain >= 2:
        if explain_o < 1:
            raise ValueError("explain=2 needs the map's column width")
        sizes += [("explain_map", G * explain_o)]
    if with_priority:
        sizes += [("prio_inv", G)]
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
                 work: Optional[Dict[str, int]],
                 seed: Optional[DeltaSeed] = None, shards: int = 1,
                 gmask: Optional[torch.Tensor] = None,
                 seed_cols: Optional[torch.Tensor] = None):
        """With `shards` S > 1 (the column-sharded scan) every reduction
        over the column or (pool,type) axis runs per contiguous shard and
        combines over the shards (`_cmax`, `_cany`); `gmask` [G, O] and
        `seed_cols` [A, O] bool then give the group masks and the seed's
        surviving columns in place of the problem's and the seed's words."""
        dev = prob.group_req.device
        i32, f32 = torch.int32, torch.float32
        self.prob, self.cat, self.N, self.work = prob, cat, N, work
        self.dev = dev
        self.G, self.E, self.P, self.D = prob.G, prob.E, prob.P, prob.D
        self.zc, self.PT, self.O = cat.zc, cat.PT, cat.O
        self.S = shards
        self.gmask_all = (gmask if gmask is not None
                          else _unpack_bits(prob.mask_bits, cat.O))
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
        if seed is not None:
            # the seeded start (ffd.py:406-427): the prefix's used, pool
            # and active slots, its surviving columns in the first A slots
            # (none past them), num_active the count of seeded slots;
            # exist_remaining arrives already consumed
            self.used = seed.seed_used.clone()
            self.colmask[:seed.A] = (
                seed_cols if seed_cols is not None
                else _unpack_bits(seed.seed_colmask, cat.O))
            self.active = seed.seed_active != 0
            self.node_pool = seed.seed_pool.clone()
            self.num_active = self.active.to(i32).sum().to(i32)

    def _cmax(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Max over the column (or (pool,type)) axis `dim`: each shard's
        local max, then the max over the shards — the reference's `_axmax`
        (ffd.py:93), a local max and a pmax.  Exact in any order."""
        local = [c.amax(dim=dim) for c in torch.chunk(x, self.S, dim=dim)]
        return torch.stack(local).amax(dim=0)

    def _cany(self, x: torch.Tensor) -> torch.Tensor:
        """any() over the column axis: per shard, then over the shards
        (the reference's `_axany`, ffd.py:107)."""
        return torch.stack([c.any() for c in torch.chunk(x, self.S)]).any()

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
        best = self._cmax(torch.where(elig_pt, cap_npt, 0), dim=1)
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
            k_full = self._cmax(torch.where(cols_p, per_col, 0)).to(i32)
            pd = cat.pool_daemon[p]
            can = (self._cany(cols_p) & _fits(limits[p] - pd - req)
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
        zc_dom = col_dom[:zc]   # shard 0's leading block
        slotmax = self._cmax(cap_no.view(N, PT, zc), dim=1)          # [N, ZC]
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
        d_real = torch.clamp(self._cmax(col_dom) + 1, min=1)
        score = _w32(_mul_i32(torch.minimum(cap_nd, cnt), D + 1).to(
            torch.int64) + (idx[None, :] + dom_ids[:, None]) % d_real)
        bd = torch.argmax(score, dim=0).to(i32)                       # [N]
        sel_nd = dom_ids[:, None] == bd[None, :]
        cap_nd = torch.where(sel_nd, cap_nd, 0).to(i32)

        per_col = torch.minimum(_fit_count(self.col_avail, req), ncap)
        col_feas = gmask & (per_col >= 1)
        kfull_pd = torch.stack([
            self._cmax(torch.where(
                dom_cols & (col_feas & self.pool_idx[p])[None, :],
                per_col[None, :], 0), dim=1)
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

    def gang(self, g: int):
        """The atomic K-node gang fill (ffd.py:820-1047): for every domain
        the exact light cascade — existing, in-flight, new nodes —
        restricted to that domain's nodes and columns, against its own
        copy of the pool budget; the feasible domain of lowest trial rank
        (dbase; ties to the lower index) commits and pins every node it
        touches, every other candidate is dropped.  dsel 0 maps every
        column and node to domain 0.  Returns (take_exist [E], take_new
        [N], unsched, dom_placed [D]: each domain's candidate total,
        saturated at the gang size)."""
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
        limits = self.limits
        dom_ids = torch.arange(D, dtype=i32, device=dev)

        def by_dsel(zone, ct):
            return (zone if dsel == 1 else ct if dsel == 2
                    else torch.zeros_like(zone))
        col_dom = by_dsel(cat.col_zone, cat.col_ct)                   # [O]
        dom_cols = col_dom[None, :] == dom_ids[:, None]              # [D, O]

        # -- 1. existing-node candidate fills per domain
        if E:
            ex_dom = by_dsel(prob.exist_zone, prob.exist_ct)
            dom_ex = ex_dom[None, :] == dom_ids[:, None]             # [D, E]
            cap_e = torch.minimum(_fit_count(self.exist_rem, req),
                                  prob.exist_cap[g])
            cap_ed = torch.where(dom_ex, cap_e[None, :], 0).to(i32)
            take_ed = torch.stack([_prefix_fill(cap_ed[d], cnt)
                                   for d in range(D)])               # [D, E]
            placed_e = _sum_i32(take_ed, -1)
        else:
            placed_e = torch.zeros(D, dtype=i32, device=dev)
        rem1 = cnt - placed_e                                        # [D]

        # -- 2. in-flight candidate fills per domain (a node pinned to
        # another domain has its columns narrowed to that domain's)
        cap_npt = _fit_count(cat.pt_alloc[None] - used[:, None], req)
        cap_no = torch.where(colmask & gmask[None],
                             _pt_expand(cap_npt, zc), 0)             # [N, O]
        zc_dom = col_dom[:zc]   # shard 0's leading block
        slotmax = self._cmax(cap_no.view(N, PT, zc), dim=1)          # [N, ZC]
        cap_nd = torch.where(
            zc_dom[None, :, None] == dom_ids[None, None, :],
            slotmax[:, :, None], 0).max(dim=1).values.T              # [D, N]
        cap_nd = torch.minimum(cap_nd, ncap)
        cap_nd = torch.where(active[None, :], cap_nd, 0).to(i32)
        take_nd = torch.stack([
            _prefix_fill(_clamp_pool_limits(cap_nd[d], node_pool, limits,
                                            req, P), rem1[d])
            for d in range(D)])                                      # [D, N]
        rem2 = rem1 - _sum_i32(take_nd, -1)
        if work is not None:
            # existing rows, each domain's fit of the active nodes'
            # eligible blocks, the empty-node fit of each admitted
            # column, each domain's pool budgets and cascade fits
            elig_pt = (colmask & gmask[None]).view(N, PT, zc).any(dim=-1)
            work["fit"] += (E + int(gmask.sum()) + D * (
                4 * P + int((elig_pt & active[:, None]).sum())))
            work["test"] += D * P

        # -- 3. open-new candidate cascade per domain, each on its own
        # budget copy pre-charged with the domain's in-flight take
        per_col = torch.minimum(_fit_count(self.col_avail, req), ncap)
        col_feas = gmask & (per_col >= 1)
        kfull_pd = torch.stack([
            self._cmax(torch.where(
                dom_cols & (col_feas & self.pool_idx[p])[None, :],
                per_col[None, :], 0), dim=1)
            for p in range(P)]).to(i32)                              # [P, D]
        pool_take_d = torch.stack([
            torch.zeros(P, dtype=f32, device=dev).index_add_(
                0, node_pool.long(), take_nd[d].to(f32))
            for d in range(D)])                                      # [D, P]
        limits_d = limits[None] - pool_take_d[:, :, None] * req[None, None]
        c_rem_d = rem2
        k_new_d = torch.zeros((D, N), dtype=i32, device=dev)
        new_pool_d = torch.zeros((D, N), dtype=i32, device=dev)
        newmask_d = torch.zeros((D, N), dtype=torch.bool, device=dev)
        na_d = torch.zeros(D, dtype=i32, device=dev) + num_active
        for p in range(P):
            kf_raw = kfull_pd[p]                                     # [D]
            lim_p = limits_d[:, p]                                   # [D, R]
            pd = cat.pool_daemon[p]
            can = (_fits(lim_p - pd[None] - req[None]) & (c_rem_d > 0)
                   & (kf_raw > 0))
            kf = torch.clamp(kf_raw, min=1)
            t = torch.minimum(c_rem_d, _fit_count(lim_p, req))
            m_t = _ceil_div(t, kf)
            t = torch.minimum(t, _fit_count(
                lim_p - m_t[:, None].to(f32) * pd[None], req))
            m_need = torch.where(can, _ceil_div(t, kf), 0)
            m = torch.minimum(m_need, N - na_d).to(i32)
            newmask = ((idx[None, :] >= na_d[:, None])
                       & (idx[None, :] < (na_d + m)[:, None]))
            pos = idx[None, :] - na_d[:, None]
            taken = torch.minimum(t, _mul_i32(m, kf_raw))
            k_node = torch.where(
                newmask,
                torch.where(pos == (m - 1)[:, None],
                            (taken - _mul_i32(m - 1, kf_raw))[:, None],
                            kf_raw[:, None]), 0).to(i32)
            k_new_d = k_new_d + k_node
            new_pool_d = torch.where(newmask, p, new_pool_d).to(i32)
            newmask_d = newmask_d | newmask
            na_d = na_d + m
            limits_d = limits_d.clone()
            limits_d[:, p] = limits_d[:, p] + (-(
                m[:, None].to(f32) * pd[None]
                + taken[:, None].to(f32) * req[None]))
            c_rem_d = c_rem_d - taken
        placed_d = _w32(placed_e.to(torch.int64) + _sum_i32(take_nd, -1)
                        + (rem2 - c_rem_d))                          # [D]

        # -- the winner: the feasible domain of lowest trial rank
        feas = (prob.group_delig[g] != 0) & (placed_d >= cnt)
        rank = torch.where(feas, prob.group_dbase[g], BIG)
        w = int(torch.argmin(rank))
        ok = bool(rank[w] < BIG) and int(cnt) > 0

        # -- commit the winner (every other candidate is never applied)
        zeros_n = torch.zeros(N, dtype=i32, device=dev)
        if E:
            take_e = take_ed[w] if ok else torch.zeros_like(cap_e)
            self.exist_rem = self.exist_rem - take_e[:, None] * req
        else:
            take_e = None
        take_n = take_nd[w] if ok else zeros_n
        used = used + take_n[:, None] * req
        touched = take_n > 0
        dcols = _slot_expand((zc_dom == w)[None, :], PT)             # [1, O]
        colmask = torch.where(touched[:, None], colmask & gmask[None] & dcols,
                              colmask)
        ok_pt = _fits(cat.pt_alloc[None] - used[:, None])
        colmask = colmask & _pt_expand(ok_pt, zc)
        pool_take = torch.zeros(P, dtype=f32, device=dev).index_add_(
            0, node_pool.long(), take_n.to(f32))
        limits = limits - pool_take[:, None] * req
        k_new = k_new_d[w] if ok else zeros_n
        newmask = newmask_d[w] if ok else torch.zeros_like(touched)
        new_pool = new_pool_d[w]
        new_used = (cat.pool_daemon[new_pool.long()]
                    + k_new[:, None].to(f32) * req)
        used = torch.where(newmask[:, None], new_used, used)
        new_cols = (col_feas[None] & (cat.col_pool[None] == new_pool[:, None])
                    & dcols)
        new_ok_pt = _fits(cat.pt_alloc[None] - new_used[:, None])
        if work is not None:
            work["test"] += int((elig_pt & touched[:, None]).sum()) + int(
                newmask.sum()) * int(col_feas.view(PT, zc).any(-1).sum())
        colmask = torch.where(newmask[:, None],
                              new_cols & _pt_expand(new_ok_pt, zc), colmask)
        active = active | newmask
        node_pool = torch.where(newmask, new_pool, node_pool).to(i32)
        num_active = num_active + newmask.to(i32).sum().to(i32)
        limits = limits.clone()
        for p in range(P):
            on_p = newmask & (new_pool == p)
            m_p = on_p.to(f32).sum()
            taken_p = torch.where(on_p, k_new, 0).to(f32).sum()
            limits[p] = limits[p] + (-(m_p * cat.pool_daemon[p]
                                       + taken_p * req))
        # pin every node the gang touched to the winning domain
        pin = touched | newmask
        if dsel == 1:
            self.node_zone = torch.where(pin, w, self.node_zone).to(i32)
        elif dsel == 2:
            self.node_ct = torch.where(pin, w, self.node_ct).to(i32)
        self.used, self.colmask, self.active = used, colmask, active
        self.node_pool, self.num_active, self.limits = (node_pool,
                                                        num_active, limits)
        unsched = torch.zeros((), dtype=i32, device=dev) if ok else cnt
        return (take_e, take_n + k_new, unsched,
                torch.minimum(placed_d, cnt).to(i32))


def priority_witness(count: torch.Tensor, unsched: torch.Tensor,
                     prio: torch.Tensor) -> torch.Tensor:
    """The priority inversion witness (ffd.py:1238-1257): a group that
    placed pods after an earlier group of strictly higher priority
    stranded — the exclusive running max of the stranded groups'
    priorities, from -(2^31)+1.  [G] i32 each → [G] bool."""
    neg = -(2 ** 31) + 1
    stranded = unsched > 0
    before, out = neg, []
    for gp, st in zip(prio.tolist(), stranded.tolist()):
        out.append(gp < before)
        if st:
            before = max(before, gp)
    placed_any = (count - unsched) > 0
    return placed_any & torch.tensor(out, dtype=torch.bool,
                                     device=count.device)



def _scan_reference(prob: FFDProblem, cat: FFDCatalog, N: int,
                    flat: torch.Tensor, lay: Dict, limits_out: torch.Tensor,
                    work: Optional[Dict[str, int]], topology: bool,
                    sparse_k: int = 0, with_gang: int = 0,
                    seed: Optional[DeltaSeed] = None, **sharding) -> None:
    """The plain scan of one problem: per group the light step, or with
    `topology` the heavy step for a group with dsel > 0 (the reference's
    `lax.cond(dsel > 0, heavy, light)`, ffd.py:1057), or with `with_gang`
    the gang fill for a gang group (ffd.py:1049-1056).  Writes the
    kernels' outputs into the problem's flat row; with `sparse_k`, the
    take_exist rows compacted; where the layout holds `prio_inv`, the
    priority inversion witness; with a `seed`, from the seeded carry;
    `sharding` (shards, gmask, seed_cols) as `_Scan` takes it."""
    f32 = torch.float32
    s = _Scan(prob, cat, N, work, seed, **sharding)
    dsel = prob.group_dsel.tolist()
    gang = prob.group_gang.tolist()
    te_rows, tn_rows, un_rows, dp_rows = [], [], [], []
    zeros_d = torch.zeros(prob.D, dtype=torch.int32, device=flat.device)
    for g in range(prob.G):
        if with_gang and gang[g]:
            te, tn, un, dp = s.gang(g)
        elif topology and dsel[g] > 0:
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
    if "prio_inv" in lay:
        put("prio_inv", priority_witness(
            prob.group_count, torch.stack(un_rows).to(torch.int32),
            prob.group_prio))
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
                         work: Optional[Dict[str, int]] = None,
                         with_gang: int = 0) -> None:
    """Plain PyTorch version of K5: `_solve_ffd_batch_impl`
    (ffd.py:1492) — the scan with the heavy branch traced (and with
    `with_gang` the gang fill), per problem of the batch, transcribed step
    for step (a Python loop over problems, groups and pools).  Writes the
    kernel's outputs, one flat row per problem, the priority witness
    and the explain rows (`pack_reference`) where the layout holds them.

    Given a `work` dict, adds to it what the kernel computes on this
    data: "fit", the R-vector `_fit_count`s, "test", the R-vector
    all-fits tests, and "flops", the water-fill's scalar float
    operations.  The kernel fits an in-flight node only against the
    (pool,type) blocks that still hold a surviving column the group
    admits, and narrows only touched and opened nodes, on the blocks
    their candidate columns span."""
    for b in range(batch.B):
        _scan_reference(batch.at(b), cat, N, flat[b], lay, limits_out[b],
                        work, topology=True, sparse_k=sparse_k,
                        with_gang=with_gang)
        if "explain_counts" in lay:
            pack_reference(batch.at(b), cat, N, flat[b], lay, limits_out[b],
                           with_gang)


def delta_scan_reference(prob: FFDProblem, seed: DeltaSeed, cat: FFDCatalog,
                         N: int, flat: torch.Tensor, lay: Dict,
                         limits_out: torch.Tensor,
                         work: Optional[Dict[str, int]] = None) -> None:
    """Plain PyTorch version of K6: `_solve_ffd_delta_impl` (ffd.py:1403)
    — the scan of one problem started from `seed` (ffd.py:406-427), every
    group light (with_topology False), dense take_exist rows, no
    witness, and the explain counts (`pack_reference`) where the layout
    holds them.  Writes one flat row; `work` counts as in
    `batch_scan_reference`."""
    _scan_reference(prob, cat, N, flat, lay, limits_out, work,
                    topology=False, seed=seed)
    if "explain_counts" in lay:
        pack_reference(prob, cat, N, flat, lay, limits_out)


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
                      dcap, skew, mindom, delig, sh.exist_zone, sh.exist_ct,
                      zeros_g, zeros_g)


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
                   flat: torch.Tensor, lay: Dict, limits: torch.Tensor,
                   with_gang: int = 0, shards: int = 1,
                   gmask: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of the scans' explain epilogue
    (`explain_pack`, csrc/ffd_scan_common.cuh): the explain=1 aux
    (ffd.py:1113-1214), the topology class (ffd.py:1141-1175) and, with
    `with_gang`, the whole class of gang strands (ffd.py:1181-1194)
    included; where the layout holds `explain_map`, the explain=2
    per-column class map (ffd.py:1215-1237), from the scan's outputs in
    `flat` and its final pool budgets `limits`.  With `shards` S > 1
    (the column-sharded scan's epilogue) each class count is summed per
    contiguous shard of the (pool,type) blocks and then over the shards
    (the reference's psum, ffd.py:1202), the slot class joining after the
    sum; `gmask` [G, O] bool gives the group masks in place of the
    problem's words."""
    dev = flat.device
    i32, f32 = torch.int32, torch.float32
    G = prob.G
    zc, PT = cat.zc, cat.PT
    gmask_pt = (gmask if gmask is not None
                else _unpack_bits(prob.mask_bits, cat.O)).view(G, PT, zc)

    def psum(x):  # [G, PT, ...] -> [G]: per shard, then over the shards
        x = x.reshape(G, PT, -1)
        return torch.stack([c.sum((1, 2)) for c in
                            torch.chunk(x, shards, dim=1)]).sum(0)
    cols_per_block = gmask_pt.sum(dim=-1).to(i32)            # [G, PT]
    pt_daemon = cat.col_daemon.view(PT, zc, R)[:, 0]
    pt_pool = cat.col_pool.view(PT, zc)[:, 0].long()
    req = prob.group_req
    fits_pt = _fits(cat.pt_alloc[None] - pt_daemon[None]
                    - req[:, None])                          # [G, PT]
    lim_ok = _fits(limits[None] - cat.pool_daemon[None]
                   - req[:, None])                           # [G, P]
    lim_ok_pt = lim_ok[:, pt_pool]
    elim_fit = psum(torch.where(~fits_pt, cols_per_block, 0))
    elim_limit = psum(torch.where(fits_pt & ~lim_ok_pt, cols_per_block, 0))
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
    elim_topo = psum(torch.where(
        (prob.group_dsel > 0)[:, None, None] & slot_blocked[:, None, :]
        & ok_pt[:, :, None], gmask_pt.to(i32), 0))
    stranded = _region(flat, lay, "unsched") > 0
    topo_sel = ((prob.group_dsel > 0)[:, None, None]
                & slot_blocked[:, None, :])                  # [G, 1, ZC]
    whole = prob.group_whole != 0
    if with_gang:
        # gang strands count in the whole class too, less the columns
        # topology already claimed (a gang carries dsel > 0)
        whole = whole | (prob.group_gang != 0)
        whole_cols = psum(torch.where(ok_pt[:, :, None] & ~topo_sel,
                                      gmask_pt.to(i32), 0))
    else:
        whole_cols = psum(torch.where(ok_pt, cols_per_block, 0))
    elim_whole = torch.where(whole & stranded, whole_cols, 0)
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
    if "explain_map" not in lay:
        return
    # explain=2: each admitted column's first eliminating class, fit >
    # limit > topology > whole (1-based into KERNEL_CONSTRAINTS, 0 kept)
    gmask = gmask_pt.reshape(G, -1)                          # [G, O]
    fits_col = fits_pt.repeat_interleave(zc, dim=1)
    lim_col = lim_ok_pt.repeat_interleave(zc, dim=1)
    col_dom = torch.where((prob.group_dsel == 1)[:, None],
                          cat.col_zone[None, :], cat.col_ct[None, :])
    col_blocked = torch.gather(
        blocked_dom, 1, torch.clamp(col_dom, 0, D - 1).long())
    cls = torch.where(gmask & ~fits_col, 1, 0)
    cls = torch.where(gmask & fits_col & ~lim_col, 2, cls)
    cls = torch.where(gmask & (prob.group_dsel > 0)[:, None] & col_blocked
                      & (cls == 0), 3, cls)
    cls = torch.where(gmask & (whole & stranded)[:, None] & (cls == 0), 4,
                      cls)
    _region(flat, lay, "explain_map").copy_(cls.to(f32).reshape(-1))


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


def _problem_fields(prob: FFDProblem, mask_shape: Tuple[int, ...]):
    """(name, tensor, dtype, shape) of every field of one problem, its
    mask_bits of `mask_shape`."""
    G, E, P, D = prob.G, prob.E, prob.P, prob.D
    f32, i32 = torch.float32, torch.int32
    return (("group_req", prob.group_req, f32, (G, R)),
            ("group_count", prob.group_count, i32, (G,)),
            ("mask_bits", prob.mask_bits, i32, mask_shape),
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
            ("group_gang", prob.group_gang, i32, (G,)),
            ("group_prio", prob.group_prio, i32, (G,)))


def _check_problem(prob: FFDProblem, cat: FFDCatalog, N: int,
                   device) -> None:
    """Shapes, types, device and contiguity of one problem (FFDProblem) or
    of a batch (FFDBatch: every shape with its leading B)."""
    G, P, D = prob.G, prob.P, prob.D
    lead = (prob.B,) if isinstance(prob, FFDBatch) else ()
    for name, t, dt, shp in _problem_fields(prob, (G, cat.W)):
        _check(t, name, dt, lead + shp, device)
    _check_catalog(cat, P, device)
    if N < 1 or G < 1 or D < 1:
        raise ValueError(f"empty problem: G={G}, N={N}, D={D}")


def _check_sweep_rows(sw: SweepBatch, N: int, device) -> None:
    """A chunk's own rows: shapes, types, device and contiguity."""
    B, G, P, X, D = sw.B, sw.G, sw.P, sw.X, sw.D
    f32, i32 = torch.float32, torch.int32
    checks = [
        ("group_req", sw.group_req, f32, (B, G, R)),
        ("group_count", sw.group_count, i32, (B, G)),
        ("group_class", sw.group_class, i32, (B, G)),
        ("exclude_idx", sw.exclude_idx, i32, (B, X)),
        ("price_cap", sw.price_cap, f32, (B,)),
        ("pool_limit", sw.pool_limit, f32, (B, P, R))]
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
    if N < 1 or G < 1 or B < 1:
        raise ValueError(f"empty sweep: B={B}, G={G}, N={N}")
    if X > MAX_EXCLUDED:
        raise ValueError(f"{X} exclusions per simulation: the sweep "
                         f"kernels take at most {MAX_EXCLUDED}")


def _check_sweep_shared(sh: SweepShared, cat: FFDCatalog, P: int,
                        device) -> None:
    """A sweep's snapshot and catalog (once a sweep, `SweepLaunch`)."""
    E, W = sh.exist_remaining.shape[0], cat.W
    f32, i32 = torch.float32, torch.int32
    C = sh.class_bits.shape[0]
    for name, t, dt, shp in (
            ("class_bits", sh.class_bits, i32, (C, W)),
            ("class_cap", sh.class_cap, i32, (C, E)),
            ("exist_remaining", sh.exist_remaining, f32, (E, R)),
            ("exist_zone", sh.exist_zone, i32, (E,)),
            ("exist_ct", sh.exist_ct, i32, (E,)),
            ("col_price", sh.col_price, f32, (cat.O,))):
        _check(t, name, dt, shp, device)
    _check_catalog(cat, P, device)
    if C < 1:
        raise ValueError("empty sweep: no class rows")


def _check_outputs(B: int, P: int, flat: torch.Tensor, lay: Dict,
                   limits_out: torch.Tensor, sparse_k: int) -> None:
    dev = flat.device
    _check(flat, "flat", torch.float32, (B, lay["total"][1]), dev)
    _check(limits_out, "limits_out", torch.float32, (B, P, R), dev)
    if ("te_cnt" in lay) != (sparse_k > 0) or (
            sparse_k and lay["te_cnt"][1] != lay["unsched"][1] * sparse_k):
        raise ValueError(f"the flat layout does not hold sparse_k="
                         f"{sparse_k} take_exist rows")


def _check_explain(lay: Dict, G: int, O: int, map_ok: bool) -> None:
    """The explain regions of a flat layout as the scans' epilogue writes
    them: the [G, 5] counts and the [G] bits both or neither, and the
    [G, O] class map only with them, where the scan writes a map."""
    have = [n for n in ("explain_counts", "explain_bits") if n in lay]
    if have and (len(have) != 2 or lay["explain_counts"][1] != G * EXPLAIN_C
                 or lay["explain_bits"][1] != G):
        raise ValueError("the flat layout's explain counts are not "
                         f"[G, {EXPLAIN_C}] and [G] rows")
    if "explain_map" in lay:
        if not map_ok:
            raise ValueError("this scan writes at most the explain counts "
                             "(explain=2 has no form here)")
        if not have or lay["explain_map"][1] != G * O:
            raise ValueError("the flat layout's explain map is not [G, O] "
                             "after the explain counts")


def _count_explain(wrapper, lay: Dict) -> None:
    """Count one launch that carried explain rows (and a map: K5 only, the
    others refuse one in `_check_explain`)."""
    if "explain_counts" in lay:
        wrapper.explain_launches += 1
    if "explain_map" in lay:
        wrapper.map_launches += 1


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _first_launch(*key) -> None:
    """Count a kernel wrapper's launch configuration (its entry point and
    shape) the first time the process meets it (`firstuse`): on the card
    the first launch of a configuration pays the module load and its
    attributes.  Counted on the CPU too, where the plain version runs, so
    the warm-up's coverage is testable there."""
    firstuse.first("launch", key)


# ScanArgs' pointer fields in order (csrc ffd_scan_common.cuh): the
# argument array every scan entry point takes
SCAN_FIELDS = (
    "group_req", "group_count", "mask_bits", "exist_cap", "exist_remaining",
    "pool_limit", "group_ncap", "group_whole",
    "col_alloc", "col_daemon", "pt_alloc", "col_pool", "pool_daemon",
    "pool_bits",
    "exist_rem", "used", "colmask", "active", "node_pool", "cap_e", "limits",
    "take_exist", "take_new", "unsched", "dom_placed", "used_out",
    "pool_out", "zone_out", "ct_out", "na_out",
    "group_dsel", "group_dbase", "group_dcap", "group_skew", "group_mindom",
    "group_delig", "exist_zone", "exist_ct", "col_zone", "col_ct",
    "node_zone", "node_ct",
    "group_class", "exclude_idx", "price_cap", "col_price", "te_dense",
    "te_head", "group_gang", "group_prio", "prio_inv",
    "seed_used", "seed_pool", "seed_active", "seed_colmask",
    "mask_rows", "xslot", "ex_counts", "ex_bits", "ex_map", "row0", "xrow")
# the flat row's regions (flat_layout's names) each output field points at
SCAN_REGIONS = (
    ("take_exist", "take_exist"), ("take_new", "take_new"),
    ("unsched", "unsched"), ("dom_placed", "dom_placed"),
    ("used_out", "used"), ("pool_out", "node_pool"),
    ("zone_out", "node_zone"), ("ct_out", "node_ct"),
    ("na_out", "num_active"), ("te_head", "te_cnt"),
    ("prio_inv", "prio_inv"), ("ex_counts", "explain_counts"),
    ("ex_bits", "explain_bits"), ("ex_map", "explain_map"))
# the carry's fields (the scratch of a device-memory carry)
CARRY_FIELDS = ("exist_rem", "used", "colmask", "active", "node_pool",
                "cap_e", "node_zone", "node_ct", "te_dense")
SWEEP_ENTRIES = ("ffd_sweep_scan", "ffd_sweep_topo_scan")
SWEEP_SMEM_BUDGET = 200 * 1024  # csrc SWEEP_SMEM_BUDGET


def _summary_words(W: int, ZC: int) -> int:
    """u32 words of a node row's chunk summary (csrc ffd_walk.cuh
    summary_words)."""
    pow2 = ZC & -ZC
    chunk = ZC // (pow2 if pow2 < 32 else 32)
    return (-(-W // chunk) + 31) // 32


def scan_smem(G: int, E: int, N: int, PT: int, ZC: int, P: int, D: int,
              W: int, K: int, topo: bool, sweep: bool,
              carry: bool = False) -> int:
    """Bytes of dynamic shared memory one block of a scan takes, as the
    kernels lay it out (csrc `scan_smem_base`): the (pool,type) rows, the
    per-slot caps and takes, the group's and the feasible column words,
    with `topo` the slot domains and the [P, D] best columns, with `sweep`
    the price-cap words, and the chunk summaries.  With `carry`, K4's
    carry after them (csrc `carry_layout`): the existing rows from a
    16-byte boundary, their caps, the dense take_exist rows when K > 0,
    used, the column words, four ints a slot and the pool budgets."""
    words = (PT * R + 2 * N + 2 * W + ((N + P * D) if topo else 0)
             + (W if sweep else 0) + (N + 1) * _summary_words(W, ZC))
    base = 4 * words
    if not carry:
        return base
    return ((base + 15) & ~15) + 4 * (
        E * R + E + (G * E if K > 0 else 0) + N * R + N * W + 4 * N + P * R)


def sweep_carry_fits(G: int, E: int, N: int, PT: int, ZC: int, P: int,
                     D: int, W: int, K: int, heavy: bool) -> bool:
    """K4's route, chosen by shape as its entry point chooses it (csrc
    `sweep_carry_fits`): the carry in each block's shared memory when the
    block's whole dynamic shared memory stays within SWEEP_SMEM_BUDGET
    (the H100's 227 KB a block less the static shared state), else the
    carry in device memory, one slice a block."""
    return scan_smem(G, E, N, PT, ZC, P, D, W, K, topo=heavy, sweep=True,
                     carry=True) <= SWEEP_SMEM_BUDGET


def _region_ptrs(base: int, lay: Dict) -> Dict[str, int]:
    """The output fields' device addresses in the flat row at `base`."""
    return {f: base + 4 * lay[name][0] if name in lay else 0
            for f, name in SCAN_REGIONS}


def _carry_scratch(reps: int, G: int, E: int, N: int, W: int, P: int,
                   sparse_k: int, total: int, n_x: int,
                   dev) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """The carry's device slices, one a block (`reps`), in two buffers
    (and on the mesh the other blocks' flat rows and budgets, `total` > 0,
    and the slot scratch, n_x ints): {field: tensor}, the buffers."""
    n_rows = (reps - 1) * (total + P * R) if total else 0
    scratch_f = torch.empty(reps * (E * R + N * R + G * E * (sparse_k > 0))
                            + n_rows, dtype=torch.float32, device=dev)
    scratch_i = torch.empty(reps * (W * N + 4 * N + E) + n_x,
                            dtype=torch.int32, device=dev)
    rest = scratch_i[reps * W * N:]
    out = {
        "exist_rem": scratch_f[:reps * E * R],
        "used": scratch_f[reps * E * R:reps * (E * R + N * R)],
        "te_dense": scratch_f[reps * (E * R + N * R):] if sparse_k else None,
        "xrow": scratch_f[scratch_f.numel() - n_rows:] if n_rows else None,
        "colmask": scratch_i[:reps * W * N],
        "active": rest[:reps * N], "node_pool": rest[reps * N:2 * reps * N],
        "node_zone": rest[2 * reps * N:3 * reps * N],
        "node_ct": rest[3 * reps * N:4 * reps * N],
        "cap_e": rest[4 * reps * N:4 * reps * N + reps * E],
        "xslot": rest[4 * reps * N + reps * E:] if n_x else None}
    return out, (scratch_f, scratch_i)


def _scan_args(entry: str, B: int, G: int, E: int, N: int, P: int,
               D: int, X: int, cat, flat: torch.Tensor,
               lay: Dict, limits_out: torch.Tensor, sparse_k: int,
               inputs: Dict[str, Optional[torch.Tensor]],
               A: int = 0, mesh: Optional[Dict] = None):
    """The argument array of one scan launch (`_launch_scan`): the
    SCAN_FIELDS device addresses, the dims and the scratch the launch
    holds until it runs.  K4 on its shared-memory route
    (`sweep_carry_fits`) allocates no scratch: its carry pointers are 0."""
    dev = flat.device
    if mesh is None:
        O, PT, W, reps = cat.O, cat.PT, cat.W, B
    else:
        O, PT, W = cat.O_s, cat.PT_s, cat.W_s
        reps = mesh.get("reps", mesh["S"])
    total = lay["total"][1]
    if P > MAX_POOLS:
        raise ValueError(f"{P} node pools: the kernels take at most "
                         f"{MAX_POOLS}")
    if D > MAX_DOMAINS:
        raise ValueError(f"{D} topology domains: the kernels take at most "
                         f"{MAX_DOMAINS}")
    vals: Dict[str, object] = dict(inputs)
    for f in ("col_alloc", "col_daemon", "pt_alloc", "col_pool",
              "pool_daemon", "pool_bits", "col_zone", "col_ct"):
        vals[f] = getattr(cat, f)
    vals["limits"] = limits_out
    row0 = flat.view(-1)   # problem 0's (block 0's) flat row
    vals.update(_region_ptrs(row0.data_ptr(), lay))
    keep: Tuple = ()
    if not (entry in SWEEP_ENTRIES and sweep_carry_fits(
            G, E, N, PT, cat.zc, P, D, W, sparse_k,
            heavy=entry == "ffd_sweep_topo_scan")):
        # per-block scratch (the scan's carry), one slice per problem (per
        # shard on the mesh, with its slot-maxima and counts scratch)
        n_x = 0 if mesh is None else reps * (N * cat.zc + 4 * G)
        scratch, keep = _carry_scratch(reps, G, E, N, W, P, sparse_k,
                                       0 if mesh is None else total, n_x,
                                       dev)
        vals.update(scratch)
    if mesh is not None:
        vals["mask_rows"] = mesh["mask_rows"]
        vals["row0"] = row0
    ptrs = [v if isinstance(v, int) else _ptr(v)
            for v in (vals.get(f) for f in SCAN_FIELDS)]
    dims = [G, E, N, O, PT, cat.zc, P, D, W, B, X, sparse_k, total, A,
            0 if mesh is None else mesh["C"],
            0 if mesh is None else mesh["S"]]
    return ptrs, dims, keep


def _launch_scan(entry: str, B: int, G: int, E: int, N: int, P: int,
                 D: int, X: int, cat, flat: torch.Tensor,
                 lay: Dict, limits_out: torch.Tensor, sparse_k: int,
                 inputs: Dict[str, Optional[torch.Tensor]],
                 A: int = 0, mesh: Optional[Dict] = None,
                 xcard: Optional[Tuple] = None):
    """Launch one of the scan kernels (grid: one block per problem) with
    the argument list every instance takes (ScanArgs order, `_scan_args`;
    the explain regions of `lay` among the outputs); `inputs` holds the
    per-problem or per-simulation tensors (and the seeded
    instance's seed, `A` its colmask rows), None where the instance reads
    nothing.  With `mesh` (K7: {"S", "C", "mask_rows"}) `cat` is a
    ShardedCatalog, the grid is one cluster of S blocks each holding a
    replica of the carry, the dims carry one shard's O, PT and W, and
    block 0 writes the flat row `flat` [total] and the budgets
    `limits_out` [P, R] (the other blocks keep theirs in the scratch).
    With `xcard` (K7x: (CardExchange, rank, rehearse, this card's copy of
    shard 0's grid-slot ids or None in the rehearsal)) the card exchange's
    addresses, the ids and the dims follow: one rank's launch alone
    (mesh["reps"] 1: `cat` rank r's one-shard view, `flat` its row; the
    solver launches every rank at once through `CardLaunch`) or the
    rehearsal's cooperative grid of S blocks (K7's layout)."""
    from karpenter_tpu_torch.solver import _cuda
    dev = flat.device
    ptrs, dims, scratch = _scan_args(entry, B, G, E, N, P, D, X, cat, flat,
                                     lay, limits_out, sparse_k, inputs, A,
                                     mesh)
    if xcard is not None:
        xch, rank, rehearse, slot_ids = xcard
        ptrs += xch.addresses() + [_ptr(slot_ids)]
        dims += [rank, rehearse, dev.index]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.launch(entry, ptrs, dims, stream)


def batch_scan(batch: FFDBatch, cat: FFDCatalog, N: int,
               flat: torch.Tensor, lay: Dict, limits_out: torch.Tensor,
               sparse_k: int = 0, with_gang: int = 0) -> None:
    """K5: the FFD scan of every problem of `batch` (the heavy step for
    groups with dsel > 0, the light step for the rest, and with
    `with_gang` the gang fill for gang groups), one flat row each in
    `flat` [B, total]: take_exist (or its sparse_k compaction), take_new,
    unsched, dom_placed, used, node_pool/zone/ct, num_active and, where
    the layout holds them, the priority witness (written in the steps),
    the explain counts and the explain=2 class map (the epilogue); the
    final pool budgets in
    `limits_out` [B, P, R].  CUDA tensors launch the kernel (its gang
    instance with `with_gang`); CPU tensors run `batch_scan_reference`."""
    dev = flat.device
    _check_problem(batch, cat, N, dev)
    _check_outputs(batch.B, batch.P, flat, lay, limits_out, sparse_k)
    _check_explain(lay, batch.G, cat.O, map_ok=True)
    _first_launch("ffd_batch_gang_scan" if with_gang else "ffd_batch_scan",
                  batch.B, batch.G, batch.E, N, batch.P, batch.D, cat.O,
                  sparse_k, "prio_inv" in lay, "explain_counts" in lay,
                  "explain_map" in lay)
    if dev.type != "cuda":
        batch_scan_reference(batch, cat, N, flat, lay, limits_out, sparse_k,
                             with_gang=with_gang)
        return
    inputs = {f.name: getattr(batch, f.name) for f in fields(batch)}
    if not with_gang:
        inputs.pop("group_gang")
    if "prio_inv" not in lay:
        inputs.pop("group_prio")
    _launch_scan("ffd_batch_gang_scan" if with_gang else "ffd_batch_scan",
                 batch.B, batch.G, batch.E, N, batch.P, batch.D, 0, cat,
                 flat, lay, limits_out, sparse_k, inputs)
    if with_gang:
        batch_scan.gang_launches += 1
    else:
        batch_scan.launches += 1
    if "prio_inv" in lay:
        batch_scan.witness_launches += 1
    _count_explain(batch_scan, lay)


batch_scan.launches = 0          # the gang-free instance
batch_scan.gang_launches = 0     # the gang instance
batch_scan.witness_launches = 0  # launches (either) with the witness
batch_scan.explain_launches = 0  # launches (either) with explain rows
batch_scan.map_launches = 0      # launches (either) with the explain=2 map


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


class SweepLaunch:
    """K4's launch path for one sweep: `_scan_args`' argument array built
    once for the sweep's snapshot `shared`, catalog `cat`, node slots `N`
    and `sparse_k` (the class tables, the existing rows, the prices, the
    catalog: the same in every chunk, checked once), and per chunk only
    its own rows, its outputs, B and, on the device-memory route, its
    carry scratch patched in before the call.  A lane (light or heavy, at
    one G, X, D, P and flat row) builds its array at its first chunk.
    The kernels, their checks (`scan_check`) and the launch counters are
    the wrappers' own (`sweep_scan`, `sweep_topo_scan`), which launch
    through the snapshot's plan (`of`)."""

    def __init__(self, shared: SweepShared, cat: FFDCatalog, N: int,
                 sparse_k: int = 0):
        # the snapshot holds its plan (`of`), the plan its snapshot weakly
        self._shared = weakref.ref(shared)
        self.cat, self.N, self.sparse_k = cat, N, sparse_k
        self._lanes: Dict[Tuple, Dict] = {}
        self._lock = threading.Lock()

    @property
    def shared(self) -> Optional[SweepShared]:
        return self._shared()

    @classmethod
    def of(cls, shared: SweepShared, cat: FFDCatalog, N: int,
           sparse_k: int = 0) -> "SweepLaunch":
        """The plan `shared` holds for (cat, N, sparse_k), else a new one
        that it holds from then on: a sweep builds it before its first
        chunk, and every chunk's wrapper call finds it."""
        plan = getattr(shared, "_k4_launch", None)
        if (plan is None or plan.shared is not shared or plan.cat is not cat
                or plan.N != N or plan.sparse_k != sparse_k):
            plan = cls(shared, cat, N, sparse_k)
            shared._k4_launch = plan
        return plan

    def _lane(self, sw: SweepBatch, flat: torch.Tensor, lay: Dict,
              limits_out: torch.Tensor) -> Dict:
        heavy = sw.heavy
        D = sw.D if heavy else 1
        smem = sweep_carry_fits(sw.G, sw.E, self.N, self.cat.PT,
                                self.cat.zc, sw.P, D, self.cat.W,
                                self.sparse_k, heavy)
        key = (heavy, sw.G, sw.X, D, sw.P, lay["total"][1], flat.device,
               smem)
        lane = self._lanes.get(key)
        if lane is not None:
            return lane
        _check_sweep_shared(self.shared, self.cat, sw.P, flat.device)
        entry = SWEEP_ENTRIES[heavy]
        ptrs, dims, _ = _scan_args(entry, sw.B, sw.G, sw.E, self.N, sw.P, D,
                                   sw.X, self.cat, flat, lay, limits_out,
                                   self.sparse_k, _sweep_inputs(sw))
        index = {f: i for i, f in enumerate(SCAN_FIELDS)}
        rows = SWEEP_ROWS + (SWEEP_TOPO_ROWS if heavy else ())
        lane = {
            "entry": entry, "smem": smem, "D": D,
            "ptrs": (ctypes.c_uint64 * len(ptrs))(*ptrs),
            "dims": (ctypes.c_int * len(dims))(*dims),
            "rows": tuple((index[n], n) for n in rows),
            "regions": tuple((index[f], 4 * lay[name][0])
                             for f, name in SCAN_REGIONS if name in lay),
            "limits": index["limits"],
            "carry": tuple((index[f], f) for f in CARRY_FIELDS)}
        self._lanes[key] = lane
        return lane

    def _patch(self, lane: Dict, sw: SweepBatch, flat: torch.Tensor,
               lay: Dict, limits_out: torch.Tensor) -> Tuple:
        """The chunk's rows, outputs and B into the lane's array; returns
        the scratch the launch holds (device-memory route)."""
        p = lane["ptrs"]
        for i, name in lane["rows"]:
            p[i] = getattr(sw, name).data_ptr()
        base = flat.data_ptr()
        for i, off in lane["regions"]:
            p[i] = base + off
        p[lane["limits"]] = limits_out.data_ptr()
        lane["dims"][9] = sw.B
        if lane["smem"]:
            return ()
        scratch, keep = _carry_scratch(sw.B, sw.G, sw.E, self.N,
                                       self.cat.W, sw.P, self.sparse_k, 0,
                                       0, flat.device)
        for i, f in lane["carry"]:
            p[i] = _ptr(scratch[f])
        return keep

    def args(self, sw: SweepBatch, flat: torch.Tensor, lay: Dict,
             limits_out: torch.Tensor) -> Tuple[List[int], List[int], Tuple]:
        """The chunk's argument array as the launch passes it: (ptrs,
        dims, the scratch it holds)."""
        with self._lock:
            lane = self._lane(sw, flat, lay, limits_out)
            keep = self._patch(lane, sw, flat, lay, limits_out)
            return list(lane["ptrs"]), list(lane["dims"]), keep

    def launch(self, sw: SweepBatch, flat: torch.Tensor, lay: Dict,
               limits_out: torch.Tensor) -> None:
        """Launch the chunk's lane on the current stream (CUDA tensors)."""
        from karpenter_tpu_torch.solver import _cuda
        dev = flat.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        with self._lock:
            lane = self._lane(sw, flat, lay, limits_out)
            fn = _cuda.kernel(lane["entry"])
            keep = self._patch(lane, sw, flat, lay, limits_out)
            rc = fn(lane["ptrs"], len(SCAN_FIELDS), lane["dims"], 16,
                    ctypes.c_void_p(stream))
        del keep  # the scratch's blocks return to the stream's pool
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {lane['entry']} failed: "
                + (f"argument check {rc}" if rc < 0 else f"cudaError {rc}"))


def _sweep_call(wrapper, heavy: bool, sw: SweepBatch, cat: FFDCatalog,
                N: int, flat: torch.Tensor, lay: Dict,
                limits_out: torch.Tensor, sparse_k: int) -> None:
    dev = flat.device
    if sw.heavy != heavy:
        raise ValueError("topology rows need the heavy lane "
                         "(sweep_topo_scan)" if sw.heavy else
                         "the heavy lane needs per-simulation topology "
                         "rows")
    _check_sweep_rows(sw, N, dev)
    _check_outputs(sw.B, sw.P, flat, lay, limits_out, sparse_k)
    entry = SWEEP_ENTRIES[heavy]
    _first_launch(entry, sw.B, sw.G, sw.E, N, sw.P,
                  *((sw.D,) if heavy else ()), sw.X, cat.O, sparse_k)
    if dev.type != "cuda":
        _check_sweep_shared(sw.shared, cat, sw.P, dev)
        plain = (sweep_topo_scan_reference if heavy
                 else sweep_scan_reference)
        plain(sw, cat, N, flat, lay, limits_out, sparse_k)
        return
    SweepLaunch.of(sw.shared, cat, N, sparse_k).launch(sw, flat, lay,
                                                        limits_out)
    wrapper.launches += 1


def sweep_scan(sw: SweepBatch, cat: FFDCatalog, N: int, flat: torch.Tensor,
               lay: Dict, limits_out: torch.Tensor,
               sparse_k: int = 0) -> None:
    """K4, light lane: the scan of every simulation of `sw` against the
    shared snapshot — its kept existing rows, its classes' column masks
    under its price cap — every group light; writes what `batch_scan`
    writes (dom_placed one zero column, node pins -1).  CUDA tensors
    launch the kernel through the snapshot's SweepLaunch, which checks
    the snapshot and the catalog once and each chunk's rows; CPU tensors
    run `sweep_scan_reference`."""
    _sweep_call(sweep_scan, False, sw, cat, N, flat, lay, limits_out,
                sparse_k)


sweep_scan.launches = 0


def sweep_topo_scan(sw: SweepBatch, cat: FFDCatalog, N: int,
                    flat: torch.Tensor, lay: Dict, limits_out: torch.Tensor,
                    sparse_k: int = 0) -> None:
    """K4, heavy lane: as `sweep_scan`, with each simulation's topology
    rows and the heavy step for its groups with dsel > 0.  CUDA tensors
    launch the kernel; CPU tensors run `sweep_topo_scan_reference`."""
    _sweep_call(sweep_topo_scan, True, sw, cat, N, flat, lay, limits_out,
                sparse_k)


sweep_topo_scan.launches = 0


def _check_seed(seed: DeltaSeed, cat: FFDCatalog, N: int, device) -> None:
    i32 = torch.int32
    _check(seed.seed_used, "seed_used", torch.float32, (N, R), device)
    _check(seed.seed_pool, "seed_pool", i32, (N,), device)
    _check(seed.seed_active, "seed_active", i32, (N,), device)
    _check(seed.seed_colmask, "seed_colmask", i32, (seed.A, cat.W), device)
    if seed.A > N:
        raise ValueError(f"{seed.A} seeded colmask rows past N={N}")


def delta_scan(prob: FFDProblem, seed: DeltaSeed, cat: FFDCatalog, N: int,
               flat: torch.Tensor, lay: Dict,
               limits_out: torch.Tensor) -> None:
    """K6: the seeded scan of one light-only problem (the delta suffix,
    or one chunk of the chunk chain) from `seed`, into its flat row `flat`
    [total] (dense take_exist, no witness, the explain counts where the
    layout holds them) and the final pool budgets `limits_out` [P, R].
    Built by `delta_tensors`, which refuses domain, gang and priority
    rows on the host; the kernel reads none of them.
    CUDA tensors launch the kernel; CPU tensors run
    `delta_scan_reference`."""
    dev = flat.device
    _check_problem(prob, cat, N, dev)
    _check_seed(seed, cat, N, dev)
    _check(flat, "flat", torch.float32, (lay["total"][1],), dev)
    _check(limits_out, "limits_out", torch.float32, (prob.P, R), dev)
    if "te_cnt" in lay or "prio_inv" in lay:
        raise ValueError("the seeded scan writes dense take_exist rows and "
                         "no priority witness")
    _check_explain(lay, prob.G, cat.O, map_ok=False)
    _first_launch("ffd_delta_scan", prob.G, prob.E, N, prob.P, prob.D,
                  seed.A, cat.O, "explain_counts" in lay)
    if dev.type != "cuda":
        if bool(prob.group_dsel.any()) or bool(prob.group_gang.any()):
            raise ValueError("the seeded scan is light-only and gang-free")
        delta_scan_reference(prob, seed, cat, N, flat, lay, limits_out)
        return
    inputs = {f.name: getattr(prob, f.name) for f in fields(prob)
              if f.name not in ("group_dsel", "group_dbase", "group_dcap",
                                "group_skew", "group_mindom", "group_delig",
                                "group_gang", "group_prio")}
    inputs.update({f.name: getattr(seed, f.name) for f in fields(seed)})
    _launch_scan("ffd_delta_scan", 1, prob.G, prob.E, N, prob.P, prob.D, 0,
                 cat, flat.view(1, -1), lay, limits_out.view(1, prob.P, R),
                 0, inputs, A=seed.A)
    delta_scan.launches += 1
    _count_explain(delta_scan, lay)


delta_scan.launches = 0
delta_scan.explain_launches = 0  # launches with the explain counts


def solve_ffd_batch(batch: FFDBatch, cat: FFDCatalog, max_nodes: int,
                    explain: int = 0, sparse_k: int = 0, with_gang: int = 0,
                    with_priority: int = 0) -> torch.Tensor:
    """The generic batched solve (`solve_ffd_batch`, ffd.py:1514): one K5
    launch over the batch (its gang instance with `with_gang`, the
    priority witness with `with_priority`), each problem's explain rows
    in its epilogue — explain=1 the counts, explain=2 also the [G, O]
    class map.  Returns the [B, total] f32 result rows on the batch's
    device (not synchronised)."""
    if explain not in (0, 1, 2):
        raise ValueError(f"explain={explain}: the scan computes the map "
                         "(2), counts (1) or nothing (0)")
    dev = batch.group_req.device
    N = max_nodes
    lay = flat_layout(batch.G, batch.E, N, batch.D, explain, sparse_k,
                      cat.O, with_priority)
    flat = torch.empty((batch.B, lay["total"][1]), dtype=torch.float32,
                       device=dev)
    limits = torch.empty((batch.B, batch.P, R), dtype=torch.float32,
                         device=dev)
    batch_scan(batch, cat, N, flat, lay, limits, sparse_k, with_gang)
    return flat


def solve_ffd(prob: FFDProblem, cat: FFDCatalog, max_nodes: int,
              explain: int = 0, with_gang: int = 0,
              with_priority: int = 0) -> torch.Tensor:
    """One solve: the batched scan at B=1, the explain rows in its
    epilogue.  Returns the flat f32 result buffer on the problem's device
    (not synchronised)."""
    return solve_ffd_batch(FFDBatch.of(prob), cat, max_nodes, explain,
                           with_gang=with_gang,
                           with_priority=with_priority)[0]


def solve_ffd_delta(prob: FFDProblem, seed: DeltaSeed, cat: FFDCatalog,
                    max_nodes: int, explain: int = 0) -> torch.Tensor:
    """The delta path's seeded solve (`solve_ffd_delta`, ffd.py:1443): one
    K6 launch from `seed`, with explain the counts in its epilogue (the
    delta pass clamps explain to counts: a suffix's [G, O] map would
    stitch against prefix rows that never had one).  Returns the flat f32
    result row on the problem's device (not synchronised)."""
    if explain not in (0, 1):
        raise ValueError(f"explain={explain}: the seeded solve computes "
                         "counts (1) or nothing (0)")
    dev = prob.group_req.device
    lay = flat_layout(prob.G, prob.E, max_nodes, prob.D, explain)
    flat = torch.empty(lay["total"][1], dtype=torch.float32, device=dev)
    limits = torch.empty((prob.P, R), dtype=torch.float32, device=dev)
    delta_scan(prob, seed, cat, max_nodes, flat, lay, limits)
    return flat


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


# -- the column-sharded scan (the mesh path) ---------------------------------
def sharded_group_masks(rows: torch.Tensor, table: torch.Tensor,
                        O_s: int) -> torch.Tensor:
    """The groups' [G, O] bool masks from their rows `rows` [G] of the
    resident mask table `table` [S, C, W_s]: each shard's gathered words
    unpacked to its O_s columns, the shards side by side."""
    r = rows.long()
    return torch.cat([_unpack_bits(table[k][r], O_s)
                      for k in range(table.shape[0])], dim=1)


def sharded_scan_reference(prob: FFDProblem, table: torch.Tensor,
                           cat: ShardedCatalog, N: int, flat: torch.Tensor,
                           lay: Dict, limits_out: torch.Tensor,
                           with_gang: int = 0,
                           seed: Optional[DeltaSeed] = None,
                           work: Optional[Dict[str, int]] = None) -> None:
    """Plain PyTorch version of K7: the reference's resident programs
    under `shard_map` (`_solve_ffd_resident_impl` ffd.py:1372, the seeded
    `_solve_ffd_delta_resident_impl` :1446), the column axes split into
    `cat.S` contiguous shards on whole (pool,type) blocks.  Each group's
    mask is gathered from its row of every shard of the mask table (`prob.
    mask_bits` holds the [G] row ids); the column work is elementwise per
    shard; every reduction over columns or blocks runs per shard and
    combines as the JAX program does — by max (`_axmax`/`_axany`, the
    [P, D] winner table), by shard 0's leading block (the grid-slot domain
    pattern), and, where the layout holds explain counts, by an integer
    sum of the per-shard counts with the slot class joining after it.
    With a `seed` ([S, A, W_s] column words) the seeded, light-only scan.
    Writes one flat row and the final pool budgets."""
    S = cat.S
    full = cat.full()
    gmask = sharded_group_masks(prob.mask_bits, table, cat.O_s)
    seed_cols = None
    if seed is not None:
        seed_cols = torch.cat([_unpack_bits(seed.seed_colmask[k], cat.O_s)
                               for k in range(S)], dim=1)
    _scan_reference(prob, full, N, flat, lay, limits_out, work,
                    topology=seed is None, with_gang=with_gang, seed=seed,
                    shards=S, gmask=gmask, seed_cols=seed_cols)
    if "explain_counts" in lay:
        pack_reference(prob, full, N, flat, lay, limits_out, with_gang,
                       shards=S, gmask=gmask)


def _check_sharded(prob: FFDProblem, table: torch.Tensor,
                   cat: ShardedCatalog, N: int, device,
                   seed: Optional[DeltaSeed]) -> None:
    G, P, D, S = prob.G, prob.P, prob.D, cat.S
    f32, i32 = torch.float32, torch.int32
    O_s, W_s, PT_s = cat.O_s, cat.W_s, cat.PT_s
    # the problem's mask_bits holds its [G] rows of the table
    checks = list(_problem_fields(prob, (G,))) + [
        ("mask table", table, i32, (S, table.shape[1], W_s)),
        ("col_alloc", cat.col_alloc, f32, (S, O_s, R)),
        ("col_daemon", cat.col_daemon, f32, (S, O_s, R)),
        ("pt_alloc", cat.pt_alloc, f32, (S, PT_s, R)),
        ("col_pool", cat.col_pool, i32, (S, O_s)),
        ("pool_daemon", cat.pool_daemon, f32, (P, R)),
        ("pool_bits", cat.pool_bits, i32, (S, P, W_s)),
        ("col_zone", cat.col_zone, i32, (S, O_s)),
        ("col_ct", cat.col_ct, i32, (S, O_s))]
    if seed is not None:
        checks += [("seed_used", seed.seed_used, f32, (N, R)),
                   ("seed_pool", seed.seed_pool, i32, (N,)),
                   ("seed_active", seed.seed_active, i32, (N,)),
                   ("seed_colmask", seed.seed_colmask, i32,
                    (S, seed.A, W_s))]
        if seed.A > N:
            raise ValueError(f"{seed.A} seeded colmask rows past N={N}")
    for name, t, dt, shp in checks:
        _check(t, name, dt, shp, device)
    if N < 1 or G < 1 or D < 1 or table.shape[1] < 1:
        raise ValueError(f"empty problem: G={G}, N={N}, D={D}")
    if P > MAX_POOLS or D > MAX_DOMAINS:
        raise ValueError(f"{P} pools / {D} domains: the kernels take at "
                         f"most {MAX_POOLS} / {MAX_DOMAINS}")
    if not 1 <= S <= MAX_SHARDS:
        raise ValueError(f"{S} shards: one cluster holds 1 to {MAX_SHARDS} "
                         f"blocks")


def _check_sharded_outputs(prob: FFDProblem, O: int, flat: torch.Tensor,
                           lay: Dict, limits_out: torch.Tensor,
                           with_gang: int, seed: Optional[DeltaSeed]) -> None:
    """The flat row and budgets of a column-sharded launch (K7, K7x), and
    what its instances refuse."""
    dev = flat.device
    _check(flat, "flat", torch.float32, (lay["total"][1],), dev)
    _check(limits_out, "limits_out", torch.float32, (prob.P, R), dev)
    if "te_cnt" in lay:
        raise ValueError("the sharded scan writes dense take_exist rows")
    _check_explain(lay, prob.G, O, map_ok=False)
    if seed is not None and ("prio_inv" in lay or with_gang):
        raise ValueError("the seeded scan is gang-free, with no witness")
    if dev.type != "cuda" and seed is not None and (
            bool(prob.group_dsel.any()) or bool(prob.group_gang.any())):
        raise ValueError("the seeded scan is light-only and gang-free")


def _sharded_launch_args(prob, table, cat, lay, with_gang, seed):
    """(entry, inputs, mesh, A) of one K7 launch."""
    inputs = {f.name: getattr(prob, f.name) for f in fields(prob)}
    inputs["mask_bits"] = table
    mesh = dict(S=cat.S, C=table.shape[1], mask_rows=prob.mask_bits)
    if seed is not None:
        for name in ("group_dsel", "group_dbase", "group_dcap", "group_skew",
                     "group_mindom", "group_delig", "group_gang",
                     "group_prio"):
            inputs.pop(name)
        inputs.update({f.name: getattr(seed, f.name) for f in fields(seed)})
        return "ffd_sharded_delta_scan", inputs, mesh, seed.A
    if not with_gang:
        inputs.pop("group_gang")
    if "prio_inv" not in lay:
        inputs.pop("group_prio")
    return (("ffd_sharded_gang_scan" if with_gang else "ffd_sharded_scan"),
            inputs, mesh, 0)


def sharded_scan(prob: FFDProblem, table: torch.Tensor, cat: ShardedCatalog,
                 N: int, flat: torch.Tensor, lay: Dict,
                 limits_out: torch.Tensor, with_gang: int = 0,
                 seed: Optional[DeltaSeed] = None) -> None:
    """K7: the column-sharded scan of one problem over `cat.S` shards —
    the heavy step for groups with dsel > 0, with `with_gang` the gang
    fill, with a `seed` the seeded light-only scan — and, where the layout
    holds them, the explain=1 counts (in its epilogue) and the priority
    witness, into the flat row `flat` [total] and the final pool budgets
    `limits_out` [P, R].  `prob.mask_bits` holds the groups' [G] rows of
    the resident mask table `table` [S, C, W_s].  CUDA tensors launch one
    cluster of S blocks (a cluster the card cannot hold raises); CPU
    tensors run `sharded_scan_reference`."""
    dev = flat.device
    _check_sharded(prob, table, cat, N, dev, seed)
    _check_sharded_outputs(prob, cat.O, flat, lay, limits_out, with_gang,
                           seed)
    _first_launch("ffd_sharded_scan", prob.G, prob.E, N, prob.P, prob.D,
                  cat.S, table.shape[1], with_gang,
                  None if seed is None else seed.A, "prio_inv" in lay,
                  "explain_counts" in lay)
    if dev.type != "cuda":
        sharded_scan_reference(prob, table, cat, N, flat, lay, limits_out,
                               with_gang, seed)
        return
    entry, inputs, mesh, A = _sharded_launch_args(prob, table, cat, lay,
                                                  with_gang, seed)
    _launch_scan(entry, 1, prob.G, prob.E, N, prob.P, prob.D, 0, cat, flat,
                 lay, limits_out, 0, inputs, A=A, mesh=mesh)
    if seed is not None:
        sharded_scan.delta_launches += 1
    elif with_gang:
        sharded_scan.gang_launches += 1
    else:
        sharded_scan.launches += 1
    _count_explain(sharded_scan, lay)


sharded_scan.launches = 0          # ffd_sharded_scan
sharded_scan.gang_launches = 0     # ffd_sharded_gang_scan
sharded_scan.delta_launches = 0    # ffd_sharded_delta_scan
sharded_scan.explain_launches = 0  # launches (any) with the explain counts


def sharded_clusters(prob: FFDProblem, table: torch.Tensor,
                     cat: ShardedCatalog, N: int, lay: Dict,
                     with_gang: int = 0,
                     seed: Optional[DeltaSeed] = None) -> int:
    """How many clusters of K7's launch for these arguments the card
    holds at once (cudaOccupancyMaxActiveClusters; 0 = the launch would be
    refused).  Launches nothing; CUDA tensors only."""
    from karpenter_tpu_torch.solver import _cuda
    variant = 2 if seed is not None else 1 if with_gang else 0
    dims = [prob.G, prob.E, N, cat.O_s, cat.PT_s, cat.zc, prob.P, prob.D,
            cat.W_s, 1, 0, 0, lay["total"][1],
            0 if seed is None else seed.A, table.shape[1], cat.S]
    rc = _cuda.kernel("ffd_sharded_occupancy")(
        None, 0, (ctypes.c_int * len(dims))(*dims), len(dims),
        ctypes.c_void_p(variant))
    if rc < 0:
        raise RuntimeError(f"ffd_sharded_occupancy failed: {rc}")
    return rc


def sharded_solve_ffd(prob: FFDProblem, table: torch.Tensor,
                      cat: ShardedCatalog, max_nodes: int, explain: int = 0,
                      with_gang: int = 0,
                      with_priority: int = 0) -> torch.Tensor:
    """The kernel-level entry of the column-sharded solve (the
    reference's `sharded_solve_ffd`, parallel/mesh.py:110, and the
    resident program `MeshExecutor.solve` runs): K7, the explain counts in
    its epilogue (explain is clamped to counts by the caller: the [G, O]
    map has no sharded form, ffd.py:374).  In the cards form (`cat` a
    CardCatalog, `prob` and `table` a rank's each) K7x.  Returns the flat
    f32 result row on the (first) device (not synchronised)."""
    if explain not in (0, 1):
        raise ValueError(f"explain={explain}: the sharded scan computes "
                         "counts (1) or nothing (0)")
    cards = isinstance(cat, CardCatalog)
    p0 = prob[0] if cards else prob
    dev = p0.group_req.device
    lay = flat_layout(p0.G, p0.E, max_nodes, p0.D, explain,
                      with_priority=with_priority)
    flat = torch.empty(lay["total"][1], dtype=torch.float32, device=dev)
    limits = torch.empty((p0.P, R), dtype=torch.float32, device=dev)
    scan = card_scan if cards else sharded_scan
    scan(prob, table, cat, max_nodes, flat, lay, limits, with_gang)
    return flat


def sharded_delta_ffd(prob: FFDProblem, seed: DeltaSeed, table: torch.Tensor,
                      cat: ShardedCatalog, max_nodes: int,
                      explain: int = 0) -> torch.Tensor:
    """The seeded column-sharded solve (`MeshExecutor.solve_delta`,
    parallel/mesh.py:265): K7's seeded instance from `seed`, whose column
    words arrive per shard ([S, A, W_s]), with explain clamped to counts.
    In the cards form (`cat` a CardCatalog, `prob`, `seed` and `table` a
    rank's each, each seed with its [A, W_s] words) K7x's seeded
    instance.  Returns the flat f32 result row (not synchronised)."""
    if explain not in (0, 1):
        raise ValueError(f"explain={explain}: the seeded solve computes "
                         "counts (1) or nothing (0)")
    cards = isinstance(cat, CardCatalog)
    p0 = prob[0] if cards else prob
    dev = p0.group_req.device
    lay = flat_layout(p0.G, p0.E, max_nodes, p0.D, explain)
    flat = torch.empty(lay["total"][1], dtype=torch.float32, device=dev)
    limits = torch.empty((p0.P, R), dtype=torch.float32, device=dev)
    if cards:
        card_scan(prob, table, cat, max_nodes, flat, lay, limits, seeds=seed)
    else:
        sharded_scan(prob, table, cat, max_nodes, flat, lay, limits,
                     seed=seed)
    return flat


# -- the column-sharded scan across cards (the mesh path on S cards) -------
# K7's entries and K7x's, instance for instance
_CARD_ENTRY = {"ffd_sharded_scan": "ffd_card_scan",
               "ffd_sharded_gang_scan": "ffd_card_gang_scan",
               "ffd_sharded_delta_scan": "ffd_card_delta_scan"}
# K7x's instances as `ffd_card_launch` numbers them
_CARD_INSTANCE = {"ffd_card_scan": 0, "ffd_card_gang_scan": 1,
                  "ffd_card_delta_scan": 2}
# a round count the host does not let pass (csrc ffd_xcard.cuh: the tags
# are 32 bits), read every CARD_CHECK_EVERY launches of an exchange (a
# launch makes far fewer than 2^21 rounds)
CARD_ROUND_LIMIT = 2 ** 31
CARD_CHECK_EVERY = 1024
# ffd_card_launch's arguments (csrc ffd_card_scan.cu): per rank its
# stream, event and replica, then card_entry's pointers (SCAN_FIELDS, the
# XMAXR inboxes, the slot ids) and dims (the scan's, rank, rehearse,
# device)
_CARD_HEAD_PTRS, _CARD_HEAD_DIMS = 2, 3
_CARD_RANK_PTRS = 3 + len(SCAN_FIELDS) + MAX_CARDS + 1
_CARD_NDIMS = 16 + 3


class CardExchange:
    """The card exchange of K7x (`csrc/ffd_xcard.cuh`) over `devices`:
    rank r's inbox on devices[r], [S, 2, XCH] tagged 64-bit words and then
    the rank's round count (zeroed here); the CUDA events that tie a
    launch's ranks together (`events`, made once, each on its card); the
    lock under which a launch is enqueued, so the ranks of two launches
    never interleave on the cards' streams.  On S distinct cards peer
    access is enabled for every ordered pair first; with one card S times
    it serves the rehearsal (the S blocks of one cooperative grid).
    Every CARD_CHECK_EVERY launches (`admit`) the host reads rank 0's round
    count, and past CARD_ROUND_LIMIT zeroes every inbox with every card
    idle (`rewind`), so no tag comes round."""

    def __init__(self, devices: Sequence):
        from karpenter_tpu_torch.solver import _cuda
        self.devices = tuple(torch.device(d) for d in devices)
        S = len(self.devices)
        if not 1 <= S <= MAX_CARDS:
            raise ValueError(f"{S} ranks: the card exchange takes 1 to "
                             f"{MAX_CARDS}")
        n_distinct = len(set(self.devices))
        if n_distinct not in (1, S):
            raise ValueError(f"ranks on {self.devices}: S distinct cards, "
                             f"or one card (the rehearsal)")
        self.cards = n_distinct == S > 1
        if self.cards:
            _cuda.launch("ffd_card_peer", [],
                         [d.index for d in self.devices], 0)
        self.inbox = [torch.zeros(S * 2 * XCH + 1, dtype=torch.int64,
                                  device=d) for d in self.devices]
        self._settle()
        self.launches = 0   # launches admitted
        self.rewinds = 0    # times every inbox was zeroed again
        self._events: Optional[Tuple[int, ...]] = None
        self.lock = threading.Lock()

    def _settle(self) -> None:
        # nothing orders one card's memset against another card's launch
        # that pushes into it: every card idle
        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def addresses(self) -> List[int]:
        """Every rank's inbox (0 past S)."""
        return ([t.data_ptr() for t in self.inbox]
                + [0] * (MAX_CARDS - len(self.devices)))

    def rounds(self) -> int:
        """Rank 0's round count: the exchange rounds since the inboxes
        were last zeroed (reads card 0 after what its stream holds)."""
        return int(self.inbox[0][-1].item())

    def rewind(self) -> None:
        """Every inbox and round count zeroed, with every card idle before
        (no rank of the exchange runs) and after (no launch starts before
        the zeroes land)."""
        self._settle()
        for t in self.inbox:
            t.zero_()
        self._settle()
        self.rewinds += 1

    def admit(self) -> None:
        """Count one launch (the caller holds `lock`); every
        CARD_CHECK_EVERY launches rewind past CARD_ROUND_LIMIT."""
        self.launches += 1
        if (self.launches % CARD_CHECK_EVERY == 0
                and self.rounds() >= CARD_ROUND_LIMIT):
            self.rewind()

    def events(self) -> Tuple[int, ...]:
        """The launch's events (cudaEvent_t handles): "ready" on card 0,
        then each rank's "done" on its card."""
        if self._events is None:
            from karpenter_tpu_torch.solver import _cuda
            devs = [self.devices[0].index] + [d.index for d in self.devices]
            out = (ctypes.c_uint64 * len(devs))()
            rc = _cuda.kernel("ffd_card_events")(
                out, len(devs), (ctypes.c_int * len(devs))(*devs),
                len(devs), None)
            if rc != 0:
                raise RuntimeError(f"ffd_card_events failed: cudaError {rc}")
            self._events = tuple(out)
        return self._events


# one exchange per set of cards in the process: two launches over the
# same cards must enqueue their ranks under one lock, or each card's
# stream could hold them in another order and every rank would wait on a
# peer queued behind the other launch
_EXCHANGES: Dict[Tuple[torch.device, ...], CardExchange] = {}
_EXCHANGES_LOCK = threading.Lock()


def card_exchange(devices: Sequence) -> CardExchange:
    """The process's card exchange over `devices` (made at first use)."""
    key = tuple(torch.device(d) for d in devices)
    with _EXCHANGES_LOCK:
        xch = _EXCHANGES.get(key)
        if xch is None:
            xch = _EXCHANGES[key] = CardExchange(key)
        return xch


def _rank_seed(seed: Optional[DeltaSeed],
               words: Optional[torch.Tensor] = None) -> Optional[DeltaSeed]:
    """A rank's seed as the one-shard form `_check_sharded` reads: its
    rows, and its own [A, W_s] words (`words`, else the seed's)."""
    if seed is None:
        return None
    w = seed.seed_colmask if words is None else words
    return DeltaSeed(seed.seed_used, seed.seed_pool, seed.seed_active,
                     w[None])


def _card_form(probs, seeds, S: int):
    """card_scan's arguments as (rank 0's problem, rank 0's seed or None,
    the ranks' seed words or None).  The problem: one a rank (each rank's
    replica) or card 0's alone; the seed likewise, one a rank with its own
    [A, W_s] words, or one whose `seed_colmask` is the ranks' words.  Only
    rank 0's rows are read: a launch copies them to every rank."""
    if isinstance(probs, FFDProblem):
        prob0 = probs
    elif len(probs) == S:
        prob0 = probs[0]
    else:
        raise ValueError(f"the cards form takes one problem, table and "
                         f"seed a rank ({S} ranks), or card 0's problem")
    if seeds is None:
        return prob0, None, None
    if isinstance(seeds, DeltaSeed):
        seed0, words = seeds, tuple(seeds.seed_colmask)
    else:
        seed0, words = seeds[0], tuple(s.seed_colmask for s in seeds)
    if len(words) != S:
        raise ValueError(f"the cards form takes one problem, table and "
                         f"seed a rank ({S} ranks)")
    return prob0, seed0, words


class CardLaunch:
    """K7x's launch path for one launch configuration (its statics, its
    CardCatalog, its cards): every rank's argument array and persistent
    scratch, built once — ranks past 0 their flat row, pool budgets and
    carry on their own cards and a replica of card 0's upload buffer of
    problem rows, rank 0 its carry — and per launch only rank 0's problem
    rows, its outputs, the upload's address, the mask tables, the seed's
    words and the streams patched in before one call into the kernel
    library (`ffd_card_launch`), which copies the upload to every replica
    and launches every rank (csrc ffd_card_scan.cu).  `card_scan` builds
    one when it is handed none and returns it; the executor holds one in
    each launch configuration (`MeshExecutor._launch`).  The plan keeps
    no buffer of the caller's: rank 0's rows and outputs are each
    launch's own."""

    def __init__(self, prob: FFDProblem, tables: Sequence[torch.Tensor],
                 cat: CardCatalog, N: int, lay: Dict, with_gang: int,
                 seed: Optional[DeltaSeed], words, flat: torch.Tensor,
                 limits_out: torch.Tensor):
        S, devs = cat.S, cat.devices
        self.cat, self.S, self.devices = cat, S, devs
        self.key = _card_key(prob, tables, N, lay, with_gang, seed)
        self.xch = card_exchange(devs)
        # the upload's rows: (ScanArgs field, "p" problem or "s" seed,
        # attribute), their offsets from the first byte, sizes and types
        src = [("mask_rows", "p", "mask_bits")] + [
            (f.name, "p", f.name) for f in fields(FFDProblem)
            if f.name != "mask_bits"]
        if seed is not None:
            src += [(n, "s", n) for n in ("seed_used", "seed_pool",
                                          "seed_active")]
        objs = {"p": prob, "s": seed}
        rows = [getattr(objs[k], a) for _, k, a in src]
        for t in rows:
            if not t.is_contiguous():
                raise ValueError("the problem rows are not contiguous")
        # an empty row has no address (data_ptr 0) and nothing to copy
        self._live = tuple(j for j, t in enumerate(rows) if t.numel())
        starts = [t.data_ptr() for t in rows]
        lo = min(starts[j] for j in self._live)
        offsets = [starts[j] - lo if j in self._live else 0
                   for j in range(len(rows))]
        self._offsets = tuple(offsets[j] for j in self._live)
        self._nbytes = max(offsets[j] + rows[j].numel()
                           * rows[j].element_size() for j in self._live)
        index = {f: i for i, f in enumerate(SCAN_FIELDS)}
        self._rows = tuple((index[f], k, a) for f, k, a in src)
        # each rank's problem: rank 0's the caller's (not kept), every
        # other one's in its replica of the upload; its outputs and carry
        self.problems, self.seeds, self.replicas = [None], [None], [None]
        self._keep = []
        head, dims = [0, 0], [S, 0, self._nbytes]
        for r in range(S):
            if r == 0:
                p_r, s_r, buf = prob, seed, None
                flat_r, lim_r = flat, limits_out
            else:
                buf = torch.empty(self._nbytes, dtype=torch.uint8,
                                  device=devs[r])
                views = {(k, a): buf[o:o + t.numel() * t.element_size()]
                         .view(t.dtype).view(t.shape)
                         for (_, k, a), o, t in zip(src, offsets, rows)}
                p_r = FFDProblem(**{f.name: views[("p", f.name)]
                                    for f in fields(FFDProblem)})
                s_r = None if seed is None else DeltaSeed(
                    views[("s", "seed_used")], views[("s", "seed_pool")],
                    views[("s", "seed_active")], None)
                flat_r = torch.empty(lay["total"][1], dtype=torch.float32,
                                     device=devs[r])
                lim_r = torch.empty((prob.P, R), dtype=torch.float32,
                                    device=devs[r])
            shard = cat.shard(r)
            entry, inputs, mesh, A = _sharded_launch_args(
                p_r, tables[r][None], shard, lay, with_gang,
                _rank_seed(s_r, None if words is None else words[r]))
            mesh.update(S=S, reps=1)
            ptrs, d, keep = _scan_args(entry, 1, prob.G, prob.E, N, prob.P,
                                       prob.D, 0, shard, flat_r, lay, lim_r,
                                       0, inputs, A, mesh)
            head += [0, 0, 0 if buf is None else buf.data_ptr()] + ptrs
            head += self.xch.addresses() + [cat.slot_ids[r].data_ptr()]
            dims += d + [r, 0, devs[r].index or 0]
            if r == 0:
                self._keep.append((keep,))
                # the rows the instance reads (its entry point refuses the
                # others: their pointers stay 0)
                self._patched = tuple(
                    (j, i) for j, (i, _, a) in enumerate(self._rows)
                    if a == "mask_bits" or inputs.get(a) is not None)
            else:
                self.problems.append(p_r)
                self.seeds.append(s_r)
                self.replicas.append(buf)
                self._keep.append((keep, flat_r, lim_r))
        self.entry = _CARD_ENTRY[entry]
        dims[1] = _CARD_INSTANCE[self.entry]
        assert len(head) == _CARD_HEAD_PTRS + S * _CARD_RANK_PTRS
        assert len(dims) == _CARD_HEAD_DIMS + S * _CARD_NDIMS
        self.ptrs = (ctypes.c_uint64 * len(head))(*head)
        self.dims = (ctypes.c_int * len(dims))(*dims)
        # what a launch patches besides its rows: rank 0's outputs, every
        # rank's table and seed words
        self._regions = tuple((index[f], 4 * lay[name][0])
                              for f, name in SCAN_REGIONS if name in lay)
        self._limits, self._row0 = index["limits"], index["row0"]
        self._table = index["mask_bits"]
        self._words = index["seed_colmask"] if seed is not None else None
        self._evented = False

    def rank_args(self, r: int) -> Tuple[List[int], List[int]]:
        """Rank r's argument array as the last launch passed it (card_entry's
        pointers and dims)."""
        p0 = _CARD_HEAD_PTRS + r * _CARD_RANK_PTRS + 3
        d0 = _CARD_HEAD_DIMS + r * _CARD_NDIMS
        return (list(self.ptrs[p0:p0 + _CARD_RANK_PTRS - 3]),
                list(self.dims[d0:d0 + _CARD_NDIMS]))

    def _patch(self, prob, seed, tables, words, flat, limits_out) -> None:
        p, S = self.ptrs, self.S
        objs = {"p": prob, "s": seed}
        starts = [getattr(objs[k], a).data_ptr() for _, k, a in self._rows]
        lo = min(starts[j] for j in self._live)
        if tuple(starts[j] - lo for j in self._live) != self._offsets:
            raise ValueError("the problem rows are not laid out as the "
                             "launch configuration's upload")
        b0 = _CARD_HEAD_PTRS + 3
        for j, i in self._patched:
            p[b0 + i] = starts[j]
        base = flat.data_ptr()
        for i, off in self._regions:
            p[b0 + i] = base + off
        p[b0 + self._limits] = limits_out.data_ptr()
        p[b0 + self._row0] = base
        p[0] = lo
        for r in range(S):
            br = _CARD_HEAD_PTRS + r * _CARD_RANK_PTRS
            p[br] = torch.cuda.current_stream(
                self.devices[r]).cuda_stream if flat.is_cuda else 0
            p[br + 3 + self._table] = tables[r].data_ptr()
            if self._words is not None:
                p[br + 3 + self._words] = words[r].data_ptr()

    def patch(self, prob, seed, tables, words, flat, limits_out) -> None:
        """The launch's rows, tables, words and rank 0's outputs into the
        arrays (under the exchange's lock), as `launch` does."""
        with self.xch.lock:
            self._patch(prob, seed, tables, words, flat, limits_out)

    def launch(self, prob, seed, tables, words, flat, limits_out) -> None:
        """One launch of every rank on the cards' current streams."""
        from karpenter_tpu_torch.solver import _cuda
        fn = _cuda.kernel("ffd_card_launch")
        with self.xch.lock:
            if not self._evented:
                ev = self.xch.events()
                self.ptrs[1] = ev[0]
                for r in range(self.S):
                    self.ptrs[_CARD_HEAD_PTRS + r * _CARD_RANK_PTRS + 1] = \
                        ev[1 + r]
                self._evented = True
            self.xch.admit()
            self._patch(prob, seed, tables, words, flat, limits_out)
            rc = fn(self.ptrs, len(self.ptrs), self.dims, len(self.dims),
                    None)
            card_scan.library_calls += 1
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.entry} across {self.S} cards failed: "
                + (f"argument check {rc}" if rc < 0 else f"cudaError {rc}"))


def _card_key(prob: FFDProblem, tables, N: int, lay: Dict, with_gang: int,
              seed: Optional[DeltaSeed]) -> tuple:
    """The statics a CardLaunch is built for."""
    return (prob.G, prob.E, prob.D, prob.P, N, tables[0].shape[0],
            with_gang, None if seed is None else seed.A, tuple(lay.items()))


def card_scan(probs, tables: Sequence[torch.Tensor], cat: CardCatalog,
              N: int, flat: torch.Tensor, lay: Dict,
              limits_out: torch.Tensor, with_gang: int = 0,
              seeds=None, plan: Optional[CardLaunch] = None
              ) -> Optional[CardLaunch]:
    """K7x: the column-sharded scan of one problem over the S cards of
    `cat`, rank r on card r — the problem's rows (mask_bits the groups'
    [G] rows of the mask tables), its mask table tables[r] [C, W_s], its
    shard of the catalog and, seeded, the seed's rows and its own [A, W_s]
    column words — each reduction across the ranks an exchange between
    their kernels over NVLink.  `probs` is card 0's problem, or one a rank
    (`_card_form`; `seeds` likewise); the launch copies rank 0's rows to
    every rank.  The same function as K7 (`sharded_scan`) on the same
    shards: rank 0 writes the flat row `flat` [total] and the budgets
    `limits_out` [P, R] on card 0.  CUDA tensors launch one block on each
    card through one call into the kernel library (`CardLaunch`: `plan`,
    one built for this launch's statics and catalog, else a new one),
    one launch counted, and return the plan; CPU tensors run the plain
    version, `sharded_scan_reference`, on the shards stacked."""
    S, devs = cat.S, cat.devices
    if not 1 <= S <= MAX_CARDS:
        raise ValueError(f"{S} cards: K7x takes 1 to {MAX_CARDS}")
    p0, seed0, words = _card_form(probs, seeds, S)
    if len(tables) != S:
        raise ValueError(f"the cards form takes one problem, table and "
                         f"seed a rank ({S} ranks)")
    dev = flat.device
    if dev != devs[0]:
        raise ValueError(f"the flat row is rank 0's, on {devs[0]}, not "
                         f"{dev}")
    _check_sharded(p0, tables[0][None], cat.shard(0), N, devs[0],
                   _rank_seed(seed0, None if words is None else words[0]))
    for r in range(1, S):
        _check(tables[r], f"mask table {r}", torch.int32,
               tables[0].shape, devs[r])
        if words is not None:
            _check(words[r], f"seed_colmask {r}", torch.int32,
                   words[0].shape, devs[r])
    _check_sharded_outputs(p0, cat.O, flat, lay, limits_out, with_gang,
                           seed0)
    if plan is not None and (plan.cat is not cat or plan.key != _card_key(
            p0, tables, N, lay, with_gang, seed0)):
        raise ValueError("the plan was built for another launch "
                         "configuration or catalog")
    _first_launch("ffd_card_scan", p0.G, p0.E, N, p0.P, p0.D, S,
                  tables[0].shape[0], with_gang,
                  None if seed0 is None else seed0.A, "prio_inv" in lay,
                  "explain_counts" in lay)
    if dev.type != "cuda":
        seed = None if seed0 is None else DeltaSeed(
            seed0.seed_used, seed0.seed_pool, seed0.seed_active,
            torch.stack([w.to(dev) for w in words]))
        sharded_scan_reference(p0, torch.stack([t.to(dev) for t in tables]),
                               cat.stacked(dev), N, flat, lay, limits_out,
                               with_gang, seed)
        return None
    if len(set(devs)) != S:
        raise ValueError(f"K7x runs one rank a card: {devs} repeats a card "
                         f"(one card's S blocks: card_scan_rehearsal)")
    if plan is None:
        plan = CardLaunch(p0, tables, cat, N, lay, with_gang, seed0, words,
                          flat, limits_out)
    plan.launch(p0, seed0, tables, words, flat, limits_out)
    if seed0 is not None:
        card_scan.delta_launches += 1
    elif with_gang:
        card_scan.gang_launches += 1
    else:
        card_scan.launches += 1
    _count_explain(card_scan, lay)
    return plan


card_scan.launches = 0          # ffd_card_scan
card_scan.gang_launches = 0     # ffd_card_gang_scan
card_scan.delta_launches = 0    # ffd_card_delta_scan
card_scan.explain_launches = 0  # launches (any) with the explain counts
card_scan.library_calls = 0     # calls into the kernel library (one a launch)


def card_scan_rehearsal(prob: FFDProblem, table: torch.Tensor,
                        cat: ShardedCatalog, N: int, flat: torch.Tensor,
                        lay: Dict, limits_out: torch.Tensor,
                        with_gang: int = 0,
                        seed: Optional[DeltaSeed] = None) -> None:
    """K7x rehearsed on one card: the same instances launched as ONE
    cooperative grid of S blocks (cudaLaunchCooperativeKernel: all
    resident, or refused), block r rank r, every rank's inbox in that
    card's memory, on K7's stacked arguments (`sharded_scan`'s), the same
    exchange protocol.  A check of the exchange code where only one card
    exists; the solver never takes it.  CPU tensors run
    `sharded_scan_reference`."""
    dev = flat.device
    _check_sharded(prob, table, cat, N, dev, seed)
    if cat.S > MAX_CARDS:
        raise ValueError(f"{cat.S} ranks: K7x takes 1 to {MAX_CARDS}")
    _check_sharded_outputs(prob, cat.O, flat, lay, limits_out, with_gang,
                           seed)
    if dev.type != "cuda":
        sharded_scan_reference(prob, table, cat, N, flat, lay, limits_out,
                               with_gang, seed)
        return
    xch = card_exchange((dev,) * cat.S)
    entry, inputs, mesh, A = _sharded_launch_args(prob, table, cat, lay,
                                                  with_gang, seed)
    with xch.lock, torch.cuda.device(dev):
        xch.admit()
        _launch_scan(_CARD_ENTRY[entry], 1, prob.G, prob.E, N, prob.P,
                     prob.D, 0, cat, flat, lay, limits_out, 0, inputs, A=A,
                     mesh=mesh, xcard=(xch, 0, 1, None))
        card_scan_rehearsal.library_calls += 1
    card_scan_rehearsal.launches += 1


card_scan_rehearsal.launches = 0
card_scan_rehearsal.library_calls = 0


def card_blocks(probs, tables: Sequence[torch.Tensor], cat: CardCatalog,
                N: int, lay: Dict, with_gang: int = 0, seeds=None
                ) -> Tuple[int, ...]:
    """How many blocks of K7x's rank launch each card holds at once (0 =
    a rank's block does not fit and its launch would be refused); `probs`
    and `seeds` as `card_scan` takes them.  Launches nothing; CUDA
    tensors only."""
    from karpenter_tpu_torch.solver import _cuda
    p, seed0, _ = _card_form(probs, seeds, cat.S)
    variant = 2 if seed0 is not None else 1 if with_gang else 0
    dims = [p.G, p.E, N, cat.O_s, cat.PT_s, cat.zc, p.P, p.D, cat.W_s, 1,
            0, 0, lay["total"][1], 0 if seed0 is None else seed0.A,
            tables[0].shape[0], cat.S]
    out = []
    for d in cat.devices:
        dd = dims + [d.index]
        with torch.cuda.device(d):
            rc = _cuda.kernel("ffd_card_occupancy")(
                None, 0, (ctypes.c_int * len(dd))(*dd), len(dd),
                ctypes.c_void_p(variant))
        if rc < 0:
            raise RuntimeError(f"ffd_card_occupancy on {d} failed: {rc}")
        out.append(rc)
    return tuple(out)


def unpack(packed, G: int, E: int, N: int, RDIM: int, D: int,
           sparse_k: int = 0, explain: int = 0, explain_o: int = 0,
           with_priority: int = 0) -> Dict:
    """Split one flat result row into named host arrays (ffd.py:1677,
    dense take_new rows).  With sparse_k the dense [G, E] take_exist rows
    are rebuilt from the (count, index) pairs; empty slots (count 0) are
    skipped, so a pad slot's index 0 never clears a real entry.  explain=2
    adds `explain_map` [G, explain_o] int8, `with_priority` the witness
    `prio_inv` [G] bool."""
    flat = np.asarray(packed)
    if not flat.flags.writeable:
        flat = np.array(flat)
    lay = flat_layout(G, E, N, D, explain, sparse_k, explain_o,
                      with_priority)
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
    if explain >= 2:
        out["explain_map"] = reg("explain_map").reshape(
            G, explain_o).astype(np.int8)
    if with_priority:
        out["prio_inv"] = reg("prio_inv") > 0.5
    return out


# every launch count by kernel instance (or the epilogue pass a launch
# carried): the wrapper attributes that hold it
LAUNCH_COUNTS = {
    "ffd_batch_scan": (("batch_scan", "launches"),),
    "ffd_batch_gang_scan": (("batch_scan", "gang_launches"),),
    "ffd_sweep_scan": (("sweep_scan", "launches"),),
    "ffd_sweep_topo_scan": (("sweep_topo_scan", "launches"),),
    "ffd_delta_scan": (("delta_scan", "launches"),),
    "ffd_sharded_scan": (("sharded_scan", "launches"),),
    "ffd_sharded_gang_scan": (("sharded_scan", "gang_launches"),),
    "ffd_sharded_delta_scan": (("sharded_scan", "delta_launches"),),
    "ffd_card_scan": (("card_scan", "launches"),),
    "ffd_card_gang_scan": (("card_scan", "gang_launches"),),
    "ffd_card_delta_scan": (("card_scan", "delta_launches"),),
    "priority_witness": (("batch_scan", "witness_launches"),),
    "explain_pack": tuple((w, "explain_launches") for w in (
        "batch_scan", "delta_scan", "sharded_scan", "card_scan")),
    "explain_map": (("batch_scan", "map_launches"),),
}


def launch_counts() -> Dict[str, int]:
    """The wrappers' launch counts by kernel instance (or epilogue pass),
    since the process started or a caller last set them to 0."""
    g = globals()
    return {k: sum(getattr(g[w], attr) for w, attr in pairs)
            for k, pairs in LAUNCH_COUNTS.items()}
