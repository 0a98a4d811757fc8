"""The scans' per-node column walk (`karpenter_tpu_torch/csrc/ffd_walk.cuh`)
against the plain version's per-node fit and narrowing, on the CPU.

The walk's per-word arithmetic is `__host__ __device__`: g++ builds it
here (`-ffp-contract=off`, IEEE float32 without contraction) into a small
shim whose entry points replay the kernel's tile functions
(`ffd_scan_common.cuh` tile_best, tile_slotmax, tile_narrow, tile_open)
with 1, 2, 8 and 32 lanes a node, each lane taking its share of the
chunks the row's chunk summary marks, the capacity walk stopping once a
lane reaches the per-node cap.  The expected values are computed as
`solver/ffd.py` `_Scan` computes them (`_fit_count` over every block,
`any` over a block's surviving admitted columns, the max; the per-slot
max of the heavy step; `_pt_expand(_fits(...))` for the narrowing), on
seeded words, `used` rows and requests, with ZC in {1, 2, 3, 5, 6, 12}
(blocks that straddle words for 3, 5, 6 and 12; five-word chunks for 5),
a domain's grid slots as a filter, per-node caps that stop the walk
early, and summaries that are exact or mark every chunk.  Integers and
uint32 words must be equal, and the summary a narrowing leaves must be
the narrowed row's own.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver import ffd

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "karpenter_tpu_torch", "csrc")

SHIM = r"""
#include "ffd_walk.cuh"

// the tile functions of ffd_scan_common.cuh (tile_best, tile_slotmax,
// tile_narrow, tile_open), the L lanes of a tile one after another, over
// the row's chunk summary: exact (every chunk that holds a bit), or with
// `full` every chunk marked
static int nsum(int W, int ZC) { return summary_words(W, ZC); }

static uint32_t had(const uint32_t* row, int sw, int W, int ZC, int full) {
  if (!full) return summary_word(row, sw, W, ZC);
  const int left = row_chunks(W, ZC) - sw * 32;
  return left >= 32 ? 0xffffffffu : (1u << left) - 1u;
}

// the chunks the group mask reaches (the kernel's s.gsum)
static uint32_t reach(const uint32_t* gm, int sw, int W, int ZC) {
  return summary_word(gm, sw, W, ZC);
}

extern "C" int kt_best(const uint32_t* row, const uint32_t* gm, int W,
                       int ZC, uint64_t slots, const float* pt,
                       const float* u, const float* req, int ncap, int L,
                       int full) {
  int best[32] = {0};
  for (int sw = 0; sw < nsum(W, ZC); ++sw) {
    bool any = false;
    for (int t = 0; t < L; ++t) {
      best[t] = lane_best(row, gm, had(row, sw, W, ZC, full) & reach(gm, sw,
                          W, ZC), sw, t, L, W, ZC, slots, pt, u, req, best[t]);
      any = any || best[t] >= ncap;
    }
    if (any) return ncap;
  }
  int m = 0;
  for (int t = 0; t < L; ++t) m = best[t] > m ? best[t] : m;
  return m < ncap ? m : ncap;
}

extern "C" void kt_slotmax(const uint32_t* row, const uint32_t* gm, int W,
                           int ZC, const float* pt, const float* u,
                           const float* req, int* slotmax, int L, int full) {
  int lanes[32][64] = {{0}};
  for (int sw = 0; sw < nsum(W, ZC); ++sw)
    for (int t = 0; t < L; ++t)
      lane_slotmax(row, gm, had(row, sw, W, ZC, full) & reach(gm, sw, W, ZC),
                   sw, t, L, W, ZC, pt, u, req, lanes[t]);
  for (int z = 0; z < ZC; ++z) {
    slotmax[z] = 0;
    for (int t = 0; t < L; ++t)
      slotmax[z] = lanes[t][z] > slotmax[z] ? lanes[t][z] : slotmax[z];
  }
}

// a touched row in place; sum receives its new summary
extern "C" void kt_narrow(uint32_t* row, const uint32_t* gm, int W, int ZC,
                          uint64_t slots, const float* pt, const float* u,
                          int L, int full, uint32_t* sum) {
  for (int sw = 0; sw < nsum(W, ZC); ++sw) {
    const uint32_t h = had(row, sw, W, ZC, full);
    uint32_t emptied = 0u;
    for (int t = 0; t < L; ++t)
      emptied |= lane_narrow(row, gm, h, sw, t, L, W, ZC, slots, pt, u);
    sum[sw] = h & ~emptied;
  }
}

// an opened row from a & b; sum receives its summary
extern "C" void kt_open(uint32_t* row, const uint32_t* a, const uint32_t* b,
                        int W, int ZC, uint64_t slots, const float* pt,
                        const float* u, int L, uint32_t* sum) {
  for (int sw = 0; sw < nsum(W, ZC); ++sw) {
    uint32_t held = 0u;
    for (int t = 0; t < L; ++t)
      held |= lane_open(row, a, b, reach(b, sw, W, ZC), sw, t, L, W, ZC,
                        slots, pt, u);
    sum[sw] = held;
  }
}

extern "C" int kt_chunk_words(int ZC) { return chunk_words(ZC); }
"""

ALL_SLOTS = (1 << 64) - 1
BIG = 536870912   # encode.BIG: no per-node cap


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """The g++ shim of ffd_walk.cuh, loaded with ctypes."""
    import ctypes
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host shim of ffd_walk.cuh "
                    "cannot be built")
    d = tmp_path_factory.mktemp("walk")
    src, lib = d / "walk_shim.cpp", d / "libwalk_shim.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    I = ctypes.c_int
    U = ctypes.c_uint64
    so.kt_best.argtypes = [P, P, I, I, U, P, P, P, I, I, I]
    so.kt_best.restype = I
    so.kt_slotmax.argtypes = [P, P, I, I, P, P, P, P, I, I]
    so.kt_narrow.argtypes = [P, P, I, I, U, P, P, I, I, P]
    so.kt_open.argtypes = [P, P, P, I, I, U, P, P, I, P]
    so.kt_chunk_words.argtypes = [ctypes.c_int]
    so.kt_chunk_words.restype = ctypes.c_int
    return so


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _case(zc: int, seed: int):
    """One node against a seeded catalog: (pt_alloc [PT, R], used [R],
    req [R], row words [W], gm words [W], other words [W], zcdom [ZC],
    PT).  Allocatable and requests are multiples of 1/4 so that many
    blocks sit exactly on a fit boundary; used leaves some blocks
    negative (no fit) and some exactly full."""
    rng = np.random.default_rng(1000 * zc + seed)
    R = ffd.R
    PT = int(rng.integers(40, 120))
    if zc == 1:
        PT = max(PT, 96)
    O = PT * zc
    pt_alloc = (rng.integers(0, 64, size=(PT, R)) / 4.0).astype(np.float32)
    req = (rng.integers(1, 12, size=R) / 4.0).astype(np.float32)
    req[rng.random(R) < 0.4] = 0.0
    req[0] = max(req[0], np.float32(0.25))
    used = (rng.integers(0, 48, size=R) / 4.0).astype(np.float32)
    dens = [0.02, 0.2, 0.6, 1.0][seed % 4]
    row = rng.random(O) < dens
    gm = rng.random(O) < 0.7
    other = rng.random(O) < 0.8
    zcdom = rng.integers(0, 3, size=zc).astype(np.int32)

    def words(m):
        return ffd.pack_mask_bits(m, O).view(np.uint32).copy()

    return (pt_alloc, used, req, words(row), words(gm), words(other),
            row, gm, other, zcdom, PT, O)


def _plain_fit(pt_alloc, used, req):
    """`_Scan`'s per-block fit of `req` in the block's allocatable less
    the node's used: [PT] int32."""
    return ffd._fit_count(torch.from_numpy(pt_alloc)[None]
                          - torch.from_numpy(used)[None, None],
                          torch.from_numpy(req))[0]


def _slots_of(zcdom, d):
    return sum(1 << z for z in range(len(zcdom)) if zcdom[z] == d)


ZCS = [1, 2, 3, 5, 6, 12]
SEEDS = [0, 1, 2, 3]
TILES = (1, 2, 8, 32)   # lanes per node


@pytest.mark.parametrize("zc", ZCS)
def test_chunk_holds_whole_blocks(walk, zc):
    """A chunk is lcm(ZC, 32) columns: whole words and whole blocks."""
    cw = walk.kt_chunk_words(zc)
    assert (32 * cw) % zc == 0
    assert 32 * cw == np.lcm(zc, 32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("zc", ZCS)
def test_best_matches_plain(walk, zc, seed):
    """The light step's in-flight capacity (ffd.py:476-490 as `_Scan.light`
    computes it), uncapped, capped and stopping early, and the gang
    step's domain-restricted one (`_Scan.gang`), for every domain."""
    (pt_alloc, used, req, row_w, gm_w, _, row, gm, _, zcdom, PT,
     O) = _case(zc, seed)
    W = row_w.shape[0]
    cap_pt = _plain_fit(pt_alloc, used, req)
    col_dom = np.tile(zcdom, PT)
    for d in (None, 0, 1, 2):
        cols = row & gm
        slots = ALL_SLOTS
        if d is not None:
            cols = cols & (col_dom == d)
            slots = _slots_of(zcdom, d)
        elig = torch.from_numpy(cols).view(PT, zc).any(dim=-1)
        best = int(torch.where(elig, cap_pt, 0).max())
        for ncap in (BIG, 1, 2, max(best, 1), best + 1):
            for L in TILES:
                for full in (0, 1):
                    got = walk.kt_best(_ptr(row_w), _ptr(gm_w), W, zc, slots,
                                       _ptr(pt_alloc), _ptr(used), _ptr(req),
                                       ncap, L, full)
                    assert got == min(best, ncap), (d, ncap, L, full, got)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("zc", ZCS)
def test_slotmax_matches_plain(walk, zc, seed):
    """The heavy step's per-grid-slot maxima (ffd.py:625-632 as
    `_Scan.heavy` computes them: where(colmask & gmask, pt_expand(fit),
    0), the max over blocks per slot)."""
    (pt_alloc, used, req, row_w, gm_w, _, row, gm, _, _, PT,
     O) = _case(zc, seed)
    W = row_w.shape[0]
    cap_pt = _plain_fit(pt_alloc, used, req)
    cap_no = torch.where(torch.from_numpy(row & gm)[None],
                         ffd._pt_expand(cap_pt[None], zc), 0)
    want = cap_no.view(PT, zc).amax(dim=0).numpy().astype(np.int32)
    for L in TILES:
        for full in (0, 1):
            got = np.full(zc, -7, np.int32)
            walk.kt_slotmax(_ptr(row_w), _ptr(gm_w), W, zc, _ptr(pt_alloc),
                            _ptr(used), _ptr(req), _ptr(got), L, full)
            np.testing.assert_array_equal(got, want)


def _summary(words: np.ndarray, zc: int) -> np.ndarray:
    """The row's chunk summary as the plain version sees it: bit c % 32 of
    word c // 32 set when chunk c (lcm(zc, 32) columns) holds a bit."""
    cw = int(np.lcm(zc, 32)) // 32
    W = words.shape[0]
    nch = -(-W // cw)
    held = [bool(words[c * cw:(c + 1) * cw].any()) for c in range(nch)]
    out = np.zeros(-(-nch // 32), np.uint32)
    for c, h in enumerate(held):
        if h:
            out[c // 32] |= np.uint32(1 << (c % 32))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("zc", ZCS)
def test_narrow_matches_plain(walk, zc, seed):
    """The colmask narrowing (`_Scan`'s colmask & gmask [& the domain's
    columns] & pt_expand(_fits(pt_alloc - used))), for a touched node
    (narrowed in place, from an exact summary and from one that marks
    every chunk) and an opened one (feasible columns & the pool's), with
    and without a domain's grid slots; the summary each leaves is the
    narrowed row's own."""
    (pt_alloc, used, req, row_w, gm_w, other_w, row, gm, other, zcdom, PT,
     O) = _case(zc, seed)
    W = row_w.shape[0]
    ok_pt = ffd._fits(torch.from_numpy(pt_alloc)[None]
                      - torch.from_numpy(used)[None, None])
    ok_cols = ffd._pt_expand(ok_pt, zc)[0].numpy()
    col_dom = np.tile(zcdom, PT)
    for d in (None, 0, 1, 2):
        dcols = np.ones(O, bool) if d is None else col_dom == d
        slots = ALL_SLOTS if d is None else _slots_of(zcdom, d)
        for L in TILES:
            want = ffd.pack_mask_bits(row & gm & dcols & ok_cols, O).view(
                np.uint32)
            for full in (0, 1):
                out = row_w.copy()
                summ = np.zeros_like(_summary(out, zc))
                walk.kt_narrow(_ptr(out), _ptr(gm_w), W, zc, slots,
                               _ptr(pt_alloc), _ptr(used), L, full,
                               _ptr(summ))
                np.testing.assert_array_equal(out, want)
                np.testing.assert_array_equal(summ, _summary(want, zc))
            want = ffd.pack_mask_bits(other & gm & dcols & ok_cols, O).view(
                np.uint32)
            out = np.full_like(row_w, 0xA5A5A5A5)
            summ = np.zeros_like(_summary(out, zc))
            walk.kt_open(_ptr(out), _ptr(other_w), _ptr(gm_w), W, zc, slots,
                         _ptr(pt_alloc), _ptr(used), L, _ptr(summ))
            np.testing.assert_array_equal(out, want)
            np.testing.assert_array_equal(summ, _summary(want, zc))
