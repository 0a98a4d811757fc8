// The per-element arithmetic of the FFD scans' per-node column walk, for
// the device and for a host shim built with g++ -ffp-contract=off
// (tests/test_torch_walk.py).
//
// A node's surviving columns are u32 bit-words: bit o % 32 of word o / 32
// is offering column o, and column o belongs to (pool,type) block
// pt = o / ZC, grid slot z = o % ZC.  A block's ZC bits sit in at most two
// adjacent words.  The walk visits each block that holds a bit once per
// word (the lowest set bit names the block, then the block's bits are
// cleared in one operation) and evaluates the block's fit once: a memo of
// the last block carries its verdict into the next word, so a block that
// straddles two words of one chunk is evaluated once.  A chunk is
// lcm(ZC, 32) columns, `chunk_words(ZC)` words, and holds whole blocks.
// A row's chunk summary (one bit a chunk, `summary_words` u32 words) marks
// the chunks that may hold a bit; the L lanes of a node's tile take the
// marked chunks in turn, each its share of every summary word
// (`lane_share`), so the lanes walk side by side (ffd_scan_common.cuh
// tile_best / tile_slotmax / tile_narrow / tile_open).
//
// Three results, one per chunk function:
//   * chunk_best: the best fit_count of `req` in a block's allocatable
//     less the node's `used`, over blocks with a bit in `row & gm` (in the
//     grid slots `slots`) — the light and gang steps' in-flight capacity
//     (ffd.py:485-490, :884-894);
//   * chunk_slotmax: per grid slot, the max of that fit over the blocks
//     whose bit in that slot survives — the heavy step's slot maxima
//     (ffd.py:617-632);
//   * chunk_narrow: `src_a & src_b` restricted to the slots `slots`, with
//     every block whose allocatable no longer holds `used` cleared — the
//     colmask narrowing of touched and opened nodes (pt_expand(ok_pt),
//     ffd.py:507-510, :565-568, :730-732, :792-795, :995-998, :1012-1015).
//
// Float parity: every float operation is the reference's, rounded to
// nearest (the intrinsics on the device; plain IEEE single operations on
// the host without contraction); max is exact in any order.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define KT_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define KT_HD inline
#endif

// the resource axis (karpenter_tpu_torch/models/resources.py RESOURCE_AXIS)
#define KR 6
// the fit-slack epsilon (solver/explain.py EPS) as float32
#define KEPS 1e-3f

KT_HD float kt_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

KT_HD float kt_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

KT_HD float kt_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// index of the lowest set bit of m != 0
KT_HD int kt_ctz(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// _fit_count (ffd.py:116): how many pods of request `req` fit in `avail`:
// floor((avail + EPS) / req) per resource with req > 0, the minimum over
// resources, clipped to [0, 2^30] BEFORE the integer conversion (pool
// limits are +inf for unlimited pools, and converting inf is undefined).
KT_HD int fit_count(const float* avail, const float* req) {
  float c = 1073741824.0f;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    if (req[r] > 0.0f) {
      const float v = floorf(kt_div(kt_add(avail[r], KEPS), req[r]));
      c = fminf(c, v);
    }
  }
  c = fminf(fmaxf(c, 0.0f), 1073741824.0f);
  return (int)c;
}

// all(a - b - c >= -EPS) over the resource axis, evaluated left to right
KT_HD bool all_fits3(const float* a, const float* b, const float* c) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < KR; ++r)
    ok = ok && (kt_sub(kt_sub(a[r], b[r]), c[r]) >= -KEPS);
  return ok;
}

// all(a - b >= -EPS) over the resource axis
KT_HD bool all_fits2(const float* a, const float* b) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < KR; ++r)
    ok = ok && (kt_sub(a[r], b[r]) >= -KEPS);
  return ok;
}

// the fit of `req` in block allocatable `pt` (one [R] row) less `u`
KT_HD int fit_left(const float* pt, const float* u, const float* req) {
  float av[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) av[r] = kt_sub(pt[r], u[r]);
  return fit_count(av, req);
}

// words per chunk: lcm(ZC, 32) / 32, so that a chunk holds whole blocks
KT_HD int chunk_words(int ZC) {
  const int pow2 = ZC & -ZC;  // the largest power of two dividing ZC
  return ZC / (pow2 < 32 ? pow2 : 32);
}

// the bits of word w that hold columns of block pt; lo < 0 when the block
// began in the word before, hi > 32 when it ends in the word after
KT_HD uint32_t block_bits(int w, int pt, int ZC) {
  const int lo = pt * ZC - 32 * w, hi = lo + ZC;
  const uint64_t upto = hi >= 32 ? 0xffffffffull : (1ull << hi) - 1ull;
  const uint64_t below = lo <= 0 ? 0ull : (1ull << lo) - 1ull;
  return (uint32_t)(upto & ~below);
}

// the bits of word w that hold block pt's columns in the grid slots of
// `slots` (bit z = slot z; all ones = every slot)
KT_HD uint32_t slot_bits(uint64_t slots, int w, int pt, int ZC) {
  const int lo = pt * ZC - 32 * w;
  const uint64_t x = lo >= 0 ? slots << lo : slots >> -lo;
  return (uint32_t)x & block_bits(w, pt, ZC);
}

// the last block a chunk walk evaluated, and its verdict
struct BlockMemo {
  int pt, v;
};

// the block that holds the lowest set bit of m (word w)
KT_HD int low_block(uint32_t m, int w, int ZC) {
  return (32 * w + kt_ctz(m)) / ZC;
}

// One word m (word w of a row) of each walk, the memo carried from the
// chunk's previous word.

// the best block fit over m's blocks with a bit in `slots`, into `best`
KT_HD int word_best(uint32_t m, int w, int ZC, uint64_t slots,
                    const float* s_pt, const float* u, const float* req,
                    int best, BlockMemo& memo) {
  while (m) {
    const int pt = low_block(m, w, ZC);
    if (m & slot_bits(slots, w, pt, ZC)) {
      if (pt != memo.pt) {
        memo.pt = pt;
        memo.v = fit_left(&s_pt[pt * KR], u, req);
      }
      best = best > memo.v ? best : memo.v;
    }
    m &= ~block_bits(w, pt, ZC);
  }
  return best;
}

// per grid slot, the max block fit over m's blocks with that slot's bit
KT_HD void word_slotmax(uint32_t m, int w, int ZC, const float* s_pt,
                        const float* u, const float* req, int* slotmax,
                        BlockMemo& memo) {
  while (m) {
    const int pt = low_block(m, w, ZC);
    const uint32_t bb = block_bits(w, pt, ZC);
    if (pt != memo.pt) {
      memo.pt = pt;
      memo.v = fit_left(&s_pt[pt * KR], u, req);
    }
    const int lo = pt * ZC - 32 * w;
    for (uint32_t f = m & bb; f; f &= f - 1) {
      const int z = kt_ctz(f) - lo;
      slotmax[z] = slotmax[z] > memo.v ? slotmax[z] : memo.v;
    }
    m &= ~bb;
  }
}

// m's bits in `slots` of the blocks whose allocatable still holds u
KT_HD uint32_t word_narrow(uint32_t m, int w, int ZC, uint64_t slots,
                           const float* s_pt, const float* u,
                           BlockMemo& memo) {
  uint32_t keep = 0u;
  while (m) {
    const int pt = low_block(m, w, ZC);
    const uint32_t f = m & slot_bits(slots, w, pt, ZC);
    if (f) {
      if (pt != memo.pt) {
        memo.pt = pt;
        memo.v = all_fits2(&s_pt[pt * KR], u);
      }
      if (memo.v) keep |= f;
    }
    m &= ~block_bits(w, pt, ZC);
  }
  return keep;
}

// the chunks of a row of W words, and the u32 words of a row's chunk
// summary (bit c % 32 of word c / 32: chunk c may hold a bit)
KT_HD int row_chunks(int W, int ZC) {
  return (W + chunk_words(ZC) - 1) / chunk_words(ZC);
}

KT_HD int summary_words(int W, int ZC) {
  return (row_chunks(W, ZC) + 31) / 32;
}

KT_HD int chunk_end(int c, int W, int ZC) {
  const int w1 = (c + 1) * chunk_words(ZC);
  return w1 < W ? w1 : W;
}

// A chunk's first three words are loaded together before its walk starts
// (one memory latency for the usual ZC, whose chunks are 1 or 3 words),
// the rest one after another; the walk itself is one loop, so that each
// call site holds one copy of the block arithmetic.
struct ChunkHead {
  uint32_t w0, w1, w2;
  KT_HD uint32_t at(int k) const { return k == 0 ? w0 : k == 1 ? w1 : w2; }
};

KT_HD ChunkHead chunk_head(const uint32_t* a, const uint32_t* b, int w0,
                           int w1) {
  ChunkHead h = {0u, 0u, 0u};
  if (w0 < w1) h.w0 = a[w0] & b[w0];
  if (w0 + 1 < w1) h.w1 = a[w0 + 1] & b[w0 + 1];
  if (w0 + 2 < w1) h.w2 = a[w0 + 2] & b[w0 + 2];
  return h;
}

// The best fit over chunk c's blocks with a bit of row & gm in `slots`,
// folded into `best`.
KT_HD int chunk_best(const uint32_t* row, const uint32_t* gm, int c, int W,
                     int ZC, uint64_t slots, const float* s_pt,
                     const float* u, const float* req, int best) {
  const int w0 = c * chunk_words(ZC), w1 = chunk_end(c, W, ZC);
  const ChunkHead h = chunk_head(row, gm, w0, w1);
  BlockMemo memo = {-1, 0};
  for (int w = w0; w < w1; ++w) {
    const uint32_t m = w - w0 < 3 ? h.at(w - w0) : row[w] & gm[w];
    if (m) best = word_best(m, w, ZC, slots, s_pt, u, req, best, memo);
  }
  return best;
}

// Per grid slot z, the max of the block fit over chunk c's blocks whose
// slot-z bit of row & gm survives, folded into slotmax[ZC].
KT_HD void chunk_slotmax(const uint32_t* row, const uint32_t* gm, int c,
                         int W, int ZC, const float* s_pt, const float* u,
                         const float* req, int* slotmax) {
  const int w0 = c * chunk_words(ZC), w1 = chunk_end(c, W, ZC);
  const ChunkHead h = chunk_head(row, gm, w0, w1);
  BlockMemo memo = {-1, 0};
  for (int w = w0; w < w1; ++w) {
    const uint32_t m = w - w0 < 3 ? h.at(w - w0) : row[w] & gm[w];
    if (m) word_slotmax(m, w, ZC, s_pt, u, req, slotmax, memo);
  }
}

// Chunk c of the narrowed row: the words of src_a & src_b in `slots`, with
// the bits of every block whose allocatable no longer holds `u` cleared,
// written to out (out may be src_a: each word is read before it is
// written).  Returns whether any bit is left in the chunk.
KT_HD bool chunk_narrow(uint32_t* out, const uint32_t* src_a,
                        const uint32_t* src_b, int c, int W, int ZC,
                        uint64_t slots, const float* s_pt, const float* u) {
  const int w0 = c * chunk_words(ZC), w1 = chunk_end(c, W, ZC);
  const ChunkHead h = chunk_head(src_a, src_b, w0, w1);
  BlockMemo memo = {-1, 0};
  uint32_t any = 0u;
  for (int w = w0; w < w1; ++w) {
    const uint32_t m = w - w0 < 3 ? h.at(w - w0) : src_a[w] & src_b[w];
    const uint32_t keep = m ? word_narrow(m, w, ZC, slots, s_pt, u, memo) : 0u;
    out[w] = keep;
    any |= keep;
  }
  return any != 0u;
}

// A row's chunk summary word sw (bit j: chunk 32 sw + j may hold a bit)
// split over the L lanes of a tile: the j-th set bit's chunk goes to lane
// j % L.  Each lane first takes its share of the bits, so that the lanes
// then walk their chunks side by side.

// the set bits of x at even rank (the 0th, 2nd, ... from the lowest), or
// with odd at odd rank: a bit's rank parity is the parity of the set bits
// below it (a prefix xor)
KT_HD uint32_t rank_parity_bits(uint32_t x, bool odd) {
  uint32_t p = x;
  p ^= p << 1;
  p ^= p << 2;
  p ^= p << 4;
  p ^= p << 8;
  p ^= p << 16;
  const uint32_t below = p ^ x;  // bit i: parity of x's bits below i
  return odd ? x & below : x & ~below;
}

// lane t's share of summary bits: the j-th set bit for j % L == t, taken
// one bit of t at a time (the set bits of even or odd rank, then of those
// the even or odd, ...)
KT_HD uint32_t lane_share(uint32_t bits, int t, int L) {
  for (int l = 1; l < L; l <<= 1) bits = rank_parity_bits(bits, (t & l) != 0);
  return bits;
}

// Lane t's share of each walk:

// the best fit over its chunks' blocks with a bit of row & gm in `slots`
KT_HD int lane_best(const uint32_t* row, const uint32_t* gm, uint32_t bits,
                    int sw, int t, int L, int W, int ZC, uint64_t slots,
                    const float* s_pt, const float* u, const float* req,
                    int best) {
  for (uint32_t m = lane_share(bits, t, L); m; m &= m - 1)
    best = chunk_best(row, gm, sw * 32 + kt_ctz(m), W, ZC, slots, s_pt, u,
                      req, best);
  return best;
}

// its chunks' per-slot maxima, into slotmax[ZC]
KT_HD void lane_slotmax(const uint32_t* row, const uint32_t* gm,
                        uint32_t bits, int sw, int t, int L, int W, int ZC,
                        const float* s_pt, const float* u, const float* req,
                        int* slotmax) {
  for (uint32_t m = lane_share(bits, t, L); m; m &= m - 1)
    chunk_slotmax(row, gm, sw * 32 + kt_ctz(m), W, ZC, s_pt, u, req,
                  slotmax);
}

// its chunks of row narrowed in place (row & gm in `slots`, blocks that no
// longer hold u cleared); returns the summary bits of those left empty
KT_HD uint32_t lane_narrow(uint32_t* row, const uint32_t* gm, uint32_t bits,
                           int sw, int t, int L, int W, int ZC,
                           uint64_t slots, const float* s_pt,
                           const float* u) {
  uint32_t emptied = 0u;
  for (uint32_t m = lane_share(bits, t, L); m; m &= m - 1)
    if (!chunk_narrow(row, row, gm, sw * 32 + kt_ctz(m), W, ZC, slots, s_pt,
                      u))
      emptied |= m & (0u - m);
  return emptied;
}

// an opened row: every chunk c of summary word sw with c % L == t written
// from src_a & src_b (narrowed as above), where `reach` (a summary word
// that marks every chunk src_a & src_b holds a bit in) leaves a chunk
// unmarked, zeros; returns the summary bits of those that hold a bit
KT_HD uint32_t lane_open(uint32_t* row, const uint32_t* src_a,
                         const uint32_t* src_b, uint32_t reach, int sw, int t,
                         int L, int W, int ZC, uint64_t slots,
                         const float* s_pt, const float* u) {
  const int nch = row_chunks(W, ZC);
  const int c1 = sw * 32 + 32 < nch ? sw * 32 + 32 : nch;
  uint32_t held = 0u;
  for (int c = sw * 32 + t; c < c1; c += L) {
    if ((reach >> (c - sw * 32)) & 1u) {
      if (chunk_narrow(row, src_a, src_b, c, W, ZC, slots, s_pt, u))
        held |= 1u << (c - sw * 32);
    } else {
      for (int w = c * chunk_words(ZC); w < chunk_end(c, W, ZC); ++w)
        row[w] = 0u;
    }
  }
  return held;
}

// the summary word sw of a row: its chunks that hold a bit
KT_HD uint32_t summary_word(const uint32_t* row, int sw, int W, int ZC) {
  const int nch = row_chunks(W, ZC), CW = chunk_words(ZC);
  const int c1 = sw * 32 + 32 < nch ? sw * 32 + 32 : nch;
  uint32_t held = 0u;
  for (int c = sw * 32; c < c1; ++c) {
    uint32_t any = 0u;
    for (int w = c * CW; w < chunk_end(c, W, ZC); ++w) any |= row[w];
    if (any) held |= 1u << (c - sw * 32);
  }
  return held;
}

