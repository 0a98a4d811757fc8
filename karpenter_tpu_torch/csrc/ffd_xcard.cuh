// The card exchange of the cross-card column-sharded scan (K7x,
// ffd_card_scan.cu): the protocol by which S ranks, one thread block on
// each of S cards, combine a vector of ints by max or by integer sum
// inside one running kernel.  It stands in for the reference's
// collectives under `shard_map` (pmax in `_axmax`/`_axany`,
// karpenter_tpu/solver/ffd.py:93-113, on `kfull_pd` :667, :918; the psum
// of the explain counts :1202), which the one-card K7 runs as exchanges
// through distributed shared memory (`cluster_combine`).  (The all_gather
// of shard 0's slot domains, :631, :893, :1161, is no exchange: those ids
// are a constant of the resident catalog, and each card holds a copy.)
//
// Memory.  Rank r's card holds its inbox: [S][2][XCH] 64-bit words (one
// double-buffered slot per source rank), then one word, the rank's round
// count.  Every rank gets all S inbox addresses: a peer's is a device
// pointer into the peer's memory, reached over NVLink once peer access is
// on (or, in the one-card rehearsal, a plain address of one card).
//
// The word.  Every value travels in one aligned 8-byte word: the round's
// tag in the high half, the int in the low half.  A writer makes one
// 64-bit store into the peer's inbox (relaxed, system scope); a reader
// loads the words of its own inbox (relaxed, system scope: past the SM's
// L1, so no stale line) until each tag is the round's, then folds them.
// A 64-bit aligned store is single-copy atomic over NVLink (NCCL's LL
// protocol rests on the same), so a word whose tag is the round's holds
// the round's value.  No fence, no flag, no release/acquire pair: one
// NVLink crossing a round.
//
// One round k (the rank's round count, +1 a round) moves n <= XCH values:
//   push     each thread stores word (k, v[i]) for its values i = t,
//            t + nt, ... into slot [rank][k & 1] of every peer's inbox;
//   combine  the same thread loads exactly those entries of slot
//            [src][k & 1] of its own inbox, for every peer, until each
//            tag is k, and folds them into v[i].
// A block barrier follows the combine (the scan reads the combined
// vector), and one separates two rounds of one exchange.
//
// Tags and slots.  The round count lives in device memory, in the word
// after the rank's slots: a launch's first round continues where the
// rank's last launch stopped, so a tag names its round across launches
// and no launch needs an entry round.  Every rank runs the same sequence
// of exchanges, so every rank's count moves alike.  A slot is reused
// every second round: a word left from round k - 2, k - 4, ... has
// another tag and is never taken for round k.  No overwrite: a rank
// pushes round k only after the barrier that follows its combine of
// round k - 1, in which it took a word of round k - 1 from every peer; a
// peer pushes round k - 1 only after the barrier that follows its own
// combine of round k - 2, the last round that used slot k & 1 (in the
// rank's last launch, if k - 2 was there: the stream orders a rank's
// launches).  A peer is at most one round ahead, so it writes the other
// slot.  The count is 32 bits and starts at 0 (the inbox is zeroed with
// it, so no round carries tag 0); the host zeroes every inbox and count
// again, with every card idle, before a count passes 2^31
// (`CardExchange`), far before a tag could come round.
//
// Exactness.  Max and sum modulo 2^32 are exact in any order, so every
// rank holds the same combination, equal to the plain version's bit for
// bit.
//
// A wait is bounded: past XC_TIMEOUT_NS of %globaltimer it calls
// __trap(), so a lost rank fails the launch (the next synchronise reports
// it); nothing hangs and nothing falls back.
//
// Everything here is __host__ __device__, with the loads, stores, clock
// and failure behind small wrappers, so that a host shim
// (tests/test_torch_xcard.py) runs the same protocol with std::thread
// ranks; there a failed wait throws `XcTimeout`.  The shim also builds
// three broken variants (XC_MUTANT_STALE, a reader that takes a tag two
// rounds old; XC_MUTANT_ONE_SLOT, one slot instead of two;
// XC_MUTANT_NO_COUNT, a count that starts again at 0 each launch) and
// checks that each fails; no build of the kernels defines them.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include <chrono>
#include <thread>

#if defined(__CUDACC__)
#include <cuda/atomic>
#define XC_HD __host__ __device__ __forceinline__
#else
#define XC_HD inline
#endif

#ifndef XCH
#define XCH 2048  // values per exchange slot
#endif
#define XMAXR 8   // ranks (cards of one host)
#ifndef XC_TIMEOUT_NS
#define XC_TIMEOUT_NS 5000000000ull  // a wait's deadline: 5 s
#endif

// What a rank needs of the exchange: every rank's inbox, its rank, the
// rank count.
struct XcardArgs {
  unsigned long long* inbox[XMAXR];  // rank r's [S][2][XCH] + 1 on its card
  int rank, S;
};

// slot [src][par] of rank dst's inbox
XC_HD unsigned long long* xc_slot(const XcardArgs& x, int dst, int src,
                                  int par) {
  return x.inbox[dst] + ((size_t)src * 2 + par) * XCH;
}

// this rank's round count, the word after its slots
XC_HD unsigned long long* xc_count(const XcardArgs& x) {
  return x.inbox[x.rank] + (size_t)x.S * 2 * XCH;
}

// the slot of round k
XC_HD int xc_par(unsigned k) {
#if defined(XC_MUTANT_ONE_SLOT)
  (void)k;
  return 0;
#else
  return (int)(k & 1u);
#endif
}

XC_HD unsigned long long xc_word(unsigned tag, int v) {
  return ((unsigned long long)tag << 32) | (unsigned)v;
}

// whether word w carries round k
XC_HD bool xc_is(unsigned long long w, unsigned k) {
  const unsigned tag = (unsigned)(w >> 32);
#if defined(XC_MUTANT_STALE)
  return tag == k || tag + 2u == k;
#else
  return tag == k;
#endif
}

// -- the wrappers ------------------------------------------------------------
XC_HD void xc_put(unsigned long long* p, unsigned long long w) {
#if defined(__CUDA_ARCH__)
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_system>(*p).store(
      w, cuda::memory_order_relaxed);
#else
  __atomic_store_n(p, w, __ATOMIC_RELAXED);
#endif
}

XC_HD unsigned long long xc_get(unsigned long long* p) {
#if defined(__CUDA_ARCH__)
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_system>(*p)
      .load(cuda::memory_order_relaxed);
#else
  return __atomic_load_n(p, __ATOMIC_RELAXED);
#endif
}

XC_HD unsigned long long xc_now_ns() {
#if defined(__CUDA_ARCH__)
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#else
  return (unsigned long long)std::chrono::duration_cast<
             std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
#endif
}

XC_HD void xc_pause() {
#if defined(__CUDA_ARCH__)
  __nanosleep(32);
#else
  std::this_thread::yield();
#endif
}

struct XcTimeout {};

XC_HD void xc_fail() {
#if defined(__CUDA_ARCH__)
  __trap();
#else
  throw XcTimeout{};
#endif
}

// -- the protocol's steps ----------------------------------------------------
// until the word at p (this rank's inbox) carries round k: its value in
// *v, or false past `timeout_ns`
XC_HD bool xc_wait(unsigned long long* p, unsigned k,
                   unsigned long long timeout_ns, int* v) {
  unsigned long long w = xc_get(p);
  if (!xc_is(w, k)) {
    const unsigned long long t0 = xc_now_ns();
    do {
      if (xc_now_ns() - t0 > timeout_ns) return false;
      xc_pause();
      w = xc_get(p);
    } while (!xc_is(w, k));
  }
  *v = (int)(unsigned)w;
  return true;
}

// round k: v [n <= XCH] becomes its combination over every rank (max, or
// with SUM the sum modulo 2^32); thread t of nt takes values t, t + nt, ...
template <bool SUM, class Team>
XC_HD void xc_round(const XcardArgs& x, unsigned k, int* v, int n,
                    Team& team) {
  const int par = xc_par(k);
  for (int i = team.t; i < n; i += team.nt) {
    const unsigned long long w = xc_word(k, v[i]);
    for (int r = 0; r < x.S; ++r)
      if (r != x.rank) xc_put(xc_slot(x, r, x.rank, par) + i, w);
  }
  team.lag();
  for (int i = team.t; i < n; i += team.nt) {
    int acc = v[i];
    for (int r = 0; r < x.S; ++r) {
      if (r == x.rank) continue;
      int y;
      if (!xc_wait(xc_slot(x, x.rank, r, par) + i, k, XC_TIMEOUT_NS, &y))
        xc_fail();
      acc = SUM ? (int)((unsigned)acc + (unsigned)y) : (acc > y ? acc : y);
    }
    v[i] = acc;
  }
}

// -- a team's exchanges ------------------------------------------------------
// `Team` is what runs one rank: t, nt, sync() (a barrier of the team) and
// lag() (between a round's push and its combine: nothing on the card; a
// host shim's slow rank waits there).  Every member calls with the same
// arguments; `round` is the team's shared round count.

// a launch's start: member 0 loads the rank's round count (x's device
// word) into *round, then a team barrier
template <class Team>
XC_HD void xc_begin(const XcardArgs& x, unsigned* round, Team& team) {
  if (team.t == 0) {
#if defined(XC_MUTANT_NO_COUNT)
    *round = 0u;
#else
    *round = (unsigned)*xc_count(x);
#endif
  }
  team.sync();
}

// a launch's end, after its last exchange: member 0 stores the count back
template <class Team>
XC_HD void xc_end(const XcardArgs& x, const unsigned* round, Team& team) {
  if (team.t == 0) *xc_count(x) = *round;
}

// a vector of any length L: rounds *round + 1, *round + 2, ... of XCH
// values each; team barriers before the first push (the members wrote v),
// between two rounds and after the last combine.  Every member reads
// *round before the first barrier; member 0 advances it before the last.
template <bool SUM, class Team>
XC_HD void xc_all(const XcardArgs& x, unsigned* round, int* v, int L,
                  Team& team) {
  unsigned k = *round;
  team.sync();
  for (int base = 0; base < L; base += XCH) {
    if (base) team.sync();
    const int n = L - base < XCH ? L - base : XCH;
    xc_round<SUM>(x, ++k, v + base, n, team);
  }
  if (team.t == 0) *round = k;
  team.sync();
}
