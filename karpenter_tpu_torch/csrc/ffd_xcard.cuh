// The card exchange of the cross-card column-sharded scan (K7x,
// ffd_card_scan.cu): the protocol by which S ranks, one thread block on
// each of S cards, combine a vector of ints by max or by integer sum
// inside one running kernel.  It stands in for the reference's
// collectives under `shard_map` (pmax in `_axmax`/`_axany`,
// karpenter_tpu/solver/ffd.py:93-113, on `kfull_pd` :667, :918; the
// all_gather of shard 0's slot domains :631, :893, :1161; the psum of the
// explain counts :1202), which the one-card K7 runs as exchanges through
// distributed shared memory (`cluster_combine`).
//
// Memory.  Rank r's card holds its inbox, [S][2][XCH] ints (one
// double-buffered slot per source rank), and its flags, [S] 64-bit
// sequence numbers (flags[src] is the last round src published to r).
// Every rank gets all S inbox and flag addresses: a peer's are device
// pointers into the peer's memory, reached over NVLink once peer access
// is on (or, in the one-card rehearsal, plain addresses of one card).
//
// One round k (1, 2, ...) of launch L moves n <= XCH values:
//   push     each thread stores its values into slot [rank][k & 1] of
//            every peer's inbox (plain stores through peer pointers),
//            then __threadfence_system() and a block barrier;
//   publish  thread r of the block stores seq(L, k) = (L << 32) | k into
//            peer r's flags[rank] with a system-scope release;
//   wait     thread r spins with system-scope acquire loads on its own
//            card's flags[r] until it reads at least seq(L, k); a block
//            barrier;
//   combine  each thread folds every peer's slot [src][k & 1] (read
//            through L2, `__ldcg`: a slot read two rounds ago may still
//            sit in L1) into its own values.
// Round 0 of every launch carries no data: each rank publishes seq(L, 0)
// on entry and waits for every peer's, so a rank starts writing slots
// only once every peer has left the previous launch.
//
// Slot reuse.  A rank writes slot p = k & 1 of round k only after it has
// seen every peer's seq(L, k - 1); a peer publishes seq(L, k - 1) only
// after the block barrier that follows its reads of round k - 2, the last
// round that used slot p (for k = 1, 2 that was the previous launch,
// which the peer had left before it published seq(L, 0)).  A peer is at
// most one round ahead, so it writes the other slot.  The flags are never
// reset: a reset on one card could land after a peer had already
// published into it.  The sequence grows instead — the launch counter L
// (kept by the host, >= 1, one per launch) in the high word and the round
// in the low one — and a wait asks for "at least".
//
// Exactness.  Max and sum modulo 2^32 are exact in any order, so every
// rank holds the same combination, equal to the plain version's bit for
// bit.
//
// A wait is bounded: past XC_TIMEOUT_NS of %globaltimer it calls
// __trap(), so a lost rank fails the launch (the next synchronise reports
// it); nothing hangs and nothing falls back.
//
// Everything here is __host__ __device__, with the atomics, the clock,
// the fence and the failure behind small wrappers, so that a host shim
// (tests/test_torch_xcard.py) runs the same protocol with std::thread
// ranks.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include <chrono>
#include <cstdlib>
#include <thread>

#if defined(__CUDACC__)
#include <cuda/atomic>
#define XC_HD __host__ __device__ __forceinline__
#else
#define XC_HD inline
#endif

#ifndef XCH
#define XCH 2048  // ints per exchange slot
#endif
#define XMAXR 8   // ranks (cards of one host)
#ifndef XC_TIMEOUT_NS
#define XC_TIMEOUT_NS 5000000000ull  // a wait's deadline: 5 s
#endif

// What a rank needs of the exchange: every rank's inbox and flags, its
// rank, the rank count and the launch counter.
struct XcardArgs {
  int* inbox[XMAXR];                 // rank r's [S][2][XCH] on its card
  unsigned long long* flags[XMAXR];  // rank r's [S] on its card
  int rank, S;
  unsigned launch;                   // >= 1, one per launch (the host's)
};

XC_HD unsigned long long xc_seq(unsigned launch, unsigned round) {
  return ((unsigned long long)launch << 32) | round;
}

// slot [src][par] of rank dst's inbox
XC_HD int* xc_slot(const XcardArgs& x, int dst, int src, int par) {
  return x.inbox[dst] + ((size_t)src * 2 + par) * XCH;
}

// -- the wrappers ------------------------------------------------------------
XC_HD void xc_release(unsigned long long* p, unsigned long long v) {
#if defined(__CUDA_ARCH__)
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_system>(*p).store(
      v, cuda::memory_order_release);
#else
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
#endif
}

XC_HD unsigned long long xc_acquire(unsigned long long* p) {
#if defined(__CUDA_ARCH__)
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_system>(*p)
      .load(cuda::memory_order_acquire);
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

// a value a peer pushed, past the reading SM's L1
XC_HD int xc_load(const int* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *(const volatile int*)p;
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
  __nanosleep(64);
#else
  std::this_thread::yield();
#endif
}

XC_HD void xc_fail() {
#if defined(__CUDA_ARCH__)
  __trap();
#else
  std::abort();
#endif
}

// -- the protocol's steps ----------------------------------------------------
// push: this rank's n values v into slot [rank][par] of every peer's inbox;
// thread t of nt
XC_HD void xc_push(const XcardArgs& x, int par, const int* v, int n, int t,
                   int nt) {
  for (int i = t; i < n; i += nt) {
    const int val = v[i];
    for (int r = 0; r < x.S; ++r)
      if (r != x.rank) xc_slot(x, r, x.rank, par)[i] = val;
  }
}

// publish: seq to every peer (flags[r][rank]), the peers r = t, t + nt, ...
XC_HD void xc_publish(const XcardArgs& x, unsigned long long seq, int t,
                      int nt) {
  for (int r = t; r < x.S; r += nt)
    if (r != x.rank) xc_release(x.flags[r] + x.rank, seq);
}

// wait until peer src has published at least seq to this rank; false past
// `timeout_ns`
XC_HD bool xc_wait_one(const XcardArgs& x, int src, unsigned long long seq,
                       unsigned long long timeout_ns) {
  unsigned long long* f = x.flags[x.rank] + src;
  if (xc_acquire(f) >= seq) return true;
  const unsigned long long t0 = xc_now_ns();
  while (xc_acquire(f) < seq) {
    if (xc_now_ns() - t0 > timeout_ns) return false;
    xc_pause();
  }
  return true;
}

// wait for the peers r = t, t + nt, ...; a peer past the deadline fails
// the launch
XC_HD void xc_wait(const XcardArgs& x, unsigned long long seq, int t,
                   int nt) {
  for (int r = t; r < x.S; r += nt)
    if (r != x.rank && !xc_wait_one(x, r, seq, XC_TIMEOUT_NS)) xc_fail();
}

// combine: every peer's slot [src][par] folded into this rank's n values v
// (max, or with SUM the sum modulo 2^32)
template <bool SUM>
XC_HD void xc_combine(const XcardArgs& x, int par, int* v, int n, int t,
                      int nt) {
  for (int i = t; i < n; i += nt) {
    int acc = v[i];
    for (int r = 0; r < x.S; ++r) {
      if (r == x.rank) continue;
      const int y = xc_load(xc_slot(x, x.rank, r, par) + i);
      acc = SUM ? (int)((unsigned)acc + (unsigned)y) : (acc > y ? acc : y);
    }
    v[i] = acc;
  }
}

// -- a team's rounds ---------------------------------------------------------
// `Team` is what runs one rank: t, nt, sync() (a barrier of the team) and
// fence() (__threadfence_system on the card).  Every member calls with the
// same arguments.

// round 0: every peer has entered launch x.launch
template <class Team>
XC_HD void xc_enter(const XcardArgs& x, Team& team) {
  const unsigned long long seq = xc_seq(x.launch, 0u);
  team.sync();
  xc_publish(x, seq, team.t, team.nt);
  xc_wait(x, seq, team.t, team.nt);
  team.sync();
}

// round k >= 1: v [n <= XCH] becomes its combination over every rank
template <bool SUM, class Team>
XC_HD void xc_round(const XcardArgs& x, unsigned k, int* v, int n,
                    Team& team) {
  const int par = (int)(k & 1u);
  const unsigned long long seq = xc_seq(x.launch, k);
  xc_push(x, par, v, n, team.t, team.nt);
  team.fence();
  team.sync();
  xc_publish(x, seq, team.t, team.nt);
  xc_wait(x, seq, team.t, team.nt);
  team.sync();
  xc_combine<SUM>(x, par, v, n, team.t, team.nt);
}

// a vector of any length L: rounds *k + 1, *k + 2, ... of XCH values each;
// team barriers before the first push (the members wrote v) and after the
// last combine.  Every member keeps its own *k: they advance alike.
template <bool SUM, class Team>
XC_HD void xc_all(const XcardArgs& x, unsigned* k, int* v, int L,
                  Team& team) {
  team.sync();
  for (int base = 0; base < L; base += XCH) {
    const int n = L - base < XCH ? L - base : XCH;
    xc_round<SUM>(x, ++*k, v + base, n, team);
  }
  team.sync();
}
