"""The card exchange of K7x (`karpenter_tpu_torch/csrc/ffd_xcard.cuh`) on
the CPU: its protocol run by std::thread ranks.

The protocol is `__host__ __device__`, its atomics, clock, fence and
failure behind small wrappers, so g++ builds it here into a shim in
which each of S ranks is a team of T threads (a spin barrier for the
block's `__syncthreads`) with its own inbox [S][2][XCH] and flags [S]
in host memory.  The ranks run the kernel's sequence: round 0 on entry
to each launch, then exchanges of vectors whose lengths cross the
2,048-value slot (1, 2,048, 2,049, 5,000: up to three rounds), by max
and by integer sum, each rank's values a hash of (rank, launch, call,
index), so that a value read from the wrong round or launch shows.  One
rank is made slow (it sleeps at every team barrier, so its reads of a
slot lag its peers' next pushes); launches follow each other with no
join between the ranks and no reset of the flags, on the 64-bit
sequence (launch << 32 | round).  Every rank's result must equal the
combination computed directly, and every flag must end at the last
launch's last round.  A wait for a rank that never publishes must give
up at its deadline.  It skips when g++ is missing.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "karpenter_tpu_torch", "csrc")

SHIM = r"""
#include "ffd_xcard.cuh"

#include <atomic>
#include <vector>

// the block barrier of one rank's team
struct SpinBarrier {
  std::atomic<int> count{0}, gen{0};
  int n = 1;
  void wait() {
    const int g = gen.load();
    if (count.fetch_add(1) + 1 == n) {
      count.store(0);
      gen.fetch_add(1);
    } else {
      while (gen.load() == g) std::this_thread::yield();
    }
  }
};

struct HostTeam {
  int t, nt;
  SpinBarrier* bar;
  int delay_us;
  void sync() {
    if (delay_us)
      std::this_thread::sleep_for(std::chrono::microseconds(delay_us));
    bar->wait();
  }
  void fence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
};

static int val(int rank, unsigned launch, int call, int i) {
  uint32_t h = (uint32_t)rank * 0x9E3779B1u ^ launch * 0x85EBCA77u ^
               (uint32_t)call * 0xC2B2AE3Du ^ (uint32_t)i * 0x27D4EB2Fu;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return (int)h;
}

// S ranks of T threads through `launches` launches (counter first,
// first + 1, ...) of `calls` exchanges each, of lengths lens[c % nlens],
// sum on odd calls and max on even ones; rank `slow` sleeps delay_us at
// every team barrier.  Returns the values that differ from the direct
// combination; flags_out [S][S] gets every rank's flags at the end.
extern "C" long kt_xcard(int S, int T, int launches, int calls,
                         const int* lens, int nlens, int slow, int delay_us,
                         unsigned first, unsigned long long* flags_out) {
  std::vector<std::vector<int>> inbox(S, std::vector<int>(S * 2 * XCH, 0));
  std::vector<std::vector<unsigned long long>> flags(
      S, std::vector<unsigned long long>(S, 0ull));
  std::vector<SpinBarrier> bars(S);
  std::vector<std::vector<int>> vals(S);
  int maxlen = 1;
  for (int i = 0; i < nlens; ++i) maxlen = lens[i] > maxlen ? lens[i] : maxlen;
  for (int r = 0; r < S; ++r) {
    bars[r].n = T;
    vals[r].assign(maxlen, 0);
  }
  std::atomic<long> bad{0};
  std::vector<std::thread> threads;
  for (int r = 0; r < S; ++r)
    for (int t = 0; t < T; ++t)
      threads.emplace_back([&, r, t]() {
        XcardArgs x = {};
        for (int q = 0; q < S; ++q) {
          x.inbox[q] = inbox[q].data();
          x.flags[q] = flags[q].data();
        }
        x.rank = r;
        x.S = S;
        HostTeam team = {t, T, &bars[r], r == slow ? delay_us : 0};
        int* v = vals[r].data();
        long mine = 0;
        for (int l = 0; l < launches; ++l) {
          x.launch = first + (unsigned)l;
          xc_enter(x, team);
          unsigned k = 0;
          for (int c = 0; c < calls; ++c) {
            const int L = lens[c % nlens];
            for (int i = t; i < L; i += T) v[i] = val(r, x.launch, c, i);
            if (c & 1)
              xc_all<true>(x, &k, v, L, team);
            else
              xc_all<false>(x, &k, v, L, team);
            for (int i = t; i < L; i += T) {
              int want = val(0, x.launch, c, i);
              for (int q = 1; q < S; ++q) {
                const int y = val(q, x.launch, c, i);
                want = (c & 1) ? (int)((unsigned)want + (unsigned)y)
                               : (want > y ? want : y);
              }
              mine += v[i] != want;
            }
          }
        }
        bad += mine;
      });
  for (auto& th : threads) th.join();
  for (int r = 0; r < S; ++r)
    for (int q = 0; q < S; ++q) flags_out[r * S + q] = flags[r][q];
  return bad.load();
}

// rank 0 of two waiting for a rank that never publishes: the ns it waited
// before giving up, or -1 if the wait returned true
extern "C" long kt_xcard_timeout(unsigned long long timeout_ns) {
  std::vector<int> inbox(2 * 2 * XCH, 0);
  std::vector<unsigned long long> flags(2, 0ull);
  XcardArgs x = {};
  x.inbox[0] = x.inbox[1] = inbox.data();
  x.flags[0] = x.flags[1] = flags.data();
  x.rank = 0;
  x.S = 2;
  x.launch = 1;
  const unsigned long long t0 = xc_now_ns();
  if (xc_wait_one(x, 1, xc_seq(1, 0), timeout_ns)) return -1;
  return (long)(xc_now_ns() - t0);
}

extern "C" int kt_xch() { return XCH; }
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The g++ shim of ffd_xcard.cuh, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host shim of ffd_xcard.cuh "
                    "cannot be built")
    d = tmp_path_factory.mktemp("xcard")
    src, lib = d / "xcard_shim.cpp", d / "libxcard_shim.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-O2", "-std=c++17", "-pthread", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    I, P = ctypes.c_int, ctypes.c_void_p
    so.kt_xcard.argtypes = [I, I, I, I, P, I, I, I, ctypes.c_uint, P]
    so.kt_xcard.restype = ctypes.c_long
    so.kt_xcard_timeout.argtypes = [ctypes.c_ulonglong]
    so.kt_xcard_timeout.restype = ctypes.c_long
    so.kt_xch.restype = I
    return so


def _run(so, S, T=1, launches=1, calls=8, lens=(5000, 1, 2048, 2049),
         slow=-1, delay_us=0, first=1):
    lens = np.asarray(lens, np.int32)
    flags = np.zeros((S, S), np.uint64)
    bad = so.kt_xcard(S, T, launches, calls, lens.ctypes.data, len(lens),
                      slow, delay_us, first, flags.ctypes.data)
    return bad, flags


def _rounds(so, calls, lens):
    xch = so.kt_xch()
    return sum(-(-int(lens[c % len(lens)]) // xch) for c in range(calls))


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("T", [1, 3])
def test_max_and_sum_across_the_slot(shim, S, T):
    """Max and sum over S ranks, lengths 1 to 5,000 (one to three rounds
    of the 2,048-value slot), every value as combined directly."""
    lens = (5000, 1, 2048, 2049)
    bad, flags = _run(shim, S, T, calls=12, lens=lens)
    assert shim.kt_xch() == 2048
    assert bad == 0
    last = (1 << 32) | _rounds(shim, 12, lens)
    off = ~np.eye(S, dtype=bool)
    assert (flags[off] == last).all() and (flags[~off] == 0).all()


@pytest.mark.parametrize("S,slow", [(2, 0), (3, 1), (4, 3)])
def test_a_delayed_rank_sees_no_slot_overwritten(shim, S, slow):
    """One rank sleeps at every barrier, so its peers run a round ahead
    of its reads: a peer that wrote the slot it still reads would change
    its result."""
    bad, _ = _run(shim, S, T=2, calls=10, lens=(3000, 7, 4097),
                  slow=slow, delay_us=300)
    assert bad == 0


@pytest.mark.parametrize("S", [2, 4])
def test_launches_in_a_row_on_the_64_bit_sequence(shim, S):
    """Launches one after another with no join between the ranks and the
    flags never reset: each launch's rounds wait on its own sequence
    numbers (a flag left at the last launch's last round satisfies no
    wait of the next), a fast rank's next launch waits in round 0 for
    the slow one to leave."""
    lens = (2049, 5000, 3)
    first = 7
    bad, flags = _run(shim, S, T=2, launches=4, calls=5, lens=lens,
                      slow=S - 1, delay_us=100, first=first)
    assert bad == 0
    last = ((first + 3) << 32) | _rounds(shim, 5, lens)
    assert (flags[~np.eye(S, dtype=bool)] == last).all()


def test_a_lost_rank_ends_the_wait(shim):
    """A wait for a rank that never publishes gives up at its deadline
    (on the card the kernel then traps)."""
    waited = shim.kt_xcard_timeout(20_000_000)
    assert waited >= 20_000_000
