"""The card exchange of K7x (`karpenter_tpu_torch/csrc/ffd_xcard.cuh`) on
the CPU: its protocol run by std::thread ranks.

The protocol is `__host__ __device__`, its loads, stores, clock and
failure behind small wrappers, so g++ builds it here into a shim in which
each of S ranks (2 to 8) is a team of T threads (a spin barrier for the
block's `__syncthreads`) with its own inbox — [S][2][XCH] tagged 64-bit
words and its round count — in host memory.  The ranks run the kernel's
sequence: each launch loads the rank's round count, makes its exchanges
and stores the count back; the exchanges are vectors whose lengths cross
the 2,048-value slot (1, 2,048, 2,049, 5,000: up to three rounds), by max
and by integer sum, each rank's values a hash of (rank, launch, call,
index), so that a value read from the wrong round or launch shows.  One
rank is made slow (it sleeps at every team barrier and between a round's
push and its combine, so its peers run a round ahead of it); launches
follow each other with no join between the ranks and no reset of the
inboxes.  Every rank's result must equal the combination computed
directly, no wait may time out, and every rank's count must end at its
start plus the rounds made.  A wait for a rank that never pushes must give
up at its deadline.  Three broken builds of the protocol (`-D`
XC_MUTANT_STALE, a reader that takes a word two rounds old;
XC_MUTANT_ONE_SLOT, one slot instead of two; XC_MUTANT_NO_COUNT, a round
count that starts again at 0 every launch) must each fail those checks
(the first two by a wrong value or a wait that times out; the last at
least by its count, since whether a stale word is read first depends on
how the threads are scheduled).
It skips when g++ is missing.
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

// a rank whose wait timed out (its team's barriers give up with it)
static std::atomic<bool> failed{false};

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
      while (gen.load() == g) {
        if (failed.load()) throw XcTimeout{};
        std::this_thread::yield();
      }
    }
  }
};

struct HostTeam {
  int t, nt;
  SpinBarrier* bar;
  int delay_us, lag_us;
  void sync() {
    if (delay_us)
      std::this_thread::sleep_for(std::chrono::microseconds(delay_us));
    bar->wait();
  }
  void lag() {
    if (lag_us)
      std::this_thread::sleep_for(std::chrono::microseconds(lag_us));
  }
};

static int val(int rank, int launch, int call, int i) {
  uint32_t h = (uint32_t)rank * 0x9E3779B1u ^ (uint32_t)launch * 0x85EBCA77u ^
               (uint32_t)call * 0xC2B2AE3Du ^ (uint32_t)i * 0x27D4EB2Fu;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return (int)h;
}

// S ranks of T threads through `launches` launches of `calls` exchanges
// each, of lengths lens[c % nlens], sum on odd calls and max on even ones,
// every round count starting at `first`; rank `slow` sleeps delay_us at
// every team barrier and lag_us between a round's push and its combine.
// Returns the values that differ from the direct combination; counts_out
// [S] gets every rank's round count at the end, *timed_out whether a wait
// gave up.
extern "C" long kt_xcard(int S, int T, int launches, int calls,
                         const int* lens, int nlens, int slow, int delay_us,
                         int lag_us, unsigned first,
                         unsigned long long* counts_out, int* timed_out) {
  failed.store(false);
  const size_t words = (size_t)S * 2 * XCH + 1;
  std::vector<std::vector<unsigned long long>> inbox(
      S, std::vector<unsigned long long>(words, 0ull));
  for (int r = 0; r < S; ++r) inbox[r][words - 1] = first;
  std::vector<SpinBarrier> bars(S);
  std::vector<unsigned> rounds(S, 0u);
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
        for (int q = 0; q < S; ++q) x.inbox[q] = inbox[q].data();
        x.rank = r;
        x.S = S;
        HostTeam team = {t, T, &bars[r], r == slow ? delay_us : 0,
                         r == slow ? lag_us : 0};
        int* v = vals[r].data();
        long mine = 0;
        try {
          for (int l = 0; l < launches; ++l) {
            xc_begin(x, &rounds[r], team);
            for (int c = 0; c < calls; ++c) {
              const int L = lens[c % nlens];
              for (int i = t; i < L; i += T) v[i] = val(r, l, c, i);
              if (c & 1)
                xc_all<true>(x, &rounds[r], v, L, team);
              else
                xc_all<false>(x, &rounds[r], v, L, team);
              for (int i = t; i < L; i += T) {
                int want = val(0, l, c, i);
                for (int q = 1; q < S; ++q) {
                  const int y = val(q, l, c, i);
                  want = (c & 1) ? (int)((unsigned)want + (unsigned)y)
                                 : (want > y ? want : y);
                }
                mine += v[i] != want;
              }
            }
            xc_end(x, &rounds[r], team);
            team.sync();  // the launch ends: every thread of the block
          }
        } catch (const XcTimeout&) {
          failed.store(true);
        }
        bad += mine;
      });
  for (auto& th : threads) th.join();
  for (int r = 0; r < S; ++r) counts_out[r] = inbox[r][words - 1];
  *timed_out = failed.load() ? 1 : 0;
  return bad.load();
}

// rank 0 of two waiting for a word of round 1 that rank 1 never pushes:
// the ns it waited before giving up, or -1 if the wait returned true
extern "C" long kt_xcard_timeout(unsigned long long timeout_ns) {
  std::vector<unsigned long long> inbox(2 * 2 * XCH + 1, 0ull);
  XcardArgs x = {};
  x.inbox[0] = x.inbox[1] = inbox.data();
  x.rank = 0;
  x.S = 2;
  int v = 0;
  const unsigned long long t0 = xc_now_ns();
  if (xc_wait(xc_slot(x, 0, 1, 1), 1u, timeout_ns, &v)) return -1;
  return (long)(xc_now_ns() - t0);
}

extern "C" int kt_xch() { return XCH; }
"""

MUTANTS = {"stale": "XC_MUTANT_STALE", "one-slot": "XC_MUTANT_ONE_SLOT",
           "no-count": "XC_MUTANT_NO_COUNT"}


def _build(d, name, flags=()):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host shim of ffd_xcard.cuh "
                    "cannot be built")
    src, lib = d / f"{name}.cpp", d / f"lib{name}.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-O2", "-std=c++17", "-pthread", "-shared", "-fPIC",
                    *flags, "-I", CSRC, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    I, P = ctypes.c_int, ctypes.c_void_p
    so.kt_xcard.argtypes = [I, I, I, I, P, I, I, I, I, ctypes.c_uint, P, P]
    so.kt_xcard.restype = ctypes.c_long
    so.kt_xcard_timeout.argtypes = [ctypes.c_ulonglong]
    so.kt_xcard_timeout.restype = ctypes.c_long
    so.kt_xch.restype = I
    return so


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The g++ shim of ffd_xcard.cuh, loaded with ctypes."""
    return _build(tmp_path_factory.mktemp("xcard"), "xcard_shim")


def _run(so, S, T=1, launches=1, calls=8, lens=(5000, 1, 2048, 2049),
         slow=-1, delay_us=0, lag_us=0, first=0):
    lens = np.asarray(lens, np.int32)
    counts = np.zeros(S, np.uint64)
    timed_out = np.zeros(1, np.int32)
    bad = so.kt_xcard(S, T, launches, calls, lens.ctypes.data, len(lens),
                      slow, delay_us, lag_us, first, counts.ctypes.data,
                      timed_out.ctypes.data)
    return bad, counts, bool(timed_out[0])


def _rounds(so, calls, lens):
    xch = so.kt_xch()
    return sum(-(-int(lens[c % len(lens)]) // xch) for c in range(calls))


@pytest.mark.parametrize("S", [2, 3, 4, 8])
@pytest.mark.parametrize("T", [1, 3])
def test_max_and_sum_across_the_slot(shim, S, T):
    """Max and sum over S ranks, lengths 1 to 5,000 (one to three rounds
    of the 2,048-value slot), every value as combined directly."""
    lens = (5000, 1, 2048, 2049)
    bad, counts, timed_out = _run(shim, S, T, calls=12, lens=lens)
    assert shim.kt_xch() == 2048
    assert bad == 0 and not timed_out
    assert (counts == _rounds(shim, 12, lens)).all()


# one rank a round behind its peers, a few launches: what the broken
# variants must fail on
LAGGED = dict(T=2, launches=3, calls=6, lens=(4097, 1, 1, 2048, 3, 1),
              delay_us=300, lag_us=300)


@pytest.mark.parametrize("S,slow", [(2, 0), (3, 1), (4, 3), (8, 5)])
def test_a_delayed_rank_sees_no_slot_overwritten(shim, S, slow):
    """One rank sleeps at every barrier and between its push and its
    combine, so its peers run a round ahead of its reads: a peer that
    wrote the slot it still reads would change its result or leave it
    waiting."""
    bad, _, timed_out = _run(shim, S, slow=slow, **{
        **LAGGED, "calls": 10, "lens": (3000, 7, 4097)})
    assert bad == 0 and not timed_out
    bad, counts, timed_out = _run(shim, S, slow=slow, **LAGGED)
    assert bad == 0 and not timed_out
    made = LAGGED["launches"] * _rounds(shim, LAGGED["calls"], LAGGED["lens"])
    assert (counts == made).all()


@pytest.mark.parametrize("S", [2, 4, 8])
def test_launches_in_a_row_on_the_round_tag(shim, S):
    """Launches one after another with no join between the ranks and the
    inboxes never reset: each launch continues the round count the last
    one stored, so a word left by the last launch carries another tag and
    satisfies no wait of the next; a fast rank's next launch pushes into
    the slot the slow one no longer reads."""
    lens = (2049, 5000, 3)
    first = 7
    bad, counts, timed_out = _run(shim, S, T=2, launches=4, calls=5,
                                  lens=lens, slow=S - 1, delay_us=100,
                                  lag_us=100, first=first)
    assert bad == 0 and not timed_out
    assert (counts == first + 4 * _rounds(shim, 5, lens)).all()


def test_a_lost_rank_ends_the_wait(shim):
    """A wait for a rank that never pushes gives up at its deadline (on
    the card the kernel then traps)."""
    waited = shim.kt_xcard_timeout(20_000_000)
    assert waited >= 20_000_000


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_a_broken_exchange_fails_the_checks(tmp_path, mutant):
    """Each broken variant of the protocol, built with its `-D` flag (and
    a 50 ms deadline), fails a check of the lagged run at 4 ranks that the
    protocol passes: a wrong value, a wait that times out, or a round
    count other than the rounds made (which catches the count that starts
    again at 0 however the threads are scheduled)."""
    so = _build(tmp_path, f"xcard_{mutant}",
                (f"-D{MUTANTS[mutant]}", "-DXC_TIMEOUT_NS=50000000ull"))
    bad, counts, timed_out = _run(so, 4, slow=3, **LAGGED)
    made = LAGGED["launches"] * _rounds(so, LAGGED["calls"], LAGGED["lens"])
    assert bad > 0 or timed_out or (counts != made).any(), mutant
