"""The priority inversion witness as the scans fold it into their steps,
on the CPU.

`karpenter_tpu_torch/csrc/ffd_witness.cuh` is `__host__ __device__`; g++
builds it here (`-ffp-contract=off`, as the other shims) into a shim that
replays the fold as the scan's thread 0 runs it: `before` reset at the
start of each problem of a batch, then at each step, in group order, the
group's flag written from its count, its strand count (the float the step
wrote to `unsched`, read as an int32 count) and its priority, and
`before` advanced.  The shim's rows are held to two references:

  * `ffd.priority_witness`, the port's plain version, on hand-built rows
    (the first group, equal priorities against the strict test, negative
    priorities down to -(2^31), padding groups of count 0, a stranded group
    that placed some of its pods, a batch whose first problem strands a
    high band ahead of the second's) and on seeded random rows;
  * the JAX program's `prio_inv` region: the seeded priority-band problems
    of `tests/test_torch_priority.py` (`_witness_case`) through
    `ffd.solve_ffd`, and a batch of B = 3 through `ffd.solve_ffd_batch`,
    the fold replayed on the program's own `unsched` row.

It skips when g++ is missing.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.problems import random_batch
from tests.test_torch_ffd import _jax_args
from tests.test_torch_priority import PRIO, WITNESS_CASES, _witness_case

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "karpenter_tpu_torch", "csrc")

SHIM = r"""
#include "ffd_witness.cuh"

// witness_put (ffd_scan_common.cuh) over the steps of B problems: thread
// 0's `before` reset in each problem's prologue, then each group's flag
// from the strand count its step wrote
extern "C" void kt_witness(const int* count, const float* unsched,
                           const int* prio, int B, int G, float* out) {
  for (int b = 0; b < B; ++b) {
    int before = WITNESS_BEFORE0;
    for (int g = 0; g < G; ++g) {
      const long i = (long)b * G + g;
      out[i] = witness_step(count[i], (int)unsched[i], prio[i], before)
                   ? 1.0f : 0.0f;
    }
  }
}

extern "C" int kt_before0() { return WITNESS_BEFORE0; }
"""

INT_MIN = -(2 ** 31)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The g++ shim of ffd_witness.cuh, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host shim of ffd_witness.cuh "
                    "cannot be built")
    d = tmp_path_factory.mktemp("witness")
    src, lib = d / "witness_shim.cpp", d / "libwitness_shim.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.kt_witness.argtypes = [P, P, P, I, I, P]
    so.kt_witness.restype = None
    so.kt_before0.restype = I
    return so


def fold(shim, count, unsched, prio):
    """The shim's witness rows [B, G] (0/1 floats) for rows [B, G] (or
    one problem's [G]): count and prio int32, unsched the float32 strand
    row as the step wrote it."""
    count = np.ascontiguousarray(np.atleast_2d(count), np.int32)
    unsched = np.ascontiguousarray(np.atleast_2d(unsched), np.float32)
    prio = np.ascontiguousarray(np.atleast_2d(prio), np.int32)
    B, G = count.shape
    out = np.full((B, G), np.nan, np.float32)
    shim.kt_witness(count.ctypes.data, unsched.ctypes.data, prio.ctypes.data,
                    B, G, out.ctypes.data)
    return out


def plain(count, unsched, prio):
    """`ffd.priority_witness` of one problem's rows, as 0/1 floats."""
    return tffd.priority_witness(
        torch.from_numpy(np.asarray(count, np.int32)),
        torch.from_numpy(np.asarray(unsched, np.float32).astype(np.int32)),
        torch.from_numpy(np.asarray(prio, np.int32))).numpy().astype(
            np.float32)


# (id, count, unsched, prio, the flags ffd.py:1238-1257 gives)
HAND = [
    # the first group: nothing stranded ahead of it, so no flag, unless
    # its priority is below -(2^31)+1
    ("first-group", [5], [0], [7], [0]),
    ("first-group-stranded", [5], [5], [-3], [0]),
    ("first-group-int-min", [5, 4], [0, 0], [INT_MIN, 0], [1, 0]),
    # the test is strict: an equal band after a strand is no inversion
    ("equal-priorities", [4, 3, 5, 2], [4, 1, 0, 0], [7, 7, 7, 6],
     [0, 0, 0, 1]),
    ("negative-priorities", [3, 3, 3, 3, 3], [0, 3, 0, 2, 0],
     [-1, -5, -9, -9, -10], [0, 0, 1, 1, 1]),
    ("int-min-bands", [2, 2, 2], [2, 0, 0], [INT_MIN + 1, INT_MIN, INT_MIN],
     [0, 1, 1]),
    # padding groups (count 0, unsched 0) place nothing: never flagged,
    # and they do not move `before`
    ("padding-groups", [6, 4, 0, 0, 3, 0], [6, 0, 0, 0, 0, 0],
     [9, 5, 0, 0, 2, 0], [0, 1, 0, 0, 1, 0]),
    # a group that stranded part of its pods placed some: it can be
    # flagged itself, and it raises `before` for the groups after it
    ("stranded-placed-some", [8, 6, 5, 4], [3, 2, 0, 0], [9, 5, 5, 1],
     [0, 1, 1, 1]),
    ("stranded-placed-none", [8, 6, 5], [3, 6, 0], [9, 5, 5], [0, 0, 1]),
    # the running max, not the last strand: a lower band stranding later
    # does not lower `before`
    ("running-max", [2, 2, 2, 2], [2, 0, 1, 0], [10, 3, 1, 5],
     [0, 1, 1, 1]),
]


@pytest.mark.parametrize("case", HAND, ids=[c[0] for c in HAND])
def test_fold_on_hand_rows(shim, case):
    _, count, unsched, prio, want = case
    got = fold(shim, count, unsched, prio)[0]
    assert got.tolist() == [float(w) for w in want]
    assert np.array_equal(got, plain(count, unsched, prio))


def test_before_starts_at_the_references_floor(shim):
    assert shim.kt_before0() == -(2 ** 31) + 1


def _random_rows(seed, G):
    """Seeded rows of one problem: bands non-increasing along the groups
    (as the encoder sorts them) from a set with negatives, a share of
    padding groups of count 0, strand counts from 0 to the count."""
    rng = np.random.RandomState(seed)
    real = rng.randint(1, G + 1)
    count = np.zeros(G, np.int32)
    count[:real] = rng.randint(1, 400, real)
    count[:real][rng.rand(real) < 0.1] = 0
    bands = rng.choice([2_000_000_000, 1000, 100, 1, 0, -1, -50,
                        INT_MIN + 1, INT_MIN], size=rng.randint(1, 10))
    prio = np.zeros(G, np.int32)
    prio[:real] = np.sort(rng.choice(bands, real))[::-1]
    mode = rng.rand(G)
    unsched = np.where(mode < 0.3, count, np.where(
        mode < 0.5, (count * rng.rand(G)).astype(np.int32), 0))
    return count, unsched.astype(np.float32), prio


@pytest.mark.parametrize("seed,G", [(1, 8), (2, 16), (3, 64), (4, 128),
                                    (5, 512), (6, 2048), (7, 2048),
                                    (8, 3)])
def test_fold_on_seeded_rows(shim, seed, G):
    count, unsched, prio = _random_rows(seed, G)
    assert np.array_equal(fold(shim, count, unsched, prio)[0],
                          plain(count, unsched, prio))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_fold_resets_before_per_problem(shim, seed):
    """A batch of B = 4: each problem's rows are its own fold's, whatever
    the problems ahead of it stranded.  Problem 0 strands the top band,
    so a `before` carried over would flag every placing group after it."""
    rows = [_random_rows(seed * 10 + b, 64) for b in range(4)]
    rows[0][0][:] = 5
    rows[0][1][:] = 5
    rows[0][2][:] = 2_000_000_000
    count, unsched, prio = (np.stack([r[i] for r in rows])
                            for i in range(3))
    got = fold(shim, count, unsched, prio)
    for b in range(4):
        assert np.array_equal(got[b], plain(*rows[b])), b
    assert not got[0].any()


@pytest.mark.parametrize("case", WITNESS_CASES,
                         ids=[c[0] for c in WITNESS_CASES])
def test_fold_matches_the_jax_program(shim, case):
    """The fold on the JAX program's own strand row gives its witness
    region, and so does the port's plain scan."""
    name, seed, kw = case
    prob, ref, out, u = _witness_case(seed, kw)
    G, E, D = prob[0].shape[0], prob[4].shape[0], prob[8].shape[1]
    r = tffd.unpack(ref, G, E, 64, 6, D, explain=1, with_priority=1)
    got = fold(shim, prob[1], r["unsched"], prob[17])[0]
    assert np.array_equal(got, r["prio_inv"].astype(np.float32)), name
    assert np.array_equal(got, u["prio_inv"].astype(np.float32)), name
    assert np.array_equal(r["unsched"], u["unsched"]), name


def test_fold_matches_the_jax_batch_program(shim):
    """B = 3 priority-band problems through `solve_ffd_batch`: each row's
    witness region is the fold's, `before` reset per problem."""
    probs, cat = random_batch(12, 3, **dict(PRIO, pod_scale=300))
    per = [_jax_args(p, cat, False) + (p[17],) for p in probs]
    axes = jffd._BATCH_AXES + (0,)
    args = [np.stack([a[i] for a in per]) if ax == 0 else per[0][i]
            for i, ax in enumerate(axes)]
    ref = np.asarray(jffd.solve_ffd_batch(*args, max_nodes=64,
                                          zc=cat["zc"], explain=1,
                                          with_priority=1))
    G, E, D = (probs[0][0].shape[0], probs[0][4].shape[0],
               probs[0][8].shape[1])
    rows = [tffd.unpack(ref[b], G, E, 64, 6, D, explain=1, with_priority=1)
            for b in range(len(probs))]
    got = fold(shim, np.stack([p[1] for p in probs]),
               np.stack([r["unsched"] for r in rows]),
               np.stack([p[17] for p in probs]))
    for b, r in enumerate(rows):
        assert np.array_equal(got[b], r["prio_inv"].astype(np.float32)), b
    assert any(r["prio_inv"].any() for r in rows) or all(
        len(set(p[17].tolist())) == 1 for p in probs)


def test_the_witness_counter_applies_to_the_scan():
    """`scan_sections.py` reads the witness's cycles around
    `witness_put`: the counter lands once, inside the instance-gated put,
    with no barrier of its own."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import scan_sections
    with open(os.path.join(CSRC, "ffd_scan_common.cuh")) as f:
        src = f.read()
    assert "priority_witness(" not in src
    out = scan_sections.instrument(src)
    counter = f"g_sections[{scan_sections.WITNESS}]"
    assert out.count(counter) == 1
    put = out[out.index("void witness_put("):]
    put = put[:put.index("\n}\n")]
    assert counter in put and "__syncthreads" not in put
