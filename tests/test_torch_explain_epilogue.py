"""The explain rows of the scans' epilogue, on the CPU.

  * the arithmetic: `karpenter_tpu_torch/csrc/ffd_explain.cuh` is
    `__host__ __device__`; g++ builds it here (`-ffp-contract=off`, IEEE
    float32 without contraction) into a shim that replays the kernel's
    `explain_pack` (`ffd_scan_common.cuh`) a group at a time, its lanes
    one after another (one warp of 32, and the team of warps the kernel
    gives a group at the case's G): each lane's share of the domains, the
    (pool,type) blocks and the map columns, combined as the warps' sums,
    minimum and ballots and the team's sums combine them.  Its explain
    counts, bits and explain=2 class map are held to
    `ffd.pack_reference` (the epilogue's plain version) as uint32,
    group by group, on seeded problems whose scan outputs (dom_placed,
    unsched, num_active) and final pool budgets are drawn directly: ZC 1,
    3 and 6, D from 1 to 128, zone and capacity-type selectors with
    minDomains above and below the populated count, gang rows, a stranded
    pool limit, explain=1 and 2.  It skips when g++ is missing;
  * the wrappers: `solve_ffd_batch` at B=4 with explain=counts makes one
    `batch_scan` call (the explain rows come from its epilogue, no call
    per problem) and its rows equal the JAX program's as uint32;
    `solve_ffd_delta` with explain makes one `delta_scan` call and equals
    the JAX seeded program.
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
from karpenter_tpu_torch.solver.problems import (random_batch,
                                                 random_delta_problem,
                                                 random_problem)
from tests.test_torch_delta import jax_delta
from tests.test_torch_ffd import _jax_args

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "karpenter_tpu_torch", "csrc")

SHIM = r"""
#include "ffd_explain.cuh"

// explain_pack (ffd_scan_common.cuh) for every group of one problem, a
// team of L lanes (one warp, or several) one lane after another: the
// lanes' parts combined as the warps' __reduce_min_sync /
// __reduce_add_sync / __ballot_sync and the team's sums do
#define LANES 32

extern "C" void kt_explain_pack(
    const uint32_t* mask, const float* group_req, const int* group_whole,
    const int* group_gang, const float* pt_alloc, const float* col_daemon,
    const int* col_pool, const float* pool_daemon, const float* limits,
    const float* unsched, float na, int N, const float* dom_placed,
    const int* group_dsel, const int* group_dbase, const int* group_skew,
    const int* group_mindom, const int* group_delig, const int* col_zone,
    const int* col_ct, int G, int PT, int ZC, int P, int D, int W, int L,
    float* ex_counts, float* ex_bits, float* ex_map) {
  const int O = PT * ZC;
  float* room = new float[(size_t)PT * KR];
  for (int i = 0; i < PT * KR; ++i)
    room[i] = block_room(pt_alloc, col_daemon, ZC, i);
  for (int g = 0; g < G; ++g) {
    const float* req = group_req + g * KR;
    const int dsel = group_dsel[g];
    DomWords bw = {0u, 0u, 0u, 0u};
    uint64_t topo_slots = 0ull;
    if (dsel > 0) {
      const int* base = group_dbase + (size_t)g * D;
      const int* elig = group_delig + (size_t)g * D;
      const float* placed = dom_placed + (size_t)g * D;
      int m_elig = 0x7fffffff;
      unsigned pop = 0u;
      for (int lane = 0; lane < LANES; ++lane) {
        const DomPart dp = lane_dom(base, elig, placed, D, lane, LANES);
        m_elig = dp.m_elig < m_elig ? dp.m_elig : m_elig;
        pop += dp.pop;
      }
      const int ceiling = skew_ceiling(m_elig, pop, group_mindom[g],
                                       group_skew[g]);
      for (int k = 0; k < EXPLAIN_DWORDS; ++k) {
        uint32_t word = 0u;
        for (int lane = 0; lane < LANES; ++lane) {
          const int d = 32 * k + lane;
          if (d < D && dom_blocked(base, elig, placed, d, ceiling))
            word |= 1u << lane;
        }
        bw.set(k, word);
      }
      const int* slot_dom = dsel == 1 ? col_zone : col_ct;
      for (int z = 0; z < ZC; ++z)
        if (blocked_in(bw, slot_dom[z], D)) topo_slots |= 1ull << z;
    }
    uint64_t pool_ok = 0ull;
    for (int p = 0; p < P; ++p)
      if (pool_funds(limits, pool_daemon, p, req)) pool_ok |= 1ull << p;
    const uint32_t* row = mask + (size_t)g * W;
    const bool stranded = unsched[g] > 0.0f;
    const bool gang_row = group_gang != nullptr;
    const bool whole = group_whole[g] != 0 || (gang_row && group_gang[g]);
    const int* col_dom = dsel == 1 ? col_zone : col_ct;
    float* map = ex_map ? ex_map + (size_t)g * O : nullptr;
    PackPart c = {0u, 0u, 0u, 0u};
    for (int t = 0; t < L; ++t) {
      const PackPart part = lane_pack(row, PT, ZC, room, col_pool, pool_ok,
                                      topo_slots, req, t, L);
      c.fit += part.fit;
      c.lim += part.lim;
      c.topo += part.topo;
      c.ok += part.ok;
    }
    if (map)
      for (int t = 0; t < L; ++t)
        for (int o = t; o < O; o += L)
          map[o] = (float)map_column(row, o, ZC, room, col_pool, pool_ok,
                                     req, dsel > 0, bw, col_dom, D,
                                     whole && stranded);
    ex_bits[g] = (float)explain_row(c.fit, c.lim, c.topo, c.ok, whole,
                                    gang_row, stranded, na >= (float)N,
                                    ex_counts + (size_t)g * EXPLAIN_C);
  }
  delete[] room;
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The g++ shim of ffd_explain.cuh, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host shim of ffd_explain.cuh "
                    "cannot be built")
    d = tmp_path_factory.mktemp("explain")
    src, lib = d / "explain_shim.cpp", d / "libexplain_shim.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.kt_explain_pack.argtypes = ([P] * 10 + [F, I] + [P] * 8
                                   + [I] * 7 + [P] * 3)
    so.kt_explain_pack.restype = None
    return so


def _case(zc, D, gang, seed):
    """A seeded problem with topology rows, gang rows and a final state
    drawn directly: (problem, catalog, N, flat row (dom_placed, unsched,
    num_active filled), final pool budgets, the layout's D)."""
    rng = np.random.RandomState(7919 * seed + 31 * zc + D)
    PT = 96 if zc == 1 else 64
    prob, cat = random_problem(seed, ZC=zc, PT=PT, P=3, D=D, E=4,
                               limits="mixed")
    p, c = tffd.problem_from_numpy(prob, cat, "cpu")
    G = p.G
    # zone and capacity-type selectors over D domains (a slot's domain id
    # may pass D - 1: the reference's gather clamps it)
    p.group_dsel = torch.from_numpy(
        rng.choice([0, 1, 2], size=G).astype(np.int32))
    p.group_dbase = torch.from_numpy(rng.randint(0, 6, (G, D))
                                     .astype(np.int32))
    p.group_delig = torch.from_numpy((rng.rand(G, D) < 0.8)
                                     .astype(np.int32))
    p.group_skew = torch.from_numpy(rng.choice([1, 2], size=G)
                                    .astype(np.int32))
    # minDomains unset, below and above the populated count
    p.group_mindom = torch.from_numpy(
        rng.choice([0, 1, 2, D, D + 3], size=G).astype(np.int32))
    p.group_whole = torch.from_numpy((rng.rand(G) < 0.3).astype(np.int32))
    p.group_gang = torch.from_numpy(
        ((rng.rand(G) < 0.5) if gang else np.zeros(G, bool))
        .astype(np.int32))
    zone = rng.randint(0, min(D + 1, 9), size=zc)
    ct = rng.randint(0, min(D + 1, 4), size=zc)
    c.col_zone = torch.from_numpy(np.tile(zone, c.PT).astype(np.int32))
    c.col_ct = torch.from_numpy(np.tile(ct, c.PT).astype(np.int32))
    N = 64
    ex = 2
    lay = tffd.flat_layout(G, p.E, N, D, ex, 0, c.O)
    flat = torch.zeros(lay["total"][1])
    tffd._region(flat, lay, "dom_placed").copy_(torch.from_numpy(
        rng.randint(0, 4, G * D).astype(np.float32)))
    tffd._region(flat, lay, "unsched").copy_(torch.from_numpy(
        np.where(rng.rand(G) < 0.5, 0, rng.randint(1, 6, G))
        .astype(np.float32)))
    tffd._region(flat, lay, "num_active").fill_(
        float(N if seed % 2 else N - 3))
    # final budgets: unlimited, drained (the stranded pool limit) or small
    limits = np.where(rng.rand(p.P, tffd.R) < 0.5, np.inf,
                      rng.randint(0, 64, (p.P, tffd.R)) * 250.0)
    limits[0] = 0.0
    return p, c, N, flat, lay, torch.from_numpy(limits.astype(np.float32))


def _team_lanes(G):
    """The lanes of one group's team in the kernel's 32 warps: 32 times
    the largest power of two WPG with G * WPG <= 32."""
    wpg = 1
    while 2 * wpg * G <= 32:
        wpg *= 2
    return 32 * wpg


def _shim_rows(shim, p, c, N, flat, lay, limits, gang, with_map, L=32):
    """The shim's explain rows, a team of L lanes a group: (counts [G, 5],
    bits [G], map [G, O])."""
    G, D = p.G, p.D

    def arr(t, dt):
        return np.ascontiguousarray(t.numpy().astype(dt))

    def ptr(a):
        return None if a is None else a.ctypes.data
    keep = [arr(p.mask_bits, np.int32).view(np.uint32),
            arr(p.group_req, np.float32), arr(p.group_whole, np.int32),
            arr(p.group_gang, np.int32) if gang else None,
            arr(c.pt_alloc, np.float32), arr(c.col_daemon, np.float32),
            arr(c.col_pool, np.int32), arr(c.pool_daemon, np.float32),
            arr(limits, np.float32),
            arr(tffd._region(flat, lay, "unsched"), np.float32)]
    na = float(tffd._region(flat, lay, "num_active")[0])
    topo = [arr(tffd._region(flat, lay, "dom_placed"), np.float32),
            arr(p.group_dsel, np.int32), arr(p.group_dbase, np.int32),
            arr(p.group_skew, np.int32), arr(p.group_mindom, np.int32),
            arr(p.group_delig, np.int32), arr(c.col_zone, np.int32),
            arr(c.col_ct, np.int32)]
    counts = np.full((G, tffd.EXPLAIN_C), np.nan, np.float32)
    bits = np.full(G, np.nan, np.float32)
    emap = np.full((G, c.O), np.nan, np.float32) if with_map else None
    shim.kt_explain_pack(*[ptr(a) for a in keep], na, N,
                         *[ptr(a) for a in topo], G, c.PT, c.zc, p.P, D,
                         c.W, L, ptr(counts), ptr(bits), ptr(emap))
    return counts, bits, emap


EPILOGUE_CASES = [(zc, D, gang, ex) for zc in (1, 3, 6)
                  for D in (1, 4, 37, 128) for gang in (0, 1)
                  for ex in (1, 2)]


@pytest.mark.parametrize(
    "zc,D,gang,ex", EPILOGUE_CASES,
    ids=[f"zc{z}-d{d}-gang{g}-explain{e}" for z, d, g, e in EPILOGUE_CASES])
def test_pack_arithmetic_matches_plain(shim, zc, D, gang, ex):
    """The epilogue's per-group arithmetic (ffd_explain.cuh, as a warp
    runs it and as the kernel's team of warps for this G runs it) against
    `pack_reference`: counts, bits and, with explain=2, the class map,
    group by group, as uint32."""
    p, c, N, flat, lay, limits = _case(zc, D, gang, seed=zc + D + ex)
    if ex == 1:
        lay = {k: v for k, v in lay.items() if k != "explain_map"}
    tffd.pack_reference(p, c, N, flat, lay, limits, gang)
    want_c = tffd._region(flat, lay, "explain_counts").view(
        p.G, tffd.EXPLAIN_C).numpy()
    want_b = tffd._region(flat, lay, "explain_bits").numpy()
    for L in sorted({32, _team_lanes(p.G)}):
        _hold_group_by_group(shim, p, c, N, flat, lay, limits, gang, ex, L,
                             want_c, want_b)
    # the case is not trivial: a fit or limit elimination, and with more
    # than one domain a blocked one somewhere
    assert (want_c[:, :2] > 0).any()
    if D > 1:
        assert (want_c[:, 2] > 0).any() or ex == 2 and (
            tffd._region(flat, lay, "explain_map") == 3).any() or (
            p.group_dsel == 0).all()


def _hold_group_by_group(shim, p, c, N, flat, lay, limits, gang, ex, L,
                         want_c, want_b):
    counts, bits, emap = _shim_rows(shim, p, c, N, flat, lay, limits, gang,
                                    ex == 2, L)
    for g in range(p.G):
        assert np.array_equal(counts[g].view(np.uint32),
                              want_c[g].view(np.uint32)), (g, L, counts[g],
                                                           want_c[g])
        assert bits[g].view(np.uint32) == want_b[g].view(np.uint32), (g, L)
        if ex == 2:
            want_m = tffd._region(flat, lay, "explain_map").view(
                p.G, c.O)[g].numpy()
            assert np.array_equal(emap[g].view(np.uint32),
                                  want_m.view(np.uint32)), (g, L)


def test_pack_cases_cover_every_class(shim):
    """Across the cases, every count class and every map class occurs."""
    seen_c, seen_m = np.zeros(tffd.EXPLAIN_C, bool), set()
    for zc, D, gang, ex in EPILOGUE_CASES:
        if ex != 2:
            continue
        p, c, N, flat, lay, limits = _case(zc, D, gang, seed=zc + D + ex)
        counts, _, emap = _shim_rows(shim, p, c, N, flat, lay, limits, gang,
                                     True)
        seen_c |= (counts > 0).any(axis=0)
        seen_m |= set(np.unique(emap).astype(int).tolist())
    assert seen_c.all(), seen_c
    assert {0, 1, 2, 3, 4} <= seen_m, seen_m


def _count_calls(monkeypatch, names):
    calls = {n: 0 for n in names}
    for n in names:
        def counted(*a, _f=getattr(tffd, n), _n=n, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tffd, n, counted)
    return calls


def test_batch_explain_is_one_scan_call(monkeypatch):
    """`solve_ffd_batch` at B=4 with explain=counts: one `batch_scan` call
    for the four problems and their explain rows (its epilogue's plain
    version once per problem inside it), rows equal to the JAX batched
    program's with explain=1 as uint32."""
    probs, cat = random_batch(3, 4, topology=True, D=4, limits="finite")
    per = [_jax_args(p, cat, False) for p in probs]
    args = [np.stack([a[i] for a in per]) if ax == 0 else per[0][i]
            for i, ax in enumerate(jffd._BATCH_AXES)]
    ref = np.asarray(jffd.solve_ffd_batch(*args, max_nodes=64,
                                          zc=cat["zc"], explain=1))
    calls = _count_calls(monkeypatch, ("batch_scan", "pack_reference"))
    c = tffd.catalog_tensors(cat, "cpu")
    out = tffd.solve_ffd_batch(tffd.batch_tensors(probs, c.O, "cpu"), c, 64,
                               1).numpy()
    assert calls == {"batch_scan": 1, "pack_reference": 4}
    assert np.array_equal(ref.view(np.uint32), out.view(np.uint32))
    G = probs[0][0].shape[0]
    lay = tffd.flat_layout(G, probs[0][4].shape[0], 64, 4, 1)
    assert (tffd._region(torch.from_numpy(out), lay, "explain_counts")
            > 0).any()


def test_delta_explain_is_one_scan_call(monkeypatch):
    """`solve_ffd_delta` with explain: one `delta_scan` call, the counts
    from its epilogue, equal to the JAX seeded program as uint32."""
    prob, cat, seeds = random_delta_problem(2, A=5, A_pad=16, N=64)
    ref = jax_delta(prob, cat, seeds, 64, 1, False)
    calls = _count_calls(monkeypatch, ("delta_scan", "pack_reference"))
    c = tffd.catalog_tensors(cat, "cpu")
    p, s = tffd.delta_tensors(prob, *seeds, c.O, "cpu")
    out = tffd.solve_ffd_delta(p, s, c, 64, explain=1).numpy()
    assert calls == {"delta_scan": 1, "pack_reference": 1}
    assert np.array_equal(ref.view(np.uint32), out.view(np.uint32))


def test_scans_refuse_an_explain_map_they_cannot_write():
    """The seeded scan writes at most the counts: a map is refused before
    any work, as is a map with no counts before it."""
    prob, cat, seeds = random_delta_problem(2, A=5, A_pad=16, N=64)
    c = tffd.catalog_tensors(cat, "cpu")
    p, s = tffd.delta_tensors(prob, *seeds, c.O, "cpu")
    lay = tffd.flat_layout(p.G, p.E, 64, p.D, 2, 0, c.O)
    flat = torch.zeros(lay["total"][1])
    with pytest.raises(ValueError, match="explain=2 has no form"):
        tffd.delta_scan(p, s, c, 64, flat, lay, torch.zeros(p.P, tffd.R))
