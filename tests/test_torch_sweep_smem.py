"""K4's launch path on the CPU: where its carry lives (the shared-memory
budget mirrored from csrc), and the argument array a sweep builds once and
each chunk patches (`ffd.SweepLaunch`), held field by field to the array
`ffd._scan_args` builds for the same launch.

The kernels need the card; what runs here is the shape arithmetic and the
argument arrays, whose device addresses are the CPU tensors' own."""

import os
import re

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.solver import TorchSolver, ffd
from karpenter_tpu_torch.solver.problems import random_sweep

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(ffd.__file__), os.pardir, "csrc")
H100_BLOCK_SMEM = 227 * 1024  # shared memory a block may hold on the H100


def _define(name: str) -> str:
    with open(os.path.join(CSRC, "ffd_scan_common.cuh")) as f:
        m = re.search(rf"^#define {name} (.+)$", f.read(), re.M)
    assert m, name
    return m.group(1).strip()


def test_the_mirror_constants_are_the_kernels():
    assert eval(_define("SWEEP_SMEM_BUDGET")) == ffd.SWEEP_SMEM_BUDGET
    assert int(_define("NT")) == 1024
    assert ffd.SWEEP_SMEM_BUDGET < H100_BLOCK_SMEM


def _shape(sw, cat, N, K):
    return dict(G=sw.G, E=sw.E, N=N, PT=cat.PT, ZC=cat.zc, P=sw.P,
                D=sw.D if sw.heavy else 1, W=cat.W, K=K, heavy=sw.heavy)


def _fits(shape):
    return ffd.sweep_carry_fits(**shape)


def _smem(shape):
    s = dict(shape)
    heavy = s.pop("heavy")
    return ffd.scan_smem(**s, topo=heavy, sweep=True, carry=True)


@pytest.fixture(scope="module")
def config4_chunks():
    """Every K4 chunk shape config #4 and #4b launch, as solve_batch
    launches them on the CPU (full scale, 2,000 simulations each)."""
    seen = []
    real = ffd.solve_ffd_sweep

    def spy(sw, cat, n, k=0):
        seen.append(_shape(sw, cat, n, k))
        return real(sw, cat, n, k)

    ffd.solve_ffd_sweep = spy
    try:
        for build in (workloads.build_config4, workloads.build_config4b):
            TorchSolver(device="cpu").solve_batch(build(), max_nodes=8)
    finally:
        ffd.solve_ffd_sweep = real
    return seen


def test_config4_sweeps_take_the_shared_memory_carry(config4_chunks):
    lanes = {s["heavy"] for s in config4_chunks}
    assert lanes == {False, True}
    for shape in config4_chunks:
        assert shape["E"] == 2048 and shape["N"] == 8
        assert _fits(shape), shape
        assert _smem(shape) <= ffd.SWEEP_SMEM_BUDGET < H100_BLOCK_SMEM
    # and an N whose column words outgrow the budget takes device memory
    for shape in config4_chunks:
        assert not _fits(dict(shape, N=1024)), shape


@pytest.fixture(scope="module")
def loop_shapes():
    """The K4 chunk shapes of the disruption loop (phase 19's), captured
    from a 40-node loop's first two waves on the CPU: its catalog, pools
    and node slots; the loop at full scale differs in E."""
    seen = []
    real = ffd.solve_ffd_sweep

    def spy(sw, cat, n, k=0):
        seen.append(_shape(sw, cat, n, k))
        return real(sw, cat, n, k)

    ffd.solve_ffd_sweep = spy
    try:
        env = workloads.disruption_loop(40, device="cpu")
        waves = workloads.DisruptionWaves(env)
        waves.wave1()
        waves.wave2()
    finally:
        ffd.solve_ffd_sweep = real
    assert seen
    return seen


@pytest.mark.parametrize("E", [128, 256, 512, 1024, 2048])
def test_disruption_loop_sweeps_take_the_shared_memory_carry(loop_shapes, E):
    for shape in loop_shapes:
        for K in (0, 8):
            s = dict(shape, E=E, K=K)
            assert _fits(s), s
            assert _smem(s) <= ffd.SWEEP_SMEM_BUDGET


def test_the_budget_is_the_whole_block():
    """The route's arithmetic: the scan's own arrays, then the carry from
    a 16-byte boundary; one byte past the budget is the device route."""
    s = dict(G=1, E=2048, N=8, PT=640, ZC=6, P=2, D=1, W=120, K=8,
             heavy=False)
    base = ffd.scan_smem(1, 2048, 8, 640, 6, 2, 1, 120, 8, topo=False,
                         sweep=True)
    carry = _smem(s)
    R = ffd.R
    assert carry == (-(-base // 16) * 16) + 4 * (
        2048 * R + 2048 + 1 * 2048 + 8 * R + 8 * 120 + 4 * 8 + 2 * R)
    n = 8
    while _fits(dict(s, N=n)):
        n += 1
    assert _smem(dict(s, N=n)) > ffd.SWEEP_SMEM_BUDGET
    assert _smem(dict(s, N=n - 1)) <= ffd.SWEEP_SMEM_BUDGET


def _sweep(seed, B, heavy, **kw):
    rows, shared, cat = random_sweep(seed, B, heavy=heavy, **kw)
    c = ffd.catalog_tensors(cat, "cpu")
    sh = ffd.sweep_shared_tensors(shared, c.O, "cpu")
    return rows, sh, c


def _chunk(rows, sh, lo, hi):
    return ffd.sweep_tensors({k: np.asarray(v)[lo:hi]
                              for k, v in rows.items()}, sh, "cpu")


def _outputs(sw, N, K):
    lay = ffd.flat_layout(sw.G, sw.E, N, sw.D, 0, K)
    return (lay, torch.empty((sw.B, lay["total"][1])),
            torch.empty((sw.B, sw.P, ffd.R)))


@pytest.mark.parametrize("heavy", [False, True], ids=["light", "heavy"])
@pytest.mark.parametrize("N", [8, 4096], ids=["shared-carry",
                                              "device-carry"])
@pytest.mark.parametrize("K", [0, 8], ids=["dense", "compacted"])
def test_the_patched_array_is_the_launch_array(heavy, N, K):
    """A SweepLaunch built at one chunk and patched for the next gives,
    field by field, the array `_scan_args` builds for that chunk; the
    carry's scratch (device route) is the chunk's own, so only whether
    each carry field is set is compared there."""
    rows, sh, c = _sweep(5, 10, heavy, E=256, X=2)
    plan = ffd.SweepLaunch.of(sh, c, N, K)
    entry = ffd.SWEEP_ENTRIES[heavy]
    first = _chunk(rows, sh, 0, 6)
    lay0, f0, l0 = _outputs(first, N, K)
    plan.args(first, f0, lay0, l0)
    for lo, hi in ((6, 10), (0, 6)):
        sw = _chunk(rows, sh, lo, hi)
        lay, flat, lim = _outputs(sw, N, K)
        got, dims, _ = plan.args(sw, flat, lay, lim)
        want, want_dims, _ = ffd._scan_args(
            entry, sw.B, sw.G, sw.E, N, sw.P, sw.D if heavy else 1, sw.X,
            c, flat, lay, lim, K, ffd._sweep_inputs(sw))
        assert dims == want_dims
        assert len(got) == len(want) == len(ffd.SCAN_FIELDS)
        fits = _fits(_shape(sw, c, N, K))
        assert fits == (N == 8)
        for name, g, w in zip(ffd.SCAN_FIELDS, got, want):
            if name in ffd.CARRY_FIELDS:
                assert (g != 0) == (w != 0), name
                assert fits == (g == 0) or (name == "te_dense" and K == 0)
            else:
                assert g == w, name
        # the chunk's rows and outputs are its own
        idx = {f: i for i, f in enumerate(ffd.SCAN_FIELDS)}
        assert got[idx["group_req"]] == sw.group_req.data_ptr()
        assert got[idx["limits"]] == lim.data_ptr()
        assert got[idx["unsched"]] == (flat.data_ptr()
                                       + 4 * lay["unsched"][0])
        assert dims[9] == sw.B


def test_the_snapshot_holds_its_plan():
    rows, sh, c = _sweep(7, 4, False)
    plan = ffd.SweepLaunch.of(sh, c, 8, 0)
    assert ffd.SweepLaunch.of(sh, c, 8, 0) is plan
    assert plan.shared is sh
    other = ffd.SweepLaunch.of(sh, c, 16, 0)
    assert other is not plan and ffd.SweepLaunch.of(sh, c, 16, 0) is other
    _, sh2, _ = _sweep(7, 4, False)
    assert ffd.SweepLaunch.of(sh2, c, 16, 0) is not other


def test_a_chunk_of_another_sweep_is_refused():
    """The wrappers check each chunk's own rows; a chunk whose rows do not
    match its snapshot's lane fails before anything launches."""
    rows, sh, c = _sweep(3, 4, True)
    sw = _chunk(rows, sh, 0, 4)
    lay, flat, lim = _outputs(sw, 8, 0)
    with pytest.raises(ValueError, match="topology rows"):
        ffd.sweep_scan(sw, c, 8, flat, lay, lim)
    bad = ffd.SweepBatch(**{**{f: getattr(sw, f) for f in (
        "group_req", "group_count", "group_class", "exclude_idx",
        "price_cap", "pool_limit", "shared")},
        "group_ncap": sw.group_ncap, "group_dsel": sw.group_dsel,
        "group_dbase": sw.group_dbase, "group_dcap": sw.group_dcap,
        "group_skew": sw.group_skew, "group_mindom": sw.group_mindom,
        "group_delig": sw.group_delig[:, :, :1].contiguous()})
    with pytest.raises(ValueError, match="group_dcap|group_delig"):
        ffd.sweep_topo_scan(bad, c, 8, flat, lay, lim)


def test_the_section_counters_apply_to_the_scan():
    """`scan_sections.py` instruments the scan's source by its anchors
    (the light step's, the heavy step's and the kernel's sections): every
    anchor is in the source."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import scan_sections
    with open(os.path.join(CSRC, "ffd_scan_common.cuh")) as f:
        src = f.read()
    out = scan_sections.instrument(src)
    assert out.count("SECTION(") == len(scan_sections.SECTIONS) + 1
    for k in range(len(scan_sections.SECTIONS)):
        assert f"SECTION({k});" in out, k
