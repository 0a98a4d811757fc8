"""The port's FFD scan and result pack against the JAX kernel.

The same seeded problem (numpy, `karpenter_tpu_torch.solver.problems`)
goes through the JAX package's `ffd.solve_ffd` on the CPU and through the
port's `ffd.solve_ffd` on the CPU (the batched scan at B=1), where its
wrappers run the plain PyTorch versions of the CUDA kernels.  The flat result buffers must be
equal as uint32: the tolerance is bit-exact, because every float in these
problems is integer-valued (millicores, MiB, counts) and both sides
perform the same IEEE float32 operations in the same order.  The CUDA
kernels are held to the same plain versions, bit for bit, on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.problems import random_problem, random_sweep


def _jax_args(prob, cat, packed):
    gm = prob[2]
    if packed:
        gm = np.packbits(gm, axis=-1, bitorder="little")
    return (prob[0], prob[1], gm, prob[3], prob[4],
            cat["col_alloc"], cat["col_daemon"], cat["pt_alloc"],
            cat["col_pool"], cat["pool_daemon"], prob[5], prob[6],
            prob[7], prob[8], prob[9], prob[10], prob[11], prob[12],
            prob[13], prob[14], cat["col_zone"], cat["col_ct"], prob[15],
            prob[16])


# (id, seed, problem kwargs, N, explain, mask_packed)
CASES = [
    ("base", 1, dict(), 64, 1, False),
    ("explain-off", 2, dict(), 64, 0, False),
    ("packed-mask", 3, dict(), 64, 1, True),
    ("packed-explain-off", 1, dict(), 64, 0, True),
    ("no-existing", 2, dict(E=0), 64, 1, False),
    ("one-pool-unlimited", 3, dict(P=1, limits="none"), 64, 1, False),
    ("three-pools-finite", 1, dict(P=3, limits="finite"), 64, 1, False),
    ("three-pools-mixed", 2, dict(P=3, limits="mixed"), 64, 1, False),
    ("whole-node", 6, dict(whole=True, pod_scale=12), 64, 1, False),
    ("slot-exhaustion", 5, dict(P=1, limits="none", pod_scale=300), 16,
     1, False),
    ("slot-exhaustion-finite", 14, dict(P=2, limits="finite",
                                        pod_scale=300), 16, 1, False),
    ("small-groups", 3, dict(pod_scale=20), 64, 1, False),
    ("small-groups-explain-off", 5, dict(pod_scale=20), 64, 0, False),
    ("wide-fan-out", 2, dict(pod_scale=400), 64, 1, False),
    ("wide-fan-out-packed", 3, dict(pod_scale=400), 64, 1, True),
    ("dense-layout-zc1", 1, dict(PT=384, ZC=1, pad_blocks=40), 64, 1,
     False),
]


def _solve_both(kw, seed, N, ex, packed):
    prob, cat = random_problem(seed, **kw)
    ref = np.asarray(jffd.solve_ffd(
        *_jax_args(prob, cat, packed), max_nodes=N, zc=cat["zc"],
        explain=ex, mask_packed=packed, with_topology=False))
    p, c = tffd.problem_from_numpy(prob, cat, "cpu")
    out = tffd.solve_ffd(p, c, N, explain=ex)
    return prob, ref, out.numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scan_and_pack_match_jax_bitwise(case):
    name, seed, kw, N, ex, packed = case
    prob, ref, out = _solve_both(kw, seed, N, ex, packed)
    assert out.dtype == np.float32 and out.shape == ref.shape
    differ = np.nonzero(ref.view(np.uint32) != out.view(np.uint32))[0]
    assert differ.size == 0, (name, differ[:10], ref[differ[:10]],
                              out[differ[:10]])
    # the case exercises what its name claims
    G, E = prob[0].shape[0], prob[4].shape[0]
    u = tffd.unpack(out, G, E, N, 6, prob[8].shape[1], explain=ex)
    if name.startswith("slot-exhaustion"):
        assert u["num_active"] == N and u["unsched"].sum() > 0
    if name.startswith("wide-fan-out"):
        # some group spreads over more than 8 new nodes
        assert ((u["take_new"] > 0).sum(axis=1) > 8).any()
    if name == "base":
        assert u["take_exist"].any() and u["take_new"].any()
    if name.startswith("small-groups"):
        assert u["take_new"].any()
    if name == "whole-node":
        whole = prob[13]
        assert (u["take_new"][whole].sum()
                + u["take_exist"][whole].sum()) > 0


def test_unpack_matches_reference_unpack():
    """The port's unpack names the reference's arrays, equal; the
    reference's one other key is its compaction's overflow flag, False
    on the dense layout the port keeps."""
    prob, ref, out = _solve_both(dict(pod_scale=400), 3, 64, 1, False)
    G, E, D = prob[0].shape[0], prob[4].shape[0], prob[8].shape[1]
    a = jffd.unpack(ref, G, E, 64, 6, D, explain=1)
    b = tffd.unpack(out, G, E, 64, 6, D, explain=1)
    assert set(a) - set(b) == {"new_overflow"} and not a["new_overflow"]
    for k in b:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_mask_bits_are_the_packed_mask():
    rng = np.random.RandomState(0)
    mask = rng.rand(5, 83) < 0.4
    words = tffd.pack_mask_bits(mask, 83)
    assert words.shape == (5, 3) and words.dtype == np.int32
    back = tffd._unpack_bits(torch.from_numpy(words), 83).numpy()
    assert np.array_equal(back, mask)
    packed = np.packbits(mask, axis=-1, bitorder="little")
    assert np.array_equal(tffd.pack_mask_bits(packed, 83), words)


@pytest.mark.parametrize("slot,value,match", [
    (7, np.ones(8, np.int32), "domain"),
    (14, np.ones(8, bool), "gang"),
    (7, np.ones(8, np.int32), "routes-to-K3"),
])
def test_light_scan_rejects_other_branches(slot, value, match,
                                           monkeypatch):
    """The one light-only scan left, K4's light lane, refuses a batch with
    domain rows; a problem with a domain group goes through the one
    problem scan (K5, heavy step traced); gang rows run the gang fill only
    under with_gang (K5's gang instance) and are the gang-free program's
    rows without it, as the reference's static."""
    prob, cat = random_problem(1)
    prob = prob[:slot] + (value,) + prob[slot + 1:]
    if match == "gang":
        p, c = tffd.problem_from_numpy(prob, cat, "cpu")
        assert bool(p.group_gang.all())
        for wg in (0, 1):
            out = tffd.solve_ffd(p, c, 64, explain=1, with_gang=wg).numpy()
            ref = np.asarray(jffd.solve_ffd(
                *_jax_args(prob, cat, False), max_nodes=64, zc=cat["zc"],
                explain=1, with_gang=wg))
            assert np.array_equal(ref.view(np.uint32), out.view(np.uint32))
        return
    p, c = tffd.problem_from_numpy(prob, cat, "cpu")
    assert (p.group_dsel > 0).any()
    if match == "domain":
        rows, shared, scat = random_sweep(1, 2, heavy=True)
        c = tffd.catalog_tensors(scat, "cpu")
        sw = tffd.sweep_tensors(rows, tffd.sweep_shared_tensors(
            shared, c.O, "cpu"), "cpu")
        lay = tffd.flat_layout(sw.G, sw.E, 8, sw.D)
        flat = torch.zeros(2, lay["total"][1])
        with pytest.raises(ValueError, match="heavy lane"):
            tffd.sweep_scan(sw, c, 8, flat, lay, torch.zeros(2, sw.P, 6))
        return
    calls = []
    real = tffd.batch_scan

    def spy(*args):
        calls.append("batch_scan")
        return real(*args)

    monkeypatch.setattr(tffd, "batch_scan", spy)
    out = tffd.solve_ffd(p, c, 64, explain=1).numpy()
    assert calls == ["batch_scan"]
    ref = np.asarray(jffd.solve_ffd(*_jax_args(prob, cat, False),
                                    max_nodes=64, zc=cat["zc"], explain=1))
    assert np.array_equal(ref.view(np.uint32), out.view(np.uint32))


def test_light_scan_rejects_priority_slot():
    """The 18-slot priority-band form is taken: its group_prio row feeds
    the priority witness, the last region of the flat row, as the
    reference's with_priority program writes it; a tuple of any other
    length is refused."""
    prob, cat = random_problem(1)
    prio = np.array([5, 5, 9, 1, 1, 0, 7, 0], np.int32)
    p, c = tffd.problem_from_numpy(prob + (prio,), cat, "cpu")
    assert p.group_prio.tolist() == prio.tolist()
    out = tffd.solve_ffd(p, c, 64, explain=1, with_priority=1).numpy()
    ref = np.asarray(jffd.solve_ffd(
        *_jax_args(prob, cat, False), prio, max_nodes=64, zc=cat["zc"],
        explain=1, with_priority=1))
    assert np.array_equal(ref.view(np.uint32), out.view(np.uint32))
    with pytest.raises(ValueError, match="17 or 18 slots"):
        tffd.problem_from_numpy(prob[:16], cat, "cpu")


def test_wrapper_checks_arguments():
    prob, cat = random_problem(2)
    p, c = tffd.problem_from_numpy(prob, cat, "cpu")
    b = tffd.FFDBatch.of(p)
    lay = tffd.flat_layout(p.G, p.E, 64, p.D)
    flat = torch.zeros(1, lay["total"][1])
    with pytest.raises(ValueError, match="limits_out"):
        tffd.batch_scan(b, c, 64, flat, lay, torch.zeros(1, p.P, 5))
    with pytest.raises(ValueError, match="flat"):
        tffd.batch_scan(b, c, 64, flat[:, :-1], lay, torch.zeros(1, p.P, 6))
    with pytest.raises(ValueError, match="sparse_k"):
        tffd.batch_scan(b, c, 64, flat, lay, torch.zeros(1, p.P, 6),
                        sparse_k=8)
    # the explain rows are the scan's own (its epilogue): a layout whose
    # class map has no counts before it is refused before any launch
    no_counts = dict(lay, explain_map=(lay["total"][1], p.G * c.O))
    with pytest.raises(ValueError, match="explain"):
        tffd.batch_scan(b, c, 64, flat, no_counts, torch.zeros(1, p.P, 6))
    b.group_count = b.group_count.to(torch.int64)
    with pytest.raises(ValueError, match="group_count"):
        tffd.batch_scan(b, c, 64, flat, lay, torch.zeros(1, p.P, 6))


def test_plain_scan_work_count():
    """The plain scan's optional work count (chip_smoke.py's operation
    bound for the scan kernels) leaves its outputs unchanged, counts exactly the
    empty-node fits on a one-group problem, and stays under the dense
    count of every node against every (pool,type) block."""
    def run(prob, cat, work):
        p, c = tffd.problem_from_numpy(prob, cat, "cpu")
        lay = tffd.flat_layout(p.G, p.E, 64, p.D)
        flat = torch.zeros(1, lay["total"][1])
        lim = torch.zeros(1, p.P, tffd.R)
        tffd.batch_scan_reference(tffd.FFDBatch.of(p), c, 64, flat, lay,
                                  lim, work=work)
        return p, c, flat.numpy().view(np.uint32)

    prob, cat = random_problem(3)
    work = {"fit": 0, "test": 0, "flops": 0}
    p, c, with_work = run(prob, cat, work)
    assert np.array_equal(with_work, run(prob, cat, None)[2])
    G, E, P, PT = p.G, p.E, p.P, c.PT
    admitted = int(prob[2].sum())
    assert admitted + G * (E + 4 * P) < work["fit"] \
        <= G * (E + 4 * P + c.O + 64 * PT)
    assert G * P < work["test"] <= G * (P + 2 * 64 * PT)

    # slots 4, 5, 15 and 16 are per existing node or per pool
    one = tuple(a if i in (4, 5, 15, 16) else a[:1]
                for i, a in enumerate(prob))
    work1 = {"fit": 0, "test": 0, "flops": 0}
    run(one, cat, work1)
    assert work1["fit"] == E + 4 * P + int(one[2][0].sum())
