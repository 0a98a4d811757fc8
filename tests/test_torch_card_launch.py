"""K7x's launch path on the CPU: `ffd.CardLaunch`, every rank's argument
array built once for a launch configuration and patched per launch, held
field by field to the array `ffd._scan_args` builds for the same launch.

The kernels and `ffd_card_launch` need the cards; what runs here is the
argument arrays, whose device addresses are the CPU tensors' own, on a
mesh of S "cpu" devices (`parallel.card_mesh(["cpu"] * S)`).  Rank 0's
problem rows are card 0's upload; every other rank reads its replica of
that upload, views at the same offsets in a buffer the plan keeps."""

import gc
import weakref

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.parallel import mesh as tmesh
from karpenter_tpu_torch.solver import ffd
from karpenter_tpu_torch.solver.problems import (random_delta_problem,
                                                 random_problem)

torch.set_num_threads(1)

N = 64
IDX = {f: i for i, f in enumerate(ffd.SCAN_FIELDS)}
# the pointers past SCAN_FIELDS: every rank's inbox, then the slot ids
TAIL = ffd.MAX_CARDS + 1


def _reupload(prob, seed=None):
    """The problem (and its seed's rows) as a second upload: the same
    rows in a new buffer, at the same offsets."""
    st = prob.group_req.untyped_storage()
    copy = st.clone()

    def move(t):
        assert t.untyped_storage().data_ptr() == st.data_ptr()
        return torch.empty(0, dtype=t.dtype).set_(
            copy, t.storage_offset(), t.size(), t.stride())
    p = ffd.FFDProblem(**{f: move(getattr(prob, f))
                          for f in prob.__dataclass_fields__})
    if seed is None:
        return p, None
    return p, ffd.DeltaSeed(move(seed.seed_used), move(seed.seed_pool),
                            move(seed.seed_active), seed.seed_colmask)


def _setup(S, kind):
    if kind == "seeded":
        prob, cat, seeds = random_delta_problem(31, A=7, A_pad=16, N=N)
        p, sd, tables, cc, _ = tmesh.shard_problem(
            prob, cat, tmesh.card_mesh(["cpu"] * S), seed=seeds)
        words = tuple(s.seed_colmask for s in sd)
        return p[0], sd[0], words, tables, cc, 0, 0
    gang = kind == "gang"
    kw = {"gang": dict(gang=True, topology=True, D=4),
          "priority": dict(priority=True, P=3, limits="finite"),
          "no-existing": dict(E=0)}[kind]
    prob, cat = random_problem(13 if gang else 14, **kw)
    p, tables, cc, _ = tmesh.shard_problem(prob, cat,
                                           tmesh.card_mesh(["cpu"] * S))
    return p[0], None, None, tables, cc, int(gang), int(len(prob) > 17)


def _outputs(p, lay):
    return (torch.empty(lay["total"][1]), torch.empty((p.P, ffd.R)))


def _want(plan, r, prob, seed, words, tables, cc, lay, wg, flat, lim):
    """What `_scan_args` builds for rank r of this launch: rank 0 on the
    launch's rows and outputs, rank r > 0 on its replica and its own
    outputs (the plan's); then the inboxes, the slot ids and the dims."""
    p_r = prob if r == 0 else plan.problems[r]
    s_r = seed if r == 0 else plan.seeds[r]
    entry, inputs, mesh, A = ffd._sharded_launch_args(
        p_r, tables[r][None], cc.shard(r), lay, wg,
        ffd._rank_seed(s_r, None if words is None else words[r]))
    mesh.update(S=cc.S, reps=1)
    fl, lm = (flat, lim) if r == 0 else plan._keep[r][1:]
    ptrs, dims, _ = ffd._scan_args(entry, 1, prob.G, prob.E, N, prob.P,
                                   prob.D, 0, cc.shard(r), fl, lay, lm, 0,
                                   inputs, A, mesh)
    ptrs += plan.xch.addresses() + [cc.slot_ids[r].data_ptr()]
    return ptrs, dims + [r, 0, 0]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("kind", ["priority", "gang", "seeded",
                                  "no-existing"])
def test_the_patched_array_is_the_launch_array(S, kind):
    """A CardLaunch built at one launch and patched for the next gives,
    rank by rank and field by field, the array `_scan_args` builds for
    that launch; the carry's scratch is the plan's own, so only whether
    each carry field is set is compared."""
    prob, seed, words, tables, cc, wg, wp = _setup(S, kind)
    lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, 1, with_priority=wp)
    f0, l0 = _outputs(prob, lay)
    plan = ffd.CardLaunch(prob, tables, cc, N, lay, wg, seed, words, f0,
                             l0)
    assert plan.entry == {"priority": "ffd_card_scan",
                          "gang": "ffd_card_gang_scan",
                          "seeded": "ffd_card_delta_scan",
                          "no-existing": "ffd_card_scan"}[kind]
    # the replica holds the upload's rows back to back, and only them (an
    # empty row has no address)
    rows = [getattr(prob, f) for f in prob.__dataclass_fields__] + (
        [] if seed is None else [seed.seed_used, seed.seed_pool,
                                 seed.seed_active])
    assert plan.replicas[1].numel() == sum(
        t.numel() * t.element_size() for t in rows)
    assert (kind == "no-existing") == (prob.exist_remaining.numel() == 0)
    p2, s2 = _reupload(prob, seed)
    assert p2.group_req.data_ptr() != prob.group_req.data_ptr()
    flat, lim = _outputs(prob, lay)
    plan.patch(p2, s2, tables, words, flat, lim)
    assert plan.ptrs[0] == min(p2.group_req.data_ptr(),
                               p2.mask_bits.data_ptr())
    assert list(plan.dims[:3]) == [S, ffd._CARD_INSTANCE[plan.entry],
                                   plan.replicas[1].numel()]
    for r in range(S):
        got, dims = plan.rank_args(r)
        want, want_dims = _want(plan, r, p2, s2, words, tables, cc, lay,
                                wg, flat, lim)
        assert dims == want_dims
        assert len(got) == len(want) == len(ffd.SCAN_FIELDS) + TAIL
        for name, g, w in zip(ffd.SCAN_FIELDS, got, want):
            if name in ffd.CARRY_FIELDS + ("xslot",):
                assert (g != 0) == (w != 0), (r, name)
            else:
                assert g == w, (r, name)
        assert got[len(ffd.SCAN_FIELDS):] == want[len(ffd.SCAN_FIELDS):]
        # each rank reads its own card's shard and table
        assert got[IDX["mask_bits"]] == tables[r].data_ptr()
        assert got[IDX["col_alloc"]] == cc.col_alloc[r].data_ptr()


@pytest.mark.parametrize("kind", ["priority", "seeded"])
def test_ranks_keep_their_scratch_and_rank0_writes_the_callers_row(kind):
    """Across launches every rank past 0 keeps its flat row, budgets,
    carry and replica; rank 0's outputs are each launch's caller's; every
    rank past 0 reads its replica, at the upload's offsets."""
    S = 4
    prob, seed, words, tables, cc, wg, wp = _setup(S, kind)
    lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, 1, with_priority=wp)
    plan = ffd.CardLaunch(prob, tables, cc, N, lay, wg, seed, words,
                             *_outputs(prob, lay))
    before = [plan.rank_args(r)[0] for r in range(S)]
    runs = []
    for _ in range(3):
        p2, s2 = _reupload(prob, seed)
        flat, lim = _outputs(prob, lay)
        plan.patch(p2, s2, tables, words, flat, lim)
        runs.append((p2, flat, lim, plan.ptrs[0],
                     [plan.rank_args(r)[0] for r in range(S)]))
    outputs = [f for f, name in ffd.SCAN_REGIONS if name in lay] + [
        "limits", "row0"]
    scratch = list(ffd.CARRY_FIELDS) + ["xslot"] + outputs
    for p2, flat, lim, lo, arrays in runs:
        a0 = arrays[0]
        assert a0[IDX["row0"]] == flat.data_ptr()
        assert a0[IDX["limits"]] == lim.data_ptr()
        assert a0[IDX["unsched"]] == flat.data_ptr() + 4 * lay["unsched"][0]
        assert a0[IDX["group_req"]] == p2.group_req.data_ptr()
        assert a0[IDX["mask_rows"]] == p2.mask_bits.data_ptr()
        for f in ffd.CARRY_FIELDS + ("xslot",):
            assert a0[IDX[f]] == before[0][IDX[f]], f
        for r in range(1, S):
            for f in scratch + ["group_req", "mask_rows", "exist_cap"]:
                assert arrays[r][IDX[f]] == before[r][IDX[f]], (r, f)
            rep = plan.replicas[r]
            for f, attr in (("group_req", "group_req"),
                            ("mask_rows", "mask_bits"),
                            ("pool_limit", "pool_limit")):
                off = getattr(p2, attr).data_ptr() - lo
                assert arrays[r][IDX[f]] == rep.data_ptr() + off, (r, f)
            if seed is not None:
                assert arrays[r][IDX["seed_colmask"]] == \
                    words[r].data_ptr()


def test_a_plan_serves_only_its_configuration():
    """card_scan takes a plan only for the launch statics and the catalog
    it was built for; any other is refused before anything launches."""
    prob, seed, words, tables, cc, wg, wp = _setup(2, "priority")
    lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, 1, with_priority=wp)
    plan = ffd.CardLaunch(prob, tables, cc, N, lay, wg, seed, words,
                          *_outputs(prob, lay))
    assert plan.xch is ffd.card_exchange(cc.devices)
    flat, lim = _outputs(prob, lay)
    # the CPU runs the plain version, and returns no plan
    assert ffd.card_scan(prob, tables, cc, N, flat, lay, lim, wg,
                         plan=plan) is None
    lay0 = ffd.flat_layout(prob.G, prob.E, N, prob.D, 0, with_priority=wp)
    f0, l0 = _outputs(prob, lay0)
    with pytest.raises(ValueError, match="another launch"):
        ffd.card_scan(prob, tables, cc, N, f0, lay0, l0, wg, plan=plan)
    tables2, cc2 = _setup(2, "priority")[3:5]
    with pytest.raises(ValueError, match="another launch"):
        ffd.card_scan(prob, tables2, cc2, N, flat, lay, lim, wg, plan=plan)


def test_the_plan_keeps_no_buffer_of_the_callers():
    """Rank 0's rows and outputs are each launch's own: once the caller
    drops them, nothing of the plan holds them."""
    prob, seed, words, tables, cc, wg, wp = _setup(4, "seeded")
    lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, 1, with_priority=wp)
    flat, lim = _outputs(prob, lay)
    p2, s2 = _reupload(prob, seed)
    plan = ffd.CardLaunch(p2, tables, cc, N, lay, wg, s2, words, flat, lim)
    held = [weakref.ref(t) for t in (flat, lim, p2.group_req,
                                     s2.seed_used)]
    del flat, lim, p2, s2
    gc.collect()
    assert all(w() is None for w in held)
    assert plan.problems[0] is None and plan.seeds[0] is None
    assert all(p is not None for p in plan.problems[1:])


def test_the_executor_holds_one_plan_a_configuration(monkeypatch):
    """Across cards each launch configuration keeps the plan its first
    launch built and hands it to every later launch; a new resident
    catalog gets a new plan in its place."""
    prob, seed, words, tables, cc, wg, wp = _setup(2, "priority")
    cc2 = _setup(2, "priority")[4]
    ex = tmesh.MeshExecutor(tmesh.card_mesh(["cpu"] * 2))
    handed = []

    class Plan:
        def __init__(self, cat):
            self.cat = cat

    def card_scan(prob, table, cat, N, flat, lay, lim, wg=0, seed=None,
                  plan=None):
        handed.append(plan)
        return plan if plan is not None else Plan(cat)
    monkeypatch.setattr(ffd, "card_scan", card_scan)
    lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, 1, with_priority=wp)
    cfg = {"lay": lay}
    for _ in range(3):
        ex._launch(cfg, prob, tables, cc, N, wg)
    first = cfg["plan"]
    assert handed == [None, first, first] and first.cat is cc
    ex._launch(cfg, prob, tables, cc2, N, wg)
    assert handed[-1] is None and cfg["plan"].cat is cc2


def test_rows_laid_out_otherwise_are_refused():
    """A launch whose rows do not sit at the configuration's offsets from
    the upload's start would point the replicas at the wrong bytes: it is
    refused before anything launches."""
    prob, seed, words, tables, cc, wg, wp = _setup(2, "priority")
    lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, 1, with_priority=wp)
    plan = ffd.CardLaunch(prob, tables, cc, N, lay, wg, seed, words,
                             *_outputs(prob, lay))
    moved = ffd.FFDProblem(**{f: getattr(prob, f).clone()
                              for f in prob.__dataclass_fields__})
    with pytest.raises(ValueError, match="laid out"):
        plan.patch(moved, None, tables, words, *_outputs(prob, lay))


def test_the_slot_ids_are_shard_0s_leading_block():
    """Every card holds shard 0's leading grid-slot block (the reference's
    all_gather(...)[0]): its zones, then its capacity types."""
    prob, cat = random_problem(12, topology=True, D=4)
    _, _, cc, _ = tmesh.shard_problem(prob, cat,
                                      tmesh.card_mesh(["cpu"] * 4))
    zc = cc.zc
    want = np.concatenate([np.asarray(cat["col_zone"])[:zc],
                           np.asarray(cat["col_ct"])[:zc]]).astype(np.int32)
    assert len(cc.slot_ids) == 4
    for r, t in enumerate(cc.slot_ids):
        assert t.device == cc.devices[r] and t.dtype == torch.int32
        assert np.array_equal(t.numpy(), want)
        assert torch.equal(t[:zc], cc.col_zone[0][:zc])
        assert torch.equal(t[zc:], cc.col_ct[0][:zc])
