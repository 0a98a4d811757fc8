"""The column-sharded solve across cards (K7x, the cards form) on the CPU.

A mesh of S "cpu" devices (`parallel.card_mesh(["cpu"] * S)`) takes the
cards form end to end — shard r of the catalog, of the mask-row table and
of the seed words in its own tensors, one problem replica a rank, the
card-0 gather of the full width for the unsharded paths — with
`ffd.card_scan` running its plain version on the shards stacked.

Kernel level: `ffd.sharded_solve_ffd`/`sharded_delta_ffd` in the cards
form at S = 2 and 4 equal the JAX package's `shard_map` programs on the
first S of the 8 host CPU devices that `tests/conftest.py` forces —
`MeshExecutor.solve` (ffd.py:1372) and `solve_delta` (:1446) — as uint32
views of the flat rows, on `tests/test_torch_mesh.py`'s KERNEL_CASES.
Solve level: `TorchSolver(device="cpu", mesh=<cards Mesh>)` equals
`TPUSolver(mesh=S)` on the mesh scenarios (`canon`: claims, assignments,
reason codes, the price as a float hex).  Then residency read from
`MeshExecutor.transfers`, and the resolution rule `resolve_mesh` as a
pure function of (spec, card count, peer matrix, device).
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from karpenter_tpu.parallel import mesh as jmesh
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.parallel import mesh as tmesh
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.problems import (random_delta_problem,
                                                 random_problem)
from tests.test_torch_mesh import (JAX_SCENARIOS, KERNEL_CASES,
                                   PORT_SCENARIOS)
from tests.test_torch_solve import canon
from tests.test_torch_sweep import to_port

N = 64
SIZES = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_cards(S):
    return tmesh.card_mesh(["cpu"] * S)


# -- the kernel ---------------------------------------------------------------
def _jax_resident(S, prob, cat, ex_, wg, seeds=None):
    """The reference's resident program (or its seeded form) under
    shard_map on the first S devices."""
    ex = jmesh.MeshExecutor(jmesh.make_mesh(S))
    ax = ex.axis
    dev = dict(
        col_alloc=ex.put_sharded(cat["col_alloc"], P(ax, None), "catalog"),
        col_daemon=ex.put_sharded(cat["col_daemon"], P(ax, None), "catalog"),
        pt_alloc=ex.put_sharded(cat["pt_alloc"], P(ax, None), "catalog"),
        col_pool=ex.put_sharded(cat["col_pool"], P(ax), "catalog"),
        pool_daemon=ex.put_replicated(cat["pool_daemon"]),
        col_zone=ex.put_sharded(cat["col_zone"], P(ax), "catalog"),
        col_ct=ex.put_sharded(cat["col_ct"], P(ax), "catalog"),
        ZC=cat["zc"])
    reg = jmesh.MaskRowRegistry(ex, cat["col_alloc"].shape[0])
    rows, table = reg.ensure(prob[2])
    jprob = tuple(prob[:2]) + (rows,) + tuple(prob[3:])
    if seeds is None:
        buf, layout = jffd.pack_problem(jprob)
        out = ex.solve(buf, table, dev, layout, N, 0, False, explain=ex_,
                       with_gang=wg, with_priority=int(len(prob) > 17))
    else:
        used, pool, active, cm = seeds
        buf, layout = jffd.pack_problem(jprob + (used, pool, active))
        cmd = ex.put_sharded(cm, P(None, ax), "delta-seed")
        out = ex.solve_delta(buf, cmd, table, dev, layout, N, explain=ex_)
    return np.asarray(out)


def _port_cards(S, prob, cat, ex_, wg, seeds=None):
    """The cards form on S "cpu" devices (its plain version)."""
    wp = int(len(prob) > 17)
    if seeds is None:
        p, tables, cc, _ = tmesh.shard_problem(prob, cat, cpu_cards(S))
        assert isinstance(cc, tffd.CardCatalog) and len(p) == S
        flat = tffd.sharded_solve_ffd(p, tables, cc, N, ex_, wg, wp)
    else:
        p, sd, tables, cc, _ = tmesh.shard_problem(prob, cat, cpu_cards(S),
                                                   seed=seeds)
        assert len(sd) == S and sd[0].seed_colmask.shape[-1] == cc.W_s
        flat = tffd.sharded_delta_ffd(p, sd, tables, cc, N, ex_)
    return flat.numpy()


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_cards_form_matches_jax_shard_map(case, S):
    _, seed, kw, ex_, wg = case
    prob, cat = random_problem(seed, **kw)
    ref = _jax_resident(S, prob, cat, ex_, wg)
    got = _port_cards(S, prob, cat, ex_, wg)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("explain", [1, 0])
def test_seeded_cards_form_matches_jax_delta_program(explain, S):
    prob, cat, seeds = random_delta_problem(31 + explain, A=7, A_pad=16,
                                            N=N)
    ref = _jax_resident(S, prob, cat, explain, 0, seeds)
    got = _port_cards(S, prob, cat, explain, 0, seeds)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_card_scan_checks_its_ranks():
    """card_scan takes one problem, table and seed a rank, and the flat
    row on rank 0's device; the K7x rehearsal on CPU tensors is the plain
    version on K7's stacked arguments."""
    prob, cat = random_problem(11)
    p, tables, cc, _ = tmesh.shard_problem(prob, cat, cpu_cards(2))
    lay = tffd.flat_layout(p[0].G, p[0].E, N, p[0].D, 1)
    flat = torch.empty(lay["total"][1])
    lim = torch.empty((p[0].P, tffd.R))
    with pytest.raises(ValueError, match="a rank"):
        tffd.card_scan(p[:1], tables, cc, N, flat, lay, lim)
    with pytest.raises(ValueError, match="counts"):
        tffd.sharded_solve_ffd(p, tables, cc, N, explain=2)
    tffd.card_scan(p, tables, cc, N, flat, lay, lim)
    p8, table8, sc8, _ = tmesh.shard_problem(prob, cat, 2, "cpu")
    flat8, lim8 = torch.empty_like(flat), torch.empty_like(lim)
    tffd.card_scan_rehearsal(p8, table8, sc8, N, flat8, lay, lim8)
    assert torch.equal(flat.view(torch.int32), flat8.view(torch.int32))
    assert torch.equal(lim.view(torch.int32), lim8.view(torch.int32))


# -- the solver ---------------------------------------------------------------
@pytest.fixture(scope="module")
def solvers():
    out = {}
    for S in SIZES:
        ref = TPUSolver(mesh=S)
        assert ref.mesh is not None and ref.mesh.size == S
        port = TorchSolver(device="cpu", mesh=cpu_cards(S))
        assert port.mesh.cards and port.mesh.size == S
        out[S] = ref, port
    return out


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("name", sorted(JAX_SCENARIOS))
def test_cards_solve_matches_reference(solvers, name, S):
    ref_s, port = solvers[S]
    jinp, tinp = JAX_SCENARIOS[name](), PORT_SCENARIOS[name]()
    if name == "solve-batch":
        ref = ref_s.solve_batch(jinp)
        got = port.solve_batch(tinp)
        assert [canon(r) for r in got] == [canon(r) for r in ref]
        return
    assert canon(port.solve(tinp)) == canon(ref_s.solve(jinp))


def test_delta_pass_across_cards():
    """The delta pass's seeded solve runs the cards form's seeded
    instance (its seed words committed per card and logged) and gives the
    full solve's answer."""
    from tests import test_solver_delta as sd
    existing = sd.mknodes(4)
    ref = TPUSolver(mesh="off", delta="off", spec="off", incr="off")
    port = TorchSolver(device="cpu", mesh=cpu_cards(4), delta="on")
    memo, keep = {}, []
    for g in range(3):
        jinp = sd.mkinput(sd.churn_pods(g), existing)
        keep.append(jinp)
        got = port.solve(to_port(jinp, memo))
        assert canon(got) == canon(ref.solve(jinp)), g
    assert port.delta_passes == {"fallback": 1, "delta": 2}
    kinds = [k for k, _ in port._mesh_exec.transfers]
    assert kinds.count("delta-seed") == 2


# -- residency ---------------------------------------------------------------
def test_cards_residency():
    """The first solve commits every shard to its own device, gathers the
    full width onto card 0 once (logged under "catalog") and uploads the
    mask rows; a repeat ships no column-axis byte; each device holds only
    its slice."""
    S = 4
    port = TorchSolver(device="cpu", mesh=cpu_cards(S))
    inp = PORT_SCENARIOS["mixed-sizes"]()
    first = canon(port.solve(inp))
    ex = port._mesh_exec
    before = list(ex.transfers)
    assert {k for k, _ in before} == {"catalog", "mask-rows"}
    assert canon(port.solve(inp)) == first
    assert ex.transfers == before
    cat = port._cat_entry[1]
    cc = cat.mesh_args
    assert isinstance(cc, tffd.CardCatalog) and cc.S == S
    O, O_s = cc.O, cc.O_s
    full = np.zeros((O, tffd.R), np.float32)
    full[:len(cat.columns)] = cat.col_alloc
    shards = (cc.col_alloc, cc.col_daemon, cc.pt_alloc, cc.col_pool,
              cc.pool_bits, cc.col_zone, cc.col_ct)
    for r in range(S):
        assert cc.col_alloc[r].shape == (O_s, tffd.R)
        assert np.array_equal(cc.col_alloc[r].numpy(),
                              full[r * O_s:(r + 1) * O_s])
    shard_bytes = sum(t.numel() * t.element_size()
                      for ts in shards for t in ts)
    gathered = cat.device_args
    assert gathered is cc.full and gathered.O == O
    assert torch.equal(gathered.col_alloc, torch.from_numpy(full))
    ref_bits = tffd.pack_mask_bits(
        gathered.col_pool.numpy()[None, :]
        == np.arange(gathered.pool_daemon.shape[0])[:, None], O)
    assert np.array_equal(gathered.pool_bits.numpy(), ref_bits)
    gather_bytes = sum(t.numel() * t.element_size() for t in (
        gathered.col_alloc, gathered.col_daemon, gathered.pt_alloc,
        gathered.col_pool, gathered.col_zone, gathered.col_ct))
    catalog = [n for k, n in before if k == "catalog"]
    # seven shard commits, then the one gather
    assert len(catalog) == 8 and catalog[-1] == gather_bytes
    assert sum(catalog[:-1]) == shard_bytes
    table = cat.mask_registry.table
    assert isinstance(table, tuple) and len(table) == S
    assert all(t.shape[1] == cc.W_s for t in table)


def test_cards_new_mask_row_is_a_delta_upload():
    """A solve with unseen group masks uploads those rows, padded to an
    upload tier, into each card's own table — not the table again."""
    S = 2
    port = TorchSolver(device="cpu", mesh=cpu_cards(S))
    port.solve(PORT_SCENARIOS["identical-pods"]())
    ex = port._mesh_exec
    reg = port._cat_entry[1].mask_registry
    n0, table0 = len(ex.transfers), reg.table
    port.solve(PORT_SCENARIOS["node-selectors"]())
    new = ex.transfers[n0:]
    assert [k for k, _ in new] == ["mask-rows"]
    W_s = table0[0].shape[1]
    assert new[0][1] == S * 8 * W_s * 4
    assert reg.table is table0 and reg.n_rows == 4


# -- the resolution rule ----------------------------------------------------
def _peer(n, missing=()):
    return tuple(tuple(i == j or (i, j) not in missing for j in range(n))
                 for i in range(n))


def test_resolution_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    r = tmesh.resolve_mesh
    # "auto": every card when there is more than one, else single-device
    m = r("auto", 4, _peer(4), cuda)
    assert m.cards and m.size == 4
    assert m.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert r("auto", 1, _peer(1), cuda) is None
    assert r("auto", 0, (), cuda) is None
    assert r("auto", 4, _peer(4), cpu) is None
    # an integer up to the card count: the first n cards
    m = r(2, 4, _peer(4), cuda)
    assert m.cards and m.devices == (torch.device("cuda", 0),
                                     torch.device("cuda", 1))
    assert r("3", 4, _peer(4), cuda).size == 3
    # above it: K7's n blocks on one card; on the CPU always so
    m = r(8, 4, _peer(4), cuda)
    assert not m.cards and m.size == 8 and m.device == cuda
    m = r(8, 1, _peer(1), cuda)
    assert not m.cards and m.size == 8
    m = r(4, 0, (), cpu)
    assert not m.cards and m.device == cpu
    # off, one shard, malformed: single-device
    for spec in (None, 0, False, "off", "", 1, "4x"):
        assert r(spec, 4, _peer(4), cuda) is None
    # a Mesh as it is
    given = cpu_cards(3)
    assert r(given, 0, (), cpu) is given
    assert r(tmesh.make_mesh(1, "cpu"), 0, (), cpu) is None


def test_cards_without_peer_access_raise():
    cuda = torch.device("cuda")
    peer = _peer(4, missing={(2, 1)})
    with pytest.raises(RuntimeError, match="cards 2 and 1"):
        tmesh.resolve_mesh("auto", 4, peer, cuda)
    # a mesh that leaves the pair out resolves
    assert tmesh.resolve_mesh(2, 4, peer, cuda).size == 2
    with pytest.raises(RuntimeError, match="cards 2 and 1"):
        tmesh.resolve_mesh(tmesh.card_mesh(["cuda:1", "cuda:2"]), 4, peer,
                           cuda)


def test_solver_mesh_knob_across_cards(monkeypatch):
    """The solver resolves through the probe: on the CPU "auto" is the
    single-device path, an integer K7's cluster form, a cards Mesh the
    cards form; KARPENTER_TPU_MESH still overrides."""
    assert TorchSolver(device="cpu").mesh is None
    assert not TorchSolver(device="cpu", mesh=4).mesh.cards
    assert TorchSolver(device="cpu", mesh=cpu_cards(2)).mesh.cards
    monkeypatch.setenv("KARPENTER_TPU_MESH", "off")
    assert TorchSolver(device="cpu", mesh=cpu_cards(2)).mesh is None
