"""The column-sharded solve of the port against the JAX package's mesh.

Kernel level: the plain version of K7, `ffd.sharded_scan_reference` (via
`sharded_scan` on CPU tensors), at S = 8 shards equals the JAX package's
`shard_map` programs on the 8 host CPU devices that `tests/conftest.py`
forces — `MeshExecutor.solve` (the resident program, ffd.py:1372) and
`MeshExecutor.solve_delta` (the seeded one, :1446) — and the port's
unsharded plain scan, as uint32 views of the flat result rows: exact.
Solve level: `TorchSolver(mesh=8, device="cpu")` equals
`TPUSolver(mesh="auto")` on the scenarios of `tests/test_solver_mesh.py`
(built once per package by one parameterised builder), compared by the
`canon` of `tests/test_torch_solve.py` (claims, assignments, reason
codes, the price as a float hex): exact.  Then the residency contract,
read from `MeshExecutor.transfers`, and the KARPENTER_TPU_MESH grammar.
"""

import importlib

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
from tests.test_torch_solve import canon
from tests.test_torch_sweep import to_port

S = 8
N = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the kernel ---------------------------------------------------------------
def _jax_resident(prob, cat, ex_, wg, seeds=None):
    """The reference's resident program (or its seeded form) under
    shard_map on 8 devices, on `prob`'s mask rows made resident."""
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


def _port_sharded(prob, cat, ex_, wg, seeds=None):
    """The port's sharded plain scan on the same problem (CPU tensors)."""
    wp = int(len(prob) > 17)
    if seeds is None:
        p, table, sc, _ = tmesh.shard_problem(prob, cat, S, "cpu")
        flat = tffd.sharded_solve_ffd(p, table, sc, N, ex_, wg, wp)
    else:
        p, sd, table, sc, _ = tmesh.shard_problem(prob, cat, S, "cpu",
                                                  seeds)
        flat = tffd.sharded_delta_ffd(p, sd, table, sc, N, ex_)
    return flat.numpy()


def _port_unsharded(prob, cat, ex_, wg, seeds=None):
    if seeds is None:
        p, c = tffd.problem_from_numpy(prob, cat, "cpu")
        return tffd.solve_ffd(p, c, N, explain=ex_, with_gang=wg,
                              with_priority=int(len(prob) > 17)).numpy()
    p, sd = tffd.delta_tensors(prob, *seeds, cat["col_alloc"].shape[0],
                               "cpu")
    c = tffd.catalog_tensors(cat, "cpu")
    return tffd.solve_ffd_delta(p, sd, c, N, explain=ex_).numpy()


# (id, seed, problem kwargs, explain, with_gang); with the default 8 pad
# blocks of PT = 64 the last shard of 8 is padding only
KERNEL_CASES = [
    ("light", 11, dict(), 1, 0),
    ("heavy", 12, dict(topology=True, D=4), 1, 0),
    ("gang", 13, dict(gang=True, topology=True, D=4), 1, 1),
    ("priority", 14, dict(priority=True, P=3, limits="finite"), 1, 0),
    ("explain-off", 15, dict(topology=True, D=4), 0, 0),
    ("pure-padding-shards", 16, dict(topology=True, D=4, pad_blocks=24),
     1, 0),
]


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_sharded_scan_matches_jax_shard_map(case):
    _, seed, kw, ex_, wg = case
    prob, cat = random_problem(seed, **kw)
    ref = _jax_resident(prob, cat, ex_, wg)
    got = _port_sharded(prob, cat, ex_, wg)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    one = _port_unsharded(prob, cat, ex_, wg)
    assert np.array_equal(got.view(np.uint32), one.view(np.uint32))


def test_pure_padding_shard_is_padding():
    """The pure-padding case really leaves whole shards without a real
    block: PT = 64 in 8 shards of 8 blocks, the last 24 blocks padding,
    and those shards still carry the tiled slot->domain pattern."""
    prob, cat = random_problem(16, topology=True, D=4, pad_blocks=24)
    sc = tmesh.shard_problem(prob, cat, S, "cpu")[2]
    assert sc.PT_s == 8
    for r in (5, 6, 7):
        assert not bool(sc.pt_alloc[r].any())
        zc = cat["zc"]
        assert torch.equal(sc.col_zone[r].view(-1, zc)[0],
                           sc.col_zone[0][:zc])


@pytest.mark.parametrize("explain", [1, 0])
def test_seeded_sharded_scan_matches_jax_delta_program(explain):
    prob, cat, seeds = random_delta_problem(21 + explain, A=7, A_pad=16,
                                            N=N)
    ref = _jax_resident(prob, cat, explain, 0, seeds)
    got = _port_sharded(prob, cat, explain, 0, seeds)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    one = _port_unsharded(prob, cat, explain, 0, seeds)
    assert np.array_equal(got.view(np.uint32), one.view(np.uint32))


def test_sharded_scan_refuses_what_has_no_sharded_form():
    prob, cat = random_problem(11)
    p, table, sc, _ = tmesh.shard_problem(prob, cat, S, "cpu")
    with pytest.raises(ValueError, match="no sharded form|counts"):
        tffd.sharded_solve_ffd(p, table, sc, N, explain=2)
    with pytest.raises(ValueError, match="shards"):
        tmesh.make_mesh(tffd.MAX_SHARDS + 1, "cpu")


# -- the solver ---------------------------------------------------------------
def _mesh_scenarios(root):
    """The solve scenarios of tests/test_solver_mesh.py, from `root`'s
    classes, on the default catalog."""
    M = importlib.import_module(f"{root}.models")
    Sch = importlib.import_module(f"{root}.scheduling")
    catalog = importlib.import_module(f"{root}.providers").generate_catalog()
    wk = M.wellknown

    def mkpod(name, cpu="500m", mem="1Gi", **kw):
        return M.Pod(meta=M.ObjectMeta(name=name,
                                       labels=kw.pop("labels", {})),
                     requests=M.Resources.parse({"cpu": cpu, "memory": mem}),
                     **kw)

    def mkinput(pods, pools=None, **kw):
        pools = pools or [M.NodePool(meta=M.ObjectMeta(name="default"))]
        return Sch.ScheduleInput(pods=pods, nodepools=pools,
                                 instance_types={p.name: catalog
                                                 for p in pools}, **kw)

    def node_selectors():
        pods = []
        for i in range(30):
            p = mkpod(f"z{i}")
            p.requirements = M.Requirements(M.Requirement.make(
                wk.ZONE_LABEL, "In", ["tpu-west-1a", "tpu-west-1b"][i % 2]))
            pods.append(p)
        return mkinput(pods)

    def zonal_spread():
        return mkinput([mkpod(f"t{i}", labels={"app": "z"},
                              topology_spread=[M.TopologySpreadConstraint(
                                  topology_key=wk.ZONE_LABEL, max_skew=1,
                                  label_selector={"app": "z"})])
                        for i in range(60)])

    def anti_affinity_hostname():
        return mkinput([mkpod(f"a{i}", labels={"app": "web"},
                              pod_affinities=[M.PodAffinityTerm(
                                  label_selector={"app": "web"},
                                  topology_key=wk.HOSTNAME_LABEL,
                                  anti=True, required=True)])
                        for i in range(12)])

    def existing_nodes():
        existing = []
        for i in range(4):
            alloc = M.Resources.parse({"cpu": "8", "memory": "32Gi",
                                       "pods": "110"})
            node = M.Node(meta=M.ObjectMeta(
                name=f"node-{i}",
                labels={wk.ZONE_LABEL: ["tpu-west-1a", "tpu-west-1b"][i % 2],
                        wk.CAPACITY_TYPE_LABEL: "on-demand"}),
                allocatable=alloc, ready=True)
            existing.append(Sch.ExistingNode(node=node, available=alloc,
                                             pods=[]))
        inp = mkinput([mkpod(f"p{i}") for i in range(40)])
        inp.existing_nodes = existing
        return inp

    def pool_limits():
        pool = M.NodePool(meta=M.ObjectMeta(name="capped"))
        return mkinput([mkpod(f"p{i}", cpu="2") for i in range(10)],
                       pools=[pool], remaining_limits={
                           "capped": M.Resources.limits(cpu=9000)})

    def weighted_pools():
        hi = M.NodePool(meta=M.ObjectMeta(name="hi"), weight=100)
        lo = M.NodePool(meta=M.ObjectMeta(name="lo"), weight=1)
        return mkinput([mkpod(f"p{i}") for i in range(20)], pools=[hi, lo])

    def split_path():
        p = mkpod("aff", labels={"app": "web"}, pod_affinities=[
            M.PodAffinityTerm(label_selector={"app": "web"},
                              topology_key=wk.ZONE_LABEL)])
        return mkinput([p] + [mkpod(f"f{i}") for i in range(8)])

    return {
        "identical-pods": lambda: mkinput([mkpod(f"p{i}")
                                           for i in range(100)]),
        "mixed-sizes": lambda: mkinput(
            [mkpod(f"s{i}", cpu="250m", mem="512Mi") for i in range(40)]
            + [mkpod(f"m{i}", cpu="2", mem="4Gi") for i in range(25)]
            + [mkpod(f"l{i}", cpu="15", mem="24Gi") for i in range(10)]),
        "node-selectors": node_selectors,
        "zonal-spread": zonal_spread,
        "anti-affinity-hostname": anti_affinity_hostname,
        "existing-nodes": existing_nodes,
        "pool-limits": pool_limits,
        "weighted-pools": weighted_pools,
        "split-path": split_path,
        "solve-batch": lambda: [
            mkinput([mkpod(f"b{k}-{i}", cpu=f"{250 * (k + 1)}m")
                     for i in range(10 + k)]) for k in range(6)],
    }


JAX_SCENARIOS = _mesh_scenarios("karpenter_tpu")
PORT_SCENARIOS = _mesh_scenarios("karpenter_tpu_torch")


@pytest.fixture(scope="module")
def solvers():
    ref = TPUSolver(mesh="auto")
    assert ref.mesh is not None and ref.mesh.size == S
    port = TorchSolver(device="cpu", mesh=S)
    assert port.mesh is not None and port.mesh.size == S
    return ref, port


@pytest.mark.parametrize("name", sorted(JAX_SCENARIOS))
def test_mesh_solve_matches_reference(solvers, name):
    ref_s, port = solvers
    jinp, tinp = JAX_SCENARIOS[name](), PORT_SCENARIOS[name]()
    if name == "solve-batch":
        ref = ref_s.solve_batch(jinp)
        got = port.solve_batch(tinp)
        assert [canon(r) for r in got] == [canon(r) for r in ref]
        return
    assert canon(port.solve(tinp)) == canon(ref_s.solve(jinp))


# -- residency ------------------------------------------------------------------
def _column_transfers(ex):
    return list(ex.transfers)


def test_zero_column_transfers_on_a_repeat():
    """The first solve uploads the catalog shards and the mask rows; the
    same solve again ships no column-axis byte."""
    port = TorchSolver(device="cpu", mesh=S)
    inp = PORT_SCENARIOS["mixed-sizes"]()
    first = canon(port.solve(inp))
    ex = port._mesh_exec
    kinds = {k for k, _ in ex.transfers}
    assert kinds == {"catalog", "mask-rows"}
    before = _column_transfers(ex)
    assert canon(port.solve(inp)) == first
    assert _column_transfers(ex) == before


def test_launch_config_built_once_per_shape():
    """The executor builds each static shape's launch configuration once
    (the reference's `_program` cache): a repeat solve reuses it, and off
    the card no cluster count is asked for.  (The second solve starts at
    the warm node bucket, a shape of its own.)"""
    port = TorchSolver(device="cpu", mesh=S)
    inp = PORT_SCENARIOS["mixed-sizes"]()
    port.solve(inp)
    port.solve(inp)
    ex = port._mesh_exec
    configs = dict(ex._configs)
    assert configs and all(c["clusters"] is None for c in configs.values())
    port.solve(inp)
    assert ex._configs.keys() == configs.keys()
    assert all(ex._configs[k] is c for k, c in configs.items())
    for (kind, G, E, D, _, _, N, explain, _, wp), c in configs.items():
        assert kind == "solve"
        assert c["lay"] == tffd.flat_layout(G, E, N, D, explain,
                                            with_priority=wp)
    assert ex.clusters == {k: None for k in configs}


def test_new_mask_row_is_a_delta_upload():
    """A solve with one unseen group mask uploads that row padded to an
    upload tier, into each shard's slice — not the table again."""
    port = TorchSolver(device="cpu", mesh=S)
    port.solve(PORT_SCENARIOS["identical-pods"]())
    ex = port._mesh_exec
    reg = port._cat_entry[1].mask_registry
    n0, table0 = len(ex.transfers), reg.table
    port.solve(PORT_SCENARIOS["node-selectors"]())
    new = ex.transfers[n0:]
    assert [k for k, _ in new] == ["mask-rows"]
    W_s = table0.shape[2]
    # two new rows (one per zone), padded to the 8-row upload tier
    assert new[0][1] == S * 8 * W_s * 4
    assert reg.table is table0 and reg.n_rows == 4


def test_each_shard_holds_only_its_slice():
    port = TorchSolver(device="cpu", mesh=S)
    port.solve(PORT_SCENARIOS["identical-pods"]())
    cat = port._cat_entry[1]
    sc = cat.mesh_args
    O = sc.O
    assert sc.col_alloc.shape == (S, O // S, tffd.R)
    full = np.zeros((O, tffd.R), np.float32)
    full[:len(cat.columns)] = cat.col_alloc
    for r in range(S):
        assert sc.col_alloc[r].is_contiguous()
        assert np.array_equal(sc.col_alloc[r].numpy(),
                              full[r * (O // S):(r + 1) * (O // S)])
    catalog_bytes = sum(n for k, n in port._mesh_exec.transfers
                        if k == "catalog")
    assert catalog_bytes == sum(t.numel() * t.element_size() for t in (
        sc.col_alloc, sc.col_daemon, sc.pt_alloc, sc.col_pool,
        sc.pool_bits, sc.col_zone, sc.col_ct))


def test_mesh_six_aligns_pt_to_the_lcm():
    port = TorchSolver(device="cpu", mesh=6)
    assert port._pt_align() == 192
    res = port.solve(PORT_SCENARIOS["weighted-pools"]())
    sc = port._cat_entry[1].mesh_args
    assert sc.S == 6 and sc.PT % 192 == 0 and sc.PT_s * 6 == sc.PT
    ref = TPUSolver(mesh="off").solve(JAX_SCENARIOS["weighted-pools"]())
    assert canon(res) == canon(ref)


def test_mesh_knob(monkeypatch):
    """KARPENTER_TPU_MESH as the reference reads it
    (tests/test_mesh_solver.py:242-264): off/0 force one device, an
    integer forces that shard count, auto takes the device count (one on
    the CPU: single-device), a malformed value keeps the constructed
    spec."""
    monkeypatch.setenv("KARPENTER_TPU_MESH", "off")
    assert TorchSolver(device="cpu", mesh=4).mesh is None
    monkeypatch.setenv("KARPENTER_TPU_MESH", "0")
    assert TorchSolver(device="cpu", mesh=4).mesh is None
    monkeypatch.setenv("KARPENTER_TPU_MESH", "4")
    assert TorchSolver(device="cpu", mesh="off").mesh.size == 4
    monkeypatch.setenv("KARPENTER_TPU_MESH", "auto")
    assert TorchSolver(device="cpu", mesh=4).mesh is None
    monkeypatch.setenv("KARPENTER_TPU_MESH", "banana")
    assert TorchSolver(device="cpu", mesh=2).mesh.size == 2
    assert TorchSolver(device="cpu").mesh is None
    monkeypatch.delenv("KARPENTER_TPU_MESH")
    assert TorchSolver(device="cpu", mesh="4x").mesh is None
    assert TorchSolver(device="cpu", mesh=1).mesh is None


def test_delta_pass_under_the_mesh():
    """The delta pass's seeded solve runs K7's seeded instance under a
    mesh (its seed masks committed per shard and logged) and gives the
    full solve's answer."""
    from tests import test_solver_delta as sd
    existing = sd.mknodes(4)
    ref = TPUSolver(mesh="off", delta="off", spec="off", incr="off")
    port = TorchSolver(device="cpu", mesh=S, delta="on")
    memo, keep = {}, []   # the converted objects stay alive (id keys)
    for g in range(3):
        jinp = sd.mkinput(sd.churn_pods(g), existing)
        keep.append(jinp)
        got = port.solve(to_port(jinp, memo))
        assert canon(got) == canon(ref.solve(jinp)), g
    assert port.delta_passes == {"fallback": 1, "delta": 2}
    kinds = [k for k, _ in port._mesh_exec.transfers]
    assert kinds.count("delta-seed") == 2


def test_chip_smoke_config2_is_the_reference():
    """chip_smoke.CONFIG2 is the JAX answer on BASELINE config #2 at 5k
    pods (`bench.py build_config2_5k`), and the port's own builder solves
    to it at mesh=8 on the CPU."""
    import chip_smoke
    from bench import build_config2_5k
    from karpenter_tpu_torch.workloads import build_config2
    ref = TPUSolver(mesh="off", max_nodes=chip_smoke.CONFIG2_MAX_NODES
                    ).solve(build_config2_5k())
    got = TorchSolver(device="cpu", mesh=S,
                      max_nodes=chip_smoke.CONFIG2_MAX_NODES
                      ).solve(build_config2())
    nodes, unsched, price_hex, digest = chip_smoke.CONFIG2
    for res in (ref, got):
        assert (res.node_count(), len(res.unschedulable),
                float(res.total_price()).hex()) == (nodes, unsched,
                                                    price_hex)
        assert chip_smoke.result_digest(res) == digest
    assert canon(got) == canon(ref)
