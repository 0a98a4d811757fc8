"""Topology-spread provisioning in the port against the JAX package.

Three levels, all on the CPU, where the port's kernel wrappers run their
plain PyTorch versions:

  * the scan: seeded problems with zone and capacity-type domain classes
    (`random_problem(topology=True)`) through the JAX `ffd.solve_ffd`
    (heavy branch on) and the port's `ffd.solve_ffd` (the plain versions
    of the batched scan at B=1 and of K2), explain=1: the flat result buffers must be equal as uint32
    — bit-exact, because both sides do the same IEEE float32 operations
    in the same order;
  * `water_fill` against the JAX `_water_fill` on random inputs, exact;
  * the solve: the scenarios of `tests/test_solver_topology.py`, config
    #3's 9,003-pod shape and config #3 at 10k pods, each built with both
    packages' classes, through `TPUSolver` and `TorchSolver(device="cpu")`:
    canonical results (zone and capacity-type pins of every claim
    included) must be equal.  Strands go through both packages' host
    oracle rescue, inexpressible groups through both split paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.problems import random_problem
from tests.test_torch_encode import JAX, PORT
from tests.test_torch_ffd import _jax_args
from tests.test_torch_solve import canon, default_catalog, jax_solver

BIG = 2 ** 29


# -- the scan -----------------------------------------------------------------
# (id, seed, random_problem kwargs, N)
TOPO = dict(topology=True, D=4)
SCAN_CASES = [
    ("zone-and-ct", 4, dict(TOPO), 64),
    ("mixed-light-heavy", 3, dict(TOPO), 64),
    ("skew2-mindom", 5, dict(TOPO), 64),
    ("existing-in-domains", 12, dict(TOPO, E=32), 64),
    ("three-pools-finite", 1, dict(TOPO, P=3, limits="finite"), 64),
    ("three-pools-mixed", 5, dict(TOPO, P=3, limits="mixed"), 64),
    ("d8", 2, dict(TOPO, D=8, ZC=12), 64),
    ("d8-existing", 14, dict(TOPO, D=8, ZC=12, E=32), 64),
    ("slot-exhaustion", 1, dict(TOPO, E=0, pod_scale=300), 16),
    ("slot-exhaustion-finite", 2, dict(TOPO, P=2, limits="finite",
                                       pod_scale=300), 16),
    ("no-existing", 9, dict(TOPO, E=0), 64),
    ("small-groups", 20, dict(TOPO, pod_scale=12), 64),
    ("wide-domain-pad", 6, dict(TOPO, D=16), 64),
    ("many-groups", 11, dict(TOPO, G=16, PT=128), 128),
]


def _scan_both(seed, kw, N):
    prob, cat = random_problem(seed, **kw)
    ref = np.asarray(jffd.solve_ffd(
        *_jax_args(prob, cat, False), max_nodes=N, zc=cat["zc"],
        explain=1))
    p, c = tffd.problem_from_numpy(prob, cat, "cpu")
    out = tffd.solve_ffd(p, c, N, explain=1)
    return prob, ref, out.numpy()


@pytest.mark.parametrize("case", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_topo_scan_matches_jax_bitwise(case):
    name, seed, kw, N = case
    prob, ref, out = _scan_both(seed, kw, N)
    assert out.dtype == np.float32 and out.shape == ref.shape
    differ = np.nonzero(ref.view(np.uint32) != out.view(np.uint32))[0]
    assert differ.size == 0, (name, differ[:10], ref[differ[:10]],
                              out[differ[:10]])
    # the case exercises what its name claims
    G, E, D = prob[0].shape[0], prob[4].shape[0], prob[8].shape[1]
    u = tffd.unpack(out, G, E, N, 6, D, explain=1)
    dsel = prob[7]
    assert (dsel == 1).any() or (dsel == 2).any()
    assert u["dom_placed"].sum() > 0
    assert ((u["node_zone"] >= 0) | (u["node_ct"] >= 0)).any()
    if name == "mixed-light-heavy":
        assert (dsel == 0)[:G - 1].any() and (dsel > 0).any()
    if name == "zone-and-ct":
        assert set(dsel.tolist()) >= {1, 2}
    if name == "skew2-mindom":
        assert (prob[10][dsel > 0] == 2).any() and (prob[11] > 0).any()
    if name.startswith("existing") or name == "d8-existing":
        assert (prob[15] >= 0).any() and u["take_exist"][dsel > 0].any()
    if name.startswith("slot-exhaustion"):
        assert u["num_active"] == N and u["unsched"].sum() > 0
    if name.startswith("three-pools"):
        assert np.isfinite(prob[5]).any()
    if name == "d8":
        assert D == 8 and (prob[12][dsel > 0].sum(axis=1) >= 1).all()
    # ineligible domains and the topology explain class appear somewhere
    # in the cases as a whole (checked in test_scan_cases_cover_topology)


def test_scan_cases_cover_topology():
    """Across the scan cases: partly ineligible domains, anti-affinity
    (unbounded skew) groups, capacity-type groups, and a nonzero topology
    elimination count."""
    inelig = anti = ct = topo_elim = 0
    for name, seed, kw, N in SCAN_CASES:
        prob, _, out = _scan_both(seed, kw, N)
        dsel, delig, skew = prob[7], prob[12], prob[10]
        for g in np.nonzero(dsel > 0)[0]:
            ndom = 2 if dsel[g] == 2 else kw.get("ZC", 6) // 2
            inelig += int(not delig[g, :ndom].all())
            anti += int(skew[g] == BIG)
            ct += int(dsel[g] == 2)
        G, E, D = prob[0].shape[0], prob[4].shape[0], prob[8].shape[1]
        u = tffd.unpack(out, G, E, N, 6, D, explain=1)
        topo_elim += int(u["explain_counts"][:, 2].sum())
    assert inelig and anti and ct and topo_elim


# -- the water-fill -----------------------------------------------------------
def _random_water_fill_inputs(rng, D):
    base = rng.randint(0, 6, D).astype(np.int32)
    xmax = np.where(rng.rand(D) < 0.2, BIG,
                    rng.randint(0, 25, D)).astype(np.int32)
    elig = rng.rand(D) < 0.8
    skew = np.int32(rng.choice([1, 2, 3, BIG]))
    mindom = np.int32(rng.randint(0, D + 1) if rng.rand() < 0.4 else 0)
    cnt = np.int32(rng.randint(0, 80))
    return cnt, base, xmax, elig, skew, mindom


@pytest.mark.parametrize("seed", range(4))
def test_water_fill_matches_jax(seed):
    """The port's water_fill against the JAX `_water_fill` (jitted, as the
    scan runs it), exactly, on random quotas, caps, eligibility, skews and
    minDomains over D in 1..8."""
    rng = np.random.RandomState(seed)
    jwf = jax.jit(jffd._water_fill)
    for _ in range(60):
        D = int(rng.randint(1, 9))
        args = _random_water_fill_inputs(rng, D)
        ref = np.asarray(jwf(*(jnp.asarray(a) for a in args)))
        got = tffd.water_fill(*(torch.as_tensor(np.asarray(a))
                                for a in args)).numpy()
        assert ref.dtype == got.dtype == np.int32
        assert np.array_equal(ref, got), (args, ref, got)


# -- the solve ------------------------------------------------------------------
def _topo_helpers(ns):
    """The builders of tests/test_solver_topology.py over `ns`'s classes."""
    M = ns.M
    wk = M.wellknown
    ZONE, CT, HOST = wk.ZONE_LABEL, wk.CAPACITY_TYPE_LABEL, wk.HOSTNAME_LABEL
    catalog = ns.prov.generate_catalog(ns.cat.CatalogSpec(
        max_types=40, include_gpu=False))

    def spread(key=ZONE, skew=1, sel=None, mindom=None):
        return M.TopologySpreadConstraint(
            topology_key=key, max_skew=skew,
            label_selector={"app": "web"} if sel is None else sel,
            min_domains=mindom)

    def anti(key=HOST, sel=None):
        return M.PodAffinityTerm(
            label_selector={"app": "web"} if sel is None else sel,
            topology_key=key, anti=True, required=True)

    def coloc(sel):
        return M.PodAffinityTerm(label_selector=sel, topology_key=HOST,
                                 required=True)

    def mkpod(name, cpu="500m", mem="1Gi", labels=None, **kw):
        return M.Pod(meta=M.ObjectMeta(
            name=name, labels={"app": "web"} if labels is None else labels),
            requests=M.Resources.parse({"cpu": cpu, "memory": mem}), **kw)

    def mknode(name, zone="tpu-west-1a", cpu=16000, mem=32768, pods_cap=58,
               resident=None):
        labels = {ZONE: zone, CT: "on-demand", wk.NODEPOOL_LABEL: "default",
                  wk.ARCH_LABEL: "amd64", wk.OS_LABEL: "linux", HOST: name}
        node = M.Node(meta=M.ObjectMeta(name=name, labels=labels),
                      allocatable=M.Resources.of(cpu=cpu, memory=mem,
                                                 pods=pods_cap),
                      ready=True)
        resident = resident or []
        avail = node.allocatable.copy()
        for p in resident:
            avail = avail - p.requests
        return ns.S.ExistingNode(node=node, available=avail, pods=resident)

    def mkinput(pods, types=None, **kw):
        pools = [M.NodePool(meta=M.ObjectMeta(name="default"))]
        types = catalog if types is None else types
        return ns.S.ScheduleInput(pods=pods, nodepools=pools,
                                  instance_types={"default": types}, **kw)

    return dict(M=M, ZONE=ZONE, CT=CT, HOST=HOST, spread=spread, anti=anti,
                coloc=coloc, mkpod=mkpod, mknode=mknode, mkinput=mkinput)


def _scenarios():
    def even(h):
        return h["mkinput"]([h["mkpod"](f"p{i}",
                                        topology_spread=[h["spread"]()])
                             for i in range(30)])

    def uneven_base(h):
        node = h["mknode"]("n1", resident=[h["mkpod"](f"r{i}")
                                           for i in range(5)])
        return h["mkinput"]([h["mkpod"](f"p{i}",
                                        topology_spread=[h["spread"]()])
                             for i in range(7)], existing_nodes=[node])

    def skew2(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", topology_spread=[h["spread"](skew=2)])
            for i in range(10)])

    def zone_unbuyable(h, ns):
        one_zone = ns.prov.generate_catalog(ns.cat.CatalogSpec(
            max_types=20, include_gpu=False, zones=["tpu-west-1a"]))
        nb = h["mknode"]("nb", zone="tpu-west-1b", cpu=100, mem=128,
                         pods_cap=1)
        nc = h["mknode"]("nc", zone="tpu-west-1c", cpu=100, mem=128,
                         pods_cap=1)
        return h["mkinput"]([h["mkpod"](f"p{i}",
                                        topology_spread=[h["spread"]()])
                             for i in range(9)], types=one_zone,
                            existing_nodes=[nb, nc])

    def min_domains(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", topology_spread=[h["spread"](mindom=3)])
            for i in range(6)])

    def zone_requirement(h):
        M = h["M"]
        reqs = M.Requirements(M.Requirement.make(
            h["ZONE"], "In", "tpu-west-1a", "tpu-west-1b"))
        return h["mkinput"]([h["mkpod"](f"p{i}", requirements=reqs,
                                        topology_spread=[h["spread"]()])
                             for i in range(10)])

    def ct_spread(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", topology_spread=[h["spread"](key=h["CT"])])
            for i in range(10)])

    def static_selector(h):
        node = h["mknode"]("n1", resident=[
            h["mkpod"](f"r{i}", labels={"app": "db"}) for i in range(2)])
        return h["mkinput"]([h["mkpod"](
            f"p{i}", topology_spread=[h["spread"](sel={"app": "db"})])
            for i in range(6)], existing_nodes=[node])

    def host_spread(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", topology_spread=[h["spread"](key=h["HOST"], skew=2)])
            for i in range(10)])

    def coloc_seed(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", pod_affinities=[h["coloc"]({"app": "web"})])
            for i in range(4)])

    def coloc_existing(h):
        return h["mkinput"](
            [h["mkpod"](f"p{i}", pod_affinities=[h["coloc"]({"app": "web"})])
             for i in range(3)],
            existing_nodes=[h["mknode"]("n1", cpu=1000, mem=2048),
                            h["mknode"]("n2")])

    def coloc_partial(h):
        filler = h["mkpod"]("big", cpu="12", mem="4Gi",
                            labels={"app": "other"})
        group = [h["mkpod"](f"c{i}", cpu="2", labels={"app": "db"},
                            pod_affinities=[h["coloc"]({"app": "db"})])
                 for i in range(3)]
        return h["mkinput"]([filler] + group,
                            existing_nodes=[h["mknode"]("n1")])

    def coloc_non_self(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", pod_affinities=[h["coloc"]({"app": "db"})])
            for i in range(3)])

    def coloc_zone_spread(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", pod_affinities=[h["coloc"]({"app": "web"})],
            topology_spread=[h["spread"](skew=3)]) for i in range(3)])

    def coloc_oversized(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", cpu="8", mem="16Gi",
            pod_affinities=[h["coloc"]({"app": "web"})])
            for i in range(40)])

    def host_anti(h):
        return h["mkinput"]([h["mkpod"](f"p{i}",
                                        pod_affinities=[h["anti"]()])
                             for i in range(6)])

    def host_anti_existing(h):
        n1 = h["mknode"]("n1", resident=[h["mkpod"]("r0")])
        return h["mkinput"]([h["mkpod"](f"p{i}",
                                        pod_affinities=[h["anti"]()])
                             for i in range(2)],
                            existing_nodes=[n1, h["mknode"]("n2")])

    def symmetric_anti(h):
        guard = h["mkpod"]("guard", labels={"app": "db"},
                           pod_affinities=[h["anti"](sel={"app": "web"})])
        return h["mkinput"]([h["mkpod"](f"p{i}") for i in range(4)],
                            existing_nodes=[h["mknode"]("n1",
                                                        resident=[guard]),
                                            h["mknode"]("n2")])

    def zone_anti(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", pod_affinities=[h["anti"](key=h["ZONE"])])
            for i in range(5)])

    def config3_shape(h):
        return h["mkinput"]([h["mkpod"](
            f"p{i}", topology_spread=[h["spread"]()],
            pod_affinities=[h["anti"]()]) for i in range(12)])

    def mixed_plain(h):
        return h["mkinput"](
            [h["mkpod"](f"s{i}", topology_spread=[h["spread"]()])
             for i in range(9)]
            + [h["mkpod"](f"plain{i}", cpu="1", mem="2Gi",
                          labels={"app": "other"}) for i in range(20)])

    def reuse_existing(h):
        nodes = [h["mknode"](f"n{z}", zone=z)
                 for z in ("tpu-west-1a", "tpu-west-1b", "tpu-west-1c")]
        return h["mkinput"]([h["mkpod"](f"p{i}",
                                        topology_spread=[h["spread"]()])
                             for i in range(30)], existing_nodes=nodes)

    def two_dynamic_keys(h):
        return h["mkinput"]([h["mkpod"]("p", topology_spread=[
            h["spread"](key=h["ZONE"]), h["spread"](key=h["CT"])])])

    def mixed_residue(h):
        pods = [h["mkpod"](f"plain{i}", labels={"app": "other"})
                for i in range(50)]
        pods.append(h["mkpod"]("p", topology_spread=[
            h["spread"](key=h["ZONE"]), h["spread"](key=h["CT"])]))
        return h["mkinput"](pods)

    def config3_9003(h):
        spread_pods = [h["mkpod"](f"sp{i}", cpu="250m", mem="512Mi",
                                  topology_spread=[h["spread"]()])
                       for i in range(9000)]
        anti_pods = [h["mkpod"](
            f"an{i}", cpu="1", mem="2Gi", labels={"app": "singleton"},
            pod_affinities=[h["anti"](sel={"app": "singleton"},
                                      key=h["ZONE"])]) for i in range(3)]
        return h["mkinput"](spread_pods + anti_pods)

    return {
        "zone-even-spread": even,
        "zone-uneven-base": uneven_base,
        "zone-max-skew-2": skew2,
        "zone-unbuyable-8-of-9": zone_unbuyable,
        "zone-min-domains": min_domains,
        "zone-requirement-eligible": zone_requirement,
        "capacity-type-spread": ct_spread,
        "zone-static-selector": static_selector,
        "hostname-spread": host_spread,
        "hostname-colocation-seed": coloc_seed,
        "hostname-colocation-existing": coloc_existing,
        "hostname-colocation-partial-fill": coloc_partial,
        "hostname-colocation-non-self-match": coloc_non_self,
        "hostname-colocation-zone-spread-split": coloc_zone_spread,
        "hostname-colocation-oversized": coloc_oversized,
        "hostname-anti-affinity": host_anti,
        "hostname-anti-existing-holder": host_anti_existing,
        "symmetric-anti-existing": symmetric_anti,
        "zone-anti-affinity-2-strands": zone_anti,
        "combined-config3-shape": config3_shape,
        "combined-mixed-plain": mixed_plain,
        "combined-reuse-existing": reuse_existing,
        "combined-two-dynamic-keys-split": two_dynamic_keys,
        "combined-mixed-residue-split": mixed_residue,
        "config3-9003-pods": config3_9003,
    }


SCENARIOS = _scenarios()


def _build(ns, name):
    fn = SCENARIOS[name]
    h = _topo_helpers(ns)
    return fn(h, ns) if name == "zone-unbuyable-8-of-9" else fn(h)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_topology_solve_matches_reference(name):
    ref_solver, port = jax_solver(), TorchSolver(device="cpu")
    ref = ref_solver.solve(_build(JAX, name))
    got = port.solve(_build(PORT, name))
    assert canon(got) == canon(ref)
    # the split path is taken exactly where the reference takes it (the
    # rescue counts too: host help of either kind)
    assert port._used_split == ref_solver._used_split
    if name == "zone-unbuyable-8-of-9":
        assert len(got.unschedulable) == 8
    if name == "zone-anti-affinity-2-strands":
        assert len(got.unschedulable) == 2
    if name.endswith("-split"):
        assert port._used_split and port.last_residue_pods >= 1
    if name.startswith(("zone-even", "combined-config3", "config3-9003")):
        assert not got.unschedulable


@pytest.mark.parametrize("name", sorted(chip_smoke.ORACLE_CASES))
def test_chip_smoke_oracle_cases_are_the_reference(name, monkeypatch):
    """chip_smoke.py's oracle phase expects the JAX package's answer on
    the scenario of the same name, and the port gives it from
    chip_smoke.py's own input, through the oracle and the scans the phase
    counts."""
    nodes, unsched, price_hex, kernels = chip_smoke.ORACLE_CASES[name]
    ref = jax_solver().solve(_build(JAX, name))
    calls = {"ffd_batch_scan": 0, "explain_pack": 0}
    for kname, fn in (("ffd_batch_scan", "batch_scan_reference"),
                      ("explain_pack", "pack_reference")):
        def counted(*a, _f=getattr(tffd, fn), _k=kname, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tffd, fn, counted)
    port = TorchSolver(device="cpu")
    got = port.solve(chip_smoke.oracle_inputs()[name]())
    for res in (ref, got):
        assert (res.node_count(), len(res.unschedulable),
                float(res.total_price()).hex()) == (nodes, unsched,
                                                    price_hex)
    assert canon(got) == canon(ref) and port._used_split
    assert {k for k, n in calls.items() if n} == set(kernels)


def test_schedule_anyway_spread_needs_the_relaxation_loop():
    """ScheduleAnyway spread is a soft term: the reference relaxes it in a
    loop around the solve, and so does the port since slice 2c — the same
    answer, nothing stranded."""
    def build(ns):
        h = _topo_helpers(ns)
        M = h["M"]
        return h["mkinput"]([h["mkpod"](f"p{i}", topology_spread=[
            M.TopologySpreadConstraint(
                topology_key=h["ZONE"], max_skew=1,
                when_unsatisfiable="ScheduleAnyway",
                label_selector={"app": "web"})]) for i in range(9)])
    ref = jax_solver().solve(build(JAX))
    assert not ref.unschedulable
    got = TorchSolver(device="cpu").solve(build(PORT))
    assert canon(got) == canon(ref)


def _config3(ns):
    """BASELINE config #3 (benchmarks/config3_topology.py make_input, the
    port's workloads.build_config3) from `ns`'s classes, on a freshly
    loaded default catalog."""
    M = ns.M
    wk = M.wellknown
    pods = []
    for w in range(4):
        sel = {"app": f"web-{w}"}
        for i in range(2495):
            pods.append(M.Pod(
                meta=M.ObjectMeta(name=f"w{w}-p{i}", labels=dict(sel)),
                requests=M.Resources.parse({"cpu": "250m",
                                            "memory": "512Mi"}),
                topology_spread=[M.TopologySpreadConstraint(
                    topology_key=wk.ZONE_LABEL, max_skew=1,
                    label_selector=sel)]))
    for s_ in range(20):
        sel = {"svc": f"s{s_}"}
        pods.append(M.Pod(
            meta=M.ObjectMeta(name=f"svc-{s_}", labels=dict(sel)),
            requests=M.Resources.parse({"cpu": "1", "memory": "2Gi"}),
            pod_affinities=[M.PodAffinityTerm(
                label_selector=sel, topology_key=wk.HOSTNAME_LABEL,
                anti=True)]))
    pool = M.NodePool(meta=M.ObjectMeta(name="default"))
    return ns.S.ScheduleInput(pods=pods, nodepools=[pool],
                              instance_types={"default":
                                              default_catalog(ns)})


def test_config3_builder_is_the_benchmarks():
    """The builder above and the port's workloads.build_config3 give the
    JAX package's benchmarks/config3_topology.py input: the same pods,
    pool and catalog."""
    from benchmarks.config3_topology import make_input
    from karpenter_tpu_torch.workloads import build_config3

    def shape(inp):
        return ([(p.meta.name, sorted(p.meta.labels.items()),
                  tuple(p.requests.v), len(p.topology_spread),
                  len(p.pod_affinities)) for p in inp.pods],
                [p.name for p in inp.nodepools],
                sorted(inp.instance_types["default"][i].name
                       for i in range(len(inp.instance_types["default"]))))
    ref = shape(make_input())
    assert shape(_config3(JAX)) == ref
    assert shape(_config3(PORT)) == ref
    assert shape(build_config3()) == ref


def test_config3_10k_matches_reference():
    """Config #3 at its full 10k pods on the 605-type catalog: 15 nodes,
    none unschedulable, the JAX package's price to the bit — through K3's
    plain version, warm-started on the second solve."""
    ref = TPUSolver(max_nodes=2048, mesh="off", delta="off", spec="off",
                    incr="off").solve(_config3(JAX))
    port = TorchSolver(device="cpu")
    inp = _config3(PORT)
    for _ in range(2):
        got = port.solve(inp)
        assert got.node_count() == 15 and not got.unschedulable
        assert float(got.total_price()).hex() == "0x1.4266a55087011p+5"
        assert canon(got) == canon(ref)
    assert not port._used_split
