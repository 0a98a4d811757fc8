"""The port's steady state against the JAX package: the seeded scan and
the delta pass.

- The plain seeded scan `delta_scan_reference` (K6's plain version) on
  seeded problems of `karpenter_tpu_torch.solver.problems`, against JAX
  `ffd.solve_ffd_delta` with the mask and the seed colmask dense and
  bit-packed: the flat result rows equal as uint32 (every float of these
  problems is integer-valued, both sides do the same IEEE float32
  operations in the same order).
- The port's `delta.build`, `fold_chunk`, `project_chunk` and
  `seed_digest` against the reference's on the same inputs: arrays equal.
- `TorchSolver(device="cpu", delta="on")` against
  `TPUSolver(mesh="off", delta="on")` in lockstep on the scenarios of
  `tests/test_solver_delta.py` (imported, not edited) — every pass's
  canonical result, hex price, and the seam's (outcome, reason) equal —
  through every fallback class the reference tests.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import delta as jdelta
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import delta as tdelta
from karpenter_tpu_torch.solver import explain as texplain
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.problems import random_delta_problem
from tests import test_solver_delta as sd
from tests.test_torch_solve import canon
from tests.test_torch_sweep import to_port


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scans run thousands of small tensor operations: on one
    intra-op thread they do not contend with the other test workers'
    threads on a shared host (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the seeded scan ----------------------------------------------------------
def jax_delta(prob, cat, seeds, N, ex, packed):
    used, pool, active, cm = seeds
    gm = prob[2]
    if packed:
        gm = np.packbits(gm, axis=-1, bitorder="little")
        cm = np.packbits(cm, axis=-1, bitorder="little")
    buf, layout = jffd.pack_problem(prob[:2] + (gm,) + prob[3:]
                                    + (used, pool, active, cm))
    return np.asarray(jffd.solve_ffd_delta(
        buf, cat["col_alloc"], cat["col_daemon"], cat["pt_alloc"],
        cat["col_pool"], cat["pool_daemon"], cat["col_zone"],
        cat["col_ct"], layout=layout, max_nodes=N, zc=cat["zc"],
        mask_packed=packed, seed_packed=packed, explain=ex))


# (id, seed, A, A_pad, N, explain, packed, problem kwargs)
SCAN_CASES = [
    ("no-seed", 1, 0, 16, 64, 1, False, {}),
    ("few-slots", 2, 5, 16, 64, 1, False, {}),
    ("few-slots-packed", 3, 5, 16, 64, 1, True, {}),
    ("a-pad-past-a", 4, 17, 64, 64, 0, False, {}),
    ("a-is-n-minus-1", 5, 63, 64, 64, 1, False, {}),
    ("no-existing", 6, 10, 16, 64, 1, False, dict(E=0)),
    ("e256", 7, 12, 16, 64, 1, True, dict(E=256)),
    ("three-pools-finite", 8, 8, 16, 64, 1, False,
     dict(P=3, limits="finite")),
    ("slot-exhaustion", 9, 14, 16, 16, 1, False,
     dict(P=1, limits="none", pod_scale=300)),
    ("wide-fan-out-packed", 10, 6, 16, 64, 0, True, dict(pod_scale=400)),
]


@pytest.mark.parametrize("case", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_seeded_scan_matches_jax_bitwise(case):
    name, seed, A, A_pad, N, ex, packed, kw = case
    prob, cat, seeds = random_delta_problem(seed, A=A, A_pad=A_pad, N=N,
                                            **kw)
    ref = jax_delta(prob, cat, seeds, N, ex, packed)
    c = tffd.catalog_tensors(cat, "cpu")
    p, s = tffd.delta_tensors(prob, *seeds, c.O, "cpu")
    out = tffd.solve_ffd_delta(p, s, c, N, explain=ex).numpy()
    assert out.shape == ref.shape
    differ = np.nonzero(ref.view(np.uint32) != out.view(np.uint32))[0]
    assert differ.size == 0, (name, differ[:10], ref[differ[:10]],
                              out[differ[:10]])
    G, E = prob[0].shape[0], prob[4].shape[0]
    u = tffd.unpack(out, G, E, N, 6, prob[8].shape[1], explain=ex)
    # the case exercises what its name claims: the seeded slots stay open
    # and new nodes append after them
    assert u["num_active"] >= A
    assert (u["node_pool"][:A] == seeds[1][:A]).all()
    if name == "slot-exhaustion":
        assert u["num_active"] == N and u["unsched"].sum() > 0
    if name in ("few-slots", "e256"):
        assert u["take_new"][:, :A].any()   # pods rode the seeded slots


def test_seeded_scan_refuses_domain_gang_and_priority_rows():
    prob, cat, seeds = random_delta_problem(1, A=2, A_pad=16)
    for slot, value in ((7, np.ones(8, np.int32)), (14, np.ones(8, bool))):
        bad = prob[:slot] + (value,) + prob[slot + 1:]
        with pytest.raises(ValueError):
            tffd.delta_tensors(bad, *seeds, 384, "cpu")
    with pytest.raises(ValueError):
        tffd.delta_tensors(prob + (np.zeros(8, np.int32),), *seeds, 384,
                           "cpu")


# -- the host replays ---------------------------------------------------------
def _records(n_existing=3):
    """The same warm record in both packages: one full solve of
    churn_pods(0) against n_existing nodes on a delta-on solver each."""
    jin = sd.mkinput(sd.churn_pods(0), sd.mknodes(n_existing))
    tin = to_port(jin)
    js = TPUSolver(mesh="off", delta="on")
    ts = TorchSolver(device="cpu", delta="on")
    js.solve(jin)
    ts.solve(tin)
    return js, ts, jin, tin


def _arrays_equal(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


SEED_FIELDS = ("er", "used", "pool", "colmask")


@pytest.mark.parametrize("n_existing", [0, 3])
def test_build_fold_project_digest_match_reference(n_existing):
    js, ts, jin, tin = _records(n_existing)
    jrec = js._delta_cache.get_any()
    trec = ts._delta_cache.get_any()
    jcat, tcat = jrec.cat, trec.cat
    # build: the suffix of a tail churn
    jnew = sd.churn_pods(1)
    jin2 = sd.mkinput(jnew, sd.mknodes(n_existing))
    tin2 = to_port(jin2)
    from karpenter_tpu.solver.encode import group_pods as jgroup
    from karpenter_tpu_torch.solver.encode import group_pods as tgroup
    jplan = jdelta.plan(jrec, jin2, jgroup(jin2.pods),
                        js._delta_cache.dirty_snapshot(), 0,
                        (1, 4, 8, 16, 32, 128, 512, 2048))
    tplan = tdelta.plan(trec, tin2, tgroup(tin2.pods),
                        ts._delta_cache.dirty_snapshot(), 0,
                        (1, 4, 8, 16, 32, 128, 512, 2048))
    assert not isinstance(jplan, str) and not isinstance(tplan, str)
    assert (jplan.m, jplan.reuse) == (tplan.m, tplan.reuse)
    jsp, tsp = jdelta.build(jplan, jcat), tdelta.build(tplan, tcat)
    _arrays_equal(jsp, tsp, ("group_req", "group_count", "group_mask",
                             "exist_cap", "exist_remaining", "seed_used",
                             "seed_pool", "seed_colmask", "A", "reencoded"))
    assert jsp.A > 0
    # the chunk seeds: entry, projection and fold of the record's encoding
    # against the record's own output, split at the middle
    jenc, tenc = jrec.enc, trec.enc
    j0, t0 = jdelta.chunk_entry_seed(jenc), tdelta.chunk_entry_seed(tenc)
    _arrays_equal(j0, t0, SEED_FIELDS)
    G = jenc.n_groups
    hi = G // 2
    jp = jdelta.project_chunk(j0, jenc, jcat, 0, hi, 1024, {})
    tp = tdelta.project_chunk(t0, tenc, tcat, 0, hi, 1024, {})
    assert (jp is None) == (tp is None)
    # without existing nodes the open-new-only projection never declines
    assert jp is not None or n_existing
    if jp is not None:
        _arrays_equal(jp, tp, SEED_FIELDS)
        assert jdelta.seed_digest(jp) == tdelta.seed_digest(tp)
    # the first half's output: the nodes its groups opened (openers come
    # in node order), their rows of the record's take rows
    na = int((jrec.out_tn[:hi] > 0).any(axis=0).sum())
    out = dict(take_exist=jrec.out_te[:hi],
               take_new=jrec.out_tn[:hi, :na], num_active=na,
               used=np.zeros((na, 6), np.float32),
               node_pool=jrec.node_pool[:na])
    jf = jdelta.fold_chunk(j0, jenc, jcat, 0, hi, out, {})
    tf = tdelta.fold_chunk(t0, tenc, tcat, 0, hi, out, {})
    assert jf is not None and tf is not None
    _arrays_equal(jf, tf, SEED_FIELDS)
    assert jdelta.seed_digest(jf) == tdelta.seed_digest(tf)
    # project from a non-empty seed too
    jp2 = jdelta.project_chunk(jf, jenc, jcat, hi, G, 1024, {})
    tp2 = tdelta.project_chunk(tf, tenc, tcat, hi, G, 1024, {})
    assert (jp2 is None) == (tp2 is None)
    if jp2 is not None:
        assert jdelta.seed_digest(jp2) == tdelta.seed_digest(tp2)


def test_vocabularies_are_the_reference_s():
    from karpenter_tpu.solver import explain as jexplain
    for name in ("DELTA_FALLBACK_REASONS", "SPEC_FALLBACK_REASONS",
                 "INCR_FALLBACK_REASONS"):
        assert getattr(texplain, name) == getattr(jexplain, name), name
    for name in ("DELTA_MIN_GROUPS", "SEED_BUCKETS", "SPEC_MIN_GROUPS"):
        assert getattr(tdelta, name) == getattr(jdelta, name), name


# -- solves in lockstep -------------------------------------------------------
class Twin:
    """A TPUSolver and a TorchSolver(device="cpu") with the same knobs, fed
    the same inputs: each JAX object is converted once (the memo persists
    across passes), so objects the scenario reuses stay the same objects
    on the port's side too."""

    def __init__(self, **kw):
        self.j = TPUSolver(mesh="off", **kw)
        self.t = TorchSolver(device="cpu", **kw)
        self.memo = {}
        self.keep = []   # the converted JAX objects stay alive (id keys)

    def port(self, obj):
        self.keep.append(obj)
        return to_port(obj, self.memo)

    def solve(self, inp, what=""):
        rj = self.j.solve(inp)
        rt = self.t.solve(self.port(inp))
        assert canon(rt) == canon(rj), what
        assert self.outcome("t") == self.outcome("j"), what
        return rj, rt

    def invalidate(self, **kw):
        self.j.delta_invalidate(**kw)
        self.t.delta_invalidate(**self.port(kw))

    def outcome(self, side="t"):
        c = (self.t if side == "t" else self.j)._delta_cache
        return c.last_outcome, c.last_reason


def _lockstep(inputs, **kw):
    """Solve each input on a Twin and on a delta-off TorchSolver; return
    the twin and the port's outcomes."""
    tw = Twin(**kw)
    off = TorchSolver(device="cpu", delta="off")
    outcomes = []
    for i, inp in enumerate(inputs):
        _, rt = tw.solve(inp, f"pass {i}")
        assert canon(off.solve(to_port(inp))) == canon(rt), f"pass {i}"
        outcomes.append(tw.outcome())
    return tw, outcomes


def test_engages_and_matches_full():
    existing = sd.mknodes(4)
    tw, outs = _lockstep([sd.mkinput(sd.churn_pods(g), existing)
                          for g in range(4)], delta="on")
    assert outs == [("fallback", "cold")] + [("delta", None)] * 3
    assert tw.t.delta_passes == {"delta": 3, "fallback": 1}
    assert tw.t._delta_cache.last_reencoded == 3


def test_identical_input_is_pure_reuse():
    existing = sd.mknodes(3)
    pods = sd.churn_pods(0)
    tw, outs = _lockstep([sd.mkinput(list(pods), existing)] * 2,
                         delta="on")
    assert outs[-1] == ("delta", None)
    assert tw.t._delta_cache.last_reencoded == 0


def test_tail_removal_and_prefix_opened_nodes():
    full = sd.churn_pods(0)
    shorter = [p for p in full if not p.meta.name.startswith("c29-")]
    _, outs = _lockstep([sd.mkinput(list(full)), sd.mkinput(shorter)],
                        delta="on")
    assert outs[-1] == ("delta", None)
    inputs = []
    for gen in range(3):
        pods = [sd.mkpod(f"big{g}-{i}", cpu_m=3000 - g * 100)
                for g in range(6) for i in range(3)]
        pods += [sd.mkpod(f"tiny-{gen}-{i}", cpu_m=100, mem_mi=128)
                 for i in range(4)]
        inputs.append(sd.mkinput(pods))
    _, outs = _lockstep(inputs, delta="on")
    assert outs[1:] == [("delta", None)] * 2


def _fallback_case(kind):
    """(warm input, next input, expected port outcome) of one fallback
    class of tests/test_solver_delta.py TestDeltaFallbacks/TestDeltaGang."""
    from karpenter_tpu.models import (PodAffinityTerm, Requirement,
                                      Requirements, Resources, wellknown)
    from karpenter_tpu.scheduling import ExistingNode
    pods = sd.churn_pods(0)
    existing = sd.mknodes(4)
    warm = sd.mkinput(list(pods), existing)
    if kind == "nodes":
        changed = list(existing)
        changed[1] = ExistingNode(
            node=existing[1].node,
            available=existing[1].available - Resources.of(cpu=1000),
            pods=[])
        return warm, sd.mkinput(list(pods), changed)
    if kind == "node-growth":
        return warm, sd.mkinput(list(pods), sd.mknodes(5))
    if kind == "cold":
        return warm, sd.mkinput(list(pods), existing,
                                catalog=sd.CATALOG_B)
    if kind == "topology":
        churned = list(pods)
        churned[-1] = sd.mkpod(
            "anti-0", cpu_m=100, labels={"app": "a"},
            pod_affinities=[PodAffinityTerm(
                label_selector={"app": "a"},
                topology_key=wellknown.ZONE_LABEL,
                required=True, anti=True)])
        return warm, sd.mkinput(churned, existing)
    if kind == "limits":
        nxt = sd.mkinput(list(pods), existing)
        nxt.remaining_limits = {
            "default": Resources.of(cpu=10 ** 9, memory=10 ** 9)}
        return warm, nxt
    if kind == "bucket":
        churned = [sd.mkpod("c0-churned", cpu_m=2000)] + pods[1:]
        return warm, sd.mkinput(churned, existing)
    if kind == "stranded":
        doomed = sd.mkpod("doomed-0", cpu_m=50, mem_mi=64)
        doomed.requirements = Requirements(Requirement.make(
            wellknown.ZONE_LABEL, "In", "zone-that-does-not-exist"))
        return warm, sd.mkinput(list(pods) + [doomed], existing)
    if kind == "priority":
        hi = sd.mkpod("prio-hi-0", cpu_m=300)
        hi.priority = 1000
        return warm, sd.mkinput(list(pods) + [hi], existing)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,reason", [
    ("nodes", "nodes"), ("node-growth", "nodes"), ("cold", "cold"),
    ("topology", "topology"), ("limits", "limits"), ("bucket", "bucket"),
    ("stranded", "stranded"), ("priority", "priority")])
def test_fallbacks_match_reference(kind, reason):
    warm, nxt = _fallback_case(kind)
    tw, outs = _lockstep([warm, nxt], delta="on")
    assert outs[-1] == ("fallback", reason)
    assert tw.t.delta_fallbacks.get(reason, 0) >= 1


@pytest.mark.parametrize("dom", ["slice", "none"])
def test_gang_prefix_engages_and_dirty_member_falls_back(dom):
    G = sd.TestDeltaGang._gang_pods
    inputs = [sd.mkinput(list(G(dom=dom) + sd.churn_pods(g)))
              for g in range(3)]
    tw, outs = _lockstep(inputs, delta="on")
    assert outs[-1] == ("delta", None)
    # a dirty MEMBER drops the gang into the suffix: counted "gang"
    tw.invalidate(pods=["dgang-0"])
    tw.solve(inputs[-1], "dirty gang member")
    assert tw.outcome() == ("fallback", "gang")


def test_invalidation_dirty_node_and_pod():
    pods = sd.churn_pods(0)
    existing = sd.mknodes(3)
    tw = Twin(delta="on")
    tw.solve(sd.mkinput(list(pods), existing))
    tw.solve(sd.mkinput(list(pods), existing))
    assert tw.outcome() == ("delta", None)
    tw.invalidate(nodes=["dn1"])
    tw.solve(sd.mkinput(list(pods), existing))
    assert tw.outcome() == ("fallback", "nodes")
    tw.invalidate(pods=[pods[-1].meta.name])
    tw.solve(sd.mkinput(list(pods), existing))
    assert tw.outcome() == ("delta", None)
    assert tw.t._delta_cache.last_reencoded == 1
    tw.invalidate(flood=True)
    tw.solve(sd.mkinput(list(pods), existing))
    assert tw.outcome() == ("fallback", "nodes")


def test_knob_grammar(monkeypatch):
    assert TorchSolver(device="cpu")._resolve_delta() == "auto"
    assert TorchSolver(device="cpu", delta="off")._resolve_delta() is False
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "1")
    assert TorchSolver(device="cpu", delta="off")._resolve_delta() == "on"
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "bogus")
    assert TorchSolver(device="cpu", delta="off")._resolve_delta() is False
    monkeypatch.setenv("KARPENTER_TPU_DELTA", "off")
    s = TorchSolver(device="cpu", delta="on")
    s.solve(to_port(sd.mkinput(sd.churn_pods(0))))
    s.solve(to_port(sd.mkinput(sd.churn_pods(1))))
    assert s.delta_passes == {} and s._delta_cache.last_outcome is None
    with pytest.raises(AssertionError):
        s._delta_fallback("made-up-reason")


def test_auto_gates_small_problems():
    tw = Twin(delta="auto")
    pods = sd.churn_pods(0, n_groups=10)
    tw.solve(sd.mkinput(list(pods)))
    tw.solve(sd.mkinput(list(pods)))
    assert tw.outcome() == ("fallback", "cold")   # no record under 24


def _fuzz_seed(seed, passes):
    """`tests/test_solver_delta.py` `_fuzz_seed`'s generator on a Twin:
    removals, additions, resizes and occasional node churn."""
    import random
    rng = random.Random(seed)
    existing = sd.mknodes(rng.randint(0, 6))
    pods = {}
    uid = [0]

    def add(k):
        cpu, mem = sd.SIZES[k % len(sd.SIZES)]
        name = f"f{seed}-p{uid[0]}"
        uid[0] += 1
        pods[name] = sd.mkpod(name, cpu_m=cpu, mem_mi=mem)

    for k in range(30):
        for _ in range(rng.randint(2, 8)):
            add(k)
    tw = Twin(delta="on")
    for pass_i in range(passes):
        plist = sorted(pods.values(), key=lambda p: p.meta.name)
        tw.solve(sd.mkinput(list(plist), existing),
                 f"seed {seed} pass {pass_i}")
        names = list(pods)
        for _ in range(rng.randint(1, 10)):
            if rng.random() < 0.4 and names:
                pods.pop(rng.choice(names), None)
                names = list(pods)
            else:
                add(rng.randint(0, len(sd.SIZES) - 1))
        if rng.random() < 0.2:
            existing = sd.mknodes(rng.randint(0, 6))
    assert sum(tw.t.delta_passes.values()) == passes


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_parity(seed):
    _fuzz_seed(seed, passes=4)


def test_cuda_solver_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TorchSolver(delta="on").solve(to_port(sd.mkinput(
            sd.churn_pods(0))))
