"""Placement provenance in the port against the JAX package, on the CPU.

  * the reason trees: a pool-limit strand (oversized pods against a 1-cpu
    budget) solved by `TPUSolver` and `TorchSolver(device="cpu")` under
    KARPENTER_TPU_EXPLAIN=counts and =full (a fresh solver each, the mode
    pins at construction): every stranded pod's `Reason.tree` equal, the
    full mode's eliminated-columns detail included — the port's verdicts
    carried codes without trees before, and full mode was lowered to
    counts;
  * the explain=2 map: seeded problems (light, topology, gangs)
    through the JAX `ffd.solve_ffd(explain=2)` and the port's (K2's map
    pass's plain version): the flat rows, the [G, O] class map included,
    equal as uint32;
  * the vocabulary: the registry, event messages and the per-process
    store behave as the reference's.
"""

import numpy as np
import pytest

from karpenter_tpu.solver import explain as jexplain
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import explain as explainmod
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.problems import random_problem
from tests.test_torch_encode import JAX, PORT
from tests.test_torch_ffd import _jax_args
from tests.test_torch_solve import canon, headline, jax_solver


def _pool_limit_strand(ns):
    """24 pods of 2 cpu against a pool budget of 1 cpu: every pod strands
    on the limit."""
    inp = headline(ns, 24)
    for p in inp.pods:
        p.requests = ns.M.Resources.parse({"cpu": "2", "memory": "2Gi"})
    inp.remaining_limits = {"default": ns.M.Resources.parse({"cpu": "1"})}
    return inp


@pytest.mark.parametrize("mode", ["counts", "full"])
def test_stranded_pool_limit_trees_match_reference(mode, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_EXPLAIN", mode)
    ref = jax_solver().solve(_pool_limit_strand(JAX))
    port = TorchSolver(device="cpu")
    got = port.solve(_pool_limit_strand(PORT))
    assert canon(got) == canon(ref)
    assert got.unschedulable and set(got.unschedulable) \
        == set(ref.unschedulable)
    for name, r in ref.unschedulable.items():
        tree = getattr(got.unschedulable[name], "tree", None)
        assert tree is not None and tree == r.tree, name
    tree = next(iter(got.unschedulable.values())).tree
    kernel = tree.get("kernel", tree)
    assert kernel["eliminations"]["limit"] > 0
    assert ("eliminated_columns" in kernel) == (mode == "full")
    assert port._explain_mode() == explainmod.mode()
    assert port.last_explain["mode"] == mode


# (id, seed, random_problem kwargs, with_gang)
MAP_CASES = [
    ("light", 1, dict(D=4), 0),
    ("topology", 4, dict(topology=True, D=4), 0),
    ("gangs", 2, dict(gang=True, topology=True, D=4), 1),
    ("gangs-finite", 5, dict(gang=True, D=4, limits="finite"), 1),
]


@pytest.mark.parametrize("case", MAP_CASES, ids=[c[0] for c in MAP_CASES])
def test_explain_map_matches_jax_bitwise(case):
    name, seed, kw, wg = case
    prob, cat = random_problem(seed, **kw)
    ref = np.asarray(jffd.solve_ffd(
        *_jax_args(prob, cat, False), max_nodes=64, zc=cat["zc"],
        explain=2, with_gang=wg))
    p, c = tffd.problem_from_numpy(prob, cat, "cpu")
    out = tffd.solve_ffd(p, c, 64, explain=2, with_gang=wg).numpy()
    assert np.array_equal(ref.view(np.uint32), out.view(np.uint32)), name
    G, E, D = prob[0].shape[0], prob[4].shape[0], prob[8].shape[1]
    a = jffd.unpack(ref, G, E, 64, 6, D, explain=2, explain_o=c.O)
    b = tffd.unpack(out, G, E, 64, 6, D, explain=2, explain_o=c.O)
    assert b["explain_map"].dtype == np.int8
    assert np.array_equal(a["explain_map"], b["explain_map"])
    m = b["explain_map"]
    # every class partitions the admitted columns as the counts do
    counts = b["explain_counts"]
    for ci in range(4):
        assert np.array_equal((m == ci + 1).sum(axis=1), counts[:, ci])
    assert not m[~prob[2]].any()
    if name == "topology":
        assert (m == 3).any()
    stranded = (b["unsched"] > 0) & prob[14]
    if name == "gangs":
        assert (m[stranded] == 4).any()
    if name == "gangs-finite":
        assert stranded.any() and (m[stranded] == 2).any()


def test_full_mode_is_not_lowered(monkeypatch):
    """KARPENTER_TPU_EXPLAIN=full reaches the kernel: the solve pulls the
    [G, O] map (explain=2), and a batched solve runs counts at most, as
    the reference's batched lane."""
    monkeypatch.setenv("KARPENTER_TPU_EXPLAIN", "full")
    seen = []
    real = tffd.unpack

    def spy(*a, **kw):
        seen.append(kw.get("explain", 0))
        return real(*a, **kw)

    monkeypatch.setattr(tffd, "unpack", spy)
    solver = TorchSolver(device="cpu")
    solver.solve(_pool_limit_strand(PORT))
    assert seen and seen[0] == 2
    seen.clear()
    solver.solve_batch([_pool_limit_strand(PORT), _pool_limit_strand(PORT)])
    assert seen and set(seen) == {1}


def test_vocabulary_matches_reference():
    """The port's registry entries are the reference's; event messages
    and the store behave the same."""
    jreg = {r["code"]: r for r in jexplain.reason_table()}
    for r in explainmod.reason_table():
        assert jreg[r["code"]] == r
    for code in explainmod.PRIORITY_CODES | explainmod.GANG_CODES:
        assert code in jreg
    for name in explainmod.CONSTRAINTS:
        assert explainmod.constraint_help(name) \
            == jexplain.constraint_help(name) != ""
    r = explainmod.make(explainmod.POOL_LIMIT, "limit", {"code": "x"})
    assert explainmod.event_message(r) == jexplain.event_message(
        jexplain.make(jexplain.POOL_LIMIT, "limit"))
    assert explainmod.event_message("plain") == "plain"
    store = explainmod.ExplainStore(capacity=2, per_pod=2)
    store.register({"a": r, "b": r}, trace_id="t1")
    store.register({"c": r}, trace_id="t2")
    assert store.size() == 2 and store.lookup("a") is None
    assert store.lookup("c")["tree"] == {"code": "x"}
    assert [e["pod"] for e in store.recent()] == ["c", "b"]


DISRUPTION_CODES = (
    "CAPACITY_LAUNCHED", "CONSOLIDATION_DELETE", "CONSOLIDATION_REPLACE",
    "DRIFT_REPLACED", "NODE_EXPIRED", "INTERRUPTION_RECLAIM",
    "NODE_TERMINATED", "REPLACEMENT_NOT_CHEAPER", "SPOT_TO_SPOT_DISABLED",
    "SPOT_FLEXIBILITY_TOO_LOW", "CANDIDATE_NOT_RESCHEDULABLE",
    "BUDGET_BLOCKED", "NODEPOOL_DRIFT")


def test_registry_is_the_reference_one_for_one():
    """Every registered code of the reference, the disruption decision
    vocabulary with it, with its constraint and summary — and nothing
    else."""
    assert set(explainmod.REGISTRY) == set(jexplain.REGISTRY)
    for code, spec in jexplain.REGISTRY.items():
        mine = explainmod.REGISTRY[code]
        assert (mine.code, mine.constraint, mine.summary) == (
            spec.code, spec.constraint, spec.summary)
    for name in DISRUPTION_CODES:
        assert getattr(explainmod, name) == getattr(jexplain, name)
        assert explainmod.constraint_of(getattr(explainmod, name)) == "none"
    assert [r["code"] for r in explainmod.reason_table()] == [
        r["code"] for r in jexplain.reason_table()]
