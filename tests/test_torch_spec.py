"""The port's speculative chunk chain against the JAX package's.

`TorchSolver(device="cpu", spec="on")` and `TPUSolver(mesh="off",
spec="on")` solve the scenarios of `tests/test_spec.py` (imported, not
edited) in lockstep: every committed, repaired and all-mispredicted chain
gives the canonical result and hex price of the JAX answer and of the
single program, with the same `last_spec` verdict (chunks, committed,
repaired); the chunk planner cuts the G axis as the reference's does at
every size; and every refused pass names the reference's fallback reason.
"""

import pytest

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import explain as texplain
from karpenter_tpu_torch.solver import pipeline as tpipe
from tests import test_spec as ts
from tests.test_torch_delta import Twin, one_torch_thread  # noqa: F401
from tests.test_torch_solve import canon
from tests.test_torch_sweep import to_port


# the chains' node axis on both sides (the scenarios open at most 280
# nodes): half the default's, for the plain scans' time
N = 512


def _spec_twin(inp, single=False, **kw):
    """One pass on a spec-on Twin: the results and the verdicts equal; with
    `single` also against the port's single program.  Returns the
    twin."""
    tw = Twin(max_nodes=N, **kw)
    _, rt = tw.solve(inp)
    assert tw.t.last_spec == tw.j.last_spec
    if single:
        off = TorchSolver(max_nodes=N, device="cpu", spec="off",
                          delta="off")
        assert canon(off.solve(to_port(inp))) == canon(rt)
        assert off.last_spec is None
    return tw


def test_committed_speculation_matches():
    tw = _spec_twin(ts.mkinput(ts.huge_pods()), single=True, spec="on")
    ls = tw.t.last_spec
    assert ls["outcome"] == "spec" and ls["chunks"] >= 2
    assert ls["committed"] == ls["chunks"] - 1 and ls["repaired"] == 0
    assert tw.t.spec_passes == {"spec": 1}
    assert tw.t.spec_chunks == {"committed": ls["chunks"] - 1}
    assert tw.t.last_phase_ms["spec_repair"] == 0.0


def test_repaired_divergence_matches():
    tw = _spec_twin(ts.mkinput(ts.varied_pods()), spec="on")
    ls = tw.t.last_spec
    assert ls["outcome"] == "spec" and ls["repaired"] > 0
    assert ls["committed"] + ls["repaired"] == ls["chunks"] - 1
    assert sum(tw.t.spec_chunks.values()) == ls["chunks"] - 1


def test_all_misprediction_degrades_to_sequential():
    tw = _spec_twin(ts.mkinput(ts.varied_pods(), ts.mknodes(12)),
                    spec="on")
    ls = tw.t.last_spec
    assert ls["outcome"] == "spec" and ls["committed"] == 0
    assert ls["repaired"] == ls["chunks"] - 1


def test_spec_output_feeds_the_delta_cache():
    pods = ts.varied_pods()
    churned = pods[:-2] + [ts.mkpod(f"w-{i}", cpu_m=333, mem_mi=512)
                           for i in range(2)]
    tw = Twin(max_nodes=N, spec="on", delta="on")
    tw.solve(ts.mkinput(list(pods)))
    assert tw.t.last_spec["outcome"] == "spec"
    tw.solve(ts.mkinput(list(churned)))
    assert tw.outcome() == ("delta", None)


def _refused(build):
    """build() → input: the pass is a counted spec fallback on
    both sides with the same reason; returns it."""
    tw = Twin(spec="on")
    tw.solve(build())
    assert tw.t.last_spec == tw.j.last_spec
    assert tw.t.last_spec["outcome"] == "fallback"
    reason = tw.t.last_spec["reason"]
    assert reason in texplain.SPEC_FALLBACK_REASONS
    assert tw.t.spec_fallbacks == {reason: 1}
    return reason


def _small():
    return ts.TestSpecFallbacks._small()


def test_fallback_gang():
    from karpenter_tpu.models import wellknown

    def build():
        pods = _small()
        for i in range(4):
            pods.append(ts.mkpod(f"gg-{i}", cpu_m=4000, annotations={
                wellknown.GANG_NAME_ANNOTATION: "gg",
                wellknown.GANG_SIZE_ANNOTATION: "4"}))
        return ts.mkinput(pods)
    assert _refused(build) == "gang"


def test_fallback_priority():
    def build():
        pods = _small()
        elevated = ts.mkpod("prio-0", cpu_m=3000)
        elevated.priority = 1000
        return ts.mkinput(pods + [elevated])
    assert _refused(build) == "priority"


def test_fallback_limits_price_cap_topology():
    from karpenter_tpu.models import PodAffinityTerm, Resources, wellknown

    def limits():
        inp = ts.mkinput(_small())
        inp.remaining_limits = {
            "default": Resources.of(cpu=10 ** 9, memory=10 ** 9)}
        return inp

    def topology():
        pods = _small()
        pods[0].pod_affinities = [PodAffinityTerm(
            label_selector={"app": "a"}, topology_key=wellknown.ZONE_LABEL,
            required=True, anti=True)]
        return ts.mkinput(pods)
    assert _refused(limits) == "limits"
    assert _refused(lambda: ts.mkinput(_small(), price_cap=1e9)) == \
        "price-cap"
    assert _refused(topology) == "topology"


def test_fallback_small_in_auto_and_off_uncounted():
    tw = Twin(spec="auto")
    tw.solve(ts.mkinput(_small()))
    assert tw.t.last_spec == tw.j.last_spec == {
        "outcome": "fallback", "reason": "small"}
    off = Twin(spec="off")
    off.solve(ts.mkinput(_small()))
    assert off.t.last_spec is None and off.t.spec_passes == {}


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_planner_matches_reference(mode):
    for n in range(1, 2101):
        assert TorchSolver._plan_spec_chunks(n, mode) == \
            TPUSolver._plan_spec_chunks(n, mode), n


def test_chain_flushes_and_returns_the_flushed_handles():
    """run_spec_chain on a scripted chain: a divergence at boundary 1
    flushes the in-flight successors, which come back for the caller to
    keep alive; the re-dispatch runs from the true seed."""
    log = []

    def dispatch(k, seed):
        log.append(("d", k, seed))
        return (k, seed)

    def project(k, seed):
        return seed + 1 if k != 1 else seed + 100   # wrong guess at k=1

    def commit(k, seed, handle):
        return seed + 1

    ok, outcomes, flushed = tpipe.run_spec_chain(
        5, 0, dispatch, project, commit, lambda a, b: a == b)
    assert ok and outcomes == ["committed", "repaired", "committed",
                               "committed"]
    assert flushed == [(2, 101), (3, 102)] and ("d", 2, 2) in log
