"""BASELINE configs #1, #6 and #13 in the port against the JAX package.

Each input is built once from each package's classes: the port's by
`karpenter_tpu_torch.workloads` (`build_config1`, `build_config6`,
`build_config13`), the JAX package's by the benchmark's own builders
(`benchmarks/config1_inflate.py`, `config6_interruption.py`,
`config13_warm_million.py`) or by the same workloads builder given the
JAX package's classes.

  * #1 at full size: `TorchSolver(device="cpu")` and `TPUSolver` give the
    same canonical result and hex price, `chip_smoke.CONFIG1`;
  * #6 at 1,500 messages: the same deleted claims, offerings marked
    unavailable and drained queue as the JAX package's environment;
  * #13 at 50k pods: every generation of the incr and walk stories gives
    `chip_smoke.CONFIG13` (the JAX package's digests), the timed passes
    engaged; at 8,000 pods both packages give the same digests pass by
    pass; at 1,000,000 pods every count and capacity stays f32-exact.

`python3 tests/test_torch_configs.py --pin` prints the JAX package's
answers at chip_smoke.py's sizes (`CONFIG1`, `CONFIG6` at 15,000
messages, `CONFIG13_1M`: 1,000,000 pods over 11 generations, several
minutes and a few GB on the CPU); not run by pytest.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from karpenter_tpu_torch import workloads  # noqa: E402
from karpenter_tpu_torch.solver import TorchSolver  # noqa: E402
from tests.test_torch_delta import one_torch_thread  # noqa: E402,F401
from tests.test_torch_solve import canon  # noqa: E402

C6_MESSAGES = 1_500
C13_SMALL = 8_000
C13_SMALL_GENS = 4
F32_EXACT = 1 << 24


def jax_package():
    import karpenter_tpu.env as jenv
    import karpenter_tpu.models as jmodels
    from karpenter_tpu.operator.options import Options
    return workloads.Package(M=jmodels, Environment=jenv.Environment,
                             Options=Options)


def jax_config1():
    from benchmarks import config1_inflate
    return config1_inflate.make_input()


def jax_solver():
    from karpenter_tpu.solver import TPUSolver
    return TPUSolver(mesh="off", delta="off", spec="off", incr="off")


def _answer(res):
    return (res.node_count(), len(res.unschedulable),
            res.total_price().hex())


# -- #1 -------------------------------------------------------------------
def test_config1_matches_reference():
    ref = jax_solver().solve(jax_config1())
    got = TorchSolver(device="cpu").solve(workloads.build_config1())
    assert canon(got) == canon(ref)
    assert _answer(got) == _answer(ref) == chip_smoke.CONFIG1[:3]
    assert chip_smoke.result_digest(got) == chip_smoke.CONFIG1[3]


def test_config1_is_the_benchmarks_shape():
    inp = workloads.build_config1()
    ref = jax_config1()
    assert [p.meta.name for p in inp.pods] == [p.meta.name
                                              for p in ref.pods]
    assert [p.requests.v for p in inp.pods] == [p.requests.v
                                                for p in ref.pods]
    cat, rcat = inp.instance_types["default"], ref.instance_types["default"]
    assert [it.name for it in cat] == [it.name for it in rcat]
    assert len(cat) == workloads.CONFIG1_TYPES
    assert not any(it.capacity.get("nvidia.com/gpu") for it in cat)


# -- #6 -------------------------------------------------------------------
def _drained(env):
    out = workloads.drain_config6(env)
    for k in ("drain_s", "msgs_per_s"):
        assert out.pop(k) > 0
    return out


@pytest.fixture(scope="module")
def config6_reference():
    return _drained(workloads.build_config6(C6_MESSAGES,
                                            pkg=jax_package()))


def test_config6_drain_matches_reference(config6_reference):
    got = _drained(workloads.build_config6(C6_MESSAGES, device="cpu"))
    assert got == config6_reference
    assert got["drained"] and got["messages"] == C6_MESSAGES
    # the mix: spot interruptions (i % 4 in 0, 1) and "stopping" state
    # changes (2) delete their claim; rebalances (3) do not
    assert got["claims_deleted"] == 3 * C6_MESSAGES // 4
    assert got["names_digest"] == workloads.names_digest(got["deleted"])


def test_config6_matches_the_benchmarks_builder(config6_reference,
                                                monkeypatch):
    from benchmarks import config6_interruption as c6
    monkeypatch.setattr(c6, "N_MESSAGES", C6_MESSAGES)
    env = c6.build_env()
    assert c6.enqueue(env) == C6_MESSAGES
    assert _drained(env) == config6_reference


# -- #13 ------------------------------------------------------------------
def _c13_story(n_pods, gens, digest, stories=("incr", "walk")):
    """Config #13 at `n_pods` through `stories` of chip_smoke.py phase
    12's incr and walk (spec off, delta auto, the incr solver fed each
    generation's watch events): each pass's digest by `digest`, and the
    solvers."""
    solvers = {name: TorchSolver(max_nodes=2048, device="cpu", spec="off",
                                 incr="on" if name == "incr" else "off")
               for name in stories}
    out = {name: [] for name in stories}
    for g in range(gens):
        inp, events = workloads.build_config13(n_pods, g)
        for name, solver in solvers.items():
            if name == "incr" and events:
                solver.delta_invalidate(pods=tuple(events), pod_objs=events)
            out[name].append(digest(solver.solve(inp)))
    return out, solvers


def test_config13_50k_gives_the_pins():
    got, s = _c13_story(chip_smoke.CONFIG13_PODS, len(chip_smoke.CONFIG13),
                        chip_smoke.result_digest)
    want = list(chip_smoke.CONFIG13)
    assert got == {"incr": want, "walk": want}
    warm = len(chip_smoke.CONFIG13) - 1
    assert s["incr"].incr_passes == {"fallback": 1, "incr": warm}
    assert (s["incr"].delta_passes == s["walk"].delta_passes
            == {"fallback": 1, "delta": warm})


def test_config13_small_matches_reference():
    """Both packages at C13_SMALL pods, the JAX package through the
    benchmark's own Population (as `tests/steady_state_answers.py` takes
    the pins): the same digest every generation (the port's incr story;
    both stories meet the pins at 50k above)."""
    from benchmarks import config13_warm_million as c13
    from karpenter_tpu.models import NodePool, ObjectMeta
    from karpenter_tpu.scheduling import ScheduleInput
    from karpenter_tpu.solver import TPUSolver
    solver = TPUSolver(max_nodes=2048, mesh="off")
    pool = NodePool(meta=ObjectMeta(name="default"))
    existing = c13.build_existing(256)
    catalog = c13.build_catalog(max(c13.class_counts(C13_SMALL)))
    pop = c13.Population(C13_SMALL)
    ref = []
    for g in range(C13_SMALL_GENS):
        if g:
            pop.advance(g)
        ref.append(chip_smoke.result_digest(solver.solve(ScheduleInput(
            pods=pop.pods(), nodepools=[pool],
            instance_types={"default": catalog},
            existing_nodes=list(existing)))))
    got, _ = _c13_story(C13_SMALL, C13_SMALL_GENS, chip_smoke.result_digest,
                        stories=("incr",))
    assert got == {"incr": ref}


def test_config13_million_stays_f32_exact():
    """At the benchmark's top size the kernel's operands stay integers
    below 2^24 (ROADMAP ground rule 5): every class count, the machine's
    capacities, and a class's whole demand on one node."""
    from benchmarks import config13_warm_million as c13
    top = max(workloads.C13_SIZES)
    assert workloads.C13_SIZES == c13.SIZES
    counts = workloads._c13_counts(top)
    assert counts == c13.class_counts(top)
    assert sum(counts) == top
    (it,) = workloads._c13_catalog(max(counts))
    cap = it.capacity
    assert max(counts) == cap.get("pods") < F32_EXACT
    assert cap.get("cpu") < F32_EXACT and cap.get("memory") < F32_EXACT
    biggest = max(c * (2100 - 5 * g) for g, c in enumerate(counts))
    assert biggest < cap.get("cpu")


# -- pins -----------------------------------------------------------------
def _pin():
    """The JAX package's answers at chip_smoke.py's sizes, in the form it
    pins them."""
    import json

    from tests import steady_state_answers
    res = jax_solver().solve(jax_config1())
    print("CONFIG1", _answer(res) + (chip_smoke.result_digest(res),))
    out = workloads.drain_config6(workloads.build_config6(
        workloads.CONFIG6_MESSAGES, pkg=jax_package()))
    print("CONFIG6", json.dumps({k: out[k] for k in (
        "messages", "drained", "claims_deleted", "offerings_unavailable",
        "names_digest")}))
    print("CONFIG13_1M")
    steady_state_answers.main(["13", str(max(workloads.C13_SIZES)),
                               str(len(chip_smoke.CONFIG13))])


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin"]:
        _pin()
