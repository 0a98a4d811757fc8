"""The plain reference gives the port's answers on the CPU, at a small
size of each configuration; the control (one guarantee broken) does not."""

import pytest

from portbench import adapter, generate
from portbench.harness import Tally
from portbench.reference import ffd as ref

SEED = 2 ** 35 + 77


def _small(name):
    cfg = generate.load_config(name)
    if "classes" in cfg:
        for c in cfg["classes"]:
            c["count"] = max(c["count"] // 25, 1)
    else:
        cfg["nodes"] = 120
    return cfg


def _solver():
    import torch
    torch.set_num_threads(1)
    from karpenter_tpu_torch.solver.solve import TorchSolver
    return TorchSolver(device="cpu")


@pytest.mark.parametrize("name, mix", [("burst50k", "cold"),
                                       ("mixed5k", "cards4")])
def test_reference_equals_the_port_on_bursts(name, mix):
    cfg = _small(name)
    tr = generate.load_traffic(mix)
    cols = ref.Columns(generate.catalog.load_table(cfg["catalog"]),
                       cfg["pools"])
    ad = adapter.Adapter()
    s = _solver()
    tally, control = Tally(), Tally()
    for prob in generate.bursts(cfg, tr, SEED)[:2]:
        want = ref.solve(prob, cols)
        tally.add(adapter.canonical(s.solve(ad.schedule_input(prob))), want)
        control.add(ref.solve(prob, cols, control=cfg["control"]), want)
    assert tally.correct(), tally.checks()
    assert want.claims and not want.unschedulable
    assert not control.correct(), control.checks()


@pytest.mark.parametrize("mix", ["single", "multi"])
def test_reference_equals_the_port_on_simulations(mix):
    cfg = _small("consolidate2k")
    tr = dict(generate.load_traffic(mix))
    if mix == "multi":
        tr["candidates"], tr["sims"] = 40, 16
    cols = ref.Columns(generate.catalog.load_table(cfg["catalog"]),
                       cfg["pools"])
    fl = generate.fleet(cfg)
    ad = adapter.Adapter()
    s = _solver()
    cands = generate.candidate_sets(cfg, tr, SEED, 0)
    got = s.solve_batch(ad.simulations(cfg, fl, cands),
                        max_nodes=cfg["max_nodes"])
    tally, control = Tally(), Tally()
    for r, cs in zip(got, cands):
        p = generate.simulation(cfg, fl, cs)
        want = ref.solve(p, cols)
        tally.add(adapter.canonical(r), want)
        control.add(ref.solve(p, cols, control=cfg["control"]), want)
    assert tally.correct(), tally.checks()
    assert not control.correct(), control.checks()


def test_reference_sees_price_cap_and_max_nodes():
    cfg = _small("consolidate2k")
    cfg["price_cap"] = 0.01
    cfg["node_allocatable"] = {"cpu": 600, "memory": 32768, "pods": 58}
    cols = ref.Columns(generate.catalog.load_table(cfg["catalog"]),
                       cfg["pools"])
    fl = generate.fleet(cfg)
    p = generate.simulation(cfg, fl, [0, 1, 2])
    want = ref.solve(p, cols)
    got = _solver().solve_batch(adapter.Adapter().simulations(
        cfg, fl, [[0, 1, 2]]), max_nodes=cfg["max_nodes"])[0]
    tally = Tally()
    tally.add(adapter.canonical(got), want)
    assert tally.correct(), tally.checks()
