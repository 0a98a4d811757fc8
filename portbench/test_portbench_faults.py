"""A run with the timed path broken underneath comes out not correct:
an answer altered where the program produces it, a stale answer (the
solver's state left unchanged from the call before), and half of a
batch of simulations left out.  The harness runs on the CPU here, past
its look for a card."""

import pytest

from portbench import generate, harness

SEED = 2 ** 36 + 5
# the cells that `PERF.md` keeps open for a later PR (their files are
# here; `BENCHMARK.json` holds no such cells yet), passed in as data
OPEN = {w["name"]: w for w in (
    {"name": "consolidate2k.single", "config": "consolidate2k",
     "traffic": "single", "chips": 1, "why": "config #4, leave-one-out"},
    {"name": "consolidate2k.multi", "config": "consolidate2k",
     "traffic": "multi", "chips": 1, "why": "config #4, nested prefixes"},
    {"name": "mixed5k.cards4", "config": "mixed5k", "traffic": "cards4",
     "chips": 4, "why": "config #2 under mesh auto on four cards"})}


def _cfg(name):
    cfg = generate.load_config(name)
    if "classes" in cfg:
        for c in cfg["classes"]:
            c["count"] = max(c["count"] // 50, 1)
    else:
        cfg["nodes"] = 150
    return cfg


def _run(cell, cfg, options=None):
    return harness.run(cell, SEED, 0.5, False, device="cpu",
                       config=cfg, options=options,
                       workload=OPEN.get(cell))["result"]


def test_sound_runs_are_correct():
    assert _run("burst50k.cold", _cfg("burst50k"))["correct"]
    assert _run("consolidate2k.multi", _cfg("consolidate2k"))["correct"]


def test_an_altered_answer_is_caught(monkeypatch):
    from karpenter_tpu_torch.solver import solve as solvemod
    real = solvemod.TorchSolver._decode

    def altered(self, enc, out):
        res = real(self, enc, out)
        if res.new_claims:
            c = res.new_claims[-1]
            c.instance_type_names = list(reversed(c.instance_type_names))
            c.price = c.price * 1.0000001
        return res
    monkeypatch.setattr(solvemod.TorchSolver, "_decode", altered)
    res = _run("burst50k.cold", _cfg("burst50k"))
    assert res["correct"] is False and res["checks"]["claims_wrong"][
        "value"] > 0


def test_a_stale_answer_is_caught(monkeypatch):
    from karpenter_tpu_torch.controllers import state
    real = state.GatedSolver.solve
    memo = {}

    def stale(self, inp, source="solver", max_nodes=None):
        if "res" not in memo:
            memo["res"] = real(self, inp, source=source, max_nodes=max_nodes)
        return memo["res"]
    monkeypatch.setattr(state.GatedSolver, "solve", stale)
    res = _run("burst50k.cold", _cfg("burst50k"))
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["consolidate2k.single",
                                  "consolidate2k.multi"])
def test_half_a_batch_left_out_is_caught(monkeypatch, cell):
    from karpenter_tpu_torch.controllers import state
    real = state.GatedSolver.solve_batch

    def half(self, inps, source="disruption", max_nodes=None):
        k = len(inps) // 2
        got = list(real(self, inps[:k], source=source, max_nodes=max_nodes))
        return got + got[:len(inps) - k]
    monkeypatch.setattr(state.GatedSolver, "solve_batch", half)
    res = _run(cell, _cfg("consolidate2k"))
    assert res["correct"] is False


def _cards_options():
    from karpenter_tpu_torch.parallel import mesh
    return {"solver_mesh": mesh.card_mesh(["cpu"] * 4)}



def test_the_exchange_between_cards_left_out_is_caught(monkeypatch):
    """mixed5k.cards4's path on the CPU: the column-sharded scan over a
    mesh of four shards (K7x's plain version).  With every column
    reduction left at one rank's own shard (the last), as if the exchange
    between the cards never ran, the answers go wrong."""
    cfg = generate.load_config("mixed5k")
    for c in cfg["classes"]:
        c["count"] //= 5
    assert _run("mixed5k.cards4", cfg, _cards_options())["correct"]
    from karpenter_tpu_torch.solver import ffd

    def own_max(self, x, dim=0):
        return torch.chunk(x, self.S, dim=dim)[-1].amax(dim=dim)

    def own_any(self, x):
        return torch.chunk(x, self.S)[-1].any()
    import torch
    monkeypatch.setattr(ffd._Scan, "_cmax", own_max)
    monkeypatch.setattr(ffd._Scan, "_cany", own_any)
    res = _run("mixed5k.cards4", cfg, _cards_options())
    assert res["correct"] is False
