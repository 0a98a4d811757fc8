"""The port's decision ledger (`karpenter_tpu_torch/utils/ledger.py`)
against the JAX package's.

The loops: the 40-node disruption loop of `tests/test_torch_disruption.py`
(its three waves) and a small provisioning loop of
`tests/test_torch_provisioning.py` run in both packages, each package's
ledger ring reset before and wide enough to hold every record.  Every
record must be equal, field for field, with the prices compared as IEEE
hex, apart from the fields that differ from run to run and are stripped
(`workloads.LEDGER_NONDETERMINISTIC`):

  * ``ts`` — the wall-clock time of the record;
  * ``pid`` — the recording process;
  * ``trace_id`` — a random id (None here: tracing is off).

``seq`` and ``flight_seq`` stay: the ledger's own order and the flight
recorder's newest solve at each decision must match too.  `fleet_cost`
after every wave (as hex), `summarize` over the records and
`workloads.WaveObserver`'s per-wave record (records by source, the hex
savings, the digest, the trajectory verdict) must be equal as well.

The unit cases follow `tests/test_ledger.py`'s ring, gate, spill, rollup
and fleet-telemetry cases, parametrised over both packages.
"""

import importlib
import os
import time
from types import SimpleNamespace

import pytest
import torch

from karpenter_tpu_torch import workloads
from tests import test_torch_provisioning as prov
from tests.test_torch_disruption import (
    JAX,
    PORT,
    fresh_catalog,
    loop_pkg,
    mkenv,
    mkpod,
)


def _obs(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        ledger=imp("utils.ledger"), flight=imp("utils.flightrecorder"),
        timeline=imp("timeline.recorder"), metrics=imp("utils.metrics"),
        telemetry=imp("utils.telemetry"),
        obs=workloads.Observability(
            metrics=imp("utils.metrics"), ledger=imp("utils.ledger"),
            invariants=imp("timeline.invariants"),
            flightrecorder=imp("utils.flightrecorder"),
            timeline=imp("timeline.recorder")))


OBS = {"jax": _obs("karpenter_tpu"), "port": _obs("karpenter_tpu_torch")}
PKGS = {"jax": JAX, "port": PORT}
SMALL_FLEET = 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scans on one intra-op thread (beside JAX in one process
    torch's default threads are ~15x slower); restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_rings(monkeypatch):
    """Both packages' process-global rings (ledger, flight, timeline)
    reset before each test, so any test order gives the same answers;
    the ledger ring is wide enough for a whole loop."""
    monkeypatch.setenv("KARPENTER_TPU_LEDGER_BUFFER", "100000")
    monkeypatch.delenv("KARPENTER_TPU_LEDGER_DIR", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_LEDGER", raising=False)
    for o in OBS.values():
        o.ledger.LEDGER.reset()
        o.flight.RECORDER.reset()
        o.timeline.RECORDER.reset()
    yield
    for o in OBS.values():
        o.ledger.LEDGER.reset()


def _strip(records):
    return [{k: v for k, v in r.items()
             if k not in workloads.LEDGER_NONDETERMINISTIC}
            for r in records]


def _hexed(records):
    """Records with every price field as its IEEE hex form."""
    out = []
    for r in _strip(records):
        r = dict(r)
        for k in ("fleet_cost_before", "fleet_cost_after", "cost_delta"):
            if r[k] is not None:
                r[k] = float(r[k]).hex()
        out.append(r)
    return out


def _disruption(name):
    """The 40-node loop's waves in package `name` with a WaveObserver
    over each: (waves, observations, every ledger record, the fleet $/hr
    hex after each wave)."""
    ns, o = PKGS[name], OBS[name]
    watch = workloads.WaveObserver(o.obs)
    env = workloads.disruption_loop(
        SMALL_FLEET, options=ns.Options(batch_idle_duration=0,
                                        solver_mesh="off"),
        catalog=fresh_catalog(ns), pkg=loop_pkg(ns))
    w = workloads.DisruptionWaves(env)
    waves, obs, costs = [], [], []
    for wave in (w.wave1, w.wave2, w.wave3):
        watch.start(env.cluster)
        waves.append(wave())
        obs.append(watch.finish(env.cluster))
        costs.append(float(o.ledger.fleet_cost(
            env.cluster, env.pricing)["total"]).hex())
    return waves, obs, o.ledger.LEDGER.tail(len(o.ledger.LEDGER)), costs


@pytest.fixture(scope="module")
def disruption_runs():
    for o in OBS.values():
        o.ledger.LEDGER.reset()
        o.flight.RECORDER.reset()
        o.timeline.RECORDER.reset()
    os.environ["KARPENTER_TPU_LEDGER_BUFFER"] = "100000"
    try:
        for o in OBS.values():
            o.ledger.LEDGER.reset()
        return {name: _disruption(name) for name in PKGS}
    finally:
        os.environ.pop("KARPENTER_TPU_LEDGER_BUFFER", None)


def test_disruption_loop_records_match_reference(disruption_runs):
    ref_waves, ref_obs, ref_recs, ref_costs = disruption_runs["jax"]
    waves, obs, recs, costs = disruption_runs["port"]
    assert waves == ref_waves
    assert _hexed(recs) == _hexed(ref_recs)
    assert costs == ref_costs
    assert obs == ref_obs
    # every decision source the loop drives wrote records
    sources = {r["source"] for r in recs}
    assert {"provisioning", "disruption", "termination",
            "interruption"} <= sources
    # the cost chain holds bit for bit, and savings were recorded
    assert all(o["verdict"]["ledger_hex_exact"] for o in obs)
    assert float.fromhex(obs[1]["ledger"]["savings"]) > 0
    # the flight cross-link points at real solves
    assert any(r["flight_seq"] for r in recs)


def test_disruption_loop_summary_matches_reference(disruption_runs):
    ref = OBS["jax"].ledger.summarize(disruption_runs["jax"][2])
    got = OBS["port"].ledger.summarize(disruption_runs["port"][2])
    assert got == ref
    assert got["by_source"]["termination"] > 0


def _provisioning(name):
    o = OBS[name]
    watch = workloads.WaveObserver(o.obs)
    loop = prov.build_loop(prov.JAX if name == "jax" else prov.PORT, 300)
    obs = []
    for wave in (1, 2):
        if wave == 2:
            prov.add_pods(loop, 30, "w", workloads.WAVE2_SIZES)
        watch.start(loop.cluster)
        loop.manager.run_until_idle()
        obs.append(watch.finish(loop.cluster))
    pricing = loop.manager.controllers[0].cp.instance_types.pricing
    cost = float(o.ledger.fleet_cost(loop.cluster, pricing)["total"]).hex()
    return obs, o.ledger.LEDGER.tail(len(o.ledger.LEDGER)), cost


def test_provisioning_loop_records_match_reference():
    ref_obs, ref_recs, ref_cost = _provisioning("jax")
    obs, recs, cost = _provisioning("port")
    assert _hexed(recs) == _hexed(ref_recs)
    assert obs == ref_obs and cost == ref_cost
    assert [r["source"] for r in recs] == ["provisioning"] * len(recs)
    # one launch record for wave 1; wave 2 lands on wave 1's nodes
    assert obs[0]["ledger"]["records"] == {"provisioning": 1}
    assert obs[1]["ledger"]["records"] == {}
    assert OBS["port"].ledger.summarize(recs) == \
        OBS["jax"].ledger.summarize(ref_recs)


# -- tests/test_ledger.py's unit cases, for both packages --------------------
@pytest.fixture(params=sorted(OBS))
def pkg(request):
    return OBS[request.param]


def test_bounded_ring_and_seq(pkg, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_LEDGER_BUFFER", "4")
    led = pkg.ledger.LEDGER
    led.reset()  # re-read the ring size
    for i in range(10):
        led.record("provisioning", "launch", detail=f"r{i}")
    assert len(led) == 4
    tail = led.tail(32)
    assert [r["detail"] for r in tail] == ["r6", "r7", "r8", "r9"]
    assert tail[-1]["seq"] == 10  # seq survives eviction


def test_gate_off(pkg, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_LEDGER", "off")
    assert pkg.ledger.LEDGER.record("provisioning", "launch") is None
    assert len(pkg.ledger.LEDGER) == 0


def test_tail_filters(pkg):
    led = pkg.ledger.LEDGER
    led.record("provisioning", "launch", pools=["a"])
    time.sleep(0.01)
    cut = time.time()
    led.record("disruption", "delete", pools=["b"])
    assert [r["pools"] for r in led.tail(8, pool="a")] == [["a"]]
    got = led.tail(8, since=cut)
    assert len(got) == 1 and got[0]["pools"] == ["b"]
    assert led.tail(0) == []


def test_cost_arithmetic_and_hex(pkg):
    rec = pkg.ledger.LEDGER.record(
        "disruption", "replace", fleet_cost_before=10.5, cost_delta=-0.3)
    assert rec.fleet_cost_after == 10.5 + (-0.3)
    assert rec.cost_delta_hex == float(-0.3).hex()


def test_jsonl_spill_and_load(pkg, monkeypatch, tmp_path):
    monkeypatch.setenv("KARPENTER_TPU_LEDGER_DIR", str(tmp_path))
    led = pkg.ledger.LEDGER
    led.reset()
    for i in range(3):
        led.record("expiration", "delete", cost_delta=-float(i))
    path = tmp_path / f"ledger-{os.getpid()}.jsonl"
    assert path.exists()
    rows = pkg.ledger.load_records(str(path))
    assert [r["cost_delta"] for r in rows] == [0.0, -1.0, -2.0]
    with open(path, "a") as f:
        f.write('{"seq": 99, "trunc')  # torn write from a crash
    assert len(pkg.ledger.load_records(str(path))) == 3
    led.reset()  # close the spill before the directory goes


def test_summarize_rollup(pkg):
    recs = [{"source": "provisioning", "cost_delta": 0.5,
             "fleet_cost_after": 0.5},
            {"source": "disruption", "cost_delta": -0.2,
             "fleet_cost_after": 0.3},
            # the settlement of the delete above: in by_source, not in
            # the savings headline
            {"source": "termination", "cost_delta": -0.2,
             "fleet_cost_after": 0.3}]
    s = pkg.ledger.summarize(recs)
    assert s["records"] == 3
    assert s["by_source"] == {"provisioning": 1, "disruption": 1,
                              "termination": 1}
    assert s["savings_dollars_per_hr"] == 0.2
    assert s["spend_added_dollars_per_hr"] == 0.5
    assert s["fleet_cost_after_last_decision"] == 0.3


def test_unknown_source_rejected(pkg):
    with pytest.raises(AssertionError):
        pkg.ledger.LEDGER.record("mystery", "launch")


def test_ensure_buffer_widens_an_unpinned_ring(pkg, monkeypatch):
    monkeypatch.delenv("KARPENTER_TPU_LEDGER_BUFFER", raising=False)
    pkg.ledger.ensure_buffer(700)
    try:
        led = pkg.ledger.LEDGER
        for i in range(600):
            led.record("provisioning", "launch")
        assert len(led) == 600
    finally:
        os.environ.pop("KARPENTER_TPU_LEDGER_BUFFER", None)
        pkg.ledger.LEDGER.reset()


def _fleet_gauges(name):
    """`update_fleet_metrics` after three pods settle in package `name`'s
    environment: the hourly-cost gauge equals the per-node sum as hex,
    and the packing and stranded gauges and the greedy bound are set.
    Returns (summary, cost series, packing series)."""
    ns, o = PKGS[name], OBS[name]
    env = mkenv(ns)
    for i in range(3):
        env.cluster.pods.create(mkpod(ns, f"p{i}", cpu="2", mem="4Gi"))
    env.settle()
    summary = o.ledger.update_fleet_metrics(env.cluster, env.cloud_provider)
    series = o.telemetry._series(o.metrics.FLEET_HOURLY_COST)
    manual = 0.0
    for node in env.cluster.nodes.list():
        manual += env.pricing.price(node.instance_type, node.zone,
                                    node.capacity_type) or 0.0
    assert manual > 0
    assert float(sum(series.values())).hex() == float(manual).hex()
    assert float(o.ledger.fleet_cost(env.cluster, env.pricing)[
        "total"]).hex() == float(manual).hex()
    pe = o.telemetry._series(o.metrics.PACKING_EFFICIENCY)
    assert any(k.startswith("default/cpu") for k in pe)
    assert o.telemetry._series(o.metrics.STRANDED_CAPACITY)[
        "default/cpu"] > 0
    assert 0.0 < o.metrics.FLEET_EFFICIENCY_BOUND.value() <= 1.0
    return summary, series, pe


def test_fleet_gauges_match_reference():
    assert _fleet_gauges("port") == _fleet_gauges("jax")
