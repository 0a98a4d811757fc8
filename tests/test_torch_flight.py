"""The port's flight recorder and solver metrics against the JAX package's.

The same inputs — the headline's shape at 2,000 pods (seeded: the
headline's eight size classes cycled), config #7's churn passes at test
size (`tests/test_solver_delta.py` `churn_pods`, delta on), the chunk
chain (spec on), soft terms through the relaxation loop, and the
whole-node, existing-node and zone-spread scenarios of
`tests/test_torch_encode.py`, the incremental index (incr on) — go
through `TPUSolver(mesh="off")` and `TorchSolver(device="cpu")`, each
package's flight ring reset before.  Every flight record must be equal
apart from the fields that differ from run to run or by definition,
which are stripped:

  * ``ts``, ``pid`` — the wall clock and the recording process;
  * ``trace_id`` — a random id (None here: tracing is off);
  * ``phase_ms`` — the phase timings;
  * ``retraces`` — the JAX package counts its XLA traces; the port
    records the first-use events of `solver/firstuse.py` over the
    attempt, asserted on its own below.

What stays compared: kind, seq, catalog identity, fingerprint, pods,
groups, knobs, the delta seam's outcome, the device-memory watermark (0
on the CPU in both), the result digest and the capture path.  The
deltas of the solver's metric families over each scenario must be equal
too (counters by label, histograms by observation count).

The unit cases follow `tests/test_flight.py`'s ring, gate, spill,
capture and telemetry-merge cases, parametrised over both packages.
"""

import importlib
import json
import os
import pickle
import sys
import threading
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from karpenter_tpu.solver import TPUSolver  # noqa: E402
from karpenter_tpu_torch.solver import TorchSolver, firstuse  # noqa: E402
from tests import test_solver_delta as sd  # noqa: E402
from tests.test_torch_encode import JAX, PORT, scenario  # noqa: E402
from tests.test_torch_relax import _stranding_soft  # noqa: E402
from tests.test_torch_solve import canon, headline  # noqa: E402
from tests.test_torch_sweep import to_port  # noqa: E402

STRIPPED = ("ts", "pid", "trace_id", "phase_ms", "retraces")

# the solver's metric families: counters and gauges by label, histograms
# by observation count
COUNTERS = ("SOLVER_SOLVES", "SOLVER_DELTA_PASSES", "SOLVER_SPEC_PASSES",
            "SOLVER_SPEC_CHUNKS", "SOLVER_INCR_PASSES",
            "RELAXATION_BUDGET_EXCEEDED", "SOLVER_HOST_REPAIRS",
            "SOLVER_GANG_REPAIRS", "SOLVER_RESIDUE_PODS",
            "SOLVER_ORACLE_BACKSTOP", "SOLVER_CONSTRAINT_ELIM",
            "FLIGHT_RECORDS", "SOLVER_DELTA_GROUPS_REENCODED")
HISTOGRAMS = ("RELAXATION_DURATION", "SOLVER_PHASE_DURATION")


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(root=root, fr=imp("utils.flightrecorder"),
                           metrics=imp("utils.metrics"),
                           telemetry=imp("utils.telemetry"))


FL = {"jax": _pkg("karpenter_tpu"), "port": _pkg("karpenter_tpu_torch")}


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
def fresh_recorders(monkeypatch):
    """Both packages' flight rings reset before and after each test, the
    knobs at their defaults."""
    for k in ("KARPENTER_TPU_FLIGHT", "KARPENTER_TPU_FLIGHT_DIR",
              "KARPENTER_TPU_FLIGHT_CAPTURE", "KARPENTER_TPU_FLIGHT_BUFFER",
              "KARPENTER_TPU_DELTA", "KARPENTER_TPU_SPEC",
              "KARPENTER_TPU_INCR", "KARPENTER_TPU_EXPLAIN"):
        monkeypatch.delenv(k, raising=False)
    for p in FL.values():
        p.fr.RECORDER.reset()
    yield
    for p in FL.values():
        p.fr.RECORDER.reset()


def _metric_state(p):
    m = p.metrics
    out = {}
    for name in COUNTERS:
        met = getattr(m, name)
        with met._lock:
            out[name] = dict(met._values)
    for name in HISTOGRAMS:
        met = getattr(m, name)
        with met._lock:
            out[name] = dict(met._totals)
    return out


def _metric_delta(before, after):
    out = {}
    for name, now in after.items():
        then = before[name]
        d = {k: v - then.get(k, 0) for k, v in sorted(now.items())
             if v != then.get(k, 0)}
        if name == "SOLVER_DELTA_GROUPS_REENCODED":
            # a gauge, emptied when the scenario starts (Side): the last
            # value a pass of the scenario set, if any
            d = dict(sorted(now.items()))
        if d:
            out[name] = d
    return out


def _records(p):
    return p.fr.RECORDER.tail(10_000)


def _stripped(recs):
    return [{k: v for k, v in r.items() if k not in STRIPPED}
            for r in recs]


class Side:
    """One package's solver over a scenario: the results, the flight
    records and the metric deltas; for the port also each solve's
    first-use delta."""

    def __init__(self, name, solver):
        self.p = FL[name]
        self.solver = solver
        self.results, self.first_use = [], []
        self.p.metrics.SOLVER_DELTA_GROUPS_REENCODED.remove()
        self._m0 = _metric_state(self.p)

    def solve(self, inp):
        f0 = firstuse.total()
        self.results.append(self.solver.solve(inp))
        self.first_use.append(firstuse.total() - f0)

    def finish(self):
        self.records = _records(self.p)
        self.metrics = _metric_delta(self._m0, _metric_state(self.p))
        return self


def _run(jax_solver, port_solver, inputs, port_inputs=None):
    """Solve `inputs` (JAX objects) on both sides in order; the port's
    inputs are `port_inputs` or the JAX ones converted (one memo, so
    objects the scenario reuses stay the same objects)."""
    if port_inputs is None:
        memo, keep = {}, []
        port_inputs = []
        for inp in inputs:
            keep.append(inp)
            port_inputs.append(to_port(inp, memo))
    j = Side("jax", jax_solver)
    for inp in inputs:
        j.solve(inp)
    j.finish()
    t = Side("port", port_solver)
    for inp in port_inputs:
        t.solve(inp)
    t.finish()
    for a, b in zip(t.results, j.results):
        assert canon(a) == canon(b)
    return j, t


def _check(j, t, n_records=None):
    assert _stripped(t.records) == _stripped(j.records)
    assert t.metrics == j.metrics
    if n_records is not None:
        assert len(t.records) == n_records
    assert all(r["device_memory_peak_bytes"] == 0 for r in t.records)


def test_headline_records_match_reference():
    j, t = _run(TPUSolver(mesh="off"), TorchSolver(device="cpu"),
                [headline(JAX, 2000)] * 2,
                [headline(PORT, 2000)] * 2)
    _check(j, t, n_records=2)
    rec = t.records[-1]
    assert rec["kind"] == "solve" and rec["pods"] == 2000
    assert rec["groups"] == 8
    assert rec["catalog"]["pools"] == ["default"]
    assert rec["result"]["price_hex"] == \
        float(t.results[-1].total_price()).hex()
    # one record a solve here, so each record's retraces field is that
    # solve's first-use delta
    assert [r["retraces"] for r in t.records] == t.first_use
    assert t.first_use[0] > 0
    assert t.metrics["SOLVER_SOLVES"] == {("device",): 2.0}
    assert t.metrics["FLIGHT_RECORDS"] == {("solve",): 2.0}


def test_delta_passes_match_reference():
    existing = sd.mknodes(4)
    inputs = [sd.mkinput(sd.churn_pods(g), existing) for g in range(4)]
    j, t = _run(TPUSolver(mesh="off", delta="on"),
                TorchSolver(device="cpu", delta="on"), inputs)
    _check(j, t, n_records=4)
    assert [r["kind"] for r in t.records] == \
        ["solve", "delta", "delta", "delta"]
    assert [r["delta"]["outcome"] for r in t.records] == \
        ["fallback", "delta", "delta", "delta"]
    assert t.records[-1]["delta"]["reencoded"] == 3
    assert t.metrics["SOLVER_DELTA_PASSES"] == {
        ("fallback",): 1.0, ("delta",): 3.0}
    assert [r["retraces"] for r in t.records] == t.first_use


def test_chunk_chain_records_match_reference():
    j, t = _run(TPUSolver(mesh="off", spec="on"),
                TorchSolver(device="cpu", spec="on"),
                [headline(JAX, 400)], [headline(PORT, 400)])
    _check(j, t, n_records=1)
    rec = t.records[0]
    assert rec["kind"] == "spec" and rec["knobs"]["spec"] == "on"
    assert rec["knobs"]["spec_chunks"] > 1
    assert t.metrics["SOLVER_SPEC_PASSES"] == {("spec",): 1.0}
    assert sum(t.metrics["SOLVER_SPEC_CHUNKS"].values()) == \
        rec["knobs"]["spec_chunks"] - 1


def test_relaxation_records_match_reference():
    j, t = _run(TPUSolver(mesh="off"), TorchSolver(device="cpu"),
                [_stranding_soft(JAX)], [_stranding_soft(PORT)])
    _check(j, t)
    assert len(t.records) >= 2  # one record a relaxation round
    assert t.metrics["RELAXATION_DURATION"] == {(): 1}


@pytest.mark.parametrize("name", ["whole-node-and-hostname",
                                  "existing-nodes", "zone-spread"])
def test_scenario_records_match_reference(name):
    j, t = _run(TPUSolver(mesh="off"), TorchSolver(device="cpu"),
                [scenario(JAX, name)], [scenario(PORT, name)])
    _check(j, t)
    assert t.records


def test_incr_passes_match_reference():
    inputs = [sd.mkinput(sd.churn_pods(g)) for g in range(3)]
    j, t = _run(TPUSolver(mesh="off", delta="on", incr="on"),
                TorchSolver(device="cpu", delta="on", incr="on"), inputs)
    _check(j, t, n_records=3)
    assert t.metrics["SOLVER_INCR_PASSES"]
    assert all(r["knobs"]["incr"] == "on" for r in t.records)


# -- tests/test_flight.py's unit cases, for both packages --------------------
@pytest.fixture(params=sorted(FL))
def p(request):
    return FL[request.param]


def test_always_on_and_bounded(p, monkeypatch):
    rec = p.fr.RECORDER
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_BUFFER", "4")
    rec.reset()  # re-read the ring size
    assert rec.enabled
    for i in range(10):
        rec.record(kind="solve", trace_id=f"t{i}")
    assert len(rec) == 4
    tail = rec.tail(32)
    assert [r["trace_id"] for r in tail] == ["t6", "t7", "t8", "t9"]
    assert tail[-1]["seq"] == 10 and rec.last_seq() == 10


def test_gate_off_and_empty_tails(p, monkeypatch):
    rec = p.fr.RECORDER
    assert rec.last_seq() is None
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT", "off")
    assert rec.record(kind="solve") is None
    assert len(rec) == 0
    monkeypatch.delenv("KARPENTER_TPU_FLIGHT")
    rec.record(kind="solve")
    assert rec.tail(0) == [] and rec.tail(-3) == []


def test_capture_requires_recorder_on(p, monkeypatch, tmp_path):
    rec = p.fr.RECORDER
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_CAPTURE", "1")
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT", "off")
    assert not rec.capture_enabled()
    monkeypatch.delenv("KARPENTER_TPU_FLIGHT")
    assert rec.capture_enabled()
    p1 = rec.capture_problem({"inp": 1})
    p2 = rec.capture_problem({"inp": 2})
    assert p1 != p2 and os.path.exists(p1) and os.path.exists(p2)


def test_trace_id_filter(p):
    rec = p.fr.RECORDER
    rec.record(kind="solve", trace_id="aaa")
    rec.record(kind="solve", trace_id="bbb")
    rec.record(kind="delta", trace_id="aaa")
    assert [r["kind"] for r in rec.tail(32, trace_id="aaa")] == \
        ["solve", "delta"]


def test_jsonl_spill_and_torn_lines(p, monkeypatch, tmp_path):
    rec = p.fr.RECORDER
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path))
    for i in range(6):
        rec.record(kind="solve", trace_id=f"t{i}", result={"nodes": i})
    path = tmp_path / f"flight-{os.getpid()}.jsonl"
    rows = p.fr.load_records(str(path))
    assert [r["result"]["nodes"] for r in rows] == list(range(6))
    lines = path.read_text(encoding="utf-8").splitlines()
    # a line torn mid-file costs that one record, a torn tail nothing
    lines[2] = lines[2][: len(lines[2]) // 2].rstrip('"{},')
    path.write_text("\n".join(lines) + '\n{"seq": 99, "trunc',
                    encoding="utf-8")
    assert [r["trace_id"] for r in p.fr.load_records(str(path))] == \
        ["t0", "t1", "t3", "t4", "t5"]
    rec.reset()  # close the spill


def test_spill_survives_concurrent_writers(p, monkeypatch, tmp_path):
    rec = p.fr.RECORDER
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path))
    writers, per = 8, 40
    barrier = threading.Barrier(writers)

    def hammer(w):
        barrier.wait()
        for i in range(per):
            rec.record(kind="solve", trace_id=f"w{w}-{i}")

    threads = [threading.Thread(target=hammer, args=(w,))
               for w in range(writers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    path = tmp_path / f"flight-{os.getpid()}.jsonl"
    rows = p.fr.load_records(str(path))
    assert sorted(r["seq"] for r in rows) == \
        list(range(1, writers * per + 1))
    with open(path, encoding="utf-8") as f:
        for ln in f:
            json.loads(ln)
    rec.reset()


def test_directory_load_stitches_in_mtime_order(p, tmp_path):
    for name, seqs, mtime in (("flight-200.jsonl", [3, 4], 2000.0),
                              ("flight-100.jsonl", [1, 2], 1000.0),
                              ("flight-9.jsonl", [10], 3000.0),
                              ("flight-10.jsonl", [20], 3000.0),
                              ("ledger-1.jsonl", [99], 1000.0)):
        path = tmp_path / name
        with open(path, "w") as f:
            for s in seqs:
                f.write(json.dumps({"seq": s, "kind": "solve"}) + "\n")
        os.utime(path, (mtime, mtime))
    rows = p.fr.load_records(str(tmp_path))
    # (mtime, name) is the total order; other prefixes are not stitched
    assert [r["seq"] for r in rows] == [1, 2, 3, 4, 20, 10]


def test_port_full_capture_roundtrip(monkeypatch, tmp_path):
    """The port's capture: the input pickled before the solve, referenced
    from the record, and a fresh solver's answer on it equal to the
    record's digest."""
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_CAPTURE", "1")
    rec = FL["port"].fr.RECORDER
    res = TorchSolver(max_nodes=64, device="cpu").solve(headline(PORT, 60))
    r = rec.tail(4)[-1]
    assert r["capture"] and os.path.exists(r["capture"])
    with open(r["capture"], "rb") as f:
        payload = pickle.load(f)
    assert len(payload["inp"].pods) == 60
    assert payload["solver_max_nodes"] == 64
    again = TorchSolver(max_nodes=64, device="cpu").solve(payload["inp"])
    assert again.node_count() == r["result"]["nodes"] == res.node_count()
    assert float(again.total_price()).hex() == r["result"]["price_hex"]
    rec.reset()


def test_port_gauges_update_with_recorder_off(monkeypatch):
    """The device-runtime gauges do not depend on the ring's gate."""
    m = FL["port"].metrics
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT", "off")
    m.SOLVER_DONATED_SLOTS.set(-1.0)
    TorchSolver(max_nodes=64, device="cpu").solve(headline(PORT, 30))
    assert m.SOLVER_DONATED_SLOTS.value() >= 0
    assert len(FL["port"].fr.RECORDER) == 0
    rendered = m.REGISTRY.render()
    assert "karpenter_tpu_solver_device_memory_peak_bytes" in rendered
    assert "karpenter_tpu_solver_donated_slots_in_use" in rendered


def test_port_device_memory_peak_reads_zero_without_a_card():
    from karpenter_tpu_torch.utils import profiling
    assert profiling.device_memory_peak() == 0


def test_local_snapshot_and_merge(p):
    tel = p.telemetry
    snap = tel.local_snapshot()
    for key in ("queue_depth", "solves", "phase_latency_ms", "delta",
                "service", "retraces", "flight_tail", "spans_dropped",
                "cost", "timeline"):
        assert key in snap, key
    a = {"queue_depth": 3, "solves_total": 10, "spans_dropped": 1,
         "service": {"retries": 2, "breaker_state": 0,
                     "worker_restarts": 0},
         "delta": {"passes": {"delta": 4, "fallback": 1}}}
    b = {"queue_depth": 1, "stats": {"shed": 5},
         "service": {"retries": 1, "breaker_state": 1,
                     "worker_restarts": 2},
         "delta": {"passes": {"delta": 2}}}
    c = {"restarts": 3, "running": True}
    fleet = tel.merge({"operator": a, "worker": b,
                       "supervisor": c})["fleet"]
    assert fleet["queue_depth"] == 4 and fleet["shed"] == 5
    assert fleet["breaker_state"] == 1 and fleet["worker_restarts"] == 3
    assert fleet["retries"] == 3
    assert fleet["delta_passes"] == {"delta": 6, "fallback": 1}
    doc = tel.merge({"operator": {"error": "boom"},
                     "worker": {"error": "also boom"}})
    assert doc["fleet"]["queue_depth"] == 0 and "cost" not in doc["fleet"]
    assert tel.render_html(doc).startswith("<!doctype html>")


def test_collect_and_sources(p):
    tel = p.telemetry

    def boom():
        raise RuntimeError("worker unreachable")
    doc = tel.collect(extra={"worker": boom})
    assert doc["processes"]["worker"]["error"].startswith(
        "worker unreachable")
    tel.register_source("x", lambda: {"queue_depth": 7})
    try:
        assert tel.collect()["processes"]["x"]["queue_depth"] == 7
    finally:
        tel.unregister_source("x")
    assert "x" not in tel.collect()["processes"]


def test_cost_rollup_and_html_escaping(p):
    tel = p.telemetry
    a = {"cost": {"fleet_hourly_cost": {"p/spot": 1.5},
                  "savings": {"single_node": 0.25},
                  "audit": {"match": 3}, "efficiency_lower_bound": 0.4}}
    b = {"cost": {"fleet_hourly_cost": {"p/spot": 0.5, "q/on-demand": 2.0},
                  "audit": {"match": 1, "diverged": 1},
                  "efficiency_lower_bound": 0.6}}
    cost = tel.merge({"a": a, "b": b})["fleet"]["cost"]
    assert cost["hourly_by_pool"] == {"p/spot": 2.0, "q/on-demand": 2.0}
    assert cost["hourly_total"] == 4.0
    assert cost["audit"] == {"match": 4, "diverged": 1}
    assert cost["efficiency_lower_bound"] == 0.6
    page = tel.html_page("t", [("rows", [{"pod": "<script>"}])])
    assert "<script>" not in page and "&lt;script&gt;" in page


def test_telemetry_pages_match_reference():
    doc = {"fleet": {"queue_depth": 2, "cost": {"hourly_total": 1.5}},
           "processes": {"operator": {"solves": {"device": 3}}}}
    assert FL["port"].telemetry.render_html(doc) == \
        FL["jax"].telemetry.render_html(doc)


def test_chip_smoke_headline_flight_is_the_ports():
    """chip_smoke.py's HEADLINE_FLIGHT (the JAX package's record, `--pin`
    below) is what the port's solve of the 50k headline records on the
    CPU: one record, the pinned fingerprint and catalog identity."""
    import chip_smoke
    port = TorchSolver(device="cpu")
    seq0 = chip_smoke._flight_seq()
    res = port.solve(headline(PORT, chip_smoke.HEADLINE_PODS))
    assert float(res.total_price()).hex() == chip_smoke.HEADLINE_PRICE_HEX
    assert chip_smoke._check_flight(seq0, 1, "test", "cpu") == []


def _pin():
    """The JAX package's flight record of the 50k headline's solve (mesh
    off): the fingerprint and catalog identity chip_smoke.py pins as
    HEADLINE_FLIGHT."""
    import chip_smoke
    from karpenter_tpu.utils import flightrecorder
    TPUSolver(mesh="off").solve(headline(JAX, chip_smoke.HEADLINE_PODS))
    rec = flightrecorder.RECORDER.tail(1)[0]
    print({"fingerprint": rec["fingerprint"], "catalog": rec["catalog"],
           "groups": rec["groups"], "result": rec["result"]})


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin"]:
        _pin()
