"""The port's operator tools (`karpenter_tpu_torch/tools/`) against the
repository's JAX versions, on the CPU.

  * kt_ledger: the same provision → consolidate → terminate flow (two
    anchored nodes, the anchors scaled away) run in each package with its
    ledger spilled; each package's tool over its own spill prints the
    same JSON report (the run-to-run fields `ts`, `pid`, `trace_id`
    stripped) and the same text, with and without its filters;
  * kt_rewind `--generate smoke --seed 7 --seek 40`: the same exit code,
    checkpoint and state digests as `tools/kt_rewind.py`;
  * allocatable_diff: the same rows as `tools/allocatable_diff.py`;
  * the determinism harness: its canonical forms equal
    `hack/determinism_harness.py`'s on the same records, its drill
    perturbs them (as `tests/test_determinism_harness.py` holds the
    reference), one child run's digest document equals the reference
    child's, the double run exits 0 and the drill non-zero;
  * run_ha: the store daemon and two replicas on one lease, one leader,
    all three stopped on SIGTERM;
  * without a card and without `--device cpu`, each tool that solves
    exits non-zero naming the missing card.
"""

import importlib
import io
import json
import os
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hack import determinism_harness as jdh  # noqa: E402
from karpenter_tpu_torch import workloads  # noqa: E402
from karpenter_tpu_torch.tools import allocatable_diff  # noqa: E402
from karpenter_tpu_torch.tools import determinism as dh  # noqa: E402
from karpenter_tpu_torch.tools import kt_ledger, kt_rewind, run_ha  # noqa: E402,E501
from tests.test_torch_delta import one_torch_thread  # noqa: E402,F401
from tests.test_torch_disruption import fresh_catalog  # noqa: E402
from tools import allocatable_diff as jallocatable_diff  # noqa: E402
from tools import kt_ledger as jkt_ledger  # noqa: E402
from tools import kt_rewind as jkt_rewind  # noqa: E402


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, M=imp("models"), env=imp("env"),
        Options=imp("operator.options").Options, ledger=imp("utils.ledger"),
        flight=imp("utils.flightrecorder"), faults=imp("utils.faults"),
        catalog=imp("providers.catalog"))


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")
TOOLS = {"jax": (JAX, jkt_ledger), "port": (PORT, kt_ledger)}


@pytest.fixture(autouse=True)
def _port_faults_disarmed():
    """tests/conftest.py disarms the JAX package's fault registry around
    every test; the port keeps its own, disarmed here the same way."""
    PORT.faults.disarm()
    yield
    PORT.faults.disarm()


def _run(main, argv):
    """(exit code, stdout) of a tool's `main(argv)` in this process."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


def _rows(out):
    """A tool's printed lines without the controllers' log lines."""
    return [ln for ln in out.splitlines() if not ln.startswith("ts=")]


def _child_env(tmp):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               KARPENTER_TPU_FLIGHT_DIR=os.path.join(tmp, "flight"),
               KARPENTER_TPU_LEDGER_DIR=os.path.join(tmp, "ledger"),
               PYTHONPATH=ROOT)
    # XLA_FLAGS: tests/conftest.py forces 8 host devices, on which the
    # reference's rewind segment would resolve a mesh of 8 (a knob its
    # flight records carry); the harness runs with the host's one
    for k in ("KARPENTER_TPU_FAULTS", "KARPENTER_TPU_TIMELINE_DIR",
              "KARPENTER_TPU_FLIGHT_CAPTURE", "XLA_FLAGS"):
        env.pop(k, None)
    return env


# -- kt_ledger ------------------------------------------------------------
def _ledger_flow(ns, spill_dir, monkeypatch):
    """The two-anchored-nodes cycle (`benchmarks/common.py
    drive_two_anchor_cycle`) in `ns`'s package, its ledger spilled under
    `spill_dir`: two nodes provisioned, the anchors scaled away, the
    fleet consolidated and the retired nodes terminated.  Returns the
    spill's path."""
    M = ns.M
    monkeypatch.setenv("KARPENTER_TPU_LEDGER_DIR", str(spill_dir))
    ns.ledger.LEDGER.reset()
    ns.flight.RECORDER.reset()
    kw = {"device": "cpu"} if ns is PORT else {}
    # the default catalog read anew: the memoized one may carry another
    # test's doubled prices (tests/test_torch_disruption.py fresh_catalog)
    env = ns.env.Environment(options=ns.Options(batch_idle_duration=0),
                             catalog=fresh_catalog(ns), **kw)
    env.add_default_nodeclass()
    env.cluster.nodepools.create(M.NodePool(meta=M.ObjectMeta(
        name="default")))

    def mkpod(name, cpu, mem):
        return M.Pod(meta=M.ObjectMeta(name=name), requests=M.Resources.
                     parse({"cpu": cpu, "memory": mem}))

    for i in (1, 2):
        env.cluster.pods.create(mkpod(f"anchor-{i}", "15", "20Gi"))
        env.cluster.pods.create(mkpod(f"small-{i}", "700m", "512Mi"))
        env.settle()
    for i in (1, 2):
        env.cluster.pods.get(f"anchor-{i}").node_name = None
        env.cluster.pods.delete(f"anchor-{i}")
    for _ in range(3):
        env.clock.step(60.0)
        env.settle()
    ns.ledger.LEDGER.reset()  # closes the spill
    (spill,) = [os.path.join(spill_dir, f) for f in os.listdir(spill_dir)]
    return spill


@pytest.fixture(scope="module")
def ledger_spills(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        return {name: _ledger_flow(ns, tmp_path_factory.mktemp(name), mp)
                for name, (ns, _) in TOOLS.items()}
    finally:
        mp.undo()


def _stripped(doc):
    doc = json.loads(doc)
    for r in doc["records"]:
        for k in workloads.LEDGER_NONDETERMINISTIC:
            r.pop(k)
    return doc


def test_kt_ledger_flow_covers_every_decision(ledger_spills):
    _, out = _run(kt_ledger.main, [ledger_spills["port"], "--json"])
    doc = json.loads(out)
    assert {"provisioning", "disruption", "termination"} <= set(
        doc["summary"]["by_source"])
    assert doc["summary"]["savings_dollars_per_hr"] > 0


@pytest.mark.parametrize("flags", [
    (), ("--pool", "default"), ("--pool", "ghost"), ("--limit", "2"),
    ("--since", "0")], ids=lambda f: " ".join(f) or "all")
def test_kt_ledger_json_matches_reference(ledger_spills, flags):
    got = {name: _run(tool.main, [ledger_spills[name], "--json", *flags])
           for name, (_, tool) in TOOLS.items()}
    assert got["port"][0] == got["jax"][0] == 0
    assert _stripped(got["port"][1]) == _stripped(got["jax"][1])


def test_kt_ledger_text_matches_reference(ledger_spills):
    got = {name: _run(tool.main, [ledger_spills[name]])
           for name, (_, tool) in TOOLS.items()}
    assert got["port"] == got["jax"]
    assert "karpenter-tpu fleet spend ledger" in got["port"][1]


def test_kt_ledger_directory_and_bad_input(ledger_spills, tmp_path):
    spill_dir = os.path.dirname(ledger_spills["port"])
    assert (_run(kt_ledger.main, [spill_dir, "--json"])
            == _run(kt_ledger.main, [ledger_spills["port"], "--json"]))
    for name, (_, tool) in TOOLS.items():
        assert _run(tool.main, [str(tmp_path), "--json"])[0] == 0
        assert _run(tool.main, [str(tmp_path / "gone.jsonl")])[0] == 2


def test_kt_ledger_report_shapes():
    recs = [
        {"seq": 1, "source": "provisioning", "cost_delta": 1.0,
         "pools": ["a"], "ts": 10.0},
        {"seq": 2, "source": "disruption", "cost_delta": -0.25,
         "pools": ["b"], "ts": 20.0, "fleet_cost_after": 0.75},
    ]
    rep = kt_ledger.report(recs)
    assert rep == jkt_ledger.report(recs)
    assert rep["sources"]["disruption"]["saved"] == 0.25
    assert (kt_ledger.render_text(recs, rep)
            == jkt_ledger.render_text(recs, rep))
    for kw in ({"pool": "a"}, {"since": 15.0}, {"limit": 1}, {"limit": 0}):
        assert kt_ledger._filter(recs, **kw) == jkt_ledger._filter(recs,
                                                                   **kw)


# -- kt_rewind ------------------------------------------------------------
SMOKE = ["--generate", "smoke", "--seed", "7", "--seek", "40"]


def test_kt_rewind_seek_matches_reference(tmp_path):
    """Both tools in processes of their own, at once."""
    cmds = {"jax": [sys.executable, os.path.join(ROOT, "tools",
                                                 "kt_rewind.py")],
            "port": [sys.executable, "-m",
                     "karpenter_tpu_torch.tools.kt_rewind", "--device",
                     "cpu"]}
    out = {name: tmp_path / f"{name}.json" for name in cmds}
    procs = {name: subprocess.Popen(
        cmd + SMOKE + ["--out", str(out[name])], cwd=ROOT,
        env=_child_env(str(tmp_path / name)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, cmd in cmds.items()}
    rcs = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        rcs[name] = proc.returncode
        assert proc.returncode == 0, err[-2000:]
    docs = {k: json.loads(v.read_text()) for k, v in out.items()}
    keys = ("mode", "k", "straight_digest", "seek_digest", "bit_identical")
    assert ({k: docs["port"][k] for k in keys}
            == {k: docs["jax"][k] for k in keys})
    assert docs["port"]["bit_identical"] and docs["port"]["k"] == 38
    assert docs["port"]["report"]["device"] == "cpu"
    for k in ("events_applied", "solves", "invariants_held", "digest"):
        assert docs["port"]["report"][k] == docs["jax"]["report"][k], k


def test_kt_rewind_scenarios_match_reference():
    from karpenter_tpu.timeline import generators as jg  # noqa: F401
    for name in ("smoke", "storm"):
        assert (kt_rewind.build_scenario(name, 7)
                == jkt_rewind.build_scenario(name, 7))
    # `day` is config #11's day: the port's builder, not the benchmark's
    from benchmarks.config11_rewind import build_day
    assert kt_rewind.build_scenario("day", 3) == build_day(seed=3)
    with pytest.raises(SystemExit):
        kt_rewind.build_scenario("noon", 0)


# -- allocatable_diff -----------------------------------------------------
@pytest.mark.parametrize("extra", [(), ("--max-pods", "8")],
                         ids=["default", "max-pods"])
def test_allocatable_diff_matches_reference(extra, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_PLATFORM", "cpu")
    types = ("--types", ",".join(allocatable_diff.SAMPLE_TYPES))
    monkeypatch.setattr(sys, "argv", ["allocatable_diff.py", *types,
                                      *extra])
    ref = _run(lambda argv: jallocatable_diff.main(), None)
    got = _run(allocatable_diff.main, [*types, *extra, "--device", "cpu"])
    assert got[0] == ref[0] == 0
    assert _rows(got[1]) == _rows(ref[1])
    assert [r.split()[0] for r in _rows(got[1])] == list(
        allocatable_diff.SAMPLE_TYPES)


def test_allocatable_diff_default_sample_exists():
    """The port's default sample (no --types) exits 0; the reference's
    own default sample names types its catalog does not hold."""
    rc, out = _run(allocatable_diff.main, ["--device", "cpu"])
    assert rc == 0 and len(_rows(out)) == 4
    rc, _ = _run(allocatable_diff.main, ["--device", "cpu", "--types",
                                         "m6.large"])
    assert rc == 1


# -- the determinism harness ------------------------------------------------
def _rec(**over):
    rec = {"problem": "abc123", "result_digest": "deadbeef",
           "price_hex": "0x1.8p+3", "knobs": {"delta": "auto"},
           "ts": 1.0, "pid": 41, "phase_ms": {"encode": 2.0},
           "device_memory_peak_bytes": 512, "trace_id": "t-1",
           "capture": {"pods": []}, "retraces": 1}
    rec.update(over)
    return rec


def test_determinism_canon_matches_reference():
    assert dh.FLIGHT_EXCLUDE == jdh.FLIGHT_EXCLUDE
    assert dh.LEDGER_KEYS == jdh.LEDGER_KEYS
    recs = [_rec(), _rec(ts=99.0, pid=7, retraces=3, capture=None),
            _rec(price_hex="0x1.9p+3")]
    assert ([dh.canon_flight_record(r) for r in recs]
            == [jdh.canon_flight_record(r) for r in recs])
    assert dh.canon_flight_record(recs[0]) == dh.canon_flight_record(
        recs[1])
    row = {"source": "disruption", "action": "delete",
           "reason_code": "consolidation.emptiness",
           "cost_delta_hex": "-0x1.2p+1", "ts": 5.0, "seq": 3}
    assert dh.canon_ledger_row(row) == jdh.canon_ledger_row(row)
    assert set(dh.canon_ledger_row(row)) == set(dh.LEDGER_KEYS)
    for obj in (recs, [dh.canon_ledger_row(row)], {"a": [1.5, None]}):
        assert dh.digest(obj) == jdh.digest(obj)


def test_determinism_drill_perturbs_the_canonical_record():
    base = dh.canon_flight_record(_rec())
    PORT.faults.arm("determinism.digest", "error")
    try:
        drilled = dh.canon_flight_record(_rec())
        assert PORT.faults.fire_count("determinism.digest") == 1
    finally:
        PORT.faults.disarm()
    assert "_drill_perturbation" in drilled
    assert dh.digest([drilled]) != dh.digest([base])
    assert dh.canon_flight_record(_rec()) == base
    # the JAX registry is the reference's own: arming the port's leaves
    # the reference's canonical form clean
    assert "_drill_perturbation" not in jdh.canon_flight_record(_rec())


def test_determinism_child_matches_reference(tmp_path):
    """One scenario run of each package's harness, at once: the port's
    digest document (every scenario's result digest, the flight and
    ledger chains) equals the reference's."""
    cmds = {"jax": [sys.executable, os.path.join(ROOT, "hack",
                                                 "determinism_harness.py")],
            "port": [sys.executable, "-m",
                     "karpenter_tpu_torch.tools.determinism", "--device",
                     "cpu"]}
    procs = {}
    for name, cmd in cmds.items():
        tmp = str(tmp_path / name)
        procs[name] = subprocess.Popen(
            cmd + ["--run-child", tmp], env=_child_env(tmp), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    docs = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        docs[name] = json.loads(out.strip().splitlines()[-1])
    assert docs["port"] == docs["jax"]
    assert docs["port"]["flight_records"] > 0
    assert docs["port"]["ledger_rows"] > 0
    assert docs["port"]["rewind"]["invariants_held"]


@pytest.mark.parametrize("drill", [False, True], ids=["clean", "drill"])
def test_determinism_double_run(drill, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = dh.main(["--device", "cpu"] + (["--drill"] if drill else []))
    out, err = capsys.readouterr()
    if drill:
        assert rc != 0 and "MISMATCH flight_digest" in err
    else:
        assert rc == 0 and "[determinism] OK on cpu" in out


# -- run_ha -----------------------------------------------------------------
def test_run_ha_starts_one_leader_and_stops_on_sigterm(tmp_path):
    """`python -m karpenter_tpu_torch.tools.run_ha <dir>` (its replicas on
    ephemeral ports and the CPU): the store daemon and both replicas
    serve, one replica holds the lease, and SIGTERM stops all three and
    the launcher with exit code 0."""
    from karpenter_tpu_torch.operator.leaderelection import FileLease
    code = ("import sys\n"
            "from karpenter_tpu_torch.tools import run_ha\n"
            "run_ha.REPLICA_PORTS = ((0, 0), (0, 0))\n"
            f"sys.argv = ['run_ha', {str(tmp_path)!r}]\n"
            "sys.exit(run_ha.main())\n")
    env = dict(os.environ, KARPENTER_TPU_PLATFORM="cpu",
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    pids = []
    try:
        lines = []
        deadline = time.monotonic() + 120
        while sum("karpenter-tpu operator:" in ln for ln in lines) < 2:
            assert time.monotonic() < deadline, lines
            lines.append(proc.stdout.readline())
        up = next(ln for ln in lines if ln.startswith("HA pair up"))
        pids = [int(up.split("store pid ")[1].split(",")[0])] + [
            int(p) for p in up.split("replicas ")[1].split(".")[0].split("/")]
        lease = FileLease(str(tmp_path / "lease.json"))
        while lease.holder(now=time.time()) is None:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        assert lease.holder(now=time.time()) in ("rep-1", "rep-2")
        assert all(_alive(p) for p in pids)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert not any(_alive(p) for p in pids)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for p in pids:
            if _alive(p):
                os.kill(p, signal.SIGKILL)
        proc.stdout.close()


def _alive(pid):
    """Whether `pid` runs (a reaped child is gone; a zombie is not
    running)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


# -- no card ----------------------------------------------------------------
@pytest.mark.parametrize("tool,argv", [
    (kt_rewind, ["--generate", "smoke"]),
    (allocatable_diff, []),
    (dh, []),
], ids=["kt_rewind", "allocatable_diff", "determinism"])
def test_tools_without_a_card_exit_nonzero(tool, argv, monkeypatch):
    monkeypatch.delenv("KARPENTER_TPU_PLATFORM", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert e.value.code and "no CUDA" in str(e.value.code)
