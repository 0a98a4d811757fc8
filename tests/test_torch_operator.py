"""The port's operator process (`operator/operator.py`, `__main__.py`)
against the JAX package's.

`tests/test_operator.py`'s cases run on both packages' Operators (real
clock, real HTTP servers on ephemeral ports, the port's environment on
the CPU): pods provision under the live loop and `/metrics` scrapes,
`/healthz` and `/readyz` answer, `/debug/state` reports, `/readyz`
degrades when the cloud is down.  Every `/debug/*` route answers on the
port with the JSON keys of the JAX Operator's.  300 of the headline's
pods created before the loop starts end in the same fleet on both
packages (`workloads.loop_answer`).

The entry point: `python -m karpenter_tpu_torch` with
KARPENTER_TPU_PLATFORM=cpu boots, serves `/healthz` and exits on SIGTERM;
without a platform variable on this host (no card) it fails at boot,
naming the missing card, and never serves from the CPU.

The port's answer to a failed reconcile: on the card a device solve that
fails raises (no oracle), and the operator's loop must survive it — one
`ReconcileError` event, the pods still pending, and the next resync
binds them on the device path.
"""

import importlib
import json
import os
import select
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from karpenter_tpu_torch import workloads
from tests.test_torch_disruption import fresh_catalog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        root=root, M=imp("models"), env=imp("env"),
        op=imp("operator.operator"), Options=imp("operator.options").Options,
        clock=imp("utils.clock"), catalog=imp("providers.catalog"),
        metrics=imp("utils.metrics"), faults=imp("utils.faults"),
        state=imp("controllers.state"), ledger=imp("utils.ledger"),
        fr=imp("utils.flightrecorder"), tl=imp("timeline.recorder"),
        explain=imp("solver.explain"))


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")
PKGS = {"jax": JAX, "port": PORT}


def get(port, path, timeout=5.0):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers["Content-Type"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_guards():
    """tests/conftest.py disarms the JAX package's fault registry and
    resets its ledger around every test; the port's are its own."""
    PORT.faults.disarm()
    PORT.ledger.LEDGER.reset()
    yield
    PORT.faults.disarm()
    PORT.ledger.LEDGER.reset()


def start(ns, pods=()):
    """`ns`'s Operator on an injected environment (the port's on the CPU),
    the default NodeClass and pool, `pods` created before the loop
    starts; its loop running in a thread.  Returns (operator, thread)."""
    opts = ns.Options(batch_idle_duration=0, solver_mesh="off")
    kw = {"device": "cpu"} if ns is PORT else {}
    env = ns.env.Environment(clock=ns.clock.RealClock(), options=opts,
                             catalog=fresh_catalog(ns), **kw)
    op = ns.op.Operator(options=opts, env=env, metrics_port=0,
                        health_port=0, reconcile_interval=0.05)
    env.add_default_nodeclass()
    env.cluster.nodepools.create(ns.M.NodePool(
        meta=ns.M.ObjectMeta(name="default")))
    for p in pods:
        env.cluster.pods.create(p)
    t = threading.Thread(target=op.run, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while op.health_port == 0 or not op._servers:
        assert time.monotonic() < deadline, "operator never started serving"
        time.sleep(0.02)
    return op, t


def stop(op, t):
    op.stop()
    t.join(timeout=120)
    assert not t.is_alive(), "operator loop did not stop"


@pytest.fixture(params=sorted(PKGS))
def operator(request):
    op, t = start(PKGS[request.param])
    op.ns = PKGS[request.param]
    yield op
    stop(op, t)


def wait_running(op, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pods = op.env.cluster.pods.list()
        if len(pods) == n and all(p.scheduled and p.phase == "Running"
                                  for p in pods):
            return True
        time.sleep(0.05)
    return False


class TestOperatorProcess:
    def test_pods_provision_and_metrics_scrape(self, operator):
        op, M = operator, operator.ns.M
        for i in range(5):
            op.env.cluster.pods.create(M.Pod(
                meta=M.ObjectMeta(name=f"p{i}"),
                requests=M.Resources.parse({"cpu": "500m",
                                            "memory": "1Gi"})))
        assert wait_running(op, 5), "pods never became Running"
        assert len(op.env.cluster.nodeclaims.list()) >= 1
        status, body, _ = get(op.metrics_port, "/metrics")
        assert status == 200
        assert "karpenter_provisioner_scheduling_duration_seconds" in body
        assert "karpenter_nodeclaims_launched" in body
        if op.ns is PORT:
            # the port's kernels' launch counts (on the CPU the plain
            # versions run and launch nothing)
            assert ('karpenter_tpu_solver_kernel_launches_total'
                    '{kernel="ffd_batch_scan"} 0.0') in body

    def test_health_and_ready(self, operator):
        for path in ("/healthz", "/readyz"):
            status, body, _ = get(operator.health_port, path)
            assert (status, body) == (200, "ok\n"), path

    def test_debug_state(self, operator):
        status, body, _ = get(operator.health_port, "/debug/state")
        assert status == 200
        assert set(json.loads(body)) == {"generation", "nodes",
                                         "nodeclaims", "pods"}

    def test_readyz_degrades_when_cloud_down(self, operator):
        operator.env.cloud.set_alive(False)
        try:
            status, _, _ = get(operator.health_port, "/readyz")
        finally:
            operator.env.cloud.set_alive(True)
        assert status == 503


ROUTES = ("/debug/traces", "/debug/traces?limit=2", "/debug/dashboard",
          "/debug/ledger", "/debug/ledger?pool=default&limit=3",
          "/debug/flight", "/debug/flight?limit=1", "/debug/timeline",
          "/debug/timeline?kind=store.pods.added", "/debug/explain",
          "/debug/explain?pod=huge", "/debug/explain?pod=nope",
          "/debug/state", "/debug/nope")
HTML = ("/debug/dashboard?format=html", "/debug/ledger?format=html",
        "/debug/timeline?format=html", "/debug/explain?format=html")


def _shape(doc):
    """The JSON keys of a route's document: its top-level keys and, for
    each list of records, the keys of its first record."""
    if not isinstance(doc, dict):
        return type(doc).__name__
    out = {}
    for k, v in doc.items():
        if isinstance(v, list) and v and isinstance(v[0], dict):
            out[k] = sorted(v[0])
        elif isinstance(v, dict) and k in ("processes",):
            out[k] = {p: sorted(s) if isinstance(s, dict) else s
                      for p, s in v.items()}
        else:
            out[k] = None
    return out


def _stranded(op, name, timeout=60.0):
    """Wait until the operator's explain store holds `name`'s verdict."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if get(op.health_port, f"/debug/explain?pod={name}")[0] == 200:
            return True
        time.sleep(0.05)
    return False


def test_every_debug_route_answers_with_the_reference_keys():
    """Both Operators after the same small wave, four pods placed and one
    stranded (no type holds it): every route's status, content type and
    JSON keys equal, and each html view renders.  Each package's explain
    store starts empty (it is process-global)."""
    shapes = {}
    for name, ns in PKGS.items():
        ns.explain.STORE.reset()
        op, t = start(ns)
        try:
            for i in range(4):
                op.env.cluster.pods.create(ns.M.Pod(
                    meta=ns.M.ObjectMeta(name=f"r{i}"),
                    requests=ns.M.Resources.parse({"cpu": "1",
                                                   "memory": "2Gi"})))
            op.env.cluster.pods.create(ns.M.Pod(
                meta=ns.M.ObjectMeta(name="huge"),
                requests=ns.M.Resources.parse({"cpu": "4000",
                                               "memory": "2Gi"})))
            assert _stranded(op, "huge"), name
            deadline = time.monotonic() + 60
            while not all(op.env.cluster.pods.get(f"r{i}").scheduled
                          for i in range(4)):
                assert time.monotonic() < deadline, name
                time.sleep(0.05)
            got = {}
            for path in ROUTES:
                status, body, ctype = get(op.health_port, path)
                doc = (json.loads(body) if ctype.startswith(
                    "application/json") else body)
                got[path] = (status, ctype, _shape(doc))
            for path in HTML:
                status, body, ctype = get(op.health_port, path)
                assert status == 200 and ctype.startswith("text/html"), path
                assert body.lstrip().lower().startswith("<!doctype html")
            shapes[name] = got
        finally:
            stop(op, t)
            ns.explain.STORE.reset()
    for path in ROUTES:
        assert shapes["port"][path] == shapes["jax"][path], path
    assert shapes["port"]["/debug/explain?pod=nope"][0] == 404
    assert shapes["port"]["/debug/explain?pod=huge"][0] == 200
    assert shapes["port"]["/debug/explain"][2]["pods"]
    assert shapes["port"]["/debug/nope"][0] == 404
    for path in ("/debug/ledger", "/debug/flight", "/debug/timeline"):
        assert shapes["port"][path][2] != {}, path


def test_pods_created_before_the_loop_give_the_reference_fleet():
    """300 of the headline's pods in the store before `run` starts: the
    first provisioning pass sees them all, and the fleet each package
    settles on is the same (`workloads.loop_answer`)."""
    answers = {}
    for name, ns in PKGS.items():
        pods = [ns.M.Pod(meta=ns.M.ObjectMeta(name=f"p{i}"),
                         requests=ns.M.Resources.parse(
                             workloads.HEADLINE_SIZES[
                                 i % len(workloads.HEADLINE_SIZES)]))
                for i in range(300)]
        op, t = start(ns, pods)
        try:
            assert wait_running(op, 300, timeout=120.0), name
        finally:
            stop(op, t)
        answers[name] = workloads.loop_answer(op.env.cluster, op.env.cloud,
                                              0)
    assert answers["port"] == answers["jax"]
    assert answers["port"]["bound"] == 300 and answers["port"]["unbound"] == 0


def test_a_failed_reconcile_retries_on_the_card(monkeypatch):
    """A GatedSolver that acts as the card's (`_on_card` true) under one
    armed `solver.dispatch` error: the first provisioning solve raises
    out of the reconcile, the loop survives it (one `ReconcileError`
    event, `/healthz` still ok), and the next resync binds every pod on
    the device path — no oracle solve, no `SolverFallback` event."""
    monkeypatch.setattr(PORT.state.GatedSolver, "_on_card",
                        lambda self: True)
    oracle0 = PORT.metrics.SOLVER_SOLVES.value(path="oracle")
    op, t = start(PORT)
    try:
        PORT.faults.arm("solver.dispatch", "error", times=1)
        for i in range(6):
            op.env.cluster.pods.create(PORT.M.Pod(
                meta=PORT.M.ObjectMeta(name=f"c{i}"),
                requests=PORT.M.Resources.parse({"cpu": "500m",
                                                 "memory": "1Gi"})))
        assert wait_running(op, 6), "the loop never recovered"
        status, body, _ = get(op.health_port, "/healthz")
        assert (status, body) == (200, "ok\n")
    finally:
        stop(op, t)
    assert PORT.faults.fire_count("solver.dispatch") == 1
    reasons = [e[3] for e in op.env.cluster.events]
    assert reasons.count("ReconcileError") == 1
    assert op.reconcile_errors == 1
    assert "SolverFallback" not in reasons
    assert PORT.metrics.SOLVER_SOLVES.value(path="oracle") == oracle0
    msg = next(e[4] for e in op.env.cluster.events
               if e[3] == "ReconcileError")
    assert "FaultInjected" in msg


def _read_banner(proc, timeout=60.0):
    """The entry point's banner line, read from the raw fd behind select
    (tests/test_operator.py's reader: a bare readline() would block past
    the deadline if the child hangs before printing)."""
    fd = proc.stdout.fileno()
    buf = b""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        i = buf.find(b"metrics=")
        if i >= 0 and b"health=:" in buf[i:] and b"\n" in buf[i:]:
            return next(ln for ln in buf.decode(errors="replace")
                        .splitlines() if "metrics=" in ln)
        readable, _, _ = select.select([fd], [], [], 1.0)
        if not readable:
            assert proc.poll() is None, \
                f"operator died at boot: {buf[-500:]!r}"
            continue
        chunk = os.read(fd, 4096)
        assert chunk or proc.poll() is None, \
            f"operator process died at boot: {buf[-500:]!r}"
        buf += chunk
    pytest.fail(f"no serving banner; output: {buf[-300:]!r}")


def _entry_env(tmp_path, **extra):
    env = dict(os.environ)
    for k in ("KARPENTER_TPU_PLATFORM", "KARPENTER_TPU_FORCE_CPU"):
        env.pop(k, None)
    env.update(KARPENTER_TPU_METRICS_PORT="0", KARPENTER_TPU_HEALTH_PORT="0",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               **extra)
    return env


def test_python_dash_m_boots_and_serves_on_the_cpu(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch"],
        env=_entry_env(tmp_path, KARPENTER_TPU_PLATFORM="cpu"),
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        line = _read_banner(proc)
        assert "device=cpu" in line
        health = int(line.split("health=:")[1].split()[0])
        status, body, _ = get(health, "/healthz", timeout=10)
        assert (status, body) == (200, "ok\n")
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            pytest.fail("operator did not exit on SIGTERM")
    assert rc == 0


def test_python_dash_m_without_a_card_fails_at_boot(tmp_path):
    """No platform variable on a host with no card: a non-zero exit well
    inside 60 s, a message naming the missing card, and no banner (it
    never served, from the CPU or anywhere)."""
    assert not torch.cuda.is_available()
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch"],
        env=_entry_env(tmp_path, JAX_PLATFORMS="cpu"), cwd=str(tmp_path),
        capture_output=True, text=True, timeout=60)
    assert time.monotonic() - t0 < 60
    assert out.returncode != 0
    assert "no CUDA card available" in out.stderr
    assert "KARPENTER_TPU_PLATFORM=cpu" in out.stderr
    assert "metrics=" not in out.stdout


def test_store_answer_reads_the_loop_answer_off_the_store():
    """`workloads.store_answer` — what a process holding only a store
    client can read — gives `loop_answer`'s fields (all but `rounds`)
    on a settled loop, before and after a second wave."""
    from karpenter_tpu_torch.operator.options import Options
    catalog = fresh_catalog(PORT)
    lp = workloads.provisioning_loop(400, Options(batch_idle_duration=0),
                                     device="cpu", catalog=catalog)
    for wave in (1, 2):
        if wave == 2:
            lp.add_pods(workloads.headline_pods(
                40, prefix="w", sizes=workloads.WAVE2_SIZES))
        rounds = lp.settle()
        want = workloads.loop_answer(lp.cluster, lp.cloud, rounds)
        assert want.pop("rounds") == rounds
        assert workloads.store_answer(lp.cluster, catalog) == want


def test_the_launch_metric_reads_the_wrappers_counts(monkeypatch):
    """One count a launch: the metric family holds no copy of its own, it
    reads the wrappers' counts (ffd.launch_counts) when scraped."""
    from karpenter_tpu_torch.solver import ffd
    from karpenter_tpu_torch.utils import metrics
    monkeypatch.setattr(ffd.batch_scan, "launches", 3)
    monkeypatch.setattr(ffd.batch_scan, "explain_launches", 2)
    monkeypatch.setattr(ffd.delta_scan, "explain_launches", 1)
    assert ffd.launch_counts()["ffd_batch_scan"] == 3
    assert ffd.launch_counts()["explain_pack"] == 3
    fam = metrics.SOLVER_KERNEL_LAUNCHES
    assert fam.value(kernel="ffd_batch_scan") == 3.0
    body = metrics.REGISTRY.render()
    assert ('karpenter_tpu_solver_kernel_launches_total'
            '{kernel="explain_pack"} 3.0') in body
    assert set(ffd.LAUNCH_COUNTS) == {
        line.split('kernel="', 1)[1].split('"', 1)[0]
        for line in body.splitlines()
        if line.startswith("karpenter_tpu_solver_kernel_launches_total{")}
