"""The port's shadow audit (`solver/audit.py`) against the JAX package's.

`tests/test_audit.py`'s cases, parametrised over both packages: the
grammar, the deterministic accumulator, the ineligible simulations, the
backlog's `dropped` count, `classify`, the live rate-1 oracle parity, the
delta pass's full re-solve and the divergence drill.  Where both packages
run the same solves, their verdict counts must be equal, and so must the
deterministic fields of the divergence drill's `kind="audit"` flight
record (its perturbed digest, its delta block, its knobs, its pods).  The
port's drill replays its capture with the port's solver; the JAX
package's `tools/kt_replay.py` has no twin in the port yet.

The repaired seam: `TorchSolver.solve` submits every eligible solve to
the sampler, as `TPUSolver.solve` does (the port's solver had dropped the
call, so `KARPENTER_TPU_AUDIT` did nothing there), and `SolveProbe`
drains the sampler after a solve when it is armed.
"""

import importlib
import os
import pickle
from types import SimpleNamespace

import pytest
import torch

PKGS = {}
for _name, _root in (("jax", "karpenter_tpu"), ("port", "karpenter_tpu_torch")):
    _imp = lambda m, r=_root: importlib.import_module(f"{r}.{m}")  # noqa
    PKGS[_name] = SimpleNamespace(
        name=_name, audit=_imp("solver.audit"), faults=_imp("utils.faults"),
        fr=_imp("utils.flightrecorder"), metrics=_imp("utils.metrics"),
        telemetry=_imp("utils.telemetry"), ledger=_imp("utils.ledger"),
        M=_imp("models"), providers=_imp("providers"),
        catalog=_imp("providers.catalog"), sched=_imp("scheduling"),
        inv=_imp("timeline.invariants"))
JAX, PORT = PKGS["jax"], PKGS["port"]


def solver(ns, **kw):
    if ns is JAX:
        from karpenter_tpu.solver import TPUSolver
        return TPUSolver(max_nodes=64, mesh="off", **kw)
    from karpenter_tpu_torch.solver import TorchSolver
    return TorchSolver(max_nodes=64, device="cpu", mesh="off", **kw)


_CATALOGS = {}


def mkinp(ns, tag, n=12, cpu="500m", mem="1Gi"):
    """tests/test_audit.py's input, from `ns`'s classes."""
    M = ns.M
    if ns.name not in _CATALOGS:
        _CATALOGS[ns.name] = ns.providers.generate_catalog(
            ns.catalog.CatalogSpec(max_types=10, include_gpu=False))
    pods = [M.Pod(meta=M.ObjectMeta(name=f"{tag}-p{i}"),
                  requests=M.Resources.parse({"cpu": cpu, "memory": mem}))
            for i in range(n)]
    return ns.sched.ScheduleInput(
        pods=pods, nodepools=[M.NodePool(meta=M.ObjectMeta(name="default"))],
        instance_types={"default": _CATALOGS[ns.name]})


def verdicts(ns) -> dict:
    return ns.telemetry._series(ns.metrics.SOLVER_AUDIT)


def moved(ns, before) -> dict:
    after = verdicts(ns)
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(after) | set(before)
            if after.get(k, 0) != before.get(k, 0)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_guards():
    """tests/conftest.py resets the JAX package's sampler and ledger and
    disarms its fault registry around every test; the port's are its
    own, reset here the same way."""
    PORT.audit.SAMPLER.reset()
    PORT.ledger.LEDGER.reset()
    PORT.faults.disarm()
    yield
    PORT.audit.SAMPLER.reset()
    PORT.ledger.LEDGER.reset()
    PORT.faults.disarm()


@pytest.fixture(params=sorted(PKGS))
def ns(request):
    return PKGS[request.param]


@pytest.fixture
def fresh_recorders():
    for p in PKGS.values():
        p.fr.RECORDER.reset()
    yield
    for p in PKGS.values():
        p.fr.RECORDER.reset()


# -- grammar + sampling units ------------------------------------------------
class TestGrammar:
    def test_disabled_spellings(self, monkeypatch, ns):
        for raw in ("", "off", "0", "false", "no", "none", "bogus",
                    "-0.5"):
            monkeypatch.setenv("KARPENTER_TPU_AUDIT", raw)
            assert ns.audit.sample_rate() == 0.0, raw
        monkeypatch.delenv("KARPENTER_TPU_AUDIT")
        assert ns.audit.sample_rate() == 0.0

    def test_armed_spellings(self, monkeypatch, ns):
        for raw, want in (("on", ns.audit.DEFAULT_RATE), ("1", 1.0),
                          ("0.25", 0.25), ("7.0", 1.0)):
            monkeypatch.setenv("KARPENTER_TPU_AUDIT", raw)
            assert ns.audit.sample_rate() == want, raw

    def test_arm_restores_the_prior_spelling(self, monkeypatch, ns):
        monkeypatch.setenv("KARPENTER_TPU_AUDIT", "0.25")
        restore = ns.audit.arm("1")
        assert ns.audit.sample_rate() == 1.0
        restore()
        assert os.environ["KARPENTER_TPU_AUDIT"] == "0.25"
        monkeypatch.delenv("KARPENTER_TPU_AUDIT")
        ns.audit.arm()()
        assert "KARPENTER_TPU_AUDIT" not in os.environ


class TestSampling:
    def test_deterministic_accumulator(self, monkeypatch, ns):
        """rate 0.5 samples exactly every second eligible solve."""
        monkeypatch.setenv("KARPENTER_TPU_AUDIT", "0.5")
        s = solver(ns)
        res = s.solve(mkinp(ns, "det"))
        ns.audit.SAMPLER.reset()  # the warm solve itself advanced the acc
        picked = [ns.audit.SAMPLER.maybe_submit(mkinp(ns, "det"), res, s)
                  for _ in range(6)]
        ns.audit.SAMPLER.drain()
        assert picked == [False, True, False, True, False, True]

    def test_sims_never_eligible(self, monkeypatch, ns):
        monkeypatch.setenv("KARPENTER_TPU_AUDIT", "1.0")
        s = solver(ns)
        res = s.solve(mkinp(ns, "sim"))
        ns.audit.SAMPLER.drain()
        before = ns.audit.SAMPLER.audits
        assert not ns.audit.SAMPLER.maybe_submit(
            mkinp(ns, "sim"), res, s, max_nodes=8)
        ns.audit.SAMPLER.drain()
        assert ns.audit.SAMPLER.audits == before

    def test_backlog_overflow_counted_dropped(self, monkeypatch, ns):
        monkeypatch.setenv("KARPENTER_TPU_AUDIT", "1.0")
        monkeypatch.setattr(ns.audit, "_BACKLOG", 0)
        s = solver(ns)
        res = s.solve(mkinp(ns, "drop"))
        ns.audit.SAMPLER.drain()
        before = verdicts(ns).get("dropped", 0)
        assert not ns.audit.SAMPLER.maybe_submit(mkinp(ns, "drop"), res, s)
        assert verdicts(ns).get("dropped", 0) == before + 1


# -- verdict classification ---------------------------------------------------
def _digest(nodes=5, price=1.0, unsched=0):
    return {"nodes": nodes, "price": price,
            "price_hex": float(price).hex(), "unschedulable": unsched}


def _sub_rounding():
    live, oracle = _digest(price=100.00004), _digest(price=100.00001)
    live["price"] = oracle["price"] = 100.0  # what the digest shows
    return live, oracle


@pytest.mark.parametrize("live, oracle, want", [
    (_digest(), _digest(), "match"),
    (_digest(price=0.9), _digest(price=1.0), "improved"),
    (_digest(unsched=0), _digest(unsched=2), "improved"),
    (_digest(price=1.1), _digest(price=1.0), "diverged"),
    (*_sub_rounding(), "diverged"),
    (_digest(unsched=3), _digest(unsched=0), "diverged"),
], ids=["match", "cheaper", "fewer-strands", "worse-price", "sub-rounding",
        "extra-strands"])
def test_classify(ns, live, oracle, want):
    assert ns.audit.AuditSampler._classify(dict(live), dict(oracle)) == want


# -- the live loop -------------------------------------------------------------
def test_rate_one_reproduces_oracle_parity(monkeypatch):
    """Every solve sampled: both packages' live solves re-verify to exact
    oracle parity, one `match` each and nothing else."""
    monkeypatch.setenv("KARPENTER_TPU_AUDIT", "1.0")
    out = {}
    for ns in (JAX, PORT):
        before = dict(verdicts(ns))
        res = solver(ns).solve(mkinp(ns, "live"))
        assert not res.unschedulable
        ns.audit.SAMPLER.drain(timeout=60.0)
        out[ns.name] = moved(ns, before)
    assert out["port"] == out["jax"] == {"match": 1}


def test_delta_pass_full_resolve_parity(monkeypatch):
    """A delta-engaged pass re-solves FULL on the audit thread (the port
    on a dedicated delta-off TorchSolver on the live solver's device) and
    stays clean in both packages."""
    out = {}
    for ns in (JAX, PORT):
        s = solver(ns, delta="on")
        inp = mkinp(ns, "delta", n=16)
        s.solve(inp)  # cold pass fills the delta cache
        monkeypatch.setenv("KARPENTER_TPU_AUDIT", "1.0")
        before = dict(verdicts(ns))
        s.solve(inp)  # steady-state repeat: the engaged pass
        assert s._delta_cache.last_outcome == "delta"
        ns.audit.SAMPLER.drain(timeout=120.0)
        out[ns.name] = moved(ns, before)
        monkeypatch.delenv("KARPENTER_TPU_AUDIT")
    assert out["port"] == out["jax"] == {"match": 1}
    resolver = PORT.audit.SAMPLER._resolver
    assert resolver is not None and str(resolver.device) == "cpu"
    assert resolver._resolve_delta() is False


# -- the repaired seam: one submit per eligible solve ---------------------------
def test_every_eligible_solve_is_submitted(monkeypatch):
    """With KARPENTER_TPU_AUDIT=1 each real solve is audited once and a
    capped simulation never: three solves and one sim give three audits
    in both packages (the port's sampler counted none before the seam
    was restored)."""
    monkeypatch.setenv("KARPENTER_TPU_AUDIT", "1")
    out = {}
    for ns in (JAX, PORT):
        s = solver(ns)
        before = dict(verdicts(ns))
        for i in range(3):
            s.solve(mkinp(ns, f"seam{i}", n=4 + i))
        s.solve(mkinp(ns, "seam-sim", n=4), max_nodes=8)
        ns.audit.SAMPLER.drain(timeout=60.0)
        out[ns.name] = (ns.audit.SAMPLER.audits, moved(ns, before))
    assert out["port"] == out["jax"] == (3, {"match": 3})


def test_solve_probe_drains_an_armed_sampler(monkeypatch):
    """`SolveProbe.solve` returns only once the armed sampler has judged
    the solve (the world lock's window covers the audit), in both
    packages."""
    monkeypatch.setenv("KARPENTER_TPU_AUDIT", "1")
    for ns in (JAX, PORT):
        probe = ns.inv.SolveProbe(solver(ns), ns.inv.TrajectoryAuditor())
        before = dict(verdicts(ns))

        class Inner:
            def __init__(self, s):
                self.s = s

            def solve(self, inp, source="solver", max_nodes=None):
                return self.s.solve(inp, max_nodes=max_nodes)
        probe._inner = Inner(probe._inner)
        probe.solve(mkinp(ns, "probe"))
        assert ns.audit.SAMPLER.backlog() == 0
        assert moved(ns, before) == {"match": 1}, ns.name


# -- the divergence drill ---------------------------------------------------------
DETERMINISTIC = ("kind", "pods", "knobs", "delta", "result", "retraces",
                 "device_memory_peak_bytes", "catalog", "fingerprint",
                 "groups", "phase_ms")


def test_injected_divergence_leaves_a_replayable_capture(
        monkeypatch, tmp_path, fresh_recorders):
    """The `solver.audit.digest` fault perturbs the live digest: one
    `diverged` verdict in each package, a forced capture although
    KARPENTER_TPU_FLIGHT_CAPTURE is off, and a `kind="audit"` record whose
    deterministic fields are equal across the packages.  The port's
    capture re-solves on a fresh port solver to the unperturbed answer,
    so the recorded (perturbed) digest does not reproduce: nodes off by
    the injected one."""
    monkeypatch.setenv("KARPENTER_TPU_AUDIT", "1.0")
    recs = {}
    for ns in (JAX, PORT):
        d = tmp_path / ns.name
        monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(d))
        ns.faults.arm("solver.audit.digest", "error", times=1)
        before = dict(verdicts(ns))
        res = solver(ns).solve(mkinp(ns, "div"))
        ns.audit.SAMPLER.drain(timeout=60.0)
        assert moved(ns, before) == {"diverged": 1}, ns.name
        audits = [r for r in ns.fr.RECORDER.tail(16)
                  if r["kind"] == "audit"]
        assert len(audits) == 1, ns.name
        rec = audits[0]
        assert rec["capture"] and os.path.exists(rec["capture"])
        assert rec["result"]["nodes"] == res.node_count() + 1
        recs[ns.name] = rec
    assert {k: recs["port"][k] for k in DETERMINISTIC} == \
        {k: recs["jax"][k] for k in DETERMINISTIC}
    assert recs["port"]["delta"] == {"engaged": False, "tripwire": "oracle"}

    with open(recs["port"]["capture"], "rb") as f:
        cap = pickle.load(f)
    again = PORT.fr.result_digest(solver(PORT).solve(cap["inp"]))
    assert again["nodes"] == recs["port"]["result"]["nodes"] - 1
    assert again["price_hex"] != recs["port"]["result"]["price_hex"]


def test_no_flight_dir_degrades_capture(monkeypatch, fresh_recorders):
    monkeypatch.setenv("KARPENTER_TPU_AUDIT", "1.0")
    monkeypatch.delenv("KARPENTER_TPU_FLIGHT_DIR", raising=False)
    for ns in (JAX, PORT):
        ns.faults.arm("solver.audit.digest", "error", times=1)
        before = dict(verdicts(ns))
        solver(ns).solve(mkinp(ns, "nofdir"))
        ns.audit.SAMPLER.drain(timeout=60.0)
        assert moved(ns, before) == {"diverged": 1}, ns.name
        recs = [r for r in ns.fr.RECORDER.tail(16) if r["kind"] == "audit"]
        assert recs and recs[-1]["capture"] is None, ns.name

