"""The port's dynamic lock-order observer (`karpenter_tpu_torch/utils/
lockwatch.py`): the toy cases of `tests/test_lint.py` against the port's
module, its scope (a lock built in the JAX package is not observed), the
static model's sites for the port's files, and one armed run of the
port's solver service — a `LoopbackSolverd`, its tenant scheduler and
three tenants' clients — with no inverted pair against the static graph
of the port's service modules (`hack.analyze.rules.lock_order.build_model`
pointed at them).
"""

import os
import threading

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lockwatch_catches_inverted_two_lock_toy(monkeypatch):
    import threading

    from karpenter_tpu_torch.utils import lockwatch as lw

    # isolate the edge store: an armed tier-1 session must not lose (or
    # inherit) the real suite's edges through this toy
    monkeypatch.setattr(lw, "_EDGES", {})
    a = lw._ObservedLock(threading.Lock(), "karpenter_tpu_torch/toy.py:1")
    b = lw._ObservedLock(threading.Lock(), "karpenter_tpu_torch/toy.py:2")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    rep = lw.verify()
    assert len(rep["inversions"]) == 1
    assert rep["inversions"][0]["kind"] == "dynamic-inversion"
    assert rep["edges"] == 2


def test_lockwatch_consistent_order_is_clean(monkeypatch):
    import threading

    from karpenter_tpu_torch.utils import lockwatch as lw

    monkeypatch.setattr(lw, "_EDGES", {})
    a = lw._ObservedLock(threading.Lock(), "karpenter_tpu_torch/toy.py:1")
    b = lw._ObservedLock(threading.Lock(), "karpenter_tpu_torch/toy.py:2")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = lw.verify()
    assert rep["inversions"] == []
    assert rep["edges"] == 1


def test_lockwatch_fails_edge_the_static_graph_calls_inverted(monkeypatch):
    import threading

    from karpenter_tpu_torch.utils import lockwatch as lw

    monkeypatch.setattr(lw, "_EDGES", {})
    a = lw._ObservedLock(threading.Lock(), "karpenter_tpu_torch/toy.py:1")
    b = lw._ObservedLock(threading.Lock(), "karpenter_tpu_torch/toy.py:2")
    with b:
        with a:  # observed b -> a, but the static graph orders a -> b
            pass
    site_to_id = {"karpenter_tpu_torch/toy.py:1": "C._a_lock",
                  "karpenter_tpu_torch/toy.py:2": "C._b_lock"}
    rep = lw.verify(static_edges={("C._a_lock", "C._b_lock")},
                    site_to_id=site_to_id)
    assert len(rep["inversions"]) == 1
    assert rep["inversions"][0]["kind"] == "contradicts-static"
    # the same observation against a static graph that agrees is clean
    rep = lw.verify(static_edges={("C._b_lock", "C._a_lock")},
                    site_to_id=site_to_id)
    assert rep["inversions"] == []


def test_lockwatch_condition_wait_releases_the_held_set(monkeypatch):
    import threading

    from karpenter_tpu_torch.utils import lockwatch as lw

    monkeypatch.setattr(lw, "_EDGES", {})
    inner = lw._ObservedLock(threading.Lock(), "karpenter_tpu_torch/toy.py:9")
    cv = lw._RAW_CONDITION(inner)
    done = []

    def waiter():
        with cv:
            while not done:
                cv.wait(0.5)

    t = threading.Thread(target=waiter)
    t.start()
    import time
    time.sleep(0.05)
    # while the waiter sleeps in wait() the lock is RELEASED — this
    # acquire must not record an edge from the waiter's held set
    other = lw._ObservedLock(threading.Lock(), "karpenter_tpu_torch/toy.py:10")
    with cv:
        done.append(1)
        cv.notify_all()
    t.join(timeout=5)
    with other:
        pass
    assert lw.verify()["inversions"] == []


def test_lockwatch_install_scopes_to_the_package(monkeypatch):
    from karpenter_tpu_torch.utils import lockwatch as lw

    was_installed = lw.installed()
    lw.install()
    try:
        ns = {}
        code = compile("import threading\nL = threading.Lock()\n",
                       "/somewhere/karpenter_tpu_torch/toy_mod.py", "exec")
        exec(code, ns)
        assert isinstance(ns["L"], lw._ObservedLock)
        assert ns["L"]._site == "karpenter_tpu_torch/toy_mod.py:2"
        ns2 = {}
        code2 = compile("import threading\nL = threading.Lock()\n",
                        "/somewhere/else/toy_mod.py", "exec")
        exec(code2, ns2)
        assert not isinstance(ns2["L"], lw._ObservedLock)
    finally:
        if not was_installed:
            lw.uninstall()


def test_lockwatch_condition_over_observed_rlock(monkeypatch):
    # threading.Condition(<observed RLock>) must wait/notify correctly:
    # the proxy forwards _release_save/_acquire_restore/_is_owned for
    # reentrant inners (the Condition fallback _is_owned is wrong for
    # RLocks), with held-set bookkeeping truthful across the wait
    import threading

    from karpenter_tpu_torch.utils import lockwatch as lw

    monkeypatch.setattr(lw, "_EDGES", {})
    rl = lw._ObservedLock(lw._RAW_RLOCK(), "karpenter_tpu_torch/toy.py:20",
                          reentrant=True)
    cv = lw._RAW_CONDITION(rl)
    done = []

    def waiter():
        with cv:
            with rl:  # recursive hold across the wait
                while not done:
                    cv.wait(5.0)

    t = threading.Thread(target=waiter)
    t.start()
    import time
    time.sleep(0.05)
    with cv:
        done.append(1)
        cv.notify_all()
    t.join(timeout=10)
    assert not t.is_alive(), "Condition(<observed RLock>) wedged"
    assert lw.verify()["inversions"] == []
    # a plain-Lock proxy still refuses the protocol attrs (the tested
    # Condition fallback path stays in force)
    plain = lw._ObservedLock(lw._RAW_LOCK(), "karpenter_tpu_torch/toy.py:21")
    import pytest
    with pytest.raises(AttributeError):
        plain._release_save


def test_lockwatch_install_leaves_the_jax_package_alone(monkeypatch):
    from karpenter_tpu_torch.utils import lockwatch as lw

    was_installed = lw.installed()
    lw.install()
    try:
        ns = {}
        code = compile("import threading\nL = threading.Lock()\n",
                       "/somewhere/karpenter_tpu/toy_mod.py", "exec")
        exec(code, ns)
        assert not isinstance(ns["L"], lw._ObservedLock)
    finally:
        if not was_installed:
            lw.uninstall()


def _port_model(dirs=("service",)):
    import sys
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from hack.analyze import core
    from hack.analyze.rules import lock_order
    ctxs = []
    for d in dirs:
        for p in core.iter_py_files([os.path.join(
                ROOT, "karpenter_tpu_torch", d)]):
            ctxs.append(core.FileContext(p, root=ROOT))
    return lock_order.build_model(ctxs)


def test_the_static_model_names_the_ports_sites():
    # build_model's site map keys are repository-relative, the port's
    # observer's site format
    sites = _port_model().site_to_id()
    assert sites
    assert all(s.startswith("karpenter_tpu_torch/service/") for s in sites)
    assert any(v.endswith("TenantScheduler._lock") for v in sites.values())


def test_an_armed_service_run_has_no_inverted_pair(monkeypatch, tmp_path):
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.service import SolverServiceClient, backend
    from karpenter_tpu_torch.service.loopback import LoopbackSolverd
    from karpenter_tpu_torch.solver import TorchSolver
    from karpenter_tpu_torch.utils import lockwatch as lw

    monkeypatch.setattr(lw, "_EDGES", {})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = backend._solver
    was_installed = lw.installed()
    lw.install()
    d = None
    clients = []
    try:
        # the locks built from here on (the window, the scheduler, the
        # clients) are observed
        backend._solver = TorchSolver(max_nodes=128, device="cpu",
                                      mesh="off", delta="off")
        d = LoopbackSolverd(str(tmp_path / "lw.sock"), idle_ms=20,
                            max_ms=200)
        sched = backend._get_scheduler()
        assert isinstance(sched._lock, lw._ObservedLock)
        traffic = workloads.Config8Traffic()
        clients = [SolverServiceClient(d.socket_path, timeout=120,
                                       tenant=f"t{i}") for i in range(3)]
        outs = []

        def drive(i, c):
            for it in (0, 3):
                outs.append(traffic.call(c, f"t{i}", it))
        ts = [threading.Thread(target=drive, args=(i, c))
              for i, c in enumerate(clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert len(outs) == 6
        assert clients[0].stats()["scheduler"]["batches"] >= 1
    finally:
        for c in clients:
            c.close()
        if d is not None:
            d.close()
        backend._solver = saved
        if not was_installed:
            lw.uninstall()
        torch.set_num_threads(n)
    model = _port_model()
    rep = lw.verify(set(model.edges), model.site_to_id())
    assert rep["edges"] >= 1
    assert rep["inversions"] == [], rep["inversions"]
