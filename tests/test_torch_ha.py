"""The port's leader election (`operator/leaderelection.py`) against the
JAX package's: the `TestLeases` and `TestElector` cases of
`tests/test_ha.py` on both packages, and one lease file shared by a
replica of each package (the file format is one, so mixed replicas
exclude each other).  The in-process replica pair of `tests/test_ha.py`
needs the operator, which the port does not have yet (slice 5d).
"""

import importlib

import pytest

PKGS = {name: importlib.import_module(f"{root}.operator.leaderelection")
        for name, root in (("jax", "karpenter_tpu"),
                           ("port", "karpenter_tpu_torch"))}


@pytest.fixture(autouse=True)
def _port_faults_disarmed():
    """tests/conftest.py disarms the JAX package's fault registry around
    every test; the port keeps its own, disarmed here the same way."""
    from karpenter_tpu_torch.utils import faults
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(params=sorted(PKGS))
def le(request):
    return PKGS[request.param]


class TestLeases:
    def test_inmemory_mutual_exclusion(self, le):
        lease = le.InMemoryLease()
        assert lease.try_acquire("a", 10.0, now=100.0)
        assert not lease.try_acquire("b", 10.0, now=105.0)
        assert lease.holder(now=105.0) == "a"
        # expiry frees it
        assert lease.try_acquire("b", 10.0, now=111.0)
        assert lease.holder(now=112.0) == "b"
        # release frees it immediately
        lease.release("b")
        assert lease.holder(now=112.0) is None

    def test_inmemory_reacquire_extends(self, le):
        lease = le.InMemoryLease()
        assert lease.try_acquire("a", 10.0, now=0.0)
        assert lease.try_acquire("a", 10.0, now=8.0)  # renew
        assert not lease.try_acquire("b", 10.0, now=12.0)  # extended to 18

    def test_file_lease_across_instances(self, le, tmp_path):
        path = str(tmp_path / "lease.json")
        a, b = le.FileLease(path), le.FileLease(path)
        assert a.try_acquire("rep-a", 10.0, now=100.0)
        assert not b.try_acquire("rep-b", 10.0, now=104.0)
        assert b.holder(now=104.0) == "rep-a"
        assert b.try_acquire("rep-b", 10.0, now=111.0)  # expired
        assert a.holder(now=112.0) == "rep-b"
        b.release("rep-b")
        assert a.holder(now=112.0) is None


class TestElector:
    def test_takeover_on_expiry_and_demotion(self, le):
        lease = le.InMemoryLease()
        t = {"now": 0.0}
        e1 = le.LeaderElector(lease, identity="rep-1", lease_duration=10.0,
                              renew_interval=3.0, now=lambda: t["now"])
        e2 = le.LeaderElector(lease, identity="rep-2", lease_duration=10.0,
                              renew_interval=3.0, now=lambda: t["now"])
        assert e1.try_acquire_or_renew()
        assert not e2.try_acquire_or_renew()
        # leader renews within the window: standby stays out
        t["now"] = 5.0
        assert e1.try_acquire_or_renew()
        t["now"] = 12.0
        assert not e2.try_acquire_or_renew()  # lease runs to 15
        # leader goes silent; lease expires; standby takes over
        t["now"] = 16.0
        assert e2.try_acquire_or_renew()
        assert e2.is_leader
        # the comatose leader wakes up and finds itself demoted
        t["now"] = 17.0
        assert not e1.try_acquire_or_renew()
        assert not e1.is_leader


def test_one_lease_file_excludes_across_packages(tmp_path):
    """A JAX replica and a port replica on one lease file: the same
    sequence of holders as two replicas of one package, and the same
    bytes on disk after each step."""
    def run(make_a, make_b, path):
        a, b = make_a(path), make_b(path)
        steps = [a.try_acquire("rep-a", 10.0, now=100.0),
                 b.try_acquire("rep-b", 10.0, now=104.0),
                 b.holder(now=104.0), b.try_acquire("rep-b", 10.0, now=111.0),
                 a.holder(now=112.0)]
        with open(path) as f:
            disk = f.read()
        b.release("rep-b")
        return steps + [a.holder(now=112.0)], disk

    jax, port = PKGS["jax"], PKGS["port"]
    mixed = run(jax.FileLease, port.FileLease, str(tmp_path / "mixed.json"))
    ref = run(jax.FileLease, jax.FileLease, str(tmp_path / "jax.json"))
    assert mixed == ref
    assert mixed[0] == [True, False, "rep-a", True, "rep-b", None]
