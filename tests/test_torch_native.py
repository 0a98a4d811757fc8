"""The port's native host paths (`karpenter_tpu_torch.native`, the in-tree
`native/hostops.cc` extension) against its Python fallbacks and against
the JAX package.

- `group_pods`: the native grouping against `group_pods_py`, on the cases
  of `tests/test_native.py`, built from the port's classes;
- `TorchSolver._decode`: the native distribute, row-id and claim-stamping
  paths against the Python loops, and both against JAX
  `TPUSolver(mesh="off")`: the canonical result and the price as a float
  hex, on the 5k headline and on `_gen_problem` seeds;
- the loader: KARPENTER_TPU_NO_NATIVE pins the Python paths in a fresh
  process, and the `kt_hostops` entry of `sys.modules` is shared with the
  JAX package's loader without either breaking the other.

The extension builds with g++ and the CPython headers (`make -s hostops`
in `native/`); without them the tests skip in the fixture.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from karpenter_tpu_torch import native
from karpenter_tpu_torch.models import (
    ObjectMeta,
    Pod,
    Resources,
    Toleration,
    TopologySpreadConstraint,
    wellknown,
)
from karpenter_tpu_torch.scheduling.types import PodSegments
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver.encode import group_pods_py
from tests.test_solver_fuzz import _gen_problem
from tests.test_torch_encode import JAX, PORT
from tests.test_torch_solve import canon, headline, jax_solver
from tests.test_torch_sweep import _port_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ops():
    mod = native.hostops()
    if mod is None:
        pytest.skip(f"kt_hostops unavailable: {native.build_error()}")
    return mod


def same(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert [id(p) for p in ga] == [id(p) for p in gb]


def _pod(name, cpu="1", mem=None, **kw):
    req = {"cpu": cpu} if mem is None else {"cpu": cpu, "memory": mem}
    return Pod(meta=ObjectMeta(name=name, labels=kw.pop("labels", {})),
               requests=Resources.parse(req), **kw)


def _grouping_cases():
    spread = TopologySpreadConstraint(topology_key=wellknown.ZONE_LABEL,
                                      label_selector={"a": "b"})
    sizes = [("250m", "512Mi"), ("2", "4Gi"), ("1", "1Gi")]
    return {
        "empty": lambda: [],
        "grouping-and-order": lambda: [
            _pod(f"p{i:03d}", *sizes[i % 3], labels={"app": "ab"[i % 2]})
            for i in range(200)],
        "distinct-constraints": lambda: [
            _pod("plain"),
            _pod("tol", tolerations=[Toleration(key="gpu",
                                                operator="Exists")]),
            _pod("spread", topology_spread=[spread])],
        "uncached-group-ids": lambda: [_pod(f"f{i}", cpu="500m")
                                       for i in range(50)],
        "name-tiebreak-unicode": lambda: [
            _pod(n) for n in ["b", "a", "ab", "a-1", "z", "ä", "a0"]],
    }


@pytest.mark.parametrize("case", sorted(_grouping_cases()))
def test_group_pods_matches_python(ops, case):
    pods = _grouping_cases()[case]()
    if case == "uncached-group-ids":
        assert all(p._sched_group_id is None for p in pods)
    got = ops.group_pods(pods)
    same(got, group_pods_py(list(pods)))
    if case == "distinct-constraints":
        assert len(got) == 3


def test_distribute_matches_python(ops):
    groups = [[_pod(f"g{g}p{j}") for j in range(n)]
              for g, n in enumerate([5, 3, 4])]
    take_exist = np.array([[2, 1], [0, 0], [1, 0]], dtype=np.int64)
    take_new = np.array([[1, 1, 0], [2, 0, 1], [0, 3, 0]], dtype=np.int64)
    unsched = np.zeros(3, dtype=np.int64)
    assignments = {}
    node_pods, node_groups, unsched_by_group = ops.distribute(
        groups, take_exist, take_new, unsched, ["e0", "e1"], 3,
        assignments)
    py_assign, py_pods, py_groups = {}, {}, {}
    for gi, pods in enumerate(groups):
        cursor = 0
        for ei in np.nonzero(take_exist[gi])[0]:
            for pod in pods[cursor:cursor + take_exist[gi, ei]]:
                py_assign[pod.meta.name] = ["e0", "e1"][ei]
            cursor += take_exist[gi, ei]
        for ni in np.nonzero(take_new[gi])[0]:
            py_pods.setdefault(int(ni), []).extend(
                pods[cursor:cursor + take_new[gi, ni]])
            py_groups.setdefault(int(ni), []).append(gi)
            cursor += take_new[gi, ni]
    assert assignments == py_assign
    assert {k: [id(p) for p in PodSegments(v)]
            for k, v in node_pods.items()} == \
        {k: [id(p) for p in v] for k, v in py_pods.items()}
    assert {k: list(v) for k, v in node_groups.items()} == py_groups
    assert unsched_by_group == {}


def _answer(res):
    return canon(res), float(res.total_price()).hex()


HEADLINE_N = 5000


def pin_python(monkeypatch):
    """The Python host paths, pinned as KARPENTER_TPU_NO_NATIVE pins them
    (the loaded module set aside for the rest of the test)."""
    monkeypatch.setattr(native, "_hostops", None)
    monkeypatch.setenv("KARPENTER_TPU_NO_NATIVE", "1")
    assert native.hostops() is None


def test_headline_native_equals_python_equals_reference(ops, monkeypatch):
    ref = _answer(jax_solver().solve(headline(JAX, HEADLINE_N)))
    got = TorchSolver(device="cpu").solve(headline(PORT, HEADLINE_N))
    # the native decode hands out lazy PodSegments
    assert isinstance(got.new_claims[0].pods, PodSegments)
    assert _answer(got) == ref
    pin_python(monkeypatch)
    off = TorchSolver(device="cpu").solve(headline(PORT, HEADLINE_N))
    assert isinstance(off.new_claims[0].pods, list)
    assert _answer(off) == ref


FUZZ_SEEDS = range(10000, 10008)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_native_equals_python_equals_reference(ops, monkeypatch, seed):
    ref = _answer(jax_solver().solve(_gen_problem(seed)))
    got = TorchSolver(device="cpu").solve(
        _port_inputs([_gen_problem(seed)])[0])
    assert _answer(got) == ref
    pin_python(monkeypatch)
    off = TorchSolver(device="cpu").solve(
        _port_inputs([_gen_problem(seed)])[0])
    assert _answer(off) == ref


def test_no_native_pins_python_in_a_fresh_process():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from karpenter_tpu_torch import native\n"
            "print(native.hostops() is None, native.build_error())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, KARPENTER_TPU_NO_NATIVE="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "None"]


def test_loaders_share_the_extension_entry(ops):
    """Both packages' loaders in one process: the `kt_hostops` entry of
    sys.modules stays the first loader's, and either module groups the
    other package's pods (the extension reads attributes only)."""
    from karpenter_tpu.native import hostops as jax_hostops
    from karpenter_tpu.models import ObjectMeta as JMeta, Pod as JPod
    from karpenter_tpu.models import Resources as JRes
    from karpenter_tpu.solver.encode import group_pods_py as jax_py
    jops = jax_hostops()
    if jops is None:
        pytest.skip("the JAX package's loader did not load kt_hostops")
    assert sys.modules["kt_hostops"] in (ops, jops)
    jpods = [JPod(meta=JMeta(name=f"j{i}"),
                  requests=JRes.parse({"cpu": ["1", "2"][i % 2]}))
             for i in range(20)]
    tpods = [_pod(f"t{i}", cpu=["1", "2"][i % 2]) for i in range(20)]
    same(ops.group_pods(jpods), jax_py(list(jpods)))
    same(jops.group_pods(tpods), group_pods_py(list(tpods)))
