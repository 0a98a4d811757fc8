"""The port's device bootstrap (`utils/platform.py`), its profiler hooks
(`utils/profiling.py`) and `knobs.bind_host`, against the JAX package's
where the two answer the same question.

`configure` resolves the port's device: an explicit argument, then
KARPENTER_TPU_PLATFORM, then KARPENTER_TPU_FORCE_CPU, then the card —
never JAX_PLATFORMS, the JAX package's knob.  `probe_backend` initializes
CUDA in a throwaway subprocess (on this CPU host it reports `error` with
`no_device`; a probe that sleeps past its timeout reports `hang`), and
`initialize` raises when there is no card: nothing falls back to the CPU
unless the CPU was asked for.  `trace_solve` writes one Chrome trace per
solve region when the hook is armed, and does nothing when it is not.
"""

import json
import os
import socket

import pytest
import torch

from karpenter_tpu.utils import knobs as jknobs
from karpenter_tpu.utils import platform as jplatform
from karpenter_tpu.utils import profiling as jprofiling
from karpenter_tpu_torch.utils import knobs, platform, profiling

KNOBS = ("KARPENTER_TPU_PLATFORM", "KARPENTER_TPU_FORCE_CPU",
         "KARPENTER_TPU_NO_COMPILE_CACHE", "KARPENTER_TPU_PROFILE",
         "KARPENTER_TPU_PROFILE_DIR", "ENABLE_PROFILING",
         "KARPENTER_TPU_BIND_HOST")


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(profiling, "_armed_dir", None)


class TestConfigure:
    @pytest.mark.parametrize("env, want", [
        ({}, "cuda"),
        ({"JAX_PLATFORMS": "cpu"}, "cuda"),
        ({"KARPENTER_TPU_FORCE_CPU": "1"}, "cpu"),
        ({"KARPENTER_TPU_FORCE_CPU": "0"}, "cuda"),
        ({"KARPENTER_TPU_PLATFORM": "cpu"}, "cpu"),
        ({"KARPENTER_TPU_PLATFORM": "cuda",
          "KARPENTER_TPU_FORCE_CPU": "1"}, "cuda"),
        ({"KARPENTER_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cuda"}, "cpu"),
    ])
    def test_resolution_order(self, monkeypatch, env, want):
        # the kernels' build is configure's side effect on the card; this
        # host has no nvcc, so the case checks the resolution alone
        monkeypatch.setenv("KARPENTER_TPU_NO_COMPILE_CACHE", "1")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert platform.configure() == want

    def test_explicit_argument_wins(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_TPU_PLATFORM", "cuda")
        assert platform.configure("cpu") == "cpu"

    def test_unknown_platform_raises(self):
        with pytest.raises(ValueError, match="'cuda'"):
            platform.configure("tpu")

    def test_card_build_runs_at_configure(self, monkeypatch):
        """On the card configure builds every kernel (here: the build's
        call, recorded); on the CPU and under the opt-out it does not."""
        from karpenter_tpu_torch.solver import _cuda
        calls = []
        monkeypatch.setattr(_cuda, "build", lambda: calls.append(1) or 0.0)
        assert platform.configure("cuda") == "cuda"
        assert platform.configure("cpu") == "cpu"
        monkeypatch.setenv("KARPENTER_TPU_NO_COMPILE_CACHE", "1")
        assert platform.configure("cuda") == "cuda"
        assert calls == [1]


def test_bind_host_matches_reference(monkeypatch):
    assert knobs.bind_host() == jknobs.bind_host() == "127.0.0.1"
    monkeypatch.setenv("KARPENTER_TPU_BIND_HOST", "0.0.0.0")
    assert knobs.bind_host() == jknobs.bind_host() == "0.0.0.0"


@pytest.mark.parametrize("env", [
    {},
    {"KARPENTER_TPU_FORCE_CPU": "1", "KARPENTER_TPU_PLATFORM": "cpu",
     "JAX_PLATFORMS": "cpu", "OTHER": "x"},
    {"KARPENTER_TPU_PLATFORM": "cuda", "JAX_PLATFORMS": "tpu"},
])
def test_scrub_cpu_overrides_matches_reference(env):
    assert platform.scrub_cpu_overrides(dict(env)) == \
        jplatform.scrub_cpu_overrides(dict(env))


def test_listening_ports_sees_a_listener():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        port = s.getsockname()[1]
        mine, ref = platform.listening_ports(), jplatform.listening_ports()
    assert port in mine and port in ref
    assert all(isinstance(p, int) for p in mine)


class TestProbe:
    def test_no_card_is_an_error(self):
        assert not torch.cuda.is_available()
        logged = []
        rec = platform.probe_backend(None, 120, log=logged.append)
        assert rec["outcome"] == "error" and rec["no_device"] is True
        assert rec["rc"] == 3 and rec["want"] == "cuda"
        assert "listening_ports" in rec and "stderr_tail" in rec
        assert logged and "no CUDA device" in logged[0]

    def test_a_stuck_init_is_a_hang(self, monkeypatch):
        monkeypatch.setattr(platform, "PROBE_CODE",
                            "import time\ntime.sleep(60)\n")
        rec = platform.probe_backend("cuda", 1.0, log=lambda m: None)
        assert rec["outcome"] == "hang" and rec["timeout_s"] == 1.0

    def test_initialize_raises_without_a_card(self, monkeypatch):
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # not the port's knob
        logged = []
        with pytest.raises(RuntimeError, match="no CUDA card available") \
                as e:
            platform.initialize(retries=3, backoff_s=30.0,
                                log=logged.append)
        # a host without a card is not retried (no 30 s backoff here)
        assert "KARPENTER_TPU_PLATFORM=cpu" in str(e.value)
        assert len(logged) == 1

    def test_initialize_gives_the_cpu_only_when_asked(self, monkeypatch):
        assert platform.initialize("cpu") == "cpu"
        monkeypatch.setenv("KARPENTER_TPU_FORCE_CPU", "1")
        assert platform.initialize() == "cpu"


SPELLINGS = ("", "0", "off", "false", "no", "1", "true", "yes", "on",
             "/tmp/kt-profiles")


@pytest.mark.parametrize("legacy", [None, "/tmp/kt-legacy"])
def test_profile_trace_dir_matches_reference(monkeypatch, legacy):
    if legacy is not None:
        monkeypatch.setenv("KARPENTER_TPU_PROFILE_DIR", legacy)
    for raw in SPELLINGS:
        monkeypatch.setenv("KARPENTER_TPU_PROFILE", raw)
        assert profiling.profile_trace_dir() == \
            jprofiling.profile_trace_dir(), raw
    monkeypatch.delenv("KARPENTER_TPU_PROFILE")
    assert profiling.profile_trace_dir() == jprofiling.profile_trace_dir()
    assert profiling.profiling_enabled() == jprofiling.profiling_enabled()


def _small_input(n=24):
    from karpenter_tpu_torch.workloads import build_input
    return build_input(n)


def test_trace_solve_writes_one_trace_per_solve(monkeypatch, tmp_path):
    from karpenter_tpu_torch.solver import TorchSolver
    solver = TorchSolver(max_nodes=64, device="cpu")
    inp = _small_input()
    solver.solve(inp)  # first use outside the trace
    monkeypatch.setenv("KARPENTER_TPU_PROFILE", str(tmp_path))
    res = solver.solve(inp)
    assert res.node_count() > 0
    traces = sorted(os.listdir(tmp_path))
    assert len(traces) == 1 and traces[0].startswith(
        f"ffd-solve-{os.getpid()}-"), traces
    with open(tmp_path / traces[0]) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "ffd-solve" in names


def test_trace_solve_is_a_no_op_when_off(monkeypatch, tmp_path):
    from karpenter_tpu_torch.solver import TorchSolver

    def refuse(*a, **kw):
        raise AssertionError("the profiler started with the hook off")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    TorchSolver(max_nodes=64, device="cpu").solve(_small_input())
    assert os.listdir(tmp_path) == []


def test_maybe_start_server_arms_the_per_solve_hook(monkeypatch, tmp_path):
    """ENABLE_PROFILING arms traces into KARPENTER_TPU_PROFILE_DIR (or
    ./profiles) and says where; off, it arms nothing."""
    logged = []
    assert profiling.maybe_start_server(log=logged.append) is None
    assert profiling.profile_trace_dir() is None and logged == []
    monkeypatch.setenv("ENABLE_PROFILING", "true")
    monkeypatch.setenv("KARPENTER_TPU_PROFILE_DIR", str(tmp_path))
    assert profiling.maybe_start_server(log=logged.append) == str(tmp_path)
    assert str(tmp_path) in logged[0]
    monkeypatch.delenv("KARPENTER_TPU_PROFILE_DIR")
    assert profiling.profile_trace_dir() == str(tmp_path)
    monkeypatch.setattr(profiling, "_armed_dir", None)
    assert profiling.maybe_start_server() == "profiles"


def test_trace_solve_covers_the_spec_chain(monkeypatch, tmp_path):
    """The chunk chain's region (`ffd-spec-chain`) traces as the
    reference's does: one spec-on pass of 140 classes writes one trace of
    it."""
    from karpenter_tpu_torch.solver import TorchSolver
    from tests import test_spec as ts
    from tests.test_torch_sweep import to_port
    inp = to_port(ts.mkinput(ts.huge_pods()))
    solver = TorchSolver(max_nodes=512, device="cpu", spec="on",
                         delta="off")
    monkeypatch.setenv("KARPENTER_TPU_PROFILE", str(tmp_path))
    solver.solve(inp)
    assert solver.last_spec["outcome"] == "spec"
    traces = [f for f in os.listdir(tmp_path)
              if f.startswith("ffd-spec-chain-")]
    assert len(traces) == 1, os.listdir(tmp_path)
    with open(tmp_path / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "ffd-spec-chain" in names
