"""The port's post-mortem tools, `python -m karpenter_tpu_torch.tools.
kt_replay` and `... .kt_explain` (the twins of `tools/kt_replay.py` and
`tools/kt_explain.py`): a port solve captured by the flight recorder
(KARPENTER_TPU_FLIGHT_DIR + KARPENTER_TPU_FLIGHT_CAPTURE=1), replayed on
the CPU to the recorded digest (exit 0), a tampered digest reported as a
mismatch (exit 1), and the stranded pod's reason tree from the replay
with explain=full, equal to the JAX package's code for the same pod.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from karpenter_tpu_torch.models import NodePool, ObjectMeta, Pod, Resources
from karpenter_tpu_torch.providers import generate_catalog
from karpenter_tpu_torch.providers.catalog import CatalogSpec
from karpenter_tpu_torch.scheduling import ScheduleInput
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.utils import flightrecorder as fr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = ("KARPENTER_TPU_FLIGHT", "KARPENTER_TPU_DELTA", "KARPENTER_TPU_SPEC",
          "KARPENTER_TPU_MESH", "KARPENTER_TPU_EXPLAIN", "KARPENTER_TPU_GANG")


def _pods(M):
    pods = [M.Pod(meta=M.ObjectMeta(name=f"r{i}"),
                  requests=M.Resources.parse({"cpu": "1", "memory": "2Gi"}))
            for i in range(24)]
    pods.append(M.Pod(meta=M.ObjectMeta(name="huge"),
                      requests=M.Resources.parse({"cpu": "1",
                                                  "memory": "8000Gi"})))
    return pods


@pytest.fixture
def captured(monkeypatch, tmp_path):
    """One port solve on the CPU with its problem captured; yields the
    flight directory's JSONL file."""
    for k in PINNED:  # the tools pin these; restore them after each test
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("KARPENTER_TPU_FLIGHT_CAPTURE", "1")
    fr.RECORDER.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    import karpenter_tpu_torch.models as M
    inp = ScheduleInput(
        pods=_pods(M), nodepools=[NodePool(meta=ObjectMeta(name="default"))],
        instance_types={"default": generate_catalog(
            CatalogSpec(max_types=12, include_gpu=False))})
    res = TorchSolver(max_nodes=64, device="cpu").solve(inp)
    assert "huge" in res.unschedulable
    path = os.path.join(str(tmp_path), f"flight-{os.getpid()}.jsonl")
    assert os.path.exists(path)
    yield path
    fr.RECORDER.reset()
    torch.set_num_threads(n)


def test_replay_gives_the_recorded_digest(captured):
    from karpenter_tpu_torch.tools import kt_replay
    out = kt_replay.replay_file(captured, device="cpu")
    assert out["diffs"] == []
    assert out["recorded"]["price_hex"] == out["replayed"]["price_hex"]
    assert out["record"]["capture"].endswith(".pkl")
    # a bare capture replays too (no digest to compare)
    bare = kt_replay.replay_file(out["record"]["capture"], device="cpu")
    assert bare["recorded"] is None and bare["diffs"] == []


def test_a_tampered_digest_is_a_mismatch(captured, tmp_path):
    recs = fr.load_records(captured)
    rec = [r for r in recs if r.get("capture")][-1]
    rec["result"]["price_hex"] = "0x1.0p+0"
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(rec) + "\n")
    env = dict(os.environ, KARPENTER_TPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.tools.kt_replay",
         str(bad)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "REPLAY MISMATCH" in p.stderr


def test_explain_names_the_stranded_pod_as_the_reference(captured):
    env = dict(os.environ, KARPENTER_TPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.tools.kt_explain",
         captured, "--pod", "huge"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    doc = json.loads(p.stdout)
    assert doc["pod"] == "huge" and doc["tree"]
    # the JAX package's verdict on the same problem
    import karpenter_tpu.models as JM
    from karpenter_tpu.providers import generate_catalog as jgen
    from karpenter_tpu.providers.catalog import CatalogSpec as JSpec
    from karpenter_tpu.scheduling import ScheduleInput as JInput
    from karpenter_tpu.solver import TPUSolver
    from karpenter_tpu.solver import explain as jexplain
    jinp = JInput(pods=_pods(JM), nodepools=[JM.NodePool(
        meta=JM.ObjectMeta(name="default"))], instance_types={
        "default": jgen(JSpec(max_types=12, include_gpu=False))})
    jres = TPUSolver(max_nodes=64, mesh="off").solve(jinp)
    assert doc["code"] == jexplain.code_of(jres.unschedulable["huge"])
    # a pod the replay did not strand: exit 2
    p = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.tools.kt_explain",
         captured, "--pod", "r0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 2
