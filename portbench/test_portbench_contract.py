"""BENCHMARK.json keeps to the benchmark's contract, every name in it has
its files, and a run's last line has the keys the contract asks for."""

import json
import os
import re

import pytest

from portbench import generate, harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return harness.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_command(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    files = set()
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert generate.load_config(c["name"])["name"] == c["name"]


def test_workloads(bench):
    pairs = set()
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
        generate.load_traffic(w["traffic"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) <= 24


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = set(e2e)
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["name"] not in names
        names.add(m["name"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        assert os.path.exists(os.path.join(
            harness._HERE, "metrics", m["name"] + ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        spec = harness.cell_spec(bench, w)
        got = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2
        assert spec["per_layer"]


def test_last_line_keys():
    cfg = generate.load_config("burst50k")
    for c in cfg["classes"]:
        c["count"] = max(c["count"] // 100, 1)
    out = harness.run("burst50k.cold", 2 ** 40 + 3, 0.5, False,
                      device="cpu", config=cfg)
    res = out["result"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert set(res["metrics"]) == {"pods_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(res["device"])
    json.dumps(res)


def test_a_run_sees_only_the_cards_its_cell_asks_for(monkeypatch):
    from portbench import run
    argv = ["--workload", "burst50k.cold", "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env = run._pinned_env(argv)
    assert env["CUDA_VISIBLE_DEVICES"] == "0"
    assert env["PYTHONHASHSEED"] == "0" and env["OMP_NUM_THREADS"] == "1"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,1,2")
    assert run._pinned_env(argv)["CUDA_VISIBLE_DEVICES"] == "3"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert "CUDA_VISIBLE_DEVICES" not in run._pinned_env(
        ["--workload", "no.such.cell"])


@pytest.mark.parametrize("command", [["portbench/run.py"],
                                     ["-m", "portbench"]])
def test_both_commands_pin_the_run_and_refuse_without_a_card(command):
    """Either command runs `run.main`: with no card (this sandbox) it
    exits non-zero, prints no result, and says so."""
    import subprocess
    import sys
    p = subprocess.run(
        [sys.executable, *command, "--workload", "burst50k.cold",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={k: v for k, v in os.environ.items()
             if k not in ("PORTBENCH_PINNED", "PYTHONHASHSEED")})
    assert p.returncode != 0 and not p.stdout.strip()
    assert "no CUDA device" in p.stderr
