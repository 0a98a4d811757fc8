"""On the card: one short run of each cell the host has cards for comes
out correct, and the command refuses a cell that needs more cards."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

RUN = os.path.join(harness._HERE, "run.py")


def _run(cell, seconds="2"):
    return subprocess.run(
        [sys.executable, RUN, "--workload", cell, "--seed", "4294967311",
         "--seconds", seconds, "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=1200)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_benchmark()["workloads"]])
def test_a_short_run_is_correct(card, cell):
    chips = harness.cell_spec(harness.load_benchmark(),
                              cell)["workload"]["chips"]
    p = _run(cell)
    if card < chips:
        assert p.returncode != 0 and not p.stdout.strip()
        return
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["count"] == chips
