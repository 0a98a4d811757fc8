"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, the benchmark
(`portbench/`) and the program (`karpenter_tpu_torch/`), on a host with
as many CUDA cards as the cell asks for.  `python3 -m portbench` comes
here too.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_PINNED = "PORTBENCH_PINNED"


def _chips(argv):
    """The cards the cell asks for, from `BENCHMARK.json`; None where the
    arguments or the file name no cell (the harness then says why)."""
    if "--workload" not in argv[:-1]:
        return None
    name = argv[argv.index("--workload") + 1]
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            cells = json.load(f)["workloads"]
    except (OSError, ValueError, KeyError):
        return None
    return next((int(w["chips"]) for w in cells if w.get("name") == name),
                None)


def _pinned_env(argv):
    """The run's environment: one hash seed for every run (string and
    tuple hashes order the program's dicts and sets, and with them the
    layout of what it allocates); one thread of host arithmetic (the
    solver's host paths are single-threaded, and idle pools spinning
    beside them on a shared host only widen the spread of its clock); and
    the first `chips` cards of the host, so that a one-card cell runs on
    one card whatever the host holds (the solver's mesh "auto" would
    otherwise spread over every card it sees)."""
    env = dict(os.environ, PYTHONHASHSEED="0", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    env[_PINNED] = "1"
    chips = _chips(argv)
    if chips:
        seen = [c for c in env.get("CUDA_VISIBLE_DEVICES", "").split(",")
                if c.strip()]
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            (seen or [str(c) for c in range(chips)])[:chips])
    return env


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if os.environ.get(_PINNED) != "1":
        # the set-up clock runs from this first process's start
        env = _pinned_env(argv)
        env["PORTBENCH_T0"] = repr(T0)
        os.execve(sys.executable,
                  [sys.executable, os.path.join(HERE, "run.py")] + argv, env)
    t0 = float(os.environ.pop("PORTBENCH_T0", T0))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness
    return harness.main(argv, t0)


if __name__ == "__main__":
    sys.exit(main())
