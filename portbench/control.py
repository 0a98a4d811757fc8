"""The check's control: the reference with one guarantee of the
configuration broken (its `"control"`: "order" drops the decreasing
order of first-fit decreasing, "first_fit" fills existing nodes from the
last), put in the program's place and judged as a run judges the
program, at the cell's own sizes.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed ...]

prints, per seed, each number the check compares with its limit, and
whether the control came out correct (it must not).  It needs no card
and never imports the program.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import generate  # noqa: E402
from portbench.harness import (  # noqa: E402
    Tally,
    cell_spec,
    format_checks,
    load_benchmark,
)
from portbench.reference import ffd as ref  # noqa: E402

CALLS = 8     # consolidation calls judged a seed


def readings(cell: str, seed: int, cfg=None) -> Tally:
    wl = cell_spec(load_benchmark(), cell)["workload"]
    cfg = cfg or generate.load_config(wl["config"])
    tr = generate.load_traffic(wl["traffic"])
    cols = ref.Columns(generate.catalog.load_table(cfg["catalog"]),
                       cfg["pools"])
    tally = Tally()
    if tr["kind"] == "burst":
        probs = [generate.bursts(cfg, tr, seed)]
    else:
        fl = generate.fleet(cfg)
        probs = [[generate.simulation(cfg, fl, cs) for cs in
                  generate.candidate_sets(cfg, tr, seed, call)]
                 for call in range(CALLS)]
    for call in probs:
        for p in call:
            tally.add(ref.solve(p, cols, control=cfg["control"]),
                      ref.solve(p, cols))
    return tally


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    passed = 0
    for seed in args.seed:
        t = readings(args.workload, seed)
        print(f"{args.workload} seed {seed}: control correct "
              f"{t.correct()}")
        for line in format_checks(t.checks()):
            print("  " + line)
        passed += t.correct()
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
