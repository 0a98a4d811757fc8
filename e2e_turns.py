#!/usr/bin/env python3
"""End-to-end warm latency of the port's solve paths on the card, against
another tree of the port in turns.

Run from the repository root on a machine with an NVIDIA H100:

    python3 e2e_turns.py [--against DIR] [--arms A,B,...] [--warm N]

Each arm runs in a child process of its own, with one tree's
`karpenter_tpu_torch` first on `sys.path` (this checkout's, or with
`--against DIR` another tree's, e.g. the parent commit unpacked by `git
archive` into the git-ignored `.chip_parent/`); with `--against` the trees
take turns: DIR, this, this, DIR.  A child builds its tree's kernels (the
first child of a tree pays the build), solves once cold and then `--warm`
times (the steady-state arms: their own passes), each solve timed on the
host clock up to a device synchronise, and prints one JSON line: the warm
p50, min and max in ms, the solver's phase p50s and the kernel wrappers'
launch counts over the timed solves (every counter a tree's `solver/ffd.py`
keeps).  The arms use only the entry points both trees share:

  headline      TorchSolver().solve(workloads.build_input(50_000))
  config9-full  config #9 on TorchSolver(max_nodes=2048), a fresh solver
                under KARPENTER_TPU_EXPLAIN=full (the explain=2 map)
  config7-delta config #7 on TorchSolver(max_nodes=2048) (delta on): gen 0,
                one warm pass, then `--warm` churn passes
  config12-spec config #12 (471,680 pods) on TorchSolver(max_nodes=2048,
                delta="off", spec="on"): the chunk chain, 5 warm passes
  batch64       solve_batch of 64 headline-sized inputs (100 to 2,431 pods
                each, one catalog and pool) with explain=counts (uncapped)

Prints, per arm, each turn's p50 and each tree's lower p50 with the
card's name and power limit.  Exits non-zero without a CUDA device or
when a child fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARMS = ("headline", "config9-full", "config7-delta", "config12-spec",
        "batch64")


def _counts(ffd):
    """{wrapper.attribute: value} of every launch counter of `ffd`."""
    out = {}
    for w in ("batch_scan", "delta_scan", "sharded_scan", "sweep_scan",
              "sweep_topo_scan", "pack"):
        fn = getattr(ffd, w, None)
        for a in dir(fn) if fn is not None else ():
            if a.endswith("launches"):
                out[f"{w}.{a}"] = getattr(fn, a)
    return out


def _batch64_inputs():
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.models import NodePool, ObjectMeta
    from karpenter_tpu_torch.providers import generate_catalog
    from karpenter_tpu_torch.scheduling import ScheduleInput
    catalog = generate_catalog()
    pool = NodePool(meta=ObjectMeta(name="default"))
    return [ScheduleInput(pods=workloads.headline_pods(100 + 37 * i,
                                                       prefix=f"b{i}-"),
                          nodepools=[pool],
                          instance_types={"default": catalog})
            for i in range(64)]


def child(arm: str, root: str, warm: int) -> int:
    """One arm on `root`'s package: prints one JSON line."""
    sys.path.insert(0, root)
    import torch
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.solver import TorchSolver, ffd
    big = 2048
    if arm == "headline":
        solver, inp = TorchSolver(), workloads.build_input(50_000)
        runs = [lambda: solver.solve(inp)] * (1 + warm)
    elif arm == "config9-full":
        os.environ["KARPENTER_TPU_EXPLAIN"] = "full"
        solver, inp = TorchSolver(max_nodes=big), workloads.build_config9()
        runs = [lambda: solver.solve(inp)] * (1 + warm)
    elif arm == "config7-delta":
        solver = TorchSolver(max_nodes=big)
        gens = [workloads.build_config7(g) for g in range(2 + warm)]
        solver.solve(gens[0])
        runs = [lambda i=i: solver.solve(gens[i])
                for i in range(1, 2 + warm)]
    elif arm == "config12-spec":
        solver = TorchSolver(max_nodes=big, delta="off", spec="on")
        inp = workloads.build_config12()
        runs = [lambda: solver.solve(inp)] * (1 + min(warm, 5))
    elif arm == "batch64":
        solver, inps = TorchSolver(), _batch64_inputs()
        runs = [lambda: solver.solve_batch(inps)] * (1 + warm)
    else:
        raise SystemExit(f"unknown arm {arm!r}")
    t0 = time.perf_counter()
    runs[0]()
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    c0 = _counts(ffd)
    ms, phases = [], {}
    for run in runs[1:]:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in solver.last_phase_ms.items():
            phases.setdefault(k, []).append(v)
    c1 = _counts(ffd)
    print(json.dumps({
        "arm": arm, "cold_ms": cold, "p50": statistics.median(ms),
        "min": min(ms), "max": max(ms), "n": len(ms),
        "phase_p50": {k: statistics.median(v) for k, v in phases.items()},
        "launches": {k: c1[k] - c0.get(k, 0) for k in c1
                     if c1[k] - c0.get(k, 0)}}))
    return 0


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", default=None,
                    help="another tree of the port to run in turns")
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("e2e_turns: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    if args.child:
        return child(args.child, os.path.abspath(args.root), args.warm)
    trees = [("this", ROOT)]
    if args.against:
        other = ("against", os.path.abspath(args.against))
        trees = [other, trees[0], trees[0], other]
    card = _card()
    arms = args.arms.split(",")
    got = {}
    for name, root in trees:
        for arm in arms:
            env = dict(os.environ)
            env.pop("KARPENTER_TPU_EXPLAIN", None)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", arm,
                 "--root", root, "--warm", str(args.warm)],
                cwd=root, capture_output=True, text=True, timeout=1500,
                env=env)
            lines = out.stdout.strip().splitlines()
            if out.returncode or not lines:
                print(f"e2e_turns: {arm} on {name} failed:\n"
                      f"{out.stderr[-4000:]}", file=sys.stderr)
                return 1
            rec = json.loads(lines[-1])
            got.setdefault(arm, {}).setdefault(name, []).append(rec)
            print(f"[turn] {name} {arm} on {card}: warm p50 "
                  f"{rec['p50']:.3f} ms over {rec['n']} (min "
                  f"{rec['min']:.3f}, max {rec['max']:.3f}; cold "
                  f"{rec['cold_ms']:.1f}); phases p50 "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              rec["phase_p50"].items())
                  + f"; launches {rec['launches']}", flush=True)
    for arm in arms:
        print(f"[e2e] {arm} on {card}: " + "; ".join(
            f"{name} warm p50 " + ", ".join(f"{r['p50']:.3f}" for r in recs)
            + f" ms (lower {min(r['p50'] for r in recs):.3f})"
            for name, recs in got[arm].items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
