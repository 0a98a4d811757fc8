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
  k4            K4 (the consolidation sweep) through the tree's own
                wrappers and kernels, at config #4's first light chunk,
                config #4b's first heavy chunk and the disruption loop's
                first chunk of each chunk size: the profiler's device ms
                a launch and the CUDA events' ms a launch (20 launches
                each, `chip_smoke._device_ms`), and a digest of each
                launch's rows, which must agree across the trees.  The
                first k4 child runs the warmed disruption loop of
                `chip_smoke.py` phase 19 (`chip_smoke._disruption_run`)
                through its three waves — its wave-2 `disruption.
                simulate_batch` span and the sweep's `device` phase (the
                p50 printed is that span's total ms) — and keeps the
                chunks' arguments in `K4_CHUNKS` (git-ignored), which the
                later children load instead of running the loop (their
                p50 is nan) (not in the default arms)
  cards         K7x (the column-sharded solve across cards) through the
                tree's own wrappers, at S = 4: across cards 0-3 on a host
                of four or more, else rehearsed on one card (one
                cooperative grid of 4 blocks): at config #2's, the
                headline's and config #9's encodings (the last the gang
                instance) and phase 3's seeded S=4 problem, a rank's
                kernel (the profiler's device ms), the CUDA events' and
                the host's ms a launch (`--warm` launches each), the
                exchange rounds a launch, K7 at the same four shards on
                one card (for a round's cost over K7's) and a digest of
                the launch's rows, which must agree across the trees; then
                TorchSolver(mesh="auto") solves config #2 and the
                headline, cold and `--warm` times (the p50 printed is
                config #2's; on one card "auto" is the single-device
                path) (not in the default arms)

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
# the k4 arm's chunks, kept by its first child for the others
K4_CHUNKS = os.path.join(ROOT, "karpenter_tpu_torch", "_build",
                         "e2e_k4_chunks.pt")


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
    elif arm == "k4":
        return k4_child(warm)
    elif arm == "cards":
        return cards_child(warm)
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


def _save_chunks(path: str, shapes) -> None:
    """{label: (SweepBatch, FFDCatalog, N, K)} on the host, each
    dataclass as its class name and fields."""
    import dataclasses
    import torch

    def plain(x):
        if isinstance(x, torch.Tensor):
            return x.cpu().clone()  # its own storage, not a view's
        if dataclasses.is_dataclass(x):
            return {"class": type(x).__name__, "fields": {
                f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init}}
        return x
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: [plain(v) for v in val] for k, val in shapes.items()},
               path)


def _load_chunks(path: str, ffd, dev):
    """`_save_chunks`' file, rebuilt with this tree's classes on `dev`."""
    import torch

    def build(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict) and set(x) == {"class", "fields"}:
            return getattr(ffd, x["class"])(
                **{k: build(v) for k, v in x["fields"].items()})
        return x
    return {k: tuple(build(v) for v in val) for k, val in
            torch.load(path, weights_only=False).items()}


def k4_child(warm: int) -> int:
    """The k4 arm on the tree first on sys.path: prints one JSON line."""
    import hashlib
    import torch
    import chip_smoke as cs
    from karpenter_tpu_torch.solver import TorchSolver, ffd
    from karpenter_tpu_torch.workloads import build_config4, build_config4b
    card = cs._card_line()
    dev = torch.device("cuda", 0)
    nan = float("nan")
    cold, sim_ms, phases, counts = nan, nan, {}, {}
    if os.path.exists(K4_CHUNKS):
        shapes = _load_chunks(K4_CHUNKS, ffd, dev)
    else:
        kept = {}
        real = ffd.solve_ffd_sweep

        def capture(sw, c, n, sparse_k=0):
            key = (f"loop {'heavy' if sw.heavy else 'light'} chunk "
                   f"B={sw.B} G={sw.G} E={sw.E} N={n}")
            if key not in kept:
                kept[key] = (cs._clone(sw), c, n, sparse_k)
            return real(sw, c, n, sparse_k)
        ffd.solve_ffd_sweep = capture
        try:
            t0 = time.perf_counter()
            waves, _, _ = cs._disruption_run(card, warm_up=True)
            cold = (time.perf_counter() - t0) * 1e3
        finally:
            ffd.solve_ffd_sweep = real
        w2 = waves[1]
        sim_ms = w2["spans_ms"].get("disruption.simulate_batch", 0.0)
        phases = {"wave 2 simulate_batch": sim_ms,
                  "wave 2 device": w2["solve_batch"].get("phase device",
                                                         0.0),
                  "wave 2 wall": w2["wall_ms"]}
        counts = {k: v for k, v in w2["launches"].items() if v}
        shapes = {"config #4 light chunk": cs._first_chunks(
            ffd, TorchSolver(), build_config4())[False],
            "config #4b heavy chunk": cs._first_chunks(
            ffd, TorchSolver(), build_config4b())[True]}
        shapes.update(sorted(kept.items()))
        _save_chunks(K4_CHUNKS, shapes)
    out = {}
    for label, (sw, c, n, k) in shapes.items():
        lay = ffd.flat_layout(sw.G, sw.E, n, sw.D, 0, k)
        flat = torch.empty((sw.B, lay["total"][1]), device=dev)
        lim = torch.empty((sw.B, sw.P, ffd.R), device=dev)
        scan = ffd.sweep_topo_scan if sw.heavy else ffd.sweep_scan
        fn = lambda: scan(sw, c, n, flat, lay, lim, k)  # noqa: E731
        ms, ev = cs._device_ms(fn, max(warm, 1), cs._tag(sw.heavy, True,
                                                         False))
        flat.fill_(float("nan"))
        lim.fill_(float("nan"))
        fn()
        torch.cuda.synchronize()
        h = hashlib.sha256(flat.cpu().numpy().tobytes())
        h.update(lim.cpu().numpy().tobytes())
        out[label] = {"ms": ms, "events_ms": ev, "digest": h.hexdigest()}
    print(json.dumps({
        "arm": "k4", "cold_ms": cold, "p50": sim_ms, "min": sim_ms,
        "max": sim_ms, "n": 1, "phase_p50": phases, "launches": counts,
        "k4": out}))
    return 0


def cards_child(warm: int) -> int:
    """The cards arm on the tree first on sys.path: prints one JSON
    line."""
    import hashlib
    import torch
    import chip_smoke as cs
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.solver import TorchSolver, ffd
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(4)] if n >= 4
            else [torch.device("cuda", 0)] * 4)
    from karpenter_tpu_torch.parallel.mesh import shard_problem
    solver = TorchSolver()
    delta = next(x for x in cs._sharded_cases() if x[0] == "S4-delta")
    cases = {
        "config #2": cs._encoded_problem(solver, workloads.build_config2(),
                                         ffd) + (cs.CONFIG2_MAX_NODES, None),
        "headline": cs._encoded_problem(
            solver, workloads.build_input(cs.HEADLINE_PODS), ffd)
        + (solver.max_nodes, None),
        "gang config #9": cs._encoded_problem(
            solver, workloads.build_config9(), ffd)
        + (cs.CONFIG_MAX_NODES, None),
        "seeded S4-delta": (delta[2], delta[3], delta[4], delta[6])}
    reps = max(warm, 1)
    xch = ffd.card_exchange(devs)
    out = {}
    for label, (prob, catarr, N, seeds) in cases.items():
        c = cs._Cards(ffd, 4, prob, catarr, N, 1, seeds, devs)
        flat, lim = c.bufs()
        fn = lambda: c.launch(flat, lim)  # noqa: E731
        ms, ev = cs._device_ms(fn, reps, cs._tag(
            seeds is None, False, bool(c.wg), seeds is not None, 2))
        for d in set(devs):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        flat.fill_(float("nan"))
        lim.fill_(float("nan"))
        before = xch.rounds() if hasattr(xch, "rounds") else 0
        fn()
        for d in set(devs):
            torch.cuda.synchronize(d)
        # the exchange rounds of one launch: the round count's step, or
        # (a tree whose flags hold the last round) the low word
        rounds = (xch.rounds() - before if hasattr(xch, "rounds")
                  else int(xch.flags[0][1].item()) & 0xffffffff)
        h = hashlib.sha256(flat.cpu().numpy().tobytes())
        h.update(lim.cpu().numpy().tobytes())
        out[label] = {"ms": ms, "events_ms": ev, "host_ms": host,
                      "rounds": rounds, "digest": h.hexdigest()}
        if seeds is None and not c.wg:
            # K7 on one card at the same shards, for a round's cost
            p, table, sc, _ = shard_problem(prob, catarr, 4, devs[0])
            lay = ffd.flat_layout(p.G, p.E, N, p.D, 1)
            fl = torch.empty(lay["total"][1], device=devs[0])
            lm = torch.empty((p.P, ffd.R), device=devs[0])
            out[label]["k7_ms"] = cs._device_ms(
                lambda: ffd.sharded_scan(p, table, sc, N, fl, lay, lm, 0),
                reps, cs._tag(True, False, False, False, 1))[0]
    p50 = {}
    for label, build, mn in (
            ("config #2", workloads.build_config2, cs.CONFIG2_MAX_NODES),
            ("headline", lambda: workloads.build_input(cs.HEADLINE_PODS),
             cs.CONFIG_MAX_NODES)):
        sv, inp = TorchSolver(mesh="auto", max_nodes=mn), build()
        sv.solve(inp)
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sv.solve(inp)
            for d in set(devs):
                torch.cuda.synchronize(d)
            ms.append((time.perf_counter() - t0) * 1e3)
        p50[f"mesh=auto {label}"] = statistics.median(ms)
        p50[f"mesh=auto {label} mesh"] = str(sv.mesh)
    main = p50["mesh=auto config #2"]
    print(json.dumps({
        "arm": "cards", "cold_ms": float("nan"), "p50": main, "min": main,
        "max": main, "n": reps, "phase_p50": {
            k: v for k, v in p50.items() if not isinstance(v, str)},
        "launches": {}, "cards": out,
        "meshes": {k: v for k, v in p50.items() if isinstance(v, str)},
        "rehearsed": n < 4}))
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
    if os.path.exists(K4_CHUNKS):
        os.remove(K4_CHUNKS)  # the first k4 child runs the loop
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
    bad = _k4_report(got.get("k4"), card)
    bad = _cards_report(got.get("cards"), card) or bad
    for arm in arms:
        print(f"[e2e] {arm} on {card}: " + "; ".join(
            f"{name} warm p50 " + ", ".join(f"{r['p50']:.3f}" for r in recs)
            + f" ms (lower {_lower(r['p50'] for r in recs):.3f})"
            for name, recs in got[arm].items()), flush=True)
    return 1 if bad else 0


def _lower(vals) -> float:
    """The least of the measured values (nan where none was)."""
    got = [v for v in vals if v == v]
    return min(got) if got else float("nan")


def _k4_report(trees, card) -> bool:
    """The k4 arm's launches, each tree's lower ms of its turns; True when
    a launch's rows differ between the trees (or turns)."""
    if not trees:
        return False
    labels = list(next(iter(trees.values()))[0]["k4"])
    bad = False
    for label in labels:
        parts, digests = [], set()
        for name, recs in trees.items():
            got = [r["k4"].get(label) for r in recs]
            if None in got:
                bad = True
                continue
            digests.update(g["digest"] for g in got)
            parts.append(
                f"{name} profiler " + ", ".join(f"{g['ms']:.4f}" for g in got)
                + f" (lower {min(g['ms'] for g in got):.4f}) events "
                + ", ".join(f"{g['events_ms']:.4f}" for g in got)
                + f" (lower {min(g['events_ms'] for g in got):.4f})")
        same = len(digests) == 1
        bad = bad or not same
        print(f"[k4] {label} on {card}, ms a launch: " + "; ".join(parts)
              + ("; rows equal across trees" if same
                 else "; ROWS DIFFER"), flush=True)
    return bad


def _cards_report(trees, card) -> bool:
    """The cards arm's launches, each tree's lower ms of its turns; True
    when a launch's rows differ between the trees (or turns)."""
    if not trees:
        return False
    bad = False
    first = next(iter(trees.values()))[0]
    where = ("rehearsed on one card (S=4)" if first["rehearsed"]
             else "across 4 cards")
    for label in first["cards"]:
        parts, digests = [], set()
        for name, recs in trees.items():
            got = [r["cards"].get(label) for r in recs]
            if None in got:
                bad = True
                continue
            digests.update(g["digest"] for g in got)
            lower = {k: min(g[k] for g in got)
                     for k in ("ms", "events_ms", "host_ms", "k7_ms")
                     if k in got[0]}
            text = f"{name} " + " ".join(
                f"{k} " + ", ".join(f"{g[k]:.4f}" for g in got)
                + f" (lower {v:.4f})" for k, v in lower.items())
            rounds = got[0]["rounds"]
            text += f"; {rounds} rounds a launch"
            if "k7_ms" in lower and rounds:
                over = (lower["ms"] - lower["k7_ms"]) / rounds * 1e3
                text += f", {over:.2f} us a round over K7's"
            parts.append(text)
        same = len(digests) == 1
        bad = bad or not same
        print(f"[cards] K7x {label} {where} on {card}, ms a launch: "
              + "; ".join(parts)
              + ("; rows equal across trees" if same
                 else "; ROWS DIFFER"), flush=True)
    for name, recs in trees.items():
        print(f"[cards] {name} mesh='auto' warm p50 on {card}: " + "; ".join(
            f"{k} " + ", ".join(f"{r['phase_p50'][k]:.3f}" for r in recs)
            + " ms" for k in recs[0]["phase_p50"])
            + f" (meshes {recs[0]['meshes']})", flush=True)
    return bad


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
