"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

Everything a cell needs is found by name from `BENCHMARK.json`: the
cell's configuration (`configs/<config>.json`) and traffic mix
(`traffic/<traffic>.json`), read by the one generator (`generate.py`);
each end-to-end metric is taken here, on the host's clock; each
per-layer metric is `metrics/<name>.py`'s `read(ctx)`, which returns
None where its cell gives it nothing to read.

The window drives the seam the operator's controllers call: a
`GatedSolver` over a `TorchSolver` on the card, built as the operator
builds it (default `Options`: the solver's feature gate on, the mesh
"auto", the recorders on and in memory) on the cards `run.py` shows
it.  A burst cell is a closed loop of
`GatedSolver.solve(..., source="provisioning")` over a ring of seeded
bursts; a consolidation cell a closed loop of
`GatedSolver.solve_batch(..., source="disruption", max_nodes=8)` calls
over a ring of seed-drawn candidate sets, as the disruption controller
makes them.  Every input of the ring is built at set-up, so the window
runs the program and nothing of the harness but its clock; the harness
holds nothing the collector walks (no `gc.freeze`: the program's heap is
collected as in an operator's process).

After the window the answers of a seed-drawn sample of the calls (and of
the first call of each ring slot and the last call), held as bytes, are
compared with the plain reference (`reference/ffd.py`); every number
compared is printed beside its limit.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import pickle
import resource
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench import generate
from portbench.reference import ffd as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")
KEEP_SHARE = 1.0 / 32       # the share of a window's calls checked


def load_benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: Dict, name: str, workload: Optional[Dict] = None
              ) -> Dict:
    wl = workload or next((w for w in bench["workloads"]
                           if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return {"workload": wl,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Ctx:
    """What the per-layer metric readers read.  The calls, their times,
    the counts and the phase histogram's deltas are those of the window's
    untraced part (all of an untraced run's window, the first half of a
    traced run's); `trace` and `kernels` are the traced half's."""
    kind: str
    window_s: float
    calls: int
    call_s: List[float]
    pods: int
    sims: int
    phases: Dict[tuple, tuple]           # (phase, path) -> (seconds, count)
    sweep_sims: int = 0
    trace: Optional[Dict] = None          # trace.DeviceTrace.summary()
    kernels: Dict[str, Dict] = field(default_factory=dict)
    setup_marks: Dict[str, float] = field(default_factory=dict)
    clocks: object = None                 # _Clocks over the window

    def phase_s(self, phases, paths) -> float:
        return sum(s for (ph, pa), (s, _) in self.phases.items()
                   if ph in phases and pa in paths)

    def kernel_s(self, cls: str) -> Dict[int, float]:
        """Device seconds of a kernel class on each card in the window."""
        from portbench.trace import kernel_class
        out: Dict[int, float] = {}
        for d, info in (self.trace or {}).get("devices", {}).items():
            out[d] = sum(b - a for a, b, n in info["ops"]
                         if kernel_class(n) == cls)
        return out

    def kernel_launches(self, cls: str) -> Dict[int, int]:
        from portbench.trace import kernel_class
        return {d: sum(1 for _, _, n in info["ops"] if kernel_class(n) == cls)
                for d, info in (self.trace or {}).get("devices", {}).items()}

    def roofline_pct(self, cls: str) -> Optional[float]:
        """The bound of the window's launches of a kernel class over their
        device time, in percent: the bound per launch (`kernels/`) is the
        mean over the calls the reference worked out; device time and
        launch count come from the traced run, per card, averaged over the
        cards that ran the class."""
        b = self.kernels.get(cls, {}).get("bound_ms_mean")
        t = {d: s for d, s in self.kernel_s(cls).items() if s > 0}
        if not b or not t:
            return None
        n = self.kernel_launches(cls)
        launches = sum(n[d] for d in t) / len(t)
        busy_ms = sum(t.values()) / len(t) * 1e3
        return 100.0 * b * launches / busy_ms

    def idle_pct(self) -> Optional[float]:
        """100 x (1 - busy / window), each card's busy time the union of
        its device operations in the traced window, averaged over the
        cards."""
        if not self.trace:
            return None
        devs = list(self.trace["devices"].values())
        busy = sum(d["busy_s"] for d in devs) / len(devs)
        if busy <= 0:
            return None
        return 100.0 * (1.0 - busy / self.trace["window_s"])


def _load_reader(name: str):
    path = os.path.join(_HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


PHASES = ("pregroup", "encode", "delta_encode", "pad", "dispatch",
          "device", "pull", "repair", "decode")
PATHS = ("solve", "sweep", "batch")


def _phase_snapshot(metrics) -> Dict[tuple, tuple]:
    h = metrics.SOLVER_PHASE_DURATION
    return {(ph, pa): (h.sum(phase=ph, path=pa), h.count(phase=ph, path=pa))
            for ph in PHASES for pa in PATHS}


def _delta(a: Dict[tuple, tuple], b: Dict[tuple, tuple]) -> Dict[tuple, tuple]:
    return {k: (v[0] - a.get(k, (0.0, 0))[0], v[1] - a.get(k, (0.0, 0))[1])
            for k, v in b.items() if v[1] - a.get(k, (0.0, 0))[1] > 0}


def _synchronize(torch, device: str) -> None:
    if device == "cuda":
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


class Tally:
    """The comparison of the program's answers with the reference's."""

    def __init__(self):
        self.checked = 0
        self.wrong = 0
        self.claims_wrong = 0
        self.pods_misplaced = 0
        self.price_gap = 0.0

    def add(self, got: ref.Answer, want: ref.Answer) -> None:
        self.checked += 1
        where_got, where_want = _placements(got), _placements(want)
        pods = set(where_got) | set(where_want)
        mis = sum(1 for p in pods if where_got.get(p) != where_want.get(p))
        claims = sum(1 for a, b in zip(got.claims, want.claims) if a != b)
        claims += abs(len(got.claims) - len(want.claims))
        gap = abs(sum(c[2] for c in got.claims)
                  - sum(c[2] for c in want.claims))
        self.pods_misplaced += mis
        self.claims_wrong += claims
        self.price_gap = max(self.price_gap, gap)
        if mis or claims or gap or got.existing != want.existing \
                or got.unschedulable != want.unschedulable:
            self.wrong += 1

    def add_batch(self, got: List[ref.Answer], want: List[ref.Answer]
                  ) -> None:
        """A call's simulations; one missing or extra counts as wrong."""
        for g, w in zip(got, want):
            self.add(g, w)
        self.checked += abs(len(got) - len(want))
        self.wrong += abs(len(got) - len(want))

    def checks(self) -> Dict[str, Dict]:
        """Each number compared, with its limit ("max": at most; "min": at
        least)."""
        return {
            "answers_checked": {"value": self.checked, "min": 1},
            "answers_wrong": {"value": self.wrong, "max": 0},
            "claims_wrong": {"value": self.claims_wrong, "max": 0},
            "pods_misplaced": {"value": self.pods_misplaced, "max": 0},
            "price_gap": {"value": self.price_gap, "max": 0.0},
        }

    def correct(self) -> bool:
        return all(("max" not in c or c["value"] <= c["max"])
                   and ("min" not in c or c["value"] >= c["min"])
                   for c in self.checks().values())


def _placements(a: ref.Answer) -> Dict[str, object]:
    out: Dict[str, object] = {p: ("node", n) for p, n in a.existing.items()}
    for i, c in enumerate(a.claims):
        for p in c[3]:
            out[p] = ("claim", i)
    for p in a.unschedulable:
        out[p] = ("unschedulable",)
    return out


def _pack(answer) -> bytes:
    """An answer held for the check, as bytes: the collector tracks no
    bytes object, so what the harness holds adds nothing to the program's
    collections in the window."""
    return pickle.dumps(answer, protocol=pickle.HIGHEST_PROTOCOL)


def _canonical(adapter, res):
    """A call's answer, or a batch's answers, in canonical form."""
    if isinstance(res, list):
        return [adapter.canonical(r) for r in res]
    return adapter.canonical(res)


class _Clocks:
    """The host's own readings over the window, for the run's log: the
    collector's time (`gc.callbacks`), page faults, involuntary context
    switches and CPU time (`getrusage`)."""

    def __init__(self):
        self.gc_s = 0.0
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t

    def __enter__(self):
        self._ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self._gc0 = [g["collections"] for g in gc.get_stats()]
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.collections = [g["collections"] - c
                            for g, c in zip(gc.get_stats(), self._gc0)]
        self.minflt = ru.ru_minflt - self._ru0.ru_minflt
        self.nivcsw = ru.ru_nivcsw - self._ru0.ru_nivcsw
        self.cpu_s = (ru.ru_utime + ru.ru_stime
                      - self._ru0.ru_utime - self._ru0.ru_stime)
        return False


def run(cell: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: Optional[float] = None,
        config: Optional[Dict] = None, options: Optional[Dict] = None,
        workload: Optional[Dict] = None) -> Dict:
    """One run; returns {"result": the result line's object, "checks":
    the numbers compared, "ctx": what the metric readers read}.  `config`
    and `options` (fields of the operator's `Options`) stand in for the
    cell's configuration file and the defaults in the tests, `workload`
    for a cell that `BENCHMARK.json` does not hold.

    With `trace`, the window's first half runs as an untraced window does
    and gives the host-clock readings; the profiler and the program's
    spans cover the second half only, which gives the device's."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = cell_spec(load_benchmark(), cell, workload)
    wl = spec["workload"]
    cfg = config or generate.load_config(wl["config"])
    tr = generate.load_traffic(wl["traffic"])
    kind = tr["kind"]

    import torch

    from karpenter_tpu_torch.cluster import Cluster
    from karpenter_tpu_torch.controllers.state import GatedSolver
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.solver import ffd, firstuse
    from karpenter_tpu_torch.utils import metrics, tracing

    from portbench import adapter
    from portbench.trace import DeviceTrace

    cards = torch.cuda.device_count() if device == "cuda" else 0
    marks = {"imported": time.perf_counter() - t0}
    ad = adapter.Adapter()
    gated = GatedSolver(Options(**(options or {})), Cluster(), device=device)

    marks["solver"] = time.perf_counter() - t0
    # -- set-up: the inputs of every call the window makes (a ring, gone
    # round in order), the warm-up of this cell's shapes, one round
    if kind == "burst":
        probs = generate.bursts(cfg, tr, seed)
        calls = [ad.schedule_input(p) for p in probs]
    else:
        fl = generate.fleet(cfg)
        cand_ring = [generate.candidate_sets(cfg, tr, seed, c)
                     for c in range(int(tr["ring"]))]
        calls = [ad.simulations(cfg, fl, cs) for cs in cand_ring]
    ring = len(calls)
    marks["inputs"] = time.perf_counter() - t0
    gated.warmup(calls[0] if kind == "burst" else calls[0][0])
    marks["warmup"] = time.perf_counter() - t0
    for inp in calls:
        if kind == "burst":
            gated.solve(inp, source="provisioning")
        else:
            list(gated.solve_batch(inp, source="disruption",
                                   max_nodes=cfg["max_nodes"]))
    _synchronize(torch, device)
    marks["warm_calls"] = time.perf_counter() - t0
    # every window starts from the same state of the collector (nothing
    # pending, every generation empty but the oldest), so that each run's
    # window makes the same collections for the same calls; nothing is
    # frozen, and the window collects the program's heap as it comes
    gc.collect()
    setup_s = time.perf_counter() - t0

    # -- the window
    keep_rng = generate.rng(seed, 3)
    kept: Dict[int, bytes] = {}
    last: Dict[str, object] = {}

    def drive(span_s: float, i: int) -> Dict:
        """Calls from call `i` on until `span_s` seconds of calls have
        passed.  Packing an answer held for the check is the harness's
        work: its time is taken out of the part's length."""
        p = {"i0": i, "call_s": [], "pods": 0, "sims": 0, "sweep_sims": 0}
        keep_s = 0.0
        s0 = time.perf_counter()
        while True:
            inp = calls[i % ring]
            if kind == "burst":
                c0 = time.perf_counter()
                with tracing.span("portbench.call"):
                    res = gated.solve(inp, source="provisioning")
                c1 = time.perf_counter()
                p["pods"] += len(inp.pods)
            else:
                lc0 = ffd.launch_counts()
                c0 = time.perf_counter()
                with tracing.span("portbench.call"):
                    res = list(gated.solve_batch(
                        inp, source="disruption",
                        max_nodes=cfg["max_nodes"]))
                c1 = time.perf_counter()
                lc1 = ffd.launch_counts()
                k4 = (lc1.get("ffd_sweep_scan", 0)
                      - lc0.get("ffd_sweep_scan", 0))
                k5 = (lc1.get("ffd_batch_scan", 0)
                      - lc0.get("ffd_batch_scan", 0))
                p["sims"] += len(res)
                if k4 + k5:
                    p["sweep_sims"] += len(res) * k4 // (k4 + k5)
            p["call_s"].append(c1 - c0)
            p["length_s"] = c1 - s0 - keep_s
            last["i"], last["res"] = i, res
            if i < ring or keep_rng.random() < KEEP_SHARE:
                k0 = time.perf_counter()
                kept[i] = _pack(_canonical(adapter, res))
                keep_s += time.perf_counter() - k0
            i += 1
            if p["length_s"] >= span_s:
                p["i1"] = i
                return p

    phases0 = _phase_snapshot(metrics)
    fu0 = firstuse.total()
    traced = summary = None
    with _Clocks() as clocks:
        host = drive(seconds / 2 if trace else seconds, 0)
        phases1 = _phase_snapshot(metrics)
        if trace:
            dtrace = DeviceTrace(cards)
            tracing.set_enabled(True)
            with dtrace:
                traced = drive(seconds - seconds / 2, host["i1"])
                dtrace.close_window()
            tracing.set_enabled(None)
            spans = [(s.start, s.start + s.duration, s.name)
                     for _, ss in tracing.finished_traces() for s in ss]
            summary = dtrace.summary(spans)
    n_calls = (traced or host)["i1"]
    if last["i"] not in kept:
        kept[last["i"]] = _pack(_canonical(adapter, last["res"]))
    fu_window = firstuse.total() - fu0
    phases = _delta(phases0, phases1)
    peak = max((torch.cuda.max_memory_allocated(d) for d in range(cards)),
               default=0)
    kind_name = (torch.cuda.get_device_name(0) if device == "cuda"
                 else "cpu")
    del gated, calls, last
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- the check, once the window has closed and the program is freed
    cols = ref.Columns(generate.catalog.load_table(cfg["catalog"]),
                       cfg["pools"])
    tally = Tally()
    from portbench.kernels import k4 as k4m, k5 as k5m, k7x as k7xm
    cat = {"O": cols.O, "PT": cols.PT, "P": len(cols.pools)}
    want: Dict[int, object] = {}
    for idx, blob in sorted(kept.items()):
        slot, got = idx % ring, pickle.loads(blob)
        if kind == "burst":
            if slot not in want:
                want[slot] = ref.solve(probs[slot], cols)
            tally.add(got, want[slot])
        else:
            if slot not in want:
                want[slot] = [ref.solve(generate.simulation(cfg, fl, cs),
                                        cols) for cs in cand_ring[slot]]
            tally.add_batch(got, want[slot])
    per_slot: Dict[str, Dict[int, float]] = {}
    for s, a in want.items():
        if kind == "burst":
            dims = {"G": a.work["groups"], "E": 0, "N": a.work["opened"],
                    **cat}
            per_slot.setdefault("K5", {})[s] = k5m.bound_ms(
                [(dims, a.work)], cat)
            per_slot.setdefault("K7x", {})[s] = k7xm.rank_bound_ms(
                dims, a.work, cat, max(cards, 1))
        else:
            E0 = int(cfg["nodes"])
            sims_w = [({"G": w.work["groups"], "E": E0 - len(cs),
                        "N": w.work["opened"], "X": len(cs),
                        "placed": w.work["existing_used"], **cat}, w.work)
                      for w, cs in zip(a, cand_ring[s])]
            per_slot.setdefault("K4", {})[s] = k4m.bound_ms(
                sims_w, E0, 1, cat)
            per_slot.setdefault("K5", {})[s] = k5m.bound_ms(sims_w, cat)
    # a kernel's bound is the mean over the calls the trace saw
    seen = range((traced or host)["i0"], n_calls)
    bounds = {k: [v[j % ring] for j in seen if j % ring in v]
              for k, v in per_slot.items()}
    checks = tally.checks()
    checks["compiles_in_window"] = {"value": fu_window, "max": 0}
    correct = tally.correct() and fu_window == 0

    ctx = Ctx(kind=kind, window_s=host["length_s"],
              calls=len(host["call_s"]), call_s=host["call_s"],
              pods=host["pods"], sims=host["sims"], phases=phases,
              sweep_sims=host["sweep_sims"], trace=summary,
              kernels={k: {"bound_ms_mean": float(np.mean(v)) if v else None}
                       for k, v in bounds.items()},
              setup_marks=marks, clocks=clocks)
    values: Dict[str, float] = {"setup_s": setup_s}
    if kind == "burst":
        values["pods_per_s"] = host["pods"] / host["length_s"]
    else:
        values["sims_per_s"] = host["sims"] / host["length_s"]
    out_metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = (_load_reader(m["name"])(ctx) if trace
             else values.get(m["name"]))
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": (n_calls if kind == "burst"
                      else host["sims"] + (traced or {}).get("sims", 0)),
        "failed": tally.wrong,
        "metrics": out_metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": kind_name, "count": cards,
                   "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        devs = summary["devices"]
        result["device"]["busy_s"] = float(np.mean(
            [v["busy_s"] for v in devs.values()]))
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(summary)
    result["checks"] = checks
    return {"result": result, "checks": checks, "ctx": ctx}


def breakdown(summary: Dict) -> Dict:
    """The device operations that took most time and the idle time by
    what the host was doing, each summed over the cards, the top 10."""
    ops: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    for info in summary["devices"].values():
        for a, b, n in info["ops"]:
            ops[n] = ops.get(n, 0.0) + (b - a)
        for k, v in info["idle"].items():
            idle[k] = idle.get(k, 0.0) + v
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def format_checks(checks: Dict[str, Dict]) -> List[str]:
    lines = []
    for name, c in checks.items():
        lim = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
        lines.append(f"check {name} {c['value']!r} limit {lim}")
    return lines


def main(argv: List[str], t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    wl = cell_spec(load_benchmark(), args.workload)["workload"]
    if args.trace:
        # the program's span ring holds every call of a traced window
        os.environ["KARPENTER_TPU_TRACE_BUFFER"] = "1000000"
    if importlib.util.find_spec("karpenter_tpu_torch") is None:
        print("portbench: the program (karpenter_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device: this benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() != int(wl["chips"]):
        # run.py shows the run the first `chips` cards of the host
        print(f"portbench: {args.workload} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    ctx = out["ctx"]
    ms = np.array(ctx.call_s) * 1e3
    ck = ctx.clocks
    print(f"portbench: {args.workload} seed {args.seed}: {ctx.calls} calls "
          f"in {ctx.window_s:.3f} s, a call p50 {np.median(ms):.3f} ms "
          f"min {ms.min():.3f} max {ms.max():.3f} deciles "
          f"{np.round(np.percentile(ms, range(10, 100, 10)), 2).tolist()}; "
          f"over the whole window: gc {ck.gc_s:.3f} s in "
          f"{ck.collections} collections, cpu {ck.cpu_s:.3f} s, "
          f"{ck.minflt} page faults, {ck.nivcsw} involuntary switches",
          file=sys.stderr)
    print("portbench: set-up seconds at "
          + ", ".join(f"{k} {v:.2f}" for k, v in ctx.setup_marks.items()),
          file=sys.stderr)
    for line in format_checks(out["checks"]):
        print(line, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out["result"]))
    return 0
