#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (karpenter_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from karpenter_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, on seeded
     problems and on the headline's encoded problem: flat result buffers
     must be equal as uint32;
  4. the main path: TorchSolver().solve(build_input(50_000)) — one cold
     and 20 warm solves through the kernels — must give the JAX package's
     answer, with every kernel's launch count above zero;
  5. warm solves with the take_new compaction against dense, at a size
     where the compaction engages;
  6. kernel timings beside their bounds.
The line before the card line is the kernels' JSON record; the last line
is {"ok": true, "device": {...}}.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# The 50k headline's answer from the JAX package (karpenter_tpu TPUSolver,
# mesh/delta/spec/incr off, float32 on the CPU): 782 new nodes, none
# unschedulable, total price as a float hex string.
HEADLINE_PODS = 50_000
HEADLINE_NODES = 782
HEADLINE_UNSCHED = 0
HEADLINE_PRICE_HEX = "0x1.c192b9cb6848bp+12"
WARM_SOLVES = 20
# the take_new compaction engages on a warm solve whose previous per-group
# fan-out is small against the node axis: on the headline workload that
# holds at a few hundred pods (N=64), not at 50k (fan-out 782 of 1024)
COMPACT_PODS = 240

# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes/s and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _seeded_cases():
    """(label, problem tuple, catalog arrays, N, sparse_n, explain)."""
    from karpenter_tpu_torch.solver.problems import random_problem
    specs = [
        ("base", dict(), 64, 0, 1),
        ("no-existing", dict(E=0), 64, 0, 1),
        ("3-pools-finite", dict(P=3, limits="finite"), 64, 0, 1),
        ("slot-exhaustion", dict(P=1, limits="none", pod_scale=300), 16,
         0, 1),
        ("sparse-overflow", dict(pod_scale=400), 64, 8, 1),
        ("sparse-K", dict(), 256, 32, 1),
        ("explain-off", dict(), 64, 0, 0),
        ("wide", dict(G=32, E=64, PT=640, ZC=6, P=2, pod_scale=200),
         1024, 0, 1),
        ("whole-node", dict(whole=True, pod_scale=20), 64, 0, 1),
        ("strided-nodes", dict(G=16, E=0, PT=128, pod_scale=3000), 2048,
         0, 1),
        ("strided-existing", dict(E=2048, pod_scale=900), 256, 0, 1),
        ("8-pools", dict(P=8, limits="mixed", PT=128), 256, 0, 1),
        ("wide-sparse", dict(G=32, E=16, PT=640, pod_scale=300), 1024,
         128, 1),
    ]
    for i, (label, kw, N, kn, ex) in enumerate(specs):
        prob, cat = random_problem(100 + i, **kw)
        yield label, prob, cat, N, kn, ex


def _k1_regions(lay):
    return [n for n in ("take_exist", "take_new", "unsched", "dom_placed",
                        "used", "node_pool", "node_zone", "node_ct",
                        "num_active") if n in lay]


def _k2_regions(lay):
    return [n for n in ("sp_cnt", "sp_idx", "sp_nnz", "explain_counts",
                        "explain_bits") if n in lay]


def compare_case(ffd, prob, cat, N, kn, ex, dev):
    """Run K1 and K2 and their plain versions on the card on the same
    inputs.  K2 and its plain version both start from the kernel's K1
    output, so each comparison isolates one kernel.  Returns
    {kernel: (equal, max_abs_err)}."""
    import torch
    p, c = ffd.problem_from_numpy(prob, cat, dev)
    lay = ffd.flat_layout(p.G, p.E, N, p.D, kn, ex)
    total = lay["total"][1]

    def buffers():
        flat = torch.full((total,), float("nan"), device=dev)
        tn = (torch.full((p.G * N,), float("nan"), device=dev) if kn
              else flat[lay["take_new"][0]:lay["take_new"][0] + p.G * N])
        lim = torch.full((p.P, ffd.R), float("nan"), device=dev)
        return flat, tn, lim

    fk, tk, lk = buffers()
    ffd.light_scan(p, c, N, fk, lay, tk, lk)
    fp, tp, lp = buffers()
    ffd.light_scan_reference(p, c, N, fp, lay, tp, lp)
    torch.cuda.synchronize()

    def diff(a, b):
        a = a.detach().cpu().numpy().reshape(-1)
        b = b.detach().cpu().numpy().reshape(-1)
        if a.shape != b.shape:
            return False, float("inf")
        differ = a.view(np.uint32) != b.view(np.uint32)
        if not differ.any():
            return True, 0.0
        d = np.abs(a[differ].astype(np.float64) - b[differ].astype(np.float64))
        return False, float(np.max(np.where(np.isfinite(d), d, np.inf)))

    parts = [diff(ffd._region(fk, lay, n), ffd._region(fp, lay, n))
             for n in _k1_regions(lay)]
    parts += [diff(tk, tp), diff(lk, lp)]
    out = {"ffd_light_scan": (all(e for e, _ in parts),
                              max(x for _, x in parts))}
    if kn or ex:
        f2, f3 = fk.clone(), fk.clone()
        t2 = tk.clone() if kn else f2[lay["take_new"][0]:
                                      lay["take_new"][0] + p.G * N]
        t3 = tk.clone() if kn else f3[lay["take_new"][0]:
                                      lay["take_new"][0] + p.G * N]
        ffd.pack(p, c, N, f2, lay, t2, lk, kn, ex)
        ffd.pack_reference(p, c, N, f3, lay, t3, lk, kn, ex)
        torch.cuda.synchronize()
        parts = [diff(ffd._region(f2, lay, n), ffd._region(f3, lay, n))
                 for n in _k2_regions(lay)]
        out["ffd_pack"] = (all(e for e, _ in parts),
                           max(x for _, x in parts))
    return out


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _kernel_ms(fn, reps: int, kernel: str):
    """Mean device time of one launch of CUDA kernel `kernel` over `reps`
    calls of fn(), from the profiler's CUPTI trace: unlike events around
    the loop, it leaves out the host time between short launches.  None
    when the trace holds no device time for the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def compaction_ab(solver, inp, reps: int):
    """Warm solves of `inp` on one solver with the take_new compaction
    (the solver's own warm-start rule engages it) and dense (its fan-out
    estimate cleared just before the solve), in turns.  Returns
    ({arm: {"e2e": [...], "transfer": [...]}}, K, failures); "transfer"
    is dispatch + device + pull, the phases the compaction can move."""
    solver.solve(inp)
    arms = {"compact": {"e2e": [], "transfer": []},
            "dense": {"e2e": [], "transfer": []}}
    answers, bad, K = set(), [], 0
    for i in range(reps):
        for arm in (("compact", "dense") if i % 2 == 0
                    else ("dense", "compact")):
            if arm == "dense":
                solver._last_new_segments = None
            k = solver._pick_sparse_n(solver._adaptive_max_nodes())
            if (k > 0) != (arm == "compact"):
                bad.append(f"{arm} solve ran with K={k}")
            K = max(K, k)
            t0 = time.perf_counter()
            res = solver.solve(inp)
            arms[arm]["e2e"].append((time.perf_counter() - t0) * 1e3)
            ph = solver.last_phase_ms
            arms[arm]["transfer"].append(
                ph["dispatch"] + ph["device"] + ph["pull"])
            answers.add((res.node_count(), len(res.unschedulable),
                         res.total_price().hex()))
    if len(answers) != 1:
        bad.append(f"the arms disagree: {sorted(answers)}")
    return arms, K, bad


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def scan_ops(ffd, p, c, N, lay) -> float:
    """Float operations K1 needs on this run's data: 5 per resource for
    each fit (subtract, add, divide, floor, min) and 2 for each all-fits
    test (subtract, compare), counted by the plain scan on the same
    inputs over the (node, block) pairs the kernel visits."""
    import torch
    flat = torch.empty(lay["total"][1], device=c.col_alloc.device)
    lim = torch.empty((p.P, ffd.R), device=flat.device)
    work = {"fit": 0, "test": 0}
    ffd.light_scan_reference(p, c, N, flat, lay,
                             ffd._region(flat, lay, "take_new"), lim, work)
    return float((work["fit"] * 5 + work["test"] * 2) * ffd.R)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch.solver import TorchSolver, _cuda, ffd
    from karpenter_tpu_torch.workloads import build_input

    dev = torch.device("cuda", 0)
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.build()
    print(f"[2] built {', '.join(_cuda.KERNELS)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for k, log in _cuda.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {k}: {line.strip()}")

    # -- 3. kernels against their plain versions ---------------------------
    errs = {"ffd_light_scan": 0.0, "ffd_pack": 0.0}
    failed = []
    solver = TorchSolver()
    inp = build_input(HEADLINE_PODS)
    # the headline's encoded problem, exactly as the main path builds it
    cat = solver._catalog_encoding(inp)
    enc = solver._encode_checked(inp, cat)
    from karpenter_tpu_torch.solver.encode import D_BUCKETS, bucket
    from karpenter_tpu_torch.solver.solve import E_BUCKETS, G_BUCKETS
    Gh = bucket(enc.n_groups, G_BUCKETS)
    Eh = bucket(len(enc.existing), E_BUCKETS)
    Dh = bucket(enc.n_domains, D_BUCKETS)
    head_prob = solver._problem_args(enc, Gh, Eh, Dh, cat.device_args.O)
    dv = cat.device_args
    head_cat = dict(col_alloc=dv.col_alloc.cpu().numpy(),
                    col_daemon=dv.col_daemon.cpu().numpy(),
                    pt_alloc=dv.pt_alloc.cpu().numpy(),
                    col_pool=dv.col_pool.cpu().numpy(),
                    pool_daemon=dv.pool_daemon.cpu().numpy(), zc=dv.zc)
    cases = list(_seeded_cases()) + [
        ("headline", head_prob, head_cat, solver.max_nodes, 0, 1),
        ("headline-sparse", head_prob, head_cat, solver.max_nodes, 512, 1)]
    for label, prob, catarr, N, kn, ex in cases:
        res = compare_case(ffd, prob, catarr, N, kn, ex, dev)
        for k, (eq, err) in res.items():
            errs[k] = max(errs[k], err)
            if not eq:
                failed.append(f"{label}:{k}")
        print(f"[3] {label:16s} N={N:5d} K={kn:3d} explain={ex}: " +
              ", ".join(f"{k} {'equal' if eq else 'DIFFERS'} "
                        f"(max abs err {err:g})"
                        for k, (eq, err) in res.items()), flush=True)
    if failed:
        print(f"chip_smoke: kernels disagree with their plain versions: "
              f"{failed}", file=sys.stderr)
        return 1

    # -- 4. the main path -----------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    ffd.light_scan.launches = 0
    ffd.pack.launches = 0
    solver = TorchSolver()
    inp = build_input(HEADLINE_PODS)
    t0 = time.perf_counter()
    res = solver.solve(inp)
    cold_ms = (time.perf_counter() - t0) * 1e3
    cold_phases = dict(solver.last_phase_ms)
    phases = {k: [] for k in solver.last_phase_ms}
    e2e = []
    for _ in range(WARM_SOLVES):
        t0 = time.perf_counter()
        res = solver.solve(inp)
        e2e.append((time.perf_counter() - t0) * 1e3)
        for k, v in solver.last_phase_ms.items():
            phases.setdefault(k, []).append(v)
    launches = {"ffd_light_scan": ffd.light_scan.launches,
                "ffd_pack": ffd.pack.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    price = res.total_price()
    print(f"[4] headline {HEADLINE_PODS} pods: {res.node_count()} nodes, "
          f"{len(res.unschedulable)} unschedulable, price {price.hex()} "
          f"({price:.5f}) on {card}", flush=True)
    print("[4] cold solve phases ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in cold_phases.items()), flush=True)
    print(f"[4] cold solve {cold_ms:.1f} ms; warm p50 "
          f"{statistics.median(e2e):.1f} ms over {WARM_SOLVES} solves; "
          f"phase p50 ms: " + ", ".join(
              f"{k} {statistics.median(v):.3f}" for k, v in phases.items()),
          flush=True)
    print(f"[4] launches on the main path: {launches}; "
          f"max_memory_allocated {peak} bytes", flush=True)
    bad = []
    if res.node_count() != HEADLINE_NODES:
        bad.append(f"nodes {res.node_count()} != {HEADLINE_NODES}")
    if len(res.unschedulable) != HEADLINE_UNSCHED:
        bad.append(f"unschedulable {len(res.unschedulable)}")
    if price.hex() != HEADLINE_PRICE_HEX:
        bad.append(f"price {price.hex()} != {HEADLINE_PRICE_HEX}")
    if not all(np.isfinite(c.price) and c.pods for c in res.new_claims):
        bad.append("a claim without pods or with a non-finite price")
    for k, n in launches.items():
        if n <= 0:
            bad.append(f"kernel {k} was not launched on the main path")
    if bad:
        print(f"chip_smoke: main path failed: {bad}", file=sys.stderr)
        return 1

    # -- 5. the take_new compaction against the dense row ------------------
    arms, K, bad = compaction_ab(TorchSolver(), build_input(COMPACT_PODS),
                                 WARM_SOLVES)
    print(f"[5] take_new compaction at {COMPACT_PODS} pods (K={K}), "
          f"{WARM_SOLVES} warm solves each, in turns, on {card}: " +
          "; ".join(f"{a} e2e p50 {statistics.median(v['e2e']):.4f} ms, "
                    f"dispatch+device+pull p50 "
                    f"{statistics.median(v['transfer']):.4f} ms"
                    for a, v in arms.items()), flush=True)
    if bad:
        print(f"chip_smoke: compaction phase failed: {bad}", file=sys.stderr)
        return 1

    # -- 6. timings at the headline's shapes ---------------------------------
    p, c = ffd.problem_from_numpy(head_prob, head_cat, dev)
    N = solver.max_nodes
    lay = ffd.flat_layout(p.G, p.E, N, p.D, 0, 1)
    flat = torch.empty(lay["total"][1], device=dev)
    tn = ffd._region(flat, lay, "take_new")
    lim = torch.empty((p.P, ffd.R), device=dev)
    k1 = lambda: ffd.light_scan(p, c, N, flat, lay, tn, lim)  # noqa: E731
    k1p = lambda: ffd.light_scan_reference(  # noqa: E731
        p, c, N, flat, lay, tn, lim)
    k2 = lambda: ffd.pack(p, c, N, flat, lay, tn, lim, 0, 1)  # noqa: E731
    k2p = lambda: ffd.pack_reference(  # noqa: E731
        p, c, N, flat, lay, tn, lim, 0, 1)
    # plain, kernel, kernel, plain: compare within one call, in turns
    t_k1p = _time_ms(k1p, 3)
    t_k1 = _time_ms(k1, 50)
    t_k2 = _time_ms(k2, 200)
    t_k1 = min(t_k1, _time_ms(k1, 50))
    t_k2 = min(t_k2, _time_ms(k2, 200))
    t_k1p = min(t_k1p, _time_ms(k1p, 3))
    t_k2p = _time_ms(k2p, 20)
    # events around a loop of short launches also time the host between
    # them: the kernel's own time comes from the profiler when it has it
    d_k1 = _kernel_ms(k1, 50, "light_scan_kernel")
    d_k2 = _kernel_ms(k2, 200, "pack_kernel")
    print(f"[6] loop of launches, CUDA events: ffd_light_scan {t_k1:.4f} "
          f"ms, ffd_pack {t_k2:.4f} ms; profiler device time: "
          f"ffd_light_scan {d_k1} ms, ffd_pack {d_k2} ms", flush=True)
    t_k1 = d_k1 if d_k1 is not None else t_k1
    t_k2 = d_k2 if d_k2 is not None else t_k2
    # the dense take_new row is one of the flat regions in out1
    out1 = [ffd._region(flat, lay, n) for n in _k1_regions(lay)]
    k1_bytes = _nbytes(p.group_req, p.group_count, p.mask_bits,
                       p.exist_cap, p.exist_remaining, p.pool_limit,
                       p.group_ncap, p.group_whole, c.col_alloc,
                       c.col_daemon, c.pt_alloc, c.col_pool, c.pool_daemon,
                       c.pool_bits, lim, *out1)
    k1_ops = scan_ops(ffd, p, c, N, lay)
    # K2 reads the mask rows, one (pool,type) row and its daemon row per
    # block, the pool rows, unsched and num_active; writes the counts
    k2_bytes = (_nbytes(p.mask_bits, p.group_req, p.group_whole,
                        c.pt_alloc, c.pool_daemon, lim)
                + c.PT * ffd.R * 4 + c.PT * 4 + (p.G + 1) * 4
                + (p.G * ffd.EXPLAIN_C + p.G) * 4)
    k2_ops = p.G * c.PT * ffd.R * 3 * 2
    b1, by1 = bound_ms(k1_bytes, k1_ops)
    b2, by2 = bound_ms(k2_bytes, k2_ops)
    kernels = [
        {"name": "ffd_light_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_light_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:210",
         "launches": launches["ffd_light_scan"],
         "max_abs_err": errs["ffd_light_scan"], "ms": t_k1,
         "plain_ms": t_k1p, "bound_ms": b1, "bound_by": by1,
         "library_ms": None},
        {"name": "ffd_pack", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_pack.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:1089",
         "launches": launches["ffd_pack"],
         "max_abs_err": errs["ffd_pack"], "ms": t_k2, "plain_ms": t_k2p,
         "bound_ms": b2, "bound_by": by2, "library_ms": None},
    ]
    print(f"[6] at the headline shapes (G={p.G}, N={N}, PT={c.PT}, "
          f"O={c.O}) on {card}: " + "; ".join(
              f"{k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms,"
              f" bound {k['bound_ms']:.6f} ms by {k['bound_by']})"
              for k in kernels), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
