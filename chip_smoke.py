#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (karpenter_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from karpenter_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  3. each kernel against its plain PyTorch version on the card, on seeded
     problems (light and topology) and on the encoded problems of both
     main paths: flat result buffers must be equal as uint32;
  4. the headline path: TorchSolver().solve(build_input(50_000)) — one
     cold and 20 warm solves through K1 and K2 — must give the JAX
     package's answer, with those kernels' launch counts above zero;
  5. the config #3 path: TorchSolver().solve(build_config3()) — 10k pods
     with zone spread and hostname anti-affinity, one cold and 20 warm
     solves through K3 and K2 — the same;
  6. the host oracle's paths: two small inputs that strand pods for the
     rescue or hold a group the encoding cannot express (the split path's
     nested device solve), each one cold and 20 warm solves — the JAX
     package's answer, the oracle taken, the kernels launched;
  7. kernel timings at the main paths' shapes beside their bounds.
The line before the card line is the kernels' JSON record; the last line
is {"ok": true, "device": {...}}.
Without a CUDA device it exits 2 and prints no result.
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
# BASELINE config #3's answer from the JAX package (TPUSolver(max_nodes=
# 2048), default knobs, on the CPU): 15 nodes, none unschedulable
CONFIG3_NODES = 15
CONFIG3_UNSCHED = 0
CONFIG3_PRICE_HEX = "0x1.4266a55087011p+5"
# The host oracle's paths, with the JAX package's answers (TPUSolver with
# mesh/delta/spec/incr off, on the CPU) as (nodes, unschedulable, price,
# kernels of the device solve): the scenarios of the same names in
# tests/test_torch_topology.py
ORACLE_CASES = {
    # 5 pods with zone anti-affinity over 3 zones: K3 places 3, the rescue
    # cannot place the other 2
    "zone-anti-affinity-2-strands": (3, 2, "0x1.76d330941c822p-4",
                                     ("ffd_topo_scan", "ffd_pack")),
    # 50 plain pods and one pod spread over zone and capacity type (two
    # dynamic keys: inexpressible): the split path solves the 50 through
    # K1 and the one through the oracle
    "combined-mixed-residue-split": (1, 0, "0x1.8d0bb6ed67770p-2",
                                     ("ffd_light_scan", "ffd_pack")),
}
# the node axis of config #3's warm solves (the solver's warm-start bucket
# for 15 active nodes)
CONFIG3_WARM_N = 64

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
    """(label, problem tuple, catalog arrays, N, explain)."""
    from karpenter_tpu_torch.solver.problems import random_problem
    specs = [
        ("base", dict(), 64, 1),
        ("no-existing", dict(E=0), 64, 1),
        ("3-pools-finite", dict(P=3, limits="finite"), 64, 1),
        ("slot-exhaustion", dict(P=1, limits="none", pod_scale=300), 16,
         1),
        ("wide-fan-out", dict(pod_scale=400), 64, 1),
        ("N-256", dict(), 256, 1),
        ("explain-off", dict(), 64, 0),
        ("wide", dict(G=32, E=64, PT=640, ZC=6, P=2, pod_scale=200),
         1024, 1),
        ("whole-node", dict(whole=True, pod_scale=20), 64, 1),
        ("strided-nodes", dict(G=16, E=0, PT=128, pod_scale=3000), 2048,
         1),
        ("strided-existing", dict(E=2048, pod_scale=900), 256, 1),
        ("8-pools", dict(P=8, limits="mixed", PT=128), 256, 1),
        ("wide-G32", dict(G=32, E=16, PT=640, pod_scale=300), 1024, 1),
    ]
    # topology problems: zone and capacity-type domain classes (K3's heavy
    # step) mixed with light ones
    topo = dict(topology=True, D=4)
    specs += [
        ("topo-base", dict(topo), 64, 1),
        ("topo-d8", dict(topo, D=8, ZC=12), 64, 1),
        ("topo-3-pools-finite", dict(topo, P=3, limits="finite"), 64, 1),
        ("topo-slot-exhaustion", dict(topo, E=0, pod_scale=300), 16, 1),
        ("topo-no-existing", dict(topo, E=0), 64, 1),
        ("topo-wide", dict(topo, G=32, E=64, PT=640, P=2, pod_scale=200),
         1024, 1),
        ("topo-strided-nodes", dict(topo, G=16, E=0, PT=128,
                                    pod_scale=3000), 2048, 1),
        ("topo-strided-exist", dict(topo, E=2048, pod_scale=900), 256, 1),
        ("topo-8-pools", dict(topo, D=8, ZC=12, P=8, PT=128), 256, 1),
        ("topo-small-groups", dict(topo, pod_scale=20), 64, 1),
        ("topo-explain-off", dict(topo), 64, 0),
        ("topo-d128", dict(topo, D=128, ZC=12), 64, 1),
        ("topo-whole-mixed", dict(topo, pod_scale=20), 64, 1),
    ]
    for i, (label, kw, N, ex) in enumerate(specs):
        prob, cat = random_problem(100 + i, **kw)
        yield label, prob, cat, N, ex


def oracle_inputs():
    """{label: build function} of the ORACLE_CASES inputs, built from the
    port's classes on a 40-type catalog without GPUs."""
    from karpenter_tpu_torch import models as M
    from karpenter_tpu_torch.providers import generate_catalog
    from karpenter_tpu_torch.providers.catalog import CatalogSpec
    from karpenter_tpu_torch.scheduling import ScheduleInput
    wk = M.wellknown
    catalog = generate_catalog(CatalogSpec(max_types=40, include_gpu=False))
    web = {"app": "web"}

    def pod(name, labels=web, **kw):
        return M.Pod(meta=M.ObjectMeta(name=name, labels=dict(labels)),
                     requests=M.Resources.parse({"cpu": "500m",
                                                 "memory": "1Gi"}), **kw)

    def spread(key):
        return M.TopologySpreadConstraint(topology_key=key, max_skew=1,
                                          label_selector=web)

    def schedule(pods):
        pool = M.NodePool(meta=M.ObjectMeta(name="default"))
        return ScheduleInput(pods=pods, nodepools=[pool],
                             instance_types={"default": catalog})

    def zone_anti():
        return schedule([pod(f"p{i}", pod_affinities=[M.PodAffinityTerm(
            label_selector=web, topology_key=wk.ZONE_LABEL, anti=True,
            required=True)]) for i in range(5)])

    def mixed_residue():
        return schedule(
            [pod(f"plain{i}", labels={"app": "other"}) for i in range(50)]
            + [pod("p", topology_spread=[spread(wk.ZONE_LABEL),
                                         spread(wk.CAPACITY_TYPE_LABEL)])])

    return {"zone-anti-affinity-2-strands": zone_anti,
            "combined-mixed-residue-split": mixed_residue}


def _k1_regions(lay):
    return [n for n in ("take_exist", "take_new", "unsched", "dom_placed",
                        "used", "node_pool", "node_zone", "node_ct",
                        "num_active") if n in lay]


def compare_case(ffd, prob, cat, N, ex, dev):
    """Run the scan — K1, or K3 for a problem with a domain class — and
    K2, and their plain versions, on the card on the same inputs.  K2 and
    its plain version both start from the kernel scan's output, so each
    comparison isolates one kernel.  Returns {kernel: (equal,
    max_abs_err)}."""
    import torch
    p, c = ffd.problem_from_numpy(prob, cat, dev)
    lay = ffd.flat_layout(p.G, p.E, N, p.D, ex)
    total = lay["total"][1]

    def buffers():
        flat = torch.full((total,), float("nan"), device=dev)
        lim = torch.full((p.P, ffd.R), float("nan"), device=dev)
        return flat, lim

    if p.topology:
        name, scan, plain = ("ffd_topo_scan", ffd.topo_scan,
                             ffd.topo_scan_reference)
    else:
        name, scan, plain = ("ffd_light_scan", ffd.light_scan,
                             ffd.light_scan_reference)
    fk, lk = buffers()
    scan(p, c, N, fk, lay, lk)
    fp, lp = buffers()
    plain(p, c, N, fp, lay, lp)
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
    parts += [diff(lk, lp)]
    out = {name: (all(e for e, _ in parts), max(x for _, x in parts))}
    if ex:
        f2, f3 = fk.clone(), fk.clone()
        ffd.pack(p, c, N, f2, lay, lk)
        ffd.pack_reference(p, c, N, f3, lay, lk)
        torch.cuda.synchronize()
        parts = [diff(ffd._region(f2, lay, n), ffd._region(f3, lay, n))
                 for n in ("explain_counts", "explain_bits")]
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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def scan_ops(ffd, p, c, N, lay, plain) -> float:
    """Float operations K1 or K3 needs on this run's data: 5 per resource
    for each fit (subtract, add, divide, floor, min), 2 for each all-fits
    test (subtract, compare), and the water-fill's scalar operations,
    counted by the plain scan `plain` on the same inputs over the (node,
    block) pairs the kernel visits."""
    import torch
    flat = torch.empty(lay["total"][1], device=c.col_alloc.device)
    lim = torch.empty((p.P, ffd.R), device=flat.device)
    work = {"fit": 0, "test": 0, "flops": 0}
    plain(p, c, N, flat, lay, lim, work)
    return float((work["fit"] * 5 + work["test"] * 2) * ffd.R
                 + work["flops"])


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def _encoded_problem(solver, inp, ffd):
    """`inp`'s padded problem tuple and catalog arrays, exactly as the main
    path builds them."""
    from karpenter_tpu_torch.solver.encode import D_BUCKETS, bucket
    from karpenter_tpu_torch.solver.solve import E_BUCKETS, G_BUCKETS
    cat = solver._catalog_encoding(inp)
    enc = solver._encode_checked(inp, cat)
    G = bucket(enc.n_groups, G_BUCKETS)
    E = bucket(len(enc.existing), E_BUCKETS)
    D = bucket(enc.n_domains, D_BUCKETS)
    dv = cat.device_args
    prob = solver._problem_args(enc, G, E, D, dv.O)
    arrays = {k: getattr(dv, k).cpu().numpy()
              for k in ("col_alloc", "col_daemon", "pt_alloc", "col_pool",
                        "pool_daemon", "col_zone", "col_ct")}
    arrays["zc"] = dv.zc
    return prob, arrays


def _main_path(solver_cls, build, ffd, card, label):
    """One cold and WARM_SOLVES warm solves of build() on a fresh solver,
    every kernel count set to 0 just before and read just after.  Returns
    (result, launches, solver)."""
    import torch
    for k in (ffd.light_scan, ffd.topo_scan, ffd.pack):
        k.launches = 0
    solver = solver_cls()
    inp = build()
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
    torch.cuda.synchronize()
    launches = {"ffd_light_scan": ffd.light_scan.launches,
                "ffd_topo_scan": ffd.topo_scan.launches,
                "ffd_pack": ffd.pack.launches}
    price = res.total_price()
    print(f"[{label}] {res.node_count()} nodes, {len(res.unschedulable)} "
          f"unschedulable, price {price.hex()} ({price:.5f}) on {card}",
          flush=True)
    print(f"[{label}] cold solve {cold_ms:.1f} ms, phases ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in cold_phases.items()), flush=True)
    print(f"[{label}] warm p50 {statistics.median(e2e):.3f} ms over "
          f"{WARM_SOLVES} solves; phase p50 ms: " + ", ".join(
              f"{k} {statistics.median(v):.3f}" for k, v in phases.items()),
          flush=True)
    print(f"[{label}] launches: {launches}", flush=True)
    return res, launches, solver


def _check_answer(res, launches, nodes, unsched, price_hex, kernels):
    bad = []
    if res.node_count() != nodes:
        bad.append(f"nodes {res.node_count()} != {nodes}")
    if len(res.unschedulable) != unsched:
        bad.append(f"unschedulable {len(res.unschedulable)} != {unsched}")
    if res.total_price().hex() != price_hex:
        bad.append(f"price {res.total_price().hex()} != {price_hex}")
    if not all(np.isfinite(c.price) and c.pods for c in res.new_claims):
        bad.append("a claim without pods or with a non-finite price")
    for k in kernels:
        if launches[k] <= 0:
            bad.append(f"kernel {k} was not launched on the main path")
    return bad


def _only_groups(prob, keep):
    """The padded problem tuple with the rows of the groups outside `keep`
    zeroed (no pods, no admitted column, no domain constraint); the
    per-existing-node and per-pool slots stay."""
    out = []
    for i, a in enumerate(prob):
        a = np.asarray(a)
        if i in (4, 5, 15, 16):
            out.append(a)
            continue
        b = a.copy()
        b[~keep] = 0
        out.append(b)
    return tuple(out)


def _kernel_times(ffd, p, c, N, scan, plain, kname, reps):
    """(kernel ms, plain ms, events ms, K2 ms, K2 plain ms) at one
    problem's shapes: plain, kernel, kernel, plain, in turns."""
    import torch
    dev = p.group_req.device
    lay = ffd.flat_layout(p.G, p.E, N, p.D, 1)
    flat = torch.empty(lay["total"][1], device=dev)
    lim = torch.empty((p.P, ffd.R), device=dev)
    k = lambda: scan(p, c, N, flat, lay, lim)  # noqa: E731
    kp = lambda: plain(p, c, N, flat, lay, lim)  # noqa: E731
    k2 = lambda: ffd.pack(p, c, N, flat, lay, lim)  # noqa: E731
    k2p = lambda: ffd.pack_reference(p, c, N, flat, lay, lim)  # noqa: E731
    t_kp = _time_ms(kp, 3)
    t_k = _time_ms(k, reps)
    t_k2 = _time_ms(k2, 200)
    t_k = min(t_k, _time_ms(k, reps))
    t_k2 = min(t_k2, _time_ms(k2, 200))
    t_kp = min(t_kp, _time_ms(kp, 3))
    t_k2p = _time_ms(k2p, 20)
    # events around a loop of short launches also time the host between
    # them: the kernel's own time comes from the profiler when it has it
    d_k = _kernel_ms(k, reps, kname)
    d_k2 = _kernel_ms(k2, 200, "pack_kernel")
    return (d_k if d_k is not None else t_k, t_kp, t_k,
            d_k2 if d_k2 is not None else t_k2, t_k2p, lay, flat, lim)


def _scan_bound(ffd, p, c, N, lay, flat, lim, plain):
    """K1/K3 bound: inputs read once, outputs written once, over the HBM
    rate, against the float operations this run's data needs over the
    fp32 rate."""
    out = [ffd._region(flat, lay, n) for n in _k1_regions(lay)]
    nbytes = _nbytes(p.group_req, p.group_count, p.mask_bits, p.exist_cap,
                     p.exist_remaining, p.pool_limit, p.group_ncap,
                     p.group_whole, p.group_dsel, p.group_dbase,
                     p.group_dcap, p.group_skew, p.group_mindom,
                     p.group_delig, p.exist_zone, p.exist_ct, c.col_alloc,
                     c.col_daemon, c.pt_alloc, c.col_pool, c.pool_daemon,
                     c.pool_bits, c.col_zone, c.col_ct, lim, *out)
    return bound_ms(nbytes, scan_ops(ffd, p, c, N, lay, plain))


def _pack_bound(ffd, p, c, lim):
    """K2 reads the mask rows, one (pool,type) row and its daemon row per
    block, the pool rows, unsched, num_active and the topology rows;
    writes the counts."""
    nbytes = (_nbytes(p.mask_bits, p.group_req, p.group_whole, c.pt_alloc,
                      c.pool_daemon, lim, p.group_dsel, p.group_dbase,
                      p.group_skew, p.group_mindom, p.group_delig)
              + c.PT * ffd.R * 4 + c.PT * 4 + (p.G + 1) * 4
              + p.G * p.D * 4 + 2 * c.zc * 4
              + (p.G * ffd.EXPLAIN_C + p.G) * 4)
    return bound_ms(nbytes, p.G * c.PT * ffd.R * 3 * 2)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch.solver import TorchSolver, _cuda, ffd
    from karpenter_tpu_torch.workloads import build_config3, build_input

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
    errs = {k: 0.0 for k in _cuda.KERNELS}
    failed = []
    solver = TorchSolver()
    head_prob, head_cat = _encoded_problem(solver, build_input(HEADLINE_PODS),
                                           ffd)
    c3_prob, c3_cat = _encoded_problem(solver, build_config3(), ffd)
    cases = list(_seeded_cases()) + [
        ("headline", head_prob, head_cat, solver.max_nodes, 1),
        ("headline-explain-off", head_prob, head_cat, solver.max_nodes, 0),
        ("config3-cold", c3_prob, c3_cat, solver.max_nodes, 1),
        ("config3-warm", c3_prob, c3_cat, CONFIG3_WARM_N, 1)]
    for label, prob, catarr, N, ex in cases:
        res = compare_case(ffd, prob, catarr, N, ex, dev)
        for k, (eq, err) in res.items():
            errs[k] = max(errs[k], err)
            if not eq:
                failed.append(f"{label}:{k}")
        print(f"[3] {label:20s} N={N:5d} explain={ex}: " +
              ", ".join(f"{k} {'equal' if eq else 'DIFFERS'} "
                        f"(max abs err {err:g})"
                        for k, (eq, err) in res.items()), flush=True)
    if failed:
        print(f"chip_smoke: kernels disagree with their plain versions: "
              f"{failed}", file=sys.stderr)
        return 1

    # -- 4. the main path: the 50k headline ----------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    res, head_launches, _ = _main_path(
        TorchSolver, lambda: build_input(HEADLINE_PODS), ffd, card,
        "4 headline")
    print(f"[4 headline] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    bad = _check_answer(res, head_launches, HEADLINE_NODES,
                        HEADLINE_UNSCHED, HEADLINE_PRICE_HEX,
                        ("ffd_light_scan", "ffd_pack"))
    if bad:
        print(f"chip_smoke: headline path failed: {bad}", file=sys.stderr)
        return 1

    # -- 5. the main path: config #3 (topology spread) -----------------------
    res, c3_launches, _ = _main_path(TorchSolver, build_config3, ffd,
                                     card, "5 config3")
    bad = _check_answer(res, c3_launches, CONFIG3_NODES, CONFIG3_UNSCHED,
                        CONFIG3_PRICE_HEX, ("ffd_topo_scan", "ffd_pack"))
    if bad:
        print(f"chip_smoke: config #3 path failed: {bad}", file=sys.stderr)
        return 1

    # -- 6. the host oracle's paths: rescue and split ------------------------
    for label, build in oracle_inputs().items():
        nodes, unsched, price_hex, kernels = ORACLE_CASES[label]
        res, launches, s = _main_path(TorchSolver, build, ffd, card,
                                      f"6 {label}")
        bad = _check_answer(res, launches, nodes, unsched, price_hex,
                            kernels)
        if not s._used_split:
            bad.append("the oracle was not taken")
        if bad:
            print(f"chip_smoke: oracle path {label} failed: {bad}",
                  file=sys.stderr)
            return 1

    # -- 7. timings at the main paths' shapes --------------------------------
    p, c = ffd.problem_from_numpy(head_prob, head_cat, dev)
    N = solver.max_nodes
    t_k1, t_k1p, ev_k1, t_k2, t_k2p, lay, flat, lim = _kernel_times(
        ffd, p, c, N, ffd.light_scan, ffd.light_scan_reference,
        "scan_kernel<false>", 50)
    b1, by1 = _scan_bound(ffd, p, c, N, lay, flat, lim,
                          ffd.light_scan_reference)
    b2, by2 = _pack_bound(ffd, p, c, lim)
    print(f"[7] headline shapes (G={p.G}, N={N}, PT={c.PT}, O={c.O}) on "
          f"{card}: ffd_light_scan {t_k1:.4f} ms (events {ev_k1:.4f}, "
          f"plain {t_k1p:.3f}, bound {b1:.6f} by {by1}); ffd_pack "
          f"{t_k2:.4f} ms (plain {t_k2p:.3f}, bound {b2:.6f} by {by2})",
          flush=True)
    # K3 on the headline, where every step is light: K1 and K3 in turns
    scans = {"ffd_light_scan": (ffd.light_scan, "scan_kernel<false>"),
             "ffd_topo_scan": (ffd.topo_scan, "scan_kernel<true>")}
    ab = {k: [] for k in scans}
    for kname in ("ffd_light_scan", "ffd_topo_scan") * 2 + (
            "ffd_topo_scan", "ffd_light_scan"):
        scan, tag = scans[kname]
        run = lambda: scan(p, c, N, flat, lay, lim)  # noqa: E731
        t = _kernel_ms(run, 50, tag)
        ab[kname].append(t if t is not None else _time_ms(run, 50))
    print(f"[7] headline shapes, K1 and K3 in turns on {card}: " + "; ".join(
        f"{k} " + ", ".join(f"{v:.4f}" for v in vs) + " ms"
        for k, vs in sorted(ab.items())), flush=True)
    p3, c3 = ffd.problem_from_numpy(c3_prob, c3_cat, dev)
    k3 = {}
    for N3 in (solver.max_nodes, CONFIG3_WARM_N):
        t_k3, t_k3p, ev_k3, t_k2c, t_k2cp, lay3, flat3, lim3 = \
            _kernel_times(ffd, p3, c3, N3, ffd.topo_scan,
                          ffd.topo_scan_reference, "scan_kernel<true>", 20)
        b3, by3 = _scan_bound(ffd, p3, c3, N3, lay3, flat3, lim3,
                              ffd.topo_scan_reference)
        k3[N3] = (t_k3, t_k3p, b3, by3)
        print(f"[7] config #3 shapes (G={p3.G}, N={N3}, PT={c3.PT}, "
              f"D={p3.D}) on {card}: ffd_topo_scan {t_k3:.4f} ms (events "
              f"{ev_k3:.4f}, plain {t_k3p:.3f}, bound {b3:.6f} by {by3}); "
              f"ffd_pack {t_k2c:.4f} ms (plain {t_k2cp:.3f})", flush=True)
    t_k3, t_k3p, b3, by3 = k3[CONFIG3_WARM_N]
    # where K3's time goes: the same problem with only its light groups,
    # or only its heavy groups, kept (the others' rows zeroed: a step with
    # no pods and no admitted column does next to nothing)
    dsel = np.asarray(c3_prob[7])
    split = {}
    for kind, keep in (("light", dsel == 0), ("heavy", dsel > 0)):
        pk, ck = ffd.problem_from_numpy(_only_groups(c3_prob, keep), c3_cat,
                                        dev)
        lay_k = ffd.flat_layout(pk.G, pk.E, CONFIG3_WARM_N, pk.D)
        flat_k = torch.empty(lay_k["total"][1], device=dev)
        lim_k = torch.empty((pk.P, ffd.R), device=dev)
        for kname, scan in (("ffd_topo_scan", ffd.topo_scan),
                            ("ffd_light_scan", ffd.light_scan)):
            if kname == "ffd_light_scan" and pk.topology:
                continue
            split[f"{kname} {kind} groups only ({int(keep.sum())})"] = \
                _kernel_ms(lambda: scan(pk, ck, CONFIG3_WARM_N, flat_k,
                                        lay_k, lim_k), 10,
                           "scan_kernel<true>" if scan is ffd.topo_scan
                           else "scan_kernel<false>")
    print(f"[7] config #3 (N={CONFIG3_WARM_N}) by step kind on {card}: " +
          "; ".join(f"{k} {v:.4f} ms" for k, v in split.items()),
          flush=True)
    kernels = [
        {"name": "ffd_light_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_light_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:460",
         "launches": head_launches["ffd_light_scan"],
         "max_abs_err": errs["ffd_light_scan"], "ms": t_k1,
         "plain_ms": t_k1p, "bound_ms": b1, "bound_by": by1,
         "library_ms": None},
        {"name": "ffd_topo_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_topo_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:589",
         "launches": c3_launches["ffd_topo_scan"],
         "max_abs_err": errs["ffd_topo_scan"], "ms": t_k3,
         "plain_ms": t_k3p, "bound_ms": b3, "bound_by": by3,
         "library_ms": None},
        {"name": "ffd_pack", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_pack.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:1113",
         "launches": head_launches["ffd_pack"] + c3_launches["ffd_pack"],
         "max_abs_err": errs["ffd_pack"], "ms": t_k2, "plain_ms": t_k2p,
         "bound_ms": b2, "bound_by": by2, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
