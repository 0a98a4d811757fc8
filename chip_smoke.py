#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (karpenter_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from karpenter_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  3. each kernel against its plain PyTorch version on the card: K5 and K2
     on seeded problems (light and topology) and on the encoded problems
     of the headline and config #3, K5 on seeded batches, K4's two lanes
     on seeded sweeps (exclusions, price caps, pool limits, strands, new
     nodes under N=8, the take_exist compaction on and off, up to 128
     domains) and on the first light chunk of config #4 and the first
     heavy chunk of config #4b: flat result buffers must be equal as
     uint32;
  4. the headline path: TorchSolver().solve(build_input(50_000)) — one
     cold and 20 warm solves through K5 and K2 — must give the JAX
     package's answer, with those kernels' launch counts above zero;
  5. the config #3 path: TorchSolver().solve(build_config3()) — 10k pods
     with zone spread and hostname anti-affinity, one cold and 20 warm
     solves through K5 (its heavy step) and K2 — the same;
  6. the host oracle's paths: two small inputs that strand pods for the
     rescue or hold a group the encoding cannot express (the split path's
     nested device solve), each one cold and 20 warm solves — the JAX
     package's answer, the oracle taken, the kernels launched;
  7. the consolidation sweep: TorchSolver().solve_batch(build_config4(),
     max_nodes=8) and the same for build_config4b() — 2,000 simulations
     against 2,000 nodes, one cold and 5 warm sweeps each through K4 (the
     light lane; both lanes for #4b) — every simulation the JAX package's
     answer (a digest of the canonical results);
  8. kernel timings at the main paths' shapes beside their bounds, and the
     sweep's dense against compacted take_exist rows.
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
    # 5 pods with zone anti-affinity over 3 zones: the scan's heavy step
    # places 3, the rescue cannot place the other 2
    "zone-anti-affinity-2-strands": (3, 2, "0x1.76d330941c822p-4",
                                     ("ffd_batch_scan", "ffd_pack")),
    # 50 plain pods and one pod spread over zone and capacity type (two
    # dynamic keys: inexpressible): the split path solves the 50 through
    # the scan and the one through the oracle
    "combined-mixed-residue-split": (1, 0, "0x1.8d0bb6ed67770p-2",
                                     ("ffd_batch_scan", "ffd_pack")),
}
# the node axis of config #3's warm solves (the solver's warm-start bucket
# for 15 active nodes)
CONFIG3_WARM_N = 64
# BASELINE config #4 and #4b (benchmarks/config4_consolidation.py,
# config4b_consolidation_spread.py): the JAX package's answer
# (TPUSolver(max_nodes=2048).solve_batch(make_input(), max_nodes=8),
# default knobs, on the CPU) — 2,000 results, every one a feasible delete
# (no unschedulable pod, no new claim) — as the sha256 `sweep_digest` of
# its canonical results, simulation by simulation
SWEEP_SIMS = 2000
SWEEP_MAX_NODES = 8
SWEEP_WARM = 5
CONFIG4_DIGEST = ("d5e84c8d96f332506e8ba8511464d10a"
                  "9832d1eb0ee692aa3c4906579c982d06")
CONFIG4B_DIGEST = ("e3ee51b1e72d8f97e3f8c142620d2e23"
                   "d6b394be1d402c8a0ca21b0c3dfae5ab")

# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes/s and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the kernel wrappers of karpenter_tpu_torch.solver.ffd and their kernels
KERNELS = {"batch_scan": "ffd_batch_scan", "sweep_scan": "ffd_sweep_scan",
           "sweep_topo_scan": "ffd_sweep_topo_scan", "pack": "ffd_pack"}


def _pins(claim, key):
    """The sorted values a claim's requirement on `key` allows (None when
    the claim does not constrain the key)."""
    for r in claim.requirements:
        if r.key == key:
            return (tuple(sorted(r.values())) if r.is_finite()
                    else ("not-in",) + tuple(sorted(r.values())))
    return None


def sweep_canon(res):
    """One result in canonical form (tests/test_torch_solve.py `canon`):
    the claims (pool, pods, ranked instance types, price as a float hex,
    zone and capacity-type pins), the existing-node assignments, the
    unschedulable pods with their reason codes, and the total price as a
    float hex."""
    zone, ct = "topology.kubernetes.io/zone", "karpenter.sh/capacity-type"
    return (sorted((c.nodepool, tuple(sorted(p.meta.name for p in c.pods)),
                    tuple(c.instance_type_names), float(c.price).hex(),
                    _pins(c, zone), _pins(c, ct))
                   for c in res.new_claims),
            sorted(res.existing_assignments.items()),
            sorted((k, getattr(v, "code", None))
                   for k, v in res.unschedulable.items()),
            float(res.total_price()).hex())


def sweep_digest(results) -> str:
    """sha256 of the simulations' canonical forms, one line each, in
    order."""
    import hashlib
    text = "\n".join(repr(sweep_canon(r)) for r in results)
    return hashlib.sha256(text.encode()).hexdigest()


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
    # topology problems: zone and capacity-type domain classes (the heavy
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


def _batch_cases():
    """(label, problems, catalog arrays, N, explain, sparse_k): seeded
    batches of stacked problems for K5."""
    from karpenter_tpu_torch.solver.problems import random_batch
    topo = dict(topology=True, D=4)
    specs = [
        ("batch-light", 1, dict(), 5, 64, 1, 0),
        ("batch-light-sparse", 2, dict(pod_scale=6), 5, 64, 0, 8),
        ("batch-topo", 3, dict(topo), 5, 64, 1, 0),
        ("batch-topo-sparse-d8", 4, dict(topo, D=8, ZC=12, pod_scale=8), 5,
         32, 1, 8),
        ("batch-E2048-N8", 5, dict(E=2048, pod_scale=300), 5, 8, 0, 0),
        ("batch-E2048-N8-sparse", 6, dict(E=2048, pod_scale=6), 5, 8, 0, 8),
        ("batch-64", 7, dict(topo), 64, 64, 0, 0),
    ]
    for label, seed, kw, B, N, ex, K in specs:
        probs, cat = random_batch(seed, B, **kw)
        yield label, probs, cat, N, ex, K


def _sweep_cases():
    """(label, rows, shared, catalog arrays, N, sparse_k): seeded sweeps
    for K4's two lanes.  Every sweep caps about half its simulations'
    price below a real column's; each simulation excludes 1..X rows."""
    from karpenter_tpu_torch.solver.problems import random_sweep
    specs = [
        ("sweep-light", 1, False, dict(X=1), 8, 0),
        ("sweep-light-sparse", 2, False, dict(pod_scale=8), 8, 8),
        ("sweep-light-two-out", 3, False, dict(X=2, pod_scale=6), 8, 8),
        ("sweep-light-finite-strand", 5, False,
         dict(limits="finite", pod_scale=400), 8, 0),
        ("sweep-light-slot-exhaustion", 9, False,
         dict(limits="none", pod_scale=600, E=16), 2, 0),
        ("sweep-light-E2048", 7, False, dict(E=2048, X=2), 8, 8),
        ("sweep-light-E2048-dense", 7, False, dict(E=2048, X=2), 8, 0),
        ("sweep-light-64", 10, False, dict(E=2048, X=8, pod_scale=30, G=4,
                                           C=6), 8, 32),
        ("sweep-heavy", 3, True, dict(), 8, 0),
        ("sweep-heavy-sparse-d8", 4, True, dict(D=8, ZC=12, pod_scale=8),
         16, 8),
        ("sweep-heavy-many-classes", 6, True, dict(G=4, C=6), 8, 32),
        ("sweep-heavy-finite", 8, True, dict(limits="finite"), 8, 0),
        ("sweep-heavy-d128-E2048", 8, True, dict(E=2048, D=128, ZC=12), 8,
         8),
    ]
    for label, seed, heavy, kw, N, K in specs:
        B = 64 if label.endswith("-64") else 6
        rows, shared, cat = random_sweep(seed, B, heavy=heavy, **kw)
        yield label, rows, shared, cat, N, K


def _diff(a, b):
    """(equal as uint32, max abs difference of the differing entries)."""
    a = a.detach().cpu().numpy().reshape(-1)
    b = b.detach().cpu().numpy().reshape(-1)
    if a.shape != b.shape:
        return False, float("inf")
    differ = a.view(np.uint32) != b.view(np.uint32)
    if not differ.any():
        return True, 0.0
    d = np.abs(a[differ].astype(np.float64) - b[differ].astype(np.float64))
    return False, float(np.max(np.where(np.isfinite(d), d, np.inf)))


def _merge(parts):
    return all(e for e, _ in parts), max(x for _, x in parts)


def _scan_regions(lay):
    """The regions of a flat row the scan kernels write (K2 writes the
    explain counts)."""
    return [n for n in lay
            if n not in ("total", "explain_counts", "explain_bits")]


def _buffers(B, P, lay, dev):
    import torch
    from karpenter_tpu_torch.solver import ffd
    return (torch.full((B, lay["total"][1]), float("nan"), device=dev),
            torch.full((B, P, ffd.R), float("nan"), device=dev))


def _compare_rows(name, fk, lk, fp, lp, lay):
    """{check: (equal, max_abs_err)} of a scan's rows against its plain
    version's: the scan's regions and final pool budgets, and the
    take_exist compaction's (count, index) head on its own."""
    from karpenter_tpu_torch.solver import ffd
    out = {name: _merge([_diff(ffd._region(fk, lay, n),
                               ffd._region(fp, lay, n))
                         for n in _scan_regions(lay)] + [_diff(lk, lp)])}
    if "te_cnt" in lay:
        out["te_compaction"] = _merge([
            _diff(ffd._region(fk, lay, n), ffd._region(fp, lay, n))
            for n in ("te_cnt", "te_idx")])
    return out


def compare_batch(ffd, b, c, N, ex, K, dev):
    """Run K5 — and K2 for each problem with explain — and their plain
    versions on the card on the same inputs.  K2 and its plain version
    both start from the kernel scan's output, so each comparison isolates
    one kernel.  Returns {kernel: (equal, max_abs_err)}."""
    import torch
    lay = ffd.flat_layout(b.G, b.E, N, b.D, ex, K)
    fk, lk = _buffers(b.B, b.P, lay, dev)
    fp, lp = _buffers(b.B, b.P, lay, dev)
    ffd.batch_scan(b, c, N, fk, lay, lk, K)
    ffd.batch_scan_reference(b, c, N, fp, lay, lp, K)
    torch.cuda.synchronize()
    out = _compare_rows("ffd_batch_scan", fk, lk, fp, lp, lay)
    if ex:
        f2, f3 = fk.clone(), fk.clone()
        for i in range(b.B):
            ffd.pack(b.at(i), c, N, f2[i], lay, lk[i])
            ffd.pack_reference(b.at(i), c, N, f3[i], lay, lk[i])
        torch.cuda.synchronize()
        out["ffd_pack"] = _merge([
            _diff(ffd._region(f2, lay, n), ffd._region(f3, lay, n))
            for n in ("explain_counts", "explain_bits")])
    return out


def compare_case(ffd, prob, cat, N, ex, dev):
    """One problem tuple through K5 at B=1 (and K2)."""
    p, c = ffd.problem_from_numpy(prob, cat, dev)
    return compare_batch(ffd, ffd.FFDBatch.of(p), c, N, ex, 0, dev)


def compare_sweep(ffd, sw, c, N, K, dev):
    """Run K4's lane for `sw` and its plain version on the card on the
    same inputs.  Returns {kernel: (equal, max_abs_err)}."""
    import torch
    lay = ffd.flat_layout(sw.G, sw.E, N, sw.D, 0, K)
    fk, lk = _buffers(sw.B, sw.P, lay, dev)
    fp, lp = _buffers(sw.B, sw.P, lay, dev)
    if sw.heavy:
        name, scan, plain = ("ffd_sweep_topo_scan", ffd.sweep_topo_scan,
                             ffd.sweep_topo_scan_reference)
    else:
        name, scan, plain = ("ffd_sweep_scan", ffd.sweep_scan,
                             ffd.sweep_scan_reference)
    scan(sw, c, N, fk, lay, lk, K)
    plain(sw, c, N, fp, lay, lp, K)
    torch.cuda.synchronize()
    return _compare_rows(name, fk, lk, fp, lp, lay)


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
    """Mean device time of one launch of CUDA kernel `kernel` (its name as
    the trace spells it, spaces ignored) over `reps` calls of fn(), from
    the profiler's CUPTI trace: unlike events around the loop, it leaves
    out the host time between short launches.  None when the trace holds
    no device time for the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    want = kernel.replace(" ", "")
    for ev in prof.key_averages():
        if want in ev.key.replace(" ", ""):
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def _device_ms(fn, reps, kernel):
    """The profiler's time of `kernel`, or the events' when the trace
    holds none; and the events' time."""
    ev = _time_ms(fn, reps)
    d = _kernel_ms(fn, reps, kernel)
    return (d if d is not None else ev), ev


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def _work_ops(work) -> float:
    """Float operations of a plain scan's work count: 5 per resource for
    each fit (subtract, add, divide, floor, min), 2 for each all-fits test
    (subtract, compare), and the water-fill's scalar operations."""
    from karpenter_tpu_torch.solver import ffd
    return float((work["fit"] * 5 + work["test"] * 2) * ffd.R
                 + work["flops"])


def _catalog_bytes(c):
    return _nbytes(c.col_alloc, c.col_daemon, c.pt_alloc, c.col_pool,
                   c.pool_daemon, c.pool_bits, c.col_zone, c.col_ct)


def _batch_bound(ffd, b, c, N, lay, flat, lim):
    """K5's bound: inputs read once, outputs written once, over the HBM
    rate, against the float operations this run's data needs (counted by
    the plain version over the (node, block) pairs the kernel visits)
    over the fp32 rate."""
    import torch
    out = [ffd._region(flat, lay, n) for n in _scan_regions(lay)]
    nbytes = (_nbytes(*(getattr(b, f) for f in (
        "group_req", "group_count", "mask_bits", "exist_cap",
        "exist_remaining", "pool_limit", "group_ncap", "group_whole",
        "group_dsel", "group_dbase", "group_dcap", "group_skew",
        "group_mindom", "group_delig", "exist_zone", "exist_ct")))
        + _catalog_bytes(c) + _nbytes(lim, *out))
    work = {"fit": 0, "test": 0, "flops": 0}
    ffd.batch_scan_reference(b, c, N, torch.empty_like(flat), lay,
                             torch.empty_like(lim), 0, work)
    return bound_ms(nbytes, _work_ops(work))


def _sweep_bound(ffd, sw, c, N, K, lay, flat, lim):
    """K4's bound, counted as K5's: the simulations' rows, the shared
    snapshot and the catalog read once, the result rows written once."""
    import torch
    sh = sw.shared
    rows = [getattr(sw, f) for f in ffd.SWEEP_ROWS]
    if sw.heavy:
        rows += [getattr(sw, f) for f in ffd.SWEEP_TOPO_ROWS]
    nbytes = (_nbytes(*rows, sh.class_bits, sh.class_cap,
                      sh.exist_remaining, sh.exist_zone, sh.exist_ct,
                      sh.col_price)
              + _catalog_bytes(c) + _nbytes(lim, flat))
    work = {"fit": 0, "test": 0, "flops": 0}
    plain = (ffd.sweep_topo_scan_reference if sw.heavy
             else ffd.sweep_scan_reference)
    plain(sw, c, N, torch.empty_like(flat), lay, torch.empty_like(lim), K,
          work)
    return bound_ms(nbytes, _work_ops(work))


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


def _first_chunks(ffd, solver, inps):
    """{heavy: (SweepBatch, catalog, N, sparse_k)}: the first chunk of
    each lane that solve_batch launches on `inps`, as it launches it."""
    seen = {}
    real = ffd.solve_ffd_sweep

    def capture(sw, cat, n, k=0):
        seen.setdefault(sw.heavy, (sw, cat, n, k))
        return real(sw, cat, n, k)

    ffd.solve_ffd_sweep = capture
    try:
        solver.solve_batch(inps, max_nodes=SWEEP_MAX_NODES)
    finally:
        ffd.solve_ffd_sweep = real
    return seen


def _reset_launches(ffd):
    for w in KERNELS:
        getattr(ffd, w).launches = 0


def _read_launches(ffd):
    return {k: getattr(ffd, w).launches for w, k in KERNELS.items()}


def _main_path(solver_cls, build, ffd, card, label, warm=WARM_SOLVES,
               max_nodes=None):
    """One cold and `warm` warm runs of build() on a fresh solver —
    `solve`, or `solve_batch` under `max_nodes` — every kernel count set
    to 0 just before and read just after.  Returns (result, launches,
    solver)."""
    import torch
    solver = solver_cls()
    inp = build()
    if max_nodes is None:
        run = lambda: solver.solve(inp)  # noqa: E731
    else:
        run = lambda: solver.solve_batch(  # noqa: E731
            inp, max_nodes=max_nodes)
    _reset_launches(ffd)
    t0 = time.perf_counter()
    res = run()
    cold_ms = (time.perf_counter() - t0) * 1e3
    cold_phases = dict(solver.last_phase_ms)
    phases = {k: [] for k in solver.last_phase_ms}
    e2e = []
    for _ in range(warm):
        t0 = time.perf_counter()
        res = run()
        e2e.append((time.perf_counter() - t0) * 1e3)
        for k, v in solver.last_phase_ms.items():
            phases.setdefault(k, []).append(v)
    torch.cuda.synchronize()
    launches = _read_launches(ffd)
    if max_nodes is None:
        price = res.total_price()
        print(f"[{label}] {res.node_count()} nodes, "
              f"{len(res.unschedulable)} unschedulable, price "
              f"{price.hex()} ({price:.5f}) on {card}", flush=True)
    print(f"[{label}] cold {cold_ms:.1f} ms, phases ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in cold_phases.items()), flush=True)
    print(f"[{label}] warm p50 {statistics.median(e2e):.3f} ms over "
          f"{warm} runs (min {min(e2e):.3f}, max {max(e2e):.3f}); phase "
          f"p50 ms: " + ", ".join(f"{k} {statistics.median(v):.3f}"
                                  for k, v in phases.items()), flush=True)
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


def _check_sweep(results, launches, digest, kernels, label):
    bad = []
    n_unsched = sum(len(r.unschedulable) for r in results)
    n_claims = sum(len(r.new_claims) for r in results)
    got = sweep_digest(results)
    print(f"[{label}] {len(results)} results, {n_unsched} unschedulable, "
          f"{n_claims} new claims, digest {got}; p0 -> "
          f"{sorted(results[0].existing_assignments.items())}, p1999 -> "
          f"{sorted(results[-1].existing_assignments.items())}", flush=True)
    if len(results) != SWEEP_SIMS:
        bad.append(f"{len(results)} results != {SWEEP_SIMS}")
    if n_unsched or n_claims:
        bad.append(f"{n_unsched} unschedulable, {n_claims} new claims")
    if got != digest:
        bad.append(f"digest {got} != {digest}")
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


def _batch_times(ffd, b, c, N, reps):
    """(K5 ms, plain ms, events ms, bound, K2 ms, K2 plain ms, K2 bound)
    at one batch's shapes: plain, kernel, kernel, plain, in turns; K2 on
    problem 0."""
    import torch
    dev = b.group_req.device
    lay = ffd.flat_layout(b.G, b.E, N, b.D, 1)
    flat = torch.empty((b.B, lay["total"][1]), device=dev)
    lim = torch.empty((b.B, b.P, ffd.R), device=dev)
    k = lambda: ffd.batch_scan(b, c, N, flat, lay, lim)  # noqa: E731
    kp = lambda: ffd.batch_scan_reference(  # noqa: E731
        b, c, N, flat, lay, lim)
    p0 = b.at(0)
    k2 = lambda: ffd.pack(p0, c, N, flat[0], lay, lim[0])  # noqa: E731
    k2p = lambda: ffd.pack_reference(  # noqa: E731
        p0, c, N, flat[0], lay, lim[0])
    t_kp = _time_ms(kp, 3)
    t_k, ev_k = _device_ms(k, reps, "scan_kernel<true, false>")
    t_k2, _ = _device_ms(k2, 200, "pack_kernel")
    t_k = min(t_k, _device_ms(k, reps, "scan_kernel<true, false>")[0])
    t_kp = min(t_kp, _time_ms(kp, 3))
    t_k2p = _time_ms(k2p, 20)
    k()
    torch.cuda.synchronize()
    bnd = _batch_bound(ffd, b, c, N, lay, flat, lim)
    return (t_k, t_kp, ev_k, bnd, t_k2, t_k2p,
            _pack_bound(ffd, p0, c, lim[0]))


def _sweep_times(ffd, sw, c, N, K, reps):
    """(K4 ms, plain ms, events ms, bound) at one chunk's shapes:
    kernel, plain, kernel, in turns."""
    import torch
    dev = sw.group_req.device
    lay = ffd.flat_layout(sw.G, sw.E, N, sw.D, 0, K)
    flat = torch.empty((sw.B, lay["total"][1]), device=dev)
    lim = torch.empty((sw.B, sw.P, ffd.R), device=dev)
    if sw.heavy:
        scan, plain = ffd.sweep_topo_scan, ffd.sweep_topo_scan_reference
        tag = "scan_kernel<true, true>"
    else:
        scan, plain = ffd.sweep_scan, ffd.sweep_scan_reference
        tag = "scan_kernel<false, true>"
    k = lambda: scan(sw, c, N, flat, lay, lim, K)  # noqa: E731
    kp = lambda: plain(sw, c, N, flat, lay, lim, K)  # noqa: E731
    t_k, ev_k = _device_ms(k, reps, tag)
    t_kp = _time_ms(kp, 1)
    t_k = min(t_k, _device_ms(k, reps, tag)[0])
    k()
    torch.cuda.synchronize()
    return t_k, t_kp, ev_k, _sweep_bound(ffd, sw, c, N, K, lay, flat, lim)


def _compaction_turns(ffd, sw, c, N, K, reps):
    """Dense (sparse_k 0) against compacted (sparse_k K) take_exist rows
    on one sweep chunk: launch, device and the pull of the result rows to
    the host, wall time per chunk, in turns dense, compacted, compacted,
    dense.  Returns ({"dense": [ms...], "compacted": [...]}, bytes)."""
    import torch
    ms = {"dense": [], "compacted": []}
    nbytes = {}
    for kind in ("dense", "compacted", "compacted", "dense"):
        k = K if kind == "compacted" else 0
        host = ffd.solve_ffd_sweep(sw, c, N, k).cpu()   # warm-up
        nbytes[kind] = host.numel() * 4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            ffd.solve_ffd_sweep(sw, c, N, k).cpu()
        ms[kind].append((time.perf_counter() - t0) * 1e3 / reps)
    return ms, nbytes


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch.solver import TorchSolver, _cuda, ffd
    from karpenter_tpu_torch.workloads import (build_config3, build_config4,
                                               build_config4b, build_input)

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
    errs = {k: 0.0 for k in list(KERNELS.values()) + ["te_compaction"]}
    failed = []

    def record(label, res, what):
        for k, (eq, err) in res.items():
            errs[k] = max(errs[k], err)
            if not eq:
                failed.append(f"{label}:{k}")
        print(f"[3] {label:28s} {what}: " + ", ".join(
            f"{k} {'equal' if eq else 'DIFFERS'} (max abs err {err:g})"
            for k, (eq, err) in res.items()), flush=True)

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
        record(label, compare_case(ffd, prob, catarr, N, ex, dev),
               f"N={N} explain={ex}")
    for label, probs, catarr, N, ex, K in _batch_cases():
        c = ffd.catalog_tensors(catarr, dev)
        b = ffd.batch_tensors(probs, c.O, dev)
        record(label, compare_batch(ffd, b, c, N, ex, K, dev),
               f"B={b.B} N={N} explain={ex} K={K}")
    for label, rows, shared, catarr, N, K in _sweep_cases():
        c = ffd.catalog_tensors(catarr, dev)
        sw = ffd.sweep_tensors(rows, ffd.sweep_shared_tensors(
            shared, c.O, dev), dev)
        record(label, compare_sweep(ffd, sw, c, N, K, dev),
               f"B={sw.B} E={sw.E} D={sw.D} N={N} K={K}")
    # the sweeps' own first chunks: config #4's first light chunk and
    # config #4b's first heavy chunk, as solve_batch launches them
    chunks = {"config4": _first_chunks(ffd, TorchSolver(), build_config4()),
              "config4b": _first_chunks(ffd, TorchSolver(),
                                        build_config4b())}
    if False not in chunks["config4"] or True not in chunks["config4b"]:
        print("chip_smoke: config #4 launched no light chunk or config #4b "
              "no heavy chunk", file=sys.stderr)
        return 1
    c4_chunk = chunks["config4"][False]
    c4b_chunk = chunks["config4b"][True]
    for label, (sw, c, N, K) in (("config4-light-chunk", c4_chunk),
                                 ("config4b-heavy-chunk", c4b_chunk)):
        record(label, compare_sweep(ffd, sw, c, N, K, dev),
               f"B={sw.B} G={sw.G} E={sw.E} D={sw.D} N={N} K={K}")
    if failed:
        print(f"chip_smoke: kernels disagree with their plain versions: "
              f"{failed}", file=sys.stderr)
        return 1

    # -- 4. the main path: the 50k headline ----------------------------------
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    torch.cuda.reset_peak_memory_stats(dev)
    res, counts, _ = _main_path(
        TorchSolver, lambda: build_input(HEADLINE_PODS), ffd, card,
        "4 headline")
    add(counts)
    print(f"[4 headline] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    bad = _check_answer(res, counts, HEADLINE_NODES, HEADLINE_UNSCHED,
                        HEADLINE_PRICE_HEX, ("ffd_batch_scan", "ffd_pack"))
    if bad:
        print(f"chip_smoke: headline path failed: {bad}", file=sys.stderr)
        return 1

    # -- 5. the main path: config #3 (topology spread) -----------------------
    res, counts, _ = _main_path(TorchSolver, build_config3, ffd, card,
                                "5 config3")
    add(counts)
    bad = _check_answer(res, counts, CONFIG3_NODES, CONFIG3_UNSCHED,
                        CONFIG3_PRICE_HEX, ("ffd_batch_scan", "ffd_pack"))
    if bad:
        print(f"chip_smoke: config #3 path failed: {bad}", file=sys.stderr)
        return 1

    # -- 6. the host oracle's paths: rescue and split ------------------------
    for label, build in oracle_inputs().items():
        nodes, unsched, price_hex, kernels = ORACLE_CASES[label]
        res, counts, s = _main_path(TorchSolver, build, ffd, card,
                                    f"6 {label}")
        add(counts)
        bad = _check_answer(res, counts, nodes, unsched, price_hex,
                            kernels)
        if not s._used_split:
            bad.append("the oracle was not taken")
        if bad:
            print(f"chip_smoke: oracle path {label} failed: {bad}",
                  file=sys.stderr)
            return 1

    # -- 7. the consolidation sweep: config #4 and #4b -----------------------
    for label, build, digest, kernels in (
            ("7 config4", build_config4, CONFIG4_DIGEST,
             ("ffd_sweep_scan",)),
            ("7 config4b", build_config4b, CONFIG4B_DIGEST,
             ("ffd_sweep_scan", "ffd_sweep_topo_scan"))):
        torch.cuda.reset_peak_memory_stats(dev)
        results, counts, _ = _main_path(
            TorchSolver, build, ffd, card, label, warm=SWEEP_WARM,
            max_nodes=SWEEP_MAX_NODES)
        add(counts)
        print(f"[{label}] max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
        bad = _check_sweep(results, counts, digest, kernels, label)
        if bad:
            print(f"chip_smoke: {label} failed: {bad}", file=sys.stderr)
            return 1

    # -- 8. timings at the main paths' shapes --------------------------------
    p, c = ffd.problem_from_numpy(head_prob, head_cat, dev)
    N = solver.max_nodes
    t_k5, t_k5p, ev_k5, (b5, by5), t_k2, t_k2p, (b2, by2) = _batch_times(
        ffd, ffd.FFDBatch.of(p), c, N, 50)
    print(f"[8] headline shapes (B=1, G={p.G}, N={N}, PT={c.PT}, O={c.O}) "
          f"on {card}: ffd_batch_scan {t_k5:.4f} ms (events {ev_k5:.4f}, "
          f"plain {t_k5p:.3f}, bound {b5:.6f} by {by5}); ffd_pack "
          f"{t_k2:.4f} ms (plain {t_k2p:.3f}, bound {b2:.6f} by {by2})",
          flush=True)
    p3, c3 = ffd.problem_from_numpy(c3_prob, c3_cat, dev)
    for N3 in (solver.max_nodes, CONFIG3_WARM_N):
        t3, t3p, ev3, (b3, by3), t3k2, t3k2p, _ = _batch_times(
            ffd, ffd.FFDBatch.of(p3), c3, N3, 20)
        print(f"[8] config #3 shapes (B=1, G={p3.G}, N={N3}, PT={c3.PT}, "
              f"D={p3.D}) on {card}: ffd_batch_scan {t3:.4f} ms (events "
              f"{ev3:.4f}, plain {t3p:.3f}, bound {b3:.6f} by {by3}); "
              f"ffd_pack {t3k2:.4f} ms (plain {t3k2p:.3f})", flush=True)
    # where the scan's time goes on config #3: the same problem with only
    # its light groups, or only its heavy groups, kept (the others' rows
    # zeroed: a step with no pods and no admitted column does next to
    # nothing)
    dsel = np.asarray(c3_prob[7])
    split = {}
    for kind, keep in (("light", dsel == 0), ("heavy", dsel > 0)):
        pk, ck = ffd.problem_from_numpy(_only_groups(c3_prob, keep), c3_cat,
                                        dev)
        bk = ffd.FFDBatch.of(pk)
        lay_k = ffd.flat_layout(pk.G, pk.E, CONFIG3_WARM_N, pk.D)
        flat_k = torch.empty((1, lay_k["total"][1]), device=dev)
        lim_k = torch.empty((1, pk.P, ffd.R), device=dev)
        split[f"{kind} groups only ({int(keep.sum())})"] = _device_ms(
            lambda: ffd.batch_scan(bk, ck, CONFIG3_WARM_N, flat_k, lay_k,
                                   lim_k), 10, "scan_kernel<true, false>")[0]
    print(f"[8] config #3 (N={CONFIG3_WARM_N}) ffd_batch_scan by step kind "
          f"on {card}: " + "; ".join(f"{k} {v:.4f} ms"
                                     for k, v in split.items()), flush=True)
    sweep_t = {}
    for kname, (sw, cs, Ns, Ks) in (("ffd_sweep_scan", c4_chunk),
                                    ("ffd_sweep_topo_scan", c4b_chunk)):
        t4, t4p, ev4, (b4, by4) = _sweep_times(ffd, sw, cs, Ns, Ks, 20)
        sweep_t[kname] = (t4, t4p, b4, by4)
        print(f"[8] {'config #4b heavy' if sw.heavy else 'config #4 light'}"
              f" chunk (B={sw.B}, G={sw.G}, E={sw.E}, D={sw.D}, N={Ns}, "
              f"O={cs.O}, K={Ks}) on {card}: {kname} {t4:.4f} ms (events "
              f"{ev4:.4f}, per simulation {t4 / sw.B * 1e3:.2f} us, plain "
              f"{t4p:.3f}, bound {b4:.6f} by {by4})", flush=True)
    sw, cs, Ns, Ks = c4_chunk
    turns, nbytes = _compaction_turns(ffd, sw, cs, Ns, max(Ks, 8), 20)
    print(f"[8] config #4 chunk take_exist, launch+device+pull per chunk, in "
          f"turns on {card}: " + "; ".join(
              f"{k} ({nbytes[k]} bytes) " + ", ".join(f"{v:.4f}" for v in vs)
              + " ms" for k, vs in turns.items()), flush=True)

    kernels = [
        {"name": "ffd_batch_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_batch_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:1492",
         "launches": launches["ffd_batch_scan"],
         "max_abs_err": errs["ffd_batch_scan"], "ms": t_k5,
         "plain_ms": t_k5p, "bound_ms": b5, "bound_by": by5,
         "library_ms": None},
        {"name": "ffd_sweep_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_sweep_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:1531",
         "launches": launches["ffd_sweep_scan"],
         "max_abs_err": max(errs["ffd_sweep_scan"], errs["te_compaction"]),
         "ms": sweep_t["ffd_sweep_scan"][0],
         "plain_ms": sweep_t["ffd_sweep_scan"][1],
         "bound_ms": sweep_t["ffd_sweep_scan"][2],
         "bound_by": sweep_t["ffd_sweep_scan"][3], "library_ms": None},
        {"name": "ffd_sweep_topo_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_sweep_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:1610",
         "launches": launches["ffd_sweep_topo_scan"],
         "max_abs_err": errs["ffd_sweep_topo_scan"],
         "ms": sweep_t["ffd_sweep_topo_scan"][0],
         "plain_ms": sweep_t["ffd_sweep_topo_scan"][1],
         "bound_ms": sweep_t["ffd_sweep_topo_scan"][2],
         "bound_by": sweep_t["ffd_sweep_topo_scan"][3], "library_ms": None},
        {"name": "ffd_pack", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_pack.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:1113",
         "launches": launches["ffd_pack"],
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
