#!/usr/bin/env python3
"""Where the FFD scan's time goes on the card, step section by section.

Run from the repository root on a machine with an NVIDIA H100:

    python3 scan_sections.py [--csrc DIR] [--against DIR]

The script copies the scan kernels' sources (this checkout's
`karpenter_tpu_torch/csrc`, or `--csrc DIR`) into
`karpenter_tpu_torch/_build/sections/`, inserts `clock64()` counters there
at block barriers between the light step's sections — the existing nodes,
the in-flight capacity walk, the pool-limit scans, the take scan, the
touched-node narrowing, the pool-budget update, the new-node column pass,
the per-pool cascade, the slot activation — and around each step's
prologue, each heavy or gang step and the kernel's prologue and epilogue,
builds K5, K6 and K4 from the copy with the port's nvcc flags, and
launches them at the main paths' shapes: K6 at config #12's second chunk,
K5 at config #12's one program (the spec-off arm's launch), at config #3
(N=1024 and 64) and at the headline, K4's light lane at config #4's first
chunk.  Thread 0 of block 0 reads the SM clock after each section's
barrier and adds the difference to a counter in device memory, which the
script reads back and prints as cycles a launch and a step and as shares.
The counters add a barrier per section, so the instrumented kernel runs a
little slower than the real one: both times are printed.  The checkout's
kernels are never changed.

With `--against DIR` (another tree's `csrc`, e.g. the parent commit's) it
also builds that tree's kernels and this checkout's, uninstrumented, and
times both at the shapes above and at config #9, config #2, config #7's
suffix and delta-off chain chunk, K7 at 8 shards and K4's two lanes, in
turns (DIR, this, this, DIR; the profiler's device time, the lower of
each tree's two), holding this checkout's outputs to DIR's as uint32.

Exits non-zero without a CUDA device, and on any build failure or
differing output.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "karpenter_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "karpenter_tpu_torch", "_build", "sections")

SECTIONS = ("existing nodes", "capacity walk", "pool-limit scans",
            "take scan", "touched narrowing", "pool-budget update",
            "new-node column pass", "cascade", "slot activation",
            "step prologue", "heavy or gang step", "kernel prologue",
            "kernel epilogue", "final state")
STEPS = 20  # counter: steps the counters span

COUNTERS = r'''
__device__ unsigned long long g_sections[32];
__device__ long long g_clock;
#define SECTION(k) do { __syncthreads(); \
  if (threadIdx.x == 0 && blockIdx.x == 0) { const long long t_ = clock64(); \
    g_sections[k] += (unsigned long long)(t_ - g_clock); g_clock = t_; } \
  } while (0)
extern "C" int kt_sections_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_sections, z, sizeof z);
}
extern "C" int kt_sections_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_sections, sizeof(g_sections));
}
'''


def _insert(src: str, start: str, anchor: str, text: str) -> str:
    """`text` inserted before the first `anchor` past `start`."""
    j = src.index(anchor, src.index(start))
    return src[:j] + text + src[j:]


def instrument(src: str) -> str:
    """ffd_scan_common.cuh with the section counters."""
    src = src.replace("#include <limits.h>\n",
                      "#include <limits.h>\n" + COUNTERS, 1)
    light = "__device__ void light_step("
    for k, anchor in (
            (0, "  // -- 2. in-flight nodes"),
            (1, "  // the best over every shard's blocks"),
            (2, "  if (whole) {\n    for (int n = tid; n < N; n += NT)\n"
                "      if (s.cap[n] >= c1)"),
            (3, "  // touched nodes: charge used"),
            (4, "  if (tid == 0) {\n    // segment_sum of integer takes"),
            (5, "  // -- 3. open new nodes"),
            (6, "  // the per-pool cascade, in pool priority order"),
            (7, "  // emit the take_new row" if "// emit the take_new row"
                in src else "  // activate the opened slots")):
        src = _insert(src, light, anchor, f"  SECTION({k});\n")
    end = "  for (int d = tid; d < D; d += NT) a.dom_placed["
    i = src.index(end, src.index(light))
    i = src.index("\n}", i)
    src = src[:i] + "\n  SECTION(8);" + src[i:]
    kern = "__launch_bounds__(NT, 1) scan_kernel("
    src = _insert(src, kern, "  const ScanArgs& a = A;",
                  "  if (tid == 0 && blockIdx.x == 0) g_clock = clock64();\n")
    src = _insert(src, kern, "  for (int g = 0; g < G; ++g) {",
                  "  SECTION(11);\n")
    src = _insert(src, kern, "  // -- final state", "  SECTION(12);\n")
    src = _insert(src, kern, "  if (tid == 0) a.na_out[0] = (float)S.na;",
                  "  SECTION(13);\n")
    src = _insert(src, kern, "    if constexpr (GANG) {",
                  "    SECTION(9);\n    if (tid == 0 && blockIdx.x == 0) "
                  f"g_sections[{STEPS}] += 1;\n")
    i = src.index("  if (a.K > 0) compact_take_exist(a, S);",
                  src.index(kern))
    i = src.rindex("    __syncthreads();\n  }\n", 0, i)
    return src[:i] + "    SECTION(10);\n" + src[i:]


def build(tree: str, dest: str, sources, instrumented: bool):
    """Copy `tree` to `dest` (instrumenting it) and start one nvcc per
    source; returns the processes."""
    from karpenter_tpu_torch.solver import _cuda
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(tree, dest, ignore=shutil.ignore_patterns("*.so"))
    if instrumented:
        path = os.path.join(dest, "ffd_scan_common.cuh")
        with open(path) as f:
            text = instrument(f.read())
        with open(path, "w") as f:
            f.write(text)
    return [(dest, name, subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
         os.path.join(dest, f"lib{name}.so"),
         os.path.join(dest, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in sources]


def load(dest: str, sources):
    """{source: CDLL} with the entry points' argument types set."""
    from karpenter_tpu_torch.solver import _cuda
    libs = {}
    for name in sources:
        lib = ctypes.CDLL(os.path.join(dest, f"lib{name}.so"))
        for entry, src in _cuda.ENTRIES.items():
            if src == name:
                fn = getattr(lib, entry)
                fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def use(libs):
    """Route the port's kernel wrappers to these libraries."""
    from karpenter_tpu_torch.solver import _cuda
    _cuda._libs.update(libs)


def shapes(cs, ffd, dev):
    """[(label, launch, output buffers, trace tag, steps)] at the main
    paths' shapes, each launch as the solver or the sweep makes it."""
    import torch
    from karpenter_tpu_torch.parallel.mesh import shard_problem
    from karpenter_tpu_torch.solver import TorchSolver
    from karpenter_tpu_torch.workloads import (
        build_config2, build_config3, build_config4, build_config4b,
        build_config7, build_config9, build_config12, build_input)
    solver = TorchSolver()
    head = cs._encoded_problem(solver, build_input(cs.HEADLINE_PODS), ffd)
    c3 = cs._encoded_problem(solver, build_config3(), ffd)
    c9 = cs._encoded_problem(solver, build_config9(), ffd)
    c2 = cs._encoded_problem(solver, build_config2(), ffd)
    big = cs.CONFIG_MAX_NODES
    with cs._DeltaCapture(ffd) as cap12:
        TorchSolver(max_nodes=big, delta="off", spec="on").solve(
            build_config12())
    with cs._SolveCapture(ffd) as cap12o:
        TorchSolver(max_nodes=big, delta="off", spec="off").solve(
            build_config12())
    s7 = TorchSolver(max_nodes=big)
    s7.solve(build_config7(0))
    with cs._DeltaCapture(ffd) as cap7:
        s7.solve(build_config7(1))
    with cs._DeltaCapture(ffd) as cap7c:
        TorchSolver(max_nodes=big, delta="off").solve(build_config7(0))
    c4 = cs._first_chunks(ffd, TorchSolver(), build_config4())[False]
    c4b = cs._first_chunks(ffd, TorchSolver(), build_config4b())[True]

    def flat(lay, P, B=None):
        lead = () if B is None else (B,)
        return (torch.empty(lead + (lay["total"][1],), device=dev),
                torch.empty(lead + (P, ffd.R), device=dev))

    def batch(p, c, N, wg=0, wp=0):
        b = ffd.FFDBatch.of(p)
        lay = ffd.flat_layout(b.G, b.E, N, b.D, 0, 0, c.O, wp)
        fl, lim = flat(lay, b.P, 1)
        return (lambda: ffd.batch_scan(b, c, N, fl, lay, lim, with_gang=wg),
                (fl, lim), cs._tag(True, False, bool(wg)), b.G)

    def encoded(prob, cat, N, wg=0):
        return batch(*ffd.problem_from_numpy(prob, cat, dev), N, wg)

    def delta(call):
        p, sd, c, N, _ = call
        lay = ffd.flat_layout(p.G, p.E, N, p.D)
        fl, lim = flat(lay, p.P)
        return (lambda: ffd.delta_scan(p, sd, c, N, fl, lay, lim), (fl, lim),
                cs._tag(False, False, False, True), p.G)

    def sharded(prob, cat, S, N):
        p, table, sc, _ = shard_problem(prob, cat, S, dev)
        lay = ffd.flat_layout(p.G, p.E, N, p.D, 1)
        fl, lim = flat(lay, p.P)
        ffd.sharded_clusters(p, table, sc, N, lay, 0)
        return (lambda: ffd.sharded_scan(p, table, sc, N, fl, lay, lim, 0),
                (fl, lim), cs._tag(True, False, False, False, True), p.G)

    def sweep(chunk):
        sw, c, N, K = chunk
        lay = ffd.flat_layout(sw.G, sw.E, N, sw.D, 0, K)
        fl, lim = flat(lay, sw.P, sw.B)
        scan = ffd.sweep_topo_scan if sw.heavy else ffd.sweep_scan
        return (lambda: scan(sw, c, N, fl, lay, lim, K), (fl, lim),
                cs._tag(sw.heavy, True, False), sw.G)

    p12, c12, n12, _, wg12, wp12 = cap12o.calls[0]
    split = [("K6 config #12 chunk 1", delta(cap12.calls[1])),
             ("K5 config #12 one program", batch(p12, c12, n12, wg12, wp12)),
             ("K5 config #3 N=1024", encoded(*c3, solver.max_nodes)),
             ("K5 config #3 N=64", encoded(*c3, cs.CONFIG3_WARM_N)),
             ("K5 headline N=1024", encoded(*head, solver.max_nodes)),
             ("K4 config #4 light chunk", sweep(c4))]
    more = [("K5 gang config #9 N=2048", encoded(*c9, big, 1)),
            ("K5 config #2 N=256", encoded(*c2, cs.CONFIG2_MAX_NODES)),
            ("K6 config #7 suffix", delta(cap7.calls[0])),
            ("K6 config #7 delta-off chain chunk 1", delta(cap7c.calls[1])),
            ("K7 headline S=8", sharded(*head, cs.MESH, solver.max_nodes)),
            ("K7 config #2 S=8", sharded(*c2, cs.MESH,
                                         cs.CONFIG2_MAX_NODES)),
            ("K4 config #4b heavy chunk", sweep(c4b))]
    return split, more


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=CSRC,
                    help="the kernel sources to split (default: this "
                         "checkout's)")
    ap.add_argument("--against", default=None,
                    help="another tree's csrc to time this checkout's "
                         "kernels against, in turns")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("scan_sections: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from karpenter_tpu_torch.solver import ffd

    split_src = ("ffd_batch_scan", "ffd_delta_scan", "ffd_sweep_scan")
    all_src = split_src + ("ffd_sharded_scan",)
    t0 = time.perf_counter()
    procs = build(args.csrc, os.path.join(OUT, "split"), split_src, True)
    procs += build(args.csrc, os.path.join(OUT, "plain"), split_src, False)
    if args.against:
        procs += build(CSRC, os.path.join(OUT, "this"), all_src, False)
        procs += build(args.against, os.path.join(OUT, "against"), all_src,
                       False)
    failed = False
    for dest, name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"scan_sections: nvcc failed on {dest}/{name}.cu\n{log}",
                  file=sys.stderr)
            failed = True
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {os.path.basename(dest)} {name}: {line.strip()}")
    if failed:
        return 1
    print(f"[sections] built {len(procs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s on {cs._card_line()}",
          flush=True)

    dev = torch.device("cuda", 0)
    plain = load(os.path.join(OUT, "plain"), split_src)
    use(plain)
    split, more = shapes(cs, ffd, dev)
    counted = load(os.path.join(OUT, "split"), split_src)
    for lib in counted.values():
        lib.kt_sections_read.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    for label, (fn, bufs, tag, G) in split:
        src = {"K4": "ffd_sweep_scan", "K5": "ffd_batch_scan",
               "K6": "ffd_delta_scan"}[label[:2]]
        use(plain)
        t_real = cs._device_ms(fn, 3, tag)[0]
        use({src: counted[src]})
        fn()
        torch.cuda.synchronize()
        counted[src].kt_sections_reset()
        fn()
        torch.cuda.synchronize()
        v = (ctypes.c_uint64 * 32)()
        counted[src].kt_sections_read(v)
        t_counted = cs._device_ms(fn, 1, tag)[0]
        total = sum(v[:len(SECTIONS)]) or 1
        steps = v[STEPS] or 1
        print(f"[sections] {label} (G={G}): kernel {t_real:.4f} ms, with "
              f"counters {t_counted:.4f} ms; cycles a launch, a step "
              f"(share):", flush=True)
        for k, name in enumerate(SECTIONS):
            print(f"    {name:22s} {v[k]:12d} {v[k] / steps:12.0f} "
                  f"({100.0 * v[k] / total:5.2f}%)")
    if not args.against:
        return 0

    # this checkout against the other tree, in turns
    real = load(os.path.join(OUT, "this"), all_src)
    against = load(os.path.join(OUT, "against"), all_src)
    times, ref, bad = {}, {}, []
    for name, libs in (("against", against), ("this", real),
                       ("this", real), ("against", against)):
        use(libs)
        for label, (fn, bufs, tag, G) in split + more:
            for b in bufs:
                b.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            got = [b.cpu().numpy().view(np.uint32).copy() for b in bufs]
            if label not in ref:
                ref[label] = got
            elif not all(np.array_equal(x, y)
                         for x, y in zip(got, ref[label])):
                bad.append(label)
            reps = 3 if "one program" in label else 20
            times.setdefault((label, name), []).append(
                cs._device_ms(fn, reps, tag)[0])
    print(f"[turns] {'shape':40s} {'against ms':>11s} {'this ms':>10s} "
          f"{'this/against':>12s} {'this ms a step':>15s}")
    for label, (fn, bufs, tag, G) in split + more:
        a, t = min(times[(label, "against")]), min(times[(label, "this")])
        print(f"[turns] {label:40s} {a:11.4f} {t:10.4f} {t / a:12.3f} "
              f"{t / G:15.5f}", flush=True)
    if bad:
        print(f"scan_sections: outputs differ from {args.against}: "
              f"{sorted(set(bad))}", file=sys.stderr)
        return 1
    print(f"[turns] every output equal to {args.against}'s as uint32")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
