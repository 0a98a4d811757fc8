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
the per-pool cascade, the slot activation — at the heavy step's (its
prologue, the capacity estimates, the in-flight slot maxima, the column
pass, the water-fill, the existing, in-flight and new nodes per domain)
and around each step's prologue, each gang step, the kernel's prologue
and epilogue and the explain rows' pass of the epilogue (`explain_pack`),
builds K5, K6 and K4 from the copy with the port's nvcc flags, and
launches them at the main paths' shapes, with the explain rows the main
path asks for (explain=counts): K6 at config #12's second chunk, K5 at
config #12's one program (the spec-off arm's launch), at config #3
(N=1024 and 64) and at the headline, K4's light lane at config #4's first
chunk and its heavy lane at config #4b's (`--only K4` splits only
those).  Thread 0 of block 0 reads the SM clock after each section's
barrier and adds the difference to a counter in device memory, which the
script reads back and prints as cycles a launch and a step and as shares.
The counters add a barrier per section, so the instrumented kernel runs a
little slower than the real one: both times are printed.  K5 is also
split with the priority witness's region at config #10's encoding and at
`chip_smoke.py`'s G = 2048 priority problem: the witness has no barrier
of its own, so thread 0 reads the clock around it (`witness_put`, inside
the steps) and its cycles are printed beside the sections, not in their
total.  The checkout's kernels are never changed.

With `--k4-launch` it times K4's two launch paths in turns at config
#4's first light chunk and config #4b's first heavy chunk, each on both
carry routes (the chunk's own N, and N = 1024, whose carry does not
fit): the wrapper (`ffd.sweep_scan` / `sweep_topo_scan`,
through the sweep's `SweepLaunch`, its array patched a chunk) and
`ffd._launch_scan` after the checks the wrapper would make each chunk
(its argument array built anew a launch, no scratch on the shared-memory
route), in the order general, wrapper, wrapper, general: the CUDA
events' ms a launch over 200 launches back to back and the host's ms a
call, holding both paths' rows equal as uint32.

With `--against DIR` (another tree's `csrc`, e.g. the parent commit's) it
also builds that tree's kernels and this checkout's, uninstrumented,
prints each kernel's ptxas report of the two trees as identical or not
(K4's must be identical: its instances compile no witness), and times
both at the shapes above and at config #9, config #2, config #7's suffix
and delta-off chain chunk, K7 at 8 shards, K7x rehearsed on this card
(one cooperative grid of 4 blocks) at config #2 and #9 and on a seeded
problem (its seeded instance), K4's two lanes, also dense and with the
take_exist compaction (K >= 8: row 3b is the difference), and K5 without
the witness's region at config #10 and at the G = 2048 priority problem
(row 9 is the difference from the split launches with it), in turns
(DIR, this, this, DIR, ROUNDS times; the profiler's device time, the
lower of each tree's 2 x ROUNDS, and the ratio of the trees' medians),
holding this checkout's outputs to DIR's as uint32.  DIR's kernels must take this checkout's
argument list (ScanArgs, the wrappers of this checkout's `solver/ffd.py`
launch both; K4's launches then carry device scratch for the carry on
both trees); K7x is left out when DIR's `ffd_card_scan.cu` takes
another (its CARD_NPTRS, CARD_NDIMS).

Exits non-zero without a CUDA device, and on any build failure or
differing output.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "karpenter_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "karpenter_tpu_torch", "_build", "sections")

SECTIONS = ("existing nodes", "capacity walk", "pool-limit scans",
            "take scan", "touched narrowing", "pool-budget update",
            "new-node column pass", "cascade", "slot activation",
            "step prologue", "heavy outputs or gang step", "kernel prologue",
            "kernel epilogue", "final state", "explain epilogue",
            "heavy prologue", "heavy capacity estimates",
            "heavy slot maxima", "heavy column pass", "heavy water-fill",
            "heavy existing per domain", "heavy in-flight per domain",
            "heavy new nodes")
# the priority witness's counter: thread 0's cycles in it, read without a
# barrier of its own (inside the sections above, so not in their total)
WITNESS = 23
# --against's rounds of (DIR, this, this, DIR): turns a side = 2 x ROUNDS
ROUNDS = 4
# the heavy step's sections: (index, the anchor that ends the section)
HEAVY = ((15, "  // -- capacity estimates per domain"),
         (16, "  // each in-flight node serves ONE domain"),
         (17, "  // per-column pods-per-node of an empty node, the feasible "
              "columns, and\n  // the best column per (pool, domain)"),
         (18, "  water_fill(H, D,"),
         (19, "  // -- 1. existing nodes, per domain"),
         (20, "  // -- 2. in-flight nodes, per domain"),
         (21, "  // -- 3. open new nodes, per pool x domain"),
         (22, "  // -- outputs"))
STEPS = 31  # counter: steps the counters span

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
    heavy = "__device__ void heavy_step("
    for k, anchor in HEAVY:
        src = _insert(src, heavy, anchor, f"  SECTION({k});\n")
    end = "  for (int d = tid; d < D; d += NT) a.dom_placed["
    i = src.index(end, src.index(light))
    i = src.index("\n}", i)
    src = src[:i] + "\n  SECTION(8);" + src[i:]
    kern = "__device__ __forceinline__ void scan_body("
    src = _insert(src, kern, "  const ScanArgs& a = A;",
                  "  if (tid == 0 && blockIdx.x == 0) g_clock = clock64();\n")
    src = _insert(src, kern, "  for (int g = 0; g < G; ++g) {",
                  "  SECTION(11);\n")
    src = _insert(src, kern, "  if constexpr (!SWEEP) {\n"
                  "    if (a.ex_counts)", "  SECTION(12);\n")
    src = _insert(src, kern, "  // -- final state", "  SECTION(14);\n")
    src = _insert(src, kern, "  if (tid == 0) a.na_out[0] = (float)S.na;",
                  "  SECTION(13);\n")
    src = _insert(src, kern, "    if constexpr (GANG) {",
                  "    SECTION(9);\n    if (tid == 0 && blockIdx.x == 0) "
                  f"g_sections[{STEPS}] += 1;\n")
    i = src.index("  if (a.K > 0) compact_take_exist(a, S);",
                  src.index(kern))
    i = src.rindex("    __syncthreads();\n  }\n", 0, i)
    return witness_counter(src[:i] + "    SECTION(10);\n" + src[i:])


def witness_counter(src: str) -> str:
    """The priority witness's counter (WITNESS): the SM clock read by
    thread 0 of block 0 before and after `witness_put` in the steps (the
    flag written beside the strand count, any wait on the loads
    `witness_in` started earlier included)."""
    put = "    int before = in.before;\n"
    end = "    wit().before = before;\n"
    j = src.index(end, src.index(put)) + len(end)
    src = (src[:j] + f"    if (blockIdx.x == 0) g_sections[{WITNESS}] += "
           "(unsigned long long)(clock64() - w0_);\n" + src[j:])
    return src.replace(put, "    const long long w0_ = clock64();\n" + put, 1)


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
    """{source: CDLL} with the entry points' argument types set (those the
    library exports: another tree's may lack some)."""
    from karpenter_tpu_torch.solver import _cuda
    libs = {}
    for name in sources:
        lib = ctypes.CDLL(os.path.join(dest, f"lib{name}.so"))
        for entry, src in _cuda.ENTRIES.items():
            if src == name and hasattr(lib, entry):
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
        build_config7, build_config9, build_config10, build_config12,
        build_input)
    solver = TorchSolver()
    head = cs._encoded_problem(solver, build_input(cs.HEADLINE_PODS), ffd)
    c3 = cs._encoded_problem(solver, build_config3(), ffd)
    c9 = cs._encoded_problem(solver, build_config9(), ffd)
    c2 = cs._encoded_problem(solver, build_config2(), ffd)
    c10 = cs._encoded_problem(solver, build_config10(), ffd)
    wprob, wcat, wN = cs.witness_problem()
    seeded = {c[0]: c for c in cs._sharded_cases()}["S4-delta"]
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

    def batch(p, c, N, wg=0, wp=0, ex=1):
        b = ffd.FFDBatch.of(p)
        lay = ffd.flat_layout(b.G, b.E, N, b.D, ex, 0, c.O, wp)
        fl, lim = flat(lay, b.P, 1)
        return (lambda: ffd.batch_scan(b, c, N, fl, lay, lim, with_gang=wg),
                (fl, lim), cs._tag(True, False, bool(wg)), b.G)

    def encoded(prob, cat, N, wg=0, wp=0, ex=1):
        return batch(*ffd.problem_from_numpy(prob, cat, dev), N, wg, wp, ex)

    def delta(call):
        p, sd, c, N, ex = call
        lay = ffd.flat_layout(p.G, p.E, N, p.D, ex)
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

    def rehearsal(prob, cat, S, N, ex=1, seeds=None):
        # K7x rehearsed on this card: one cooperative grid of S blocks
        c = cs._Cards(ffd, S, prob, cat, N, ex, seeds, (dev,) * S)
        fl, lim = c.bufs()
        return (lambda: c.launch(fl, lim), (fl, lim),
                cs._tag(seeds is None, False, bool(c.wg), seeds is not None,
                        2),
                c.ref[0].G)

    def sweep(chunk):
        sw, c, N, K = chunk
        lay = ffd.flat_layout(sw.G, sw.E, N, sw.D, 0, K)
        fl, lim = flat(lay, sw.P, sw.B)
        scan = ffd.sweep_topo_scan if sw.heavy else ffd.sweep_scan
        return (lambda: scan(sw, c, N, fl, lay, lim, K), (fl, lim),
                cs._tag(sw.heavy, True, False), sw.G)

    p12, c12, n12, ex12, wg12, wp12 = cap12o.calls[0]
    split = [("K6 config #12 chunk 1", delta(cap12.calls[1])),
             ("K5 config #12 one program", batch(p12, c12, n12, wg12, wp12,
                                                 ex12)),
             ("K5 config #3 N=1024", encoded(*c3, solver.max_nodes)),
             ("K5 config #3 N=64", encoded(*c3, cs.CONFIG3_WARM_N)),
             ("K5 headline N=1024", encoded(*head, solver.max_nodes)),
             ("K4 config #4 light chunk", sweep(c4)),
             ("K4 config #4b heavy chunk", sweep(c4b))]
    more = [("K5 gang config #9 N=2048", encoded(*c9, big, 1)),
            ("K5 config #2 N=256", encoded(*c2, cs.CONFIG2_MAX_NODES)),
            ("K6 config #7 suffix", delta(cap7.calls[0])),
            ("K6 config #7 delta-off chain chunk 1", delta(cap7c.calls[1])),
            ("K7 headline S=8", sharded(*head, cs.MESH, solver.max_nodes)),
            ("K7 config #2 S=8", sharded(*c2, cs.MESH,
                                         cs.CONFIG2_MAX_NODES)),
            ("K7x rehearsal config #2 S=4", rehearsal(
                *c2, 4, cs.CONFIG2_MAX_NODES)),
            ("K7x rehearsal gang config #9 S=4", rehearsal(*c9, 4, big)),
            ("K7x rehearsal seeded S4-delta S=4", rehearsal(
                *seeded[2:4], 4, *seeded[4:7]))]
    # row 9, the priority witness: K5 with its region (split: its cycles)
    # and without (in `more`), as phase 9 of chip_smoke.py launches it
    for lab, (prob, cat), N in (
            ("config #10", c10, cs.CONFIG3_WARM_N),
            (f"G={cs.WITNESS_G} priority problem", (wprob, wcat), wN)):
        split.append((f"K5 {lab} with the witness",
                      encoded(prob, cat, N, 0, 1, 0)))
        more.append((f"K5 {lab} without the witness",
                     encoded(prob, cat, N, 0, 0, 0)))
    # the take_exist compaction of K4's epilogue (row 3b): each chunk dense
    # and compacted
    for lab, (sw, c, N, K) in (("K4 config #4 light chunk", c4),
                               ("K4 config #4b heavy chunk", c4b)):
        more += [(f"{lab} dense", sweep((sw, c, N, 0))),
                 (f"{lab} K={max(K, 8)}", sweep((sw, c, N, max(K, 8))))]
    return split, more


def card_abi(csrc: str):
    """K7x's argument counts in a tree's ffd_card_scan.cu (its
    CARD_NPTRS and CARD_NDIMS definitions)."""
    with open(os.path.join(csrc, "ffd_card_scan.cu")) as f:
        return tuple(line.split(None, 2)[2].strip() for line in f
                     if line.startswith(("#define CARD_NPTRS",
                                         "#define CARD_NDIMS")))


def k4_launch_paths(cs, ffd, reps: int = 200) -> int:
    """K4's launch through its wrapper (SweepLaunch) against
    `_launch_scan` with the wrapper's checks, in turns (module doc)."""
    import numpy as np
    import torch
    from karpenter_tpu_torch.solver import TorchSolver
    from karpenter_tpu_torch.workloads import build_config4, build_config4b
    dev = torch.device("cuda", 0)
    c4 = cs._first_chunks(ffd, TorchSolver(), build_config4())[False]
    c4b = cs._first_chunks(ffd, TorchSolver(), build_config4b())[True]
    cases = []
    for label, (sw, c, N, K) in (("config #4 light chunk", c4),
                                 ("config #4b heavy chunk", c4b)):
        for n in (N, 1024):
            lay = ffd.flat_layout(sw.G, sw.E, n, sw.D, 0, K)
            bufs = (torch.empty((sw.B, lay["total"][1]), device=dev),
                    torch.empty((sw.B, sw.P, ffd.R), device=dev))
            entry = ffd.SWEEP_ENTRIES[sw.heavy]
            scan = ffd.sweep_topo_scan if sw.heavy else ffd.sweep_scan
            D = sw.D if sw.heavy else 1

            def general(sw=sw, c=c, n=n, K=K, lay=lay, b=bufs, entry=entry,
                        D=D):
                ffd._check_sweep_rows(sw, n, dev)
                ffd._check_sweep_shared(sw.shared, c, sw.P, dev)
                ffd._check_outputs(sw.B, sw.P, b[0], lay, b[1], K)
                ffd._first_launch(entry, sw.B, sw.G, sw.E, n, sw.P, D,
                                  sw.X, c.O, K)
                ffd._launch_scan(entry, sw.B, sw.G, sw.E, n, sw.P, D, sw.X,
                                 c, b[0], lay, b[1], K,
                                 ffd._sweep_inputs(sw))

            route = cs._route(ffd, sw, c, n, K)
            cases.append((f"{label} N={n} ({route} carry)", bufs, {
                "_launch_scan": general,
                "SweepLaunch": lambda sw=sw, c=c, n=n, K=K, lay=lay,
                b=bufs, scan=scan: scan(sw, c, n, b[0], lay, b[1], K)}))
    times, ref, bad = {}, {}, []
    for path in ("_launch_scan", "SweepLaunch", "SweepLaunch",
                 "_launch_scan"):
        for label, bufs, fns in cases:
            fn = fns[path]
            for b in bufs:
                b.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            got = [b.cpu().numpy().view(np.uint32).copy() for b in bufs]
            if label not in ref:
                ref[label] = got
            elif not all(np.array_equal(x, y)
                         for x, y in zip(got, ref[label])):
                bad.append((label, path))
            ev = cs._time_ms(fn, reps)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda.synchronize()
            times.setdefault((label, path), []).append((ev, host))
    print(f"[k4-launch] K4's launch paths, events ms a launch and host ms "
          f"a call over {reps} launches (each turn; general, wrapper, "
          f"wrapper, general), on {cs._card_line()}")
    for label, bufs, fns in cases:
        print(f"[k4-launch] {label:44s} " + "; ".join(
            f"{path}: events " + ", ".join(
                f"{e:.4f}" for e, _ in times[(label, path)])
            + " host " + ", ".join(f"{h:.4f}" for _, h in
                                   times[(label, path)])
            for path in ("_launch_scan", "SweepLaunch")), flush=True)
    if bad:
        print(f"scan_sections: the launch paths differ in their rows: {bad}",
              file=sys.stderr)
        return 1
    print("[k4-launch] both paths' rows equal as uint32")
    return 0


def ptxas_reports(log: str):
    """{kernel's mangled name: its ptxas lines (registers, stack, spills)}
    of one nvcc log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
            out[name] = []
        elif name and ("registers" in line or "spill" in line
                       or "stack frame" in line):
            out[name].append(line.split("info    :")[-1].strip())
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=CSRC,
                    help="the kernel sources to split (default: this "
                         "checkout's)")
    ap.add_argument("--against", default=None,
                    help="another tree's csrc to time this checkout's "
                         "kernels against, in turns")
    ap.add_argument("--only", default=None,
                    help="split only the launches whose label starts with "
                         "one of these, e.g. K4 or K5,K6")
    ap.add_argument("--k4-launch", action="store_true",
                    help="time K4's wrapper against _launch_scan in turns")
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

    if args.k4_launch:
        return k4_launch_paths(cs, ffd)
    split_src = ("ffd_batch_scan", "ffd_delta_scan", "ffd_sweep_scan")
    # K7x's source is built for its ptxas report beside the others'
    all_src = split_src + ("ffd_sharded_scan", "ffd_card_scan")
    t0 = time.perf_counter()
    procs = build(args.csrc, os.path.join(OUT, "split"), split_src, True)
    procs += build(args.csrc, os.path.join(OUT, "plain"), split_src, False)
    if args.against:
        procs += build(CSRC, os.path.join(OUT, "this"), all_src, False)
        procs += build(args.against, os.path.join(OUT, "against"), all_src,
                       False)
    failed, logs = False, {}
    for dest, name, proc in procs:
        log, _ = proc.communicate()
        logs[(os.path.basename(dest), name)] = log
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
    k4_differs = []
    if args.against:
        # each kernel's ptxas report, this checkout's against DIR's
        for src in all_src:
            mine = ptxas_reports(logs[("this", src)])
            theirs = ptxas_reports(logs[("against", src)])
            for kern in sorted(set(mine) | set(theirs)):
                t, a = mine.get(kern), theirs.get(kern)
                if t == a:
                    print(f"[ptxas] {src} {kern}: identical", flush=True)
                    continue
                if src == "ffd_sweep_scan":
                    k4_differs.append(kern)
                print(f"[ptxas] {src} {kern}: against "
                      + " | ".join(a or ["(none)"]) + " ; this "
                      + " | ".join(t or ["(none)"]), flush=True)

    dev = torch.device("cuda", 0)
    plain = load(os.path.join(OUT, "plain"), split_src)
    use(plain)
    split, more = shapes(cs, ffd, dev)
    counted = load(os.path.join(OUT, "split"), split_src)
    for lib in counted.values():
        lib.kt_sections_read.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    if args.only:
        split = [x for x in split
                 if x[0].split()[0] in args.only.split(",")]
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
        print(f"    {'priority witness':22s} {v[WITNESS]:12d} "
              f"{v[WITNESS] / steps:12.0f} (thread 0, inside the sections "
              f"above)")
    if not args.against:
        return 0

    # this checkout against the other tree, in turns.  K4's launches
    # carry device scratch for its carry on every route: a tree whose K4
    # keeps its carry in device memory reads it there, and this
    # checkout's K4 ignores it where its carry fits in shared memory
    ffd.sweep_carry_fits = lambda *a, **k: False
    if card_abi(args.against) != card_abi(CSRC):
        # this checkout's wrappers cannot launch the other tree's K7x
        more = [x for x in more if not x[0].startswith("K7x")]
        print(f"[turns] K7x left out: {args.against} takes another "
              f"argument list {card_abi(args.against)} than this checkout "
              f"{card_abi(CSRC)} (e2e_turns.py --arms cards times each "
              f"tree's K7x through its own wrappers)", flush=True)
    real = load(os.path.join(OUT, "this"), all_src)
    against = load(os.path.join(OUT, "against"), all_src)
    times, ref, bad = {}, {}, []
    for name, libs in (("against", against), ("this", real),
                       ("this", real), ("against", against)) * ROUNDS:
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
            reps = 3 if G >= 2048 else 20
            times.setdefault((label, name), []).append(
                cs._device_ms(fn, reps, tag)[0])
    print(f"[turns] {'shape':40s} {'against ms':>11s} {'this ms':>10s} "
          f"{'this/against':>12s} {'of the medians':>14s} "
          f"{'this ms a step':>15s}")
    for label, (fn, bufs, tag, G) in split + more:
        a, t = min(times[(label, "against")]), min(times[(label, "this")])
        med = (statistics.median(times[(label, "this")])
               / statistics.median(times[(label, "against")]))
        print(f"[turns] {label:40s} {a:11.4f} {t:10.4f} {t / a:12.3f} "
              f"{med:14.3f} {t / G:15.5f}", flush=True)
    for lab in ("K4 config #4 light chunk", "K4 config #4b heavy chunk"):
        dense = [x for x in more if x[0] == f"{lab} dense"][0][0]
        packed = [x for x in more if x[0].startswith(f"{lab} K=")][0][0]
        pack = {name: min(times[(packed, name)]) - min(times[(dense, name)])
                for name in ("against", "this")}
        print(f"[turns] {lab}: the take_exist compaction (row 3b, the "
              f"difference of the minima) " + ", ".join(
                  f"{name} {ms:.4f} ms" for name, ms in pack.items()),
              flush=True)
    for lab in ("config #10", f"G={cs.WITNESS_G} priority problem"):
        on, off = (f"K5 {lab} with the witness",
                   f"K5 {lab} without the witness")
        row = {name: (min(times[(on, name)]) - min(times[(off, name)]),
                      statistics.median(times[(on, name)])
                      - statistics.median(times[(off, name)]))
               for name in ("against", "this")}
        print(f"[turns] K5 {lab}: the priority witness (row 9, the "
              f"difference of the minima; of the medians) " + ", ".join(
                  f"{name} {lo:.4f} ms ({med:.4f})"
                  for name, (lo, med) in row.items()), flush=True)
    rc = 0
    if k4_differs:
        print(f"scan_sections: K4's ptxas report differs from "
              f"{args.against}'s: {k4_differs}", file=sys.stderr)
        rc = 1
    if bad:
        print(f"scan_sections: outputs differ from {args.against}: "
              f"{sorted(set(bad))}", file=sys.stderr)
        return 1
    print(f"[turns] every output equal to {args.against}'s as uint32")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
