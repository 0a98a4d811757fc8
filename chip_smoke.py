#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (karpenter_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from karpenter_tpu_torch/csrc with nvcc, one
     process per source, all at once, and load the native host paths
     (kt_hostops, `make -s hostops` in native/): a missing extension
     fails the run with make's output, never falls back to the Python
     loops;
  3. each kernel against its plain PyTorch version on the card: K5 with
     the explain rows of its epilogue on seeded problems (light and
     topology) and on the encoded problems of the headline and config #3,
     K5 on seeded batches (a B=64 one with the explain counts, which must
     make one launch for its problems and their rows), K4's two lanes
     on seeded sweeps (exclusions, price caps, pool limits, strands, new
     nodes under N=8, the take_exist compaction on and off, up to 128
     domains) and on the first light chunk of config #4 and the first
     heavy chunk of config #4b, each K4 case on both carry routes (its own
     N, the carry in shared memory, and an N whose carry does not fit
     there, in device memory): flat result buffers must be equal as
     uint32, region by region, every case's explain counts must hold a
     nonzero, and the map cases together every class 1-4;
  4. the headline path: TorchSolver().solve(build_input(50_000)) — one
     cold and 20 warm solves through K5 and its explain epilogue — must
     give the JAX package's answer, with those launch counts above zero,
     and write one flight record a solve (utils/flightrecorder.py, on by
     default) with the JAX package's fingerprint (HEADLINE_FLIGHT); then
     the same in a child process with KARPENTER_TPU_NO_NATIVE=1 (the
     Python host paths), its encode and decode p50 printed beside the
     native ones;
  5. the config #3 path: TorchSolver().solve(build_config3()) — 10k pods
     with zone spread and hostname anti-affinity, one cold and 20 warm
     solves through K5 (its heavy step) and the epilogue — the same;
  6. the host oracle's paths: two small inputs that strand pods for the
     rescue or hold a group the encoding cannot express (the split path's
     nested device solve), each one cold and 20 warm solves — the JAX
     package's answer, the oracle taken, the kernels launched;
  7. the consolidation sweep: TorchSolver().solve_batch(build_config4(),
     max_nodes=8) and the same for build_config4b() — 2,000 simulations
     against 2,000 nodes, one cold and 5 warm sweeps each through K4 (the
     light lane; both lanes for #4b) — every simulation the JAX package's
     answer (a digest of the canonical results);
  8. gangs, priority bands and explain=full: TorchSolver(max_nodes=2048)
     .solve(build_config9()) through K5's gang instance and the
     epilogue, then
     build_config10() through K5 with the priority witness, the preemption
     planner attaching its plan, then build_config9() on a fresh solver
     under KARPENTER_TPU_EXPLAIN=full (the epilogue's class map and the
     reason
     trees), one cold and 20 warm solves each — the JAX package's answers,
     gang audit and plans, with the kernels launched;
  9. kernel timings at the main paths' shapes beside their bounds, each
     also as ms a scan step (kernel ms / G); K5, K6 and K7 with and
     without their explain rows in turns (the epilogue's cost: the
     headline, config #3, #9 with the map, #12's one program, K6 at #7's
     suffix and #12's chunk, K7 at #2's launch); K4 at each chunk shape
     (config #4's, #4b's and phase 19's first chunk of each size B), the
     profiler's and the CUDA events' ms a launch and its carry route;
     the sweep's dense against compacted take_exist rows; row 9, the
     priority witness (written in K5's steps), as K5 without and with
     its region over 8 turns a side at config #10 and at a G = 2048
     priority problem (`witness_problem`), its region held to the plain
     witness, beside `torch.cummax` of the masked row as a yardstick;
     row 5, the headline's one pinned upload copy, beside the rate of a
     256 MiB pinned copy; and an empty kernel's launch as the floor of
     them all (run after 10-12);
 10. the steady state, config #7: a delta-on TorchSolver(max_nodes=2048)
     and a delta-off one in lockstep over build_config7(gen) — gen 0, one
     warm pass, 16 timed churn passes — every pass the JAX package's
     answer (its digest), every timed pass a delta pass through K6;
 11. config #12: build_config12() (471,680 pods) on a spec-on and a
     spec-off solver (delta off in both), a cold and two warm passes — the
     JAX answer, the chain of 5 chunks through K6 (committed + repaired
     = 4);
 12. config #13 at 50k pods: the incremental index fed the churn as
     watch events against the walk, a cold pass, two warm ones and 8
     timed churn passes — every pass the JAX answer, index-resolved delta
     passes through K6;
 13. the column-sharded solve (slice 7): TorchSolver(mesh=8,
     max_nodes=256).solve(build_config2()) — BASELINE config #2 at 5k
     pods — through K7 (one cluster of 8 blocks, the explain counts in
     its epilogue) against mesh off (K5), one cold and 5 warm
     solves each: the JAX answer, and no column-axis transfer after the
     first solve (MeshExecutor.transfers);
 14. the 50k headline at mesh=8 (max_nodes 2048): the JAX answer;
 15. config #9 at mesh=8: K7's gang instance, the JAX answer and trees;
 16. config #7 at mesh=8, delta on, gen 0 and 4 churn passes: the chunk
     chain and the delta passes through K7's seeded instance, every pass
     the JAX answer;
 17. the soft-term input (workloads.build_soft_terms) through the
     relaxation loop, mesh off and mesh=8: the JAX answer;
 18. the provisioning control loop (workloads.provisioning_loop, run
     right after phase 2, before any other phase launches a kernel):
     the headline's 50k pods in the cluster store, one NodePool, the
     default NodeClass, the 605-type catalog through the fake cloud and
     the instance-type provider, GatedSolver on the card; the controller
     manager runs the provisioner, the NodeClaim lifecycle, the fake
     kubelet and the pod binder until idle, then again after 2,000 pods
     of the two smallest sizes arrive.  Each wave must give the JAX
     package's answer (LOOP: the launched instances, the pods bound per
     node, the hex price, the rounds) and record what the JAX loop's
     decision ledger and timeline recorded (LOOP_OBSERVED: the ledger's
     records by source, the hex sums of savings and added spend, the
     records' digest; the timeline's events by kind; the trajectory
     judges' verdict), with K5 and its explain epilogue launched, no
     oracle
     solve, no SolverFallback event and kt_hostops loaded.  One cold loop
     (in a child process that has launched nothing), one whose solver is
     warmed first as the provisioner's startup warm-up does — its first
     solve must meet zero first-use events (solver/firstuse.py) — and
     one more on a fresh cluster; wall time to idle and per round, the
     provisioner's spans, the controllers' times and the solve phases,
     with p50s;
 19. the disruption control loop (workloads.disruption_loop, run after
     phase 18): BASELINE config #4's fleet through the port's
     env.Environment on the card — the default NodeClass, a spot pool
     (weight 100, a cpu limit of half the fleet) and an on-demand pool,
     2,000 pods that each need a 16-vCPU node (wave 1, K5); every pod
     resized in place to 500m / 1Gi and the manager settled until a
     settle changes nothing (wave 2: multi-node prefixes on K5 at B=64
     and on K4, single-node sweeps on K4, Termination draining and the
     provisioner re-placing through K5); spot interruptions for a tenth
     of the spot nodes left (wave 3).  Each wave must give the JAX
     package's answer (DISRUPTION_LOOP: loop_answer and the disruption
     record) and what its ledger and timeline recorded
     (DISRUPTION_OBSERVED), K5 must launch at B=64 and K4 launch, with no
     oracle solve,
     no SolverFallback event and kt_hostops loaded.  One cold loop in a
     child process that has launched nothing and, beside it, the
     parent's loop whose solver is warmed first, each run whole (so each
     loop's host times count the other's host work too); per wave
     the wall time to idle, the ms a round and a disruption pass, the
     disruption.* spans, each controller's reconcile ms, solve_batch's
     calls, simulations (those K4's sweep answered) and phases, the
     launch shapes (B, G, E, N) of every K5 and K4 launch, and the
     first-use events of the first disruption pass;
 21. the column-sharded solve across cards (K7x, slice 7b; run within
     phase 3 and, for the cards, last): each K7x instance rehearsed on
     this card as one cooperative grid of S blocks (every rank's inbox
     in its memory) at S = 2 and 4 on phase 3's 32 seeded K7 problems
     and the headline's and config #2's encodings, each launched 3
     times, equal to its plain version as uint32 and holding its
     feature; K7x timed so at config #2, #9 and a seeded problem
     (profiler, events and the host's ms a launch); the stress case,
     CARD_STRESS launches back to back cycling the three instances
     (`_card_stress`: the inboxes rewound halfway, each launch equal to
     its plain version, one library call a launch); a launch after the
     fit check's occupancy query at a smaller shape still equal;
     mesh="auto" on one card must be the single-device path; a rank
     whose peer never comes must fail its launch at the exchange's
     deadline (`--child trap`); and on a host of two or more cards
     `--child cards` (below), whose numbers the kernels line then
     carries — on one card the line says the check needs two cards;
 20. the external cluster stores (run after phase 19): (a) a store daemon
     started as its own process (`python -m karpenter_tpu_torch.store
     <socket>`) and phase 18's loop at full scale with its cluster on a
     RemoteBackend to it — every wave LOOP and LOOP_OBSERVED, K5 and its
     epilogue launched, no oracle solve, no SolverFallback, kt_hostops
     loaded; the store round trips a wave and their ms beside phase 18's
     p50; the daemon stopped with SIGTERM and its exit code 0; (b) the
     kube list/watch store (FakeApiServer + HttpBackend) and the same loop
     at HTTP_LOOP_PODS + HTTP_LOOP_WAVE2 pods, held to the JAX loop
     through its own http store at that size (HTTP_LOOP,
     HTTP_LOOP_OBSERVED); each store's put timed over 200 puts first;
     (c) a GatedSolver on the card solving the headline's first 2,000
     pods twice under a one-shot `solver.dispatch` error
     (`faults.arm`, never the environment variable): the first solve
     launches nothing and raises FaultInjected, as every failure of the
     device solve does on the card (no oracle solve, no SolverFallback
     event; one fault.inject timeline event, the fault fired once), the
     second launches K5 and gives the JAX device answer
     (FAULT_SOLVES[1]); disarmed after;
 22. the operator's entry point (in child processes started beside
     phase 19, each ended before phase 3): (a) a
     store daemon in its own process loaded through a store client with
     the default NodeClass, the default pool (its consolidateAfter an
     hour: the operator runs the disruption controller too, which phase
     18's loop does not) and phase 18's 50,000 pods, then `python -m
     karpenter_tpu_torch` started on that store and a file lease with no
     platform variable, so on the card; every pod must bind and the store
     must hold LOOP's wave 1 (`workloads.store_answer`), the wave's
     flight record HEADLINE_FLIGHT (/debug/flight), /metrics the
     scheduling histogram and the replica's K5 and epilogue launches
     (`karpenter_tpu_solver_kernel_launches_total`), /healthz and /readyz
     "ok", /debug/ledger and /debug/timeline records; 2,000 more pods
     must give LOOP's wave 2; the replica spills its ledger
     (KARPENTER_TPU_LEDGER_DIR, its ring wide enough for every record),
     and `python -m karpenter_tpu_torch.tools.kt_ledger <spill> --json`
     must report its /debug/ledger summary's records by source, savings
     and added spend, hex for hex; SIGTERM must end the replica with exit
     code 0 within 15 s and its lease released; (b) tests/test_ha.py's
     two-replica layout on the card — a
     store daemon in its own process, one shared FakeCloud, two
     Operators, one file lease — the election made, the 50,000 pods
     created through the standby, the pair's loops started, and the
     leader killed without release (its store connection cut) once
     claims exist: never two leaders at once, every pod bound, none lost,
     the standby leading (the fleet, which depends on timing, printed);
 23. in a child process started beside phase 19: BASELINE config #11's
     rewind day (`workloads.build_rewind_day`, 6,422 events at 240 s
     ticks) through `RewindEngine(device="cuda",
     audit=True).run(driver="operator")`: every invariant of the config
     (ledger hex exactness, gang atomicity, no priority inversion, the
     shadow audit at rate 1 clean, no lost pod), every event applied, the
     crash tick's armed `solver.dispatch` error raised once on the card
     (one ReconcileError, no SolverFallback) and retried there; then
     `seek_check` on the manager driver at the day's midpoint,
     bit-identical.
 24. the solver service (slice 6b; in a child process started beside
     phase 19): kt_solverd (`make -s solverd` in native/) under
     `SolverdSupervisor`, always `--module karpenter_tpu_torch.service.
     backend`, on the card.  (a) each worker's seconds from spawn to its
     socket, its first answer and a warm `warmup` frame, its interpreter,
     torch, CUDA and card as it reports them over stats, and no jaxlib
     or libtpu in its /proc/<pid>/maps; (b) BASELINE config #8
     (`workloads.Config8Traffic`: 8 tenants, two closed-loop drivers
     each, 12 s an arm, the 12-type catalog, KARPENTER_TPU_MAX_NODES=128)
     with fusion on and off, each on its own worker: every request equal
     to a solo `TorchSolver(device="cuda", mesh="off", delta="off")`
     solve, tenant-0's warm steps `CONFIG8_PIN` (the JAX package's), none
     lost, K5 launched by the worker; throughput, per-tenant p50/p99,
     fleet p99, fused batch sizes, shed, the fused/unfused ratio; (c)
     phase 18's 50k + 2k loop with `Options(solver_endpoint=<the
     worker>)`: `LOOP` and `LOOP_OBSERVED`, K5 launched by the worker,
     the frames' bytes each way and each wave's time to idle beside the
     same loop in memory; (d) a worker armed with
     `KARPENTER_TPU_FAULTS=solverd.handle_batch=crash::1`: restarted by
     the supervisor, the client's retries give the pin; then the
     supervisor stopped, the breaker open, the degraded in-process
     `TorchSolver` on the card gives the pin with `SolverFallback`
     recorded and no oracle solve; the worker's exit code on SIGTERM and
     both processes' device memory.  `--child service` runs it alone.
 25. BASELINE configs #1, #6 and #13 at 1M pods and the operator's tools:
     (a) config #1 (workloads.build_config1: 100 identical pods over 30
     types) through K5 at B = 1, one cold and 20 warm solves: the JAX
     package's nodes, unschedulable, hex price and digest (CONFIG1);
     in child processes started beside phase 20 (`--child config6`,
     `config13-1m`, `tools`, each also runnable alone): (b) config #6 at
     15,000 queued interruption messages (workloads.build_config6) on an
     Environment on the card, drained by one interruption reconcile: the
     queue empty, claims deleted, offerings marked unavailable and the
     deleted names' digest the JAX package's (CONFIG6), the drain's
     seconds and msgs/s; (c) config #13 at 50k and then 1,000,000 pods in
     one process, each through phase 12's stories with the resident pods
     frozen in the collector before the timed passes, as its benchmark
     runs them: every generation CONFIG13 / CONFIG13_1M, every timed
     pass engaged with no fallback, the build seconds, peak RSS, both
     stories' p50 at both sizes, flat_ratio and walk_ratio (no limit);
     (d) `python -m karpenter_tpu_torch.tools.determinism` (exit 0), the
     same `--drill` (non-zero), `kt_rewind --generate smoke --seed 7
     --seek 40` (bit-identical, every invariant held, on the card) and
     `allocatable_diff` (exit 0), at once, each one's seconds printed.

Phase 3 also holds K5's gang instance, the witness and the epilogue's map
and with_gang class against their plain versions on seeded gang and priority
problems at B=1 and B>1 and on config #9's and #10's encodings, and K6
(the seeded scan) on seeded problems and on config #7's churned suffix,
the second chunk of config #7's delta-off chain and config #12's first
two chunks as the solver launches them; phase 19's own launches (its
warmed loop's first B=64 K5 launch of a multi-node pass, its first K4
chunk and a wave-2 re-placement K5 launch with E > 1,000); and K7
(the column-sharded scan) on seeded problems at 2, 4, 6 and 8 shards —
light, heavy, gang, priority, explain off, shards of padding blocks only,
a wide one and the seeded instance, each launched 3 times; the witness
region of every K5, K7 and K7x case that holds one also on its own,
`priority_witness` — and on the
headline's and config #2's encodings at 8 shards, printing
cudaOccupancyMaxActiveClusters by cluster size.  Phase 9 also times K7 at
2, 4 and 8 shards beside K5 and at the mesh phases' own launches, and K5
at config #12's one program as the spec-off arm launches it (G=2048
steps, 640 of them real), held once more against its plain version,
and the take_exist compaction of K4's epilogue as the difference of K4
with and without it in turns, beside its plain version and its bound.
The three recorders (flight, ledger, timeline) stay on, their defaults,
in every phase; each loop empties their rings first, as a fresh process
has them.  The fault registry stays disarmed outside phase 20(c).
The line before the card line is the kernels' JSON record; the last line
is {"ok": true, "device": {...}}.
Without a CUDA device it exits 2 and prints no result.  `--child MODE`
runs one of the phases above that need a process of their own; the
script starts those itself.  `--child entry` (phase 22(a)), `--child
ha` (22(b)) and `--child rewind` (23) run those phases alone, the kernels
and kt_hostops built first; `--child service` (24), `--child config6`
(25(b)), `--child config13-1m` (25(c)) and `--child tools` (25(d))
likewise; the main run starts the first four beside phase 19 and the
other three beside phase 20, and every child ends before phase 3 times a
kernel.
`--child cards` is the cross-card check,
run on a host of two or more cards (`python3 chip_smoke.py --child
cards` on a four-card host): every card's name and power limit, the
peer matrix and `nvidia-smi topo -m`; K7x at S = 2 (cards 0-1) and 4
against its plain version on phase 21's cases; the stress case across
four cards (host and events ms a launch); the headline, config #2
(also mesh off), #9, #7 (delta on) and the soft-term input under
mesh="auto" against their pins, the transfers log (no column-axis byte
after the first solve, each card holding only its slice) and every K7x
launch of those solves against its plain version; K7x timed in turns
beside K7 on one card and K5 at the headline and config #2, the cost of
one exchange round, and the NCCL yardstick; one JSON line last.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# The 50k headline's answer from the JAX package (karpenter_tpu TPUSolver,
# mesh/delta/spec/incr off, float32 on the CPU): 782 new nodes, none
# unschedulable, total price as a float hex string.
HEADLINE_PODS = 50_000
HEADLINE_NODES = 782
HEADLINE_UNSCHED = 0
HEADLINE_PRICE_HEX = "0x1.c192b9cb6848bp+12"
# the flight record of each headline solve: the JAX package's fingerprint
# of the encoded problem and the catalog's identity (`python3
# tests/test_torch_flight.py --pin` prints them)
HEADLINE_FLIGHT = {"fingerprint": "d27cc79ee16221df", "columns": 3630,
                   "price_sha": "22b4a4af1183e045"}
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
                                     ("ffd_batch_scan", "explain_pack")),
    # 50 plain pods and one pod spread over zone and capacity type (two
    # dynamic keys: inexpressible): the split path solves the 50 through
    # the scan and the one through the oracle
    "combined-mixed-residue-split": (1, 0, "0x1.8d0bb6ed67770p-2",
                                     ("ffd_batch_scan", "explain_pack")),
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
# BASELINE config #9 and #10 (benchmarks/config9_gang.py,
# config10_priority.py): the JAX package's answers (TPUSolver(max_nodes=
# 2048).solve(make_input()), default knobs, on the CPU) as (nodes,
# unschedulable, price, sha256 `result_digest` of the canonical result,
# `trees_digest` of the reason trees under the default explain=counts);
# config #9's stranded gangs; config #10's preemption plans as (plan id,
# targets, target priority, (victim unit, its pods)...); and for config
# #9 on a fresh solver under KARPENTER_TPU_EXPLAIN=full the sha256 of the
# cold solve's [G, O] class map as int8 and `trees_digest` of its reason
# trees
CONFIG_MAX_NODES = 2048
CONFIG9 = (4, 72, "0x1.023ffac1d29dcp+4",
           "dfcad7cca219ebb5e805268b29c7cb70f2b276f2391bdd91eea481e85320a3fb",
           "ab5d55181a7b096d0b79e830ffcaf7e76d0e9a987da28c964c675e106e55f1c9")
CONFIG9_STRANDED_GANGS = ("jumbo", "waiting")
CONFIG10 = (3, 1, "0x1.d2c100e6afccep+2",
            "cd5e8b393e4ec810ba013353dd6620c79caa835dd132cf0c52c1d400cf0a585c",
            "deb9239a9f536d3962cbacf72ce5d7daa2112c52c3db6f8dee97bbe6009632e3")
CONFIG10_PLANS = [("preempt-94fc1b355fb1", ("pin-hi",), 1000,
                   (("gang:ring", ("ring-0", "ring-1")),
                    ("low-edge", ("low-edge",))))]
CONFIG9_FULL_MAP = ("d34a0a3887865481acfbedd300bb90a2"
                    "538806bbcfe11f48063cec6e0bba18e2")
CONFIG9_FULL_TREES = ("469b1284358b3c50751f4e8f0a5e8443"
                      "10b6b5c009ac35d9c419b0d1b9c65b6b")

# The steady state (BASELINE config #7, #12 and #13: benchmarks/
# config7_churn.py, config12_megascale.py, config13_warm_million.py): the
# JAX package's answers (TPUSolver(max_nodes=2048, mesh="off"), default
# knobs, on the CPU; `tests/steady_state_answers.py` takes them) as the
# sha256 `result_digest` of the canonical result of each pass — config #7
# per churn generation 0..17 (269 nodes,
# 0x1.452396d0917d7p+9 every pass), config #13 at 50k pods per generation
# 0..10 (400 nodes, 0x1.9p+14), config #12's one cold fleet (640 nodes,
# 0x1.692e76c8b4395p+9)
CONFIG7 = (
    "d71f7c9c29c40dc80090458fcb08641431230334199f14a78ddc8d1adccffc83",
    "c45c73278488fd751b37e603d3dc804994f706fbb18604a1764d841f8a2393c5",
    "048d6cff9fc6799bc35d0a4a6d1ccd6f42ee2e513e7246cf3d0c69072905670c",
    "a8ec2302404b76a85f2693698540e4dd54bdfdade64570ce06e20571bb939443",
    "90198c5047eb50a01a419ea79e222a846cc8ff523179b5d5e955eb0caa6bd0dc",
    "fb7e9354028f54097639366945fc6278487defc19e5b7533447fcd6a77536b95",
    "5415bf384f2b16b36044abac45f28dc2366b8f26d45dcd6884b490cfa4078f9f",
    "286943806c1fb899a4fd3c2ef7334c5d212044772180346b7f4b758e7fe3579d",
    "895802467ea54ddb3aad889f2f3ef5a03391b82dead7f44c1a25122a15d0f691",
    "a26d8558fedb383d125c9b02f30107986b2e292f6bc1360d91fb4c5f1c2e35ee",
    "2e2a2c53bf36217c624bce0ce81edf400fb181ee58c71bfbfb7057458ed52f7c",
    "34ab69c36259c6177e6c8e34952963571de5fcc62350ef58f4ccf0806d21417f",
    "bc8310d9209f03c36bfe0d95396078d6187d99aff4df99bc46260e91ebd9ed6c",
    "f09faa6ceff4d7f4ee7661f2b8935310283db582fe637b63633228e22a52edc1",
    "2477ff99c7852040e82ae039179062eedfda2e4cd6a957f80c8df62a881f5878",
    "a42d8f1b618aa15dc001df1d5fe87f1c81d11b4ae78e6fa1be674ce75b84064c",
    "dfb01f8ec6bda131dc458b61b5807e2a9a73fde7cd83ed929ac3f0553a396411",
    "261c460478dcaf5f448276d2d3a2803e0923a2d43dde149f11c41707652b7bc5",
)
CONFIG7_TIMED = 16        # churn passes after gen 0 and one warm pass
CONFIG12 = "548186e9300c0fb12b678fff8de5a7fc0e1f9388fed1776961af240eb5f0c535"
CONFIG12_CHUNKS = 5
CONFIG13_PODS = 50_000    # config #13's first size (phase 12, 25(c))
CONFIG13 = (
    "250406d122cc0b889c267a867a5a0858c090bdfa017ef3901b1df9ea587d81ab",
    "f1ffe368eaa3b84729587634eef9570443460d00bfc41240805b7b91a370035e",
    "cdabb938a51bce6e695f710a7cd91019f29fab19f4cfae4eb6748ae5dedb1b40",
    "af1838785006c78e7b5b4332cdd228d9a40be1124d931756b097328db4dba3b1",
    "c60d13c6c33e04c2f867f8dd3e4871c274fb93cbb0b53c02bac91b144d6d0c1b",
    "607795e9d304adf16aae1b5c704f3400dfd0f34e692c0d5b731753be76271f71",
    "2f5df11d08e23359f93b06131069d823a99268cc221e1e951f02266960ee3d12",
    "fde9f204fea3ad99e4986983153fb00c604a54a7c4cb4d877f79ef97a1821199",
    "a3701995f710f907cd6a49ecd6adc42a197bc83575228429574dc49072939a3e",
    "6f5b2e35720f316bafe41b3df53a614530b9b05bdb206d583914d09f7389150c",
    "1ca0da542fe6c1d5272759230413f83dbd8fab9275751f43313b34b2a3d8c76c",
)
# config #13 at its published top size (`benchmarks/config13_warm_million.py`
# SIZES), per generation 0..10 (397 nodes, 0x1.8d00000000000p+14 every
# pass; `python3 tests/test_torch_configs.py --pin`, the JAX package's
# TPUSolver(max_nodes=2048, mesh="off") with its default knobs on the CPU)
CONFIG13_1M_PODS = 1_000_000
CONFIG13_1M = (
    "fbe68ded77c1665b6b57d15f03267b6057f4971af4dbdcbf1a4cd62b8ab0d69a",
    "ebd9f6f5b421836ef2c915e5403390487cda7572a4319d13fb2fab1fe5f3b4ee",
    "b214c787b3df9cd3632191cfd5b04dfc4f0f61be6116fb3014f418ef207f5aed",
    "8b0e8bd02177198594b61d1f5c1659c41cf8adaa6152e85bb0672ae71db56d25",
    "eb296b6190cdbbe0b63c351bcfb30f83813d6d7f4f3cd006924ce751a6b74e5c",
    "4d7e567ebf2acc6b935b723de03f95d7028aca55e710b65acd2a4b869a241d0e",
    "8e90abe24988e1e1e48ae302164dd555714bd94dec2a4a1869b430ffad7dc855",
    "87c73dccb8f892252e3629aad42a4ef6d19d9988ebc8b972f1cedbde6ea9338c",
    "c60795fdf6f6334004028e2b79151d82a81e02a2ae21eae915c39f8d1a63596f",
    "37c286230ae43a8ac69730f4fa69ecfde6191553660cf22bab48ace9c0517546",
    "53e41c4ade2ebe47d51b1fa9aaf5182e2d81f7d4caff32c35ee5fa77ac586459",
)
# BASELINE config #1 (`benchmarks/config1_inflate.py`, workloads.
# build_config1) on TorchSolver(): nodes, unschedulable, price hex,
# result_digest of the JAX answer (TPUSolver(mesh="off"), delta, spec and
# incr off, on the CPU; `tests/test_torch_configs.py --pin`)
CONFIG1 = (2, 0, "0x1.18b4395810625p+0",
           "99d9714704b5bade7d8447cfa7abdedbbdfa3768acb8796140f6f70eef2906ee")
# BASELINE config #6 (`benchmarks/config6_interruption.py`, workloads.
# build_config6) at the reference harness's 15,000 messages, drained by one
# interruption reconcile: claims deleted, offerings marked unavailable and
# `workloads.names_digest` of the deleted claims' names — the JAX package's
# environment's (`tests/test_torch_configs.py --pin`)
CONFIG6_MESSAGES = 15_000
CONFIG6 = (11_250, 6,
           "5565077b5c0eb5131e6cb8fc86055a8731ea0f9c9b3eeb51e8df9f84a0c9937b")
# The column-sharded solve (slice 7): BASELINE config #2 at 5k pods (the
# JAX package's `bench.py build_config2_5k`, the port's
# workloads.build_config2) on TorchSolver(max_nodes=256) — the JAX
# answer, TPUSolver(mesh="off", max_nodes=256) on the CPU: nodes,
# unschedulable, price hex, result_digest; and the soft-term input
# (workloads.build_soft_terms) on TorchSolver() — TPUSolver(mesh="off",
# delta/spec/incr off) on the CPU
CONFIG2 = (36, 0, "0x1.afd930be0ded2p+6",
           "3409b0bbe7c9a6c155cbd59c932c9df0e9ed6c6ed6f9dc92dab2605c73890d9a")
CONFIG2_MAX_NODES = 256
SOFT = (7, 0, "0x1.fa8255b035bd5p+3",
        "6a8a44848cafb5c5c217d9cea08a18ef2db7dc62e28224467963723a05d85c6e")
MESH = 8                  # the mesh arms' shard count
MESH_WARM = 5             # warm solves per mesh arm
SHARDS = (2, 4, 6, 8)     # K7 against its plain version at these sizes
WITNESS_TURNS = 8         # row 9's turns a side (phase 9)
WITNESS_SEED, WITNESS_G = 2048, 2048  # row 9's G = 2048 priority problem
UPLOAD_RATE_BYTES = 256 << 20  # the pinned copy that sets row 5's rate
K7_REPEATS = 3            # each K7 comparison launched this many times
CARD_SIZES = (2, 4)       # K7x's ranks in phase 21 and the card check
CARD_STRESS = 510         # K7x launches back to back in the stress case
MESH_CONFIG7_PASSES = 5   # config #7 under the mesh: gen 0 and 4 passes

# The provisioning control loop (phase 18): the headline's 50k pods
# through GatedSolver to launched nodes and bound pods, then 2,000 pods of
# its two smallest sizes.  The JAX package's answer to the same loop (its
# own controllers, cloud provider and stores on the CPU, solver mesh off;
# `python3 tests/test_torch_provisioning.py --pin` prints it), one dict
# per wave as `workloads.loop_answer` gives it
LOOP_PODS = 50_000
LOOP_WAVE2 = 2_000
LOOP_FRESH = 1            # loops on fresh clusters after the cold one
LOOP = (
    {"instances": 782, "instances_digest": "81ea05461e218a66",
     "price": "0x1.c192b9cb684b1p+12", "nodes": 782,
     "pods_per_node_digest": "e0a1832721c047fc", "bound": 50000,
     "unbound": 0, "rounds": 4},
    {"instances": 782, "instances_digest": "81ea05461e218a66",
     "price": "0x1.c192b9cb684b1p+12", "nodes": 782,
     "pods_per_node_digest": "0cd8fddd45301372", "bound": 52000,
     "unbound": 0, "rounds": 2},
)
# what the JAX loop's decision ledger and timeline recorded over each wave
# (`workloads.WaveObserver`: the ledger's records by source, the hex sums
# of their savings and added spend, the digest of the records; the
# timeline's events by kind; the trajectory judges' verdict), printed by
# the same `--pin`
_VERDICT = {"ledger_hex_exact": True, "zero_lost_pods": True,
            "zero_gang_atomicity_violations": True,
            "zero_priority_inversions": True, "audit_clean": True}
LOOP_OBSERVED = (
    {"ledger": {"records": {"provisioning": 1}, "savings": "0x0.0p+0",
                "added": "0x1.c192b9cb6848bp+12",
                "digest": "7adbe1e5510080f8"},
     "timeline": {"store.nodeclaims.added": 782,
                  "store.nodeclaims.modified": 2346,
                  "store.nodes.added": 782, "store.nodes.modified": 2346,
                  "store.pods.modified": 100000},
     "verdict": dict(_VERDICT, ledger_rows_checked=1)},
    {"ledger": {"records": {}, "savings": "0x0.0p+0", "added": "0x0.0p+0",
                "digest": "4f53cda18c2baa0c"},
     "timeline": {"store.pods.modified": 2000},
     "verdict": dict(_VERDICT, ledger_rows_checked=0)},
)

# The disruption control loop (phase 19): BASELINE config #4's fleet
# reached through the control plane (workloads.disruption_loop: the port's
# env.Environment, two weighted pools, 2,000 pods that each need a
# 16-vCPU node; then every pod resized to 500m / 1Gi and the fleet
# consolidated; then spot interruptions for a tenth of the spot nodes
# left).  The JAX package's answer to the same loop (its own Environment
# and controllers on the CPU, solver mesh off; `python3
# tests/test_torch_disruption.py --pin` prints it), one dict per wave in
# `disruption_pin`'s form: `workloads.loop_answer` and the disruption
# record, its acts as their count and digest
DISRUPTION_LOOP = (
    {"instances": 2000, "instances_digest": "b67499c3e92a3342",
     "price": "0x1.015826aa8eb56p+9", "nodes": 2000,
     "pods_per_node_digest": "2300d3b24bb5fa1b", "bound": 2000,
     "unbound": 0, "rounds": 4, "acts": 0,
     "acts_digest": "4f53cda18c2baa0c", "multi_node_acts": 0,
     "replacements": 0, "verdicts": {}, "retired": "0x0.0p+0",
     "added": "0x0.0p+0", "settles": 1, "settle_rounds": [4]},
    {"instances": 78, "instances_digest": "a01297a6d8cf9230",
     "price": "0x1.b0f6944673821p+3", "nodes": 78,
     "pods_per_node_digest": "603541f1d1df5ece", "bound": 2000,
     "unbound": 0, "rounds": 286, "acts": 169,
     "acts_digest": "cb92ed8624001872", "multi_node_acts": 88,
     "replacements": 48,
     "verdicts": {"Unconsolidatable:CandidateNotReschedulable": 59,
                  "Unconsolidatable:SpotFlexibilityTooLow": 19},
     "retired": "0x1.0181d49518312p+9", "added": "0x1.ede939eadd58dp+2",
     "settles": 4, "settle_rounds": [270, 11, 4, 1]},
    {"instances": 88, "instances_digest": "6e91ff9577f71dc8",
     "price": "0x1.99a0a52695968p+3", "nodes": 88,
     "pods_per_node_digest": "74d4b1a81d74b313", "bound": 2000,
     "unbound": 0, "rounds": 111, "acts": 32,
     "acts_digest": "e1fadc8caa6ad6ab", "multi_node_acts": 20,
     "replacements": 32,
     "verdicts": {"Unconsolidatable:SpotFlexibilityTooLow": 19},
     "retired": "0x1.0a7caea747d83p+3", "added": "0x1.c8b827fa1a0cep+1",
     "settles": 1, "settle_rounds": [111]},
)
# what the JAX loop's decision ledger and timeline recorded over each wave
# (`workloads.WaveObserver`, as LOOP_OBSERVED), printed by the same `--pin`
DISRUPTION_OBSERVED = (
    {"ledger": {"records": {"provisioning": 1}, "savings": "0x0.0p+0",
                "added": "0x1.015826aa8eb46p+9",
                "digest": "7e6dc03fa0d0ef51"},
     "timeline": {"price.refresh": 1, "store.nodeclaims.added": 2000,
                  "store.nodeclaims.modified": 6000,
                  "store.nodeclasses.modified": 2, "store.nodes.added": 2000,
                  "store.nodes.modified": 6000, "store.pods.modified": 4000},
     "verdict": dict(_VERDICT, ledger_rows_checked=1)},
    {"ledger": {"records": {"disruption": 169, "provisioning": 39,
                            "termination": 2010},
                "savings": "0x1.fb964840e1720p+8",
                "added": "0x1.7ff9f01b866e6p+2",
                "digest": "f6fed0f10fc60f30"},
     "timeline": {"store.nodeclaims.added": 88,
                  "store.nodeclaims.deleted": 2010,
                  "store.nodeclaims.deleting": 2010,
                  "store.nodeclaims.modified": 2274, "store.nodes.added": 88,
                  "store.nodes.deleted": 2010, "store.nodes.modified": 4284,
                  "store.pods.modified": 10720},
     "verdict": dict(_VERDICT, ledger_rows_checked=2218)},
    {"ledger": {"records": {"disruption": 32, "interruption": 8,
                            "provisioning": 28, "termination": 60},
                "savings": "0x1.950cb295e9e19p+2",
                "added": "0x1.55e963dc486acp+2",
                "digest": "ec524f125ff8e1da"},
     "timeline": {"spot.reclaim": 8, "store.nodeclaims.added": 70,
                  "store.nodeclaims.deleted": 60,
                  "store.nodeclaims.deleting": 60,
                  "store.nodeclaims.modified": 270, "store.nodes.added": 70,
                  "store.nodes.deleted": 60, "store.nodes.modified": 322,
                  "store.pods.modified": 3569},
     "verdict": dict(_VERDICT, ledger_rows_checked=128)},
)

# The external cluster stores (phase 20).  (a) The same loop at full
# scale through a store daemon in a process of its own
# (`python -m karpenter_tpu_torch.store`): it must give LOOP and
# LOOP_OBSERVED, which the JAX loop gives through its own daemon too
# (tests/test_torch_store.py).  (b) The loop through the kube list/watch
# store (FakeApiServer + HttpBackend) at a reduced size: wave 1 holds
# HTTP_LOOP_PODS of the headline's eight sizes and wave 2 HTTP_LOOP_WAVE2
# of its two smallest; the catalog and pool stay.  The size keeps every
# write of the loop inside the protocol's windows (HTTP_WINDOW retained
# events, as many own write ids), so the records cannot depend on how far
# the watch thread lags; the JAX pin through its own http store takes
# ~44 ms a request on a host whose loopback delays the ACK.  The JAX
# loop's answer and records at that size (`python3
# tests/test_torch_store.py --pin` prints them)
HTTP_LOOP_PODS = 1_024
HTTP_LOOP_WAVE2 = 128
HTTP_WINDOW = 4_096
HTTP_LOOP = (
    {"instances": 16, "instances_digest": "e19e9e008113c2c3",
     "price": "0x1.26b1c432ca57ap+7", "nodes": 16,
     "pods_per_node_digest": "e68c8fe2605958ff", "bound": 1024,
     "unbound": 0, "rounds": 4},
    {"instances": 16, "instances_digest": "e19e9e008113c2c3",
     "price": "0x1.26b1c432ca57ap+7", "nodes": 16,
     "pods_per_node_digest": "ee47ec64ded9dbc4", "bound": 1152,
     "unbound": 0, "rounds": 2},
)
HTTP_LOOP_OBSERVED = (
    {"ledger": {"records": {"provisioning": 1}, "savings": "0x0.0p+0",
                "added": "0x1.26b1c432ca57ap+7",
                "digest": "c961635a4f32bad2"},
     "timeline": {"store.nodeclaims.added": 16,
                  "store.nodeclaims.modified": 48, "store.nodes.added": 16,
                  "store.nodes.modified": 48, "store.pods.modified": 2048},
     "verdict": dict(_VERDICT, ledger_rows_checked=1)},
    {"ledger": {"records": {}, "savings": "0x0.0p+0", "added": "0x0.0p+0",
                "digest": "4f53cda18c2baa0c"},
     "timeline": {"store.pods.modified": 128},
     "verdict": dict(_VERDICT, ledger_rows_checked=0)},
)
STORE_PROBE_PUTS = 200    # sequential puts timed on each store first
# (c) GatedSolver under a one-shot `solver.dispatch` error, solving the
# headline's first FAULT_PODS pods twice.  The JAX package's answers to
# the two solves (nodes, unschedulable, hex price, `result_digest`): the
# first the oracle's (its SolverFallback route, which the port takes on
# the CPU), the second the device path's; tests/test_torch_faults.py holds
# the port on the CPU to both.  On the card the injected fault raises, and
# the second solve must give FAULT_SOLVES[1]
FAULT_PODS = 2_000
FAULT_SOLVES = (
    (32, 0, "0x1.1e4536501e258p+8",
     "7b4ba97a94c010c631f73005d4c425d3a7e3c207868e213e760c6e674847f573"),
    (32, 0, "0x1.1e4536501e258p+8",
     "735fc324c99c34c86b737765ca507aa759246912c5158380231f1d55f5cae8a7"),
)

# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes/s and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the kernels of karpenter_tpu_torch.solver.ffd: kernel -> (its wrapper,
# the wrapper's launch count); and the passes of the scans' epilogue —
# the priority witness, the explain counts (K5, K6 and K7) and the
# explain=2 map (K5) — as the launches that carried them, summed over the
# wrappers
KERNELS = {"ffd_batch_scan": ("batch_scan", "launches"),
           "ffd_batch_gang_scan": ("batch_scan", "gang_launches"),
           "ffd_sweep_scan": ("sweep_scan", "launches"),
           "ffd_sweep_topo_scan": ("sweep_topo_scan", "launches"),
           "ffd_delta_scan": ("delta_scan", "launches"),
           "ffd_sharded_scan": ("sharded_scan", "launches"),
           "ffd_sharded_gang_scan": ("sharded_scan", "gang_launches"),
           "ffd_sharded_delta_scan": ("sharded_scan", "delta_launches"),
           "ffd_card_scan": ("card_scan", "launches"),
           "ffd_card_gang_scan": ("card_scan", "gang_launches"),
           "ffd_card_delta_scan": ("card_scan", "delta_launches")}
PASSES = {"priority_witness": (("batch_scan", "witness_launches"),),
          "explain_pack": tuple((w, "explain_launches") for w in (
              "batch_scan", "delta_scan", "sharded_scan", "card_scan")),
          "explain_map": (("batch_scan", "map_launches"),)}


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


def result_digest(res) -> str:
    """sha256 of one result's canonical form."""
    import hashlib
    return hashlib.sha256(repr(sweep_canon(res)).encode()).hexdigest()


def trees_digest(res) -> str:
    """sha256 of the unschedulable pods' reason codes and reason trees
    (as sorted-key JSON), in pod order."""
    import hashlib
    rows = sorted((k, getattr(v, "code", None),
                   json.dumps(getattr(v, "tree", None), sort_keys=True,
                              default=str))
                  for k, v in res.unschedulable.items())
    return hashlib.sha256(repr(rows).encode()).hexdigest()


def plans_canon(res):
    """A result's preemption plans: (plan id, targets, target priority,
    (victim unit, its pods)...)."""
    return [(p.plan_id, tuple(p.target_pods), p.target_priority,
             tuple((u.name, tuple(u.pod_names)) for u in p.victims))
            for p in res.preemptions]


def map_digest(m) -> str:
    """sha256 of a [G, O] class map as int8."""
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(m).astype(np.int8)).tobytes()).hexdigest()


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
        ("batch-64-explain", 16, dict(topo, limits="finite"), 64, 64, 1,
         0),
    ]
    for label, seed, kw, B, N, ex, K in specs:
        probs, cat = random_batch(seed, B, **kw)
        yield label, probs, cat, N, ex, K


def _gang_cases():
    """(label, problems, catalog arrays, N, explain): seeded gang and
    priority-band problems — gangs over zones, capacity types and no
    domain, with and without existing nodes, finite pool budgets, tied
    ranks, slot exhaustion, the strided node and existing axes, 8
    domains, priority bands with strands — at B=1 and in batches, for
    K5's gang instance, the witness and the epilogue's map."""
    from karpenter_tpu_torch.solver.problems import random_batch
    g4 = dict(gang=True, D=4)
    specs = [
        ("gang-base", 11, g4, 1, 64, 2),
        ("gang-topo", 2, dict(g4, topology=True), 1, 64, 2),
        ("gang-no-existing", 3, dict(g4, E=0), 1, 64, 1),
        ("gang-3-pools-finite", 4, dict(g4, P=3, limits="finite"), 1, 64,
         2),
        ("gang-tied-ranks", 5, dict(g4, tied_ranks=True), 1, 64, 1),
        ("gang-slot-exhaustion", 6, g4, 1, 8, 2),
        ("gang-E2048", 8, dict(g4, E=2048, pod_scale=300), 1, 256, 1),
        ("gang-N2048", 9, dict(g4, G=16, PT=128, E=0, pod_scale=800), 1,
         2048, 2),
        ("gang-d8", 10, dict(g4, D=8, ZC=12, topology=True), 1, 64, 2),
        ("prio-gang-topo-finite", 7, dict(g4, topology=True, priority=True,
                                          limits="finite"), 1, 64, 2),
        ("prio-no-gang", 12, dict(priority=True, limits="finite",
                                  pod_scale=300), 1, 64, 1),
        ("gang-batch", 13, g4, 5, 64, 1),
        ("gang-prio-batch", 14, dict(g4, topology=True, priority=True,
                                     limits="finite"), 5, 64, 1),
        ("gang-batch-64", 15, dict(g4, pod_scale=30), 64, 32, 0),
    ]
    for label, seed, kw, B, N, ex in specs:
        probs, cat = random_batch(seed, B, **kw)
        yield label, probs, cat, N, ex


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


PACK_REGIONS = ("explain_counts", "explain_bits", "explain_map")
# phase 3's comparisons at the main paths' own encodings whose explain
# rows must hold a nonzero count (each has columns a class eliminates).
# Config #12's chunks and config #7's delta suffix (its four churned
# classes of 120-125m pods) are not among them: every column they admit
# fits their pods, no pool is budgeted and no class has a domain, so
# their counts are 0 by their data; K6's non-trivial case is the second
# chunk of config #7's chain, whose classes of up to 2.1 CPU do not fit
# every column.
EXPLAIN_NONTRIVIAL = frozenset((
    "headline", "config3-cold", "config3-warm", "config9-cold-full",
    "config9-warm", "config10-cold", "config10-warm-full",
    "batch-64-explain", "config7-chain-chunk1", "headline-S8",
    "config2-S8"))
# what the explain rows of the phase-3 comparisons held, one entry per
# comparison since `record` last drained it: (some count nonzero, the map
# classes the kernel wrote)
_EXPLAIN_SEEN = []


def _scan_regions(lay):
    """The regions of a flat row the scan's steps write (the epilogue's
    witness and explain rows are compared on their own)."""
    return [n for n in lay
            if n not in ("total", "prio_inv") + PACK_REGIONS]


def _explain_checks(fk, fp, lay):
    """{pass: (equal, max_abs_err)} of the explain rows of a kernel's flat
    rows `fk` against its plain version's `fp` — the counts and bits
    ("explain_pack"), the class map ("explain_map") — noting in
    `_EXPLAIN_SEEN` whether the kernel's rows are non-trivial."""
    from karpenter_tpu_torch.solver import ffd
    if "explain_counts" not in lay:
        return {}
    out = {"explain_pack": _merge([
        _diff(ffd._region(fk, lay, n), ffd._region(fp, lay, n))
        for n in ("explain_counts", "explain_bits")])}
    classes = set()
    if "explain_map" in lay:
        out["explain_map"] = _diff(ffd._region(fk, lay, "explain_map"),
                                   ffd._region(fp, lay, "explain_map"))
        classes = set(np.unique(ffd._region(fk, lay, "explain_map")
                                .detach().cpu().numpy()).astype(int).tolist())
    counts = ffd._region(fk, lay, "explain_counts")
    _EXPLAIN_SEEN.append((bool((counts != 0).any()), classes))
    return out


def _witness_checks(fk, fp, lay):
    """{"priority_witness": (equal, max_abs_err)} of the witness region of
    a kernel's flat rows `fk` against its plain version's `fp`, where the
    layout holds one (the scans write it in their steps), else {}."""
    from karpenter_tpu_torch.solver import ffd
    if "prio_inv" not in lay:
        return {}
    return {"priority_witness": _diff(ffd._region(fk, lay, "prio_inv"),
                                      ffd._region(fp, lay, "prio_inv"))}


def _buffers(B, P, lay, dev):
    import torch
    from karpenter_tpu_torch.solver import ffd
    return (torch.full((B, lay["total"][1]), float("nan"), device=dev),
            torch.full((B, P, ffd.R), float("nan"), device=dev))


def _compare_rows(name, fk, lk, fp, lp, lay):
    """{check: (equal, max_abs_err)} of a scan's rows against its plain
    version's: the scan's regions and final pool budgets, the explain rows
    of its epilogue, and the take_exist compaction's (count, index) head,
    each on its own."""
    from karpenter_tpu_torch.solver import ffd
    out = {name: _merge([_diff(ffd._region(fk, lay, n),
                               ffd._region(fp, lay, n))
                         for n in _scan_regions(lay)] + [_diff(lk, lp)])}
    out.update(_explain_checks(fk, fp, lay))
    if "te_cnt" in lay:
        out["te_compaction"] = _merge([
            _diff(ffd._region(fk, lay, n), ffd._region(fp, lay, n))
            for n in ("te_cnt", "te_idx")])
    return out


def compare_batch(ffd, b, c, N, ex, K, dev, wg=0, wp=0):
    """Run K5 (its gang instance with `wg`, the witness with `wp`, the
    explain rows with `ex`: the counts, with 2 the class map) and its
    plain version on the card on the same inputs: every region of the
    flat rows.  Returns {kernel or pass: (equal, max_abs_err)}."""
    import torch
    lay = ffd.flat_layout(b.G, b.E, N, b.D, ex, K, c.O, wp)
    fk, lk = _buffers(b.B, b.P, lay, dev)
    fp, lp = _buffers(b.B, b.P, lay, dev)
    ffd.batch_scan(b, c, N, fk, lay, lk, K, with_gang=wg)
    ffd.batch_scan_reference(b, c, N, fp, lay, lp, K, with_gang=wg)
    torch.cuda.synchronize()
    out = _compare_rows("ffd_batch_gang_scan" if wg else "ffd_batch_scan",
                        fk, lk, fp, lp, lay)
    out.update(_witness_checks(fk, fp, lay))
    return out


def _launches_of(ffd, fn):
    """The kernel and pass counts of one call of fn(), every count set to
    0 just before it."""
    import torch
    _reset_launches(ffd)
    fn()
    torch.cuda.synchronize()
    return _read_launches(ffd)


def _statics(probs):
    """(with_gang, with_priority) of problem tuples, as the solver derives
    them: a gang row set anywhere, an 18th slot."""
    return (int(any(np.asarray(p[14]).any() for p in probs)),
            int(any(len(p) > 17 for p in probs)))


def compare_case(ffd, prob, cat, N, ex, dev):
    """One problem tuple through K5 at B=1."""
    p, c = ffd.problem_from_numpy(prob, cat, dev)
    wg, wp = _statics([prob])
    return compare_batch(ffd, ffd.FFDBatch.of(p), c, N, ex, 0, dev, wg, wp)


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


def device_carry_n(ffd, sw, c, N, K) -> int:
    """The least N' = N * 2^k past which K4's carry no longer fits a
    block's shared memory (its device-memory route, `ffd.sweep_carry_fits`)."""
    n = N
    while ffd.sweep_carry_fits(sw.G, sw.E, n, c.PT, c.zc, sw.P,
                               sw.D if sw.heavy else 1, c.W, K, sw.heavy):
        n *= 2
    return n


def compare_sweep_routes(ffd, sw, c, N, K, dev):
    """K4 against its plain version on both carry routes: at N, and at
    `device_carry_n`'s N' (the device-memory carry).  Returns [(label
    suffix, {kernel: (equal, max_abs_err)}, N, route)]; a route other than
    its label says is a failed check."""
    out = []
    for suffix, n in (("", N), ("-device-carry", device_carry_n(
            ffd, sw, c, N, K))):
        fits = ffd.sweep_carry_fits(sw.G, sw.E, n, c.PT, c.zc, sw.P,
                                    sw.D if sw.heavy else 1, c.W, K,
                                    sw.heavy)
        res = compare_sweep(ffd, sw, c, n, K, dev)
        if fits != (suffix == ""):
            res = {k: (False, v[1]) for k, v in res.items()}
        out.append((suffix, res, n, "shared" if fits else "device"))
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


def _tag(topo: bool, sweep: bool, gang: bool, seed: bool = False,
         sharded: int = 0) -> str:
    """The trace's name of one instance of the templated scan kernel
    (`sharded` its transport: 0 none, 1 K7's cluster, 2 K7x's cards)."""
    flags = ", ".join("true" if f else "false"
                      for f in (topo, sweep, gang, seed))
    return f"scan_kernel<{flags}, {int(sharded)}>"


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


def _batch_bound(ffd, b, c, N, lay, flat, lim, wg=0, work=None):
    """K5's bound: inputs read once, outputs written once, over the HBM
    rate, against the float operations this run's data needs (counted by
    the plain version over the (node, block) pairs the kernel visits, and
    in the gang fill over every domain's candidate; `work`, a count the
    caller's plain run already made) over the fp32 rate."""
    import torch
    out = [ffd._region(flat, lay, n) for n in lay if n != "total"]
    fields = ["group_req", "group_count", "mask_bits", "exist_cap",
              "exist_remaining", "pool_limit", "group_ncap", "group_whole",
              "group_dsel", "group_dbase", "group_dcap", "group_skew",
              "group_mindom", "group_delig", "exist_zone", "exist_ct"]
    fields += ["group_gang"] if wg else []
    fields += ["group_prio"] if "prio_inv" in lay else []
    nbytes = (_nbytes(*(getattr(b, f) for f in fields))
              + _catalog_bytes(c) + _nbytes(lim, *out))
    if work is None:
        work = {"fit": 0, "test": 0, "flops": 0}
        ffd.batch_scan_reference(b, c, N, torch.empty_like(flat), lay,
                                 torch.empty_like(lim), 0, work,
                                 with_gang=wg)
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


def _epilogue_bound(ffd, p, c, lay, topo=True, wg=0):
    """The explain epilogue's own work (`explain_pack`): per group it reads
    its mask row, request, whole flag, unsched (and with `topo` its
    topology rows and dom_placed; with `wg` its gang row), per admitted
    block its allocatable, daemon and pool entries, the pools' final
    budgets and daemon rows, num_active, and writes the counts and bits,
    with a map row also the [G, O] map after reading each column's domain.
    Operations: a 3-term all-fits test (3 per resource) per group and
    pool, per group and admitted block, and with the map per admitted
    column, as this run's masks need."""
    R, G, D, P = ffd.R, p.G, p.D, p.P
    mask = ffd._unpack_bits(p.mask_bits, c.O).view(G, c.PT, c.zc)
    blocks, cols = int(mask.any(-1).sum()), int(mask.sum())
    emap = "explain_map" in lay
    nbytes = (G * (c.W + R + 3) * 4 + 4 + c.PT * (2 * R + 1) * 4
              + 2 * P * R * 4
              + (G * (3 * D + 3) * 4 + 2 * c.zc * 4 if topo else 0)
              + (G * 4 if wg else 0) + G * (ffd.EXPLAIN_C + 1) * 4
              + ((G * c.O + c.O) * 4 if emap else 0))
    ops = 3 * R * (G * P + blocks + (cols if emap else 0))
    return bound_ms(nbytes, ops)


def _epilogue_turns(launch, reps, tag):
    """A scan with and without its explain rows on identical inputs, in
    turns (without, with, with, without): ({"off": [profiler ms, ms],
    "on": [ms, ms]}, the events ms of the first launch with them).
    `launch(on)` launches it."""
    ms, ev = {"off": [], "on": []}, None
    for kind in ("off", "on", "on", "off"):
        t, e = _device_ms(lambda: launch(kind == "on"), reps, tag)
        ms[kind].append(t)
        if kind == "on" and ev is None:
            ev = e
    return ms, ev


def _epilogue_ms(turns):
    """The epilogue's cost from its turns: the difference of the minima."""
    return min(turns["on"]) - min(turns["off"])


def _turns_text(turns):
    return (f"with its explain rows " + ", ".join(
        f"{v:.4f}" for v in turns["on"]) + " ms, without " + ", ".join(
        f"{v:.4f}" for v in turns["off"]) + " ms (in turns): the epilogue "
        f"{_epilogue_ms(turns):.4f} ms")


def _epilogue_line(t):
    """A `_batch_times` record's epilogue, for a phase-9 line."""
    b, by = t["epi_bound"]
    return (_turns_text(t["turns"]) + f" (plain pack_reference "
            f"{t['epi_plain_ms']:.3f}, bound {b:.6f} by {by})")


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


def _counters():
    """{kernel or pass: ((wrapper, attribute), ...)} of every count."""
    return {**{k: (v,) for k, v in KERNELS.items()}, **PASSES}


def _reset_launches(ffd):
    for pairs in _counters().values():
        for w, attr in pairs:
            setattr(getattr(ffd, w), attr, 0)


def _read_launches(ffd):
    return {k: sum(getattr(getattr(ffd, w), attr) for w, attr in pairs)
            for k, pairs in _counters().items()}


def _main_path(solver_cls, build, ffd, card, label, warm=WARM_SOLVES,
               max_nodes=None, after_cold=None, p50=None):
    """One cold and `warm` warm runs of build() on a fresh solver —
    `solve`, or `solve_batch` under `max_nodes` — every kernel count set
    to 0 just before and read just after; `after_cold(solver)` runs
    between the cold run and the warm ones; `p50`, a dict, receives the
    warm e2e p50 ("e2e") and each phase's.  Returns (result, launches,
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
    if after_cold is not None:
        after_cold(solver)
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
    if p50 is not None:
        p50["e2e"] = statistics.median(e2e)
        p50.update({k: statistics.median(v) for k, v in phases.items()})
    print(f"[{label}] launches: {launches}; seams: delta "
          f"{solver.delta_passes} {solver.delta_fallbacks}, spec "
          f"{solver.spec_passes} {solver.spec_fallbacks}", flush=True)
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


def _flight_seq() -> int:
    from karpenter_tpu_torch.utils import flightrecorder
    return flightrecorder.RECORDER.last_seq() or 0


def _check_flight(seq0, solves, label, card):
    """The flight records written since the recorder's newest one was
    `seq0`: one for each of `solves` headline solves, each of kind
    "solve" with the pinned fingerprint and catalog identity and the
    JAX answer's digest."""
    from karpenter_tpu_torch.utils import flightrecorder
    rec = flightrecorder.RECORDER
    recs = [r for r in rec.tail(len(rec)) if r["seq"] > seq0]
    bad = []
    if len(recs) != solves:
        bad.append(f"{len(recs)} flight records for {solves} solves")
    for r in recs:
        got = {"fingerprint": r["fingerprint"],
               "columns": r["catalog"]["columns"],
               "price_sha": r["catalog"]["price_sha"]}
        if r["kind"] != "solve" or got != HEADLINE_FLIGHT:
            bad.append(f"flight record {r['seq']}: {r['kind']} {got} != "
                       f"{HEADLINE_FLIGHT}")
            break
        if r["result"]["price_hex"] != HEADLINE_PRICE_HEX:
            bad.append(f"flight record {r['seq']}: result {r['result']}")
            break
    last = recs[-1] if recs else {}
    print(f"[{label}] flight records on {card}: {len(recs)} for {solves} "
          f"solves; the last: fingerprint {last.get('fingerprint')}, "
          f"catalog {last.get('catalog')}, knobs {last.get('knobs')}, "
          f"first-use events (retraces) "
          f"{[r['retraces'] for r in recs][:3]}..., device memory peak "
          f"{last.get('device_memory_peak_bytes')} bytes", flush=True)
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


def _batch_times(ffd, b, c, N, reps, ex=1, wg=0, wp=0):
    """K5 at one batch's shapes (its gang instance with `wg`, the witness
    with `wp`) with and without its explain rows at level `ex`, in turns:
    {"ms": K5's profiler ms with them (the lower of two), "plain_ms",
    "ev_ms", "bound": (ms, by), "turns", "epi_ms": the epilogue's cost
    (the minima's difference), "epi_plain_ms": `pack_reference` on
    problem 0 on the card, "epi_bound": (ms, by)}."""
    import torch
    dev = b.group_req.device
    lays = {on: ffd.flat_layout(b.G, b.E, N, b.D, ex if on else 0, 0, c.O,
                                wp) for on in (False, True)}
    bufs = {on: (torch.empty((b.B, lay["total"][1]), device=dev),
                 torch.empty((b.B, b.P, ffd.R), device=dev))
            for on, lay in lays.items()}
    tag = _tag(True, False, bool(wg))

    def launch(on):
        flat_on, lim_on = bufs[on]
        ffd.batch_scan(b, c, N, flat_on, lays[on], lim_on, with_gang=wg)
    turns, ev_k = _epilogue_turns(launch, reps, tag)
    lay, (flat, lim) = lays[True], bufs[True]
    t_kp = _time_ms(lambda: ffd.batch_scan_reference(
        b, c, N, flat, lay, lim, with_gang=wg), 3)
    launch(True)
    torch.cuda.synchronize()
    p0 = b.at(0)
    f3 = flat[0].clone()
    t_ep = _time_ms(lambda: ffd.pack_reference(p0, c, N, f3, lay, lim[0],
                                               wg), 20)
    return {"ms": min(turns["on"]), "plain_ms": t_kp, "ev_ms": ev_k,
            "bound": _batch_bound(ffd, b, c, N, lay, flat, lim, wg),
            "turns": turns, "epi_ms": _epilogue_ms(turns),
            "epi_plain_ms": t_ep,
            "epi_bound": _epilogue_bound(ffd, p0, c, lay, True, wg)}


def _kept_batch_times(ffd, b, c, N, ex, K, wg, wp, reps):
    """(K5 ms, plain ms, events ms, bound) at one batch launch a loop made,
    its explain rows and compaction as the solver asked: kernel, then its
    plain version once on the same inputs."""
    import torch
    dev = b.group_req.device
    lay = ffd.flat_layout(b.G, b.E, N, b.D, ex, K, c.O, wp)
    flat = torch.empty((b.B, lay["total"][1]), device=dev)
    lim = torch.empty((b.B, b.P, ffd.R), device=dev)
    k = lambda: ffd.batch_scan(b, c, N, flat, lay, lim, K,  # noqa: E731
                               with_gang=wg)
    t_k, ev_k = _device_ms(k, reps, _tag(True, False, bool(wg)))
    t_kp = _time_ms(lambda: ffd.batch_scan_reference(
        b, c, N, flat, lay, lim, K, with_gang=wg), 1)
    work = {"fit": 0, "test": 0, "flops": 0}
    ffd.batch_scan_reference(b, c, N, flat, lay, lim, K, work, with_gang=wg)
    k()
    torch.cuda.synchronize()
    return t_k, t_kp, ev_k, _batch_bound(ffd, b, c, N, lay, flat, lim, wg,
                                         work)


def _witness_times(ffd, b, c, N, reps, turns=WITNESS_TURNS):
    """Row 9, the witness, at one batch's shapes: K5 without and with the
    witness region on identical inputs in rounds of (without, with, with,
    without), `turns` launches' profiler ms a side ({0: [...], 1: [...]});
    its cost, the difference of the two sides' minima; the witness region
    of the last launch held to the plain witness on the kernel's own
    strand rows ((equal, max_abs_err), every problem of the batch); the
    plain witness's ms; the yardstick, `torch.cummax` of the masked [G]
    int32 row on the card; and its bound (count, unsched and priority rows
    read, the witness row written)."""
    import torch
    dev = b.group_req.device
    out, bufs = {0: [], 1: []}, {}
    for wp in (0, 1):
        lay = ffd.flat_layout(b.G, b.E, N, b.D, 0, 0, c.O, wp)
        bufs[wp] = (lay, torch.empty((b.B, lay["total"][1]), device=dev),
                    torch.empty((b.B, b.P, ffd.R), device=dev))
    for _ in range(turns // 2):
        for wp in (0, 1, 1, 0):
            lay, flat, lim = bufs[wp]
            t, _ = _device_ms(
                lambda: ffd.batch_scan(b, c, N, flat, lay, lim), reps,
                _tag(True, False, False))
            out[wp].append(t)
    lay, flat, lim = bufs[1]
    torch.cuda.synchronize()
    unsched = ffd._region(flat, lay, "unsched").to(torch.int32)
    got = ffd._region(flat, lay, "prio_inv")
    want = torch.stack([ffd.priority_witness(
        b.group_count[i], unsched[i], b.group_prio[i]).to(torch.float32)
        for i in range(b.B)])
    check = _diff(got, want)
    t_plain = _time_ms(lambda: ffd.priority_witness(
        b.group_count[0], unsched[0], b.group_prio[0]), 20)
    masked = torch.where(unsched[0] > 0, b.group_prio[0],
                         torch.full_like(b.group_prio[0], -(2 ** 31) + 1))
    t_cummax = _time_ms(lambda: torch.cummax(masked, 0), 50)
    return {"turns": out, "ms": min(out[1]) - min(out[0]),
            "k5_ms": min(out[1]), "check": check, "plain_ms": t_plain,
            "cummax_ms": t_cummax, "bound": bound_ms(4 * 4 * b.G, 3 * b.G)}


def _witness_line(label, b, N, card, w):
    """A phase-9 line of `_witness_times`'s record `w`."""
    bnd, by = w["bound"]
    return (f"[9] {label} (B={b.B}, G={b.G}, N={N}) on {card}: "
            f"ffd_batch_scan with the witness " + ", ".join(
                f"{v:.4f}" for v in w["turns"][1]) + " ms, without "
            + ", ".join(f"{v:.4f}" for v in w["turns"][0])
            + f" ms (in turns): row 9 {w['ms']:.4f} ms (the difference of "
            f"the minima; of the medians "
            f"{statistics.median(w['turns'][1]) - statistics.median(w['turns'][0]):.4f}"
            f"; K5 with it {w['k5_ms']:.4f}); the witness region "
            f"{'equal to' if w['check'][0] else 'NOT equal to'} the plain "
            f"witness on the kernel's strand rows; plain witness "
            f"{w['plain_ms']:.4f} ms, torch.cummax of the masked row "
            f"{w['cummax_ms']:.4f} ms, bound {bnd:.8f} by {by}")


def witness_problem():
    """The G = 2048 priority-band problem row 9 is timed at besides config
    #10: gang-free and light (no topology rows), small groups on 256 node
    slots and mixed pool budgets, so that most groups place and about one
    in twenty strands (on the CPU: 1,924 groups place, 123 strand, 1,544
    flags).  (problem tuple, catalog arrays, N)."""
    from karpenter_tpu_torch.solver.problems import random_problem
    prob, cat = random_problem(WITNESS_SEED, G=WITNESS_G, priority=True,
                               limits="mixed", pod_scale=4)
    return prob, cat, 256


def _upload_times(ffd, prob, O, dev, reps=50):
    """Row 5, the coalesced upload, at one problem: the CUDA events' ms of
    its one pinned host->device copy (the int32 buffer `ffd._upload`
    ships; each copy between its own pair of events, the median and the
    minimum of `reps`), its bytes, and its bound: those bytes over the rate
    of a large pinned copy (UPLOAD_RATE_BYTES) on the same card.  Returns
    {"ms", "min_ms", "bytes", "bound_ms", "rate_gbs"}."""
    import torch
    parts = [np.ascontiguousarray(a).reshape(-1).view(np.int32)
             for a in ffd.problem_arrays(prob, O)]
    host = torch.from_numpy(np.concatenate(parts)).pin_memory()
    big = torch.empty(UPLOAD_RATE_BYTES // 4, dtype=torch.int32).pin_memory()

    def copies(src, n):
        dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
        dst.copy_(src, non_blocking=True)
        ts = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            z.record()
            z.synchronize()
            ts.append(a.elapsed_time(z))
        return ts
    small = copies(host, reps)
    rate = big.numel() * 4 / (min(copies(big, 5)) * 1e-3)
    nbytes = host.numel() * 4
    return {"ms": statistics.median(small), "min_ms": min(small),
            "bytes": nbytes, "bound_ms": nbytes / rate * 1e3,
            "rate_gbs": rate / 1e9}


def _route(ffd, sw, c, N, K) -> str:
    """K4's carry route at this chunk's shapes."""
    return "shared" if ffd.sweep_carry_fits(
        sw.G, sw.E, N, c.PT, c.zc, sw.P, sw.D if sw.heavy else 1, c.W, K,
        sw.heavy) else "device"


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
        tag = _tag(True, True, False)
    else:
        scan, plain = ffd.sweep_scan, ffd.sweep_scan_reference
        tag = _tag(False, True, False)
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


def _pack_times(ffd, sw, c, N, K, reps):
    """The take_exist compaction of K4's epilogue (row 3b) at one sweep
    chunk: the kernel with the dense and with the compacted rows in turns
    (dense, compacted, compacted, dense; profiler ms), the pack's cost the
    difference of their minima (it cannot launch alone); its plain
    version, `compact_take_exist`, on the chunk's dense rows; and the
    bound of that function (the dense rows read once, the (count, index)
    rows written once).  Returns {"turns", "ms", "plain_ms", "bound"}."""
    import torch
    dev = sw.group_req.device
    tag = _tag(bool(sw.heavy), True, False)
    scan = ffd.sweep_topo_scan if sw.heavy else ffd.sweep_scan
    bufs = {}
    for k in (0, K):
        lay = ffd.flat_layout(sw.G, sw.E, N, sw.D, 0, k)
        bufs[k] = (lay, torch.empty((sw.B, lay["total"][1]), device=dev),
                   torch.empty((sw.B, sw.P, ffd.R), device=dev))
    turns = {"dense": [], "compacted": []}
    for kind in ("dense", "compacted", "compacted", "dense"):
        k = K if kind == "compacted" else 0
        lay, flat, lim = bufs[k]
        turns[kind].append(_device_ms(
            lambda: scan(sw, c, N, flat, lay, lim, k), reps, tag)[0])
    lay, flat, lim = bufs[0]
    scan(sw, c, N, flat, lay, lim, 0)
    te = ffd._region(flat, lay, "take_exist").reshape(sw.B * sw.G, sw.E)
    te = te.contiguous()
    plain = _time_ms(lambda: ffd.compact_take_exist(te, K), 5)
    rows = sw.B * sw.G
    bound = bound_ms(rows * sw.E * 4 + 2 * rows * K * 4, rows * sw.E)
    return {"turns": turns, "ms": min(turns["compacted"])
            - min(turns["dense"]), "plain_ms": plain, "bound": bound}


def _delta_cases():
    """(label, problem tuple, catalog arrays, seed arrays, N, explain):
    seeded light problems for K6 — no seeded slot, a few, A_pad past A,
    A = N - 1, no existing nodes and 256 of them, finite pool budgets,
    slot exhaustion, the strided node axis (N > 1024), a wide catalog."""
    from karpenter_tpu_torch.solver.problems import random_delta_problem
    specs = [
        ("delta-a0", 0, 16, 64, 1, dict()),
        ("delta-few-slots", 5, 16, 64, 1, dict()),
        ("delta-a-pad-past-a", 17, 64, 64, 0, dict()),
        ("delta-a-n-minus-1", 63, 64, 64, 1, dict()),
        ("delta-e0", 10, 16, 64, 1, dict(E=0)),
        ("delta-e256", 12, 16, 64, 1, dict(E=256)),
        ("delta-explain-off", 8, 16, 64, 0, dict()),
        ("delta-3-pools-finite", 8, 16, 64, 1, dict(P=3, limits="finite")),
        ("delta-slot-exhaustion", 14, 16, 16, 1,
         dict(P=1, limits="none", pod_scale=300)),
        ("delta-strided-nodes", 1500, 2048, 2048, 1,
         dict(G=16, E=0, PT=128, pod_scale=3000)),
        ("delta-wide", 300, 1024, 1024, 1,
         dict(G=32, E=64, PT=640, pod_scale=200)),
    ]
    for i, (label, A, A_pad, N, ex, kw) in enumerate(specs):
        prob, cat, seeds = random_delta_problem(200 + i, A=A, A_pad=A_pad,
                                                N=N, **kw)
        yield label, prob, cat, seeds, N, ex


def compare_delta(ffd, p, sd, c, N, ex):
    """Run K6 (the explain counts with `ex`) and its plain version on the
    card on the same inputs.  Returns {kernel or pass: (equal,
    max_abs_err)}."""
    import torch
    dev = p.group_req.device
    lay = ffd.flat_layout(p.G, p.E, N, p.D, ex)
    fk, lk = (t[0] for t in _buffers(1, p.P, lay, dev))
    fp, lp = (t[0] for t in _buffers(1, p.P, lay, dev))
    ffd.delta_scan(p, sd, c, N, fk, lay, lk)
    ffd.delta_scan_reference(p, sd, c, N, fp, lay, lp)
    torch.cuda.synchronize()
    return _compare_rows("ffd_delta_scan", fk, lk, fp, lp, lay)


class _DeltaCapture:
    """Records the arguments of every seeded solve (`ffd.solve_ffd_delta`)
    the solver launches while active: (problem, seed, catalog, N,
    explain)."""

    def __init__(self, ffd):
        self.ffd, self.calls = ffd, []

    def __enter__(self):
        real = self.real = self.ffd.solve_ffd_delta

        def capture(p, sd, c, n, explain=0):
            self.calls.append((p, sd, c, n, explain))
            return real(p, sd, c, n, explain=explain)
        self.ffd.solve_ffd_delta = capture
        return self

    def __exit__(self, *exc):
        self.ffd.solve_ffd_delta = self.real


class _SolveCapture:
    """Records the arguments of every one-problem solve (`ffd.solve_ffd`)
    the solver launches while active: (problem, catalog, N, explain,
    with_gang, with_priority)."""

    def __init__(self, ffd):
        self.ffd, self.calls = ffd, []

    def __enter__(self):
        real = self.real = self.ffd.solve_ffd

        def capture(p, c, n, explain=0, with_gang=0, with_priority=0):
            self.calls.append((p, c, n, explain, with_gang, with_priority))
            return real(p, c, n, explain=explain, with_gang=with_gang,
                        with_priority=with_priority)
        self.ffd.solve_ffd = capture
        return self

    def __exit__(self, *exc):
        self.ffd.solve_ffd = self.real


def _captured_batch_times(ffd, call, reps):
    """K5 at one captured solve's launch, its explain rows as the solve
    asked: (kernel ms, plain ms, events ms, bound, {kernel: (equal, max abs
    err)}, the epilogue's turns or None).  With explain rows the kernel
    runs with and without them in turns (`_epilogue_turns`) and its ms is
    the lower time with them.  The plain version runs once, on the same
    inputs: its wall time, its work count for the bound, and its row and
    budgets held against the kernel's as uint32."""
    import torch
    p, c, N, ex, wg, wp = call
    b = ffd.FFDBatch.of(p)
    dev = p.group_req.device
    lays = {on: ffd.flat_layout(b.G, b.E, N, b.D, ex if on else 0, 0, c.O,
                                wp) for on in (False, True)}
    bufs = {on: _buffers(1, b.P, lays[on], dev) for on in (False, True)}
    lay, (fk, lk) = lays[True], bufs[True]
    fp, lp = _buffers(1, b.P, lay, dev)
    tag = _tag(True, False, bool(wg))

    def launch(on):
        flat_on, lim_on = bufs[on]
        ffd.batch_scan(b, c, N, flat_on, lays[on], lim_on, with_gang=wg)
    turns = None
    if ex:
        turns, ev_k = _epilogue_turns(launch, reps, tag)
        t_k = min(turns["on"])
    else:
        t_k, ev_k = _device_ms(lambda: launch(True), reps, tag)
    launch(True)
    torch.cuda.synchronize()
    work = {"fit": 0, "test": 0, "flops": 0}
    t0 = time.perf_counter()
    ffd.batch_scan_reference(b, c, N, fp, lay, lp, 0, work, with_gang=wg)
    torch.cuda.synchronize()
    t_kp = (time.perf_counter() - t0) * 1e3
    name = "ffd_batch_gang_scan" if wg else "ffd_batch_scan"
    res = _compare_rows(name, fk, lk, fp, lp, lay)
    return (t_k, t_kp, ev_k,
            _batch_bound(ffd, b, c, N, lay, fk, lk, wg, work), res, turns)


def _delta_bound(ffd, p, sd, c, N, lay, flat, lim):
    """K6's bound, counted as K5's: the problem, the seed and the catalog
    read once, the result row and pool budgets written once, against the
    float operations the plain version counts on this run's data."""
    import torch
    fields = ["group_req", "group_count", "mask_bits", "exist_cap",
              "exist_remaining", "pool_limit", "group_ncap", "group_whole",
              "exist_zone", "exist_ct"]
    out = [ffd._region(flat, lay, n) for n in lay if n != "total"]
    nbytes = (_nbytes(*(getattr(p, f) for f in fields))
              + _nbytes(sd.seed_used, sd.seed_pool, sd.seed_active,
                        sd.seed_colmask)
              + _catalog_bytes(c) + _nbytes(lim, *out))
    work = {"fit": 0, "test": 0, "flops": 0}
    ffd.delta_scan_reference(p, sd, c, N, torch.empty_like(flat), lay,
                             torch.empty_like(lim), work)
    return bound_ms(nbytes, _work_ops(work))


def _delta_times(ffd, call, reps):
    """K6 at one captured seeded solve's shapes, with and without the
    explain counts in turns: (K6 ms with them, the lower of two; plain ms,
    events ms, bound, the epilogue's turns, the epilogue's bound)."""
    import torch
    p, sd, c, N, _ = call
    dev = p.group_req.device
    lays = {on: ffd.flat_layout(p.G, p.E, N, p.D, int(on))
            for on in (False, True)}
    bufs = {on: (torch.empty(lays[on]["total"][1], device=dev),
                 torch.empty((p.P, ffd.R), device=dev))
            for on in (False, True)}
    tag = _tag(False, False, False, True)

    def launch(on):
        flat_on, lim_on = bufs[on]
        ffd.delta_scan(p, sd, c, N, flat_on, lays[on], lim_on)
    turns, ev_k = _epilogue_turns(launch, reps, tag)
    lay, (flat, lim) = lays[True], bufs[True]
    t_kp = _time_ms(lambda: ffd.delta_scan_reference(
        p, sd, c, N, flat, lay, lim), 1)
    launch(True)
    torch.cuda.synchronize()
    return (min(turns["on"]), t_kp, ev_k,
            _delta_bound(ffd, p, sd, c, N, lay, flat, lim), turns,
            _epilogue_bound(ffd, p, c, lay, topo=False))


# -- the column-sharded scan (K7) -------------------------------------------
def _features(prob, seeds):
    """What a problem tuple makes K7 run: "gang" rows (its gang instance),
    a "priority" row (the witness), "heavy" (topology) rows, a "seed" (its
    seeded instance)."""
    wg, wp = _statics([prob])
    return ({"gang"} if wg else set()) | ({"priority"} if wp else set()) \
        | ({"heavy"} if np.asarray(prob[7]).any() else set()) \
        | ({"seed"} if seeds is not None else set())


def _sharded_cases():
    """(label, S, problem tuple, catalog arrays, N, explain, seed arrays or
    None, the features the case must have): seeded problems on meshes of
    2, 4, 6 and 8 shards (PT = 96 for 6: 64 does not split in 6) — light,
    heavy, gang, priority, explain off, shards made only of padding
    blocks, a wide one, and the seeded (delta) scan.  A draw that lacks
    its label's feature (a "gang" problem with no gang row) is replaced by
    the next seed's."""
    from karpenter_tpu_torch.solver.problems import (random_delta_problem,
                                                     random_problem)

    def draw(make, base, want):
        for k in range(16):
            out = make(base + 1000 * k)
            if want <= _features(out[0], out[2] if len(out) > 2 else None):
                return out
        raise RuntimeError(f"no seed from {base} draws {want}")
    for S in SHARDS:
        PT = 96 if S == 6 else 64
        topo = dict(topology=True, D=4, PT=PT)
        pad = PT // 2 if S == 2 else 2 * (PT // S)
        specs = [
            ("light", dict(PT=PT), 64, 1, set()),
            ("heavy", topo, 64, 1, {"heavy"}),
            ("gang", dict(topo, gang=True), 64, 1, {"gang"}),
            ("priority", dict(PT=PT, priority=True, P=3, limits="finite"),
             64, 1, {"priority"}),
            ("explain-off", topo, 64, 0, {"heavy"}),
            ("padding-shards", dict(topo, pad_blocks=pad), 64, 1, {"heavy"}),
            ("wide", dict(topo, G=32, E=64, PT=6 * PT, P=2, pod_scale=200),
             1024, 1, {"heavy"}),
        ]
        for i, (label, kw, N, ex, want) in enumerate(specs):
            prob, cat = draw(lambda sd, kw=kw: random_problem(sd, **kw),
                             500 + 10 * S + i, want)
            yield f"S{S}-{label}", S, prob, cat, N, ex, None, want
        prob, cat, seeds = draw(lambda sd: random_delta_problem(
            sd, A=7, A_pad=16, N=64, PT=PT), 600 + S, {"seed"})
        yield f"S{S}-delta", S, prob, cat, 64, 1, seeds, {"seed"}


def _sharded_name(wg, seed):
    return ("ffd_sharded_delta_scan" if seed is not None
            else "ffd_sharded_gang_scan" if wg else "ffd_sharded_scan")


def compare_sharded(ffd, S, prob, cat, N, ex, seeds, dev,
                    want=frozenset()):
    """K7 on a mesh of S shards against its plain version on the card, on
    the same tensors: the whole flat row (the explain counts of its
    epilogue and the witness included) and the final pool budgets, equal
    as uint32 on each of K7_REPEATS launches.  Returns ({kernel: (equal,
    max_abs_err)}, the max active clusters of the launch, the features of
    `want` the problem lacks)."""
    import torch
    from karpenter_tpu_torch.parallel.mesh import shard_problem
    missing = set(want) - _features(prob, seeds)
    wg, wp = _statics([prob]) if seeds is None else (0, 0)
    if seeds is None:
        p, table, sc, _ = shard_problem(prob, cat, S, dev)
        sd = None
    else:
        p, sd, table, sc, _ = shard_problem(prob, cat, S, dev, seeds)
    lay = ffd.flat_layout(p.G, p.E, N, p.D, ex, with_priority=wp)
    clusters = ffd.sharded_clusters(p, table, sc, N, lay, wg, sd)
    fp = torch.full((lay["total"][1],), float("nan"), device=dev)
    lp = torch.full((p.P, ffd.R), float("nan"), device=dev)
    ffd.sharded_scan_reference(p, table, sc, N, fp, lay, lp, wg, sd)
    parts, out = [], {}
    for _ in range(K7_REPEATS):
        fk = torch.full_like(fp, float("nan"))
        lk = torch.full_like(lp, float("nan"))
        ffd.sharded_scan(p, table, sc, N, fk, lay, lk, wg, sd)
        torch.cuda.synchronize()
        parts += [_diff(fk, fp), _diff(lk, lp)]
    out[_sharded_name(wg, sd)] = _merge(parts)
    out.update(_explain_checks(fk, fp, lay))
    out.update(_witness_checks(fk, fp, lay))
    return out, clusters, missing


def compare_captured(ffd, call, flat_main):
    """One K7 launch the mesh path made, held to its plain version on the
    same tensors: the flat row the path itself got (`flat_main`), and a
    fresh launch's flat row and final pool budgets, equal as uint32.  (A
    captured launch's tensors stay as they were: each solve uploads its
    problem rows and seed into fresh device buffers, and the mask table
    only gains rows.)  Returns {kernel: (equal, max_abs_err)}."""
    import torch
    p, table, sc, N, ex, wg, wp, sd = call
    dev = table.device
    lay = ffd.flat_layout(p.G, p.E, N, p.D, ex, with_priority=wp)
    fp = torch.full((lay["total"][1],), float("nan"), device=dev)
    lp = torch.full((p.P, ffd.R), float("nan"), device=dev)
    ffd.sharded_scan_reference(p, table, sc, N, fp, lay, lp, wg, sd)
    fk = torch.full_like(fp, float("nan"))
    lk = torch.full_like(lp, float("nan"))
    ffd.sharded_scan(p, table, sc, N, fk, lay, lk, wg, sd)
    torch.cuda.synchronize()
    out = {_sharded_name(wg, sd): _merge(
        [_diff(flat_main, fp), _diff(fk, fp), _diff(lk, lp)])}
    out.update(_explain_checks(fk, fp, lay))
    out.update(_witness_checks(fk, fp, lay))
    return out


def _sharded_bound(ffd, p, table, sc, N, lay, flat, lim, wg=0, sd=None,
                   spread=1):
    """K7's bound, counted as K5's: the problem rows, the catalog shards,
    the mask-table rows the groups gather (and the seed) read once, the
    flat row and budgets written once, against the float operations this
    run's data needs (the plain version's count) over the fp32 rate; K7x
    (`spread` S cards) with both spread over its S cards."""
    import torch
    fields = ["group_req", "group_count", "mask_bits", "exist_cap",
              "exist_remaining", "pool_limit", "group_ncap", "group_whole",
              "exist_zone", "exist_ct"]
    if sd is None:
        fields += ["group_dsel", "group_dbase", "group_dcap", "group_skew",
                   "group_mindom", "group_delig"]
    fields += ["group_gang"] if wg else []
    fields += ["group_prio"] if "prio_inv" in lay else []
    rows = int(torch.unique(p.mask_bits).numel())
    nbytes = (_nbytes(*(getattr(p, f) for f in fields))
              + _nbytes(sc.col_alloc, sc.col_daemon, sc.pt_alloc,
                        sc.col_pool, sc.pool_daemon, sc.pool_bits,
                        sc.col_zone, sc.col_ct)
              + rows * sc.S * sc.W_s * 4 + _nbytes(lim, flat))
    if sd is not None:
        nbytes += _nbytes(sd.seed_used, sd.seed_pool, sd.seed_active,
                          sd.seed_colmask)
    work = {"fit": 0, "test": 0, "flops": 0}
    ffd.sharded_scan_reference(p, table, sc, N, torch.empty_like(flat), lay,
                               torch.empty_like(lim), wg, sd, work)
    return bound_ms(nbytes / spread, _work_ops(work) / spread)


def _sharded_times(ffd, prob, cat, S, N, reps, dev):
    """K7 at S shards on one problem tuple (explain=1): (profiler ms a
    launch, events ms, plain-version ms on the card, (bound, by), the
    clusters the card holds)."""
    import torch
    from karpenter_tpu_torch.parallel.mesh import shard_problem
    p, table, sc, _ = shard_problem(prob, cat, S, dev)
    wg, wp = _statics([prob])
    lay = ffd.flat_layout(p.G, p.E, N, p.D, 1, with_priority=wp)
    flat = torch.empty(lay["total"][1], device=dev)
    lim = torch.empty((p.P, ffd.R), device=dev)
    clusters = ffd.sharded_clusters(p, table, sc, N, lay, wg)

    def k7():
        ffd.sharded_scan(p, table, sc, N, flat, lay, lim, wg)
    t, ev = _device_ms(k7, reps, _tag(True, False, bool(wg), False, True))
    t_plain = _time_ms(lambda: ffd.sharded_scan_reference(
        p, table, sc, N, flat, lay, lim, wg), 1)
    bound = _sharded_bound(ffd, p, table, sc, N, lay, flat, lim, wg)
    return t, ev, t_plain, bound, clusters


class _MeshCapture:
    """Records every K7 launch the mesh executor makes while active: its
    arguments in `calls`, as (problem, table, catalog, N, explain,
    with_gang, with_priority, seed), and in `made` the phase it ran in
    (`phase`, set by the caller) and the flat row it returned."""

    def __enter__(self):
        from karpenter_tpu_torch.parallel.mesh import MeshExecutor
        self.cls, self.calls, self.made, self.phase = MeshExecutor, [], [], ""
        self.real = (MeshExecutor.solve, MeshExecutor.solve_delta)
        real_solve, real_delta = self.real

        def solve(ex, prob, table, cat, max_nodes, explain=0, with_gang=0,
                  with_priority=0):
            flat = real_solve(ex, prob, table, cat, max_nodes, explain,
                              with_gang, with_priority)
            self.calls.append((prob, table, cat, max_nodes, explain,
                               with_gang, with_priority, None))
            self.made.append((self.phase, flat))
            return flat

        def solve_delta(ex, prob, seed, table, cat, max_nodes, explain=0):
            flat = real_delta(ex, prob, seed, table, cat, max_nodes, explain)
            self.calls.append((prob, table, cat, max_nodes, explain, 0, 0,
                               seed))
            self.made.append((self.phase, flat))
            return flat
        MeshExecutor.solve, MeshExecutor.solve_delta = solve, solve_delta
        return self

    def __exit__(self, *exc):
        self.cls.solve, self.cls.solve_delta = self.real


def _captured_sharded_times(ffd, call, reps):
    """K7 at one captured launch's shapes: (profiler ms a launch, events
    ms, plain-version ms on the card, (bound, by), the epilogue's turns or
    None).  With explain rows the launch runs with and without them in
    turns and its ms is the lower time with them."""
    import torch
    p, table, sc, N, ex, wg, wp, sd = call
    lays = {on: ffd.flat_layout(p.G, p.E, N, p.D, ex if on else 0,
                                with_priority=wp) for on in (False, True)}
    bufs = {on: (torch.empty(lays[on]["total"][1], device=table.device),
                 torch.empty((p.P, ffd.R), device=table.device))
            for on in (False, True)}
    tag = _tag(sd is None, False, bool(wg), sd is not None, True)

    def launch(on):
        flat_on, lim_on = bufs[on]
        ffd.sharded_scan(p, table, sc, N, flat_on, lays[on], lim_on, wg, sd)
    turns = None
    if ex:
        turns, ev = _epilogue_turns(launch, reps, tag)
        t = min(turns["on"])
    else:
        t, ev = _device_ms(lambda: launch(True), reps, tag)
    lay, (flat, lim) = lays[True], bufs[True]
    t_plain = _time_ms(lambda: ffd.sharded_scan_reference(
        p, table, sc, N, flat, lay, lim, wg, sd), 1)
    return t, ev, t_plain, _sharded_bound(ffd, p, table, sc, N, lay, flat,
                                          lim, wg, sd), turns


# -- the column-sharded solve across cards (K7x): phase 21, --child cards
def _card_name(wg, seed):
    return ("ffd_card_delta_scan" if seed is not None
            else "ffd_card_gang_scan" if wg else "ffd_card_scan")


def _card_cases(encoded):
    """(label, S, problem tuple, catalog arrays, N, explain, seed arrays or
    None, the features it must hold): the 32 seeded problems of phase 3's
    K7 check (`_sharded_cases`) and the encodings `encoded` ({name:
    (problem, catalog, N)}), each at S = 2 and 4 ranks."""
    cases = [(label, prob, cat, N, ex, seeds, want) for
             label, _, prob, cat, N, ex, seeds, want in _sharded_cases()]
    cases += [(name, prob, cat, N, 1, None, set())
              for name, (prob, cat, N) in encoded.items()]
    for label, prob, cat, N, ex, seeds, want in cases:
        for S in CARD_SIZES:
            yield f"{label}@{S}", S, prob, cat, N, ex, seeds, want


class _Cards:
    """K7x on one problem over `devices`: S distinct cards (`card_scan`,
    one rank a card), or one card S times (`card_scan_rehearsal`, one
    cooperative grid of S blocks on K7's layout); and its plain version's
    arguments, the same shards stacked on the first card."""

    def __init__(self, ffd, S, prob, cat, N, ex, seeds, devices):
        import torch
        from karpenter_tpu_torch.parallel.mesh import (card_mesh, make_mesh,
                                                       shard_problem)
        self.ffd, self.N, self.S = ffd, N, S
        self.devices = tuple(devices)
        self.wg, wp = _statics([prob]) if seeds is None else (0, 0)
        self.rehearse = len(set(self.devices)) == 1
        dev = self.devices[0]
        mesh = make_mesh(S, dev) if self.rehearse else card_mesh(devices)
        if seeds is None:
            p, table, sc, _ = shard_problem(prob, cat, mesh)
            sd = None
        else:
            p, sd, table, sc, _ = shard_problem(prob, cat, mesh, seed=seeds)
        self.args = (p, table, sc, sd)
        if self.rehearse:
            self.ref = self.args
        else:
            sd0 = None if sd is None else ffd.DeltaSeed(
                sd[0].seed_used, sd[0].seed_pool, sd[0].seed_active,
                torch.stack([x.seed_colmask.to(dev) for x in sd]))
            self.ref = (p[0], torch.stack([t.to(dev) for t in table]),
                        sc.stacked(dev), sd0)
        p0 = self.ref[0]
        self.lay = ffd.flat_layout(p0.G, p0.E, N, p0.D, ex,
                                   with_priority=wp)
        self.name = _card_name(self.wg, sd)
        self.shape = (S, p0.G, p0.E, N, self.ref[2].O)
        self.plan = None  # card_scan's CardLaunch, from the first launch

    def bufs(self):
        import torch
        dev = self.devices[0]
        p0 = self.ref[0]
        return (torch.full((self.lay["total"][1],), float("nan"),
                           device=dev),
                torch.full((p0.P, self.ffd.R), float("nan"), device=dev))

    def launch(self, flat, lim):
        p, table, sc, sd = self.args
        if self.rehearse:
            self.ffd.card_scan_rehearsal(p, table, sc, self.N, flat,
                                         self.lay, lim, self.wg, sd)
        else:
            self.plan = self.ffd.card_scan(p, table, sc, self.N, flat,
                                           self.lay, lim, self.wg, sd,
                                           plan=self.plan)

    def plain(self, flat, lim):
        p, table, sc, sd = self.ref
        self.ffd.sharded_scan_reference(p, table, sc, self.N, flat, self.lay,
                                        lim, self.wg, sd)

    def sync(self):
        import torch
        for d in set(self.devices):
            torch.cuda.synchronize(d)

    def bound(self):
        p, table, sc, sd = self.ref
        flat, lim = self.bufs()
        return _sharded_bound(self.ffd, p, table, sc, self.N, self.lay, flat,
                              lim, self.wg, sd,
                              spread=1 if self.rehearse else self.S)

    def times(self, reps):
        """(the profiler's mean time of a rank's kernel, events ms a launch
        on the first card, whose stream each launch ties every rank back
        into, and the host's ms a launch: the wrapper's call, every rank
        enqueued)."""
        flat, lim = self.bufs()
        seed = self.args[3] is not None
        ms, ev = _device_ms(lambda: self.launch(flat, lim), reps,
                            _tag(not seed, False, bool(self.wg), seed, 2))
        return ms, ev, _host_ms(lambda: self.launch(flat, lim), reps,
                                self.devices)


def _host_ms(fn, reps, devices):
    """The host's mean ms a call of fn() over `reps` calls made back to
    back (every device synchronised before, and after the clock stops)."""
    import torch
    for d in set(devices):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    for d in set(devices):
        torch.cuda.synchronize(d)
    return t


def _card_stress(ffd, devices):
    """K7x at S = len(devices) ranks (S distinct cards, or one card S times:
    the rehearsal), CARD_STRESS launches back to back, cycling the three
    instances on phase 3's seeded S = 4 problems (heavy rows with the
    explain counts, the gang instance, the seeded one), in two halves with
    every inbox zeroed between them (`CardExchange.rewind`), each launch's
    rows and budgets then held to its instance's plain version as uint32.
    Returns (what failed, {"launches", "library_calls", "host_ms" and
    "events_ms" a launch, "rounds" of the first half, "max_abs_err"})."""
    import torch
    cases = {c[0]: c for c in _sharded_cases()}
    cards = [_Cards(ffd, len(devices), *cases[k][2:7], devices)
             for k in ("S4-heavy", "S4-gang", "S4-delta")]
    plain = []
    for c in cards:
        fp, lp = c.bufs()
        c.plain(fp, lp)
        c.launch(*c.bufs())  # its launch configuration, built
        plain.append((fp, lp))
    rehearse = cards[0].rehearse
    wrap = ffd.card_scan_rehearsal if rehearse else ffd.card_scan

    def launched():
        return (wrap.launches if rehearse else wrap.launches
                + wrap.gang_launches + wrap.delta_launches)
    xch = ffd.card_exchange(devices)
    outs = [cards[i % 3].bufs() for i in range(CARD_STRESS)]
    n0, calls0 = launched(), wrap.library_calls
    host = ev = 0.0
    rounds = None
    half = CARD_STRESS // 2
    for lo, hi in ((0, half), (half, CARD_STRESS)):
        for d in set(devices):
            torch.cuda.synchronize(d)
        r0 = xch.rounds()
        with torch.cuda.device(devices[0]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            for i in range(lo, hi):
                cards[i % 3].launch(*outs[i])
            host += time.perf_counter() - t0
            b.record()
        b.synchronize()
        for d in set(devices):
            torch.cuda.synchronize(d)
        ev += a.elapsed_time(b)
        if rounds is None:
            rounds = xch.rounds() - r0
            xch.rewind()
    bad, parts = [], []
    for i, (fk, lk) in enumerate(outs):
        fp, lp = plain[i % 3]
        d = [_diff(fk, fp), _diff(lk, lp)]
        parts += d
        if not all(eq for eq, _ in d):
            bad.append(f"stress launch {i} ({cards[i % 3].name}) differs")
    n, calls = launched() - n0, wrap.library_calls - calls0
    if n != CARD_STRESS or calls != n:
        bad.append(f"stress: {n} launches counted, {calls} library calls, "
                   f"for {CARD_STRESS}")
    return bad[:8], {"launches": n, "library_calls": calls,
                     "host_ms": host * 1e3 / CARD_STRESS,
                     "events_ms": ev / CARD_STRESS, "rounds": rounds,
                     "rewinds": xch.rewinds,
                     "max_abs_err": _merge(parts)[1]}


def _span_ms(fn, reps, devices):
    """Mean time of fn() over `reps` calls, by CUDA events on the first
    of `devices`, every device synchronised before and after (one warm-up
    call first)."""
    import torch
    fn()
    for d in set(devices):
        torch.cuda.synchronize(d)
    with torch.cuda.device(devices[0]):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
    for d in set(devices):
        torch.cuda.synchronize(d)
    return a.elapsed_time(b) / reps


def compare_cards(ffd, S, prob, cat, N, ex, seeds, devices,
                  want=frozenset()):
    """K7x over `devices` against its plain version on the same shards
    (stacked on the first card): the whole flat row (the explain counts
    of its epilogue and the witness included) and the final pool budgets,
    equal as uint32 on each of K7_REPEATS launches.  Returns ({kernel:
    (equal, max_abs_err)}, the features of `want` the problem lacks)."""
    missing = set(want) - _features(prob, seeds)
    c = _Cards(ffd, S, prob, cat, N, ex, seeds, devices)
    fp, lp = c.bufs()
    c.plain(fp, lp)
    parts = []
    for _ in range(K7_REPEATS):
        fk, lk = c.bufs()
        c.launch(fk, lk)
        c.sync()
        parts += [_diff(fk, fp), _diff(lk, lp)]
    out = {c.name: _merge(parts)}
    out.update(_explain_checks(fk, fp, c.lay))
    out.update(_witness_checks(fk, fp, c.lay))
    return out, missing


def _p50(xs):
    return statistics.median(xs) if xs else float("nan")


def _lockstep(ffd, label, arms, inputs, digests, card, feed=None,
              timed_from=0, at_timed=None):
    """Solve each input (inputs[i] answers digests[i]) on every solver of
    `arms` ({name: solver}) in turn; `feed(name, solver, i)` delivers the
    pass's watch events first, `at_timed()` runs once before the first
    timed pass's input is built.  Returns ({arm: [e2e ms of the timed
    passes]}, {arm: {phase: [ms]}}, {arm: [per-pass verdicts]}, {arm:
    [K6 launches of each pass]}, problems): every arm's canonical result
    must equal the pinned JAX answer."""
    import torch
    ms = {a: [] for a in arms}
    phases = {a: {} for a in arms}
    verdicts = {a: [] for a in arms}
    k6 = {a: [] for a in arms}
    bad = []
    for i, build in enumerate(inputs):
        if i == timed_from and at_timed is not None:
            at_timed()
        inp = build()
        for name, solver in arms.items():
            k0 = ffd.delta_scan.launches
            t0 = time.perf_counter()
            if feed is not None:
                feed(name, solver, i)
            res = solver.solve(inp)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            k6[name].append(ffd.delta_scan.launches - k0)
            got = result_digest(res)
            if got != digests[i]:
                bad.append(f"{name} pass {i}: digest {got[:16]} != "
                           f"{digests[i][:16]}")
            cache = solver._delta_cache
            verdicts[name].append((cache.last_outcome, cache.last_reason,
                                   cache.last_incr_reason,
                                   None if solver.last_spec is None else
                                   dict(solver.last_spec)))
            if i >= timed_from:
                ms[name].append(dt)
                for k, v in solver.last_phase_ms.items():
                    phases[name].setdefault(k, []).append(v)
        if i == 0:
            print(f"[{label}] {res.node_count()} nodes, "
                  f"{len(res.unschedulable)} unschedulable, price "
                  f"{res.total_price().hex()} on {card}", flush=True)
    return ms, phases, verdicts, k6, bad


def _report(label, ms, phases, verdicts, k6):
    for name, xs in ms.items():
        if xs:
            print(f"[{label}] {name}: p50 {_p50(xs):.3f} ms over "
                  f"{len(xs)} passes (min {min(xs):.3f}, max "
                  f"{max(xs):.3f})", flush=True)
            print(f"[{label}] {name} phase p50 ms: " + ", ".join(
                f"{k} {_p50(v):.3f}" for k, v in phases[name].items()),
                flush=True)
        print(f"[{label}] {name} per pass (delta outcome, reason, incr "
              f"reason, K6 launches): " + str(
                  [v[:3] + (n,) for v, n in zip(verdicts[name],
                                                k6[name])]), flush=True)
        specs = {str(v[3]) for v in verdicts[name]}
        print(f"[{label}] {name} last_spec seen: {sorted(specs)}",
              flush=True)


def _config7(ffd, card, TorchSolver, build_config7):
    """Config #7: a delta-on solver and a delta-off one in lockstep over
    gen 0, one warm pass and the timed churn passes; returns (launches,
    problems)."""
    import torch
    on = TorchSolver(max_nodes=CONFIG_MAX_NODES)
    off = TorchSolver(max_nodes=CONFIG_MAX_NODES, delta="off")
    n = 2 + CONFIG7_TIMED
    _reset_launches(ffd)
    ms, phases, verdicts, k6, bad = _lockstep(
        ffd, "10 config7", {"delta-on": on, "delta-off": off},
        [lambda g=g: build_config7(g) for g in range(n)], CONFIG7[:n],
        card, timed_from=2)
    torch.cuda.synchronize()
    launches = _read_launches(ffd)
    _report("10 config7", ms, phases, verdicts, k6)
    if any(v[0] != "delta" for v in verdicts["delta-on"][1:]):
        bad.append("a delta-on pass after gen 0 did not engage")
    if min(k6["delta-on"][1:]) < 1:
        bad.append(f"a delta pass launched no K6: {k6['delta-on']}")
    if on.delta_passes.get("fallback", 0) != 1:
        bad.append(f"delta-on fallbacks {on.delta_fallbacks} (only gen "
                   f"0's cold one expected)")
    if off.delta_passes:
        bad.append(f"the delta-off arm crossed the seam: {off.delta_passes}")
    print(f"[10 config7] launches {launches}; delta-on passes "
          f"{on.delta_passes}, fallbacks {on.delta_fallbacks}; reencoded "
          f"{on._delta_cache.last_reencoded}, reuse "
          f"{on._delta_cache.last_reuse}; K6 launches of the timed delta "
          f"passes {sum(k6['delta-on'][2:])}", flush=True)
    return launches, bad


def _config12(ffd, card, TorchSolver, build_config12):
    """Config #12: a spec-on solver and a spec-off one (delta off in
    both) over one cold and two warm passes of 471,680 pods; returns
    (launches, problems)."""
    import torch
    on = TorchSolver(max_nodes=CONFIG_MAX_NODES, delta="off", spec="on")
    off = TorchSolver(max_nodes=CONFIG_MAX_NODES, delta="off", spec="off")
    _reset_launches(ffd)
    ms, phases, verdicts, k6, bad = _lockstep(
        ffd, "11 config12", {"spec-on": on, "spec-off": off},
        [build_config12] * 3, [CONFIG12] * 3, card, timed_from=1)
    torch.cuda.synchronize()
    launches = _read_launches(ffd)
    _report("11 config12", ms, phases, verdicts, k6)
    for i, v in enumerate(verdicts["spec-on"]):
        sp = v[3] or {}
        if (sp.get("outcome") != "spec"
                or sp.get("chunks") != CONFIG12_CHUNKS
                or sp.get("committed", 0) + sp.get("repaired", 0)
                != CONFIG12_CHUNKS - 1):
            bad.append(f"spec-on pass {i}: {sp}")
    if off.spec_passes:
        bad.append(f"the spec-off arm crossed the seam: {off.spec_passes}")
    print(f"[11 config12] launches {launches}; spec passes "
          f"{on.spec_passes}, chunks {on.spec_chunks}", flush=True)
    for k in ("ffd_delta_scan", "ffd_batch_scan"):
        if launches[k] <= 0:
            bad.append(f"kernel {k} was not launched on the main path")
    return launches, bad


def _config13(ffd, card, TorchSolver, build_config13,
              n_pods=CONFIG13_PODS, pins=CONFIG13, label="12 config13",
              freeze=False):
    """Config #13 at `n_pods`: the incremental index (fed the churn as
    watch events) against the walk, delta auto in both, over a cold
    pass, two warm ones and 8 timed churn passes, every pass the pinned
    digest (`pins`); `freeze` moves the resident pods to the collector's
    permanent generation before the timed passes, as the benchmark does
    (`benchmarks/config13_warm_million.py`).  Returns (launches,
    problems, {story: timed e2e p50 ms})."""
    import gc

    import torch
    on = TorchSolver(max_nodes=CONFIG_MAX_NODES, spec="off", incr="on")
    walk = TorchSolver(max_nodes=CONFIG_MAX_NODES, spec="off", incr="off")
    n = len(pins)
    timed_from = 3
    events = {}

    def build(g):
        inp, ev = build_config13(n_pods, g)
        events[g] = ev
        return inp

    def feed(name, solver, i):
        if name == "incr" and events.get(i):
            solver.delta_invalidate(pods=tuple(events[i]),
                                    pod_objs=events[i])

    def at_timed():
        gc.collect()
        gc.freeze()

    _reset_launches(ffd)
    try:
        ms, phases, verdicts, k6, bad = _lockstep(
            ffd, label, {"incr": on, "walk": walk},
            [lambda g=g: build(g) for g in range(n)], pins, card,
            feed=feed, timed_from=timed_from,
            at_timed=at_timed if freeze else None)
    finally:
        if freeze:
            gc.unfreeze()
    torch.cuda.synchronize()
    launches = _read_launches(ffd)
    _report(label, ms, phases, verdicts, k6)
    for name in ("incr", "walk"):
        for i, v in enumerate(verdicts[name][1:], 1):
            if (v[0] != "delta" or k6[name][i] < 1
                    or (name == "incr" and v[2] is not None)):
                bad.append(f"{name} pass {i}: {v}, {k6[name][i]} K6")
    engaged = sum(v[2] is None for v in verdicts["incr"][timed_from:])
    fallbacks = {name: sum(v[0] != "delta"
                           for v in verdicts[name][timed_from:])
                 for name in ("incr", "walk")}
    print(f"[{label}] launches {launches}; incr passes "
          f"{on.incr_passes} fallbacks {on.incr_fallbacks}; delta passes "
          f"incr {on.delta_passes}, walk {walk.delta_passes}; timed "
          f"passes {n - timed_from}: incr engaged {engaged}, fallbacks "
          f"{fallbacks}", flush=True)
    if engaged != n - timed_from or any(fallbacks.values()):
        bad.append(f"{label}: timed passes engaged {engaged} of "
                   f"{n - timed_from}, fallbacks {fallbacks}")
    if launches["ffd_delta_scan"] <= 0:
        bad.append("kernel ffd_delta_scan was not launched on the main path")
    return launches, bad, {k: _p50(v) for k, v in ms.items()}


# -- 18. the provisioning control loop ---------------------------------------
def _loop_run(card, warm_up=False, capture=None, n_pods=LOOP_PODS,
              n_wave2=LOOP_WAVE2, store_backend=None, rpcs=None,
              options=None, launch_counts=None):
    """One provisioning loop on a fresh cluster (workloads.provisioning_loop,
    Options(batch_idle_duration=0)): wave 1 the headline's first `n_pods`
    pods, wave 2 `n_wave2` pods of its two smallest sizes landing on wave
    1's nodes.  With `warm_up`, its GatedSolver is warmed first as the
    provisioner's startup warm-up does (a one-pod input, shapes (8, e) and
    (512, e)).  With a list as `capture`, each wave appends to it the
    arguments of the one-problem and seeded solves it launched
    (`_SolveCapture`, `_DeltaCapture`), for phase 3 to hold those launches
    to their plain versions.  `store_backend` is the cluster's store (the
    in-memory one by default); `rpcs`, a `_rpc_tally` of that backend,
    gives each wave its store round trips and their ms (and wave 1 the
    set-up's: the pods created before it).  Every kernel count is set to
    0 just before each wave and read just after.  `options` replaces
    Options(batch_idle_duration=0) (phase 24 passes a `solver_endpoint`:
    the loop's GatedSolver is then the solver service's client, each
    wave's launches are the worker's, read by `launch_counts` before and
    after it, and its frame bytes each way are recorded).  Returns one
    record per wave and the warm-up's."""
    import contextlib
    import torch
    from karpenter_tpu_torch import native, workloads
    from karpenter_tpu_torch.models import ObjectMeta, Pod, Resources
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.solver import ffd, firstuse
    from karpenter_tpu_torch.utils import metrics, tracing

    # the three recorders (flight, ledger, timeline) on, as by default,
    # their rings emptied as a fresh process has them
    obs = workloads.port_observability()
    obs.reset()
    watch = workloads.WaveObserver(obs)
    t_setup = time.perf_counter()
    loop = workloads.provisioning_loop(
        n_pods, options or Options(batch_idle_duration=0), device="cuda",
        store_backend=store_backend)
    client = loop.solver.tpu if loop.solver._remote else None
    setup = {"ms": (time.perf_counter() - t_setup) * 1e3}
    if rpcs is not None:
        setup.update(rpcs=rpcs["n"], rpc_ms=rpcs["s"] * 1e3)
    warm = None
    if warm_up:
        pod = Pod(meta=ObjectMeta(name="karpenter-warmup"),
                  requests=Resources.parse({"cpu": "100m",
                                            "memory": "128Mi"}))
        inp = loop.provisioner._build_input([pod])
        e = len(inp.existing_nodes)
        f0 = firstuse.snapshot()
        t0 = time.perf_counter()
        n = loop.solver.warmup(inp, shapes=((8, e), (512, e)))
        torch.cuda.synchronize()
        warm = {"launches": n, "ms": (time.perf_counter() - t0) * 1e3,
                "first_use": {k: v - f0[k]
                              for k, v in firstuse.snapshot().items()}}
    # time each round and each controller's reconcile
    ctl_s = {}
    for c in loop.manager.controllers:
        def timed(fn=c.reconcile, name=c.name):
            t = time.perf_counter()
            try:
                fn()
            finally:
                ctl_s[name] = ctl_s.get(name, 0.0) + time.perf_counter() - t
        c.reconcile = timed
    round_ms = []
    run_once = loop.manager.run_once

    def timed_round():
        t = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t) * 1e3)
    loop.manager.run_once = timed_round
    tracing.set_enabled(True)
    waves = []
    try:
        for wave in (1, 2):
            if wave == 2:
                loop.add_pods(workloads.headline_pods(
                    n_wave2, prefix="w", sizes=workloads.WAVE2_SIZES))
            rpc0 = dict(rpcs) if rpcs is not None else None
            ctl_s.clear()
            round_ms.clear()
            tracing.reset()
            oracle0 = metrics.SOLVER_SOLVES.value(path="oracle")
            f0 = firstuse.total()
            watch.start(loop.cluster)
            with contextlib.ExitStack() as stack:
                if capture is not None:
                    caps = (stack.enter_context(_SolveCapture(ffd)),
                            stack.enter_context(_DeltaCapture(ffd)))
                    capture.append({"solve": caps[0].calls,
                                    "delta": caps[1].calls})
                if launch_counts is None:
                    _reset_launches(ffd)
                    c0 = {}
                else:
                    c0 = launch_counts()
                if client is not None:
                    frames0 = (client.bytes_sent, client.bytes_received)
                t0 = time.perf_counter()
                rounds = loop.settle()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                launches = {k: v - c0.get(k, 0) for k, v in (
                    launch_counts or (lambda: _read_launches(ffd)))().items()}
            observed = watch.finish(loop.cluster)
            spans = {}
            for _, sps in tracing.finished_traces():
                for sp in sps:
                    spans[sp.name] = spans.get(sp.name, 0.0) + \
                        sp.duration * 1e3
            cache = getattr(loop.solver.tpu, "_delta_cache", None)
            waves.append({
                "answer": workloads.loop_answer(loop.cluster, loop.cloud,
                                                rounds),
                "wall_ms": wall, "round_ms": list(round_ms),
                "spans_ms": spans,
                "controller_ms": {k: v * 1e3 for k, v in ctl_s.items()},
                "phase_ms": dict(getattr(loop.solver.tpu, "last_phase_ms",
                                         {})),
                "launches": launches,
                "oracle": metrics.SOLVER_SOLVES.value(path="oracle")
                - oracle0,
                "fallbacks": sum(1 for ev in loop.cluster.events
                                 if ev[3] == "SolverFallback"),
                "first_use": firstuse.total() - f0,
                "seams": (cache.last_outcome, cache.last_reason,
                          cache.last_incr_reason) if cache else None,
                "observed": observed,
                "hostops": native.hostops() is not None})
            if client is not None:
                waves[-1]["frames"] = {
                    "sent": client.bytes_sent - frames0[0],
                    "received": client.bytes_received - frames0[1]}
            if rpcs is not None:
                waves[-1]["store"] = {
                    "rpcs": rpcs["n"] - rpc0["n"],
                    "rpc_ms": (rpcs["s"] - rpc0["s"]) * 1e3}
                if wave == 1:
                    waves[-1]["store"]["setup"] = setup
    finally:
        tracing.set_enabled(None)
        tracing.reset()
    return waves, warm


def _loop_check(waves, label, answers=LOOP, observed=LOOP_OBSERVED):
    """What phases 18 and 20 hold each wave to: the pinned JAX answer
    (`answers`) and what the JAX loop's ledger and timeline recorded
    (`observed`), K5 and its explain epilogue launched, no oracle solve,
    no SolverFallback event, kt_hostops loaded."""
    bad = []
    for i, w in enumerate(waves):
        if w["answer"] != answers[i]:
            bad.append(f"{label} wave {i + 1}: {w['answer']} != "
                       f"{answers[i]}")
        if w["observed"] != observed[i]:
            bad.append(f"{label} wave {i + 1}: recorded {w['observed']} "
                       f"!= {observed[i]}")
        for k in ("ffd_batch_scan", "explain_pack"):
            if w["launches"][k] <= 0:
                bad.append(f"{label} wave {i + 1}: {k} not launched")
        if w["oracle"]:
            bad.append(f"{label} wave {i + 1}: {w['oracle']} oracle solves")
        if w["fallbacks"]:
            bad.append(f"{label} wave {i + 1}: {w['fallbacks']} "
                       f"SolverFallback events")
        if not w["hostops"]:
            bad.append(f"{label} wave {i + 1}: kt_hostops not loaded")
    return bad


def _loop_print(label, waves, card):
    for i, w in enumerate(waves):
        sp = w["spans_ms"]
        print(f"[{label}] wave {i + 1} on {card}: {w['answer']}; to idle "
              f"{w['wall_ms']:.1f} ms, rounds ms "
              + ", ".join(f"{x:.1f}" for x in w["round_ms"])
              + "; spans ms " + ", ".join(
                  f"{k} {sp.get(k, 0.0):.1f}" for k in (
                      "provisioning.build_input", "provisioning.solve",
                      "provisioning.apply", "lifecycle.pass"))
              + "; controllers ms " + ", ".join(
                  f"{k} {v:.1f}" for k, v in w["controller_ms"].items())
              + "; solve phases ms " + ", ".join(
                  f"{k} {v:.3f}" for k, v in w["phase_ms"].items())
              + f"; seams {w['seams']}; launches "
              f"{ {k: v for k, v in w['launches'].items() if v} }; "
              f"oracle solves {w['oracle']}, SolverFallback events "
              f"{w['fallbacks']}, first-use events {w['first_use']}; "
              f"recorded {w['observed']}", flush=True)


def _loop_phase(card, add, captured):
    """Phase 18: the cold loop in a child process, a loop whose solver is
    warmed first, and LOOP_FRESH more loops on fresh clusters; every wave
    held by `_loop_check`, the warmed solver's first solve to zero
    first-use events.  The first fresh loop's solves are captured into
    `captured` (one entry per wave), and each wave must have launched K5
    and K6 only through the captured calls.  Adds the parent's loops'
    launches with `add`; returns what failed."""
    cold, err = _run_child("cold-loop")
    if cold is None:
        return [f"the cold loop failed: {err}"], None
    runs = {"cold": cold["waves"]}
    warmed, warm = _loop_run(card, warm_up=True)
    runs["warmed"] = warmed
    for i in range(LOOP_FRESH):
        runs[f"fresh {i + 1}"] = _loop_run(
            card, capture=captured if i == 0 else None)[0]
    bad, p50 = [], []
    for i, (w, cap) in enumerate(zip(runs["fresh 1"], captured)):
        n = {"ffd_batch_scan": len(cap["solve"]),
             "ffd_delta_scan": len(cap["delta"])}
        for k, v in n.items():
            if w["launches"][k] != v:
                bad.append(f"fresh 1 wave {i + 1}: {w['launches'][k]} {k} "
                           f"launches, {v} of them captured")
    for label, waves in runs.items():
        _loop_print(f"18 {label} loop", waves, card)
        bad += _loop_check(waves, label)
        if label != "cold":
            for w in waves:
                add(w["launches"])
    first = {k: [w[0]["spans_ms"].get("provisioning.solve", 0.0)]
             for k, w in runs.items()}
    print(f"[18] warm-up on {card}: {warm['launches']} launches in "
          f"{warm['ms']:.1f} ms, first-use events {warm['first_use']}; the "
          f"warmed solver's first solve (provisioning.solve) "
          f"{first['warmed'][0]:.1f} ms with {warmed[0]['first_use']} "
          f"first-use events, the cold process's first solve "
          f"{first['cold'][0]:.1f} ms with {runs['cold'][0]['first_use']}, "
          f"fresh clusters' first solves "
          + ", ".join(f"{first[k][0]:.1f}" for k in runs
                      if k.startswith("fresh")) + " ms", flush=True)
    if warm["launches"] <= 0:
        bad.append("the warm-up launched nothing")
    if warmed[0]["first_use"]:
        bad.append(f"the warmed solver's first solve met "
                   f"{warmed[0]['first_use']} first-use events")
    # the p50 of the fresh loops alone: the cold loop pays its process's
    # first use and the warmed one its warm-up, each printed above
    p50_runs = [runs[k] for k in runs if k.startswith("fresh")]
    for i in (0, 1):
        ws = [r[i] for r in p50_runs]
        spans = {k: _p50([w["spans_ms"].get(k, 0.0) for w in ws])
                 for k in ("provisioning.build_input", "provisioning.solve",
                           "provisioning.apply", "lifecycle.pass")}
        ctl = {k: _p50([w["controller_ms"].get(k, 0.0) for w in ws])
               for k in ws[0]["controller_ms"]}
        phases = {k: _p50([w["phase_ms"].get(k, 0.0) for w in ws])
                  for k in ws[0]["phase_ms"]}
        p50.append(_p50([w["wall_ms"] for w in ws]))
        print(f"[18] wave {i + 1} p50 over {LOOP_FRESH} fresh loop(s) "
              f"on {card}: to idle {p50[-1]:.1f} ms; spans ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in spans.items())
              + "; controllers ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in ctl.items())
              + "; solve phases ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
              flush=True)
    return bad, p50


# -- 20. the external cluster stores and the restored dispatch hook ---------
def _rpc_tally(backend, attr):
    """Wrap `backend.<attr>` (one store round trip: RemoteBackend._call,
    HttpBackend._request) to count its calls and their seconds; returns
    the running tally {"n", "s"}."""
    tally = {"n": 0, "s": 0.0}
    inner = getattr(backend, attr)

    def counted(*a, **kw):
        t = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            tally["n"] += 1
            tally["s"] += time.perf_counter() - t
    setattr(backend, attr, counted)
    return tally


def _probe_puts(backend, n=STORE_PROBE_PUTS):
    """ms a put: `n` sequential creates of one small pod each into a kind
    no cluster reads."""
    from karpenter_tpu_torch.models import ObjectMeta, Pod, Resources
    t = time.perf_counter()
    for i in range(n):
        ok = backend.put("probe", f"x{i}", Pod(
            meta=ObjectMeta(name=f"x{i}"),
            requests=Resources.parse({"cpu": "1", "memory": "1Gi"})),
            verb="added")
        if not ok:
            raise RuntimeError(f"probe put {i} was rejected")
    return (time.perf_counter() - t) * 1e3 / n


def _start_store_daemon():
    """`python -m karpenter_tpu_torch.store <socket>` as a child process
    (the store in a process of its own, as deployed); returns the process,
    its socket and the socket's directory once it listens."""
    import select
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    sockdir = tempfile.mkdtemp(prefix="kt_store_")
    sock = os.path.join(sockdir, "store.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.store", sock],
        stdout=subprocess.PIPE, text=True, cwd=root,
        env=dict(os.environ, PYTHONPATH=root))
    ready, _, _ = select.select([proc.stdout], [], [], 60)
    line = proc.stdout.readline() if ready else ""
    if not line.strip().endswith(sock):
        proc.kill()
        proc.wait()
        raise RuntimeError(f"the store daemon did not start: {line!r}")
    return proc, sock, sockdir


def _stop_store_daemon(proc, sockdir):
    """SIGTERM the daemon; its exit code (killed after 60 s: -9)."""
    import shutil
    proc.terminate()
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = -9
    proc.stdout.close()
    shutil.rmtree(sockdir, ignore_errors=True)
    return rc


def _store_print(label, waves, card, p50=None):
    _loop_print(label, waves, card)
    for i, w in enumerate(waves):
        st = w["store"]
        setup = st.get("setup")
        print(f"[{label}] wave {i + 1} on {card}: to idle "
              f"{w['wall_ms']:.1f} ms"
              + (f" (phase 18's fresh loops' p50 {p50[i]:.1f} ms)"
                 if p50 else "")
              + f"; store round trips {st['rpcs']}, "
              f"{st['rpc_ms']:.1f} ms in them, "
              f"{st['rpc_ms'] / max(1, st['rpcs']):.4f} ms each"
              + (f"; set-up (the pods created before wave 1) "
                 f"{setup['ms']:.1f} ms, {setup['rpcs']} round trips, "
                 f"{setup['rpc_ms'] / max(1, setup['rpcs']):.4f} ms each"
                 if setup else ""), flush=True)


def _stores_phase(card, add, p50=None):
    """Phase 20 (a) and (b): the provisioning loop through a store daemon
    in its own process at full scale (LOOP, LOOP_OBSERVED), then through
    the kube list/watch store at HTTP_LOOP_PODS + HTTP_LOOP_WAVE2 pods
    (HTTP_LOOP, HTTP_LOOP_OBSERVED); each store's put timed first.  Every
    wave held by `_loop_check`; the daemon's exit code must be 0.  Adds
    the loops' launches with `add`; returns what failed."""
    from karpenter_tpu_torch.store import (
        FakeApiServer,
        HttpBackend,
        RemoteBackend,
    )
    bad = []
    proc, sock, sockdir = _start_store_daemon()
    try:
        probe = RemoteBackend(sock)
        put_ms = _probe_puts(probe)
        probe.close()
        backend = RemoteBackend(sock)
        tally = _rpc_tally(backend, "_call")
        waves, _ = _loop_run(card, store_backend=backend, rpcs=tally)
        backend.close()
    finally:
        rc = _stop_store_daemon(proc, sockdir)
    print(f"[20a] store daemon (pid {proc.pid}) on {card}: "
          f"{STORE_PROBE_PUTS} puts {put_ms:.4f} ms each; exit code {rc}",
          flush=True)
    _store_print("20a remote", waves, card, p50)
    bad += _loop_check(waves, "20a remote")
    if rc != 0:
        bad.append(f"the store daemon exited with {rc}")
    for w in waves:
        add(w["launches"])

    srv = FakeApiServer()
    try:
        probe = HttpBackend(srv.url)
        put_ms = _probe_puts(probe)
        probe.close()
    finally:
        srv.close()
    print(f"[20b] fake apiserver on {card}: {STORE_PROBE_PUTS} puts "
          f"{put_ms:.4f} ms each", flush=True)
    srv = FakeApiServer()
    try:
        backend = HttpBackend(srv.url)
        tally = _rpc_tally(backend, "_request")
        waves, _ = _loop_run(card, n_pods=HTTP_LOOP_PODS,
                             n_wave2=HTTP_LOOP_WAVE2, store_backend=backend,
                             rpcs=tally)
        backend.close()
        writes = srv._rv
    finally:
        srv.close()
    _store_print("20b http", waves, card)
    print(f"[20b] the loop's server took {writes} writes (its windows hold "
          f"{HTTP_WINDOW})", flush=True)
    bad += _loop_check(waves, "20b http", HTTP_LOOP, HTTP_LOOP_OBSERVED)
    if writes > HTTP_WINDOW:
        bad.append(f"20b http: {writes} writes overran the {HTTP_WINDOW}-"
                   f"entry windows, so its records may depend on timing")
    for w in waves:
        add(w["launches"])
    return bad


def _fault_phase(card, add):
    """Phase 20 (c): a GatedSolver on the card solves the headline's first
    FAULT_PODS pods twice under `faults.arm("solver.dispatch", "error",
    times=1)`.  On the card an injected fault raises like any other
    failure of the device solve: the first solve must raise
    `FaultInjected` having launched nothing, with no oracle solve and no
    SolverFallback event, one fault.inject timeline event and the fault
    fired once; the second must launch K5 and give the JAX package's
    device answer FAULT_SOLVES[1].  Adds the second solve's launches with
    `add`; returns what failed."""
    import torch
    from karpenter_tpu_torch.cluster import Cluster
    from karpenter_tpu_torch.controllers.state import GatedSolver
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.solver import ffd
    from karpenter_tpu_torch.timeline import recorder
    from karpenter_tpu_torch.utils import faults, metrics
    from karpenter_tpu_torch.workloads import build_input

    cluster = Cluster()
    gs = GatedSolver(Options(), cluster, device="cuda")
    inp = build_input(FAULT_PODS)
    recorder.RECORDER.reset()
    oracle0 = metrics.SOLVER_SOLVES.value(path="oracle")
    out = []
    faults.arm("solver.dispatch", "error", times=1)
    try:
        for _ in range(2):
            _reset_launches(ffd)
            t0 = time.perf_counter()
            try:
                res = gs.solve(inp, source="provisioning")
                answer = (len(res.new_claims), len(res.unschedulable),
                          float(res.total_price()).hex(), result_digest(res))
            except faults.FaultInjected as e:
                answer = f"raised {type(e).__name__}: {e}"
            torch.cuda.synchronize()
            out.append({
                "answer": answer,
                "ms": (time.perf_counter() - t0) * 1e3,
                "launches": _read_launches(ffd),
                "oracle": metrics.SOLVER_SOLVES.value(path="oracle")
                - oracle0,
                "fallbacks": [e[1:5] for e in cluster.events
                              if e[3] == "SolverFallback"]})
        fired = faults.fire_count("solver.dispatch")
    finally:
        faults.disarm()
    r = recorder.RECORDER
    injects = [e["name"] for e in r.tail(len(r))
               if e["kind"] == "fault.inject"]
    for i, o in enumerate(out):
        shown = o["answer"] if i == 0 else o["answer"][:3]
        print(f"[20c] armed solve {i + 1} on {card}: {shown} in "
              f"{o['ms']:.1f} ms; launches "
              f"{ {k: v for k, v in o['launches'].items() if v} }; oracle "
              f"solves {o['oracle']}, SolverFallback events "
              f"{o['fallbacks']}", flush=True)
    print(f"[20c] fault fired {fired} time(s); fault.inject events "
          f"{injects}", flush=True)
    first, second = out
    bad = []
    want = "raised FaultInjected: injected fault at 'solver.dispatch' (error)"
    if first["answer"] != want:
        bad.append(f"the faulted solve: {first['answer']}, not {want!r}")
    if any(first["launches"].values()):
        bad.append(f"the faulted solve launched {first['launches']}")
    if second["answer"] != FAULT_SOLVES[1]:
        bad.append(f"the second solve: {second['answer']} != "
                   f"{FAULT_SOLVES[1]}")
    if second["oracle"] or second["fallbacks"]:
        bad.append(f"the card fell back: {second['oracle']} oracle solves, "
                   f"{second['fallbacks']}")
    if second["launches"]["ffd_batch_scan"] <= 0:
        bad.append("the second solve did not launch ffd_batch_scan")
    if fired != 1 or injects != ["solver.dispatch"]:
        bad.append(f"fired {fired}, fault.inject events {injects}")
    add(second["launches"])
    return bad


# -- 22. the operator's entry point as its own process; the HA pair ---------
# the replica's ledger ring in 22(a): wide enough for every record of its
# waves (as workloads.LEDGER_RING), so /debug/ledger and the spill hold
# the same records
_LEDGER_RING = 100_000
ENTRY_WAVE_S = 900        # a wave's wait, through the store, for every pod
ENTRY_STOP_S = 15         # SIGTERM to exit
# the HA pair's lease: duration, renew interval, retry period (s)
HA_LEASE = (5.0, 1.0, 0.2)
# the default pool's consolidateAfter in both: the operator runs every
# controller, and at the models' default of 0 the disruption controller
# simulates all 782 nodes right after the burst (multi-node, then one
# simulation a node) and acts on them; an hour keeps the fleet phase 18's
# for the phase, whose loop runs no disruption controller
ENTRY_CONSOLIDATE_AFTER_S = 3600.0
# the replica's batch window's max (BATCH_MAX_DURATION; the idle window
# stays the default 1 s): wave 2's 2,000 creates reach the replica at the
# pace it drains the daemon's stream, 15.0 s in one run on an H100 host, past
# the default 10 s max, which split the wave into two solves; phase 18
# places wave 2 as one batch
ENTRY_BATCH_MAX_S = 120.0


def _entry_pool():
    from karpenter_tpu_torch.models import Disruption, NodePool, ObjectMeta
    return NodePool(meta=ObjectMeta(name="default"), disruption=Disruption(
        consolidate_after=ENTRY_CONSOLIDATE_AFTER_S))


def _http(port, path, timeout=60.0):
    """GET http://127.0.0.1:`port``path`: (status, body)."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _scraped_launches(port):
    """The replica's kernel counts by kernel, from its /metrics
    (karpenter_tpu_solver_kernel_launches_total, which reads the
    wrappers' counts when scraped)."""
    out = {k: 0 for k in _counters()}
    _, body = _http(port, "/metrics")
    for line in body.splitlines():
        if line.startswith("karpenter_tpu_solver_kernel_launches_total{"):
            kernel = line.split('kernel="', 1)[1].split('"', 1)[0]
            out[kernel] = out.get(kernel, 0) + int(float(line.rsplit(" ", 1)[1]))
    return out, body


def _start_replica(sock, lease, logdir, env_extra=None):
    """`python -m karpenter_tpu_torch` as its own process on the store
    daemon at `sock` and the file lease `lease`, on ephemeral ports and
    with no platform variable (so on the card), `env_extra` added to its
    environment; its stderr to a file in `logdir`.  Returns (process,
    banner, metrics port, health port, the seconds to the banner, the
    stderr path)."""
    import select
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, KARPENTER_TPU_STORE_SOCKET=sock,
               KARPENTER_TPU_LEASE_FILE=lease,
               KARPENTER_TPU_METRICS_PORT="0", KARPENTER_TPU_HEALTH_PORT="0",
               BATCH_MAX_DURATION=str(ENTRY_BATCH_MAX_S), **(env_extra or {}))
    for k in ("KARPENTER_TPU_PLATFORM", "KARPENTER_TPU_FORCE_CPU"):
        env.pop(k, None)
    errpath = os.path.join(logdir, "replica.stderr")
    t0 = time.perf_counter()
    with open(errpath, "w") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch"], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=errf)
    fd = proc.stdout.fileno()
    buf = b""
    deadline = time.monotonic() + 300
    while b"health=:" not in buf or not buf.endswith(b"\n"):
        left = deadline - time.monotonic()
        if left <= 0 or proc.poll() is not None:
            proc.kill()
            proc.wait()
            with open(errpath) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"the replica did not start: {buf!r}\n{tail}")
        ready, _, _ = select.select([fd], [], [], min(left, 1.0))
        if ready:
            buf += os.read(fd, 4096)
    banner = buf.decode().strip().splitlines()[-1]
    ports = {k: int(banner.split(f"{k}=:")[1].split()[0])
             for k in ("metrics", "health")}
    return (proc, banner, ports["metrics"], ports["health"],
            time.perf_counter() - t0, errpath)


def _wait_bound(client, n, timeout=ENTRY_WAVE_S):
    """Poll the store client until it holds `n` pods, every one bound and
    Running; the seconds it took (None at the timeout)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        client.sync_backend()
        pods = client.pods.list()
        if len(pods) == n and all(p.node_name and p.phase == "Running"
                                  for p in pods):
            return time.perf_counter() - t0
        time.sleep(0.5)
    return None


def _kt_ledger_check(port, spill):
    """Phase 22(a)'s ledger check: `python -m karpenter_tpu_torch.tools.
    kt_ledger <spill> --json` over the replica's ledger spill must report
    what the replica's /debug/ledger summary reports over the same
    records (its ring holds them all): the records by source and the
    savings and added spend, hex for hex.  Returns what failed."""
    root = os.path.dirname(os.path.abspath(__file__))
    limit = str(_LEDGER_RING)
    code, body = _http(port, f"/debug/ledger?limit={limit}")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.tools.kt_ledger", spill,
         "--json", "--limit", limit], cwd=root, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=root))
    secs = time.perf_counter() - t0
    if code != 200 or out.returncode != 0:
        return [f"22a kt_ledger: /debug/ledger {code}, the tool's exit code "
                f"{out.returncode}: {out.stderr[-500:]}"]
    docs = {"http": json.loads(body)["summary"],
            "kt_ledger": json.loads(out.stdout)["summary"]}
    seen = {name: (doc["records"], doc["by_source"],
                   float(doc["savings_dollars_per_hr"]).hex(),
                   float(doc["spend_added_dollars_per_hr"]).hex())
            for name, doc in docs.items()}
    print(f"[22a] kt_ledger over {os.path.basename(spill)} in {secs:.1f} s: "
          f"(records, by source, savings hex, added hex) {seen['kt_ledger']}"
          f"; /debug/ledger {seen['http']}", flush=True)
    if seen["http"] != seen["kt_ledger"] or not seen["http"][0]:
        return [f"22a kt_ledger: {seen['kt_ledger']} != /debug/ledger "
                f"{seen['http']}"]
    return []


def _entry_phase(card, add):
    """Phase 22 (a): a store daemon in its own process holds the default
    NodeClass and pool and the headline's 50,000 pods, created through a
    store client before `python -m karpenter_tpu_torch` starts on the
    card; every pod must bind, and what the store holds must give LOOP's
    wave 1 (`workloads.store_answer`: the nodes, their pods, the price
    from the nodes' labels and the port's catalog), the wave's flight
    record HEADLINE_FLIGHT (/debug/flight), /metrics the scheduling
    histogram and K5's and the epilogue's launch counters, /healthz and
    /readyz "ok", /debug/ledger and /debug/timeline records; then 2,000
    pods of its two smallest sizes give LOOP's wave 2; SIGTERM ends the
    replica with exit code 0 inside ENTRY_STOP_S seconds, its lease
    released.  Adds the replica's launches with `add`; returns what
    failed."""
    import shutil
    import tempfile
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.cluster import Cluster
    from karpenter_tpu_torch.models import NodeClass, ObjectMeta
    from karpenter_tpu_torch.operator.leaderelection import FileLease
    from karpenter_tpu_torch.providers import generate_catalog
    from karpenter_tpu_torch.store import RemoteBackend

    bad = []
    tmp = tempfile.mkdtemp(prefix="kt_entry_")
    lease = os.path.join(tmp, "lease.json")
    ledger_dir = os.path.join(tmp, "ledger")
    daemon, sock, sockdir = _start_store_daemon()
    proc = None
    try:
        client = Cluster(backend=RemoteBackend(sock))
        t0 = time.perf_counter()
        client.nodeclasses.create(NodeClass(meta=ObjectMeta(name="default")))
        client.nodepools.create(_entry_pool())
        for pod in workloads.headline_pods(LOOP_PODS):
            client.pods.create(pod)
        setup_s = time.perf_counter() - t0
        proc, banner, mport, hport, boot_s, errpath = _start_replica(
            sock, lease, tmp, {"KARPENTER_TPU_LEDGER_DIR": ledger_dir,
                               "KARPENTER_TPU_LEDGER_BUFFER":
                                   str(_LEDGER_RING)})
        print(f"[22a] {LOOP_PODS} pods created through the store client in "
              f"{setup_s:.1f} s; the replica (pid {proc.pid}) served after "
              f"{boot_s:.1f} s: {banner}", flush=True)
        catalog = generate_catalog()
        seen = {k: 0 for k in _counters()}
        for wave in (1, 2):
            if wave == 2:
                t0 = time.perf_counter()
                for pod in workloads.headline_pods(
                        LOOP_WAVE2, prefix="w", sizes=workloads.WAVE2_SIZES):
                    client.pods.create(pod)
                print(f"[22a] wave 2's {LOOP_WAVE2} pods created in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            want_n = LOOP_PODS + (LOOP_WAVE2 if wave == 2 else 0)
            took = _wait_bound(client, want_n)
            counts, metrics_body = _scraped_launches(mport)
            launches = {k: counts.get(k, 0) - seen.get(k, 0) for k in counts}
            seen = counts
            add(launches)
            if took is None:
                bad.append(f"22a wave {wave}: not every pod bound in "
                           f"{ENTRY_WAVE_S} s")
                break
            answer = workloads.store_answer(client, catalog)
            want = {k: v for k, v in LOOP[wave - 1].items() if k != "rounds"}
            _, fbody = _http(hport, "/debug/flight?limit=64")
            solves = [r for r in json.loads(fbody)["records"]
                      if r["kind"] == "solve" and r["pods"] == (
                          LOOP_PODS if wave == 1 else LOOP_WAVE2)]
            print(f"[22a] wave {wave} on {card}: every pod bound {took:.1f} s "
                  f"after {'the replica served' if wave == 1 else 'the last create'}; "
                  f"{answer}; the replica's launches "
                  f"{ {k: v for k, v in launches.items() if v} }; flight "
                  f"records of the wave's solve {len(solves)}"
                  + (f", phase ms {solves[-1]['phase_ms']}" if solves else ""),
                  flush=True)
            if answer != want:
                bad.append(f"22a wave {wave}: {answer} != {want}")
            for k in ("ffd_batch_scan", "explain_pack"):
                if launches.get(k, 0) <= 0:
                    bad.append(f"22a wave {wave}: {k} not launched")
            if wave == 1:
                got = [{"fingerprint": r["fingerprint"],
                        "columns": r["catalog"]["columns"],
                        "price_sha": r["catalog"]["price_sha"],
                        "price_hex": r["result"]["price_hex"]}
                       for r in solves]
                if got != [dict(HEADLINE_FLIGHT,
                                price_hex=HEADLINE_PRICE_HEX)]:
                    bad.append(f"22a wave 1 flight records: {got}")
                if ("karpenter_provisioner_scheduling_duration_seconds"
                        not in metrics_body):
                    bad.append("22a: /metrics has no scheduling histogram")
                for path in ("/healthz", "/readyz"):
                    got_h = _http(hport, path)
                    if got_h != (200, "ok\n"):
                        bad.append(f"22a {path}: {got_h}")
                for path, key in (("/debug/ledger", "records"),
                                  ("/debug/timeline", "events")):
                    code, body = _http(hport, path)
                    n = len(json.loads(body)[key]) if code == 200 else 0
                    print(f"[22a] {path}: {code}, {n} {key}", flush=True)
                    if code != 200 or n == 0:
                        bad.append(f"22a {path}: {code}, {n} {key}")
        if not bad:
            bad += _kt_ledger_check(hport, os.path.join(
                ledger_dir, f"ledger-{proc.pid}.jsonl"))
        t0 = time.perf_counter()
        proc.terminate()
        try:
            rc = proc.wait(timeout=ENTRY_STOP_S)
        except subprocess.TimeoutExpired:
            rc = None
        stop_s = time.perf_counter() - t0
        holder = FileLease(lease).holder(now=time.time())
        print(f"[22a] SIGTERM: exit code {rc} after {stop_s:.1f} s; the "
              f"lease's holder after {holder!r}", flush=True)
        if rc != 0:
            bad.append(f"22a: the replica's exit code {rc} within "
                       f"{ENTRY_STOP_S} s of SIGTERM")
        if holder is not None:
            bad.append(f"22a: the lease is still held by {holder}")
        if bad:
            with open(errpath) as f:
                print("[22a] the replica's stderr ends:\n"
                      + f.read()[-3000:], flush=True)
        client.backend.close()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        if proc is not None:
            proc.stdout.close()
        drc = _stop_store_daemon(daemon, sockdir)
        shutil.rmtree(tmp, ignore_errors=True)
    if drc != 0:
        bad.append(f"22a: the store daemon exited with {drc}")
    return bad


def _ha_phase(card, add):
    """Phase 22 (b): tests/test_ha.py TestTwoReplicaExternalStore's layout
    on the card — a store daemon in its own process, one shared FakeCloud,
    two Operators (their environments on the card, each its own informer
    cache), one file lease; the headline's 50,000 pods created through
    the standby, the leader killed without releasing its lease once
    claims exist.  Never two leaders at once, every pod bound and none
    lost, the standby leading.  The fleet depends on when the leader
    died, so it is printed, not pinned.  The election is made before the
    pods are created and the pair's loops start after, so the leader meets
    the 50,000 pods as one burst.  Adds the launches with `add`; returns
    what failed."""
    import shutil
    import tempfile
    import threading
    import torch
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.cluster import Cluster
    from karpenter_tpu_torch.env import Environment
    from karpenter_tpu_torch.operator.leaderelection import FileLease
    from karpenter_tpu_torch.operator.operator import Operator
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.providers.fake_cloud import FakeCloud
    from karpenter_tpu_torch.solver import ffd
    from karpenter_tpu_torch.store import RemoteBackend
    from karpenter_tpu_torch.utils.clock import RealClock

    bad = []
    tmp = tempfile.mkdtemp(prefix="kt_ha_")
    daemon, sock, sockdir = _start_store_daemon()
    ops, threads, envs = [], [], []
    overlap = {"max": 0}
    watching = threading.Event()
    try:
        opts = Options()
        cloud = FakeCloud(clock=RealClock())
        envs = [Environment(clock=RealClock(), options=opts, cloud=cloud,
                            store_backend=RemoteBackend(sock), device="cuda")
                for _ in range(2)]
        envs[0].add_default_nodeclass()
        envs[0].cluster.nodepools.create(_entry_pool())
        lease = FileLease(os.path.join(tmp, "lease.json"))
        for ident, env in zip(("rep-1", "rep-2"), envs):
            op = Operator(options=opts, env=env, lease=lease, identity=ident,
                          metrics_port=0, health_port=0,
                          reconcile_interval=0.05)
            (op.elector.lease_duration, op.elector.renew_interval,
             op.elector.retry_period) = HA_LEASE
            ops.append(op)

        def watch_leaders():
            while not watching.is_set():
                overlap["max"] = max(overlap["max"], sum(
                    op._leadership.is_set() for op in ops))
                time.sleep(0.01)
        # the election first (rep-1 takes the lease, held while the pods
        # are created), then the 50,000 pods through the standby's cache,
        # then the pair's loops: created while the loops run, the creates
        # contend with both loops for this process's interpreter (117.8 s
        # in one run on an H100 host)
        leader, standby = ops
        lease_s = leader.elector.lease_duration
        leader.elector.lease_duration = 3600.0
        if not leader.elector.try_acquire_or_renew():
            return ["22b: rep-1 did not take the free lease"]
        leader.elector.lease_duration = lease_s
        t0 = time.perf_counter()
        for pod in workloads.headline_pods(LOOP_PODS):
            standby.env.cluster.pods.create(pod)
        create_s = time.perf_counter() - t0
        watcher = threading.Thread(target=watch_leaders, daemon=True)
        watcher.start()
        _reset_launches(ffd)
        threads = [threading.Thread(target=op.run, daemon=True)
                   for op in ops]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        while time.perf_counter() - t0 < ENTRY_WAVE_S:
            if leader.env.cluster.nodeclaims.list():
                break
            time.sleep(0.02)
        claims = len(leader.env.cluster.nodeclaims.list())
        kill_s = time.perf_counter() - t0
        leading = (leader._leadership.is_set(),
                   standby._leadership.is_set())
        # sudden death: no release, and the replica's store connection
        # gone, so the pass it is in cannot go on writing (stop() alone
        # lets that pass run to its end, as a live process would)
        leader.elector.release = lambda: None

        def dead(*_a, **_kw):
            raise ConnectionError("the replica was killed")
        leader.env.cluster.backend._call = dead
        leader.stop()
        client = Cluster(backend=RemoteBackend(sock))
        took = _wait_bound(client, LOOP_PODS)
        torch.cuda.synchronize()
        launches = _read_launches(ffd)
        add(launches)
        answer = workloads.loop_answer(client, cloud, 0)
        pods = client.pods.list()
        client.backend.close()
        print(f"[22b] HA pair on {card}: {LOOP_PODS} pods created through "
              f"the standby ({standby.elector.identity}) in {create_s:.1f} "
              f"s; the leader ({leader.elector.identity}; leading, standby "
              f"leading: {leading}) killed {kill_s:.1f} s after the loops "
              f"started, once {claims} claim(s) existed; every pod bound "
              + (f"{took:.1f} s after the kill" if took is not None
                 else "NOT within the limit")
              + f"; at most {overlap['max']} leader(s) at once; standby "
              f"leads {standby.elector.is_leader}; fleet {answer['instances']} "
              f"instances, price {answer['price']} ({float.fromhex(answer['price']):.5f}), "
              f"bound {answer['bound']}, unbound {answer['unbound']}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; reconcile "
              f"errors {[op.reconcile_errors for op in ops]}", flush=True)
        if took is None or len(pods) != LOOP_PODS:
            bad.append(f"22b: {len(pods)} pods, bound "
                       f"{answer['bound']}, within {ENTRY_WAVE_S} s: "
                       f"{took is not None}")
        if overlap["max"] > 1:
            bad.append("22b: two leaders at once")
        if not standby.elector.is_leader:
            bad.append("22b: the standby does not lead")
        if leading != (True, False):
            bad.append(f"22b: leadership before the kill {leading}")
        if launches["ffd_batch_scan"] <= 0:
            bad.append("22b: ffd_batch_scan not launched")
    finally:
        watching.set()
        for op in ops:
            op.stop()
        for th in threads:
            th.join(timeout=300)
        for env in envs:
            env.cluster.backend.close()
        drc = _stop_store_daemon(daemon, sockdir)
        shutil.rmtree(tmp, ignore_errors=True)
    if any(th.is_alive() for th in threads):
        bad.append("22b: an operator's loop did not stop")
    if drc != 0:
        bad.append(f"22b: the store daemon exited with {drc}")
    return bad


# -- 23. BASELINE config #11's rewind day through a real Operator ------------
REWIND_SEED = 1107


def _rewind_phase(card, add):
    """Phase 23: BASELINE config #11's day (`workloads.build_rewind_day`,
    at least 5,000 events, 240 s ticks) through `RewindEngine(device=
    "cuda", audit=True).run(driver="operator")`: a real Operator on the
    card, the shadow audit at rate 1.  Every invariant must hold
    (`ledger_hex_exact`, `zero_gang_atomicity_violations`,
    `zero_priority_inversions`, `audit_clean`, `zero_lost_pods`), every
    event applied, solves made, K5 launched, and the crash tick's armed
    `solver.dispatch` error must raise once on the card — one
    `ReconcileError`, no `SolverFallback` — and the next resync answer
    on the card.  (After the crash tick the card's trajectory may differ
    from the JAX replay's, whose oracle answers that tick.)  Then
    `seek_check` on the manager driver at the day's midpoint must be
    bit-identical.  Adds the launches with `add`; returns what failed."""
    import torch
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.solver import ffd
    from karpenter_tpu_torch.timeline import rewind
    from karpenter_tpu_torch.utils import metrics

    bad = []
    day = workloads.build_rewind_day(REWIND_SEED)
    oracle0 = metrics.SOLVER_SOLVES.value(path="oracle")
    _reset_launches(ffd)
    eng = rewind.RewindEngine(day, resolution=workloads.REWIND_TICK,
                              device="cuda", audit=True)
    t0 = time.perf_counter()
    rep = eng.run(driver="operator")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches(ffd)
    add(launches)
    reasons = [e[3] for e in eng.env.cluster.events]
    errors = [e[4] for e in eng.env.cluster.events
              if e[3] == "ReconcileError"]
    print(f"[23] config #11's day on {card}: {rep['events_applied']} of {rep['events_total']} events in "
          f"{len(eng.ticks)} ticks, {wall:.1f} s ({rep['events_per_s']} "
          f"events/s), {rep['solves']} solves; audit verdicts "
          f"{rep['audit_verdict_deltas']}; invariants "
          + ", ".join(f"{k} {rep[k]}" for k in (
              "ledger_hex_exact", "zero_gang_atomicity_violations",
              "zero_priority_inversions", "audit_clean", "zero_lost_pods"))
          + f"; ledger rows {rep['ledger_rows_checked']}; final pods "
          f"{rep['pods_final']}, scheduled {rep['scheduled_final']}, nodes "
          f"{rep['nodes_final']}; skipped {rep['events_skipped']}; "
          f"reconcile errors {rep['reconcile_errors']} {errors}; "
          f"SolverFallback events {reasons.count('SolverFallback')}; oracle "
          f"solves {metrics.SOLVER_SOLVES.value(path='oracle') - oracle0}; "
          f"launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    if len(day) < workloads.REWIND_MIN_EVENTS:
        bad.append(f"23: the day has {len(day)} events")
    if not rep["invariants_held"]:
        bad.append("23: " + ", ".join(
            f"{k} {rep[k]}" for k in ("ledger_breaks", "gang_violations",
                                      "priority_inversions", "lost_pods")
            if rep.get(k)))
    if rep["events_applied"] != rep["events_total"] or rep["solves"] <= 0:
        bad.append(f"23: {rep['events_applied']} of {rep['events_total']} "
                   f"events, {rep['solves']} solves")
    if rep["reconcile_errors"] != 1 or len(errors) != 1 \
            or "FaultInjected" not in errors[0]:
        bad.append(f"23: the crash raised {rep['reconcile_errors']} "
                   f"time(s): {errors}")
    if "SolverFallback" in reasons:
        bad.append("23: a SolverFallback event on the card")
    if launches["ffd_batch_scan"] <= 0:
        bad.append("23: ffd_batch_scan not launched")

    _reset_launches(ffd)
    t0 = time.perf_counter()
    chk = rewind.seek_check(day, len(day) // 2,
                            resolution=workloads.REWIND_TICK, audit=False,
                            device="cuda")
    torch.cuda.synchronize()
    seek_launches = _read_launches(ffd)
    add(seek_launches)
    print(f"[23] seek_check at event {chk['k']} of {len(day)} on {card}: "
          f"bit_identical {chk['bit_identical']} ({chk['straight_digest']}"
          f" / {chk['seek_digest']}) in {time.perf_counter() - t0:.1f} s "
          f"(straight {chk['straight']['wall_s']} s, seek "
          f"{chk['seek']['wall_s']} s); launches "
          f"{ {k: v for k, v in seek_launches.items() if v} }", flush=True)
    if not chk["bit_identical"]:
        bad.append(f"23: seek {chk['seek_digest']} != straight "
                   f"{chk['straight_digest']}")
    return bad


# -- 24. the solver service ----------------------------------------------------
# BASELINE config #8 (benchmarks/config8_saturation.py, its traffic as
# `workloads.Config8Traffic`) through kt_solverd with the port's backend
# on the card: the answers of `tenant-0`'s warm steps (its three traffic
# shapes, four solves), pinned from the JAX package (TPUSolver(max_nodes=
# 128, mesh off, delta off); tests/test_torch_service.py holds the pin to
# both packages on the CPU), as `config8_digest`
CONFIG8_PIN_TENANT = "tenant-0"
CONFIG8_PIN = "d9c09ff241893041a094aeb1b36f541a"
SERVICE_BOOT_S = 600      # a worker's spawn to its socket, at most
SERVICE_RECOVER_S = 300   # the crashed worker's client, retrying, at most
SERVICE_CRASH = "solverd.handle_batch=crash::1"   # the worker's first batch
SERVICE_DEGRADED_REPS = 5  # timed degraded solves after the first


def config8_digest(results) -> str:
    """sha256 (32 hex) of the results' `workloads.config8_canon`s."""
    import hashlib
    from karpenter_tpu_torch.workloads import config8_canon
    return hashlib.sha256(json.dumps(
        [config8_canon(r) for r in results]).encode()).hexdigest()[:32]


def _pct(xs, q):
    return sorted(xs)[max(0, int(round(q * len(xs))) - 1)] if xs else None


def _service_worker(sockdir, name, env_extra, probe=True):
    """A `SolverdSupervisor` worker (kt_solverd with the port's backend)
    on the card, `env_extra` in its environment: the seconds from spawn
    to its socket and, with `probe`, to its first answer (a stats frame)
    and the worker's own report.  A worker that exits before it listens
    fails with its stderr."""
    from karpenter_tpu_torch.service import SolverdSupervisor
    from karpenter_tpu_torch.service import SolverServiceClient
    env = dict(os.environ)
    for k in ("KARPENTER_TPU_PLATFORM", "KARPENTER_TPU_FORCE_CPU",
              "KARPENTER_TPU_FAULTS"):
        env.pop(k, None)
    env.update(env_extra)
    from karpenter_tpu_torch.workloads import CONFIG8_WINDOW
    sock = os.path.join(sockdir, f"{name}.sock")
    err = os.path.join(sockdir, f"{name}.stderr")
    sup = SolverdSupervisor(sock, env=env, extra_args=CONFIG8_WINDOW,
                            stderr_path=err, backoff_base=0.2,
                            backoff_max=2.0)
    t0 = time.perf_counter()
    sup.start(wait_for_socket=False)
    while True:
        try:
            sup.wait_ready(timeout=1.0)
            break
        except TimeoutError:
            pass
        if sup.restarts or sup.last_exit is not None \
                or time.perf_counter() - t0 > SERVICE_BOOT_S:
            sup.stop()
            with open(err, errors="replace") as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"the {name} worker never listened (exit "
                               f"{sup.last_exit}): {tail}")
    boot = {"socket_s": time.perf_counter() - t0, "sock": sock, "err": err}
    if probe:
        client = SolverServiceClient(sock, timeout=SERVICE_BOOT_S)
        boot["worker"] = client.stats()["worker"]
        boot["first_answer_s"] = time.perf_counter() - t0
        client.close()
    return sup, boot


def _worker_report(sock):
    """The worker's own report over a stats frame (`backend._worker_info`:
    its interpreter, torch, device, launch counts and device memory)."""
    from karpenter_tpu_torch.service import SolverServiceClient
    c = SolverServiceClient(sock, timeout=120)
    try:
        return c.stats()["worker"]
    finally:
        c.close()


def _config8_arm(sock, traffic, fuse_on, card):
    """One arm of config #8 on a worker started with
    KARPENTER_TPU_TENANT_FUSE on or off: CONFIG8_TENANTS tenants, two
    closed-loop drivers each (a control plane's provisioner and its
    disruption simulator), CONFIG8_ARM_S seconds, after `tenant-0`'s warm
    steps.  Returns the arm's record: throughput, latencies, shed, lost,
    the worker's batch sizes and launches during the arm, and one
    (tenant, step, [digest]) per traffic step for the solo check."""
    import threading
    from collections import Counter

    from karpenter_tpu_torch.service import SolverServiceClient
    from karpenter_tpu_torch.workloads import (CONFIG8_ARM_S,
                                               CONFIG8_TENANTS,
                                               CONFIG8_WINDOW)
    names = [f"tenant-{i}" for i in range(CONFIG8_TENANTS)]
    clients = {t: SolverServiceClient(sock, timeout=120, tenant=t)
               for t in names}
    lat = {t: [] for t in names}
    sent = {t: 0 for t in names}
    done = {t: 0 for t in names}
    errors, answers = [], []
    lock = threading.Lock()
    try:
        warm = traffic.warm(clients[names[0]], names[0])
        pin = config8_digest([r for _, rs, _ in warm for r in rs])
        st0 = clients[names[0]].stats()
        n_batches0 = len(st0["batch_sizes"])
        dispatch0 = (st0.get("scheduler") or {}).get("dispatch_s", 0.0)
        launches0 = st0["worker"]["launches"]
        seq = {t: iter(range(1 << 20)) for t in names}
        start = threading.Barrier(2 * len(names))
        stop_at = [0.0]

        def drive(t):
            start.wait()
            while time.perf_counter() < stop_at[0]:
                with lock:
                    it = next(seq[t])
                t0 = time.perf_counter()
                try:
                    n, results, _ = traffic.call(clients[t], t, it)
                except Exception as e:  # noqa: BLE001 — counted, must be 0
                    errors.append((t, str(e)[:200]))
                    return
                ms = (time.perf_counter() - t0) * 1e3
                digs = [config8_digest([r]) for r in results]
                with lock:
                    lat[t].append(ms)
                    sent[t] += n
                    done[t] += len(results)
                    answers.append((t, it, digs))

        threads = [threading.Thread(target=drive, args=(t,))
                   for t in names for _ in range(2)]
        stop_at[0] = time.perf_counter() + CONFIG8_ARM_S
        t_begin = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        elapsed = time.perf_counter() - t_begin
        st = clients[names[0]].stats()
    finally:
        for c in clients.values():
            c.close()
    sizes = st["batch_sizes"][n_batches0:]
    launches = {k: v - launches0.get(k, 0)
                for k, v in st["worker"]["launches"].items()}
    all_lat = [x for v in lat.values() for x in v]
    per_tenant = {t: (len(v), _pct(v, 0.5), _pct(v, 0.99))
                  for t, v in lat.items()}
    rec = {"fuse": fuse_on, "elapsed_s": elapsed,
           "requests": sum(done.values()),
           "throughput_rps": sum(done.values()) / elapsed,
           "lost": sum(sent.values()) - sum(done.values()),
           "errors": errors, "shed": st["shed"],
           "fleet_p50_ms": _pct(all_lat, 0.5),
           "fleet_p99_ms": _pct(all_lat, 0.99),
           "per_tenant": per_tenant,
           "batch_sizes": dict(sorted(Counter(sizes).items())),
           "batches": len(sizes),
           "cross_tenant_batches":
               (st.get("scheduler") or {}).get("cross_tenant_batches"),
           "launches": launches, "pin": pin, "answers": answers,
           "worker": st["worker"],
           "dispatch_s": (st.get("scheduler") or {}).get(
               "dispatch_s", 0.0) - dispatch0,
           "phases": (st.get("telemetry") or {}).get("phase_latency_ms")}
    print(f"[24b] config #8 fusion {'on' if fuse_on else 'off'} on {card}: "
          f"{rec['requests']} requests in {elapsed:.2f} s = "
          f"{rec['throughput_rps']:.2f} req/s; fleet p50 "
          f"{rec['fleet_p50_ms']:.3f} ms, p99 {rec['fleet_p99_ms']:.3f} ms; "
          f"per tenant (calls, p50, p99 ms) "
          + ", ".join(f"{t} ({n}, {p50:.2f}, {p99:.2f})"
                      for t, (n, p50, p99) in per_tenant.items())
          + f"; fused batch sizes {rec['batch_sizes']} over "
          f"{rec['batches']} batches ({rec['cross_tenant_batches']} "
          f"cross-tenant in all); shed {rec['shed']}, lost {rec['lost']}, "
          f"errors {len(errors)}; the worker's launches "
          f"{ {k: v for k, v in launches.items() if v} }; the warm "
          f"steps' digest {pin}", flush=True)
    # where an arm's time goes: the worker's dispatches (its scheduler's
    # EWMA of one fused dispatch: unpickled frames to answers, K5
    # included) against the wall, the rest the window and the frames
    print(f"[24b] fusion {'on' if fuse_on else 'off'}: the worker "
          f"dispatched {rec['batches']} batches in "
          f"{rec['dispatch_s'] * 1e3:.1f} ms of the arm's "
          f"{elapsed * 1e3:.1f} ms wall (the rest its window, "
          f"{' '.join(CONFIG8_WINDOW)}, and the frames); its solve phases "
          f"(count, p50, p99 ms, histogram buckets) {rec['phases']}",
          flush=True)
    return rec


def _service_phase(card, add):
    """Phase 24: the solver service.  (a) kt_solverd built by `make
    solverd` and started by `SolverdSupervisor` (always `--module
    karpenter_tpu_torch.service.backend`) on the card: seconds to its
    socket, its first answer and a warm `warmup` frame; its interpreter,
    torch and device as it reports them; no jaxlib or libtpu mapped into
    it.  (b) config #8: fusion on and off, each on its own worker — every
    request equal to a solo card solve, `tenant-0`'s warm steps the JAX
    pin, none lost, K5 launched by the worker.  (c) phase 18's 50k +
    2k loop with `Options(solver_endpoint=...)`: `LOOP` and
    `LOOP_OBSERVED`, K5 launched by the worker, the frames' bytes each
    way and each wave's time to idle beside the same loop in memory.
    (d) a worker armed to crash on its first batch: the supervisor
    restarts it and the client's retry gets the pin; then the supervisor
    stopped, the breaker open, and the degraded in-process TorchSolver on
    the card gives the pin with `SolverFallback` recorded and no oracle
    solve; the worker's exit code on SIGTERM and both processes' device
    memory.  Adds the launches with `add`; returns what failed."""
    import pickle
    import shutil

    import torch
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.cluster import Cluster
    from karpenter_tpu_torch.controllers.state import GatedSolver
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.service import (CircuitBreaker, RetryPolicy,
                                             SolverServiceClient)
    from karpenter_tpu_torch.service import supervisor as sup_mod
    from karpenter_tpu_torch.solver import TorchSolver, ffd
    from karpenter_tpu_torch.utils import metrics

    bad = []
    t0 = time.perf_counter()
    try:
        binary = sup_mod.build_binary()
    except RuntimeError as e:
        return [f"24a: kt_solverd did not build or link: {e}"]
    print(f"[24a] kt_solverd ({binary}) ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tmp = tempfile.mkdtemp(prefix="kt_svc_")
    sockdir = os.path.join(tmp, "s")
    os.makedirs(sockdir)
    traffic = workloads.Config8Traffic()
    small = {"KARPENTER_TPU_MAX_NODES": str(workloads.CONFIG8_MAX_NODES)}
    sups = []
    try:
        # -- (a) boot, and (b) the fused arm on the same worker --------------
        arms = {}
        for fuse in (True, False):
            sup, boot = _service_worker(
                sockdir, f"config8-{'on' if fuse else 'off'}",
                dict(small, KARPENTER_TPU_TENANT_FUSE="on" if fuse else "off"))
            sups.append(sup)
            w = boot["worker"]
            c = SolverServiceClient(boot["sock"], timeout=SERVICE_BOOT_S)
            t1 = time.perf_counter()
            warmed = c.warmup(traffic.inputs("boot", 0)[0],
                              shapes=((12, 0),), batch_sizes=(1, 4, 16, 64))
            warm_s = time.perf_counter() - t1
            c.close()
            with open(f"/proc/{sup.worker_pid}/maps") as f:
                maps = f.read()
            libs = sorted({line.split()[-1] for line in maps.splitlines()
                           if line.split()[-1].startswith("/")})
            print(f"[24a] worker {sup.worker_pid} (fusion "
                  f"{'on' if fuse else 'off'}) on {card}: socket "
                  f"{boot['socket_s']:.2f} s, first answer "
                  f"{boot['first_answer_s']:.2f} s, warmup frame "
                  f"{warm_s:.2f} s ({warmed} launches) after spawn + "
                  f"{boot['first_answer_s']:.2f}; its sys.executable "
                  f"{w['executable']}, python {w['python']}, torch "
                  f"{w['torch']}, CUDA {w['cuda']}, device {w['device']} "
                  f"({w.get('device_name')}); libpython "
                  f"{[p for p in libs if 'libpython' in p]}", flush=True)
            if not str(w["device"]).startswith("cuda"):
                bad.append(f"24a: the worker runs on {w['device']}")
            hits = [p for p in libs if "jaxlib" in p or "libtpu" in p]
            if hits:
                bad.append(f"24a: the worker maps {hits}")
            if warmed <= 0:
                bad.append("24a: the warmup frame launched nothing")
            arms[fuse] = _config8_arm(boot["sock"], traffic, fuse, card)
            sup.stop()
            print(f"[24a] worker stopped by SIGTERM: exit code "
                  f"{sup.last_exit}", flush=True)
        # every request against a solo card solve on the same input
        solo = TorchSolver(max_nodes=workloads.CONFIG8_MAX_NODES,
                           device="cuda", mesh="off", delta="off")
        t1 = time.perf_counter()
        n = wrong = 0
        for fuse, arm in arms.items():
            for t, it, digs in arm.pop("answers"):
                for inp, d in zip(traffic.inputs(t, it), digs):
                    n += 1
                    if config8_digest([solo.solve(inp)]) != d:
                        wrong += 1
        ratio = arms[True]["throughput_rps"] / arms[False]["throughput_rps"]
        print(f"[24b] {n} requests against solo card solves: {wrong} "
              f"differ ({time.perf_counter() - t1:.1f} s); fused/unfused "
              f"throughput {ratio:.3f}x; the warm steps' digests "
              f"{arms[True]['pin']} / {arms[False]['pin']} (pin "
              f"{CONFIG8_PIN})", flush=True)
        if wrong:
            bad.append(f"24b: {wrong} of {n} requests differ from solo "
                       f"card solves")
        for fuse, arm in arms.items():
            tag = f"24b fusion {'on' if fuse else 'off'}"
            if arm["pin"] != CONFIG8_PIN:
                bad.append(f"{tag}: warm digest {arm['pin']} != pin")
            if arm["lost"] or arm["errors"]:
                bad.append(f"{tag}: lost {arm['lost']}, errors "
                           f"{arm['errors'][:3]}")
            if arm["launches"].get("ffd_batch_scan", 0) <= 0:
                bad.append(f"{tag}: the worker launched no K5")
            add({k: arm["launches"].get(k, 0)
                 for k in ("ffd_batch_scan", "explain_pack")})

        # -- (c) the 50k headline loop through the service ----------------
        opts = Options()
        sup, boot = _service_worker(
            sockdir, "loop",
            {"KARPENTER_TPU_MAX_NODES": str(opts.solver_max_nodes)})
        sups.append(sup)
        inp = workloads.build_input(LOOP_PODS)
        t1 = time.perf_counter()
        blob = pickle.dumps(inp.pods, protocol=pickle.HIGHEST_PROTOCOL)
        t_dump = time.perf_counter() - t1
        t1 = time.perf_counter()
        pickle.loads(blob)
        t_load = time.perf_counter() - t1
        print(f"[24c] the {LOOP_PODS} pods pickled on this host: "
              f"{len(blob)} bytes, dumps {t_dump:.3f} s, loads "
              f"{t_load:.3f} s", flush=True)
        del inp, blob
        mem, _ = _loop_run(card)
        svc, _ = _loop_run(
            card, options=Options(batch_idle_duration=0,
                                  solver_endpoint=boot["sock"],
                                  service_request_timeout=600.0),
            launch_counts=lambda: _worker_report(boot["sock"])["launches"])
        _loop_print("24c service loop", svc, card)
        bad += _loop_check(svc, "24c service loop")
        for i, (m, s_) in enumerate(zip(mem, svc)):
            print(f"[24c] wave {i + 1} on {card}: to idle through the "
                  f"service {s_['wall_ms']:.1f} ms against "
                  f"{m['wall_ms']:.1f} in memory; frames sent "
                  f"{s_['frames']['sent']} bytes, received "
                  f"{s_['frames']['received']}; spans ms provisioning.solve"
                  f" {s_['spans_ms'].get('provisioning.solve', 0.0):.1f} "
                  f"(in memory "
                  f"{m['spans_ms'].get('provisioning.solve', 0.0):.1f}); "
                  f"the worker's launches "
                  f"{ {k: v for k, v in s_['launches'].items() if v} }",
                  flush=True)
            add(s_["launches"])
        bad += [f"24c in memory: {b}" for b in _loop_check(mem, "memory")]
        w = _worker_report(boot["sock"])
        print(f"[24c] the worker's device memory after the loop: allocated "
              f"{w.get('memory_allocated')} bytes, reserved at most "
              f"{w.get('max_memory_reserved')}", flush=True)
        sup.stop()
        print(f"[24c] worker stopped by SIGTERM: exit code {sup.last_exit}",
              flush=True)

        # -- (d) a crash, its recovery, and degraded mode ------------------
        sup, boot = _service_worker(
            sockdir, "crash", dict(small, KARPENTER_TPU_FAULTS=SERVICE_CRASH),
            probe=False)
        sups.append(sup)
        # the crashing worker read its environment at spawn; its
        # successors start clean
        sup.env.pop("KARPENTER_TPU_FAULTS", None)
        client = SolverServiceClient(
            boot["sock"], timeout=SERVICE_RECOVER_S,
            retry=RetryPolicy(attempts=1000, base_backoff=0.25,
                              max_backoff=1.0, deadline=SERVICE_RECOVER_S),
            breaker=CircuitBreaker(threshold=1000))
        t1 = time.perf_counter()
        try:
            warm = traffic.warm(client, CONFIG8_PIN_TENANT)
            got = config8_digest([r for _, rs, _ in warm for r in rs])
        except Exception as e:  # noqa: BLE001
            got = f"failed: {e}"
        recover_s = time.perf_counter() - t1
        client.close()
        print(f"[24d] crash on the first batch: restarts {sup.restarts}, "
              f"the crashed worker's exit {sup.last_exit}, the client's "
              f"retries answered after {recover_s:.2f} s, digest {got}",
              flush=True)
        if sup.restarts < 1:
            bad.append("24d: the supervisor restarted nothing")
        if got != CONFIG8_PIN:
            bad.append(f"24d: after the restart {got} != pin")
        gs = GatedSolver(Options(
            solver_endpoint=boot["sock"],
            solver_max_nodes=workloads.CONFIG8_MAX_NODES,
            service_retry_attempts=2, service_breaker_threshold=2),
            Cluster(), device="cuda")

        def steps():
            out = []
            for it in workloads.CONFIG8_WARM_STEPS:
                inps = traffic.inputs(f"{CONFIG8_PIN_TENANT}-warm", it)
                out += (list(gs.solve_batch(inps)) if len(inps) > 1
                        else [gs.solve(inps[0])])
            return config8_digest(out)
        live = steps()
        wstats = _worker_report(boot["sock"])
        sup.stop()
        exit_code = sup.last_exit
        oracle0 = metrics.SOLVER_SOLVES.value(path="oracle")
        _reset_launches(ffd)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        degraded = steps()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t1) * 1e3
        times = []
        for _ in range(SERVICE_DEGRADED_REPS):
            t1 = time.perf_counter()
            again = steps()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        local_launches = _read_launches(ffd)
        add(local_launches)
        fallbacks = sum(1 for e in gs.cluster.events
                        if e[3] == "SolverFallback")
        oracle = metrics.SOLVER_SOLVES.value(path="oracle") - oracle0
        print(f"[24d] service mode before the stop: digest {live}; the "
              f"worker's exit code on SIGTERM {exit_code}; degraded mode "
              f"on {card}: digest {degraded} (again {again}), breaker "
              f"{gs.tpu.breaker.state}, SolverFallback events {fallbacks}, "
              f"oracle solves {oracle}, the degraded solver on "
              f"{gs._local.device if gs._local else None}; the warm steps "
              f"(4 solves) {first_ms:.1f} ms the first time, "
              f"{_p50(times):.1f} ms p50 of {len(times)} after; this "
              f"process's launches "
              f"{ {k: v for k, v in local_launches.items() if v} }; device "
              f"memory: the worker allocated {wstats.get('memory_allocated')}"
              f" bytes (reserved at most {wstats.get('max_memory_reserved')})"
              f", this process reserved at most "
              f"{torch.cuda.max_memory_reserved()}", flush=True)
        if live != CONFIG8_PIN or degraded != CONFIG8_PIN \
                or again != CONFIG8_PIN:
            bad.append(f"24d: digests {live} / {degraded} / {again} != pin")
        if gs.tpu.breaker.state != "open":
            bad.append(f"24d: the breaker is {gs.tpu.breaker.state}")
        if not fallbacks or oracle:
            bad.append(f"24d: SolverFallback {fallbacks}, oracle {oracle}")
        if gs._local is None or gs._local.device.type != "cuda" \
                or local_launches["ffd_batch_scan"] <= 0:
            bad.append("24d: the degraded solve did not launch K5 on the "
                       "card")
    except Exception as e:  # noqa: BLE001 — the phase fails, with why
        import traceback
        traceback.print_exc()
        bad.append(f"24: {type(e).__name__}: {e}")
    finally:
        for sup in sups:
            sup.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return bad


# -- 19. the disruption control loop -----------------------------------------
def disruption_pin(answer):
    """A disruption wave's answer in the form DISRUPTION_LOOP pins:
    `loop_answer`'s fields and the record's, its acts (each as reason,
    candidates, candidate digest, replacement types) as their count, the
    sha256 of their JSON, the multi-node acts and the replacements."""
    import hashlib
    rec = answer["disruption"]
    acts = json.loads(json.dumps(rec["acts"]))
    out = {k: v for k, v in answer.items() if k != "disruption"}
    out.update({
        "acts": len(acts),
        "acts_digest": hashlib.sha256(
            json.dumps(acts).encode()).hexdigest()[:16],
        "multi_node_acts": sum(1 for a in acts if a[1] > 1),
        "replacements": sum(1 for a in acts if a[3]),
        "verdicts": rec["verdicts"], "retired": rec["retired"],
        "added": rec["added"], "settles": rec["settles"],
        "settle_rounds": rec["rounds"]})
    return out


def _clone(x):
    """A copy of a tensor, or of a dataclass of tensors (nested), that
    later launches cannot overwrite."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _clone(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


class _LaunchLog:
    """Logs the shape of every K5 (`ffd.solve_ffd_batch`, which one-problem
    solves reach too) and K4 (`ffd.solve_ffd_sweep`) launch while active,
    with the controller whose reconcile made it and the wave: (kernel,
    controller, wave, B, G, E, N).  With `keep`, it also keeps, cloned,
    the arguments of the first B=64 K5 launch of a disruption pass, its
    first K4 chunk (and the first of each other chunk size B) and the
    first provisioner K5 launch with E > 1,000 in wave 2 (a re-placement
    of evicted pods), for phase 3."""

    def __init__(self, ffd, keep=False):
        self.ffd, self.keep = ffd, keep
        self.rows, self.kept = [], {}
        self.ctl, self.wave = None, 0
        self.sweep_b = set()

    def __enter__(self):
        ffd = self.ffd
        self.real = (ffd.solve_ffd_batch, ffd.solve_ffd_sweep)
        real_batch, real_sweep = self.real

        def batch(b, c, n, explain=0, sparse_k=0, with_gang=0,
                  with_priority=0):
            self.rows.append(("ffd_batch_scan", self.ctl, self.wave, b.B,
                              b.G, b.E, n))
            for key, want in (
                    ("multi-node batch", self.ctl == "disruption"
                     and b.B == 64),
                    ("re-placement", self.ctl == "provisioning"
                     and self.wave == 2 and b.E > 1000)):
                if self.keep and want and key not in self.kept:
                    self.kept[key] = ("batch", _clone(b), c, n, explain,
                                      sparse_k, with_gang, with_priority)
            return real_batch(b, c, n, explain, sparse_k, with_gang,
                              with_priority)

        def sweep(sw, c, n, sparse_k=0):
            self.rows.append(("ffd_sweep_topo_scan" if sw.heavy
                              else "ffd_sweep_scan", self.ctl, self.wave,
                              sw.B, sw.G, sw.E, n))
            if self.keep and "sweep chunk" not in self.kept:
                self.kept["sweep chunk"] = ("sweep", _clone(sw), c, n,
                                            sparse_k)
                self.sweep_b = {sw.B}
            elif self.keep and sw.B not in self.sweep_b:
                # the first chunk of each other chunk size (B)
                self.sweep_b.add(sw.B)
                self.kept[f"sweep chunk B={sw.B}"] = ("sweep", _clone(sw),
                                                      c, n, sparse_k)
            return real_sweep(sw, c, n, sparse_k)
        ffd.solve_ffd_batch, ffd.solve_ffd_sweep = batch, sweep
        return self

    def __exit__(self, *exc):
        self.ffd.solve_ffd_batch, self.ffd.solve_ffd_sweep = self.real


def _disruption_run(card, warm_up=False, keep=False):
    """One disruption loop on a fresh cluster (workloads.disruption_loop,
    Options(batch_idle_duration=0), on the card) through its three waves
    (workloads.DisruptionWaves).  With `warm_up`, its GatedSolver is
    warmed first as the provisioner's startup warm-up does.  A `_LaunchLog`
    (keeping launches for phase 3 with `keep`) records every K5 and K4
    launch.  Every kernel count is set to 0 just before each wave and read
    just after.  Returns one record per wave, the warm-up's and the
    log."""
    import torch
    from karpenter_tpu_torch import native, workloads
    from karpenter_tpu_torch.models import ObjectMeta, Pod, Resources
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.solver import ffd, firstuse
    from karpenter_tpu_torch.utils import metrics, tracing

    # the three recorders on, as by default, their rings emptied as a
    # fresh process has them
    obs = workloads.port_observability()
    obs.reset()
    watch = workloads.WaveObserver(obs)
    env = workloads.disruption_loop(
        workloads.DISRUPTION_NODES, Options(batch_idle_duration=0),
        device="cuda")
    log = _LaunchLog(ffd, keep=keep)
    warm = None
    if warm_up:
        pod = Pod(meta=ObjectMeta(name="karpenter-warmup"),
                  requests=Resources.parse({"cpu": "100m",
                                            "memory": "128Mi"}))
        inp = env.provisioner._build_input([pod])
        e = len(inp.existing_nodes)
        f0 = firstuse.snapshot()
        t0 = time.perf_counter()
        n = env.solver.warmup(inp, shapes=((8, e), (512, e)))
        torch.cuda.synchronize()
        warm = {"launches": n, "ms": (time.perf_counter() - t0) * 1e3,
                "first_use": {k: v - f0[k]
                              for k, v in firstuse.snapshot().items()}}
    # each controller's reconcile ms, and the controller active for the
    # launch log
    ctl_s = {}
    for c in env.manager.controllers:
        def timed(fn=c.reconcile, name=c.name):
            log.ctl = name
            t = time.perf_counter()
            try:
                fn()
            finally:
                ctl_s[name] = ctl_s.get(name, 0.0) + time.perf_counter() - t
                log.ctl = None
        c.reconcile = timed
    # the first-use events of the loop's first disruption pass that had
    # candidates
    first_pass = {}
    had = [False]
    build, reconcile = (env.disruption._build_candidates,
                        env.disruption._reconcile)

    def counted_build():
        out = build()
        had[0] = had[0] or bool(out)
        return out

    def counted_reconcile():
        had[0] = False
        f = firstuse.total()
        reconcile()
        if had[0] and "events" not in first_pass:
            first_pass.update(events=firstuse.total() - f, wave=log.wave)
    env.disruption._build_candidates = counted_build
    env.disruption._reconcile = counted_reconcile
    # solve_batch: calls, simulations, those the sweep answered, ms and
    # the solver's phases summed over the calls
    batch = {}
    real_batch, real_sweep = env.solver.solve_batch, env.solver.tpu._try_sweep

    def timed_batch(inps, *a, **kw):
        t = time.perf_counter()
        out = real_batch(inps, *a, **kw)
        batch["calls"] = batch.get("calls", 0) + 1
        batch["sims"] = batch.get("sims", 0) + len(inps)
        batch["ms"] = batch.get("ms", 0.0) + (time.perf_counter() - t) * 1e3
        for k, v in env.solver.tpu.last_phase_ms.items():
            batch[f"phase {k}"] = batch.get(f"phase {k}", 0.0) + v
        return out

    def counted_sweep(inps, *a, **kw):
        out = real_sweep(inps, *a, **kw)
        if out is not None:
            batch["sweep sims"] = batch.get("sweep sims", 0) + sum(
                r is not None for r in out)
        return out
    env.solver.solve_batch = timed_batch
    env.solver.tpu._try_sweep = counted_sweep
    round_ms, spans = [], {}
    run_once = env.manager.run_once

    def timed_round():
        t = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t) * 1e3)
        for _, sps in tracing.finished_traces():
            for sp in sps:
                spans.setdefault(sp.name, []).append(sp.duration * 1e3)
        tracing.reset()
    env.manager.run_once = timed_round
    waves_drv = workloads.DisruptionWaves(env)
    tracing.set_enabled(True)
    waves = []
    try:
        with log:
            for wave, fn in enumerate((waves_drv.wave1, waves_drv.wave2,
                                       waves_drv.wave3), 1):
                ctl_s.clear()
                round_ms.clear()
                spans.clear()
                batch.clear()
                tracing.reset()
                log.wave = wave
                n_rows = len(log.rows)
                oracle0 = metrics.SOLVER_SOLVES.value(path="oracle")
                f0 = firstuse.total()
                watch.start(env.cluster)
                _reset_launches(ffd)
                t0 = time.perf_counter()
                answer = fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                launches = _read_launches(ffd)
                observed = watch.finish(env.cluster)
                shapes = {}
                for row in log.rows[n_rows:]:
                    key = f"{row[0]} {row[1]} B={row[3]} G={row[4]} " \
                          f"E={row[5]} N={row[6]}"
                    shapes[key] = shapes.get(key, 0) + 1
                waves.append({
                    "answer": disruption_pin(answer),
                    "wall_ms": wall, "round_ms": list(round_ms),
                    "pass_ms": list(spans.get("disruption.pass", [])),
                    "spans_ms": {k: sum(v) for k, v in spans.items()},
                    "controller_ms": {k: v * 1e3 for k, v in ctl_s.items()},
                    "solve_batch": dict(batch), "launches": launches,
                    "shapes": shapes,
                    "first_pass_first_use": first_pass["events"]
                    if first_pass.get("wave") == wave else None,
                    "oracle": metrics.SOLVER_SOLVES.value(path="oracle")
                    - oracle0,
                    "fallbacks": sum(1 for ev in waves_drv.last_events
                                     if ev[3] == "SolverFallback"),
                    "first_use": firstuse.total() - f0,
                    "observed": observed,
                    "hostops": native.hostops() is not None})
    finally:
        tracing.set_enabled(None)
        tracing.reset()
    return waves, warm, log


def _disruption_check(waves, label):
    """What phase 19 holds each wave to: the pinned JAX answer and what the
    JAX loop's ledger and timeline recorded (DISRUPTION_OBSERVED), no
    oracle solve, no SolverFallback event, kt_hostops loaded; and over the
    loop, K5 launched at B=64 and K4 launched."""
    bad = []
    for i, w in enumerate(waves):
        if w["answer"] != DISRUPTION_LOOP[i]:
            bad.append(f"{label} wave {i + 1}: {w['answer']} != "
                       f"{DISRUPTION_LOOP[i]}")
        if w["observed"] != DISRUPTION_OBSERVED[i]:
            bad.append(f"{label} wave {i + 1}: recorded {w['observed']} "
                       f"!= {DISRUPTION_OBSERVED[i]}")
        if w["oracle"]:
            bad.append(f"{label} wave {i + 1}: {w['oracle']} oracle solves")
        if w["fallbacks"]:
            bad.append(f"{label} wave {i + 1}: {w['fallbacks']} "
                       f"SolverFallback events")
        if not w["hostops"]:
            bad.append(f"{label} wave {i + 1}: kt_hostops not loaded")
    shapes = [k for w in waves for k in w["shapes"]]
    if not any(k.startswith("ffd_batch_scan disruption B=64 ")
               for k in shapes):
        bad.append(f"{label}: no B=64 ffd_batch_scan launch of a "
                   f"disruption pass")
    if not any(k.startswith("ffd_sweep_scan disruption ") for k in shapes):
        bad.append(f"{label}: no ffd_sweep_scan launch of a disruption "
                   f"pass")
    for k in ("ffd_batch_scan", "ffd_sweep_scan"):
        if sum(w["launches"][k] for w in waves) <= 0:
            bad.append(f"{label}: {k} not launched")
    return bad


def _disruption_print(label, waves, card):
    for i, w in enumerate(waves):
        sp = w["spans_ms"]
        rounds = w["round_ms"]
        pm = w["pass_ms"]
        print(f"[{label}] wave {i + 1} on {card}: {w['answer']}; to idle "
              f"{w['wall_ms']:.1f} ms in {len(rounds)} rounds (ms a round "
              f"p50 {_p50(rounds):.1f}, max {max(rounds):.1f}); "
              f"{len(pm)} disruption passes (ms a pass p50 "
              f"{_p50(pm) if pm else 0.0:.1f}, max "
              f"{max(pm) if pm else 0.0:.1f}); spans ms " + ", ".join(
                  f"{k} {v:.1f}" for k, v in sorted(sp.items())
                  if k.startswith(("disruption.", "provisioning.")))
              + "; controllers ms " + ", ".join(
                  f"{k} {v:.1f}" for k, v in w["controller_ms"].items())
              + "; solve_batch " + ", ".join(
                  f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
                  for k, v in w["solve_batch"].items())
              + f"; launches { {k: v for k, v in w['launches'].items() if v} }"
              f"; oracle solves {w['oracle']}, SolverFallback events "
              f"{w['fallbacks']}, first-use events {w['first_use']} (the "
              f"first disruption pass {w['first_pass_first_use']}); "
              f"recorded {w['observed']}", flush=True)
        for k, v in sorted(w["shapes"].items()):
            print(f"    [{label}] wave {i + 1} launch shape {k}: {v}",
                  flush=True)


def _first_pass(waves):
    """The first-use events of a loop's first disruption pass with
    candidates (None when it had none)."""
    return next((w["first_pass_first_use"] for w in waves
                 if w["first_pass_first_use"] is not None), None)


def _disruption_phase(card, add):
    """Phase 19: the cold loop in a child process and, beside it, the
    loop whose solver is warmed first, which keeps the launches phase 3
    holds to their plain versions; each run whole and held to the pins.
    Side by side, each loop's host times count the other's host work
    too; the answers, launches and first-use counts are each loop's own.
    Adds the warmed loop's launches with `add`; returns what failed and
    the warmed loop's `_LaunchLog`."""
    child = _start_child("disruption-cold")
    try:
        warmed, warm, log = _disruption_run(card, warm_up=True, keep=True)
    finally:
        cold, err = _finish_child(child, "disruption-cold")
    bad = []
    if cold is None:
        bad.append(f"the cold disruption loop failed: {err}")
    runs = {"warmed": warmed}
    if cold is not None:
        runs["cold"] = cold["waves"]
    for label, waves in runs.items():
        _disruption_print(f"19 {label} loop", waves, card)
        bad += _disruption_check(waves, label)
    for w in warmed:
        add(w["launches"])
    print(f"[19] warm-up on {card}: {warm['launches']} launches in "
          f"{warm['ms']:.1f} ms, first-use events {warm['first_use']}; "
          f"first-use events of the first disruption pass: warmed "
          f"{_first_pass(warmed)}, cold "
          f"{_first_pass(cold['waves']) if cold else None}",
          flush=True)
    missing = {"multi-node batch", "re-placement",
               "sweep chunk"} - set(log.kept)
    if missing:
        bad.append(f"the warmed loop made no {sorted(missing)} launch")
    return bad, log


# -- 25. configs #1, #6 and #13 at 1M pods, and the operator's tools -------
TOOLS_TIMEOUT_S = 600     # each tool's run in 25(d), at most
# 25(d)'s tool runs: (module of karpenter_tpu_torch.tools, its arguments,
# the exit code it must give: 0, or "nonzero")
TOOL_RUNS = (
    ("determinism", (), 0),
    ("determinism", ("--drill",), "nonzero"),
    ("kt_rewind", ("--generate", "smoke", "--seed", "7", "--seek", "40"), 0),
    ("allocatable_diff", (), 0),
)


def _config1_phase(ffd, card, TorchSolver, add):
    """Phase 25(a): BASELINE config #1 (workloads.build_config1: 100
    identical pods, 30 types) through K5 at B = 1 and its epilogue, one
    cold and 20 warm solves: the JAX package's nodes, unschedulable, hex
    price and result digest (CONFIG1).  Returns what failed."""
    from karpenter_tpu_torch.workloads import build_config1
    t0 = time.perf_counter()
    res, counts, _ = _main_path(TorchSolver, build_config1, ffd, card,
                                "25a config1")
    add(counts)
    bad = _check_answer(res, counts, *CONFIG1[:3],
                        ("ffd_batch_scan", "explain_pack"))
    if result_digest(res) != CONFIG1[3]:
        bad.append(f"25a: result digest {result_digest(res)[:16]} != "
                   f"{CONFIG1[3][:16]}")
    print(f"[25a] phase time {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    return bad


def _config6_phase(card, add):
    """Phase 25(b): BASELINE config #6 at CONFIG6_MESSAGES messages
    (workloads.build_config6: an Environment on the card, one m5.large
    instance and one launched claim a message, the interruption mix)
    drained by one interruption reconcile: the queue empty, and the
    claims deleted, the offerings marked unavailable and the deleted
    names' digest the JAX package's (CONFIG6); the drain's seconds and
    msgs/s printed.  Launches no kernel.  Returns what failed."""
    from karpenter_tpu_torch import workloads
    t0 = time.perf_counter()
    env = workloads.build_config6(CONFIG6_MESSAGES)
    build_s = time.perf_counter() - t0
    out = workloads.drain_config6(env)
    got = (out["claims_deleted"], out["offerings_unavailable"],
           out["names_digest"])
    print(f"[25b] config #6 on {card}: {CONFIG6_MESSAGES} instances, "
          f"claims and queued messages built in {build_s:.1f} s; "
          f"{out['messages']} messages drained in {out['drain_s']:.3f} s "
          f"({out['msgs_per_s']:.1f} msgs/s): queue empty "
          f"{out['drained']}, claims deleted {got[0]}, offerings marked "
          f"unavailable {got[1]}, deleted names {got[2][:16]}", flush=True)
    bad = []
    if not out["drained"]:
        bad.append("25b: the interruption queue is not empty")
    if got != CONFIG6:
        bad.append(f"25b: {got} != {CONFIG6}")
    return bad


def _config13_million_phase(card, add):
    """Phase 25(c): BASELINE config #13 as its benchmark sweeps it, in
    one process: CONFIG13_PODS and then CONFIG13_1M_PODS pods, each size
    through phase 12's incr and walk stories (`_config13`, the resident
    pods frozen in the collector before the timed passes): every
    generation the JAX package's digest (CONFIG13, CONFIG13_1M), every
    timed pass engaged with no fallback, K6 launched; the seconds to
    build each size's pods, the peak RSS, each story's timed p50 at both
    sizes and their ratios (flat_ratio, walk_ratio: printed, no limit).
    Returns what failed."""
    import resource

    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.solver import TorchSolver, ffd
    bad, p50, k56 = [], {}, {}
    for n, pins in ((CONFIG13_PODS, CONFIG13),
                    (CONFIG13_1M_PODS, CONFIG13_1M)):
        label = f"25c config13 {n}"
        t0 = time.perf_counter()
        workloads.build_config13(n, 0)
        print(f"[{label}] {n} pods built in "
              f"{time.perf_counter() - t0:.1f} s; peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB",
              flush=True)
        counts, b, p50[n] = _config13(ffd, card, TorchSolver,
                                      workloads.build_config13, n, pins,
                                      label, freeze=True)
        add(counts)
        bad += b
        k56[n] = (counts["ffd_batch_scan"], counts["ffd_delta_scan"])
        workloads._C13.pop(n, None)
    small, big = p50[CONFIG13_PODS], p50[CONFIG13_1M_PODS]
    print(f"[25c] config #13 on {card}: incr p50 {small['incr']:.3f} ms at "
          f"{CONFIG13_PODS}, {big['incr']:.3f} ms at {CONFIG13_1M_PODS} "
          f"(flat_ratio {big['incr'] / small['incr']:.3f}); walk p50 "
          f"{small['walk']:.3f} ms, {big['walk']:.3f} ms (walk_ratio "
          f"{big['walk'] / small['walk']:.3f}); K5, K6 launches "
          f"{k56[CONFIG13_PODS]} at {CONFIG13_PODS}, "
          f"{k56[CONFIG13_1M_PODS]} at {CONFIG13_1M_PODS}; peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB",
          flush=True)
    return bad


def _tools_phase(card, add):
    """Phase 25(d): the operator's tools, each `python -m
    karpenter_tpu_torch.tools.<tool>` in a process of its own with no
    platform variable (so on the card), all at once (TOOL_RUNS): the
    determinism harness exits 0 and its drill non-zero, kt_rewind's
    seek at event 40 of the smoke scenario is bit-identical with every
    invariant held, allocatable_diff exits 0.  Each one's seconds, exit
    code and last lines printed.  Returns what failed."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    for k in ("KARPENTER_TPU_PLATFORM", "KARPENTER_TPU_FORCE_CPU"):
        env.pop(k, None)
    runs = []
    for tool, args, want in TOOL_RUNS:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", f"karpenter_tpu_torch.tools.{tool}",
             *args], cwd=root, env=env, stdout=out, stderr=err, text=True)
        runs.append(dict(name=" ".join((tool,) + args), proc=proc, out=out,
                         err=err, want=want, t0=time.perf_counter(),
                         s=None))
    deadline = time.perf_counter() + TOOLS_TIMEOUT_S
    while any(r["s"] is None for r in runs):
        for r in runs:
            if r["s"] is None and r["proc"].poll() is not None:
                r["s"] = time.perf_counter() - r["t0"]
        if time.perf_counter() > deadline:
            for r in runs:
                if r["s"] is None:
                    r["proc"].kill()
                    r["proc"].wait()
                    r["s"] = time.perf_counter() - r["t0"]
        time.sleep(0.2)
    bad = []
    for r in runs:
        rc = r["proc"].returncode
        stdout, stderr = [f.seek(0) or f.read() for f in (r["out"],
                                                          r["err"])]
        for f in (r["out"], r["err"]):
            f.close()
        tail = [ln for ln in (stdout + stderr).splitlines()
                if not ln.startswith("ts=")][-3:]
        print(f"[25d] {r['name']} on {card}: exit code {rc} after "
              f"{r['s']:.1f} s; " + " | ".join(ln[:400] for ln in tail),
              flush=True)
        ok = rc != 0 if r["want"] == "nonzero" else rc == r["want"]
        if r["name"].startswith("kt_rewind") and ok:
            doc = json.loads(stdout.strip().splitlines()[-1])
            ok = (doc["seek_bit_identical"] and doc["invariants_held"]
                  and doc["device"] == "cuda")
        if r["name"] == "determinism --drill" and ok:
            ok = "MISMATCH" in stderr
        if not ok:
            bad.append(f"25d {r['name']}: exit code {rc}: "
                       f"{(stdout + stderr)[-1500:]}")
    return bad


def _child(mode: str) -> int:
    """The phases that run in a child process of their own: "headline"
    (phase 4's headline with the environment the parent set, for the
    KARPENTER_TPU_NO_NATIVE=1 arm), "cold-loop" (phase 18's cold loop,
    in a process that has launched nothing), "disruption-cold" (phase
    19's cold loop, the same), "entry" (phase 22(a)), "ha" (phase 22(b)),
    "rewind" (phase 23), "service" (phase 24), "config6" (phase 25(b)),
    "config13-1m" (25(c)) and "tools" (25(d)).  Prints one JSON line."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.solver import TorchSolver, ffd
    from karpenter_tpu_torch.workloads import build_input
    card = _card_line()
    if mode == "cards":
        return _cards_check(card)
    if mode in ("entry", "ha", "rewind", "service", "config6",
                "config13-1m", "tools"):
        # phases 22(a), 22(b), 23, 24 and 25(b)-(d) in a process of their
        # own: the kernels and kt_hostops built first (loaded as they are
        # when phase 2 built them), so no replica or tool builds them
        from karpenter_tpu_torch.solver import _cuda
        _cuda.build()
        if native.hostops() is None:
            print(f"chip_smoke: kt_hostops did not load: "
                  f"{native.build_error()}", file=sys.stderr)
            return 1
        launches = {}

        def add(counts):
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        t0 = time.perf_counter()
        bad = {"entry": _entry_phase, "ha": _ha_phase,
               "rewind": _rewind_phase, "service": _service_phase,
               "config6": _config6_phase,
               "config13-1m": _config13_million_phase,
               "tools": _tools_phase}[mode](card, add)
        print(json.dumps({"bad": bad, "launches": launches,
                          "s": time.perf_counter() - t0}))
        return 1 if bad else 0
    if mode == "trap":
        return _trap_check()
    if mode == "headline":
        p50 = {}
        res, counts, _ = _main_path(
            TorchSolver, lambda: build_input(HEADLINE_PODS), ffd, card,
            "4 headline, child", p50=p50)
        bad = _check_answer(res, counts, HEADLINE_NODES, HEADLINE_UNSCHED,
                            HEADLINE_PRICE_HEX,
                            ("ffd_batch_scan", "explain_pack"))
        print(json.dumps({"bad": bad, "p50": p50,
                          "hostops": native.hostops() is not None}))
        return 1 if bad else 0
    if mode == "disruption-cold":
        waves = _disruption_run(card)[0]
    else:
        waves, _ = _loop_run(card)
    torch.cuda.synchronize()
    print(json.dumps({"waves": waves}))
    return 0


def _cards_check(card) -> int:
    """`--child cards`: the column-sharded solve across the cards of this
    host (at least two).  Prints every card's name and power limit, the
    peer-access matrix and `nvidia-smi topo -m`; holds K7x (each
    instance) at S = 2 (cards 0-1) and S = 4 to its plain version on
    phase 21's cases; solves the headline, config #2 (also against mesh
    off), #9, #7 with delta on and the soft-term input with
    mesh="auto" against their pins, checking the transfers log (no
    column-axis byte after the first solve, each card holding only its
    slice) and holding every launch those solves made to its plain
    version; times K7x at S = 2 and 4 in turns beside K7 on one card at
    S = 2 and 4 and K5, at the headline and config #2, with the cost of
    one exchange and the NCCL yardstick (a single-process
    torch.cuda.nccl.all_reduce, MAX over [N] int32 on the same cards,
    never called by the port).  Ends with one JSON line."""
    import torch
    from karpenter_tpu_torch.parallel.mesh import probe_cards, shard_problem
    from karpenter_tpu_torch.solver import TorchSolver, _cuda, ffd
    from karpenter_tpu_torch.workloads import (
        build_config2, build_config7, build_config9, build_input,
        build_soft_terms)
    n_cards, peer = probe_cards()
    if n_cards < 2:
        print(f"the cross-card check needs two cards: this host has "
              f"{n_cards}", flush=True)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout
    for i, line in enumerate(smi):
        print(f"[cards] card {i}: {line}", flush=True)
    print(f"[cards] peer access {peer}", flush=True)
    print("[cards] nvidia-smi topo -m:\n" + topo, flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    print(f"[cards] built {', '.join(_cuda.KERNELS)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    devs = [torch.device("cuda", i) for i in range(n_cards)]
    sizes = [S for S in CARD_SIZES if S <= n_cards]
    bad, errs, seen = [], {}, {}

    def record(label, res, what):
        for k, (eq, err) in res.items():
            errs[k] = max(errs.get(k, 0.0), err)
            if not eq:
                bad.append(f"{label}:{k}")
        _EXPLAIN_SEEN.clear()
        print(f"[cards] {label:28s} {what}: " + ", ".join(
            f"{k} {'equal' if eq else 'DIFFERS'} (max abs err {err:g})"
            for k, (eq, err) in res.items()), flush=True)

    # -- K7x against its plain version on phase 21's cases ------------------
    solver = TorchSolver()
    head = _encoded_problem(solver, build_input(HEADLINE_PODS), ffd)
    c2 = _encoded_problem(solver, build_config2(), ffd)
    encoded = {"headline": head + (solver.max_nodes,),
               "config2": c2 + (CONFIG2_MAX_NODES,)}
    for label, S, prob, catarr, N, ex, seeds, want in _card_cases(encoded):
        if S not in sizes:
            continue
        res, missing = compare_cards(ffd, S, prob, catarr, N, ex, seeds,
                                     devs[:S], want)
        seen.update({k: True for k in res})
        record(label, res, f"K7x S={S} N={N} explain={ex} "
               f"{'+'.join(sorted(want)) or 'light'} x{K7_REPEATS}")
        if missing:
            bad.append(f"{label}: the problem has no {sorted(missing)}")

    # -- the stress case: CARD_STRESS launches back to back at S = 4 -------
    stress = None
    if n_cards >= 4:
        sbad, stress = _card_stress(ffd, devs[:4])
        bad.extend(sbad)
        print(f"[cards] stress: {stress['launches']} K7x launches back to "
              f"back at S=4 across 4 cards (three instances in turn, the "
              f"inboxes zeroed halfway), {stress['library_calls']} calls "
              f"into the kernel library; host {stress['host_ms']:.4f} ms a "
              f"launch, events {stress['events_ms']:.4f} ms a launch, "
              f"{stress['rounds']} rounds in the first half; every launch "
              f"{'equal to' if not sbad else 'NOT equal to'} its plain "
              f"version (max abs err {stress['max_abs_err']:g}) on "
              f"{smi[0]}", flush=True)

    # -- the main path: mesh="auto" over every card ------------------------
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def auto(max_nodes, mesh="auto"):
        return lambda: TorchSolver(mesh=mesh, max_nodes=max_nodes)

    def residency(sv, label):
        """Each card holds only its slice of every column-axis array."""
        cat = sv._cat_entry[1]
        cc = cat.mesh_args
        if not isinstance(cc, ffd.CardCatalog) or cc.S != n_cards:
            return [f"{label}: the catalog is {type(cc).__name__}"]
        out = []
        for name in ("col_alloc", "col_daemon", "pt_alloc", "col_pool",
                     "pool_bits", "col_zone", "col_ct"):
            for r, t in enumerate(getattr(cc, name)):
                if t.device != devs[r]:
                    out.append(f"{label}: {name}[{r}] on {t.device}")
        if any(t.shape[0] != cc.O_s for t in cc.col_alloc):
            out.append(f"{label}: a card holds more than its {cc.O_s} "
                       f"columns")
        table = cat.mask_registry.table
        if [t.device for t in table] != devs or any(
                t.shape[1] != cc.W_s for t in table):
            out.append(f"{label}: the mask table is not one slice a card")
        return out

    with _MeshCapture() as mcap:
        for label, m, kernels in (("config2-auto", "auto",
                                   ("ffd_card_scan", "explain_pack")),
                                  ("config2-off", "off",
                                   ("ffd_batch_scan", "explain_pack"))):
            n_cold = {}

            def after(sv, n_cold=n_cold):
                n_cold["n"] = (len(sv._mesh_exec.transfers)
                               if sv._mesh_exec is not None else 0)
            res, counts, sv = _main_path(
                auto(CONFIG2_MAX_NODES, m), build_config2, ffd, card, label,
                warm=MESH_WARM, after_cold=after)
            nodes, unsched, price_hex, digest = CONFIG2
            bad.extend(_check_answer(res, counts, nodes, unsched, price_hex,
                                     kernels))
            if result_digest(res) != digest:
                bad.append(f"{label}: digest {result_digest(res)}")
            if m == "off":
                continue
            add(counts)
            if sv.mesh is None or not sv.mesh.cards \
                    or sv.mesh.size != n_cards:
                bad.append(f"{label}: the mesh is {sv.mesh}")
                continue
            ex = sv._mesh_exec
            late = len(ex.transfers) - n_cold["n"]
            print(f"[cards] {label} column-axis transfers {ex.transfers}; "
                  f"after the first solve: {late}; blocks each card holds "
                  f"{[c.get('blocks') for c in ex._configs.values()]}",
                  flush=True)
            if late:
                bad.append(f"{label}: {late} column-axis transfers after "
                           f"the first solve")
            bad.extend(residency(sv, label))
        res, counts, _ = _main_path(
            auto(CONFIG_MAX_NODES), lambda: build_input(HEADLINE_PODS), ffd,
            card, "headline-auto", warm=MESH_WARM)
        add(counts)
        bad.extend(_check_answer(res, counts, HEADLINE_NODES,
                                 HEADLINE_UNSCHED, HEADLINE_PRICE_HEX,
                                 ("ffd_card_scan",)))
        res, counts, _ = _main_path(auto(CONFIG_MAX_NODES), build_config9,
                                    ffd, card, "config9-auto",
                                    warm=MESH_WARM)
        add(counts)
        nodes, unsched, price_hex, digest, trees = CONFIG9
        bad.extend(_check_answer(res, counts, nodes, unsched, price_hex,
                                 ("ffd_card_gang_scan",)))
        if result_digest(res) != digest or trees_digest(res) != trees:
            bad.append(f"config9-auto: digests {result_digest(res)} "
                       f"{trees_digest(res)}")
        n7 = MESH_CONFIG7_PASSES
        on7 = TorchSolver(mesh="auto", max_nodes=CONFIG_MAX_NODES)
        _reset_launches(ffd)
        ms, phases, verdicts, k6, bad7 = _lockstep(
            ffd, "config7-auto", {"auto-delta-on": on7},
            [lambda g=g: build_config7(g) for g in range(n7)],
            CONFIG7[:n7], card, timed_from=2)
        torch.cuda.synchronize()
        counts = _read_launches(ffd)
        add(counts)
        _report("config7-auto", ms, phases, verdicts, k6)
        print(f"[cards] config7-auto launches {counts}; delta passes "
              f"{on7.delta_passes}", flush=True)
        bad.extend(bad7)
        if any(v[0] != "delta" for v in verdicts["auto-delta-on"][1:]):
            bad.append("config7-auto: a pass after gen 0 was not a delta "
                       "pass")
        if counts["ffd_card_delta_scan"] < n7 - 1:
            bad.append(f"config7-auto: seeded K7x launches "
                       f"{counts['ffd_card_delta_scan']}")
        res, counts, sv = _main_path(auto(1024), build_soft_terms, ffd,
                                     card, "soft-terms-auto",
                                     warm=MESH_WARM)
        add(counts)
        nodes, unsched, price_hex, digest = SOFT
        bad.extend(_check_answer(res, counts, nodes, unsched, price_hex,
                                 ("ffd_card_scan",)))
        if result_digest(res) != digest:
            bad.append(f"soft-terms-auto: digest {result_digest(res)}")
        if sv.relax_counts["rounds"] < 2 * (1 + MESH_WARM):
            bad.append(f"soft-terms-auto: relaxation {sv.relax_counts}")

    # every K7x launch of those solves held to its plain version, on the
    # shards stacked on card 0; the first of each instance kept for its
    # times, with its rows replicated to every card as the executor does
    by_kind, first = {}, {}
    dev0 = devs[0]
    for call, (_, flat) in zip(mcap.calls, mcap.made):
        prob, table, cat, N, ex, wg, wp, seed = call
        lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, ex,
                              with_priority=wp)
        ref = (prob, torch.stack([t.to(dev0) for t in table]),
               cat.stacked(dev0), None if seed is None else ffd.DeltaSeed(
                   seed.seed_used, seed.seed_pool, seed.seed_active,
                   torch.stack([w.to(dev0) for w in seed.seed_colmask])))
        fp = torch.full_like(flat, float("nan"))
        lp = torch.full((prob.P, ffd.R), float("nan"), device=dev0)
        ffd.sharded_scan_reference(*ref[:3], N, fp, lay, lp, wg, ref[3])
        name = _card_name(wg, seed)
        by_kind.setdefault(name, []).append(_diff(flat, fp))
        first.setdefault(name, (call, lay, ref))
    for name, diffs in by_kind.items():
        record(f"main path {name}", {name: _merge(diffs)},
               f"{len(diffs)} launches")

    # -- times: K7x in turns beside K7 on one card and K5 (the profiler's
    # device time of a rank's kernel, of K7's cluster, of K5's block; K7x's
    # events and the host's ms a launch) ------------------------------------
    turns, exch, host_turns = {}, {}, {}
    for lab, (prob, catarr, N) in (("config #2", encoded["config2"]),
                                   ("headline", encoded["headline"])):
        arms = {f"K7x S={S}": _Cards(ffd, S, prob, catarr, N, 1, None,
                                     devs[:S]) for S in sizes}
        k7 = {}
        for S in sizes:
            p, table, sc, _ = shard_problem(prob, catarr, S, devs[0])
            lay = ffd.flat_layout(p.G, p.E, N, p.D, 1)
            fl = torch.empty(lay["total"][1], device=devs[0])
            lm = torch.empty((p.P, ffd.R), device=devs[0])
            k7[f"K7 S={S}"] = (lambda p=p, table=table, sc=sc, lay=lay,
                               fl=fl, lm=lm: _device_ms(
                                   lambda: ffd.sharded_scan(
                                       p, table, sc, N, fl, lay, lm, 0), 20,
                                   _tag(True, False, False, False, 1)))
        p5, c5 = ffd.problem_from_numpy(prob, catarr, devs[0])
        b5 = ffd.FFDBatch.of(p5)
        lay5 = ffd.flat_layout(p5.G, p5.E, N, p5.D, 1)
        fl5 = torch.empty((1, lay5["total"][1]), device=devs[0])
        lm5 = torch.empty((1, p5.P, ffd.R), device=devs[0])
        k5 = {"K5": lambda: _device_ms(
            lambda: ffd.batch_scan(b5, c5, N, fl5, lay5, lm5), 20,
            _tag(True, False, False))}
        t = turns[lab] = {}
        ev = {}
        hosts = host_turns[lab] = {}
        order = list(arms) + list(k7) + list(k5)
        for rnd in range(3):
            for arm in (order if rnd % 2 == 0 else order[::-1]):
                if arm in arms:
                    ms_, ev_, host_ = arms[arm].times(20)
                    hosts.setdefault(arm, []).append(host_)
                else:
                    ms_, ev_ = (k7.get(arm) or k5[arm])()
                t.setdefault(arm, []).append(ms_)
                ev.setdefault(arm, []).append(ev_)
        G = arms[f"K7x S={sizes[0]}"].ref[0].G
        print(f"[cards] {lab} (G={G}, N={N}) in turns on {smi[0]}: "
              + "; ".join(f"{a} " + ", ".join(f"{v:.4f}" for v in vs)
                          + " ms" for a, vs in t.items())
              + "; events a launch: " + "; ".join(
                  f"{a} " + ", ".join(f"{v:.4f}" for v in vs) + " ms"
                  for a, vs in ev.items())
              + "; host a launch: " + "; ".join(
                  f"{a} " + ", ".join(f"{v:.4f}" for v in vs) + " ms"
                  for a, vs in hosts.items()), flush=True)
        for S in sizes:
            c = arms[f"K7x S={S}"]
            xch = ffd.card_exchange(devs[:S])
            c.sync()
            r0 = xch.rounds()
            c.launch(*c.bufs())
            c.sync()
            rounds = xch.rounds() - r0
            extra = (min(t[f"K7x S={S}"]) - min(t[f"K7 S={S}"])) / rounds
            exch[f"{lab} S={S}"] = {
                "rounds": rounds, "k7x_ms_a_round":
                min(t[f"K7x S={S}"]) / rounds,
                "over_cluster_ms_a_round": extra}
            print(f"[cards] {lab} S={S}: {rounds} exchange rounds a "
                  f"launch; K7x {min(t[f'K7x S={S}']) / rounds * 1e3:.2f} "
                  f"us a round, {extra * 1e3:.2f} us a round over K7's "
                  f"cluster exchange", flush=True)
    # the NCCL yardstick: MAX over [N] int32 on the same cards
    nccl = {}
    for S in sizes:
        xs = [torch.zeros(CONFIG_MAX_NODES, dtype=torch.int32, device=d)
              for d in devs[:S]]
        try:
            nccl[f"S={S}"] = _span_ms(
                lambda xs=xs: torch.cuda.nccl.all_reduce(xs, op=2), 50,
                devs[:S])
        except Exception as e:  # a yardstick, not a phase: report it
            nccl[f"S={S}"] = f"not measured: {e}"
        print(f"[cards] NCCL yardstick all_reduce MAX [{CONFIG_MAX_NODES}] "
              f"int32 S={S}: {nccl[f'S={S}']} ms a call", flush=True)
    # K7x at its main path's own launches (the first of each instance)
    kernels = {}
    for name in ("ffd_card_scan", "ffd_card_gang_scan",
                 "ffd_card_delta_scan"):
        if name not in first:
            bad.append(f"no {name} launch on the main path")
            continue
        (prob, table, cat, N, _, wg, _, seed), lay, ref = first[name]
        flat = torch.empty(lay["total"][1], device=dev0)
        lim = torch.empty((prob.P, ffd.R), device=dev0)

        plans = [None]

        def launch(prob=prob, table=table, cat=cat, N=N, lay=lay, wg=wg,
                   seed=seed, flat=flat, lim=lim, plans=plans):
            plans[0] = ffd.card_scan(prob, table, cat, N, flat, lay, lim, wg,
                                     seed, plan=plans[0])
        ms_, ev_ = _device_ms(launch, 20, _tag(
            seed is None, False, bool(wg), seed is not None, 2))
        host_ = _host_ms(launch, 20, devs)
        plain = _time_ms(lambda: ffd.sharded_scan_reference(
            *ref[:3], N, flat, lay, lim, wg, ref[3]), 1)
        bound = _sharded_bound(ffd, *ref[:3], N, lay, flat, lim, wg, ref[3],
                               spread=cat.S)
        shape = (cat.S, prob.G, prob.E, N, cat.O)
        kernels[name] = {"ms": ms_, "events_ms": ev_, "host_ms": host_,
                         "plain_ms": plain, "bound": bound, "shape": shape,
                         "measured": f"across {cat.S} cards"}
        print(f"[cards] {name} at its main path's launch (S, G, E, N, O) "
              f"{shape} on {smi[0]}: {ms_:.4f} ms a rank's kernel "
              f"({ms_ / prob.G:.4f} ms a step; events {ev_:.4f} a launch, "
              f"host {host_:.4f} a launch, plain {plain:.3f}, bound "
              f"{bound[0]:.6f} by {bound[1]})", flush=True)
    for d in devs:
        torch.cuda.synchronize(d)
    for k in ("ffd_card_scan", "ffd_card_gang_scan", "ffd_card_delta_scan"):
        if not launches.get(k):
            bad.append(f"{k} was not launched on the main path")
    print(json.dumps({"bad": bad, "cards": smi, "peer": peer,
                      "launches": launches, "errs": errs,
                      "kernels": kernels, "turns": turns,
                      "host_turns": host_turns, "exchange": exch,
                      "nccl": nccl, "stress": stress}))
    return 1 if bad else 0


def _trap_check() -> int:
    """`--child trap`: rank 0 of a two-rank K7x exchange launched alone on
    this card, its peer never launched: its first exchange round must wait
    out the exchange's deadline and trap, and the next synchronise must
    report it.  Prints one JSON line; exits 0 only if the launch failed."""
    import torch
    from karpenter_tpu_torch.parallel.mesh import shard_problem
    from karpenter_tpu_torch.solver import ffd
    from karpenter_tpu_torch.solver.problems import random_problem
    dev = torch.device("cuda", 0)
    prob, cat = random_problem(11)
    p, table, sc, _ = shard_problem(prob, cat, 2, dev)
    lay = ffd.flat_layout(p.G, p.E, 64, p.D, 1)
    flat = torch.empty(lay["total"][1], device=dev)
    lim = torch.empty((p.P, ffd.R), device=dev)
    xch = ffd.CardExchange((dev, dev))
    entry, inputs, mesh, A = ffd._sharded_launch_args(p, table, sc, lay, 0,
                                                      None)
    mesh.update(reps=1)
    slot_ids = torch.cat([sc.col_zone[0, :sc.zc], sc.col_ct[0, :sc.zc]])
    t0 = time.perf_counter()
    ffd._launch_scan(ffd._CARD_ENTRY[entry], 1, p.G, p.E, 64, p.P, p.D, 0,
                     sc, flat, lay, lim, 0, inputs, A=A, mesh=mesh,
                     xcard=(xch, 0, 0, slot_ids))
    try:
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(json.dumps({"trapped": True, "s": time.perf_counter() - t0,
                          "error": str(e).splitlines()[0][:200]}))
        return 0
    print(json.dumps({"trapped": False, "s": time.perf_counter() - t0}))
    return 1


def _start_child(mode: str, env=None):
    """Start `_child(mode)` in a child process, its output to files (a
    child that runs beside the parent must never block on a full pipe)."""
    out = tempfile.TemporaryFile("w+")
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", mode],
        stdout=out, stderr=err, text=True,
        env=dict(os.environ, **(env or {})))
    proc.outputs = (out, err)
    return proc


def _finish_child(proc, mode: str, timeout=600):
    """Wait for a `_start_child` process and print its output; its JSON
    line, or None and its output when it failed."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    stdout, stderr = [f.seek(0) or f.read() for f in proc.outputs]
    for f in proc.outputs:
        f.close()
    lines = stdout.strip().splitlines()
    for line in lines:
        print(f"    [child {mode}] {line}", flush=True)
    if proc.returncode != 0 or not lines:
        return None, stderr[-4000:]
    return json.loads(lines[-1]), None


def _run_child(mode: str, env=None, timeout=600):
    """Run `_child(mode)` in a child process; its JSON line, or None and
    the child's output when it failed."""
    return _finish_child(_start_child(mode, env), mode, timeout)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--child"] and len(argv) == 2:
        return _child(argv[1])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch.solver import TorchSolver, _cuda, ffd
    from karpenter_tpu_torch.workloads import (
        build_config2, build_config3, build_config4, build_config4b,
        build_config7, build_config9, build_config10, build_config12,
        build_config13, build_input, build_soft_terms)

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
    # the native host paths: no silent fallback to the Python loops here
    from karpenter_tpu_torch import native
    t0 = time.perf_counter()
    if native.hostops() is None:
        print(f"chip_smoke: kt_hostops did not load (the Python host paths "
              f"would run): {native.build_error() or 'KARPENTER_TPU_NO_NATIVE set'}",
              file=sys.stderr)
        return 1
    print(f"[2] kt_hostops loaded ({native.hostops().__file__}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # -- 18. the provisioning control loop, run here: before any other
    # phase launches a kernel, so that the warm-up check starts from a
    # process that has launched nothing -------------------------------------
    loop_calls = []
    t0 = time.perf_counter()
    bad, loop_p50 = _loop_phase(card, add, loop_calls)
    print(f"[18] phase time {time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        print(f"chip_smoke: the provisioning loop failed: {bad}",
              file=sys.stderr)
        return 1

    # -- 19. the disruption control loop, here too: its warmed loop keeps
    # the launches phase 3 holds to their plain versions.  Beside it, each
    # in a child process, the phases that launch nothing in this process:
    # 22(a) the operator's entry point as its own process, 22(b) the HA
    # pair, 23 config #11's rewind day through a real Operator.  Each is
    # host-bound on processes of its own, and one after the other they do
    # not fit the script's time limit; every child ends before phase 3
    # times a kernel ----------------------------------------------------
    t19 = time.perf_counter()
    children = {mode: _start_child(mode) for mode in ("entry", "ha",
                                                      "rewind", "service")}
    try:
        bad, disruption_log = _disruption_phase(card, add)
        print(f"[19] phase time {time.perf_counter() - t19:.1f} s",
              flush=True)
        if bad:
            print(f"chip_smoke: the disruption loop failed: {bad}",
                  file=sys.stderr)
            return 1

        # -- 25(b)-(d), each in a child process beside phase 20 (the
        # children of 22-24 mostly done by then): config #6 at 15,000
        # messages, config #13 at 50k and 1M pods, the operator's tools
        children.update({mode: _start_child(mode) for mode in (
            "config6", "config13-1m", "tools")})

        # -- 20. the external cluster stores and the restored dispatch
        # hook ------------------------------------------------------------
        t0 = time.perf_counter()
        bad = _stores_phase(card, add, loop_p50)
        bad += _fault_phase(card, add)
        print(f"[20] phase time {time.perf_counter() - t0:.1f} s",
              flush=True)
        if bad:
            print(f"chip_smoke: the external stores or the dispatch fault "
                  f"failed: {bad}", file=sys.stderr)
            return 1
        for mode, phase in (("entry", "22a"), ("ha", "22b"),
                            ("rewind", "23"), ("service", "24"),
                            ("config6", "25b"), ("config13-1m", "25c"),
                            ("tools", "25d")):
            out, err = _finish_child(children.pop(mode), mode,
                                     timeout=1200)
            print(f"[{phase}] the child took "
                  f"{out['s'] if out else float('nan'):.1f} s on {card} "
                  f"and ended "
                  f"{time.perf_counter() - t19:.1f} s after phase 19 "
                  f"began", flush=True)
            if out is None:
                bad.append(f"{phase}: the child failed: {err}")
            else:
                bad += out["bad"]
                add(out["launches"])
        if bad:
            print(f"chip_smoke: phase 22, 23, 24 or 25 failed: {bad}",
                  file=sys.stderr)
            return 1
    finally:
        for mode, proc in children.items():
            _finish_child(proc, mode, timeout=1200)

    # -- 3. kernels against their plain versions ---------------------------
    errs = {k: 0.0 for k in list(KERNELS) + list(PASSES)
            + ["te_compaction"]}
    failed = []

    map_classes = set()

    def record(label, res, what):
        """Print one comparison; fail on a difference, and for the main
        paths' encodings (EXPLAIN_NONTRIVIAL) on explain rows whose
        counts are all 0."""
        trivial_ok = label not in EXPLAIN_NONTRIVIAL
        for k, (eq, err) in res.items():
            errs[k] = max(errs[k], err)
            if not eq:
                failed.append(f"{label}:{k}")
        seen = list(_EXPLAIN_SEEN)
        _EXPLAIN_SEEN.clear()
        nonzero = [nz for nz, _ in seen]
        for _, cls in seen:
            map_classes.update(cls)
        if seen and not all(nonzero) and not trivial_ok:
            failed.append(f"{label}: every explain count is 0")
        print(f"[3] {label:28s} {what}: " + ", ".join(
            f"{k} {'equal' if eq else 'DIFFERS'} (max abs err {err:g})"
            for k, (eq, err) in res.items())
            + (f"; explain rows non-trivial {nonzero}" if seen else ""),
            flush=True)

    solver = TorchSolver()
    head_prob, head_cat = _encoded_problem(solver, build_input(HEADLINE_PODS),
                                           ffd)
    c3_prob, c3_cat = _encoded_problem(solver, build_config3(), ffd)
    c9_prob, c9_cat = _encoded_problem(solver, build_config9(), ffd)
    c10_prob, c10_cat = _encoded_problem(solver, build_config10(), ffd)
    cases = list(_seeded_cases()) + [
        ("headline", head_prob, head_cat, solver.max_nodes, 1),
        ("headline-explain-off", head_prob, head_cat, solver.max_nodes, 0),
        ("config3-cold", c3_prob, c3_cat, solver.max_nodes, 1),
        ("config3-warm", c3_prob, c3_cat, CONFIG3_WARM_N, 1),
        ("config9-cold-full", c9_prob, c9_cat, CONFIG_MAX_NODES, 2),
        ("config9-warm", c9_prob, c9_cat, CONFIG3_WARM_N, 1),
        ("config10-cold", c10_prob, c10_cat, CONFIG_MAX_NODES, 1),
        ("config10-warm-full", c10_prob, c10_cat, CONFIG3_WARM_N, 2)]
    for label, prob, catarr, N, ex in cases:
        record(label, compare_case(ffd, prob, catarr, N, ex, dev),
               f"N={N} explain={ex}")
    one_launch = {}
    for label, probs, catarr, N, ex, K in _batch_cases():
        c = ffd.catalog_tensors(catarr, dev)
        b = ffd.batch_tensors(probs, c.O, dev)
        record(label, compare_batch(ffd, b, c, N, ex, K, dev),
               f"B={b.B} N={N} explain={ex} K={K}")
        if ex and b.B == 64:
            one_launch[label] = _launches_of(
                ffd, lambda: ffd.solve_ffd_batch(b, c, N, ex, K))
    for label, probs, catarr, N, ex in _gang_cases():
        c = ffd.catalog_tensors(catarr, dev)
        b = ffd.batch_tensors(probs, c.O, dev)
        wg, wp = _statics(probs)
        record(label, compare_batch(ffd, b, c, N, ex, 0, dev, wg, wp),
               f"B={b.B} N={N} explain={ex} gang={wg} prio={wp}")
    # phase 18's own launches (its first fresh loop), on the tensors the
    # loop gave them: K5 of each one-problem solve, K6 of
    # each seeded one
    for w, cap in enumerate(loop_calls, 1):
        for j, (p, c, N, ex, wg, wp) in enumerate(cap["solve"]):
            record(f"loop-wave{w}-solve{j}",
                   compare_batch(ffd, ffd.FFDBatch.of(p), c, N, ex, 0, dev,
                                 wg, wp),
                   f"G={p.G} E={p.E} N={N} O={c.O} explain={ex} gang={wg} "
                   f"prio={wp}")
        for j, (p, sd, c, N, ex) in enumerate(cap["delta"]):
            record(f"loop-wave{w}-delta{j}",
                   compare_delta(ffd, p, sd, c, N, ex),
                   f"G={p.G} A={sd.A} N={N} E={p.E} explain={ex}")
    # phase 19's own launches (its warmed loop), on the tensors the loop
    # gave them: the first B=64 K5 launch of a multi-node pass, the first
    # K4 chunk and a wave-2 re-placement K5 launch with E > 1,000
    for key, call in sorted(disruption_log.kept.items()):
        if call[0] == "batch":
            _, b, c, N, ex, K, wg, wp = call
            record(f"disruption-{key.replace(' ', '-')}",
                   compare_batch(ffd, b, c, N, ex, K, dev, wg, wp),
                   f"B={b.B} G={b.G} E={b.E} N={N} O={c.O} explain={ex} "
                   f"K={K}")
        else:
            _, sw, c, N, K = call
            for suffix, res, n, route in compare_sweep_routes(
                    ffd, sw, c, N, K, dev):
                record(f"disruption-{key.replace(' ', '-')}{suffix}", res,
                       f"B={sw.B} G={sw.G} E={sw.E} D={sw.D} N={n} K={K} "
                       f"{route} carry")
    for label, prob, catarr, seeds, N, ex in _delta_cases():
        c = ffd.catalog_tensors(catarr, dev)
        p, sd = ffd.delta_tensors(prob, *seeds, c.O, dev)
        record(label, compare_delta(ffd, p, sd, c, N, ex),
               f"A={sd.A} N={N} E={p.E} explain={ex}")
        if ex and "delta" not in one_launch:
            one_launch["delta"] = _launches_of(
                ffd, lambda: ffd.solve_ffd_delta(p, sd, c, N, ex))
    # K6 at the steady state's own encodings, as the solver launches them:
    # config #7's churned suffix (gen 0, then the delta pass of gen 1) and
    # config #12's first two chunks (the second seeded with the first's
    # 128 nodes)
    s7 = TorchSolver(max_nodes=CONFIG_MAX_NODES)
    s7.solve(build_config7(0))
    with _DeltaCapture(ffd) as cap7:
        s7.solve(build_config7(1))
    s12 = TorchSolver(max_nodes=CONFIG_MAX_NODES, delta="off", spec="on")
    with _DeltaCapture(ffd) as cap12:
        s12.solve(build_config12())
    # config #7's delta-off pass runs the chunk chain (spec auto), and
    # config #12's spec-off arm one K5 program (timed in phase 9)
    with _DeltaCapture(ffd) as cap7c:
        TorchSolver(max_nodes=CONFIG_MAX_NODES, delta="off").solve(
            build_config7(0))
    with _SolveCapture(ffd) as cap12o:
        TorchSolver(max_nodes=CONFIG_MAX_NODES, delta="off",
                    spec="off").solve(build_config12())
    if (not cap7.calls or len(cap12.calls) < 2 or len(cap7c.calls) < 2
            or not cap12o.calls):
        print(f"chip_smoke: config #7 launched {len(cap7.calls)} seeded "
              f"solves (delta off: {len(cap7c.calls)}), config #12 "
              f"{len(cap12.calls)} (spec off: {len(cap12o.calls)} "
              f"solves)", file=sys.stderr)
        return 1
    for label, (p, sd, c, N, ex) in (("config7-suffix", cap7.calls[0]),
                                     ("config7-chain-chunk1",
                                      cap7c.calls[1]),
                                     ("config12-chunk0", cap12.calls[0]),
                                     ("config12-chunk1", cap12.calls[1])):
        record(label, compare_delta(ffd, p, sd, c, N, ex),
               f"G={p.G} A={sd.A} N={N} E={p.E} explain={ex}")
    # K4 on both carry routes: at the case's N (the carry in shared
    # memory) and at an N whose carry does not fit (in device memory)
    for label, rows, shared, catarr, N, K in _sweep_cases():
        c = ffd.catalog_tensors(catarr, dev)
        sw = ffd.sweep_tensors(rows, ffd.sweep_shared_tensors(
            shared, c.O, dev), dev)
        for suffix, res, n, route in compare_sweep_routes(ffd, sw, c, N, K,
                                                          dev):
            record(label + suffix, res,
                   f"B={sw.B} E={sw.E} D={sw.D} N={n} K={K} {route} carry")
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
        for suffix, res, n, route in compare_sweep_routes(ffd, sw, c, N, K,
                                                          dev):
            record(label + suffix, res,
                   f"B={sw.B} G={sw.G} E={sw.E} D={sw.D} N={n} K={K} "
                   f"{route} carry")
    # K7, the column-sharded scan, against its plain version at 2, 4, 6
    # and 8 shards, each launch repeated, then at the mesh paths' own
    # encodings (the headline and config #2) at 8 shards
    from karpenter_tpu_torch.parallel.mesh import card_mesh, shard_problem
    for label, S, prob, catarr, N, ex, seeds, want in _sharded_cases():
        res, n, missing = compare_sharded(ffd, S, prob, catarr, N, ex, seeds,
                                          dev, want)
        record(label, res, f"S={S} N={N} explain={ex} clusters={n} "
                           f"{'+'.join(sorted(want)) or 'light'} "
                           f"x{K7_REPEATS}")
        if missing:
            failed.append(f"{label}: the problem has no {sorted(missing)}")
    c2_prob, c2_cat = _encoded_problem(solver, build_config2(), ffd)
    for label, prob, catarr, N in (
            ("headline-S8", head_prob, head_cat, solver.max_nodes),
            ("config2-S8", c2_prob, c2_cat, CONFIG2_MAX_NODES)):
        res, n, _ = compare_sharded(ffd, MESH, prob, catarr, N, 1, None, dev)
        record(label, res, f"S={MESH} N={N} clusters={n} x{K7_REPEATS}")
    occ = {}
    for S in (2, 4, 8, 16):
        p, table, sc, _ = shard_problem(head_prob, head_cat, S, dev)
        lay = ffd.flat_layout(p.G, p.E, solver.max_nodes, p.D, 1)
        occ[S] = ffd.sharded_clusters(p, table, sc, solver.max_nodes, lay)
    print(f"[3] K7 ffd_sharded_scan at the headline's shape (1024 threads "
          f"a block): cudaOccupancyMaxActiveClusters by cluster size "
          f"{occ}", flush=True)
    # -- 21. K7x rehearsed on this card: each instance as one cooperative
    # grid of S blocks (every rank's inbox in this card's memory), held to
    # its plain version on the 32 seeded problems and the headline's and
    # config #2's encodings at S = 2 and 4, each launched 3 times
    encoded = {"headline": (head_prob, head_cat, solver.max_nodes),
               "config2": (c2_prob, c2_cat, CONFIG2_MAX_NODES)}
    for label, S, prob, catarr, N, ex, seeds, want in _card_cases(encoded):
        res, missing = compare_cards(ffd, S, prob, catarr, N, ex, seeds,
                                     (dev,) * S, want)
        record(f"21 {label}", res, f"K7x rehearsal S={S} N={N} "
               f"explain={ex} {'+'.join(sorted(want)) or 'light'} "
               f"x{K7_REPEATS}")
        if missing:
            failed.append(f"21 {label}: the problem has no "
                          f"{sorted(missing)}")
    # K7x's times in the rehearsal (one card, its S blocks' exchanges
    # through this card's memory) at config #2's, config #9's and a
    # seeded problem's shapes at S = 4
    k7x_t = {}
    s4_delta = next(c for c in _sharded_cases() if c[0] == "S4-delta")
    for prob, catarr, N, seeds in ((c2_prob, c2_cat, CONFIG2_MAX_NODES,
                                    None),
                                   (c9_prob, c9_cat, CONFIG_MAX_NODES, None),
                                   (s4_delta[2], s4_delta[3], s4_delta[4],
                                    s4_delta[6])):
        c = _Cards(ffd, 4, prob, catarr, N, 1, seeds, (dev,) * 4)
        flat, lim = c.bufs()
        t, ev, host = c.times(20)
        k7x_t[c.name] = {"ms": t, "events_ms": ev, "host_ms": host,
                         "plain_ms": _time_ms(lambda: c.plain(flat, lim), 1),
                         "bound": c.bound(), "shape": c.shape,
                         "measured": "rehearsal: S blocks on one card, "
                                     "no main path on one card"}
        print(f"[21] {c.name} rehearsed (S, G, E, N, O) {c.shape} on "
              f"{card}: {t:.4f} ms (events {ev:.4f}, host {host:.4f} a "
              f"launch, plain {k7x_t[c.name]['plain_ms']:.3f}, bound "
              f"{k7x_t[c.name]['bound'][0]:.6f} by "
              f"{k7x_t[c.name]['bound'][1]})", flush=True)
    # the stress case, rehearsed: CARD_STRESS launches back to back at S=4
    sbad, stress = _card_stress(ffd, (dev,) * 4)
    failed.extend(f"21 {b}" for b in sbad)
    print(f"[21] stress: {stress['launches']} K7x launches back to back, "
          f"rehearsed at S=4 (three instances in turn, the inboxes zeroed "
          f"halfway), {stress['library_calls']} calls into the kernel "
          f"library; host {stress['host_ms']:.4f} ms a launch, events "
          f"{stress['events_ms']:.4f} ms a launch, {stress['rounds']} "
          f"rounds in the first half; every launch "
          f"{'equal to' if not sbad else 'NOT equal to'} its plain version "
          f"(max abs err {stress['max_abs_err']:g}) on {card}", flush=True)
    # the fit check's occupancy query (`ffd.card_blocks`, which the
    # executor makes once a launch configuration) must not lower the
    # shared-memory attribute a launch already raised: config #2's S=2
    # rehearsal, the query at its S=4 shape, the S=2 launch again
    c = _Cards(ffd, 2, c2_prob, c2_cat, CONFIG2_MAX_NODES, 1, None,
               (dev,) * 2)
    c.launch(*c.bufs())
    p4, t4, cc4, _ = shard_problem(c2_prob, c2_cat, card_mesh([dev] * 4))
    blocks = ffd.card_blocks(p4, t4, cc4, CONFIG2_MAX_NODES, ffd.flat_layout(
        p4[0].G, p4[0].E, CONFIG2_MAX_NODES, p4[0].D, 1))
    fk, lk = c.bufs()
    c.launch(fk, lk)
    c.sync()
    fp, lp = c.bufs()
    c.plain(fp, lp)
    record("21 launch after the fit check", {c.name: _merge(
        [_diff(fk, fp), _diff(lk, lp)])}, f"K7x rehearsal S=2 after "
        f"card_blocks at S=4 (blocks {blocks})")
    auto = TorchSolver(mesh="auto")
    print(f"[21] TorchSolver(mesh='auto') on {torch.cuda.device_count()} "
          f"card(s): mesh {auto.mesh}", flush=True)
    if torch.cuda.device_count() == 1 and auto.mesh is not None:
        failed.append(f"21: mesh='auto' on one card resolved to "
                      f"{auto.mesh}, not the single-device path")
    # a lost rank fails its launch: rank 0 of two, alone, in a child
    # process (a trap ends the process's CUDA context)
    got, err = _run_child("trap", timeout=180)
    print(f"[21] a K7x rank whose peer never comes: {got or err}",
          flush=True)
    if got is None or not got.get("trapped"):
        failed.append(f"21: the lone rank's launch did not fail: "
                      f"{got or err}")
    # the epilogue: every map class across the cases, and one launch for
    # a batch's problems with their explain rows, one for a seeded solve
    print(f"[3] explain map classes the kernels wrote: "
          f"{sorted(map_classes)}; launches of one explain=counts "
          f"solve_ffd_batch (B=64) and solve_ffd_delta: {one_launch}",
          flush=True)
    if not {1, 2, 3, 4} <= map_classes:
        failed.append(f"explain map classes {sorted(map_classes)}: not "
                      f"each of 1-4")
    want_one = {"batch-64-explain": "ffd_batch_scan",
                "delta": "ffd_delta_scan"}
    for label, k in want_one.items():
        n = one_launch.get(label, {})
        kernels_run = {kk: v for kk, v in n.items() if kk in KERNELS and v}
        if kernels_run != {k: 1} or n.get("explain_pack") != 1:
            failed.append(f"{label}: launches {n}, not one {k} with its "
                          f"explain rows")
    if failed:
        print(f"chip_smoke: kernels disagree with their plain versions: "
              f"{failed}", file=sys.stderr)
        return 1

    # -- 4. the main path: the 50k headline ----------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    p50_on = {}
    seq0 = _flight_seq()
    res, counts, _ = _main_path(
        TorchSolver, lambda: build_input(HEADLINE_PODS), ffd, card,
        "4 headline", p50=p50_on)
    add(counts)
    print(f"[4 headline] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    bad = _check_answer(res, counts, HEADLINE_NODES, HEADLINE_UNSCHED,
                        HEADLINE_PRICE_HEX, ("ffd_batch_scan", "explain_pack"))
    bad += _check_flight(seq0, WARM_SOLVES + 1, "4 headline", card)
    if bad:
        print(f"chip_smoke: headline path failed: {bad}", file=sys.stderr)
        return 1
    # the same path with the host fast paths pinned off, in a child process
    off, err = _run_child("headline", {"KARPENTER_TPU_NO_NATIVE": "1"})
    if off is None or off["bad"] or off["hostops"]:
        print(f"chip_smoke: the headline with KARPENTER_TPU_NO_NATIVE=1 "
              f"failed: {off or err}", file=sys.stderr)
        return 1
    p50_off = off["p50"]
    print(f"[4 headline] warm p50 ms on {card}, kt_hostops on | off "
          f"(KARPENTER_TPU_NO_NATIVE=1, child process): " + ", ".join(
              f"{k} {p50_on[k]:.3f} | {p50_off[k]:.3f}"
              for k in ("e2e", "encode", "decode")), flush=True)

    # -- 5. the main path: config #3 (topology spread) -----------------------
    res, counts, _ = _main_path(TorchSolver, build_config3, ffd, card,
                                "5 config3")
    add(counts)
    bad = _check_answer(res, counts, CONFIG3_NODES, CONFIG3_UNSCHED,
                        CONFIG3_PRICE_HEX, ("ffd_batch_scan", "explain_pack"))
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

    # -- 8. gangs, priority bands and explain=full: config #9 and #10 -------
    from karpenter_tpu_torch.scheduling.types import (
        gang_placement_audit, priority_inversion_audit)

    def big_solver():
        return TorchSolver(max_nodes=CONFIG_MAX_NODES)

    maps = []
    real_unpack = ffd.unpack

    def capture(*a, **kw):
        out = real_unpack(*a, **kw)
        if "explain_map" in out:
            maps.append(out["explain_map"])
        return out

    for label, build, want, kernels, passes, full in (
            ("8 config9", build_config9, CONFIG9,
             ("ffd_batch_gang_scan", "explain_pack"), (), False),
            ("8 config10", build_config10, CONFIG10,
             ("ffd_batch_scan", "explain_pack"), ("priority_witness",), False),
            ("8 config9-explain-full", build_config9, CONFIG9,
             ("ffd_batch_gang_scan", "explain_pack"), ("explain_map",), True)):
        if full:
            os.environ["KARPENTER_TPU_EXPLAIN"] = "full"
            ffd.unpack = capture
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            res, counts, s = _main_path(big_solver, build, ffd, card, label)
        finally:
            os.environ.pop("KARPENTER_TPU_EXPLAIN", None)
            ffd.unpack = real_unpack
        add(counts)
        print(f"[{label}] max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
        nodes, unsched, price_hex, digest, trees = want
        trees = CONFIG9_FULL_TREES if full else trees
        bad = _check_answer(res, counts, nodes, unsched, price_hex,
                            kernels + passes)
        got = result_digest(res)
        print(f"[{label}] result digest {got}; gang repairs "
              f"{s.gang_repairs}; plans {plans_canon(res)}", flush=True)
        if got != digest:
            bad.append(f"result digest {got} != {digest}")
        inp = build()
        audit = gang_placement_audit(inp, res)
        for g, a in audit.items():
            if a["placed"] not in (0, a["total"]) or (
                    a["placed"] and a["spec"].domain_key is not None
                    and (a["unpinned"] or len(a["domains"]) != 1)):
                bad.append(f"gang {g} partial or split: {a}")
        if label == "8 config10":
            if plans_canon(res) != CONFIG10_PLANS:
                bad.append(f"plans {plans_canon(res)} != {CONFIG10_PLANS}")
            inv = priority_inversion_audit(inp, res, res.preemptions)
            if inv:
                bad.append(f"priority inversions {inv}")
        else:
            stranded = tuple(sorted(g for g, a in audit.items()
                                    if a["placed"] == 0))
            if stranded != CONFIG9_STRANDED_GANGS:
                bad.append(f"stranded gangs {stranded}")
        td = trees_digest(res)
        print(f"[{label}] trees digest {td}", flush=True)
        if td != trees:
            bad.append(f"trees digest {td} != {trees}")
        if full:
            md = map_digest(maps[0]) if maps else None
            print(f"[{label}] map {None if not maps else maps[0].shape} "
                  f"digest {md}", flush=True)
            if md != CONFIG9_FULL_MAP or not all(
                    map_digest(m) == md for m in maps):
                bad.append(f"map digest {md} != {CONFIG9_FULL_MAP} (or a "
                           f"warm solve's differs)")
        if bad:
            print(f"chip_smoke: {label} failed: {bad}", file=sys.stderr)
            return 1

    # -- 25(a). config #1 through K5 at B = 1 ------------------------------
    bad = _config1_phase(ffd, card, TorchSolver, add)
    if bad:
        print(f"chip_smoke: config #1 failed: {bad}", file=sys.stderr)
        return 1

    # -- 10-12. the steady state: config #7, #12 and #13 --------------------
    counts, bad = _config7(ffd, card, TorchSolver, build_config7)
    add(counts)
    if bad:
        print(f"chip_smoke: config #7 failed: {bad}", file=sys.stderr)
        return 1
    counts, bad = _config12(ffd, card, TorchSolver, build_config12)
    add(counts)
    if bad:
        print(f"chip_smoke: config #12 failed: {bad}", file=sys.stderr)
        return 1
    counts, bad, _ = _config13(ffd, card, TorchSolver, build_config13)
    add(counts)
    if bad:
        print(f"chip_smoke: config #13 failed: {bad}", file=sys.stderr)
        return 1

    # -- 13-17. the column-sharded solve (K7) ---------------------------------
    def mesh_solver(m, max_nodes):
        return lambda: TorchSolver(mesh=m, max_nodes=max_nodes)

    with _MeshCapture() as mcap:
        bad = []
        # 13. config #2 at mesh=8 against mesh off
        for label, m, kernels in (("13 config2-mesh8", MESH,
                                   ("ffd_sharded_scan",)),
                                  ("13 config2-off", "off",
                                   ("ffd_batch_scan", "explain_pack"))):
            seen = {}
            mcap.phase = label

            def after(sv, seen=seen):
                seen["n"] = (len(sv._mesh_exec.transfers)
                             if sv._mesh_exec is not None else 0)
            res, counts, sv = _main_path(
                mesh_solver(m, CONFIG2_MAX_NODES), build_config2, ffd, card,
                label, warm=MESH_WARM, after_cold=after)
            add(counts)
            nodes, unsched, price_hex, digest = CONFIG2
            bad += _check_answer(res, counts, nodes, unsched, price_hex,
                                 kernels)
            if result_digest(res) != digest:
                bad.append(f"{label}: digest {result_digest(res)}")
            if m != "off":
                ex = sv._mesh_exec
                if sv.mesh is None or sv.mesh.size != MESH:
                    bad.append(f"{label}: the mesh is {sv.mesh}")
                else:
                    late = len(ex.transfers) - seen["n"]
                    print(f"[{label}] column-axis transfers {ex.transfers}; "
                          f"after the first solve: {late}; clusters "
                          f"{ex.clusters}", flush=True)
                    if late:
                        bad.append(f"{label}: {late} column-axis "
                                   f"transfers after the first solve")
        # 14. the 50k headline at mesh=8
        mcap.phase = "14 headline-mesh8"
        res, counts, _ = _main_path(
            mesh_solver(MESH, CONFIG_MAX_NODES),
            lambda: build_input(HEADLINE_PODS), ffd, card,
            "14 headline-mesh8", warm=MESH_WARM)
        add(counts)
        bad += _check_answer(res, counts, HEADLINE_NODES, HEADLINE_UNSCHED,
                             HEADLINE_PRICE_HEX, ("ffd_sharded_scan",))
        # 15. config #9 (gangs) at mesh=8: K7's gang instance
        mcap.phase = "15 config9-mesh8"
        res, counts, _ = _main_path(
            mesh_solver(MESH, CONFIG_MAX_NODES), build_config9, ffd, card,
            "15 config9-mesh8", warm=MESH_WARM)
        add(counts)
        nodes, unsched, price_hex, digest, trees = CONFIG9
        bad += _check_answer(res, counts, nodes, unsched, price_hex,
                             ("ffd_sharded_gang_scan",))
        if result_digest(res) != digest or trees_digest(res) != trees:
            bad.append(f"15 config9-mesh8: digests {result_digest(res)} "
                       f"{trees_digest(res)}")
        # 16. config #7 at mesh=8, delta on: K7's seeded instance
        n7 = MESH_CONFIG7_PASSES
        mcap.phase = "16 config7-mesh8"
        on7 = TorchSolver(mesh=MESH, max_nodes=CONFIG_MAX_NODES)
        _reset_launches(ffd)
        ms, phases, verdicts, k6, bad7 = _lockstep(
            ffd, "16 config7-mesh8", {"mesh8-delta-on": on7},
            [lambda g=g: build_config7(g) for g in range(n7)], CONFIG7[:n7],
            card, timed_from=2)
        torch.cuda.synchronize()
        counts = _read_launches(ffd)
        add(counts)
        _report("16 config7-mesh8", ms, phases, verdicts, k6)
        print(f"[16 config7-mesh8] launches {counts}; delta passes "
              f"{on7.delta_passes}", flush=True)
        bad += bad7
        if any(v[0] != "delta" for v in verdicts["mesh8-delta-on"][1:]):
            bad.append("16 config7-mesh8: a pass after gen 0 was not a "
                       "delta pass")
        if counts["ffd_sharded_delta_scan"] < n7 - 1:
            bad.append(f"16 config7-mesh8: sharded delta launches "
                       f"{counts['ffd_sharded_delta_scan']}")
        # 17. the soft-term input, mesh off and mesh=8
        for label, m, kernels in (("17 soft-terms", "off",
                                   ("ffd_batch_scan",)),
                                  ("17 soft-terms-mesh8", MESH,
                                   ("ffd_sharded_scan",))):
            mcap.phase = label
            res, counts, sv = _main_path(
                mesh_solver(m, 1024), build_soft_terms, ffd, card, label,
                warm=MESH_WARM)
            add(counts)
            nodes, unsched, price_hex, digest = SOFT
            bad += _check_answer(res, counts, nodes, unsched, price_hex,
                                 kernels)
            print(f"[{label}] relaxation {sv.relax_counts}", flush=True)
            if result_digest(res) != digest:
                bad.append(f"{label}: digest {result_digest(res)}")
            if sv.relax_counts["rounds"] < 2 * (1 + MESH_WARM):
                bad.append(f"{label}: relaxation {sv.relax_counts}")
    if bad:
        print(f"chip_smoke: the mesh phases failed: {bad}", file=sys.stderr)
        return 1
    # every K7 launch of phases 13-17 held to its plain version at the
    # path's own shapes (N, O, G and the table as the solver made them)
    by_phase = {}
    for call, (phase, flat) in zip(mcap.calls, mcap.made):
        by_phase.setdefault(phase, []).append((call, flat))
    for phase, made in by_phase.items():
        res = {}
        for call, flat in made:
            for k, v in compare_captured(ffd, call, flat).items():
                res[k] = _merge([res[k], v]) if k in res else v
        shapes = sorted({(c[2].S, c[0].G, c[0].E, c[3], c[2].O)
                         for c, _ in made})
        record(f"{phase} K7", res, f"{len(made)} launches, (S, G, E, N, O) "
                                   f"{shapes}")
    kinds = {_sharded_name(c[5], c[7]) for c in mcap.calls}
    if failed or kinds != {"ffd_sharded_scan", "ffd_sharded_gang_scan",
                           "ffd_sharded_delta_scan"}:
        print(f"chip_smoke: the mesh path's K7 launches disagree with their "
              f"plain versions, or an instance was not launched ({kinds}): "
              f"{failed}", file=sys.stderr)
        return 1

    # -- 9. timings at the main paths' shapes --------------------------------
    # the floor: an empty kernel (one thread, no work) as the profiler
    # times one launch, beside the events' time a launch
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty():
        _cuda.launch("ffd_empty", [], [], stream)
    t_empty = _kernel_ms(empty, 200, "empty_kernel")
    ev_empty = _time_ms(empty, 200)
    print(f"[9] an empty launch (ffd_empty, 1 thread) on {card}: profiler "
          f"device time {'none' if t_empty is None else f'{t_empty:.4f}'} "
          f"ms, events {ev_empty:.4f} ms a launch", flush=True)
    p, c = ffd.problem_from_numpy(head_prob, head_cat, dev)
    N = solver.max_nodes
    head_t = _batch_times(ffd, ffd.FFDBatch.of(p), c, N, 50)
    t_k5, t_k5p, (b5, by5) = (head_t["ms"], head_t["plain_ms"],
                              head_t["bound"])
    print(f"[9] headline shapes (B=1, G={p.G}, N={N}, PT={c.PT}, O={c.O}) "
          f"on {card}: ffd_batch_scan with the explain counts {t_k5:.4f} "
          f"ms ({t_k5 / p.G:.4f} ms a step; events {head_t['ev_ms']:.4f}, "
          f"plain {t_k5p:.3f}, bound {b5:.6f} by {by5}); "
          + _epilogue_line(head_t), flush=True)
    p3, c3 = ffd.problem_from_numpy(c3_prob, c3_cat, dev)
    for N3 in (solver.max_nodes, CONFIG3_WARM_N):
        t3d = _batch_times(ffd, ffd.FFDBatch.of(p3), c3, N3, 20)
        t3, (b3, by3) = t3d["ms"], t3d["bound"]
        print(f"[9] config #3 shapes (B=1, G={p3.G}, N={N3}, PT={c3.PT}, "
              f"D={p3.D}) on {card}: ffd_batch_scan {t3:.4f} ms "
              f"({t3 / p3.G:.4f} ms a step; events {t3d['ev_ms']:.4f}, "
              f"plain {t3d['plain_ms']:.3f}, bound {b3:.6f} by {by3}); "
              + _epilogue_line(t3d), flush=True)
    # where the scan's time goes on config #3: the same problem with only
    # its light groups, or only its heavy groups, kept (the others' rows
    # zeroed: a step with no pods and no admitted column does next to
    # nothing)
    dsel = np.asarray(c3_prob[7])
    split, steps = {}, {}
    tag = _tag(True, False, False)
    for kind, keep in (("light", dsel == 0), ("heavy", dsel > 0)):
        steps[f"{kind} groups only ({int(keep.sum())})"] = int(keep.sum())
        pk, ck = ffd.problem_from_numpy(_only_groups(c3_prob, keep), c3_cat,
                                        dev)
        bk = ffd.FFDBatch.of(pk)
        lay_k = ffd.flat_layout(pk.G, pk.E, CONFIG3_WARM_N, pk.D)
        flat_k = torch.empty((1, lay_k["total"][1]), device=dev)
        lim_k = torch.empty((1, pk.P, ffd.R), device=dev)
        split[f"{kind} groups only ({int(keep.sum())})"] = _device_ms(
            lambda: ffd.batch_scan(bk, ck, CONFIG3_WARM_N, flat_k, lay_k,
                                   lim_k), 10, tag)[0]
    print(f"[9] config #3 (N={CONFIG3_WARM_N}) ffd_batch_scan by step kind "
          f"on {card}: " + "; ".join(
              f"{k} {v:.4f} ms ({v / steps[k]:.4f} ms a kept step)"
              for k, v in split.items()), flush=True)
    sweep_t = {}
    for kname, (sw, cs, Ns, Ks) in (("ffd_sweep_scan", c4_chunk),
                                    ("ffd_sweep_topo_scan", c4b_chunk)):
        t4, t4p, ev4, (b4, by4) = _sweep_times(ffd, sw, cs, Ns, Ks, 20)
        sweep_t[kname] = (t4, t4p, b4, by4)
        print(f"[9] {'config #4b heavy' if sw.heavy else 'config #4 light'}"
              f" chunk (B={sw.B}, G={sw.G}, E={sw.E}, D={sw.D}, N={Ns}, "
              f"O={cs.O}, K={Ks}, {_route(ffd, sw, cs, Ns, Ks)} carry) on "
              f"{card}: {kname} {t4:.4f} ms "
              f"({t4 / sw.G:.4f} ms a step; events {ev4:.4f}, per "
              f"simulation {t4 / sw.B * 1e3:.2f} us, plain "
              f"{t4p:.3f}, bound {b4:.6f} by {by4})", flush=True)
    sw, cs, Ns, Ks = c4_chunk
    turns, nbytes = _compaction_turns(ffd, sw, cs, Ns, max(Ks, 8), 20)
    print(f"[9] config #4 chunk take_exist, launch+device+pull per chunk, in "
          f"turns on {card}: " + "; ".join(
              f"{k} ({nbytes[k]} bytes) " + ", ".join(f"{v:.4f}" for v in vs)
              + " ms" for k, vs in turns.items()), flush=True)
    for lab, (sw, cs, Ns, Ks) in (("config #4", c4_chunk),
                                  ("config #4b heavy", c4b_chunk)):
        pack = _pack_times(ffd, sw, cs, Ns, max(Ks, 8), 20)
        print(f"[9] {lab} chunk take_exist compaction (row 3b, K4's "
              f"epilogue) on {card}: K4 dense | compacted in turns "
              + "; ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                          for k, vs in pack["turns"].items())
              + f" ms; the pack {pack['ms']:.4f} ms (the difference of "
              f"the minima), plain compact_take_exist "
              f"{pack['plain_ms']:.4f} ms, bound {pack['bound'][0]:.6f} by "
              f"{pack['bound'][1]}", flush=True)
    # config #9: the gang instance at the cold and the warm node axis, the
    # epilogue with the explain=2 map at the cold one
    p9, c9 = ffd.problem_from_numpy(c9_prob, c9_cat, dev)
    gang_t = {}
    for N9, ex9 in ((CONFIG_MAX_NODES, 2), (CONFIG3_WARM_N, 1)):
        gang_t[N9] = t9d = _batch_times(ffd, ffd.FFDBatch.of(p9), c9, N9, 20,
                                        ex9, wg=1)
        t9, (b9, by9) = t9d["ms"], t9d["bound"]
        print(f"[9] config #9 shapes (B=1, G={p9.G}, N={N9}, PT={c9.PT}, "
              f"D={p9.D}, explain={ex9}) on {card}: ffd_batch_gang_scan "
              f"{t9:.4f} ms ({t9 / p9.G:.4f} ms a step; events "
              f"{t9d['ev_ms']:.4f}, plain {t9d['plain_ms']:.3f}, bound "
              f"{b9:.6f} by {by9}); " + _epilogue_line(t9d), flush=True)
    # row 9, the witness: the gang-free scan with and without it at config
    # #10 (the main path's) and at the G = 2048 priority problem
    p10, c10 = ffd.problem_from_numpy(c10_prob, c10_cat, dev)
    b10 = ffd.FFDBatch.of(p10)
    wit = _witness_times(ffd, b10, c10, CONFIG3_WARM_N, 20)
    print(_witness_line("config #10 shapes", b10, CONFIG3_WARM_N, card, wit),
          flush=True)
    wprob, wcat, wN = witness_problem()
    pw, cw = ffd.problem_from_numpy(wprob, wcat, dev)
    bw = ffd.FFDBatch.of(pw)
    wit2k = _witness_times(ffd, bw, cw, wN, 5)
    print(_witness_line(f"the G={WITNESS_G} priority problem", bw, wN, card,
                        wit2k), flush=True)
    for lab, w in (("config #10", wit), (f"G={WITNESS_G}", wit2k)):
        errs["priority_witness"] = max(errs["priority_witness"],
                                       w["check"][1])
        if not w["check"][0]:
            print(f"chip_smoke: {lab}: the witness region differs from the "
                  f"plain witness (max abs err {w['check'][1]:g})",
                  file=sys.stderr)
            return 1
    (b_wit, by_wit), t_witp = wit["bound"], wit["plain_ms"]
    # row 5, the coalesced upload: the headline's one pinned copy
    up = _upload_times(ffd, head_prob, head_cat["col_pool"].shape[0], dev)
    print(f"[9] headline upload (row 5: one pinned host->device copy of "
          f"{up['bytes']} bytes) on {card}: events {up['ms']:.4f} ms "
          f"(median of 50, min {up['min_ms']:.4f}); bound "
          f"{up['bound_ms']:.6f} ms by bytes at {up['rate_gbs']:.2f} GB/s, "
          f"the rate of a {UPLOAD_RATE_BYTES >> 20} MiB pinned copy on this "
          f"card", flush=True)
    map_t = gang_t[CONFIG_MAX_NODES]
    t_gang, t_gangp, (b_gang, by_gang) = (map_t["ms"], map_t["plain_ms"],
                                          map_t["bound"])
    # K6 at config #7's churned suffix, at a chunk of its delta-off chain
    # and at config #12's seeded chunk
    delta_t = {}
    for dlabel, call in (("config #7 suffix", cap7.calls[0]),
                         ("config #7 delta-off chain chunk 1",
                          cap7c.calls[1]),
                         ("config #12 chunk 1", cap12.calls[1])):
        p6, sd6, c6, N6, _ = call
        delta_t[dlabel] = _delta_times(ffd, call, 20)
        t6, t6p, ev6, (b6, by6), turns6, (be6, bye6) = delta_t[dlabel]
        print(f"[9] {dlabel} shapes (G={p6.G}, A={sd6.A}, N={N6}, "
              f"E={p6.E}, O={c6.O}) on {card}: ffd_delta_scan {t6:.4f} ms "
              f"({t6 / p6.G:.4f} ms a step; events {ev6:.4f}, plain "
              f"{t6p:.3f}, bound {b6:.6f} by {by6}); " + _turns_text(turns6)
              + f" (bound {be6:.6f} by {bye6})", flush=True)
    # K5 at config #12's one program, the spec-off arm's launch, held
    # against its plain version
    p12 = cap12o.calls[0][0]
    t12, t12p, ev12, (b12, by12), res12, turns12 = _captured_batch_times(
        ffd, cap12o.calls[0], 3)
    for k, (eq, err) in res12.items():
        errs[k] = max(errs[k], err)
        if not eq:
            print(f"chip_smoke: {k} at config #12's one program differs "
                  f"from its plain version (max abs err {err:g})",
                  file=sys.stderr)
            return 1
    print(f"[9] config #12 one program (spec off: B=1, G={p12.G}, "
          f"N={cap12o.calls[0][2]}, O={cap12o.calls[0][1].O}, "
          f"explain={cap12o.calls[0][3]}) on {card}: ffd_batch_scan "
          f"{t12:.4f} ms ({t12 / p12.G:.4f} ms a step; events "
          f"{ev12:.4f}, plain {t12p:.3f} once, equal to it, bound "
          f"{b12:.6f} by {by12})"
          + (f"; {_turns_text(turns12)}" if turns12 else ""), flush=True)
    # K5 at phase 18's wave-2 launch: the existing-node fill of 2,000 pods
    # over wave 1's nodes, on the tensors the loop gave it
    for w, cap in enumerate(loop_calls, 1):
        if w != 2 or not cap["solve"]:
            continue
        call = cap["solve"][-1]
        pl, cl, Nl = call[0], call[1], call[2]
        tl, tlp, evl, (bl, byl), resl, _ = _captured_batch_times(
            ffd, call, 20)
        for k, (eq, err) in resl.items():
            errs[k] = max(errs[k], err)
            if not eq:
                print(f"chip_smoke: {k} at the loop's wave-2 launch differs "
                      f"from its plain version (max abs err {err:g})",
                      file=sys.stderr)
                return 1
        print(f"[9] loop wave 2 (B=1, G={pl.G}, E={pl.E}, N={Nl}, "
              f"O={cl.O}) on {card}: ffd_batch_scan {tl:.4f} ms "
              f"({tl / pl.G:.4f} ms a step; events {evl:.4f}, plain "
              f"{tlp:.3f} once, equal to it, bound {bl:.6f} by {byl})",
              flush=True)
    # K5 and K4 at phase 19's own launches (its warmed loop): the first
    # B=64 multi-node batch, the wave-2 re-placement, the first sweep chunk
    for key, call in sorted(disruption_log.kept.items()):
        if call[0] == "batch":
            _, b, c, N, ex, K, wg, wp = call
            kname = "ffd_batch_scan"
            t, tp, ev, (bd, by) = _kept_batch_times(ffd, b, c, N, ex, K,
                                                    wg, wp, 20)
            shape = (f"B={b.B}, G={b.G}, E={b.E}, N={N}, O={c.O}, "
                     f"explain={ex}")
        else:
            _, sw, c, N, K = call
            kname = "ffd_sweep_topo_scan" if sw.heavy else "ffd_sweep_scan"
            t, tp, ev, (bd, by) = _sweep_times(ffd, sw, c, N, K, 20)
            shape = (f"B={sw.B}, G={sw.G}, E={sw.E}, N={N}, O={c.O}, K={K}, "
                     f"{_route(ffd, sw, c, N, K)} carry")
        print(f"[9] disruption loop {key} ({shape}) on {card}: {kname} "
              f"{t:.4f} ms (events {ev:.4f}, plain {tp:.3f} once, bound "
              f"{bd:.6f} by {by})", flush=True)
    t_k6, t_k6p, _, (b_k6, by_k6), _, _ = delta_t["config #7 suffix"]
    # K7 at 2, 4 and 8 shards on config #2's and the headline's encodings,
    # beside K5 on the same problems; then at the mesh paths' own launches
    for lab, prob, catarr, N in (("config #2", c2_prob, c2_cat,
                                  CONFIG2_MAX_NODES),
                                 ("headline", head_prob, head_cat,
                                  solver.max_nodes)):
        p5, c5 = ffd.problem_from_numpy(prob, catarr, dev)
        k5 = _batch_times(ffd, ffd.FFDBatch.of(p5), c5, N, 20)["ms"]
        print(f"[9] {lab} (G={p5.G}, N={N}, PT={c5.PT}, O={c5.O}) on "
              f"{card}: ffd_batch_scan {k5:.4f} ms ({k5 / p5.G:.4f} "
              f"ms a step; S=1)", flush=True)
        for S in (2, 4, 8):
            t7, ev7, t7p, (b7, by7), n7 = _sharded_times(
                ffd, prob, catarr, S, N, 20, dev)
            print(f"[9] {lab} ffd_sharded_scan S={S}: {t7:.4f} ms "
                  f"({t7 / p5.G:.4f} ms a step; events {ev7:.4f}, plain "
                  f"{t7p:.3f}, bound {b7:.6f} by {by7}; "
                  f"clusters the card holds {n7})", flush=True)
    k7_t = {}
    for k7_name, pick in (
            ("ffd_sharded_scan",
             lambda c: c[7] is None and not c[5] and c[2].S == MESH
             and c[3] == CONFIG2_MAX_NODES),
            ("ffd_sharded_gang_scan", lambda c: c[5]),
            ("ffd_sharded_delta_scan",
             lambda c: c[7] is not None and c[0].G <= 4)):
        call = next((c for c in mcap.calls if pick(c)), None)
        if call is None:
            print(f"chip_smoke: no {k7_name} launch was captured",
                  file=sys.stderr)
            return 1
        k7_t[k7_name] = _captured_sharded_times(ffd, call, 20)
        t7, ev7, t7p, (b7, by7), turns7 = k7_t[k7_name]
        p7 = call[0]
        print(f"[9] {k7_name} at its main path's launch (S={call[2].S}, "
              f"G={p7.G}, E={p7.E}, N={call[3]}, O={call[2].O}, "
              f"explain={call[4]}) on {card}: "
              f"{t7:.4f} ms ({t7 / p7.G:.4f} ms a step; events {ev7:.4f}, "
              f"plain {t7p:.3f}, bound {b7:.6f} by {by7})"
              + (f"; {_turns_text(turns7)}" if turns7 else ""), flush=True)

    # -- 21 (continued). K7x across the cards of this host, in a child
    # process of its own, when there are two or more
    if torch.cuda.device_count() >= 2:
        got, err = _run_child("cards", timeout=900)
        if got is None or got.get("bad"):
            print(f"chip_smoke: the cross-card check failed: "
                  f"{got['bad'] if got else err}", file=sys.stderr)
            return 1
        for k, v in got["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in got["errs"].items():
            errs[k] = max(errs.get(k, 0.0), v)
        for k, v in got["kernels"].items():
            k7x_t[k] = dict(v, bound=tuple(v["bound"]))
    else:
        print(f"[21] the cross-card check needs two cards: this host has "
              f"{torch.cuda.device_count()} (run `chip_smoke.py --child "
              f"cards` on a host of 2 or more)", flush=True)

    kernels = [
        {"name": "ffd_batch_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_batch_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:1492",
         "launches": launches["ffd_batch_scan"],
         "max_abs_err": errs["ffd_batch_scan"], "ms": t_k5,
         "plain_ms": t_k5p, "bound_ms": b5, "bound_by": by5,
         "library_ms": None},
        {"name": "ffd_batch_gang_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_batch_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:820",
         "launches": launches["ffd_batch_gang_scan"],
         "max_abs_err": errs["ffd_batch_gang_scan"], "ms": t_gang,
         "plain_ms": t_gangp, "bound_ms": b_gang, "bound_by": by_gang,
         "library_ms": None},
        {"name": "priority_witness", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_scan_common.cuh",
         "replaces": "karpenter_tpu/solver/ffd.py:1238",
         "launches": launches["priority_witness"],
         "max_abs_err": errs["priority_witness"],
         "ms": max(0.0, wit["ms"]), "plain_ms": t_witp,
         "bound_ms": b_wit, "bound_by": by_wit, "library_ms": None},
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
        {"name": "ffd_delta_scan", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_delta_scan.cu",
         "replaces": "karpenter_tpu/solver/ffd.py:1403",
         "launches": launches["ffd_delta_scan"],
         "max_abs_err": errs["ffd_delta_scan"], "ms": t_k6,
         "plain_ms": t_k6p, "bound_ms": b_k6, "bound_by": by_k6,
         "library_ms": None},
        {"name": "explain_pack", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_scan_common.cuh",
         "replaces": "karpenter_tpu/solver/ffd.py:1113",
         "epilogue_of": ["ffd_batch_scan", "ffd_delta_scan",
                         "ffd_sharded_scan", "ffd_card_scan"],
         "launches": launches["explain_pack"],
         "max_abs_err": errs["explain_pack"],
         "ms": max(0.0, head_t["epi_ms"]),
         "plain_ms": head_t["epi_plain_ms"],
         "bound_ms": head_t["epi_bound"][0],
         "bound_by": head_t["epi_bound"][1], "library_ms": None},
        *({"name": k7, "route": "cuda",
           "source": "karpenter_tpu_torch/csrc/ffd_sharded_scan.cu",
           "replaces": replaces,
           "launches": launches[k7], "max_abs_err": errs[k7],
           "ms": k7_t[k7][0], "plain_ms": k7_t[k7][2],
           "bound_ms": k7_t[k7][3][0], "bound_by": k7_t[k7][3][1],
           "library_ms": None}
          for k7, replaces in (
              ("ffd_sharded_scan", "karpenter_tpu/solver/ffd.py:1372"),
              ("ffd_sharded_gang_scan",
               "karpenter_tpu/parallel/mesh.py:203"),
              ("ffd_sharded_delta_scan",
               "karpenter_tpu/solver/ffd.py:1446"))),
        *({"name": k7x, "route": "cuda",
           "source": "karpenter_tpu_torch/csrc/ffd_card_scan.cu",
           "replaces": replaces,
           "launches": launches[k7x], "max_abs_err": errs[k7x],
           "ms": k7x_t[k7x]["ms"], "plain_ms": k7x_t[k7x]["plain_ms"],
           "bound_ms": k7x_t[k7x]["bound"][0],
           "bound_by": k7x_t[k7x]["bound"][1], "library_ms": None,
           "measured": k7x_t[k7x]["measured"],
           "shape": list(k7x_t[k7x]["shape"])}
          for k7x, replaces in (
              ("ffd_card_scan", "karpenter_tpu/solver/ffd.py:1372"),
              ("ffd_card_gang_scan", "karpenter_tpu/parallel/mesh.py:203"),
              ("ffd_card_delta_scan", "karpenter_tpu/solver/ffd.py:1446"))),
        {"name": "explain_map", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/ffd_scan_common.cuh",
         "replaces": "karpenter_tpu/solver/ffd.py:1215",
         "epilogue_of": ["ffd_batch_scan"],
         "launches": launches["explain_map"],
         "max_abs_err": errs["explain_map"],
         "ms": max(0.0, map_t["epi_ms"]),
         "plain_ms": map_t["epi_plain_ms"],
         "bound_ms": map_t["epi_bound"][0],
         "bound_by": map_t["epi_bound"][1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
