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
     heavy chunk of config #4b: flat result buffers must be equal as
     uint32, region by region, every case's explain counts must hold a
     nonzero, and the map cases together every class 1-4;
  4. the headline path: TorchSolver().solve(build_input(50_000)) — one
     cold and 20 warm solves through K5 and its explain epilogue — must
     give the JAX package's answer, with those launch counts above zero;
     then
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
     suffix and #12's chunk, K7 at #2's launch); the sweep's dense
     against compacted take_exist rows, and an empty kernel's launch as
     the floor of them all (run after 10-12);
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
     node, the hex price, the rounds) with K5 and its explain epilogue
     launched, no oracle
     solve, no SolverFallback event and kt_hostops loaded.  One cold loop
     (in a child process that has launched nothing), one whose solver is
     warmed first as the provisioner's startup warm-up does — its first
     solve must meet zero first-use events (solver/firstuse.py) — and
     two more on fresh clusters; wall time to idle and per round, the
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
     record), K5 must launch at B=64 and K4 launch, with no oracle solve,
     no SolverFallback event and kt_hostops loaded.  One cold loop in a
     child process that has launched nothing, run to its end before the
     parent's loop whose solver is warmed first; per wave
     the wall time to idle, the ms a round and a disruption pass, the
     disruption.* spans, each controller's reconcile ms, solve_batch's
     calls, simulations (those K4's sweep answered) and phases, the
     launch shapes (B, G, E, N) of every K5 and K4 launch, and the
     first-use events of the first disruption pass.

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
a wide one and the seeded instance, each launched 3 times — and on the
headline's and config #2's encodings at 8 shards, printing
cudaOccupancyMaxActiveClusters by cluster size.  Phase 9 also times K7 at
2, 4 and 8 shards beside K5 and at the mesh phases' own launches, and K5
at config #12's one program as the spec-off arm launches it (G=2048
steps, 640 of them real), held once more against its plain version.
The line before the card line is the kernels' JSON record; the last line
is {"ok": true, "device": {...}}.
Without a CUDA device it exits 2 and prints no result.  `--child MODE`
runs one of the phases above that need a process of their own; the
script starts those itself.
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
CONFIG13_PODS = 50_000    # config #13's first size (1M cut)
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
K7_REPEATS = 3            # each K7 comparison launched this many times
MESH_CONFIG7_PASSES = 5   # config #7 under the mesh: gen 0 and 4 passes

# The provisioning control loop (phase 18): the headline's 50k pods
# through GatedSolver to launched nodes and bound pods, then 2,000 pods of
# its two smallest sizes.  The JAX package's answer to the same loop (its
# own controllers, cloud provider and stores on the CPU, solver mesh off;
# `python3 tests/test_torch_provisioning.py --pin` prints it), one dict
# per wave as `workloads.loop_answer` gives it
LOOP_PODS = 50_000
LOOP_WAVE2 = 2_000
LOOP_FRESH = 2            # loops on fresh clusters after the cold one
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
           "ffd_sharded_delta_scan": ("sharded_scan", "delta_launches")}
PASSES = {"priority_witness": (("batch_scan", "witness_launches"),),
          "explain_pack": tuple((w, "explain_launches") for w in (
              "batch_scan", "delta_scan", "sharded_scan")),
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
    if wp:
        out["priority_witness"] = _diff(ffd._region(fk, lay, "prio_inv"),
                                        ffd._region(fp, lay, "prio_inv"))
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
         sharded: bool = False) -> str:
    """The trace's name of one instance of the templated scan kernel."""
    flags = ", ".join("true" if f else "false"
                      for f in (topo, sweep, gang, seed, sharded))
    return f"scan_kernel<{flags}>"


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


def _witness_times(ffd, b, c, N, reps):
    """The witness at one problem's shapes: K5 with and without the
    witness region in turns (profiler ms each), the plain witness's ms,
    and its bound (count, unsched and priority rows read, the witness row
    written)."""
    import torch
    dev = b.group_req.device
    out = {}
    for wp in (0, 1, 1, 0):
        lay = ffd.flat_layout(b.G, b.E, N, b.D, 0, 0, c.O, wp)
        flat = torch.empty((b.B, lay["total"][1]), device=dev)
        lim = torch.empty((b.B, b.P, ffd.R), device=dev)
        t, _ = _device_ms(lambda: ffd.batch_scan(b, c, N, flat, lay, lim),
                          reps, _tag(True, False, False))
        out.setdefault(wp, []).append(t)
    unsched = ffd._region(flat, lay, "unsched")[0].to(torch.int32)
    p0 = b.at(0)
    t_plain = _time_ms(lambda: ffd.priority_witness(
        p0.group_count, unsched, p0.group_prio), 20)
    bnd = bound_ms(4 * 4 * b.G, 3 * b.G)
    return out, t_plain, bnd


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
    return out


def _sharded_bound(ffd, p, table, sc, N, lay, flat, lim, wg=0, sd=None):
    """K7's bound, counted as K5's: the problem rows, the catalog shards,
    the mask-table rows the groups gather (and the seed) read once, the
    flat row and budgets written once, against the float operations this
    run's data needs (the plain version's count) over the fp32 rate."""
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
    return bound_ms(nbytes, _work_ops(work))


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


def _p50(xs):
    return statistics.median(xs) if xs else float("nan")


def _lockstep(ffd, label, arms, inputs, digests, card, feed=None,
              timed_from=0):
    """Solve each input (inputs[i] answers digests[i]) on every solver of
    `arms` ({name: solver}) in turn; `feed(name, solver, i)` delivers the
    pass's watch events first.  Returns ({arm: [e2e ms of the timed
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


def _config13(ffd, card, TorchSolver, build_config13):
    """Config #13 at its first size: the incremental index (fed the churn
    as watch events) against the walk, delta auto in both, over a cold
    pass, two warm ones and 8 timed churn passes; returns (launches,
    problems)."""
    import torch
    on = TorchSolver(max_nodes=CONFIG_MAX_NODES, spec="off", incr="on")
    walk = TorchSolver(max_nodes=CONFIG_MAX_NODES, spec="off", incr="off")
    n = len(CONFIG13)
    events = {}

    def build(g):
        inp, ev = build_config13(CONFIG13_PODS, g)
        events[g] = ev
        return inp

    def feed(name, solver, i):
        if name == "incr" and events.get(i):
            solver.delta_invalidate(pods=tuple(events[i]),
                                    pod_objs=events[i])

    _reset_launches(ffd)
    ms, phases, verdicts, k6, bad = _lockstep(
        ffd, "12 config13", {"incr": on, "walk": walk},
        [lambda g=g: build(g) for g in range(n)], CONFIG13, card,
        feed=feed, timed_from=3)
    torch.cuda.synchronize()
    launches = _read_launches(ffd)
    _report("12 config13", ms, phases, verdicts, k6)
    for name in ("incr", "walk"):
        for i, v in enumerate(verdicts[name][1:], 1):
            if (v[0] != "delta" or k6[name][i] < 1
                    or (name == "incr" and v[2] is not None)):
                bad.append(f"{name} pass {i}: {v}, {k6[name][i]} K6")
    print(f"[12 config13] launches {launches}; incr passes "
          f"{on.incr_passes} fallbacks {on.incr_fallbacks}; delta passes "
          f"incr {on.delta_passes}, walk {walk.delta_passes}", flush=True)
    if launches["ffd_delta_scan"] <= 0:
        bad.append("kernel ffd_delta_scan was not launched on the main path")
    return launches, bad


# -- 18. the provisioning control loop ---------------------------------------
def _loop_run(card, warm_up=False, capture=None):
    """One provisioning loop on a fresh cluster (workloads.provisioning_loop,
    Options(batch_idle_duration=0)): wave 1 the headline's LOOP_PODS pods,
    wave 2 LOOP_WAVE2 pods of its two smallest sizes landing on wave 1's
    nodes.  With `warm_up`, its GatedSolver is warmed first as the
    provisioner's startup warm-up does (a one-pod input, shapes (8, e) and
    (512, e)).  With a list as `capture`, each wave appends to it the
    arguments of the one-problem and seeded solves it launched
    (`_SolveCapture`, `_DeltaCapture`), for phase 3 to hold those launches
    to their plain versions.  Every kernel count is set to 0 just before
    each wave and read just after.  Returns one record per wave and the
    warm-up's."""
    import contextlib
    import torch
    from karpenter_tpu_torch import native, workloads
    from karpenter_tpu_torch.models import ObjectMeta, Pod, Resources
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.solver import ffd, firstuse
    from karpenter_tpu_torch.utils import metrics, tracing

    loop = workloads.provisioning_loop(
        LOOP_PODS, Options(batch_idle_duration=0), device="cuda")
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
                    LOOP_WAVE2, prefix="w", sizes=workloads.WAVE2_SIZES))
            ctl_s.clear()
            round_ms.clear()
            tracing.reset()
            oracle0 = metrics.SOLVER_SOLVES.value(path="oracle")
            f0 = firstuse.total()
            with contextlib.ExitStack() as stack:
                if capture is not None:
                    caps = (stack.enter_context(_SolveCapture(ffd)),
                            stack.enter_context(_DeltaCapture(ffd)))
                    capture.append({"solve": caps[0].calls,
                                    "delta": caps[1].calls})
                _reset_launches(ffd)
                t0 = time.perf_counter()
                rounds = loop.settle()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                launches = _read_launches(ffd)
            spans = {}
            for _, sps in tracing.finished_traces():
                for sp in sps:
                    spans[sp.name] = spans.get(sp.name, 0.0) + \
                        sp.duration * 1e3
            cache = loop.solver.tpu._delta_cache
            waves.append({
                "answer": workloads.loop_answer(loop.cluster, loop.cloud,
                                                rounds),
                "wall_ms": wall, "round_ms": list(round_ms),
                "spans_ms": spans,
                "controller_ms": {k: v * 1e3 for k, v in ctl_s.items()},
                "phase_ms": dict(loop.solver.tpu.last_phase_ms),
                "launches": launches,
                "oracle": metrics.SOLVER_SOLVES.value(path="oracle")
                - oracle0,
                "fallbacks": sum(1 for ev in loop.cluster.events
                                 if ev[3] == "SolverFallback"),
                "first_use": firstuse.total() - f0,
                "seams": (cache.last_outcome, cache.last_reason,
                          cache.last_incr_reason),
                "hostops": native.hostops() is not None})
    finally:
        tracing.set_enabled(None)
        tracing.reset()
    return waves, warm


def _loop_check(waves, label):
    """What phase 18 holds each wave to: the pinned JAX answer, K5 and its
    explain epilogue launched, no oracle solve, no SolverFallback event,
    kt_hostops loaded."""
    bad = []
    for i, w in enumerate(waves):
        if w["answer"] != LOOP[i]:
            bad.append(f"{label} wave {i + 1}: {w['answer']} != {LOOP[i]}")
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
              f"{w['fallbacks']}, first-use events {w['first_use']}",
              flush=True)


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
        return [f"the cold loop failed: {err}"]
    runs = {"cold": cold["waves"]}
    warmed, warm = _loop_run(card, warm_up=True)
    runs["warmed"] = warmed
    for i in range(LOOP_FRESH):
        runs[f"fresh {i + 1}"] = _loop_run(
            card, capture=captured if i == 0 else None)[0]
    bad = []
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
    p50_runs = [runs["cold"]] + [runs[k] for k in runs
                                 if k.startswith("fresh")]
    for i in (0, 1):
        ws = [r[i] for r in p50_runs]
        spans = {k: _p50([w["spans_ms"].get(k, 0.0) for w in ws])
                 for k in ("provisioning.build_input", "provisioning.solve",
                           "provisioning.apply", "lifecycle.pass")}
        ctl = {k: _p50([w["controller_ms"].get(k, 0.0) for w in ws])
               for k in ws[0]["controller_ms"]}
        phases = {k: _p50([w["phase_ms"].get(k, 0.0) for w in ws])
                  for k in ws[0]["phase_ms"]}
        print(f"[18] wave {i + 1} p50 over the cold loop and {LOOP_FRESH} "
              f"fresh ones on {card}: to idle "
              f"{_p50([w['wall_ms'] for w in ws]):.1f} ms; spans ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in spans.items())
              + "; controllers ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in ctl.items())
              + "; solve phases ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
              flush=True)
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
    first K4 chunk and the first provisioner K5 launch with E > 1,000 in
    wave 2 (a re-placement of evicted pods), for phase 3."""

    def __init__(self, ffd, keep=False):
        self.ffd, self.keep = ffd, keep
        self.rows, self.kept = [], {}
        self.ctl, self.wave = None, 0

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
                _reset_launches(ffd)
                t0 = time.perf_counter()
                answer = fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                launches = _read_launches(ffd)
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
                    "hostops": native.hostops() is not None})
    finally:
        tracing.set_enabled(None)
        tracing.reset()
    return waves, warm, log


def _disruption_check(waves, label):
    """What phase 19 holds each wave to: the pinned JAX answer, no oracle
    solve, no SolverFallback event, kt_hostops loaded; and over the loop,
    K5 launched at B=64 and K4 launched."""
    bad = []
    for i, w in enumerate(waves):
        if w["answer"] != DISRUPTION_LOOP[i]:
            bad.append(f"{label} wave {i + 1}: {w['answer']} != "
                       f"{DISRUPTION_LOOP[i]}")
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
              f"first disruption pass {w['first_pass_first_use']})",
              flush=True)
        for k, v in sorted(w["shapes"].items()):
            print(f"    [{label}] wave {i + 1} launch shape {k}: {v}",
                  flush=True)


def _first_pass(waves):
    """The first-use events of a loop's first disruption pass with
    candidates (None when it had none)."""
    return next((w["first_pass_first_use"] for w in waves
                 if w["first_pass_first_use"] is not None), None)


def _disruption_phase(card, add):
    """Phase 19: the cold loop in a child process, run to its end first,
    then the loop whose solver is warmed first, which keeps the launches
    phase 3 holds to their plain versions (one loop at a time, so that
    neither's times count the other's host work).  Adds the warmed loop's
    launches with `add`; returns what failed and the warmed loop's
    `_LaunchLog`."""
    cold, err = _run_child("disruption-cold")
    warmed, warm, log = _disruption_run(card, warm_up=True, keep=True)
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


def _child(mode: str) -> int:
    """The phases that run in a child process of their own: "headline"
    (phase 4's headline with the environment the parent set, for the
    KARPENTER_TPU_NO_NATIVE=1 arm), "cold-loop" (phase 18's cold loop,
    in a process that has launched nothing) and "disruption-cold" (phase
    19's cold loop, the same).  Prints one JSON line."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.solver import TorchSolver, ffd
    from karpenter_tpu_torch.workloads import build_input
    card = _card_line()
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


def _run_child(mode: str, env=None):
    """Run `_child(mode)` in a child process; its JSON line, or None and
    the child's output when it failed."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", mode],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **(env or {})))
    lines = out.stdout.strip().splitlines()
    for line in lines:
        print(f"    [child {mode}] {line}", flush=True)
    if out.returncode != 0 or not lines:
        return None, out.stderr[-4000:]
    return json.loads(lines[-1]), None


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
    bad = _loop_phase(card, add, loop_calls)
    if bad:
        print(f"chip_smoke: the provisioning loop failed: {bad}",
              file=sys.stderr)
        return 1

    # -- 19. the disruption control loop, here too: its warmed loop keeps
    # the launches phase 3 holds to their plain versions -------------------
    bad, disruption_log = _disruption_phase(card, add)
    if bad:
        print(f"chip_smoke: the disruption loop failed: {bad}",
              file=sys.stderr)
        return 1

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
            record(f"disruption-{key.replace(' ', '-')}",
                   compare_sweep(ffd, sw, c, N, K, dev),
                   f"B={sw.B} G={sw.G} E={sw.E} D={sw.D} N={N} K={K}")
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
    # K7, the column-sharded scan, against its plain version at 2, 4, 6
    # and 8 shards, each launch repeated, then at the mesh paths' own
    # encodings (the headline and config #2) at 8 shards
    from karpenter_tpu_torch.parallel.mesh import shard_problem
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
    res, counts, _ = _main_path(
        TorchSolver, lambda: build_input(HEADLINE_PODS), ffd, card,
        "4 headline", p50=p50_on)
    add(counts)
    print(f"[4 headline] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    bad = _check_answer(res, counts, HEADLINE_NODES, HEADLINE_UNSCHED,
                        HEADLINE_PRICE_HEX, ("ffd_batch_scan", "explain_pack"))
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
    counts, bad = _config13(ffd, card, TorchSolver, build_config13)
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
              f"O={cs.O}, K={Ks}) on {card}: {kname} {t4:.4f} ms "
              f"({t4 / sw.G:.4f} ms a step; events {ev4:.4f}, per "
              f"simulation {t4 / sw.B * 1e3:.2f} us, plain "
              f"{t4p:.3f}, bound {b4:.6f} by {by4})", flush=True)
    sw, cs, Ns, Ks = c4_chunk
    turns, nbytes = _compaction_turns(ffd, sw, cs, Ns, max(Ks, 8), 20)
    print(f"[9] config #4 chunk take_exist, launch+device+pull per chunk, in "
          f"turns on {card}: " + "; ".join(
              f"{k} ({nbytes[k]} bytes) " + ", ".join(f"{v:.4f}" for v in vs)
              + " ms" for k, vs in turns.items()), flush=True)
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
    # config #10: the gang-free scan with and without the witness
    p10, c10 = ffd.problem_from_numpy(c10_prob, c10_cat, dev)
    wit, t_witp, (b_wit, by_wit) = _witness_times(
        ffd, ffd.FFDBatch.of(p10), c10, CONFIG3_WARM_N, 20)
    print(f"[9] config #10 shapes (B=1, G={p10.G}, N={CONFIG3_WARM_N}) on "
          f"{card}: ffd_batch_scan with the witness "
          + ", ".join(f"{v:.4f}" for v in wit[1]) + " ms, without "
          + ", ".join(f"{v:.4f}" for v in wit[0]) + f" ms (in turns); "
          f"plain witness {t_witp:.4f} ms, bound {b_wit:.8f} by {by_wit}",
          flush=True)
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
            kname = "ffd_sweep_scan"
            t, tp, ev, (bd, by) = _sweep_times(ffd, sw, c, N, K, 20)
            shape = f"B={sw.B}, G={sw.G}, E={sw.E}, N={N}, O={c.O}, K={K}"
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
         "ms": max(0.0, min(wit[1]) - min(wit[0])), "plain_ms": t_witp,
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
                         "ffd_sharded_scan"],
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
