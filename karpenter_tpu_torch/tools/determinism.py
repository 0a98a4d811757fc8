"""determinism-harness: the double-run digest compare.

The port's twin of `hack/determinism_harness.py`: the same scenario set,
canonical forms and drill, run through the port on the card unless
`--device cpu` asks for the CPU.

    python -m karpenter_tpu_torch.tools.determinism            # exit 0: bit-identical
    python -m karpenter_tpu_torch.tools.determinism --drill    # must exit non-zero

The same representative solve set runs TWICE, in two child processes,
under DIFFERENT ``PYTHONHASHSEED`` values and distinct spill directories,
and every digest the replay pipeline depends on must match bit-for-bit:

  * the flight-record chain — every record's canonical form (problem
    fingerprint, catalog identity, resolved knobs, delta outcome, result
    digest incl. the IEEE price hex), with the capture-side provenance
    fields (ts / pid / phase timings / first-use events / device
    watermark / trace id / capture path) excluded (`FLIGHT_EXCLUDE`):
    what the port's `kt_replay` re-executes and compares is everything
    else;
  * the ledger hex chain — (source, action, reason_code,
    cost_delta_hex) per row, the exactness contract the rewind engine's
    ledger judge audits;
  * the solve-result digests of each scenario pass.

Scenario set (a slice of each family the repo considers load-bearing):
a config2-style mixed-constraint solve, a delta churn pass (three
incremental generations through ``delta="auto"``), a gang+priority mix,
and a short rewind segment through the real Operator driver.

Drill mode (``--drill``): arms the ``determinism.digest`` fault point
(utils/faults.py; its site is `canon_flight_record` here) in both
children, which stamps a ``time.time()`` perturbation into every
canonical flight record — the digests MUST then differ and the harness
MUST exit non-zero.  A green drill proves the compare has teeth.

The two children run at once (each its own spill directories under one
temporary directory, removed after).  Exit 0: every digest equal.
Exit 1: a digest differs, a child failed, or no card was found without
``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# flight-record fields excluded from the canonical digest: capture-side
# provenance that legitimately differs between two runs of the same
# workload.  Everything else must be bit-identical.
FLIGHT_EXCLUDE = ("ts", "pid", "phase_ms", "device_memory_peak_bytes",
                  "trace_id", "capture", "retraces")

# the ledger exactness chain: the fields rewind's ledger_hex_exact
# invariant and kt_ledger's settlement accounting key on
LEDGER_KEYS = ("source", "action", "reason_code", "cost_delta_hex")

# the two children's hash seeds
HASH_SEEDS = ("0", "1")


def canon_flight_record(rec: dict) -> dict:
    """One flight record reduced to its replay-relevant form.  The
    ``determinism.digest`` fault point sits here: armed (the --drill
    path), it stamps a wall-clock value INTO the canonical form, the
    deliberate nondeterminism the double-run compare must catch."""
    d = {k: v for k, v in rec.items() if k not in FLIGHT_EXCLUDE}
    from karpenter_tpu_torch.utils import faults
    try:
        faults.fire("determinism.digest")
    except faults.FaultInjected:
        d["_drill_perturbation"] = time.time()
    return d


def canon_ledger_row(rec: dict) -> dict:
    return {k: rec.get(k) for k in LEDGER_KEYS}


def digest(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()


# -- child scenarios ---------------------------------------------------------
def _result_digest(res) -> dict:
    from karpenter_tpu_torch.utils import flightrecorder
    return flightrecorder.result_digest(res)


def _mixed_input(n_pods: int = 240):
    """config2's shape at smoke scale: mixed sizes, zonal selectors,
    a tainted dedicated pool, a spot-only pool."""
    from karpenter_tpu_torch.models import (
        NodePool, ObjectMeta, Pod, Requirement, Requirements, Resources,
        Taint, Toleration, wellknown)
    from karpenter_tpu_torch.providers import generate_catalog
    from karpenter_tpu_torch.scheduling import ScheduleInput
    catalog = generate_catalog()
    zones = ["tpu-west-1a", "tpu-west-1b", "tpu-west-1c"]
    sizes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"),
             ("2", "4Gi"), ("500m", "2Gi")]
    general = NodePool(meta=ObjectMeta(name="general"), weight=10)
    spot = NodePool(
        meta=ObjectMeta(name="spot-only"),
        requirements=Requirements(Requirement.make(
            wellknown.CAPACITY_TYPE_LABEL, "In", "spot")))
    dedicated = NodePool(meta=ObjectMeta(name="dedicated"),
                         taints=[Taint("team", "ml")])
    pods = []
    for i in range(n_pods):
        cpu, mem = sizes[i % len(sizes)]
        p = Pod(meta=ObjectMeta(name=f"m{i}"),
                requests=Resources.parse({"cpu": cpu, "memory": mem}))
        if i % 3 == 0:
            p.requirements = Requirements(Requirement.make(
                wellknown.ZONE_LABEL, "In", zones[i % len(zones)]))
        if i % 7 == 0:
            p.tolerations = [Toleration(key="team", operator="Exists")]
        pods.append(p)
    pools = [general, spot, dedicated]
    return ScheduleInput(pods=pods, nodepools=pools,
                         instance_types={p.meta.name: catalog
                                         for p in pools})


def _scenario_mixed(out: dict, device: str) -> None:
    from karpenter_tpu_torch.solver import TorchSolver
    solver = TorchSolver(max_nodes=256, mesh="off", delta="off",
                         device=device)
    res = solver.solve(_mixed_input())
    out["mixed"] = _result_digest(res)


def _scenario_delta_churn(out: dict, device: str) -> None:
    """Three churn generations through delta="auto" — op-for-order
    delta replay is a headline exactness claim (PAPER.md)."""
    from karpenter_tpu_torch.models import (NodePool, ObjectMeta, Pod,
                                            Resources)
    from karpenter_tpu_torch.providers import generate_catalog
    from karpenter_tpu_torch.scheduling import ScheduleInput
    from karpenter_tpu_torch.solver import TorchSolver
    catalog = generate_catalog()
    pool = NodePool(meta=ObjectMeta(name="default"))
    solver = TorchSolver(max_nodes=256, mesh="off", delta="auto",
                         device=device)

    def pods_at(gen: int):
        pods = []
        for g in range(8):
            stamp = gen if g >= 7 else 0  # only the tail class churns
            for i in range(25):
                cpu = 150 + 40 * g
                pods.append(Pod(
                    meta=ObjectMeta(name=f"w{g}-{i}-{stamp}"),
                    requests=Resources.parse(
                        {"cpu": f"{cpu}m", "memory": f"{2 * cpu}Mi"})))
        return pods

    passes = []
    for gen in range(3):
        res = solver.solve(ScheduleInput(
            pods=pods_at(gen), nodepools=[pool],
            instance_types={"default": catalog}))
        passes.append(_result_digest(res))
    out["delta_churn"] = passes


def _scenario_gang_priority(out: dict, device: str) -> None:
    from karpenter_tpu_torch.models import (
        NodePool, ObjectMeta, Pod, Resources, wellknown)
    from karpenter_tpu_torch.providers import generate_catalog
    from karpenter_tpu_torch.scheduling import ScheduleInput
    from karpenter_tpu_torch.solver import TorchSolver
    catalog = generate_catalog()
    pool = NodePool(meta=ObjectMeta(name="default"))
    pods = []
    for gname, size, prio in (("ring", 3, 100), ("mesh", 2, 0)):
        for i in range(size):
            pods.append(Pod(
                meta=ObjectMeta(
                    name=f"{gname}-{i}",
                    annotations={
                        wellknown.GANG_NAME_ANNOTATION: gname,
                        wellknown.GANG_SIZE_ANNOTATION: str(size),
                        wellknown.PRIORITY_ANNOTATION: str(prio)}),
                requests=Resources.parse({"cpu": "2", "memory": "4Gi"})))
    for i in range(12):
        pods.append(Pod(meta=ObjectMeta(name=f"solo-{i}"),
                        requests=Resources.parse(
                            {"cpu": "500m", "memory": "1Gi"})))
    solver = TorchSolver(max_nodes=256, mesh="off", delta="off",
                         device=device)
    res = solver.solve(ScheduleInput(
        pods=pods, nodepools=[pool], instance_types={"default": catalog}))
    out["gang_priority"] = _result_digest(res)


def _scenario_rewind_segment(out: dict, device: str) -> None:
    """A short generated segment through the real Operator driver —
    ledger rows and solve flight records land in the spill dirs."""
    from karpenter_tpu_torch.timeline import generators as g
    from karpenter_tpu_torch.timeline import rewind
    stream = g.compose(
        g.diurnal_load(seed=11, duration=900.0, step=300.0,
                       base=1, peak=3, lifetime=600.0),
        g.gang_burst(at=300.0, gangs=1, size=3, seed=11),
        g.spot_storm(at=600.0, reclaims=1, seed=11),
    )
    report = rewind.replay(stream, driver="operator", resolution=300.0,
                           device=device)
    out["rewind"] = {
        "events_applied": report["events_applied"],
        "solves": report["solves"],
        "scheduled_final": report["scheduled_final"],
        "invariants_held": report["invariants_held"],
    }


def run_child(tmpdir: str, device: str) -> dict:
    """Run the scenario set on `device` with spills under `tmpdir`;
    return the digest document the parent compares."""
    from karpenter_tpu_torch.utils import faults, flightrecorder, ledger
    from karpenter_tpu_torch.utils.platform import configure
    device = configure(device)
    out: dict = {}
    _scenario_mixed(out, device)
    _scenario_delta_churn(out, device)
    _scenario_gang_priority(out, device)
    _scenario_rewind_segment(out, device)
    # rewind.replay() disarms ALL fault specs on exit (its own cleanup
    # discipline); the drill plan must survive into canonicalization
    if os.environ.get("KARPENTER_TPU_FAULTS"):
        faults.load_env()

    flight_dir = os.environ["KARPENTER_TPU_FLIGHT_DIR"]
    ledger_dir = os.environ["KARPENTER_TPU_LEDGER_DIR"]
    # directory loads — the multi-spill stitching path under test too
    flights = [canon_flight_record(r)
               for r in flightrecorder.load_records(flight_dir)]
    rows = [canon_ledger_row(r)
            for r in ledger.load_records(ledger_dir)]
    out["flight_records"] = len(flights)
    out["ledger_rows"] = len(rows)
    out["flight_digest"] = digest(flights)
    out["ledger_digest"] = digest(rows)
    return out


# -- parent ------------------------------------------------------------------
def _spawn(seed: str, drill: bool, device: str, tmp: str):
    """Start one child under PYTHONHASHSEED=`seed`, its spills and output
    under `tmp`."""
    from karpenter_tpu_torch.utils.platform import repo_root
    os.makedirs(tmp)
    env = dict(os.environ)
    env.update({
        "PYTHONHASHSEED": seed,
        "PYTHONPATH": (repo_root() + os.pathsep
                       + env.get("PYTHONPATH", "")),
        "KARPENTER_TPU_FLIGHT_DIR": os.path.join(tmp, "flight"),
        "KARPENTER_TPU_LEDGER_DIR": os.path.join(tmp, "ledger"),
    })
    # a clean slate for everything that would make the runs trivially
    # differ or trivially agree
    for k in ("KARPENTER_TPU_FAULTS", "KARPENTER_TPU_TIMELINE_DIR",
              "KARPENTER_TPU_FLIGHT_CAPTURE"):
        env.pop(k, None)
    if drill:
        env["KARPENTER_TPU_FAULTS"] = "determinism.digest=error"
    out = open(os.path.join(tmp, "stdout"), "w+")
    err = open(os.path.join(tmp, "stderr"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.tools.determinism",
         "--run-child", tmp, "--device", device],
        env=env, stdout=out, stderr=err, text=True, cwd=repo_root())
    proc.outputs = (out, err)
    return proc


def _finish(proc, seed: str) -> dict:
    proc.wait()
    stdout, stderr = [f.seek(0) or f.read() for f in proc.outputs]
    for f in proc.outputs:
        f.close()
    if proc.returncode != 0:
        print(stdout, file=sys.stderr)
        print(stderr, file=sys.stderr)
        raise SystemExit(
            f"[determinism] child (PYTHONHASHSEED={seed}) failed "
            f"rc={proc.returncode}")
    return json.loads(stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.tools.determinism")
    ap.add_argument("--drill", action="store_true",
                    help="arm the determinism.digest perturbation in "
                         "both children; the compare MUST fail (exit "
                         "non-zero) or the harness has no teeth")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the children's device (default: the card)")
    ap.add_argument("--run-child", metavar="TMPDIR", default=None,
                    help=argparse.SUPPRESS)  # internal: one scenario run
    args = ap.parse_args(argv)

    if args.run_child is not None:
        doc = run_child(args.run_child, args.device)
        print(json.dumps(doc, sort_keys=True))
        return 0

    from karpenter_tpu_torch.tools import device
    dev = device(args.device, "determinism")
    tmp = tempfile.mkdtemp(prefix="kt-determinism-")
    try:
        procs = [(seed, _spawn(seed, args.drill, dev,
                               os.path.join(tmp, seed)))
                 for seed in HASH_SEEDS]
        a, b = [_finish(proc, seed) for seed, proc in procs]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # empty digests compare equal for free — demand real coverage
    if not args.drill and not (a["flight_records"] > 0
                               and a["ledger_rows"] > 0):
        print(f"[determinism] no coverage: {a['flight_records']} flight "
              f"record(s), {a['ledger_rows']} ledger row(s)",
              file=sys.stderr)
        return 1

    mismatches = sorted(k for k in set(a) | set(b)
                        if a.get(k) != b.get(k))
    if mismatches:
        for k in mismatches:
            print(f"[determinism] MISMATCH {k}: "
                  f"hashseed0={a.get(k)!r} hashseed1={b.get(k)!r}",
                  file=sys.stderr)
        print(f"[determinism] {len(mismatches)} digest mismatch(es) "
              "across PYTHONHASHSEED 0 vs 1", file=sys.stderr)
        return 1
    print(f"[determinism] OK on {dev}: {a['flight_records']} flight "
          f"record(s), {a['ledger_rows']} ledger row(s), "
          f"flight={a['flight_digest'][:12]}… "
          f"ledger={a['ledger_digest'][:12]}… bit-identical across "
          "PYTHONHASHSEED 0 vs 1")
    return 0


if __name__ == "__main__":
    sys.exit(main())
