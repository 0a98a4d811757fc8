"""kt-rewind: replay a cluster timeline and audit the whole trajectory.

The port's twin of `tools/kt_rewind.py`: the same CLI, scenarios, report
and exit codes, replaying through the port's `timeline/rewind.py` on the
card unless `--device cpu` asks for the CPU.

The timeline recorder (`karpenter_tpu_torch/timeline/recorder.py`)
spills one JSONL event per cluster mutation; the synthetic generators
(`timeline/generators.py`) emit the same stream shape from seeded
scenario builders.  This CLI replays either through a live control
plane (`timeline/rewind.py`) with every trajectory invariant auditor
armed — ledger-hex-exact cost chain, zero gang-atomicity violations,
zero priority inversions, shadow audit at rate=1, zero lost pods:

    python -m karpenter_tpu_torch.tools.kt_rewind /var/timeline/timeline-1234.jsonl
    python -m karpenter_tpu_torch.tools.kt_rewind --generate smoke --seed 7
    python -m karpenter_tpu_torch.tools.kt_rewind --generate day --driver operator
    python -m karpenter_tpu_torch.tools.kt_rewind --generate smoke --seek 40   # bit-identity check

Seek (`--seek K`): reconstruct the cluster at event K by replaying
[0..K) on a fresh environment, and compare its state digest bit-for-bit
against a straight-line replay's checkpoint at the same K (K snaps to a
tick boundary — state mid-tick is not defined).  The deterministic
"manager" driver backs seek; `--driver operator` routes the plain
replay through a real Operator's watch-driven loop instead.

Exit 0: replay complete, every invariant held (and seek bit-identical
when requested).  Exit 1: an invariant broke or seek diverged — the
report says which, with the first violating entries inline — or no card
was found without `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_scenario(name: str, seed: int):
    """The built-in seeded scenarios: `smoke` (sub-minute mixed drive),
    `day` (config #11's compressed fleet day, `workloads.
    build_rewind_day`), `storm` (spot interruption storm over a steady
    floor)."""
    from karpenter_tpu_torch.timeline import generators as g
    if name == "smoke":
        return g.compose(
            g.diurnal_load(seed=seed, duration=1500.0, step=300.0,
                           base=1, peak=4, lifetime=900.0),
            g.gang_burst(at=300.0, gangs=2, size=3, seed=seed),
            g.priority_wave(at=600.0, bands=((100, 2), (0, 3)),
                            seed=seed),
            g.spot_storm(at=900.0, reclaims=3, seed=seed),
            g.crash_schedule(1200.0, restart_after=300.0))
    if name == "day":
        from karpenter_tpu_torch.workloads import build_rewind_day
        return build_rewind_day(seed=seed)
    if name == "storm":
        return g.compose(
            g.diurnal_load(seed=seed, duration=3600.0, step=300.0,
                           base=2, peak=4, lifetime=2400.0),
            g.spot_storm(at=1800.0, reclaims=16, spacing=20.0,
                         seed=seed))
    raise SystemExit(f"unknown scenario {name!r} "
                     "(choose: smoke, day, storm)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.tools.kt_rewind",
        description="Replay a recorded or synthetic cluster timeline "
                    "against a live control plane with trajectory "
                    "invariant auditors armed.")
    ap.add_argument("path", nargs="?",
                    help="timeline-<pid>.jsonl spill to replay")
    ap.add_argument("--generate", metavar="SCENARIO",
                    help="synthesize a stream instead: smoke|day|storm")
    ap.add_argument("--seed", type=int, default=0,
                    help="generator seed (default 0)")
    ap.add_argument("--driver", choices=("manager", "operator"),
                    default="manager",
                    help="manager = deterministic stepped replay; "
                         "operator = through a real Operator run loop")
    ap.add_argument("--speedup", type=float, default=None,
                    help="pace wall time at recorded-time/SPEEDUP "
                         "(operator driver; default: as fast as the "
                         "operator drains)")
    ap.add_argument("--resolution", type=float, default=None,
                    help="quantize event offsets to this many seconds "
                         "per replay tick (throughput lever)")
    ap.add_argument("--seek", type=int, metavar="K",
                    help="seek/checkpoint bit-identity check at event K")
    ap.add_argument("--limit", type=int, default=None,
                    help="replay only the first N events")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the rate=1 shadow audit (faster)")
    ap.add_argument("--out", help="also write the full report JSON here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the solver's device (default: the card)")
    args = ap.parse_args(argv)

    if bool(args.path) == bool(args.generate):
        raise SystemExit("exactly one input: a spill path or --generate")
    if args.path:
        from karpenter_tpu_torch.timeline import load_events
        try:
            stream = load_events(args.path)
        except OSError as e:
            raise SystemExit(f"cannot read timeline {args.path!r}: {e}")
        if not stream:
            raise SystemExit(f"no timeline events in {args.path!r}")
    else:
        stream = build_scenario(args.generate, args.seed)
    if args.limit is not None:
        stream = stream[:args.limit]

    from karpenter_tpu_torch.timeline import rewind
    from karpenter_tpu_torch.tools import device
    kw = dict(audit=not args.no_audit, resolution=args.resolution,
              device=device(args.device, "kt-rewind"))
    if args.seek is not None:
        chk = rewind.seek_check(stream, args.seek, **kw)
        doc = {"mode": "seek", "k": chk["k"],
               "straight_digest": chk["straight_digest"],
               "seek_digest": chk["seek_digest"],
               "bit_identical": chk["bit_identical"],
               "report": chk["straight"]}
        ok = chk["bit_identical"] and \
            chk["straight"]["invariants_held"]
    else:
        report = rewind.replay(stream, driver=args.driver,
                               speedup=args.speedup, **kw)
        doc = {"mode": "replay", "report": report}
        ok = report["invariants_held"]

    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, default=str)
    rep = doc["report"]
    summary = {k: rep[k] for k in (
        "driver", "events_total", "events_applied", "wall_s",
        "events_per_s", "solves", "ledger_hex_exact",
        "zero_gang_atomicity_violations", "zero_priority_inversions",
        "audit_clean", "zero_lost_pods", "invariants_held")}
    summary["device"] = rep["device"]
    if args.seek is not None:
        summary["seek_bit_identical"] = doc["bit_identical"]
    print(json.dumps(summary, default=str))
    if not ok:
        print("kt-rewind: TRAJECTORY VIOLATION", file=sys.stderr)
        for key in ("ledger_breaks", "gang_violations",
                    "priority_inversions", "lost_pods"):
            if rep.get(key):
                print(f"  {key}: {rep[key]}", file=sys.stderr)
        if args.seek is not None and not doc["bit_identical"]:
            print(f"  seek digest {doc['seek_digest']} != straight "
                  f"{doc['straight_digest']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
