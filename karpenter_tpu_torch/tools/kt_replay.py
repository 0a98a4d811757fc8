"""kt-replay: deterministically re-execute a captured flight record and
assert the result is bit-identical to what production answered.

The port's twin of `tools/kt_replay.py`: the same CLI and replay
discipline, re-executing on `TorchSolver` (single device, delta off,
spec off, recorder off) on `utils/platform.configure()`'s device — the
card unless KARPENTER_TPU_PLATFORM=cpu or KARPENTER_TPU_FORCE_CPU asks
for the CPU.

The flight recorder (`karpenter_tpu_torch/utils/flightrecorder.py`) writes one
JSONL record per solve; with `KARPENTER_TPU_FLIGHT_CAPTURE=1` each record
also references a pickled capture of the full problem (`capture-*.pkl`).
This CLI turns any such record into a one-command repro:

    python -m karpenter_tpu_torch.tools.kt_replay /var/flight/flight-1234.jsonl   # newest captured record
    python -m karpenter_tpu_torch.tools.kt_replay /var/flight/flight-1234.jsonl --seq 17
    python -m karpenter_tpu_torch.tools.kt_replay /var/flight/flight-1234.jsonl --trace-id <id>
    python -m karpenter_tpu_torch.tools.kt_replay /var/flight/capture-1234-17.pkl # bare capture (no digest check)

Replay discipline (why the re-execution is deterministic):

  * the solve kernel is a deterministic sequential scan — same encoded
    problem, same fill, bit for bit (the repo's mesh/delta/pipeline
    variants are each bit-identical to the plain single-device solve,
    parity-asserted in their own suites), so replay pins the simplest
    story: single-device, delta off, and compares against the recorded
    digest's IEEE-hex cost;
  * the capture was written BEFORE the solve ran, so records exist even
    for solves that crashed the process;
  * the recorder itself is disabled inside the replay (no recursive
    spill into the flight directory being inspected).

Exit 0: bit-identical nodes/cost (or no digest to compare).  Exit 1:
mismatch — congratulations, the parity bug reproduces on your desk.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def pick_record(records, seq=None, trace_id=None):
    """The record to replay: explicit --seq / --trace-id selector, else
    the NEWEST record carrying a capture reference."""
    if seq is not None:
        matches = [r for r in records if r.get("seq") == seq]
    elif trace_id is not None:
        matches = [r for r in records if r.get("trace_id") == trace_id]
    else:
        matches = [r for r in records if r.get("capture")]
    if not matches:
        raise SystemExit(
            "no matching flight record with a capture — was the solve "
            "recorded with KARPENTER_TPU_FLIGHT_CAPTURE=1?")
    return matches[-1]


def load_capture(path: str) -> dict:
    import pickle
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not isinstance(payload, dict) or "inp" not in payload:
        raise SystemExit(f"not a flight capture: {path}")
    return payload


def pin_replay_env(knobs: "dict | None" = None) -> None:
    """The replay environment, set BEFORE the solver resolves its knobs:
    recorder off (no recursive spill), delta off (an engaged delta pass
    is bit-identical to the full re-solve by contract, so the full path
    is the canonical replay), spec off (the chunked chain is
    bit-identical to the single program by contract), mesh off
    (single-device is the parity baseline every other story is asserted
    against).  The gang knob is SEMANTIC, not an execution strategy: a
    solve recorded with gangs disabled placed gang members as plain pods,
    so replay resolves it exactly as the recording did."""
    os.environ["KARPENTER_TPU_FLIGHT"] = "off"
    os.environ["KARPENTER_TPU_DELTA"] = "off"
    os.environ["KARPENTER_TPU_SPEC"] = "off"
    os.environ.setdefault("KARPENTER_TPU_MESH", "off")
    if knobs is not None and "gang" in knobs:
        os.environ["KARPENTER_TPU_GANG"] = (
            "on" if knobs.get("gang") else "off")


def replay_solver(payload: dict, device=None):
    """The replay's solver: a `TorchSolver` on `device` (configure()'s by
    default), single-device, delta, spec and the recorder off."""
    if device is None:
        from karpenter_tpu_torch.utils.platform import configure
        device = configure()
    from karpenter_tpu_torch.solver import TorchSolver
    return TorchSolver(max_nodes=payload.get("solver_max_nodes", 2048),
                       device=device, mesh="off", delta="off", spec="off")


def replay(payload: dict, knobs: "dict | None" = None, device=None) -> dict:
    """Re-execute the captured problem and return its bit-exact digest
    (the same shape `flightrecorder.result_digest` records)."""
    pin_replay_env(knobs)
    from karpenter_tpu_torch.utils import flightrecorder as fr
    res = replay_solver(payload, device).solve(
        payload["inp"], max_nodes=payload.get("max_nodes"))
    return fr.result_digest(res)


def compare(recorded: dict, replayed: dict) -> list:
    """Mismatches between the recorded digest and the replayed one —
    nodes and the IEEE-hex cost are the bit-identity contract; the
    placement counts ride along as extra diagnostics."""
    diffs = []
    for key in ("nodes", "price_hex", "existing_assignments",
                "unschedulable"):
        if key in recorded and recorded[key] != replayed.get(key):
            diffs.append(f"{key}: recorded {recorded[key]!r} != "
                         f"replayed {replayed.get(key)!r}")
    return diffs


def replay_file(path: str, seq=None, trace_id=None, device=None) -> dict:
    """Programmatic entry (tests): replay a record (JSONL) or a bare
    capture (pkl); returns {record, replayed, diffs}."""
    from karpenter_tpu_torch.utils import flightrecorder as fr
    if path.endswith(".pkl"):
        record = {"capture": path, "result": None}
    else:
        record = pick_record(fr.load_records(path), seq=seq,
                             trace_id=trace_id)
        if not record.get("capture"):
            raise SystemExit(
                f"record seq={record.get('seq')} carries no capture "
                "(fingerprint-only); re-run the workload with "
                "KARPENTER_TPU_FLIGHT_CAPTURE=1")
    replayed = replay(load_capture(record["capture"]),
                      knobs=record.get("knobs"), device=device)
    recorded = record.get("result") or {}
    return {"record": {k: record.get(k) for k in
                       ("seq", "trace_id", "fingerprint", "pods",
                        "groups", "knobs", "capture")},
            "recorded": recorded or None,
            "replayed": replayed,
            "diffs": compare(recorded, replayed) if recorded else []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.tools.kt_replay",
        description="Re-execute a captured flight record and assert "
                    "bit-identical nodes/cost.")
    ap.add_argument("path", help="flight-<pid>.jsonl or capture-*.pkl")
    ap.add_argument("--seq", type=int, default=None,
                    help="record sequence number to replay")
    ap.add_argument("--trace-id", default=None,
                    help="replay the record of this trace id")
    args = ap.parse_args(argv)
    out = replay_file(args.path, seq=args.seq, trace_id=args.trace_id)
    print(json.dumps(out, indent=2, default=str))
    if out["diffs"]:
        print("REPLAY MISMATCH — the parity bug reproduces:",
              file=sys.stderr)
        for d in out["diffs"]:
            print(f"  {d}", file=sys.stderr)
        return 1
    verdict = ("bit-identical to the recorded digest"
               if out["recorded"] else
               "replayed (no recorded digest to compare)")
    print(f"replay OK: {verdict}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
