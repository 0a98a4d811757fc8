"""kt-explain: the post-mortem half of placement explainability.

The port's twin of `tools/kt_explain.py`: the same CLI, re-executing on
`TorchSolver` with kt_replay's pins (`kt_replay.pin_replay_env`) plus
the explain arm, on `utils/platform.configure()`'s device.

Turns a captured flight record into per-pod constraint-elimination
trees — after the process that solved it is gone.  The flight recorder
(`karpenter_tpu_torch/utils/flightrecorder.py`, `KARPENTER_TPU_FLIGHT_CAPTURE=1`)
pickled the FULL problem before the solve ran; this CLI re-executes it
with `KARPENTER_TPU_EXPLAIN=full` pinned and prints, for every stranded
pod, the registry reason code, which constraint eliminated which catalog
columns, the nearest-miss instance type, and the unblock suggestion.

    python -m karpenter_tpu_torch.tools.kt_explain /var/flight/flight-1234.jsonl           # newest captured record
    python -m karpenter_tpu_torch.tools.kt_explain /var/flight/flight-1234.jsonl --seq 17
    python -m karpenter_tpu_torch.tools.kt_explain /var/flight/flight-1234.jsonl --trace-id <id>
    python -m karpenter_tpu_torch.tools.kt_explain /var/flight/capture-1234-17.pkl         # bare capture
    python -m karpenter_tpu_torch.tools.kt_explain /var/flight/flight-1234.jsonl --pod web-42
    python -m karpenter_tpu_torch.tools.kt_explain --url http://operator:8000 --pod web-42 # live store

Replay discipline is kt_replay's (single-device, delta off, recorder
off — the parity baseline every other story is asserted against), plus
the explain arm.  Exit 0 on success (stranded pods are the POINT, not a
failure), 2 when --pod names a pod the replay did not strand.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def explain_capture(payload: dict, knobs: "dict | None" = None,
                    device=None) -> dict:
    """Re-execute a captured problem with explain armed; returns
    {summary, unschedulable: {pod: entry}} where each entry carries the
    code/detail/tree."""
    from karpenter_tpu_torch.tools.kt_replay import (pin_replay_env,
                                                     replay_solver)
    # kt_replay's pins plus the explain arm (full: this is the on-demand
    # path where the [G, O] detail is worth materializing), set BEFORE
    # the solver resolves its knobs
    pin_replay_env(knobs)
    os.environ["KARPENTER_TPU_EXPLAIN"] = "full"
    from karpenter_tpu_torch.solver import explain as explainmod
    from karpenter_tpu_torch.utils import flightrecorder as fr
    solver = replay_solver(payload, device)
    res = solver.solve(payload["inp"],
                       max_nodes=payload.get("max_nodes"))
    unsched = {}
    for pod, reason in sorted(res.unschedulable.items()):
        unsched[pod] = {
            "code": explainmod.code_of(reason),
            "constraint": explainmod.constraint_of(
                explainmod.code_of(reason)),
            "detail": str(reason),
            "tree": getattr(reason, "tree", None),
        }
    return {
        "digest": fr.result_digest(res),
        "explain": solver.last_explain,
        "unschedulable": unsched,
    }


def explain_file(path: str, seq=None, trace_id=None, device=None) -> dict:
    """Programmatic entry (tests): explain a flight JSONL record or a
    bare capture pkl."""
    from karpenter_tpu_torch.tools.kt_replay import load_capture, pick_record
    if path.endswith(".pkl"):
        record = {"capture": path}
    else:
        from karpenter_tpu_torch.utils import flightrecorder as fr
        record = pick_record(fr.load_records(path), seq=seq,
                             trace_id=trace_id)
        if not record.get("capture"):
            raise SystemExit(
                f"record seq={record.get('seq')} carries no capture "
                "(fingerprint-only); re-run the workload with "
                "KARPENTER_TPU_FLIGHT_CAPTURE=1")
    out = explain_capture(load_capture(record["capture"]),
                          knobs=record.get("knobs"), device=device)
    out["record"] = {k: record.get(k) for k in
                     ("seq", "trace_id", "fingerprint", "pods",
                      "groups", "knobs", "capture")}
    return out


def explain_url(url: str, pod: str, trace_id=None) -> dict:
    """The live-store path: query a running operator's
    GET /debug/explain for one pod.  Every failure mode — unreachable
    operator, HTTP error, a proxy's non-JSON error page — returns an
    {"error": ...} document (the CLI exits 2 on it), never a raw
    traceback."""
    import urllib.error
    import urllib.request
    q = f"{url.rstrip('/')}/debug/explain?pod={pod}"
    if trace_id:
        q += f"&trace_id={trace_id}"
    try:
        with urllib.request.urlopen(q, timeout=30) as r:
            body = r.read().decode()
    except urllib.error.HTTPError as e:
        try:
            body = e.read().decode()
        except OSError:
            return {"error": f"HTTP {e.code} from {q}"}
    except (urllib.error.URLError, OSError) as e:
        return {"error": f"operator unreachable at {url}: {e}"}
    try:
        return json.loads(body)
    except ValueError:
        return {"error": f"non-JSON response from {q}: {body[:200]!r}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.tools.kt_explain",
        description="Per-pod constraint-elimination explainability from "
                    "a captured flight record (replay with explain "
                    "armed) or a live operator's /debug/explain.")
    ap.add_argument("path", nargs="?", default=None,
                    help="flight-<pid>.jsonl or capture-*.pkl")
    ap.add_argument("--seq", type=int, default=None,
                    help="record sequence number to explain")
    ap.add_argument("--trace-id", default=None,
                    help="explain the record of this trace id")
    ap.add_argument("--pod", default=None,
                    help="print only this pod's tree (exit 2 if the "
                         "replay did not strand it)")
    ap.add_argument("--url", default=None,
                    help="query a live operator's /debug/explain "
                         "instead of replaying (requires --pod)")
    args = ap.parse_args(argv)

    if args.url:
        if not args.pod:
            ap.error("--url requires --pod")
        doc = explain_url(args.url, args.pod, trace_id=args.trace_id)
        print(json.dumps(doc, indent=2, default=str))
        return 0 if "error" not in doc else 2

    if not args.path:
        ap.error("a flight/capture path (or --url) is required")
    out = explain_file(args.path, seq=args.seq, trace_id=args.trace_id)
    unsched = out["unschedulable"]
    if args.pod is not None:
        entry = unsched.get(args.pod)
        if entry is None:
            print(f"pod {args.pod!r} was not stranded by the replay "
                  f"({len(unsched)} pods were)", file=sys.stderr)
            return 2
        print(json.dumps({"pod": args.pod, **entry}, indent=2,
                         default=str))
        return 0
    print(json.dumps(out, indent=2, default=str))
    print(f"explain: {len(unsched)} unschedulable pod(s); "
          + ("codes: " + ", ".join(sorted(
              {e['code'] for e in unsched.values()}))
             if unsched else "everything placed"), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
