"""kt-ledger: the fleet spend/savings report over decision-ledger records.

The port's twin of `tools/kt_ledger.py`: the same CLI, flags and report,
over the port's ledger records (`utils/ledger.py`'s spill or a port
operator's `/debug/ledger`).  It reads records only and needs no device.

The decision ledger (`karpenter_tpu_torch/utils/ledger.py`) records every
fleet-mutating decision — provisioning launches, consolidation
deletes/replaces, drift, expiry, interruption reclaims, terminations —
with before/after fleet $/hr, the decision's exact cost delta, a
registry reason code, and trace-id + flight-seq cross links.  This CLI
renders the same records two ways:

    python -m karpenter_tpu_torch.tools.kt_ledger /var/ledger/ledger-<pid>.jsonl   # spilled trail
    python -m karpenter_tpu_torch.tools.kt_ledger /var/ledger                      # newest spill in a dir
    python -m karpenter_tpu_torch.tools.kt_ledger --url http://operator:8000       # live GET /debug/ledger
    ... [--pool P] [--since TS] [--limit N] [--json]

The summary block is `ledger.summarize` — the SAME rollup
`GET /debug/ledger` serves, so the CLI and the HTTP surface can never
disagree about identical records (checked by `chip_smoke.py` against
a replica on the card, and against the reference's tool in
`tests/test_torch_tools.py`).

Exit 0 on a rendered report (even an empty one — "no decisions yet" is
an answer); exit 2 on unusable input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _filter(records, pool=None, since=None, limit=None):
    if pool is not None:
        records = [r for r in records if pool in (r.get("pools") or ())]
    if since is not None:
        records = [r for r in records if (r.get("ts") or 0) >= since]
    if limit is not None and limit >= 0:
        records = records[-limit:] if limit else []
    return records


def load(path: str):
    """Records from a spilled JSONL file, or EVERY ledger-*.jsonl in a
    directory stitched oldest-first (a restarted operator leaves one
    spill per pid — the trail is their union, not just the newest).  A
    directory with no spills yet is the first-run case — an EMPTY
    trail, reported as such ("no decisions yet" is an answer, exit 0
    per the module contract); a path that does not exist at all is
    unusable input (exit 2), not a traceback."""
    from karpenter_tpu_torch.utils import ledger
    if os.path.isdir(path):
        spills = [f for f in os.listdir(path)
                  if f.startswith("ledger-") and f.endswith(".jsonl")]
        if not spills:
            print(f"kt-ledger: no ledger-*.jsonl under {path} yet — "
                  "no decisions recorded (was the operator run with "
                  "KARPENTER_TPU_LEDGER_DIR?)", file=sys.stderr)
            return []
    try:
        return ledger.load_records(path)
    except OSError as e:
        print(f"kt-ledger: cannot read {path!r}: {e}", file=sys.stderr)
        raise SystemExit(2)


def fetch(url: str, pool=None, since=None, limit=None):
    """Records from a live operator's GET /debug/ledger."""
    import urllib.parse
    import urllib.request
    q = {}
    if pool is not None:
        q["pool"] = pool
    if since is not None:
        q["since"] = since
    if limit is not None:
        q["limit"] = limit
    full = url.rstrip("/") + "/debug/ledger"
    if q:
        full += "?" + urllib.parse.urlencode(q)
    with urllib.request.urlopen(full, timeout=10) as r:
        doc = json.loads(r.read().decode())
    return doc.get("records", [])


def report(records) -> dict:
    """The machine-readable report: the shared summarize() rollup plus
    per-source savings/spend splits (programmatic entry for tests and
    the smoke gate)."""
    from karpenter_tpu_torch.utils import ledger
    out = ledger.summarize(records)
    by_source: dict = {}
    for r in records:
        src = r.get("source", "?")
        row = by_source.setdefault(
            src, {"records": 0, "saved": 0.0, "added": 0.0})
        row["records"] += 1
        delta = r.get("cost_delta") or 0.0
        if isinstance(delta, (int, float)):
            if delta < 0:
                row["saved"] += -delta
            else:
                row["added"] += delta
    for row in by_source.values():
        row["saved"] = round(row["saved"], 6)
        row["added"] = round(row["added"], 6)
    out["sources"] = by_source
    return out


def render_text(records, rep) -> str:
    lines = ["karpenter-tpu fleet spend ledger",
             f"  records: {rep['records']}"]
    if "fleet_cost_after_last_decision" in rep:
        lines.append("  fleet $/hr after last decision: "
                     f"{rep['fleet_cost_after_last_decision']:.4f}")
    lines.append(
        f"  savings: ${rep['savings_dollars_per_hr']:.4f}/hr removed, "
        f"${rep['spend_added_dollars_per_hr']:.4f}/hr added")
    for src, row in sorted(rep.get("sources", {}).items()):
        lines.append(f"  {src:>13}: {row['records']:>4} record(s)  "
                     f"-${row['saved']:.4f}/hr  +${row['added']:.4f}/hr")
    if records:
        lines.append("")
        lines.append("  seq  source        action   code"
                     "                      delta$/hr   fleet$/hr  pools")
        for r in records[-20:]:
            after = r.get("fleet_cost_after")
            after = float("nan") if after is None else after
            lines.append(
                f"  {str(r.get('seq', '?')):>3}  "
                f"{str(r.get('source', '')):<12}  "
                f"{str(r.get('action', '')):<7}  "
                f"{str(r.get('reason_code', '')):<24}  "
                f"{(r.get('cost_delta') or 0.0):+9.4f}  "
                f"{after:>9.4f}  "
                f"{','.join(r.get('pools') or [])}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.tools.kt_ledger",
        description="Spend/savings report over decision-ledger records.")
    ap.add_argument("path", nargs="?", default=None,
                    help="ledger-<pid>.jsonl or a spill directory")
    ap.add_argument("--url", default=None,
                    help="live operator base URL (GET /debug/ledger)")
    ap.add_argument("--pool", default=None,
                    help="only records touching this nodepool")
    ap.add_argument("--since", type=float, default=None,
                    help="only records with ts >= this unix timestamp")
    ap.add_argument("--limit", type=int, default=None,
                    help="newest-N cap on the record table")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    args = ap.parse_args(argv)
    if (args.path is None) == (args.url is None):
        ap.error("exactly one of <path> or --url is required")
    if args.url is not None:
        records = fetch(args.url, pool=args.pool, since=args.since,
                        limit=args.limit)
    else:
        records = _filter(load(args.path), pool=args.pool,
                          since=args.since, limit=args.limit)
    rep = report(records)
    if args.json:
        print(json.dumps({"summary": rep, "records": records},
                         default=str))
    else:
        print(render_text(records, rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
