"""CLI over JSONL traces: summarize or convert to a Chrome trace.

    PYTHONPATH=src python -m repro_torch.obs summary TRACE.jsonl --top 5
    PYTHONPATH=src python -m repro_torch.obs chrome TRACE.jsonl -o trace.json

``summary`` prints markdown; ``chrome`` writes
Perfetto/``chrome://tracing`` JSON.  A trace written by either package
reads alike: both write the ``repro-obs/1`` schema.
"""
from __future__ import annotations

import argparse
import sys

from .chrome import export_chrome_trace, load_jsonl
from .summary import summary_table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="summarize or convert a repro-obs/1 JSONL trace")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ap_s = sub.add_parser("summary", help="markdown totals + slowest waves")
    ap_s.add_argument("trace", help="JSONL trace file (JsonlTracker output)")
    ap_s.add_argument("--top", type=int, default=5,
                      help="how many slowest waves to list (default 5)")
    ap_c = sub.add_parser("chrome", help="convert to Chrome trace JSON")
    ap_c.add_argument("trace", help="JSONL trace file (JsonlTracker output)")
    ap_c.add_argument("-o", "--out", default="trace.chrome.json",
                      help="output path (default trace.chrome.json)")
    args = ap.parse_args(argv)

    events = load_jsonl(args.trace)
    if args.cmd == "summary":
        print(summary_table(events, top=args.top))
    else:
        doc = export_chrome_trace(events, args.out)
        print(f"wrote {args.out} ({len(doc['traceEvents'])} trace events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
