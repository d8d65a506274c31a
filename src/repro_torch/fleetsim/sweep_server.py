"""Command-line front end of the sweep service (`fleetsim.service`):
what-if queries in as JSONL, one JSONL result per completed cell out.

    python -m repro_torch.fleetsim.sweep_server --queries queries.jsonl
    cat queries.jsonl | python -m repro_torch.fleetsim.sweep_server \\
        --queries - --out results.jsonl --device cpu

A query object takes "kind" ("dumbbell" | "fat_tree" | "multi_dc"), the
run config keys ("scheme", "n_warm", "n_meas", "seed", "backend") and any
scalar builder kwargs (k, n_wan, n_flows, drain_frac, ...), e.g.

    {"kind": "fat_tree", "k": 4, "n_flows": 2000, "n_warm": 2000}
    {"kind": "dumbbell", "n_intra": 64, "n_inter": 64, "drain_frac": 0.85}

Scenarios compile through the content-addressed cache ($UNO_SCENARIO_CACHE
or --cache-dir) onto --device (default cuda); same-shape queries batch
through the bucket ladder, and results stream as each batch completes,
tagged with the query index ("id") and its input line ("line").  A line
that cannot be served (broken JSON, a missing or unknown "kind", kwargs
the builder rejects) emits {"error": ..., "line": N} and the stream keeps
draining.  A final "stats" line reports every cache layer.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.fleetsim import service

_QUERY_KEYS = ("scheme", "n_warm", "n_meas", "seed", "backend")


def _parse_query(line: str, defaults: dict):
    obj = json.loads(line)
    kind = obj.pop("kind")
    cfg = {k: obj.pop(k) for k in _QUERY_KEYS if k in obj}
    return kind, obj, {**defaults, **cfg}


def serve(args) -> int:
    """Answer the queries of `args.queries` (a path, or "-" for stdin),
    writing JSONL to `args.out` (appended) or stdout."""
    svc = service.SweepService(cache_dir=args.cache_dir,
                               device=getattr(args, "device", None))
    src = sys.stdin if args.queries == "-" else open(args.queries)
    out = sys.stdout if args.out is None else open(args.out, "a")
    try:
        defaults = {"n_warm": args.n_warm, "n_meas": args.n_meas}
        queries, qlines = [], []
        with src:
            for lineno, line in enumerate(src, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    kind, kwargs, cfg = _parse_query(line, defaults)
                    fs = svc.scenario(kind, **kwargs)
                    queries.append(service.SweepQuery(fs, **cfg))
                    qlines.append(lineno)
                except Exception as e:  # noqa: BLE001 - per-line isolation
                    # a poisoned query emits an error record; the rest of
                    # the stream keeps draining
                    print(json.dumps({"error": f"{type(e).__name__}: {e}",
                                      "line": lineno}), file=out,
                          flush=True)
        t0 = time.time()
        for qid, _final, rates in svc.stream(queries):
            rec = {"id": qid, "line": qlines[qid],
                   "wall_s": round(time.time() - t0, 3),
                   **service.summarize_rates(rates)}
            print(json.dumps(rec), file=out, flush=True)
        print(json.dumps({"stats": svc.stats()}), file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleetsim.sweep_server",
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--queries", metavar="FILE", required=True,
                    help="JSONL query file, or - for stdin")
    ap.add_argument("--out", default=None,
                    help="append JSONL results here (default: stdout)")
    ap.add_argument("--cache-dir", default=None,
                    help="scenario bundle cache (default: "
                         "$UNO_SCENARIO_CACHE or "
                         "~/.cache/uno_fleetsim/scenarios)")
    ap.add_argument("--n-warm", type=int, default=2_000,
                    help="default warm-up epochs per query")
    ap.add_argument("--n-meas", type=int, default=500,
                    help="default measured epochs per query")
    ap.add_argument("--device", default=None,
                    help="torch device of the scenarios (default: cuda)")
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
