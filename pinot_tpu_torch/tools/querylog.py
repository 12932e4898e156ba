"""Query-log summarizer: ``python -m pinot_tpu_torch.tools.querylog <log.jsonl>...``.

Reads the broker's structured JSONL query log (broker/querylog.py) and
prints the operator's five-minute view: volume + error/timeout/partial
counts, latency percentiles overall and per table/template, the
per-phase p50 breakdown reconstructed from the attached traces (queue /
compile / gather / kernel / link / reduce — the waterfall that tells
kernel-ms from link-ms from queue-ms), and the top-N slowest queries.

Accepts MULTIPLE log paths: a broker fleet writes one JSONL
per broker, each entry stamped with its ``brokerId`` — passing them all
merges the entries into one fleet-wide summary (per-template stats
aggregate across brokers) plus a per-broker volume/latency breakdown.

Options:
    --top N        how many slow queries to list (default 5)
    --per-template aggregate by literal-free template key too
    --json         machine-readable output (one summary dict)
"""

from __future__ import annotations

import argparse
import json
import sys


# phase buckets for the waterfall, matched on the span name's LAST dotted
# segment (nesting depth varies: "gather" from an embedded engine,
# "server.execute.gather" from a cluster server) — full-name buckets
# first. Matching a raw suffix substring would misbucket e.g.
# "broker.scatter_gather" as the gather phase.
PHASE_FULL_NAMES = {
    "server.queue": "queue",
    "server.compile": "compile",
    "server.trim": "reduce",
    "broker.reduce": "reduce",
    # the broker's scatter wall (the span behind the broker.scatterMs
    # timer) — previously missing, so the waterfall under-reported the
    # broker's share of every distributed query
    "broker.scatter_gather": "scatter",
    "broker.route": "route",
    # embedded multistage execution (query2/runner.py run_local): the
    # broker-local join/window stage
    "stage2": "stage2",
}
PHASE_LAST_SEGMENTS = {
    "gather": "gather",
    "kernel": "kernel",
    "link": "link",
    "host_scan": "host_scan",
    "host_fallback": "host_fallback",
    "merge": "reduce",
}


def _phase_bucket(name: str):
    bucket = PHASE_FULL_NAMES.get(name)
    if bucket is not None:
        return bucket
    return PHASE_LAST_SEGMENTS.get(name.rsplit(".", 1)[-1])


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return float(sorted_vals[idx])


def phase_breakdown(entry: dict) -> dict:
    """Per-phase ms for one log entry, summed across its servers.

    traceInfo values are span lists for single-stage queries, but the
    multistage path nests a whole per-leaf traceInfo DICT under each
    ``leaf:<alias>`` key ({instance: [spans], "broker": [spans]}) —
    recurse through dicts so join/window entries (and EXPLAIN ANALYZE on
    them) sum the same waterfall instead of crashing on string keys."""
    out: dict = {}

    def _walk(spans_or_nested):
        if isinstance(spans_or_nested, dict):
            for v in spans_or_nested.values():
                _walk(v)
            return
        for s in spans_or_nested or ():
            if not isinstance(s, dict):
                continue
            bucket = _phase_bucket(s.get("phase", ""))
            if bucket is not None:
                out[bucket] = out.get(bucket, 0.0) + s["durationMs"]

    _walk(entry.get("traceInfo") or {})
    return out


def _advisor_state(kind_sets: list) -> str:
    """Convergence label for one template's advisor override history
    (entry-ordered decision-kind sets). "cold" = no execution ever
    stamped an override; "converged" = the trailing executions all ran
    with the same override set (the memo stopped changing its mind);
    "adapting" = the override set is still moving."""
    if not any(kind_sets):
        return "cold"
    tail = kind_sets[-min(3, len(kind_sets)):]
    return "converged" if len(set(tail)) == 1 else "adapting"


def summarize(entries: list, top: int = 5,
              per_template: bool = False) -> dict:
    lats = sorted(e.get("timeUsedMs", 0.0) for e in entries)
    summary = {
        "queries": len(entries),
        "errors": sum(1 for e in entries if e.get("exceptions")),
        "partials": sum(1 for e in entries if e.get("partialResult")),
        "timeouts": sum(
            1 for e in entries
            if any(x.get("errorCode") == 250
                   for x in e.get("exceptions") or ())),
        "latencyMs": {
            "p50": round(_percentile(lats, 0.50), 2),
            "p90": round(_percentile(lats, 0.90), 2),
            "p99": round(_percentile(lats, 0.99), 2),
        },
    }
    phases: dict = {}
    for e in entries:
        for k, v in phase_breakdown(e).items():
            phases.setdefault(k, []).append(v)
    summary["phaseP50Ms"] = {
        k: round(_percentile(sorted(v), 0.5), 3)
        for k, v in sorted(phases.items())
    }
    by_table: dict = {}
    for e in entries:
        by_table.setdefault(e.get("table") or "?", []).append(
            e.get("timeUsedMs", 0.0))
    summary["tables"] = {
        t: {"queries": len(v),
            "p50Ms": round(_percentile(sorted(v), 0.5), 2),
            "p90Ms": round(_percentile(sorted(v), 0.9), 2)}
        for t, v in sorted(by_table.items())
    }
    if per_template:
        by_tpl: dict = {}
        for e in entries:
            counters = e.get("counters") or {}
            # the decisions a plan advisor override stamped on this
            # execution — e.g. "ADVISOR(candBound=1/32: ...)" — keyed on
            # the decision name left of '=' so per-template aggregation
            # sees "the advisor overrides candBound here", not one row
            # per measured value
            stamps = counters.get("advisorDecisions") or ()
            kinds = frozenset(
                s.split("(", 1)[-1].split("=", 1)[0] for s in stamps)
            by_tpl.setdefault(e.get("template") or "?", []).append(
                (e.get("timeUsedMs", 0.0),
                 bool(counters.get("partialsCacheHit")),
                 bool(counters.get("resultCacheHit")),
                 kinds))
        summary["templates"] = {
            t: {"queries": len(v),
                "p50Ms": round(
                    _percentile(sorted(x for x, _, _, _ in v), 0.5), 2),
                # device partials-cache hit rate for this literal-free
                # template — the repeat-dashboard-query signal the cache
                # exists to serve
                "cacheHitRate": round(
                    sum(1 for _, h, _, _ in v if h) / len(v), 3),
                # broker result-cache hit rate (the resultCacheHit):
                # hits answer with NO scatter at all, so a template whose
                # latency looks great may simply be cache-hot — the two
                # rates disambiguate
                "resultCacheHitRate": round(
                    sum(1 for _, _, h, _ in v if h) / len(v), 3),
                # plan advisor: how often the memo overrode a
                # static default for this template, which knobs it turned,
                # and whether the decision set has settled — "converged"
                # once the latest executions all stamp the same override
                # set (possibly empty after warm-up confirmed the
                # defaults), "adapting" while it still changes, "cold"
                # before any query ran with advisor overrides recorded
                "advisorOverrides": sum(len(k) for _, _, _, k in v),
                "advisorOverrideRate": round(
                    sum(1 for _, _, _, k in v if k) / len(v), 3),
                "advisorDecisions": sorted(
                    set().union(*(k for _, _, _, k in v))),
                "advisorState": _advisor_state([k for _, _, _, k in v])}
            for t, v in sorted(by_tpl.items())
        }
    # fleet breakdown: when entries carry brokerId stamps
    # (broker/querylog.py), break volume/error/latency down per broker —
    # the merged-fleet view's answer to "is one broker the slow one?"
    by_broker: dict = {}
    for e in entries:
        bid = e.get("brokerId")
        if bid:
            by_broker.setdefault(bid, []).append(e)
    if by_broker:
        summary["brokers"] = {
            b: {"queries": len(v),
                "errors": sum(1 for e in v if e.get("exceptions")),
                "p50Ms": round(_percentile(
                    sorted(e.get("timeUsedMs", 0.0) for e in v), 0.5), 2),
                "p90Ms": round(_percentile(
                    sorted(e.get("timeUsedMs", 0.0) for e in v), 0.9), 2)}
            for b, v in sorted(by_broker.items())
        }
    slowest = sorted(entries, key=lambda e: e.get("timeUsedMs", 0.0),
                     reverse=True)[:top]
    summary["slowest"] = [
        {"timeUsedMs": e.get("timeUsedMs"), "table": e.get("table"),
         "requestId": e.get("requestId"), "traceId": e.get("traceId"),
         "sql": (e.get("sql") or "")[:120],
         "phases": {k: round(v, 2)
                    for k, v in sorted(phase_breakdown(e).items())}}
        for e in slowest
    ]
    return summary


def load(path: str) -> list:
    entries = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except ValueError:
                continue  # torn tail line from rotation/crash
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pinot_tpu_torch.tools.querylog",
        description="summarize a pinot-tpu broker query log (JSONL)")
    ap.add_argument("paths", nargs="+", metavar="path",
                    help="query log file(s) — pass one per broker to "
                         "merge a fleet's logs")
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--per-template", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    entries = []
    for path in args.paths:
        try:
            entries.extend(load(path))
        except OSError as e:
            print(f"cannot read {path}: {e}", file=sys.stderr)
            return 2
    if not entries:
        print("no entries", file=sys.stderr)
        return 1
    summary = summarize(entries, top=args.top,
                        per_template=args.per_template)
    if args.as_json:
        print(json.dumps(summary, indent=2))
        return 0
    lat = summary["latencyMs"]
    print(f"{summary['queries']} logged queries | "
          f"{summary['errors']} errors ({summary['timeouts']} timeouts), "
          f"{summary['partials']} partial")
    print(f"latency p50/p90/p99: {lat['p50']} / {lat['p90']} / "
          f"{lat['p99']} ms")
    if summary["phaseP50Ms"]:
        print("phase p50s (ms): " + ", ".join(
            f"{k}={v}" for k, v in summary["phaseP50Ms"].items()))
    for b, row in (summary.get("brokers") or {}).items():
        print(f"  broker {b}: n={row['queries']} errors={row['errors']} "
              f"p50={row['p50Ms']}ms p90={row['p90Ms']}ms")
    for t, row in summary["tables"].items():
        print(f"  table {t}: n={row['queries']} p50={row['p50Ms']}ms "
              f"p90={row['p90Ms']}ms")
    if "templates" in summary:
        for t, row in summary["templates"].items():
            adv = ""
            if row["advisorState"] != "cold":
                kinds = ",".join(row["advisorDecisions"]) or "-"
                adv = (f" advisor={row['advisorState']} "
                       f"overrides={row['advisorOverrides']} "
                       f"({kinds})")
            print(f"  template {t}: n={row['queries']} p50={row['p50Ms']}ms "
                  f"partialsCache={row['cacheHitRate']:.1%} "
                  f"resultCache={row['resultCacheHitRate']:.1%}{adv}")
    print(f"top {len(summary['slowest'])} slowest:")
    for e in summary["slowest"]:
        phases = " ".join(f"{k}={v}" for k, v in (e["phases"] or {}).items())
        print(f"  {e['timeUsedMs']}ms [{e.get('table')}] "
              f"req={e.get('requestId')} {e['sql']!r} {phases}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
