"""Cluster temperature CLI: ``python -m pinot_tpu_torch.tools.clusterstat URL``.

Renders the controller's segment-temperature aggregation(
``GET /tables/{t}/heat``, fed by the servers' heartbeat-piggybacked
heat snapshots): per table, the hottest segments with their decayed
access/bytes rates, lifetime totals, and reporting-instance counts —
the operator's view of what ROADMAP 3's tier lifecycle would promote
or demote next.

Options:
    --table T      one table (default: every table the controller lists)
    --top N        segments to print per table (default 10)
    --tiers        also fetch /tables/{t}/tiers and print each segment's
                   tier (hot/warm/cold) next to its heat
    --load         fetch /cluster/load instead: per-instance scheduler
                   pressure, heartbeat age/liveness, and the controller
                   autoscaler's state (watermarks, sustain counters,
                   last scale action)
    --brokers      fetch /brokers instead: the broker fleet with
                   live/draining state and per-broker QPS + cache hit
                   rate from heartbeat-piggybacked counters
    --user u:p     basic auth for an ACL'd controller
    --json         machine-readable output (one dict)
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import time
import urllib.error
import urllib.request


def _get(base_url: str, path: str, user: str = None) -> dict:
    req = urllib.request.Request(base_url.rstrip("/") + path)
    if user:
        token = base64.b64encode(user.encode()).decode()
        req.add_header("Authorization", f"Basic {token}")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read().decode("utf-8"))


def gather(base_url: str, table: str = None, user: str = None,
           tiers: bool = False) -> dict:
    """{table: heat dict} from the controller REST; with ``tiers=True``
    each heat dict also carries a ``tiers`` section
    (``/tables/{t}/tiers``)."""
    if table:
        tables = [table]
    else:
        tables = _get(base_url, "/tables", user).get("tables", [])
    out = {}
    for t in tables:
        doc = _get(base_url, f"/tables/{t}/heat", user)
        if tiers:
            doc["tiers"] = _get(base_url, f"/tables/{t}/tiers", user)
        out[t] = doc
    return out


def gather_load(base_url: str, user: str = None) -> dict:
    """The controller's /cluster/load doc: per-instance
    pressure + heartbeat ages + autoscaler state."""
    return _get(base_url, "/cluster/load", user)


def gather_brokers(base_url: str, user: str = None) -> dict:
    """The controller's /brokers doc: the fleet with
    liveness, drain state, and heartbeat-piggybacked QPS / cache-hit
    counters."""
    return _get(base_url, "/brokers", user)


def render_brokers(doc: dict) -> str:
    brokers = doc.get("brokers") or {}
    lines = [f"{len(brokers)} broker(s):"]
    for name in sorted(brokers):
        rec = brokers[name]
        state = "DRAINING" if rec.get("draining") \
            else ("live" if rec.get("live") else "STALE")
        lines.append(
            f"  {name}: [{state}] url={rec.get('url')} "
            f"qps={rec.get('qps')} queries={rec.get('queries')} "
            f"cacheHitRate={rec.get('cacheHitRate', 0.0):.1%} "
            f"hb={rec.get('heartbeatAgeMs')}ms")
    if not brokers:
        lines.append("  (no brokers registered — start one with "
                     "admin start-broker)")
    return "\n".join(lines)


def render_load(doc: dict) -> str:
    lines = []
    insts = doc.get("instances") or {}
    lines.append(f"{len(insts)} server instance(s):")
    for name in sorted(insts):
        rec = insts[name]
        live = "live" if rec.get("live") else "STALE"
        lines.append(
            f"  {name}: pressure={rec.get('pressure')} "
            f"hb={rec.get('heartbeatAgeMs')}ms [{live}] "
            f"endpoint={rec.get('endpoint')}")
    a = doc.get("autoscaler") or {}
    if not a:
        lines.append("autoscaler: not attached")
        return "\n".join(lines)
    lines.append(
        f"autoscaler: {a.get('servers')} server(s) "
        f"[{a.get('min')}..{a.get('max')}] "
        f"meanPressure={a.get('meanPressure')} "
        f"water={a.get('lowWater')}/{a.get('highWater')} "
        f"sustain(above={a.get('aboveTicks')}, below={a.get('belowTicks')}, "
        f"cooldown={a.get('cooldownTicks')}) "
        f"scaleOuts={a.get('scaleOuts')} scaleIns={a.get('scaleIns')}")
    last = a.get("lastAction")
    if last:
        lines.append(f"  last action: {last.get('action')} "
                     f"{last.get('instance')} -> "
                     f"{last.get('servers_after')} servers "
                     f"(pressure {last.get('mean_pressure')})")
    return "\n".join(lines)


def render(heat_by_table: dict, top: int = 10, now: float = None,
           tiers: bool = False) -> str:
    now = time.time() if now is None else now
    lines = []
    for table, heat in sorted(heat_by_table.items()):
        segs = heat.get("segments") or {}
        tier_segs = (heat.get("tiers") or {}).get("segments") or {}
        lines.append(
            f"table {table}: {len(segs)} segment(s) reporting heat "
            f"across {heat.get('instancesReporting', 0)} instance(s)")
        names = list(segs)[:max(1, top)]
        if tiers:
            # tiered-but-cold segments fall out of the heat top-N by
            # construction; list them too so the operator sees the
            # lifecycle's other end
            names += [n for n in tier_segs if n not in segs][:max(1, top)]
        for name in names:
            rec = segs.get(name, {})
            last = rec.get("lastAccessTs") or 0
            ago = f"{max(0.0, now - last):.0f}s ago" if last else "never"
            tier_txt = ""
            if tiers:
                tier_txt = f"tier={tier_segs.get(name, {}).get('tier', '?')} "
            lines.append(
                f"  {name}: {tier_txt}rate={rec.get('rate')} "
                f"bytesRate={rec.get('bytesRate')} "
                f"accesses={rec.get('accesses')} bytes={rec.get('bytes')} "
                f"replicas={rec.get('instances')} last={ago}")
        if not segs:
            lines.append("  (no heat reported yet — servers heartbeat "
                         "their snapshots every few seconds)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pinot_tpu_torch.tools.clusterstat",
        description="segment-temperature view from a pinot-tpu controller")
    ap.add_argument("controller", help="controller base URL "
                                       "(e.g. http://127.0.0.1:9000)")
    ap.add_argument("--table", default=None)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--tiers", action="store_true",
                    help="show each segment's hot/warm/cold tier next to "
                         "its heat (lifecycle view)")
    ap.add_argument("--load", action="store_true", dest="load",
                    help="show per-instance pressure, heartbeat "
                         "liveness, and autoscaler state instead of "
                         "segment heat (overload view)")
    ap.add_argument("--brokers", action="store_true", dest="brokers",
                    help="show the broker fleet: live/draining state "
                         "and per-broker QPS + cache hit rate from "
                         "heartbeat-piggybacked counters")
    ap.add_argument("--user", default=None, help="basic auth user:pass")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    try:
        if args.brokers:
            doc = gather_brokers(args.controller, user=args.user)
        elif args.load:
            doc = gather_load(args.controller, user=args.user)
        else:
            heat = gather(args.controller, table=args.table,
                          user=args.user, tiers=args.tiers)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"cannot reach controller {args.controller}: {e}",
              file=sys.stderr)
        return 2
    if args.brokers:
        print(json.dumps(doc, indent=2) if args.as_json
              else render_brokers(doc))
        return 0
    if args.load:
        print(json.dumps(doc, indent=2) if args.as_json
              else render_load(doc))
        return 0
    if args.as_json:
        print(json.dumps(heat, indent=2))
    else:
        print(render(heat, top=args.top, tiers=args.tiers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
