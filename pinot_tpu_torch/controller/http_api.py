"""Controller admin REST: table metadata endpoints with per-principal ACLs.

Minimal analog of the reference's controller API resources
(pinot-controller/.../api/resources/PinotTableRestletResource.java) over
the cluster registry, with ``BasicAuthAccessControlFactory``-style
enforcement (common/auth.py): a principal only sees / reads the tables its
``principals.<user>.tables=`` list grants.

    GET /health               liveness (open, like the reference)
    GET /tables               {"tables": [...]} filtered to the principal
    GET /tables/<name>        {"config": ..., "schema": ...} or 403/404
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from pinot_tpu_torch.common.auth import BasicAuthAccessControl


class ControllerHttpServer:
    def __init__(self, registry, host: str = "127.0.0.1", port: int = 0,
                 users: Optional[dict] = None, acls: Optional[dict] = None,
                 access_control: Optional[BasicAuthAccessControl] = None):
        self.registry = registry
        if access_control is None and users:
            access_control = BasicAuthAccessControl(users, acls)
        elif access_control is None and acls:
            # ACLs without credentials cannot be enforced (see broker twin)
            raise ValueError("table acls require users (or access_control)")
        self._access = access_control
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _principal(self):
                if outer._access is None:
                    return ""
                return outer._access.authenticate(
                    self.headers.get("Authorization"))

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "OK"})
                    return
                principal = self._principal()
                if principal is None:
                    self.send_response(401)
                    self.send_header("WWW-Authenticate",
                                     'Basic realm="pinot-tpu-controller"')
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if self.path.rstrip("/") == "/cluster/load":
                    # per-instance pressure + heartbeat age + autoscaler
                    # state — the clusterstat --load payload.
                    # Cluster-wide data: principals with table grant
                    # lists are denied, like the broker's /metrics.
                    if outer._access is not None and \
                            outer._access.is_restricted(principal):
                        self._send(403, {"error": "Permission denied: "
                                                  "cluster load spans "
                                                  "tables outside this "
                                                  "principal's grants"})
                        return
                    import time as _time

                    from pinot_tpu_torch.cluster.registry import (
                        HB_STALE_S,
                        Role,
                    )

                    now_ms = _time.time() * 1000
                    instances = {}
                    for i in outer.registry.instances(Role.SERVER):
                        age_ms = max(0.0, now_ms - i.last_heartbeat_ms)
                        instances[i.instance_id] = {
                            "pressure": float(
                                getattr(i, "pressure", 0.0) or 0.0),
                            "heartbeatAgeMs": round(age_ms, 1),
                            # the shared 3-interval staleness rule
                            # (registry HB_STALE_S — same cut the
                            # LoadTracker and autoscaler apply)
                            "live": age_ms <= HB_STALE_S * 1000.0,
                            "endpoint": i.endpoint,
                        }
                    self._send(200, {
                        "instances": instances,
                        "autoscaler": outer.registry.autoscaler_state(),
                    })
                    return
                if self.path.rstrip("/") == "/brokers":
                    # fleet discovery: every registered broker
                    # with liveness, drain state, and the QPS / cache-hit
                    # counters its heartbeat piggybacked — what a DB-API
                    # client rotates over and clusterstat --brokers
                    # renders. Cluster-wide data: restricted principals
                    # are denied, like /cluster/load.
                    if outer._access is not None and \
                            outer._access.is_restricted(principal):
                        self._send(403, {"error": "Permission denied: "
                                                  "broker fleet spans "
                                                  "tables outside this "
                                                  "principal's grants"})
                        return
                    import time as _time

                    from pinot_tpu_torch.cluster.registry import (
                        HB_STALE_S,
                        Role,
                    )

                    now_ms = _time.time() * 1000
                    brokers = {}
                    for i in outer.registry.instances(Role.BROKER):
                        age_ms = max(0.0, now_ms - i.last_heartbeat_ms)
                        st = i.stats or {}
                        brokers[i.instance_id] = {
                            "url": st.get("url"),
                            "live": age_ms <= HB_STALE_S * 1000.0,
                            "draining": bool(st.get("draining")),
                            "heartbeatAgeMs": round(age_ms, 1),
                            "qps": float(st.get("qps", 0.0) or 0.0),
                            "queries": int(st.get("queries", 0) or 0),
                            "cacheHitRate": float(
                                st.get("cacheHitRate", 0.0) or 0.0),
                        }
                    self._send(200, {"brokers": brokers})
                    return
                if self.path == "/tables":
                    tables = outer.registry.tables()
                    if outer._access is not None:
                        tables = outer._access.allowed_tables(
                            principal, tables)
                    self._send(200, {"tables": sorted(tables)})
                    return
                heat_name = tier_name = None
                if self.path.startswith("/tables/") \
                        and self.path.rstrip("/").endswith("/heat"):
                    heat_name = self.path[len("/tables/"):].rstrip("/")
                    heat_name = heat_name[: -len("/heat")].strip("/")
                if self.path.startswith("/tables/") \
                        and self.path.rstrip("/").endswith("/tiers"):
                    tier_name = self.path[len("/tables/"):].rstrip("/")
                    tier_name = tier_name[: -len("/tiers")].strip("/")
                if tier_name:
                    # GET /tables/{t}/tiers: per-segment tier
                    # map aggregated from the servers' heartbeat tier
                    # snapshots — what the tier-aware assignment places
                    # by and clusterstat --tiers renders. Same non-empty-
                    # segment rule as /heat (a table literally named
                    # "tiers" keeps its metadata route).
                    if outer._access is not None and \
                            not outer._access.allows(principal, tier_name):
                        self._send(403, {"error": f"Permission denied on "
                                                  f"table {tier_name!r}"})
                        return
                    from pinot_tpu_torch.controller.controller import (
                        aggregate_tiers,
                    )

                    self._send(200,
                               aggregate_tiers(outer.registry, tier_name))
                    return
                if heat_name:
                    # GET /tables/{t}/heat: cluster-aggregated
                    # per-segment access temperature from the servers'
                    # heartbeat-piggybacked heat snapshots — the tier
                    # lifecycle's promotion/demotion input. Requires a
                    # NON-EMPTY table segment: plain GET /tables/heat is
                    # the metadata route for a table literally named
                    # "heat", not an aggregation over ''.
                    name = heat_name
                    if outer._access is not None and \
                            not outer._access.allows(principal, name):
                        self._send(403, {"error": f"Permission denied on "
                                                  f"table {name!r}"})
                        return
                    from pinot_tpu_torch.controller.controller import (
                        aggregate_heat,
                    )

                    self._send(200, aggregate_heat(outer.registry, name))
                    return
                if self.path.startswith("/tables/"):
                    name = self.path[len("/tables/"):].strip("/")
                    if outer._access is not None and \
                            not outer._access.allows(principal, name):
                        # deny BEFORE existence resolution: a denied
                        # principal can't probe the table namespace
                        self._send(403, {"error": f"Permission denied on "
                                                  f"table {name!r}"})
                        return
                    # raw names resolve their typed variants, like the
                    # reference's table resource
                    cfg, resolved = None, name
                    for cand in (name, f"{name}_OFFLINE", f"{name}_REALTIME"):
                        cfg = outer.registry.table_config(cand)
                        if cfg is not None:
                            resolved = cand
                            break
                    if cfg is None:
                        self._send(404, {"error": f"table {name!r} not found"})
                        return
                    schema = outer.registry.table_schema(resolved)
                    self._send(200, {
                        "config": cfg.to_json(),
                        "schema": schema.to_json() if schema else None,
                    })
                    return
                self._send(404, {"error": "not found"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="controller-http",
            daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
