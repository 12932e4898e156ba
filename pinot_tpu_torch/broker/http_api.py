"""Broker HTTP endpoint: POST /query/sql, the reference's public query API.

Equivalent of pinot-broker/.../api/resources/PinotClientRequest.java (the
jersey resource brokering HTTP to BaseBrokerRequestHandler) — stdlib
ThreadingHTTPServer; each request body is {"sql": "..."} and the response is
the BrokerResponse JSON. /health mirrors the reference's health resource.

Auth (BasicAuthAccessControlFactory analog): pass ``users`` as
{username: password} to require HTTP Basic credentials on the query
endpoints; /health stays open like the reference's health resource.
``acls`` ({username: [table, ...]}) adds per-principal TABLE access
control (principals.<user>.tables= in config form): a query against a
table outside the principal's list answers 403 BEFORE any execution —
the reference's AccessControl.hasAccess check in
BaseBrokerRequestHandler.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from pinot_tpu_torch.common.auth import BasicAuthAccessControl


class BrokerHttpServer:
    def __init__(self, broker, host: str = "127.0.0.1", port: int = 0,
                 users: Optional[dict] = None, tls="auto",
                 acls: Optional[dict] = None,
                 access_control: Optional[BasicAuthAccessControl] = None):
        self.broker = broker
        if access_control is None and users:
            access_control = BasicAuthAccessControl(users, acls)
        elif access_control is None and acls:
            # ACLs without credentials cannot be enforced — constructing an
            # open endpoint the operator believes is table-restricted is
            # the one wrong answer
            raise ValueError("table acls require users (or access_control)")
        self._access = access_control
        if tls == "auto":
            from pinot_tpu_torch.common.tls import TlsConfig

            tls = TlsConfig.from_config()
        self.tls = tls
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 enables chunked transfer for the streaming result
            # path; safe for every other route because they all set
            # Content-Length (keep-alive framing stays intact)
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict,
                      headers: dict = None) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "OK"})
                    return
                # everything beyond /health requires credentials when auth
                # is enabled (metrics leak query/table statistics)
                principal = self._authorized()
                if principal is None:
                    self._reject_unauthorized()
                    return
                if outer._access is not None and \
                        outer._access.is_restricted(principal):
                    # metrics aggregate across ALL tables: a principal with
                    # a table grant list must not read them
                    self._send(403, {"error": "Permission denied: metrics "
                                              "span tables outside this "
                                              "principal's grants"})
                    return
                if self.path == "/metrics":
                    from pinot_tpu_torch.common.metrics import all_snapshots

                    self._send(200, all_snapshots())
                elif self.path.startswith("/debug/queries"):
                    # flight-recorder ring: the last N logged queries
                    # (slow/errored/sampled — broker/querylog.py policy),
                    # newest first, each with its merged trace attached
                    try:
                        from urllib.parse import parse_qs, urlparse

                        qs = parse_qs(urlparse(self.path).query)
                        limit = int(qs.get("limit", ["0"])[0])
                    except (ValueError, IndexError):
                        limit = 0
                    self._send(200, {
                        "queries": outer.broker.querylog.recent(limit)})
                elif self.path == "/metrics/prometheus":
                    from pinot_tpu_torch.common.metrics import all_prometheus_text

                    body = all_prometheus_text().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": "not found"})

            def _authorized(self):
                """Principal name, "" when auth is disabled, None when
                rejected."""
                if outer._access is None:
                    return ""
                return outer._access.authenticate(
                    self.headers.get("Authorization"))

            def _reject_unauthorized(self) -> None:
                self.send_response(401)
                self.send_header("WWW-Authenticate", 'Basic realm="pinot-tpu"')
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):
                if self.path not in ("/query/sql", "/query",
                                     "/query/sql/stream"):
                    self._send(404, {"error": "not found"})
                    return
                principal = self._authorized()
                if principal is None:
                    self._reject_unauthorized()
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    sql = payload.get("sql", "")
                    if outer.broker.draining:
                        # fleet drain: a REAL 503 before any
                        # execution — rotating clients move to a peer
                        self._send(503, outer.broker.drain_response(),
                                   headers={"Retry-After": "1"})
                        return
                    denied = outer._denied_table(principal, sql)
                    if denied is not None:
                        # per-principal table ACL: reject BEFORE execution
                        # (BaseBrokerRequestHandler access-control ordering)
                        self._send(403, {"exceptions": [{
                            "errorCode": 403,
                            "message": f"Permission denied on table "
                                       f"{denied!r} for principal "
                                       f"{principal!r}"}]})
                        return
                    if self.path == "/query/sql/stream":
                        self._stream_query(sql, principal)
                        return
                    # the authenticated principal is the tenant key for
                    # priority admission; "" (auth disabled)
                    # falls back to SET workloadName / 'default'
                    resp = outer.broker.execute(sql,
                                                principal=principal or None)
                    excs = resp.get("exceptions") or []
                    if excs and all(x.get("errorCode") == 429 for x in excs):
                        # over-quota: a real 429 status + Retry-After so
                        # standards clients (and our DB-API driver) can
                        # back off and retry instead of failing the call.
                        # The header derives from the broker's own pacing
                        # hint, ceiled to RFC delta-seconds (integers)
                        import math

                        after = math.ceil(float(
                            resp.get("retryAfterSeconds", 1.0)))
                        self._send(429, resp,
                                   headers={"Retry-After": str(max(1, after))})
                        return
                    self._send(200, resp)
                except Exception as e:  # noqa: BLE001
                    self._send(
                        200,
                        {"exceptions": [{"errorCode": 450,
                                         "message": f"{type(e).__name__}: {e}"}]},
                    )

            def _stream_query(self, sql: str, principal: str) -> None:
                """Chunked NDJSON result delivery: one JSON
                line per broker chunk (schema / rows / final), HTTP/1.1
                chunked transfer encoding written by hand so each chunk
                flushes as it is produced — client RTT-to-first-row is
                one block, broker RSS stays bounded. urllib/http.client
                decode the chunk framing transparently; consumers just
                readline NDJSON."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write_chunk(obj: dict) -> None:
                    line = (json.dumps(obj) + "\n").encode("utf-8")
                    self.wfile.write(f"{len(line):X}\r\n".encode("ascii"))
                    self.wfile.write(line)
                    self.wfile.write(b"\r\n")

                try:
                    for chunk in outer.broker.execute_stream(
                            sql, principal=principal or None):
                        write_chunk(chunk)
                except BrokenPipeError:
                    return  # client went away: stop producing
                except Exception as e:  # noqa: BLE001 — in-band, typed
                    try:
                        write_chunk({"type": "final", "exceptions": [{
                            "errorCode": 450,
                            "message": f"{type(e).__name__}: {e}"}]})
                    except OSError:
                        return
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if self.tls is not None:
            # HTTPS listener (reference: broker TLS via TlsConfig/Netty).
            # Defer the handshake off the accept loop: with
            # do_handshake_on_connect=True, SSLSocket.accept() handshakes
            # inside serve_forever's single accept thread, so one client
            # that connects and never sends a ClientHello would block ALL
            # broker HTTP traffic. Deferred, the handshake happens on the
            # handler thread's first recv.
            self._httpd.socket = self.tls.server_ssl_context().wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="broker-http", daemon=True
        )

    def _denied_table(self, principal: str, sql: str):
        """Table the principal may NOT query, or None when allowed.
        Unparseable SQL passes through — the broker's own compile error
        answers it in-band (no information leak: the table name in a
        broken query never resolves)."""
        if self._access is None or not self._access.restricts_tables:
            return None  # pure-auth setup: skip the extra SQL compile
        try:
            from pinot_tpu_torch.sql.parser import parse_sql

            stmt = parse_sql(sql)
            # a multi-stage (join) query touches EVERY referenced table —
            # each one must pass the principal's ACL, or a restricted
            # principal could read a denied table through a join
            tables = [stmt.table] + [j.table for j in stmt.joins]
        except Exception:  # noqa: BLE001 — broker reports the parse error
            return None
        for table in tables:
            if table and not self._access.allows(principal, table):
                return table
        return None

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def url(self) -> str:
        scheme = "https" if self.tls is not None else "http"
        return f"{scheme}://{self.host}:{self.port}"
