"""Python client: DB-API-flavored access to a broker fleet.

Equivalent of the reference's client libraries (pinot-clients/
pinot-java-client's Connection/ResultSetGroup and the external pinotdb
client): ``connect()`` to one broker HTTP endpoint, a broker URL *list*,
a cluster registry (fleet discovery), or an in-process Broker — cursors
with ``execute`` / ``fetch*`` / ``description`` / ``rowcount``, and
broker response stats on the cursor. Read-only by design — DML raises,
like the reference.

    from pinot_tpu_torch.client import connect
    conn = connect("http://localhost:8099")                  # one broker
    conn = connect(broker_urls=["http://a:8099", "http://b:8099"])
    conn = connect(registry=reg, discover=True)              # fleet
    cur = conn.cursor()
    cur.execute("SELECT city, COUNT(*) FROM t GROUP BY city")
    for row in cur:
        ...

Fleet behavior: queries round-robin across the target list;
a draining broker (HTTP 503 / in-band ``brokerDraining``) or a connect
failure rotates to the next target, bounded at two passes over the
fleet before failing typed (``NoLiveBrokersError``) — a fleet of
draining brokers fails fast instead of spinning. The 429 over-quota
policy is single-sourced in ``retry_after_s`` / ``is_quota_rejection``
and composes with rotation: a 429 retries ONCE against the same broker
after its Retry-After (quota is pacing, not placement), while 503s and
connect failures move on.

Streaming (``Cursor.execute_stream``): rows arrive incrementally
(in-process generator or HTTP chunked NDJSON from /query/sql/stream) —
``fetchone``/iteration pull from the live stream, so a 10M-row SELECT
never materializes client- or broker-side; ``cursor.stats`` fills when
the final chunk lands.
"""

from __future__ import annotations

import itertools
import json
import urllib.error
import urllib.request
from typing import Optional

apilevel = "2.0"
threadsafety = 1
paramstyle = "qmark"


class Error(Exception):
    """DB-API base error."""


class DatabaseError(Error):
    """Query-level failure reported by the cluster."""


class ProgrammingError(Error):
    """Client misuse (closed cursor, fetch before execute...)."""


class NoLiveBrokersError(DatabaseError):
    """Every broker in the rotation refused (draining) or was
    unreachable for two full passes — the typed fleet-exhaustion
    failure (never an unbounded spin)."""


# ---- 429 over-quota policy: ONE definition for every path --------------
# (in-process, HTTP unary, HTTP streaming): one bounded retry after
# Retry-After — a per-table QPS quota / admission 429 is a *pacing*
# signal, not a hard failure; the sleep is capped so a hostile or buggy
# header can't hang a client.
MAX_RETRY_AFTER_S = 5.0


def retry_after_s(value) -> float:
    """Clamp a Retry-After hint (header string or retryAfterSeconds
    number) to [0.05, MAX_RETRY_AFTER_S]; unparseable → 0.5 s."""
    try:
        return max(0.05, min(float(value), MAX_RETRY_AFTER_S))
    except (TypeError, ValueError):
        return 0.5


def is_quota_rejection(resp: dict) -> bool:
    """True when EVERY exception in a broker response is a 429 (quota /
    admission rejection — retriable after the response's own hint)."""
    excs = resp.get("exceptions") or []
    return bool(excs) and all(x.get("errorCode") == 429 for x in excs)


def _is_drain_rejection(resp: dict) -> bool:
    excs = resp.get("exceptions") or []
    return bool(resp.get("brokerDraining")) or (
        bool(excs) and all(x.get("errorCode") == 503 for x in excs))


class _RotateToPeer(Exception):
    """Internal: this target refused (draining) or is unreachable —
    try the next broker in the rotation."""


class Cursor:
    arraysize = 1

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._rows: Optional[list] = None
        self._pos = 0
        self.description = None
        self.rowcount = -1
        self.stats: dict = {}
        self._closed = False
        # streaming mode (execute_stream): live chunk iterator + the
        # current rows-chunk buffer
        self._chunks = None
        self._buf: list = []
        self._buf_pos = 0
        self._streamed = False

    # ---- DB-API surface -------------------------------------------------
    def execute(self, sql: str, params=None) -> "Cursor":
        if self._closed:
            raise ProgrammingError("cursor is closed")
        self._chunks = None
        self._buf, self._buf_pos = [], 0
        self._streamed = False
        sql = self._bind(sql, params)
        resp = self._conn._execute(sql)
        if resp.get("exceptions"):
            raise DatabaseError(resp["exceptions"])
        rt = resp.get("resultTable") or {"dataSchema": {"columnNames": [],
                                                        "columnDataTypes": []},
                                         "rows": []}
        names = rt["dataSchema"]["columnNames"]
        types = rt["dataSchema"]["columnDataTypes"]
        self.description = [(n, t, None, None, None, None, None)
                            for n, t in zip(names, types)]
        self._rows = [tuple(r) for r in rt["rows"]]
        self._pos = 0
        self.rowcount = len(self._rows)
        self.stats = {k: v for k, v in resp.items()
                      if k not in ("resultTable", "exceptions")}
        return self

    def execute_stream(self, sql: str, params=None) -> "Cursor":
        """Streaming execute: rows flow through ``fetchone``/
        iteration as the broker produces them. ``description`` fills from
        the stream's schema chunk before this returns; ``rowcount`` stays
        -1 (unknown until exhaustion) and ``stats`` fills when the final
        chunk arrives. Works for every query shape — the broker falls
        back to buffered-re-chunked delivery for non-streamable plans."""
        if self._closed:
            raise ProgrammingError("cursor is closed")
        sql = self._bind(sql, params)
        self._rows = None
        self._streamed = True
        self._buf, self._buf_pos = [], 0
        self._pos = 0
        self.rowcount = -1
        self.stats = {}
        self.description = None
        self._chunks = self._conn._execute_stream(sql)
        # pull until the schema (or a rowless final) so description is
        # usable immediately, like execute()
        while self.description is None and self._chunks is not None:
            if not self._pull_chunk():
                break
        return self

    def _pull_chunk(self) -> bool:
        """Advance the stream one chunk. Returns False at exhaustion."""
        try:
            chunk = next(self._chunks)
        except StopIteration:
            self._chunks = None
            return False
        kind = chunk.get("type")
        if kind == "schema":
            self.description = [
                (n, t, None, None, None, None, None)
                for n, t in zip(chunk.get("columnNames") or [],
                                chunk.get("columnDataTypes") or [])]
        elif kind == "rows":
            self._buf = chunk.get("rows") or []
            self._buf_pos = 0
        elif kind == "final":
            self._chunks = None
            self.stats = {k: v for k, v in chunk.items()
                          if k not in ("type", "exceptions")}
            if chunk.get("exceptions"):
                raise DatabaseError(chunk["exceptions"])
            return False
        return True

    @staticmethod
    def _bind(sql: str, params) -> str:
        if params is None:
            return sql
        # qmark substitution with conservative literal quoting;
        # ? inside single-quoted literals is not a placeholder
        parts = _split_placeholders(sql)
        if len(parts) != len(params) + 1:
            raise ProgrammingError(
                f"query has {len(parts) - 1} placeholders, "
                f"{len(params)} params given")
        out = []
        for i, p in enumerate(parts):
            out.append(p)
            if i < len(params):
                out.append(_quote(params[i]))
        return "".join(out)

    def _require_rows(self) -> list:
        if self._closed:
            raise ProgrammingError("cursor is closed")
        if self._rows is None and not self._streamed:
            raise ProgrammingError("fetch before execute")
        return self._rows if self._rows is not None else []

    def fetchone(self):
        if self._chunks is not None or self._buf_pos < len(self._buf):
            # streaming mode: drain the buffered chunk, then pull more
            while self._buf_pos >= len(self._buf):
                if self._chunks is None or not self._pull_chunk():
                    return None
            row = tuple(self._buf[self._buf_pos])
            self._buf_pos += 1
            return row
        rows = self._require_rows()
        if self._pos >= len(rows):
            return None
        row = rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> list:
        if size is None:
            size = self.arraysize
        if self._chunks is not None or self._buf_pos < len(self._buf):
            out = []
            while len(out) < size:
                row = self.fetchone()
                if row is None:
                    break
                out.append(row)
            return out
        rows = self._require_rows()
        out = rows[self._pos: self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> list:
        if self._chunks is not None or self._buf_pos < len(self._buf):
            out = []
            while True:
                row = self.fetchone()
                if row is None:
                    return out
                out.append(row)
        rows = self._require_rows()
        out = rows[self._pos:]
        self._pos = len(rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self) -> None:
        self._closed = True
        self._rows = None
        self._chunks = None
        self._buf = []


def _split_placeholders(sql: str) -> list:
    """Split on ? placeholders, ignoring ?s inside single-quoted strings
    AND double-quoted identifiers."""
    parts, cur = [], []
    in_sq = in_dq = False
    for ch in sql:
        if ch == "'" and not in_dq:
            in_sq = not in_sq
            cur.append(ch)
        elif ch == '"' and not in_sq:
            in_dq = not in_dq
            cur.append(ch)
        elif ch == "?" and not in_sq and not in_dq:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _quote(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v).replace("'", "''")
    return f"'{s}'"


class Connection:
    # two full passes over the rotation before failing typed: enough to
    # ride out one rolling drain, never an unbounded spin
    MAX_ROTATION_PASSES = 2

    # legacy aliases — the policy itself is single-sourced module-level
    MAX_RETRY_AFTER_S = MAX_RETRY_AFTER_S
    _retry_after_s = staticmethod(retry_after_s)
    _is_quota_rejection = staticmethod(is_quota_rejection)

    def __init__(self, broker_url: Optional[str] = None, broker=None,
                 registry=None, timeout_s: float = 30.0, auth=None,
                 ssl_context=None, broker_urls: Optional[list] = None,
                 brokers: Optional[list] = None, discover: bool = False):
        """``auth``: optional (username, password) for brokers running
        with HTTP Basic auth. ``ssl_context``: optional ssl.SSLContext for
        https:// broker URLs (e.g. TlsConfig.client_ssl_context() to trust
        a private CA). ``broker_urls``/``brokers``: a rotation list of
        HTTP endpoints / in-process Broker objects. ``registry`` with
        ``discover=True`` re-discovers the live fleet's URLs from broker
        heartbeats each query; ``registry`` alone keeps the embedded
        single-broker behavior."""
        self._ssl_context = ssl_context
        if broker_url is None and broker is None and registry is None \
                and not broker_urls and not brokers:
            raise ProgrammingError(
                "connect() needs a broker_url (or broker_urls), a Broker "
                "(or brokers), or a registry")
        self._urls = [u.rstrip("/") for u in (broker_urls or []) if u]
        if broker_url:
            self._urls.insert(0, broker_url.rstrip("/"))
        self._url = self._urls[0] if self._urls else None  # legacy attr
        self._auth_header = None
        if auth is not None:
            import base64

            cred = base64.b64encode(
                f"{auth[0]}:{auth[1]}".encode("utf-8")).decode("ascii")
            self._auth_header = f"Basic {cred}"
        self._brokers = list(brokers or [])
        if broker is not None:
            self._brokers.insert(0, broker)
        self._registry = registry if discover else None
        self._owns_broker = False
        if not self._brokers and not self._urls and registry is not None \
                and not discover:
            from pinot_tpu_torch.broker.broker import Broker

            self._brokers = [Broker(registry, timeout_s=timeout_s)]
            self._owns_broker = True
        self._timeout_s = timeout_s
        self._rr = itertools.count()  # round-robin start offset
        self._closed = False

    # ---- target rotation -------------------------------------------------
    def _targets(self) -> list:
        """The current rotation list: ("proc", Broker) and ("http", url)
        entries; registry-discovery mode re-reads the live fleet."""
        targets = [("proc", b) for b in self._brokers]
        urls = list(self._urls)
        if self._registry is not None:
            from pinot_tpu_torch.broker.fleet import discover_broker_urls

            urls += [u for u in discover_broker_urls(self._registry)
                     if u not in urls]
        targets += [("http", u) for u in urls]
        return targets

    def _rotate(self, fn):
        """Run ``fn(kind, target)`` against the rotation: round-robin
        start, advance on _RotateToPeer, bounded passes, typed
        exhaustion. The single rotation loop both unary and streaming
        executes ride."""
        if self._closed:
            raise ProgrammingError("connection is closed")
        targets = self._targets()
        if not targets:
            raise NoLiveBrokersError(
                "no live brokers (discovery returned an empty fleet)")
        start = next(self._rr)
        last: Optional[Exception] = None
        for n in range(self.MAX_ROTATION_PASSES * len(targets)):
            kind, target = targets[(start + n) % len(targets)]
            try:
                return fn(kind, target)
            except _RotateToPeer as e:
                last = e.__cause__ or e
                continue
        raise NoLiveBrokersError(
            f"all {len(targets)} broker(s) draining or unreachable "
            f"after {self.MAX_ROTATION_PASSES} passes "
            f"(last: {last})") from last

    # ---- unary execute ---------------------------------------------------
    def _execute(self, sql: str) -> dict:
        return self._rotate(
            lambda kind, target: self._execute_proc(target, sql)
            if kind == "proc" else self._execute_http(target, sql,
                                                      retry_quota=True))

    def _execute_proc(self, broker, sql: str) -> dict:
        resp = broker.execute(sql)
        if _is_drain_rejection(resp):
            raise _RotateToPeer(f"broker {resp.get('brokerId')} draining")
        if is_quota_rejection(resp):
            # in-process brokers ship the 429 in-band; honor the
            # response's own hint when present, then retry ONCE
            import time

            time.sleep(retry_after_s(resp.get("retryAfterSeconds", 0.5)))
            resp = broker.execute(sql)
            if _is_drain_rejection(resp):
                raise _RotateToPeer(
                    f"broker {resp.get('brokerId')} draining")
        return resp

    def _http_request(self, url: str, path: str, sql: str):
        headers = {"Content-Type": "application/json"}
        if self._auth_header:
            headers["Authorization"] = self._auth_header
        return urllib.request.Request(
            url + path,
            data=json.dumps({"sql": sql}).encode("utf-8"),
            headers=headers,
        )

    def _execute_http(self, url: str, sql: str, retry_quota: bool) -> dict:
        req = self._http_request(url, "/query/sql", sql)
        try:
            with urllib.request.urlopen(req, timeout=self._timeout_s,
                                        context=self._ssl_context) as resp:
                return json.loads(resp.read())
        except Error:
            raise
        except urllib.error.HTTPError as e:
            if e.code == 401:
                raise DatabaseError(
                    "authentication failed (HTTP 401): check the "
                    "connection's auth=(user, password)") from e
            if e.code == 429 and retry_quota:
                # over-quota: back off for the broker's Retry-After
                # (bounded) and retry once before surfacing the error
                import time

                time.sleep(retry_after_s(
                    e.headers.get("Retry-After") if e.headers else None))
                return self._execute_http(url, sql, retry_quota=False)
            if e.code == 503:
                # draining broker: typed refusal — rotate to a peer
                raise _RotateToPeer(f"broker {url} draining") from e
            raise DatabaseError(f"broker returned HTTP {e.code}") from e
        except urllib.error.URLError as e:
            # connect failure (broker down / not listening): rotate
            raise _RotateToPeer(f"broker {url} unreachable") from e
        except Exception as e:  # noqa: BLE001 — transport failure
            raise DatabaseError(f"broker unreachable: {e}") from e

    # ---- streaming execute -----------------------------------------------
    def _execute_stream(self, sql: str):
        """Chunk-dict iterator for Cursor.execute_stream. Rotation
        happens at stream OPEN (drain / connect failure / leading 429);
        once row chunks flow, failures surface in-band in the final
        chunk — a mid-stream replay could duplicate rows."""
        return self._rotate(
            lambda kind, target: self._open_proc_stream(target, sql)
            if kind == "proc" else self._open_http_stream(target, sql,
                                                          retry_quota=True))

    def _open_proc_stream(self, broker, sql: str, retry_quota: bool = True):
        gen = broker.execute_stream(sql)
        first = next(gen, None)
        if first is None:
            return iter(())
        if first.get("type") == "final":
            if _is_drain_rejection(first):
                raise _RotateToPeer(
                    f"broker {first.get('brokerId')} draining")
            if is_quota_rejection(first) and retry_quota:
                import time

                time.sleep(retry_after_s(
                    first.get("retryAfterSeconds", 0.5)))
                return self._open_proc_stream(broker, sql,
                                              retry_quota=False)
        return itertools.chain([first], gen)

    def _open_http_stream(self, url: str, sql: str, retry_quota: bool):
        req = self._http_request(url, "/query/sql/stream", sql)
        try:
            resp = urllib.request.urlopen(req, timeout=self._timeout_s,
                                          context=self._ssl_context)
        except urllib.error.HTTPError as e:
            if e.code == 401:
                raise DatabaseError(
                    "authentication failed (HTTP 401): check the "
                    "connection's auth=(user, password)") from e
            if e.code == 503:
                raise _RotateToPeer(f"broker {url} draining") from e
            raise DatabaseError(f"broker returned HTTP {e.code}") from e
        except urllib.error.URLError as e:
            raise _RotateToPeer(f"broker {url} unreachable") from e

        def gen():
            # urllib/http.client decode the chunked framing; each line is
            # one NDJSON chunk dict
            with resp:
                for line in resp:
                    line = line.strip()
                    if line:
                        yield json.loads(line)

        it = gen()
        first = next(it, None)
        if first is None:
            return iter(())
        if first.get("type") == "final" and is_quota_rejection(first) \
                and retry_quota:
            import time

            for _ in it:  # drain the connection before reuse
                pass
            time.sleep(retry_after_s(first.get("retryAfterSeconds", 0.5)))
            return self._open_http_stream(url, sql, retry_quota=False)
        return itertools.chain([first], it)

    def cursor(self) -> Cursor:
        if self._closed:
            raise ProgrammingError("connection is closed")
        return Cursor(self)

    def close(self) -> None:
        self._closed = True
        if self._owns_broker:
            for b in self._brokers:
                b.close()

    def commit(self) -> None:
        pass  # read-only: DB-API requires the method to exist

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def connect(broker_url: Optional[str] = None, **kwargs) -> Connection:
    return Connection(broker_url, **kwargs)
