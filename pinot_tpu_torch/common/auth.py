"""Per-principal access control: HTTP Basic credentials + table ACLs.

Equivalent of the reference's ``BasicAuthAccessControlFactory``
(pinot-broker/.../broker/broker/BasicAuthAccessControlFactory.java:44 and
the controller twin): principals configure as

    principals=admin,reader
    principals.admin.password=verysecret
    principals.reader.password=secret
    principals.reader.tables=events,metrics

A principal WITHOUT a ``tables=`` key (or with ``tables=*``) may access
every table; otherwise access is limited to the listed tables. Table names
compare case-insensitively on the RAW name — type suffixes (``_OFFLINE`` /
``_REALTIME``) are stripped first, like the reference's
``BasicAuthPrincipal.hasTable``.

Enforced at both public surfaces: the broker query API
(broker/http_api.py — a denied table answers 403 before any execution)
and the controller admin REST (controller/http_api.py — table metadata is
filtered/denied per principal).

A copy of pinot_tpu/common/auth.py for the port.
"""

from __future__ import annotations

import base64
import hmac
from typing import Mapping, Optional


def _base_table(table: str) -> str:
    t = table.strip()
    for suffix in ("_OFFLINE", "_REALTIME"):
        if t.upper().endswith(suffix):
            t = t[: -len(suffix)]
    return t.lower()


class BasicAuthAccessControl:
    """users: {name: password}; table_acls: {name: iterable of table names}
    — a principal absent from ``table_acls`` (or mapped to ``None``/"*")
    has access to all tables."""

    def __init__(self, users: Mapping[str, str],
                 table_acls: Optional[Mapping] = None):
        self._users = dict(users)
        self._acls: dict = {}
        for user, tables in (table_acls or {}).items():
            if tables is None:
                continue
            if isinstance(tables, str):
                tables = [t for t in tables.split(",") if t.strip()]
            tables = [t.strip() for t in tables]
            if "*" in tables:
                continue
            self._acls[user] = {_base_table(t) for t in tables}

    @classmethod
    def from_config(cls, conf) -> Optional["BasicAuthAccessControl"]:
        """Build from a Configuration holding ``principals*`` keys
        (``None`` when no principals are configured = auth disabled)."""
        names = [n.strip() for n in str(conf.get("principals", "")).split(",")
                 if n.strip()]
        if not names:
            return None
        users, acls = {}, {}
        for name in names:
            users[name] = str(conf.get(f"principals.{name}.password", ""))
            tables = conf.get(f"principals.{name}.tables")
            if tables is not None:
                acls[name] = tables
        return cls(users, acls)

    # ---- authentication --------------------------------------------------
    def authenticate(self, authorization_header: Optional[str]) -> Optional[str]:
        """Authorization header → principal name, or None when rejected.
        Compares against a dummy for unknown users so timing doesn't
        enumerate usernames."""
        header = authorization_header or ""
        if not header.startswith("Basic "):
            return None
        try:
            raw = base64.b64decode(header[6:]).decode("utf-8")
            user, _, pw = raw.partition(":")
        except Exception:  # noqa: BLE001 — malformed header
            return None
        expected = self._users.get(user)
        known = expected is not None
        ref = (expected if known else "\x00dummy").encode("utf-8")
        ok = hmac.compare_digest(pw.encode("utf-8"), ref) and known
        return user if ok else None

    # ---- authorization ---------------------------------------------------
    @property
    def restricts_tables(self) -> bool:
        """False when no principal has a table list — callers can skip
        table resolution entirely (pure-auth deployments)."""
        return bool(self._acls)

    def is_restricted(self, user: str) -> bool:
        """True when the principal has a table grant list (cross-table
        surfaces like /metrics must deny these principals)."""
        return user in self._acls

    def allows(self, user: str, table: str) -> bool:
        allowed = self._acls.get(user)
        if allowed is None:
            return True  # unrestricted principal
        return _base_table(table) in allowed

    def allowed_tables(self, user: str, tables) -> list:
        """Filter a table listing down to what the principal may see."""
        return [t for t in tables if self.allows(user, t)]
