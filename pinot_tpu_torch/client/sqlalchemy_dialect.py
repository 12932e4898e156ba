"""SQLAlchemy dialect over the DB-API client — the second client surface
(pinot-clients/pinot-jdbc-client role: the JDBC client is a standards
surface wrapped around the java client; a SQLAlchemy dialect is the
pythonic equivalent wrapped around the DB-API module).

Gated on ``sqlalchemy`` (not in the build image): importing this module is
safe; constructing the dialect without sqlalchemy raises a clear error.

Usage:

    from pinot_tpu_torch.client.sqlalchemy_dialect import register_dialect
    register_dialect()
    engine = sqlalchemy.create_engine("pinot://localhost:8099")
    pd.read_sql("SELECT ... FROM tbl", engine)

URL: ``pinot://host:port`` → the broker's HTTP endpoint.
"""

from __future__ import annotations

TYPE_MAP = {
    # Pinot column data types → sqlalchemy type FACTORY NAMES; resolved
    # lazily so this module imports without sqlalchemy present
    "INT": "INTEGER",
    "LONG": "BIGINT",
    "FLOAT": "FLOAT",
    "DOUBLE": "FLOAT",
    "STRING": "VARCHAR",
    "BOOLEAN": "BOOLEAN",
    "TIMESTAMP": "TIMESTAMP",
    "BYTES": "LargeBinary",
    "JSON": "JSON",
    "BIG_DECIMAL": "Numeric",
}


def _sqlalchemy():
    try:
        import sqlalchemy

        return sqlalchemy
    except ImportError as e:  # pragma: no cover — exercised via fake module
        raise RuntimeError(
            "the pinot:// SQLAlchemy dialect needs the sqlalchemy package; "
            "use the DB-API client (pinot_tpu_torch.client.connect) directly "
            "otherwise") from e


def _resolve_type(sa, name: str):
    return getattr(sa.types, TYPE_MAP.get(name, "VARCHAR"), sa.types.VARCHAR)


def make_dialect_class():
    """Build the dialect class against the installed sqlalchemy (deferred
    base-class resolution keeps the module importable without it)."""
    sa = _sqlalchemy()
    from sqlalchemy.engine import default

    class PinotDialect(default.DefaultDialect):
        name = "pinot"
        driver = "pinot_tpu_torch"
        paramstyle = "qmark"
        supports_statement_cache = True
        supports_native_boolean = True
        supports_sane_rowcount = False
        supports_multivalues_insert = False
        postfetch_lastrowid = False

        @classmethod
        def import_dbapi(cls):
            import pinot_tpu_torch.client as dbapi

            return dbapi

        # SQLAlchemy <2 spelling
        @classmethod
        def dbapi(cls):
            return cls.import_dbapi()

        def create_connect_args(self, url):
            host = url.host or "localhost"
            port = url.port or 8099
            return [f"http://{host}:{port}"], {}

        def do_ping(self, dbapi_connection) -> bool:
            # SHOW TABLES is the cheapest broker round trip: a live broker
            # answers it; a dead connection raises → False so the pool
            # invalidates and reconnects (the one job pre-ping has)
            try:
                cur = dbapi_connection.cursor()
                cur.execute("SHOW TABLES")
                return True
            except Exception:  # noqa: BLE001 — transport failure
                return False

        def has_table(self, connection, table_name, schema=None, **kw):
            return table_name in self.get_table_names(connection, schema)

        def get_table_names(self, connection, schema=None, **kw):
            from pinot_tpu_torch.client import DatabaseError

            cur = connection.connection.cursor()
            try:
                cur.execute("SHOW TABLES")
                return [r[0] for r in cur.fetchall()]
            except DatabaseError:
                # in-band broker error (a broker without the catalog op):
                # empty catalog. Transport failures PROPAGATE — a down
                # broker must not reflect as an empty database.
                return []

        def get_columns(self, connection, table_name, schema=None, **kw):
            """Column metadata from a LIMIT 0 probe: the DataTable schema
            carries names + Pinot types, which is what the JDBC client's
            ResultSetMetaData exposes too."""
            cur = connection.connection.cursor()
            cur.execute(f"SELECT * FROM {table_name} LIMIT 0")
            out = []
            for (name, type_code, *_rest) in cur.description or []:
                out.append({
                    "name": name,
                    "type": _resolve_type(sa, str(type_code))(),
                    "nullable": True,
                    "default": None,
                })
            return out

        def get_pk_constraint(self, connection, table_name, schema=None, **kw):
            return {"constrained_columns": [], "name": None}

        def get_foreign_keys(self, connection, table_name, schema=None, **kw):
            return []

        def get_indexes(self, connection, table_name, schema=None, **kw):
            return []

        def get_schema_names(self, connection, **kw):
            return ["default"]

        def get_view_names(self, connection, schema=None, **kw):
            return []

    return PinotDialect


def register_dialect() -> None:
    """Register ``pinot://`` with sqlalchemy's dialect registry."""
    sa = _sqlalchemy()
    cls = make_dialect_class()
    sa.dialects.registry.register(
        "pinot", "pinot_tpu_torch.client.sqlalchemy_dialect", "dialect")
    # module attribute the registry entrypoint resolves
    globals()["dialect"] = cls
    return cls
