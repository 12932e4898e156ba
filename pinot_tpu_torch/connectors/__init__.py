"""DataFrame connectors: the spark/flink connector roles, pythonic form.

Reference analogs:
- pinot-connectors/pinot-spark-connector (DataSource v2 READ: scan a
  Pinot table into a distributed DataFrame) → ``read_table`` /
  ``query_df`` producing a pandas DataFrame;
- pinot-connectors/pinot-flink-connector (SINK: stream rows into
  segments) → ``write_table`` building + uploading segments from a
  DataFrame through the controller.

pandas is the DataFrame runtime of this build the way Spark/Flink are the
reference's; the read path rides the same broker SQL surface the spark
connector's gRPC server read rides.
"""

from __future__ import annotations

import math
from typing import Optional


def _quote_ident(name: str) -> str:
    """SQL-quote an identifier ("" escaping) unless it is already a plain
    (possibly dotted, db.table-style) identifier; a table/column name
    containing a quote must not rewrite the query it is interpolated into.
    Dotted names pass through unquoted so the parser's last-segment
    resolution (sql/parser.py parse_table_name) keeps working."""
    import re

    if re.fullmatch(r"[A-Za-z_$][\w$]*(\.[A-Za-z_$][\w$]*)*", name):
        return name
    return '"' + name.replace('"', '""') + '"'


def _quote_literal(value: str) -> str:
    """SQL string literal with '' escaping (the parser's string grammar)."""
    return "'" + str(value).replace("'", "''") + "'"


def query_df(source, sql: str):
    """One SQL query → pandas DataFrame. ``source``: a Broker, an engine,
    a DB-API Connection, or a broker URL string."""
    import pandas as pd

    resp = _execute(source, sql)
    if resp.get("exceptions"):
        raise RuntimeError(f"query failed: {resp['exceptions']}")
    table = resp.get("resultTable") or {"dataSchema": {"columnNames": []},
                                        "rows": []}
    return pd.DataFrame(table["rows"],
                        columns=table["dataSchema"]["columnNames"])


def read_table(source, table: str, columns=None, where: Optional[str] = None,
               batch_rows: int = 100_000):
    """Full-table scan → pandas DataFrame (spark-connector read role).

    Pages per SEGMENT by the $docId virtual column — the same
    partition-by-segment shape the spark connector's per-split reads use
    ($docId is segment-local, so global paging would be wrong) — keeping
    every request bounded by batch_rows instead of one giant LIMIT."""
    import pandas as pd

    cols = ", ".join(_quote_ident(c) for c in columns) if columns else "*"
    table = _quote_ident(table)
    base_where = f"({where}) AND " if where else ""
    # page over each segment's RAW doc-id range (MAX($docId)+1), not its
    # matching-row count — a filter would otherwise shrink the page span
    # and drop matching rows near the segment tail
    per_seg = _execute(
        source,
        f"SELECT $segmentName, MAX($docId) FROM {table}"
        + (f" WHERE {where}" if where else "")
        + " GROUP BY $segmentName ORDER BY $segmentName LIMIT 100000")
    if per_seg.get("exceptions"):
        raise RuntimeError(f"read_table failed: {per_seg['exceptions']}")
    if per_seg.get("numGroupsLimitReached") or \
            len(per_seg["resultTable"]["rows"]) >= 100_000:
        # a truncated segment listing would silently export a partial
        # table — refuse loudly (bulk-export API, not best-effort)
        raise RuntimeError(
            "read_table: segment discovery truncated (>100k segments or "
            "numGroupsLimit reached); export per partition/time range "
            "instead")
    frames = []
    for seg_name, max_doc in per_seg["resultTable"]["rows"]:
        n = int(max_doc) + 1
        for page in range(max(1, math.ceil(int(n) / batch_rows))):
            lo, hi = page * batch_rows, (page + 1) * batch_rows
            sql = (f"SELECT {cols} FROM {table} WHERE {base_where}"
                   f"$segmentName = {_quote_literal(seg_name)} AND "
                   f"$docId >= {lo} AND $docId < {hi} LIMIT {batch_rows}")
            frames.append(query_df(source, sql))
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


def write_table(df, schema, table: str, controller, segment_rows: int = 1_000_000,
                segment_prefix: Optional[str] = None) -> list:
    """DataFrame → segments → controller upload (flink-connector sink
    role). Returns the uploaded segment names."""
    import os
    import shutil
    import tempfile

    cfg = controller.registry.table_config(controller.resolve(table))
    if cfg is None:
        raise KeyError(f"table {table!r} not found")
    from pinot_tpu_torch.storage.creator import build_segment

    prefix = segment_prefix or f"{table}_df"
    names = []
    n = len(df)
    for i in range(max(1, math.ceil(n / segment_rows))):
        part = df.iloc[i * segment_rows: (i + 1) * segment_rows]
        cols = {}
        for name in part.columns:
            spec = schema.fields.get(name)
            if spec is not None and not spec.single_value:
                cols[name] = list(part[name])
            else:
                cols[name] = part[name].to_numpy()
        seg_name = f"{prefix}_{i}"
        tmp = tempfile.mkdtemp()
        try:
            d = os.path.join(tmp, seg_name)
            build_segment(schema, cols, d, cfg, seg_name)
            # upload copies into the deep store; the local build dir is
            # scratch and must not accumulate across pipeline runs
            controller.upload_segment(table, d)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        names.append(seg_name)
    return names


def _execute(source, sql: str) -> dict:
    if isinstance(source, str):
        from pinot_tpu_torch.client import connect

        with connect(source) as conn:
            return conn._execute(sql)
    if hasattr(source, "execute"):  # Broker or QueryEngine
        return source.execute(sql)
    if hasattr(source, "_execute"):  # DB-API Connection
        return source._execute(sql)
    raise TypeError(f"unsupported source {type(source).__name__}")
