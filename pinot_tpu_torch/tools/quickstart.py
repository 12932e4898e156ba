"""One-command quickstart: full in-process cluster + sample data + queries.

Equivalent of the reference's ``Quickstart``
(pinot-tools/.../Quickstart.java:43 — controller + broker + server + the
baseballStats sample, then example queries), using the in-memory registry,
real gRPC scatter/gather, the batch ingestion job runner, and the broker
HTTP endpoint. ``python -m pinot_tpu_torch.tools.quickstart`` keeps serving until
interrupted; tests call :func:`run_quickstart` and stop the handle.
"""

from __future__ import annotations

import csv
import os
import tempfile

import numpy as np

from pinot_tpu_torch.broker.broker import Broker
from pinot_tpu_torch.broker.http_api import BrokerHttpServer
from pinot_tpu_torch.cluster.registry import ClusterRegistry
from pinot_tpu_torch.common.datatypes import DataType
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import IndexingConfig, TableConfig
from pinot_tpu_torch.controller.controller import Controller
from pinot_tpu_torch.ingestion.job import IngestionJobSpec, run_ingestion_job
from pinot_tpu_torch.minion.worker import MinionWorker
from pinot_tpu_torch.server.server import ServerInstance

EXAMPLE_QUERIES = [
    "SELECT COUNT(*) FROM baseballStats",
    "SELECT SUM(homeRuns) FROM baseballStats",
    "SELECT teamID, SUM(runs) FROM baseballStats "
    "GROUP BY teamID ORDER BY SUM(runs) DESC LIMIT 5",
    "SELECT playerName, SUM(homeRuns) FROM baseballStats "
    "WHERE yearID >= 2000 GROUP BY playerName "
    "ORDER BY SUM(homeRuns) DESC LIMIT 5",
]

_TEAMS = ["ATL", "BOS", "CHC", "NYY", "OAK", "SEA", "SFG", "TEX"]
_NAMES = ["Aaron", "Bonds", "Cobb", "DiMaggio", "Gehrig", "Mays",
          "Ripken", "Ruth", "Trout", "Williams"]


def write_sample_csvs(data_dir: str, files: int = 2, rows: int = 500,
                      seed: int = 7) -> None:
    """Synthetic baseballStats-shaped sample (the repo carries no data
    files; the reference ships a CSV with the same columns)."""
    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    for i in range(files):
        with open(os.path.join(data_dir, f"baseballStats_{i}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["playerName", "teamID", "yearID", "runs", "homeRuns"])
            for _ in range(rows):
                w.writerow([
                    _NAMES[rng.integers(len(_NAMES))],
                    _TEAMS[rng.integers(len(_TEAMS))],
                    int(rng.integers(1990, 2024)),
                    int(rng.integers(0, 130)),
                    int(rng.integers(0, 50)),
                ])


class QuickstartHandle:
    def __init__(self, registry, controller, servers, broker, http, minion):
        self.registry = registry
        self.controller = controller
        self.servers = servers
        self.broker = broker
        self.http = http
        self.minion = minion

    def execute(self, sql: str) -> dict:
        return self.broker.execute(sql)

    def stop(self) -> None:
        self.minion.stop()
        self.http.stop()
        self.broker.close()
        for s in self.servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass


def _format_result(resp: dict) -> str:
    if resp.get("exceptions"):
        return f"  ERROR: {resp['exceptions']}"
    rt = resp.get("resultTable", {})
    cols = rt.get("dataSchema", {}).get("columnNames", [])
    lines = ["  " + " | ".join(str(c) for c in cols)]
    for row in rt.get("rows", []):
        lines.append("  " + " | ".join(str(v) for v in row))
    lines.append(f"  ({resp.get('timeUsedMs')} ms, "
                 f"{resp.get('numDocsScanned')} docs scanned)")
    return "\n".join(lines)


def run_quickstart(work_dir=None, n_servers: int = 2,
                   run_examples: bool = True, out=print,
                   device=None) -> QuickstartHandle:
    """An in-process cluster (registry, controller, ``n_servers``
    servers, a broker behind HTTP, a minion) over the sample data, on
    ``device``: the card unless the caller asks for "cpu"."""
    work_dir = work_dir or tempfile.mkdtemp(prefix="pinot_tpu_quickstart_")
    out(f"quickstart working dir: {work_dir}")

    registry = ClusterRegistry()
    controller = Controller(registry, os.path.join(work_dir, "deepstore"))
    servers = [
        ServerInstance(f"server_{i}", registry,
                       os.path.join(work_dir, f"server_{i}"),
                       device=device)
        for i in range(n_servers)
    ]
    for s in servers:
        s.start()
    broker = Broker(registry, device=device)
    http = BrokerHttpServer(broker)
    http.start()
    minion = MinionWorker(registry, controller, os.path.join(work_dir, "minion"),
                          device=device)
    minion.start()

    schema = Schema.build(
        name="baseballStats",
        dimensions=[("playerName", DataType.STRING), ("teamID", DataType.STRING)],
        metrics=[("runs", DataType.INT), ("homeRuns", DataType.INT)],
        datetimes=[("yearID", DataType.INT)],
    )
    config = TableConfig(
        table_name="baseballStats",
        replication=min(2, n_servers),
        indexing=IndexingConfig(inverted_index_columns=["teamID"]),
    )
    controller.add_table(config, schema)

    data_dir = os.path.join(work_dir, "rawdata")
    write_sample_csvs(data_dir)
    built = run_ingestion_job(
        IngestionJobSpec(table_name="baseballStats", input_dir=data_dir,
                         include_pattern="*.csv", format="csv"),
        controller,
    )
    out(f"ingested {len(built)} segments from {data_dir}")

    # wait until servers actually serve every pushed segment
    import time

    deadline = time.time() + 30
    want = len(built)
    while time.time() < deadline:
        if len(registry.external_view("baseballStats_OFFLINE")) >= want:
            break
        time.sleep(0.05)

    if run_examples:
        for sql in EXAMPLE_QUERIES:
            out(f"\n> {sql}")
            out(_format_result(broker.execute(sql)))
    out(f"\nbroker HTTP endpoint: {http.url}/query/sql "
        f'(POST {{"sql": "..."}})')
    return QuickstartHandle(registry, controller, servers, broker, http, minion)


def main() -> None:
    handle = run_quickstart()
    print("cluster running; Ctrl-C to stop")
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        handle.stop()


if __name__ == "__main__":
    main()
