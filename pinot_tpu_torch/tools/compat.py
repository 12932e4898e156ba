"""Compatibility verifier: yaml-defined op suites against a live cluster.

Equivalent of the reference's compatibility verifier
(pinot-compatibility-verifier/.../compat/CompatibilityOpsRunner.java driven
by ``compatibility-verifier/compCheck.sh``): a suite file lists ops —
``tableOp`` (create/delete), ``segmentOp`` (upload/delete), ``queryOp``
(run SQL, compare rows), ``streamOp`` (produce events, await counts) —
executed in order against a cluster, so the same suite can gate behavior
across versions/upgrades. Here the cluster is the in-process quickstart
topology (or any supplied handle with controller/broker/registry).

Suite format (yaml or json)::

    operations:
      - type: tableOp
        op: CREATE
        schema: {name: t, dimensions: [[city, STRING]], metrics: [[v, LONG]]}
        tableConfig: {table_name: t}
      - type: segmentOp
        op: UPLOAD
        table: t
        segmentName: s0
        rows: [{city: sf, v: 3}, {city: nyc, v: 4}]
      - type: queryOp
        sql: SELECT city, SUM(v) FROM t GROUP BY city ORDER BY city
        expectedRows: [[nyc, 4], [sf, 3]]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


class CompatError(Exception):
    pass


def load_suite(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    try:
        import yaml
    except ImportError as e:  # pragma: no cover — pyyaml is a declared dep
        raise CompatError(
            "yaml suite files need pyyaml installed; use a .json suite "
            "or install pyyaml") from e
    return yaml.safe_load(text)


def _wait(cond, timeout_s: float, what: str) -> None:
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if cond():
            return
        time.sleep(0.05)
    raise CompatError(f"timed out waiting for {what}")


class CompatRunner:
    """Executes one suite against a cluster handle (registry + controller +
    broker). Collects per-op pass/fail like CompatibilityOpsRunner."""

    def __init__(self, registry, controller, broker, timeout_s: float = 20.0):
        self.registry = registry
        self.controller = controller
        self.broker = broker
        self.timeout_s = timeout_s
        self.results: list = []

    def run(self, suite: dict) -> bool:
        ops = suite.get("operations") or []
        ok = True
        for i, op in enumerate(ops):
            op_type = op.get("type", "?")
            try:
                getattr(self, f"_op_{op_type}", self._op_unknown)(op)
                self.results.append((i, op_type, "PASS", ""))
            except Exception as e:  # noqa: BLE001 — suite reports, not raises
                self.results.append((i, op_type, "FAIL", f"{e}"))
                ok = False
        return ok

    def _op_unknown(self, op: dict) -> None:
        raise CompatError(f"unknown op type {op.get('type')!r}")

    # ---- ops -------------------------------------------------------------
    def _op_tableOp(self, op: dict) -> None:
        from pinot_tpu_torch.common.schema import Schema
        from pinot_tpu_torch.common.table_config import TableConfig

        kind = op.get("op", "CREATE").upper()
        if kind == "CREATE":
            from pinot_tpu_torch.common.datatypes import DataType

            def fields(key):
                return [(n, DataType(t)) for n, t in op["schema"].get(key, [])]

            sch = op["schema"]
            schema = Schema.build(
                name=sch["name"],
                dimensions=fields("dimensions"),
                metrics=fields("metrics"),
                datetimes=fields("datetimes"),
                primary_key_columns=sch.get("primaryKeyColumns", []),
            )
            cfg = TableConfig.from_json(op["tableConfig"])
            self.controller.add_table(cfg, schema)
        elif kind == "DELETE":
            self.controller.drop_table(op["table"])
        else:
            raise CompatError(f"tableOp {kind!r} not supported")

    def _op_segmentOp(self, op: dict) -> None:
        kind = op.get("op", "UPLOAD").upper()
        table = op["table"]
        if kind == "DELETE":
            self.controller.delete_segment(table, op["segmentName"])
            return
        if kind != "UPLOAD":
            raise CompatError(f"segmentOp {kind!r} not supported")
        import numpy as np

        from pinot_tpu_torch.storage.creator import build_segment

        key = self.controller.resolve(table)
        schema = self.registry.table_schema(key)
        cfg = self.registry.table_config(key)
        if schema is None or cfg is None:
            raise CompatError(f"table {table!r} not found")
        rows = op["rows"]
        cols = {
            name: np.asarray([r.get(name) for r in rows])
            for name in schema.column_names()
        }
        import shutil

        before = len(self.registry.external_view(key))
        out = tempfile.mkdtemp(prefix="compat_seg_")
        try:
            build_segment(schema, cols, out, cfg, op["segmentName"])
            self.controller.upload_segment(table, out)
        finally:
            # upload copies into the deep store; the build dir is garbage
            shutil.rmtree(out, ignore_errors=True)
        _wait(lambda: len(self.registry.external_view(key)) > before
              or op["segmentName"] in {
                  s for segs in self.registry.external_view(key).values()
                  for s in segs},
              self.timeout_s, f"segment {op['segmentName']} serving")

    def _op_queryOp(self, op: dict) -> None:
        sql = op["sql"]
        expected = op.get("expectedRows")
        deadline = time.time() + self.timeout_s
        last = None
        while True:
            resp = self.broker.execute(sql)
            if not resp.get("exceptions"):
                got = resp["resultTable"]["rows"]
                if expected is None or got == expected:
                    return
                last = got
            else:
                last = resp["exceptions"]
            if time.time() > deadline:
                raise CompatError(f"query {sql!r}: got {last}, "
                                  f"expected {expected}")
            time.sleep(0.1)

    def _op_streamOp(self, op: dict) -> None:
        from pinot_tpu_torch.stream.memory_stream import TopicRegistry

        kind = op.get("op", "PRODUCE").upper()
        if kind == "CREATE_TOPIC":
            TopicRegistry.delete(op["topic"])
            TopicRegistry.create(op["topic"], int(op.get("partitions", 1)))
            return
        if kind != "PRODUCE":
            raise CompatError(f"streamOp {kind!r} not supported")
        topic = TopicRegistry.get(op["topic"])
        for row in op["rows"]:
            topic.publish_json(row, partition=int(row.pop("__partition", 0)))


def run_suite_file(path: str, timeout_s: float = 20.0,
                   keep_cluster=None, device=None) -> list:
    """Spin up a quickstart-topology cluster (or use ``keep_cluster``:
    a (registry, controller, broker) triple), run the suite, return
    results. The compCheck.sh entry point. The cluster runs on
    ``device``: the card unless the caller asks for "cpu"."""
    suite = load_suite(path)
    if keep_cluster is not None:
        registry, controller, broker = keep_cluster
        runner = CompatRunner(registry, controller, broker, timeout_s)
        runner.run(suite)
        return runner.results
    import shutil

    from pinot_tpu_torch.broker.broker import Broker
    from pinot_tpu_torch.cluster.registry import ClusterRegistry
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.server.server import ServerInstance

    work = tempfile.mkdtemp(prefix="compat_cluster_")
    registry = ClusterRegistry()
    controller = Controller(registry, f"{work}/ds")
    servers = [ServerInstance(f"server_{i}", registry, f"{work}/s{i}",
                              device=device) for i in range(2)]
    for s in servers:
        s.start()
    broker = Broker(registry, timeout_s=max(10.0, timeout_s), device=device)
    try:
        runner = CompatRunner(registry, controller, broker, timeout_s)
        runner.run(suite)
        return runner.results
    finally:
        broker.close()
        for s in servers:
            s.stop()
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pinot-compat", description="run a compatibility op suite")
    ap.add_argument("--suite", required=True, help="yaml/json suite file")
    ap.add_argument("--timeout", type=float, default=20.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the cluster (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    results = run_suite_file(args.suite, args.timeout, device=args.device)
    failed = 0
    for i, op_type, status, msg in results:
        line = f"[{i}] {op_type}: {status}"
        if msg:
            line += f" — {msg}"
        print(line)
        failed += status != "PASS"
    print(f"{len(results) - failed}/{len(results)} ops passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
