"""Admin CLI: the ``pinot-admin.sh`` analog.

Equivalent surface to the reference's command-line tools
(pinot-tools/.../admin/PinotAdministrator.java and its StartController/
StartServer/StartBroker/LaunchDataIngestionJob/PostQuery/AddTable
commands). Multi-process clusters share a FileRegistry JSON file the way
the reference's roles share ZooKeeper; each ``start-*`` command blocks
until interrupted.

Usage examples::

    python -m pinot_tpu_torch.tools.admin quickstart
    python -m pinot_tpu_torch.tools.admin start-controller --registry /tmp/c.json
    python -m pinot_tpu_torch.tools.admin start-server   --registry /tmp/c.json --id server_1
    python -m pinot_tpu_torch.tools.admin start-broker   --registry /tmp/c.json --port 8099
    python -m pinot_tpu_torch.tools.admin add-table --registry /tmp/c.json \
        --schema schema.json --config table.json
    python -m pinot_tpu_torch.tools.admin ingest --registry /tmp/c.json --spec job.json
    python -m pinot_tpu_torch.tools.admin query --broker-url http://127.0.0.1:8099 \
        --sql "SELECT COUNT(*) FROM t"
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _registry(path: str):
    from pinot_tpu_torch.cluster.registry import FileRegistry

    return FileRegistry(path)


def _device(args):
    """The process's device: the card unless ``--device`` names another
    (``cpu`` runs the kernels' plain versions); ``--no-device`` is
    ``--device cpu``."""
    if getattr(args, "no_device", False):
        return "cpu"
    return getattr(args, "device", None)


def _add_device(sp) -> None:
    sp.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")


def _block():
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def cmd_quickstart(args) -> int:
    from pinot_tpu_torch.tools.quickstart import run_quickstart

    handle = run_quickstart(device=args.device)
    print("cluster running; Ctrl-C to stop")
    _block()
    handle.stop()
    return 0


def cmd_start_controller(args) -> int:
    from pinot_tpu_torch.controller.controller import Controller

    controller = Controller(_registry(args.registry), args.deep_store,
                            controller_id=args.id)
    controller.start_periodic_tasks(interval_s=args.period_s)
    print(f"controller {args.id} running (registry={args.registry}, "
          f"deep store={args.deep_store})")
    _block()
    controller.stop_periodic_tasks()
    return 0


def cmd_start_server(args) -> int:
    from pinot_tpu_torch.server.server import ServerInstance

    server = ServerInstance(args.id, _registry(args.registry), args.data_dir,
                            host=args.host, port=args.port,
                            max_concurrent_queries=args.max_concurrent,
                            device=_device(args))
    server.start()
    print(f"server {args.id} running on gRPC port {server.transport.port}")
    _block()
    server.stop()
    return 0


def cmd_start_broker(args) -> int:
    from pinot_tpu_torch.broker.broker import Broker
    from pinot_tpu_torch.broker.fleet import BrokerFleetMember
    from pinot_tpu_torch.broker.http_api import BrokerHttpServer

    # generous default: the first query on a fresh server builds its
    # kernels and uploads its planes before the caches warm up
    registry = _registry(args.registry)
    broker = Broker(registry, broker_id=args.id, timeout_s=args.timeout_s,
                    device=_device(args))
    users = None
    if args.auth:
        users = {}
        for a in args.auth:
            if ":" not in a:
                print(f"--auth expects user:password, got {a!r}",
                      file=sys.stderr)
                return 2
            u, _, p = a.partition(":")
            users[u] = p
    http = BrokerHttpServer(broker, host=args.host, port=args.port,
                            users=users)
    http.start()
    # fleet membership: register under Role.BROKER with the
    # serving URL so clients discover/rotate and peers gossip admission
    # spend — the BrokerStarter's Helix broker-resource registration
    fleet = BrokerFleetMember(registry, broker, http_url=http.url,
                              host=http.host, port=http.port)
    fleet.start()
    print(f"broker {args.id} serving {http.url}/query/sql")
    _block()
    fleet.stop()
    http.stop()
    broker.close()
    return 0


def cmd_start_minion(args) -> int:
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.minion.worker import MinionWorker

    registry = _registry(args.registry)
    controller = Controller(registry, args.deep_store,
                            controller_id=f"{args.id}_ctl")
    minion = MinionWorker(registry, controller, args.work_dir,
                          instance_id=args.id, device=_device(args))
    minion.start()
    print(f"minion {args.id} polling the task queue")
    _block()
    minion.stop()
    return 0


def cmd_add_table(args) -> int:
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.controller.controller import Controller

    schema = Schema.load(args.schema)
    with open(args.config) as f:
        config = TableConfig.from_json(json.load(f))
    controller = Controller(_registry(args.registry), args.deep_store)
    controller.add_table(config, schema)
    print(f"table {config.table_name_with_type} created")
    return 0


def cmd_ingest(args) -> int:
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.ingestion.job import IngestionJobSpec, run_ingestion_job

    spec = IngestionJobSpec.load(args.spec)
    controller = Controller(_registry(args.registry), args.deep_store)
    built = run_ingestion_job(spec, controller)
    print(f"built+pushed {len(built)} segments:")
    for d in built:
        print(f"  {d}")
    return 0


def cmd_query(args) -> int:
    if args.broker_url:
        import urllib.request

        req = urllib.request.Request(
            args.broker_url.rstrip("/") + "/query/sql",
            data=json.dumps({"sql": args.sql}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=args.timeout_s) as resp:
            out = json.loads(resp.read())
    else:
        from pinot_tpu_torch.broker.broker import Broker

        broker = Broker(_registry(args.registry), timeout_s=args.timeout_s,
                        device=_device(args))
        try:
            out = broker.execute(args.sql)
        finally:
            broker.close()
    json.dump(out, sys.stdout, indent=2, default=str)
    print()
    return 1 if out.get("exceptions") else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pinot_tpu_torch.tools.admin",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("quickstart",
                        help="in-process demo cluster with sample data")
    _add_device(sp)
    sp.set_defaults(fn=cmd_quickstart)

    sp = sub.add_parser("start-controller")
    sp.add_argument("--registry", required=True)
    sp.add_argument("--deep-store", default="./deepstore")
    sp.add_argument("--id", default="controller_0")
    sp.add_argument("--period-s", type=float, default=60.0)
    sp.set_defaults(fn=cmd_start_controller)

    sp = sub.add_parser("start-server")
    sp.add_argument("--registry", required=True)
    sp.add_argument("--data-dir", default="./serverdata")
    sp.add_argument("--id", default="server_0")
    sp.add_argument("--host", default="127.0.0.1",
                    help="bind + advertised gRPC host (container/pod "
                         "hostname or IP in multi-host deployments)")
    sp.add_argument("--port", type=int, default=0)
    _add_device(sp)
    sp.add_argument("--no-device", action="store_true",
                    help="the same as --device cpu: the kernels' plain "
                         "versions on the CPU (no card needed)")
    sp.add_argument("--max-concurrent", type=int, default=8,
                    help="scheduler admission width (concurrent queries "
                         "per server; excess queues). Size to the cores "
                         "this process may actually use — past that, "
                         "concurrent queries thrash instead of queueing")
    sp.set_defaults(fn=cmd_start_server)

    sp = sub.add_parser("start-broker")
    sp.add_argument("--registry", required=True)
    sp.add_argument("--id", default="broker_0")
    sp.add_argument("--host", default="127.0.0.1",
                    help="HTTP bind host (0.0.0.0 in containers)")
    sp.add_argument("--port", type=int, default=8099)
    sp.add_argument("--auth", action="append",
                    help="user:password (repeatable); enables HTTP basic "
                         "auth on the query endpoints")
    sp.add_argument("--timeout-s", type=float, default=60.0)
    _add_device(sp)
    sp.set_defaults(fn=cmd_start_broker)

    sp = sub.add_parser("start-minion")
    sp.add_argument("--registry", required=True)
    sp.add_argument("--deep-store", default="./deepstore")
    sp.add_argument("--work-dir", default="./minionwork")
    sp.add_argument("--id", default="minion_0")
    _add_device(sp)
    sp.set_defaults(fn=cmd_start_minion)

    sp = sub.add_parser("add-table")
    sp.add_argument("--registry", required=True)
    sp.add_argument("--schema", required=True)
    sp.add_argument("--config", required=True)
    sp.add_argument("--deep-store", default="./deepstore")
    sp.set_defaults(fn=cmd_add_table)

    sp = sub.add_parser("ingest")
    sp.add_argument("--registry", required=True)
    sp.add_argument("--spec", required=True)
    sp.add_argument("--deep-store", default="./deepstore")
    sp.set_defaults(fn=cmd_ingest)

    sp = sub.add_parser("query")
    sp.add_argument("--sql", required=True)
    sp.add_argument("--registry")
    sp.add_argument("--broker-url")
    sp.add_argument("--timeout-s", type=float, default=30.0)
    _add_device(sp)
    sp.set_defaults(fn=cmd_query)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "query" and not (args.registry or args.broker_url):
        print("query needs --registry or --broker-url", file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
