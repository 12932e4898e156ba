"""The port's cluster core (pinot_tpu_torch/cluster, server, broker,
controller, transport) against the JAX package's, on the CPU.

Replays: the reference's own cluster test files run through the port.
Each is loaded anew as a module while ``sys.modules`` maps every
``pinot_tpu.<x>`` that the port has to ``pinot_tpu_torch.<x>``, so the
names it imports at its top are the port's; the same swap is in place
while each of its cases runs, for the imports inside test bodies. The
reference's engine choices map to the port's engine on the CPU (the
shims below): ``device_executor=None`` (its host-only engine) and the
default device executor alike, as the port has one engine. A replayed
case that a later item or a named divergence keeps from passing is not
bound here; it is listed by name with its reason (``NOT_REPLAYED``).

This file holds the replay harness the other cluster files import
(``replay``, ``port_swap``), the replays of test_cluster.py,
test_completion.py, test_file_registry.py, test_schema_evolution.py and
the two cluster cases of test_join.py / test_lookup.py, and the
differential scenario: one scripted cluster session through both
packages, compared on rows and stats.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import pathlib
import sys
import types

import pytest

TESTS = pathlib.Path(__file__).parent
_REF_ROOT = pathlib.Path(importlib.util.find_spec("pinot_tpu").origin).parent
_PORT_ROOT = _REF_ROOT.parent / "pinot_tpu_torch"


# packages whose ``__init__`` is a module of its own (the DB-API client,
# the connectors): swapped like any module
_MODULE_PACKAGES = ("client", "connectors")


def _port_pairs() -> dict:
    """{"pinot_tpu.<rel>": port module} for every module both packages
    have (packages themselves stay the reference's, but those in
    ``_MODULE_PACKAGES``)."""
    pairs = {}
    for path in sorted(_PORT_ROOT.rglob("*.py")):
        rel = path.relative_to(_PORT_ROOT).with_suffix("")
        if "_build" in rel.parts:
            continue
        if rel.name == "__init__":
            if rel.parent.parts not in [(p,) for p in _MODULE_PACKAGES]:
                continue
            rel = rel.parent
        elif not (_REF_ROOT / rel).with_suffix(".py").is_file():
            continue
        dotted = ".".join(rel.parts)
        pairs[f"pinot_tpu.{dotted}"] = importlib.import_module(
            f"pinot_tpu_torch.{dotted}")
    return pairs


def _shims(pairs: dict) -> dict:
    """The reference's engine choices on the port's CPU engine. The
    reference builds its host-only engine with ``device_executor=None``
    and its device engine by default; the port has one engine, which the
    tests run on the CPU. Only these shims map the reference's arguments:
    the port's own classes (and the minion worker and the quickstart,
    which take a ``device`` too) run on the card unless given "cpu"."""
    eng = pairs["pinot_tpu.engine.engine"]
    dev = pairs["pinot_tpu.engine.device"]
    srv = pairs["pinot_tpu.server.server"]
    brk = pairs["pinot_tpu.broker.broker"]

    class DeviceExecutor(dev.DeviceExecutor):
        def __init__(self, *args, mm_mode=None, device="cpu", **kw):
            super().__init__(device, *args, **kw)

    class QueryEngine(eng.QueryEngine):
        def __init__(self, device_executor="auto", *args, **kw):
            if device_executor in ("auto", None):
                kw.setdefault("device", "cpu")
                device_executor = None
            super().__init__(*args, device_executor=device_executor, **kw)

    class ServerInstance(srv.ServerInstance):
        def __init__(self, *args, device_executor="auto", **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*args, **kw)

    class Broker(brk.Broker):
        def __init__(self, *args, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*args, **kw)

    wrk = pairs["pinot_tpu.minion.worker"]
    qs = pairs["pinot_tpu.tools.quickstart"]

    class MinionWorker(wrk.MinionWorker):
        def __init__(self, *args, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*args, **kw)

    def run_quickstart(*args, device_executor="auto", **kw):
        kw.setdefault("device", "cpu")
        return qs.run_quickstart(*args, **kw)

    out = {}
    for name, mod, cls in (("engine.device", dev, DeviceExecutor),
                           ("engine.engine", eng, QueryEngine),
                           ("server.server", srv, ServerInstance),
                           ("broker.broker", brk, Broker),
                           ("minion.worker", wrk, MinionWorker),
                           ("tools.quickstart", qs, run_quickstart)):
        if isinstance(cls, type):
            cls.__name__ = cls.__qualname__ = cls.__mro__[1].__name__
        cls.__module__ = mod.__name__
        shim = types.ModuleType(mod.__name__, mod.__doc__)
        shim.__dict__.update(mod.__dict__)
        setattr(shim, cls.__name__, cls)
        out[f"pinot_tpu.{name}"] = shim
    return out


_PAIRS = None


def _swap_map() -> dict:
    global _PAIRS
    if _PAIRS is None:
        pairs = _port_pairs()
        pairs.update(_shims(pairs))
        _PAIRS = pairs
    return _PAIRS


@contextlib.contextmanager
def port_swap():
    """``pinot_tpu.<x>`` is the port's module while the block runs, in
    ``sys.modules`` and as an attribute of its (reference) package;
    whatever was there before comes back after, set or not. Reference
    modules (``pinot_tpu.<x>``) first imported during the block are
    dropped after it, from ``sys.modules`` and from their package, so none
    bound to the port's classes outlives it; every other module imported
    meanwhile stays."""
    import pinot_tpu  # noqa: F401 — the reference's packages exist

    swap = _swap_map()
    before = dict(sys.modules)
    attrs = []
    for name, mod in swap.items():
        parent_name, _, leaf = name.rpartition(".")
        parent = importlib.import_module(parent_name)
        attrs.append((parent, leaf, parent.__dict__.get(leaf, _MISSING)))
        sys.modules[name] = mod
        setattr(parent, leaf, mod)
    try:
        yield
    finally:
        for name in list(sys.modules):
            if (name.startswith("pinot_tpu.") and name not in before
                    and name not in swap):
                mod = sys.modules.pop(name)
                parent_name, _, leaf = name.rpartition(".")
                parent = sys.modules.get(parent_name)
                if parent is not None and parent.__dict__.get(leaf) is mod:
                    delattr(parent, leaf)
        for name in swap:
            if name in before:
                sys.modules[name] = before[name]
            else:
                sys.modules.pop(name, None)
        for parent, leaf, old in attrs:
            if old is _MISSING:
                parent.__dict__.pop(leaf, None)
            else:
                setattr(parent, leaf, old)


_MISSING = object()


def load_replay(test_file: str):
    """The reference test module ``tests/<test_file>.py`` loaded anew
    under the swap, as ``_port_replay.<test_file>``."""
    name = f"_port_replay.{test_file}"
    if name in sys.modules:
        return sys.modules[name]
    sys.modules.setdefault("_port_replay",
                           types.ModuleType("_port_replay"))
    spec = importlib.util.spec_from_file_location(
        name, TESTS / f"{test_file}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    with port_swap():
        spec.loader.exec_module(mod)
    return mod


def replay(namespace: dict, test_file: str, not_replayed: dict,
           classes=None) -> None:
    """Bind the reference file's fixtures and test cases into a test
    module's ``namespace``, so pytest collects them there. Cases named in
    ``not_replayed`` ("file::Class::case" or "file::case") stay out;
    ``classes`` limits the replay to those test classes."""
    mod = load_replay(test_file)
    out = {k.split("::", 1)[1] for k in not_replayed
           if k.startswith(f"{test_file}::")}
    for key, obj in vars(mod).items():
        if _is_fixture(obj):
            namespace[key] = obj
        elif classes is not None:
            continue
        elif key.startswith("test_") and callable(obj) and key not in out:
            namespace[key] = obj
    for key, obj in vars(mod).items():
        if not (key.startswith("Test") and isinstance(obj, type)):
            continue
        if classes is not None and key not in classes:
            continue
        gone = {c.split("::")[1]: None for c in out
                if c.startswith(f"{key}::")}
        namespace[key] = type(key, (obj,), gone) if gone else obj


def fails_as_listed(key: str, expect: str, request) -> None:
    """Run the replayed case ``key`` ("file::Class::case") through the
    port and hold it to the failure its listing names: it raises, and
    ``expect`` is in the message. A case that starts to pass, or fails
    another way, fails here, so the list cannot go stale."""
    import inspect

    test_file, *path = key.split("::")
    obj = load_replay(test_file)
    if len(path) == 2:
        obj = getattr(obj, path[0])()
    fn = getattr(obj, path[-1])
    names = [p for p in inspect.signature(fn).parameters if p != "self"]
    with port_swap():
        with pytest.raises(Exception) as err:
            fn(*[request.getfixturevalue(n) for n in names])
    assert expect in str(err.value), (key, str(err.value))


def _is_fixture(obj) -> bool:
    return (type(obj).__name__ == "FixtureFunctionDefinition"
            or hasattr(obj, "_pytestfixturefunction")
            or hasattr(obj, "_fixture_function_marker"))


def is_replayed(request) -> bool:
    fn = getattr(request, "function", None)
    return getattr(fn, "__module__", "").startswith("_port_replay.")


@pytest.fixture(autouse=True)
def _as_port(request):
    """The swap around each replayed case (its body and fixtures import
    ``pinot_tpu.<x>`` too); other tests run untouched."""
    if not is_replayed(request):
        yield
        return
    with port_swap():
        yield


# ---------------------------------------------------------------------------
# replays
# ---------------------------------------------------------------------------

# "file::Class::case" → (why it is not replayed, the text its failure
# through the port holds); test_not_replayed_case_fails_as_listed runs each
NOT_REPLAYED: dict = {}
# replayed cases whose timing flakes, each with its twin below
FLAKES = {
    "test_cluster::TestBrokerResultCache::"
    "test_hit_miss_parity_and_invalidation": (
        "waits for the table's segments in the external view, not for "
        "their second replicas: a replica's publish after the first query "
        "moves the routing generation, and the second query misses the "
        "cache (the reference's run flakes the same way, on the same "
        "line); test_result_cache_hit_miss_parity_twin waits for both"),
}

replay(globals(), "test_cluster", {**NOT_REPLAYED, **FLAKES})
replay(globals(), "test_completion", NOT_REPLAYED)
replay(globals(), "test_file_registry", NOT_REPLAYED)
replay(globals(), "test_schema_evolution", NOT_REPLAYED)
replay(globals(), "test_join", NOT_REPLAYED, classes=("TestBrokerMultistage",))
replay(globals(), "test_lookup", NOT_REPLAYED, classes=("TestClusterDimTable",))


def test_result_cache_hit_miss_parity_twin(cluster, tmp_path):
    """test_cluster.py's TestBrokerResultCache case on the port, its waits
    holding until every segment's replicas serve it (FLAKES): each
    server's first publish of a segment moves the routing generation,
    which a cached entry is validated against."""
    mod = load_replay("test_cluster")
    registry = cluster[0]
    real = mod.wait_until

    def wait_until(cond, timeout=10.0, interval=0.05):
        def settled():
            ev = registry.external_view(mod.TABLE_OFF)
            want = registry.assignment(mod.TABLE_OFF)
            return cond() and {k: sorted(v) for k, v in ev.items()} == \
                {k: sorted(v) for k, v in want.items()}
        return real(settled, timeout, interval)

    case = mod.TestBrokerResultCache().test_hit_miss_parity_and_invalidation
    with port_swap():
        mod.wait_until = wait_until
        try:
            case(cluster, tmp_path)
        finally:
            mod.wait_until = real


def test_port_swap_drops_only_reference_modules():
    """A reference module first imported under the swap is gone after
    it, from ``sys.modules`` and from its package; any other module
    imported meanwhile stays."""
    import pinot_tpu

    ref, other = "pinot_tpu._swap_probe", "_swap_probe_elsewhere"
    try:
        with port_swap():
            sys.modules[ref] = types.ModuleType(ref)
            pinot_tpu._swap_probe = sys.modules[ref]
            sys.modules[other] = types.ModuleType(other)
            assert sys.modules["pinot_tpu.broker.broker"] is \
                _swap_map()["pinot_tpu.broker.broker"]
        assert ref not in sys.modules
        assert not hasattr(pinot_tpu, "_swap_probe")
        assert other in sys.modules
        assert sys.modules.get("pinot_tpu.broker.broker") is not \
            _swap_map()["pinot_tpu.broker.broker"]
    finally:
        sys.modules.pop(other, None)


def test_cluster_modules_import_without_grpc():
    """The broker, server and controller modules import without the
    ``grpc`` package; only building a transport or channel needs it."""
    import subprocess

    code = (
        "import sys; sys.modules['grpc'] = None\n"
        "import pinot_tpu_torch.broker.broker, pinot_tpu_torch.server.server\n"
        "import pinot_tpu_torch.controller.controller\n"
        "import pinot_tpu_torch.broker.http_api\n"
        "import pinot_tpu_torch.controller.http_api\n"
        "from pinot_tpu_torch.transport import grpc_transport as g\n"
        "try:\n"
        "    g.QueryRouterChannel('127.0.0.1:1')\n"
        "except ImportError:\n"
        "    print('needs grpc')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(_REF_ROOT.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "needs grpc"


# ---------------------------------------------------------------------------
# one cluster session through both packages
# ---------------------------------------------------------------------------

STATS = ("numDocsScanned", "numEntriesScannedInFilter", "totalDocs",
         "numSegmentsQueried", "numSegmentsProcessed", "numSegmentsMatched",
         "numServersQueried", "numServersResponded", "numGroupsLimitReached",
         "partialResult", "partialResponse")

SESSION = (
    "SELECT COUNT(*), SUM(amount) FROM sales",
    "SELECT region, COUNT(*), SUM(amount), AVG(price) FROM sales "
    "GROUP BY region ORDER BY region",
    "SELECT product, SUM(amount) FROM sales GROUP BY product "
    "ORDER BY SUM(amount) DESC, product LIMIT 5",
    "SELECT region, product, amount FROM sales WHERE amount > 490 "
    "ORDER BY amount DESC, region, product LIMIT 10",
    "SELECT region, day, amount FROM sales WHERE day = 3 AND amount < 40 "
    "ORDER BY region, amount, day LIMIT 20",
    "SELECT DISTINCTCOUNTHLL(product) FROM sales",
    "SELECT region, DISTINCTCOUNTHLL(product) FROM sales GROUP BY region "
    "ORDER BY region",
    "SELECT PERCENTILETDIGEST(price, 50) FROM sales",
    "SELECT MIN(price), MAX(amount) FROM sales WHERE region = 'eu'",
    "SELECT day, COUNT(*) FROM sales WHERE day BETWEEN 2 AND 5 "
    "GROUP BY day ORDER BY day",
    "SELECT r.zone, COUNT(*), SUM(s.amount) FROM sales s JOIN regions r "
    "ON s.region = r.region GROUP BY r.zone ORDER BY r.zone",
    "EXPLAIN PLAN FOR SELECT region, SUM(amount) FROM sales "
    "GROUP BY region",
    "SELECT COUNT(*) FROM no_such_table",
)
# one query after the stop: the broker's failure detector half-opens the
# stopped server after a backoff of wall time (0.5 s), so later queries'
# routing would follow the machine's speed
AFTER_STOP = SESSION[:1]
REALTIME = ("SELECT COUNT(*), SUM(n) FROM dclicks",
            "SELECT page, COUNT(*), SUM(n) FROM dclicks GROUP BY page "
            "ORDER BY page")


def _session_data():
    import numpy as np

    rng = np.random.default_rng(20261018)
    regions = np.array(["na", "eu", "apac", "latam"])
    products = np.array([f"p{j:02d}" for j in range(60)])
    sales = [{
        "region": regions[rng.integers(0, 4, 3000)],
        "product": products[rng.integers(0, 60, 3000)],
        "day": rng.integers(0, 10, 3000).astype(np.int32),
        "amount": rng.integers(1, 500, 3000).astype(np.int32),
        "price": np.round(rng.uniform(1, 100, 3000), 2),
    } for _ in range(4)]
    dims = {"region": regions, "zone": np.array(["amer", "emea", "apj",
                                                 "amer"])}
    clicks = [{"page": f"page{i % 7}", "n": int(i % 13)} for i in range(250)]
    return sales, dims, clicks


def _wait(cond, timeout=20.0):
    import time

    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _pin_replica_order(registry, servers) -> None:
    """Each segment's replicas in the external view in server order. The
    broker's round robin picks a replica by its place in that list, which
    is the order the servers' sync loops happened to publish in, so
    ``numServersQueried`` would follow the loops' timing: each server in
    turn withdraws and publishes again what it serves."""
    for s in servers:
        registry.update_external_view(s.instance_id, {})
        registry.update_external_view(s.instance_id, s._serving_map())


def _session(pkg: str, tmp, data) -> list:
    """The scripted session on one package's cluster → every response."""
    m = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "broker.broker", "cluster.registry", "common.datatypes",
        "common.schema", "common.table_config", "controller.controller",
        "server.server", "storage.creator", "stream.memory_stream")}
    DT = m["common.datatypes"].DataType
    Schema = m["common.schema"].Schema
    tc = m["common.table_config"]
    build = m["storage.creator"].build_segment
    kw = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
    registry = m["cluster.registry"].ClusterRegistry()
    controller = m["controller.controller"].Controller(
        registry, str(tmp / "deepstore"))
    servers = [m["server.server"].ServerInstance(
        f"server_{i}", registry, str(tmp / f"srv{i}"), **kw)
        for i in range(3)]
    for s in servers:
        s.start()
    broker = m["broker.broker"].Broker(registry, timeout_s=20.0, **kw)
    sales, dims, clicks = data
    out = []
    try:
        schema = Schema.build(
            name="sales",
            dimensions=[("region", DT.STRING), ("product", DT.STRING),
                        ("day", DT.INT)],
            metrics=[("amount", DT.INT), ("price", DT.DOUBLE)])
        cfg = tc.TableConfig(table_name="sales", replication=2)
        controller.add_table(cfg, schema)
        for i, cols in enumerate(sales):
            d = str(tmp / f"up_s{i}")
            build(schema, cols, d, cfg, f"sales_s{i}")
            controller.upload_segment("sales", d)
        dschema = Schema.build(name="regions", dimensions=[
            ("region", DT.STRING), ("zone", DT.STRING)],
            primary_key_columns=["region"])
        dcfg = tc.TableConfig(table_name="regions", is_dim_table=True)
        controller.add_table(dcfg, dschema)
        build(dschema, dims, str(tmp / "up_r0"), dcfg, "regions_s0")
        controller.upload_segment("regions", str(tmp / "up_r0"))
        assert _wait(lambda: len(registry.external_view("sales_OFFLINE"))
                     == 4 and all(len(v) == 2 for v in registry.external_view(
                         "sales_OFFLINE").values())
                     and len(registry.external_view("regions_OFFLINE"))
                     == 1)
        _pin_replica_order(registry, servers)
        out += [broker.execute(sql) for sql in SESSION]
        # a realtime table commits a segment through the completion FSM
        topics = m["stream.memory_stream"].TopicRegistry
        topics.delete("dclicks")
        topic = topics.create("dclicks", 1)
        rschema = Schema.build(name="dclicks",
                               dimensions=[("page", DT.STRING)],
                               metrics=[("n", DT.INT)])
        rcfg = tc.TableConfig(
            table_name="dclicks", table_type=tc.TableType.REALTIME,
            stream=tc.StreamConfig(
                stream_type="memory", topic="dclicks", decoder="json",
                segment_flush_threshold_rows=100,
                segment_flush_threshold_seconds=3600))
        controller.add_table(rcfg, rschema)
        for row in clicks:
            topic.publish_json(row, partition=0)

        def settled():
            # every row counted, a commit done, and the next consuming
            # segment routable: the segments queried no longer move
            segs = registry.segments("dclicks_REALTIME")
            if sorted(r.state for r in segs.values()) != \
                    ["CONSUMING", "ONLINE"] or len(registry.external_view(
                        "dclicks_REALTIME")) != 2:
                return False
            r = broker.execute(REALTIME[0])
            return not r.get("exceptions") and \
                r["resultTable"]["rows"][0][0] == len(clicks)

        assert _wait(settled)
        out += [broker.execute(sql) for sql in REALTIME]
        # a server dies: its replicas answer
        servers[0].transport.stop(grace=0)
        out += [broker.execute(sql) for sql in AFTER_STOP]
    finally:
        broker.close()
        for s in servers:
            s.stop(drain_timeout_s=0)
    return out


def _same(a: dict, b: dict, sql: str) -> None:
    from test_pallas_scatter import _rows_close

    assert [e["errorCode"] for e in a.get("exceptions", ())] == \
        [e["errorCode"] for e in b.get("exceptions", ())], (sql, a, b)
    for k in STATS:
        assert a.get(k) == b.get(k), (sql, k, a.get(k), b.get(k))
    if "resultTable" not in a:
        assert "resultTable" not in b, sql
        return
    ta, tb = a["resultTable"], b["resultTable"]
    assert ta["dataSchema"] == tb["dataSchema"], sql
    if sql.startswith("EXPLAIN"):
        # the backend labels are a named divergence (queue 3)
        def label(c):
            return str(c).replace("DEVICE(torch/cuda, host-path shape)",
                                  "HOST(numpy)").replace(
                "DEVICE(torch/cuda)", "DEVICE(jax/xla)")
        assert [[label(c) for c in r] for r in ta["rows"]] \
            == [[str(c) for c in r] for r in tb["rows"]], sql
        return
    ints = [isinstance(v, (int, str)) for v in (ta["rows"] or [[]])[0]]
    for ra, rb in zip(ta["rows"], tb["rows"]):
        assert [x for x, i in zip(ra, ints) if i] == \
            [y for y, i in zip(rb, ints) if i], (sql, ra, rb)
    assert _rows_close(ta["rows"], tb["rows"]), (sql, ta["rows"], tb["rows"])


def test_cluster_session_matches_reference(tmp_path):
    data = _session_data()
    port = _session("pinot_tpu_torch", tmp_path / "port", data)
    ref = _session("pinot_tpu", tmp_path / "ref", data)
    sqls = SESSION + REALTIME + AFTER_STOP
    assert len(port) == len(ref) == len(sqls)
    for sql, a, b in zip(sqls, port, ref):
        _same(a, b, sql)
    # the answers are whole after the stop, from the replicas
    for r in port[-len(AFTER_STOP):]:
        assert not r["exceptions"] and not r.get("partialResult"), r
    assert port[0]["resultTable"]["rows"][0][0] == 12000
