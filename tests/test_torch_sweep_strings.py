"""A differential sweep of the port against the reference: a STRING
operand compared with a string literal outside a filter predicate, in
every position where the port evaluates such a comparison.

F13: a dictionary STRING column's batch plane pads each segment with the
id C (one past the global dictionary) on unsigned storage, and the
comparison's lookup table of C booleans was indexed with those ids
unclamped (engine/values.py ``_string_compare``), so ``CASE WHEN d = 'a'``
or a key ``d < 'b'`` raised ``IndexError`` at every gate in every tier.
The lookup tables are now gathered by one helper, ``values.take_ids``,
which clamps the ids; the pad rows are masked by the batch's valid docs
later, so none may reach an answer. The literal that matters most is the
dictionary's last value: a clamped pad row reads it.

The operands:

- ``d``: tests/test_torch_host_float64.py's dictionary STRING column of
  three values, on a u8 plane;
- ``w``: a dictionary STRING column of 300 values, on a u16 plane, added
  to this file's own copy of that schema and made from the seed;
- ``$segmentName``;
- ``UPPER(d)``, which the port computes per dictionary value (its
  ``_lut`` route) and carries as ids;
- ``CAST(k AS STRING)``, strings computed per distinct value and carried
  as ids. It stands for a raw STRING column: both creators store every
  STRING column with a dictionary (``_use_dictionary``), so no segment
  holds one.

The comparisons are ``=``, ``<>``, ``<``, ``<=``, ``>``, ``>=``, with the
literal on either side; each literal is the operand's first, middle or
last value or one absent from its values. ``$segmentName``'s values
differ by tier: ``t0`` and ``t1`` sealed and warm, ``t0`` and
``t__0__0__rt`` consuming, so ``t1`` is its last value in two tiers and
absent in the third.

The data is tests/test_torch_host_float64.py's seeded segments with
``w`` beside them, in its three tiers (sealed, consuming beside a sealed
segment, warm), and the oracle and its rule are
tests/test_torch_sweep.py's ``check``: the reference's ``QueryEngine()``,
its host-only engine where that fails, an in-band refusal where both
fail. The port runs on the CPU at the default kernel gate and at gate 0.
Integers and MIN / MAX match bit for bit with the same Python type, SUM
and AVG within ``rows_close``.

This file holds the aggregation positions; the keys, the filters over a
comparison, HAVING and the selection are in
tests/test_torch_sweep_strings_keys.py, so that the two halves run on two
workers.
"""

import numpy as np
import pytest
import torch

import test_torch_host_float64 as hf
import test_torch_sweep as sw
from pinot_tpu.engine.engine import QueryEngine as RefEngine

W_VALUES = np.array([f"w{j:03d}" for j in range(300)])
TIERS = ("sealed", "consuming", "warm")

# operand → (expression, {literal role: literal})
OPERANDS = {
    "d": ("d", {"first": "a", "middle": "b", "last": "c", "absent": "ab"}),
    "w_u16": ("w", {"first": "w000", "middle": "w150", "last": "w299",
                    "absent": "w150x"}),
    "segment": ("$segmentName", {"first": "t0", "middle": "t__0__0__rt",
                                 "last": "t1", "absent": "t05"}),
    "upper": ("UPPER(d)", {"first": "A", "middle": "B", "last": "C",
                           "absent": "AB"}),
    "cast": ("CAST(k AS STRING)", {"first": "0", "middle": "5",
                                   "last": "9", "absent": "55"}),
}
OPS = ("=", "<>", "<", "<=", ">", ">=")
# each comparison with the literal on the right and on the left
COMPARISONS = [f"{side}{op}" for side in ("r", "l") for op in OPS]
SHAPES = {"scalar": (None, ""), "by_k": ("k", ""),
          "docid": (None, "WHERE $docId < 1800"),
          "k_eq_3": (None, "WHERE k = 3")}


def comparison(operand: str, cmp: str, role: str) -> str:
    expr, lits = OPERANDS[operand]
    lit = f"'{lits[role]}'"
    op = cmp[1:]
    return f"{expr} {op} {lit}" if cmp[0] == "r" else f"{lit} {op} {expr}"


def _schema(side):
    sc, dt = hf.MODS[side][:2]
    D = dt.DataType
    return sc.Schema.build(
        name="t",
        dimensions=[("d", D.STRING), ("k", D.INT), ("rk", D.LONG),
                    ("ts", D.LONG), ("w", D.STRING)],
        multi_value_dimensions=[("tags", D.INT)],
        metrics=[("nv", D.LONG), ("f", D.DOUBLE), ("fd", D.DOUBLE),
                 ("big", D.LONG), ("lm", D.LONG), ("fl", D.FLOAT),
                 ("i", D.INT)])


def _data(n: int, seed: int) -> dict:
    cols = hf._data(n, seed)
    rng = np.random.default_rng(seed + 1000)
    cols["w"] = W_VALUES[rng.integers(0, len(W_VALUES), n)]
    return cols


def _load(side, eng, tier: str, dirs: list):
    _sc, _dt, _tc, _cr, mut, tiering, segment = hf.MODS[side]
    if tier == "warm":
        for d in dirs:
            eng.add_segment("t", tiering.LazySegmentView(d))
        return eng
    eng.add_segment("t", segment.ImmutableSegment(dirs[0]))
    if tier == "sealed":
        eng.add_segment("t", segment.ImmutableSegment(dirs[1]))
    else:
        ms = mut.MutableSegment(_schema(side), "t__0__0__rt")
        ms.index_batch(hf._records(_data(hf.N_CONSUMING, 77)))
        eng.add_segment("t", ms)
    return eng


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the sweep's tables are a few thousand rows,
    which torch's thread pool does no faster, and its idle threads spin
    on cores the other test workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def string_dirs(tmp_path_factory):
    """Two sealed segments a package, tests/test_torch_host_float64.py's
    rows with ``w`` beside them."""
    base = tmp_path_factory.mktemp("sweep_strings")
    out = {}
    for side in hf.MODS:
        _sc, _dt, tc, creator = hf.MODS[side][:4]
        out[side] = []
        for j in range(2):
            d = str(base / f"{side}{j}")
            creator.build_segment(
                _schema(side), _data(hf.N, 40 + j), d,
                tc.TableConfig(table_name="t", indexing=tc.IndexingConfig(
                    no_dictionary_columns=hf.RAW)), f"t{j}")
            out[side].append(d)
    return out


@pytest.fixture(scope="module", params=TIERS)
def engines(request, string_dirs):
    """(reference, reference host-only, [port at each gate], tier)."""
    t = request.param
    return (_load("ref", hf._engine("ref"), t, string_dirs["ref"]),
            _load("ref", RefEngine(device_executor=None), t,
                  string_dirs["ref"]),
            [_load("port", hf._engine("port", g), t, string_dirs["port"])
             for g in hf.GATES], t)


def select(aggs: list, shape: str) -> str:
    key, where = SHAPES[shape]
    body = ", ".join(aggs)
    if key is None:
        return f"SELECT {body} FROM t {where}".strip()
    return (f"SELECT {key}, {body} FROM t {where} GROUP BY {key} "
            f"ORDER BY {key} LIMIT 1000")


# each position of a comparison inside an aggregation, and whether its
# column must match bit for bit
POSITIONS = {
    "sum": ("SUM(CASE WHEN {c} THEN i ELSE 0 END)", False),
    "avg": ("AVG(CASE WHEN {c} THEN fl ELSE 0 END)", False),
    "min": ("MIN(CASE WHEN {c} THEN i ELSE 5000 END)", True),
    "max": ("MAX(CASE WHEN {c} THEN i ELSE -5000 END)", True),
    "count": ("COUNT(CASE WHEN {c} THEN 1 END)", True),
    "minmaxrange": ("MINMAXRANGE(CASE WHEN {c} THEN i ELSE 0 END)", True),
    "distinctcount": ("DISTINCTCOUNT(CASE WHEN {c} THEN k ELSE -1 END)",
                      True),
    "no_else": ("SUM(CASE WHEN {c} THEN i END)", False),
    "two_whens": ("SUM(CASE WHEN {c} THEN i WHEN k = 3 THEN 1 ELSE 0 END)",
                  False),
}


def test_if_is_a_function_of_neither_package(engines):
    """IF: both packages answer the same unknown function, at each gate
    and in each tier, so the sweep asks its CASE form instead."""
    sql = "SELECT SUM(IF(d = 'a', i, 0)) FROM t"
    ref, host, ports, _tier = engines
    want = sw._message(ref.execute(sql))
    assert "unknown function: if" in want
    assert sw._message(host.execute(sql)) == want
    for port in ports:
        assert sw._message(port.execute(sql)) == want


@pytest.mark.parametrize("role", ["first", "middle", "last", "absent"])
@pytest.mark.parametrize("position", list(POSITIONS))
@pytest.mark.parametrize("operand", list(OPERANDS))
def test_each_comparison_in_an_aggregation(engines, operand, position,
                                           role):
    """The twelve comparisons as twelve columns of one query, scalar."""
    agg, exact = POSITIONS[position]
    aggs = [agg.format(c=comparison(operand, cmp, role))
            for cmp in COMPARISONS]
    sw.check(engines, select(aggs, "scalar"), [exact] * len(aggs))
