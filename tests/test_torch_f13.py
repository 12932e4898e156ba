"""F13's examples as first found, each held to the reference, and the
gather that repairs it.

F13: a dictionary STRING column compared with a string literal anywhere
but a filter predicate (``CASE WHEN d = 'a'``, a key ``d < 'b'``) raised
``IndexError: index 3 is out of bounds for dimension 0 with size 3`` at
both kernel gates in every tier. The batch plane of a dictionary column
pads each segment with the id C, one past the global dictionary, on
unsigned storage (-1 on int32 storage), and engine/values.py
``_string_compare`` indexed its lookup table of C booleans with those
ids unclamped. Every gather of a lookup table by ids in that module now
goes through ``take_ids``, which clamps them; the pad rows are masked by
the batch's valid docs later. On the card the same index is a
device-side assert, which the process's CUDA context does not survive.
"""

import numpy as np
import pytest
import torch

import test_torch_host_float64 as hf
import test_torch_sweep as sw
import test_torch_sweep_strings as ss
from pinot_tpu_torch.engine.values import take_ids
from test_torch_sweep_strings import (  # noqa: F401 — fixtures
    engines, one_thread, string_dirs)

# (sql, the reference's rows on the sealed tier as first found)
EXAMPLES = {
    "scalar_case_sum": ("SELECT SUM(CASE WHEN d = 'a' THEN i ELSE 0 END) "
                        "FROM t", [[-33049.0]]),
    "grouped_by_d": ("SELECT d, SUM(CASE WHEN d = 'a' THEN i ELSE 0 END) "
                     "FROM t GROUP BY d ORDER BY d",
                     [["a", -33049.0], ["b", 0.0], ["c", 0.0]]),
    "max_by_k": ("SELECT k, MAX(CASE WHEN d = 'b' THEN i ELSE -5000 END) "
                 "FROM t GROUP BY k ORDER BY k", None),
    "where_over_case": ("SELECT COUNT(*) FROM t WHERE CASE WHEN d = 'a' "
                        "THEN i ELSE 0 END > 10", [[801]]),
}
# the same shapes over the 300-value column on a u16 plane
WIDE = {name: sql.replace("d = 'a'", "w = 'w000'").replace(
    "d = 'b'", "w = 'w150'").replace("SELECT d,", "SELECT w,").replace(
    "BY d", "BY w") for name, (sql, _rows) in EXAMPLES.items()}


@pytest.mark.parametrize("example", list(EXAMPLES))
def test_example(engines, example):  # noqa: F811
    """At both gates in each tier, as the reference answers; on sealed
    segments, the rows as first found (MAX by k: 977.0 for k = 0 through
    999.0 for k = 9)."""
    sql, sealed_rows = EXAMPLES[example]
    exact = [True] if example in ("max_by_k", "where_over_case") \
        else [False]
    want = sw.check(engines, sql, exact)
    rows = want["resultTable"]["rows"]
    if engines[3] == "sealed":
        if sealed_rows is not None:
            assert rows == sealed_rows
        else:
            assert [r[0] for r in rows] == list(range(10))
            assert rows[0][1] == 977.0 and rows[9][1] == 999.0


@pytest.mark.parametrize("example", list(WIDE))
def test_example_over_a_u16_plane(engines, example):  # noqa: F811
    exact = [True] if example in ("max_by_k", "where_over_case") \
        else [False]
    sw.check(engines, WIDE[example], exact)


TABLES = {"bool": np.array([True, False, True]),
          "int64": np.array([7, -3, 11, 5], dtype=np.int64),
          "float64": np.array([0.5, -1.25], dtype=np.float64),
          "one": np.array([9], dtype=np.int32),
          "empty_bool": np.zeros(0, dtype=bool),
          "empty_float": np.zeros(0, dtype=np.float64)}
IDS = {"uint8": np.uint8, "uint16": np.uint16, "int32": np.int32,
       "int64": np.int64}


@pytest.mark.parametrize("id_dtype", list(IDS))
@pytest.mark.parametrize("table", list(TABLES))
def test_take_ids_is_a_clipped_take(table, id_dtype):
    """Ids C (the unsigned pad), -1 (the int32 pad), 0 and every id in
    between, in each dtype a plane stores ids in, against
    ``np.take(..., mode="clip")``; an empty table gives its dtype's
    zero without indexing."""
    t = TABLES[table]
    C = len(t)
    ids = np.array([C, 0] + list(range(C)) + [C, 0], dtype=np.int64)
    if np.dtype(IDS[id_dtype]).kind == "i":
        ids = np.concatenate([ids, [-1, -1]])
    ids = ids.astype(IDS[id_dtype]).reshape(1, -1)
    got = take_ids(torch.from_numpy(t), torch.from_numpy(ids)).numpy()
    assert got.dtype == t.dtype and got.shape == ids.shape
    want = np.take(t, ids.astype(np.int64), mode="clip") if C \
        else np.zeros(ids.shape, dtype=t.dtype)
    np.testing.assert_array_equal(got, want)


LAST = {"d": ("d", "c"), "w_u16": ("w", "w299")}


@pytest.mark.parametrize("column", list(LAST))
def test_no_pad_reaches_an_answer(engines, column):  # noqa: F811
    """A pad row reads the dictionary's last value once clamped: the
    count of rows holding that value is still the count the filter
    gives, at both gates and in each tier (as the reference's)."""
    col, last = LAST[column]
    case = f"SUM(CASE WHEN {col} = '{last}' THEN 1 ELSE 0 END)"
    ref, _host, ports, _tier = engines
    count = ref.execute(f"SELECT COUNT(*) FROM t WHERE {col} = '{last}'")
    n = count["resultTable"]["rows"][0][0]
    assert n > 0
    for sql in (f"SELECT {case} FROM t",
                f"SELECT {case} FROM t WHERE $docId < 100000"):
        want = ref.execute(sql)
        assert want["resultTable"]["rows"] == [[float(n)]]
        for port in ports:
            got = port.execute(sql)
            assert not got.get("exceptions"), got["exceptions"]
            assert got["resultTable"]["rows"] == [[float(n)]]


def test_the_sealed_planes_are_padded(string_dirs):  # noqa: F811
    """The sealed segments' ``d`` and ``w`` planes hold pad rows (ids 3
    and 300), so the cases above read the pads."""
    port = ss._load("port", hf._engine("port"), "sealed", string_dirs["port"])
    port.execute("SELECT COUNT(*) FROM t WHERE d = 'a'")
    ctx = next(iter(port.device._batches.values()))
    for col, pad in (("d", 3), ("w", 300)):
        blocks = ctx.host_column(col)[0]
        assert blocks.dtype.kind == "u" and (blocks == pad).any()
