"""The port's sorted group-by primitives (pinot_tpu_torch/ops/radix_groupby.py)
against the JAX package's (pinot_tpu/ops/radix_groupby.py).

tests/test_radix_groupby.py's shapes, each case run through both
functions on the same seeded inputs: key packing and its sentinels, the
chunk plans, ``chunked_group_aggregate`` for every reduction family at
chunk sizes that force level-2 and deeper merges (and over int64 keys),
the overflow contract, exact int64 sums under a wrapping cumulative sum,
``merge_tables``' key alignment and neutral fills, the segmented scans,
and ``bucket_histogram`` against ``np.bincount`` and the reference's
interpret-mode kernel. Integers compare exactly, float sums within
1e-12 relative. Float MIN / MAX: a NaN wins in both; the port orders
-0.0 below +0.0 (its K2 and ops/agg.py convention), where the
reference's ``jnp.minimum`` leaves the sign of a tie to XLA, so zeros
compare by value and the port's sign is checked on its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pinot_tpu.ops import radix_groupby as ref_radix
from pinot_tpu_torch.ops import radix_groupby as radix

SEN32 = radix.INT32_SENTINEL
SEN64 = radix.INT64_SENTINEL


def _table(tbl, names):
    """{key: (count, columns...)} over a table's non-empty slots."""
    sk = np.asarray(tbl["skeys"])
    empty = np.asarray(tbl["empty"])
    cnt = np.asarray(tbl["gcount"])
    cols = [np.asarray(tbl[nm]) for nm in names]
    return {int(sk[j]): (int(cnt[j]),) + tuple(c[j].item() for c in cols)
            for j in range(len(sk)) if not empty[j]}


def _both(keys, payloads, sums, mins, maxs, K, chunk_rows):
    """The port's and the reference's tables over the same numpy inputs."""
    got = radix.chunked_group_aggregate(
        torch.from_numpy(keys),
        {n: (torch.from_numpy(v), kind) for n, (v, kind) in payloads.items()},
        sums, mins, maxs, K, chunk_rows=chunk_rows)
    kinds = {n: kind for n, (_v, kind) in payloads.items()}
    want = jax.jit(lambda k, p: ref_radix.chunked_group_aggregate(
        k, {n: (p[n], kinds[n]) for n in p}, sums, mins, maxs, K,
        chunk_rows=chunk_rows))(
        jnp.asarray(keys), {n: jnp.asarray(v)
                            for n, (v, _k) in payloads.items()})
    return got, want


def _same(a, b, rel=1e-12):
    if isinstance(a, float) or isinstance(b, float):
        if np.isnan(a) or np.isnan(b):
            return bool(np.isnan(a) and np.isnan(b))
        return a == pytest.approx(b, rel=rel, abs=1e-12)
    return a == b


class TestPackKeys:
    @pytest.mark.parametrize("cards", [(4, 3), (1 << 16, 1 << 16),
                                       (3000, 1500), (46341, 46341)])
    def test_dtype_values_and_sentinels(self, cards):
        rng = np.random.default_rng(1)
        g = [rng.integers(0, c, 50).astype(np.int32) for c in cards]
        mask = rng.random(50) < 0.7
        got = radix.pack_keys([torch.from_numpy(x) for x in g], cards,
                              torch.from_numpy(mask))
        want = ref_radix.pack_keys([jnp.asarray(x) for x in g], cards,
                                   jnp.asarray(mask))
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert got.tolist() == np.asarray(want).tolist()

    def test_clips_padding_ids(self):
        g = [torch.tensor([-1, 5, 2], dtype=torch.int32)]
        key = radix.pack_keys(g, (4,), torch.tensor([True, True, False]))
        assert key.tolist() == [0, 3, SEN32]


@pytest.mark.parametrize("n,k,rows", [
    (10_000, 1000, None), (64 << 20, 1000, 1 << 20), (4 << 20, 16 << 20,
                                                      1 << 20),
    (100_007_936, 100_000, None), (9_600_096, 100_000, None),
    (1_190_000, 100_000, None), (2000, 50, 64), (2000, 50, 256),
    (3000, 100, 256)])
def test_plan_chunks_match_reference(n, k, rows):
    assert radix.plan_chunks(n, k, rows) == ref_radix.plan_chunks(n, k, rows)


class TestChunkedGroupAggregate:
    # None: one chunk; 256: several chunks, one merge level; 64: merges
    # over several levels at n = 2000
    @pytest.mark.parametrize("chunk_rows", [None, 256, 64])
    def test_all_families_match_reference(self, chunk_rows):
        rng = np.random.default_rng(7)
        n, nkeys, K = 2000, 40, 50
        keys = rng.integers(0, nkeys, n).astype(np.int32)
        mask = rng.random(n) < 0.9
        keys = np.where(mask, keys, SEN32).astype(np.int32)
        payloads = {"pi": (rng.integers(-500, 500, n).astype(np.int64),
                           "int"),
                    "pf": (rng.uniform(-10, 10, n), "float")}
        names = ["sum::pi", "sum::pf", "min::pi", "max::pi", "min::pf",
                 "max::pf"]
        got, want = _both(keys, payloads, {"pi", "pf"}, {"pi", "pf"},
                          {"pi", "pf"}, K, chunk_rows)
        assert int(got["n_groups_total"]) == int(want["n_groups_total"]) \
            == len(np.unique(keys[mask]))
        tg, tw = _table(got, names), _table(want, names)
        assert set(tg) == set(tw)
        for k in tw:
            assert all(_same(a, b) for a, b in zip(tg[k], tw[k])), \
                (k, tg[k], tw[k])
        # and the numpy oracle
        iv, fv = payloads["pi"][0], payloads["pf"][0]
        for k in tw:
            sel = keys == k
            assert tg[k][:2] == (int(sel.sum()), int(iv[sel].sum()))
            assert tg[k][2] == pytest.approx(fv[sel].sum(), rel=1e-12)
            assert tg[k][3:] == (int(iv[sel].min()), int(iv[sel].max()),
                                 float(fv[sel].min()), float(fv[sel].max()))

    def test_table_shape_and_neutral_fills(self):
        keys = np.array([5, 3, 5, SEN32], dtype=np.int32)
        got = radix.chunked_group_aggregate(
            torch.from_numpy(keys),
            {"p": (torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64),
                   "float"),
             "q": (torch.tensor([7, 8, 9, 10]), "int")},
            {"p"}, {"p", "q"}, {"p", "q"}, 6)
        assert got["skeys"].tolist() == [3, 5] + [SEN64] * 4
        assert got["empty"].tolist() == [False] * 2 + [True] * 4
        assert got["gcount"].tolist() == [1, 2, 0, 0, 0, 0]
        assert got["sum::p"].tolist() == [2.0, 4.0, 0, 0, 0, 0]
        assert got["min::p"][2:].tolist() == [np.inf] * 4
        assert got["max::p"][2:].tolist() == [-np.inf] * 4
        info = torch.iinfo(torch.int64)
        assert got["min::q"].tolist() == [8, 7] + [info.max] * 4
        assert got["max::q"].tolist() == [8, 9] + [info.min] * 4

    @pytest.mark.parametrize("chunk_rows", [None, 256, 64])
    def test_int64_key_basis(self, chunk_rows):
        """Key spaces past 2^31 pack int64; the chunked plans agree."""
        rng = np.random.default_rng(12)
        n = 3000
        g = [rng.integers(0, 1 << 16, n).astype(np.int32) for _ in range(2)]
        g[0] = (g[0] % 30).astype(np.int32)
        mask = rng.random(n) < 0.8
        key = radix.pack_keys([torch.from_numpy(x) for x in g],
                              (1 << 16, 1 << 16), torch.from_numpy(mask))
        assert key.dtype == torch.int64
        v = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
        got, want = _both(key.numpy(), {"v": (v, "int")}, {"v"}, {"v"},
                          set(), 4000, chunk_rows)
        names = ["sum::v", "min::v"]
        assert _table(got, names) == _table(want, names)
        assert int(got["n_groups_total"]) == int(want["n_groups_total"])

    @pytest.mark.parametrize("chunk_rows", [None, 256])
    def test_overflow_detected_never_truncated_silently(self, chunk_rows):
        rng = np.random.default_rng(8)
        n, K = 3000, 100
        keys = rng.permutation(n).astype(np.int32)
        got, want = _both(keys, {}, set(), set(), set(), K, chunk_rows)
        assert int(got["n_groups_total"]) > K
        assert int(want["n_groups_total"]) > K
        # the table keeps the K smallest keys it saw, all real
        assert not bool(got["empty"].any())

    def test_exact_int_sums_under_wrapping_cumsum(self):
        big = (1 << 62) - 7
        keys = np.array([0, 1, 0, 1], dtype=np.int32)
        vals = np.array([big, -big, big, -big], dtype=np.int64)
        got, want = _both(keys, {"p": (vals, "int")}, {"p"}, set(), set(),
                          8, None)
        assert _table(got, ["sum::p"]) == _table(want, ["sum::p"]) \
            == {0: (2, big * 2), 1: (2, -big * 2)}

    def test_signed_zeros_and_nan(self):
        """A group holding both zeros: MIN -0.0 and MAX +0.0 (the port's
        order keys), equal in value to the reference's; a group holding
        a NaN: NaN for MIN, MAX and SUM in both."""
        keys = np.array([0, 0, 1, 1, 1, 2, 2, SEN32], dtype=np.int32)
        f = np.array([0.0, -0.0, 1.5, np.nan, -2.0, -0.0, -0.0, np.nan])
        for chunk_rows in (None, 2):
            got, want = _both(keys, {"f": (f, "float")}, {"f"}, {"f"},
                              {"f"}, 4, chunk_rows)
            names = ["sum::f", "min::f", "max::f"]
            tg, tw = _table(got, names), _table(want, names)
            assert set(tg) == set(tw) == {0, 1, 2}
            for k in tw:
                assert all(_same(a, b) for a, b in zip(tg[k], tw[k])), k
            assert np.signbit(tg[0][2]) and not np.signbit(tg[0][3])
            assert np.signbit(tg[2][2]) and np.signbit(tg[2][3])
            assert all(np.isnan(x) for x in tg[1][1:])


@pytest.mark.parametrize("how", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_segmented_scans_match_reference(how, dtype):
    rng = np.random.default_rng(4)
    shape = (3, 257)
    v = rng.integers(-50, 50, shape).astype(dtype)
    if dtype == "float64":
        v = v * 0.37
        v[0, 10] = np.nan
        v[1, 3:6] = [-0.0, 0.0, -0.0]
    starts = rng.random(shape) < 0.1
    starts[:, 0] = True
    got = getattr(radix, f"seg_{how}")(torch.from_numpy(v),
                                       torch.from_numpy(starts))
    want = np.asarray(jax.jit(lambda a, b: getattr(
        ref_radix, f"seg_{how}")(a, b, axis=1))(jnp.asarray(v),
                                                jnp.asarray(starts)))
    if dtype == "int64":
        assert got.numpy().tolist() == want.tolist()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("case", ["unflagged_first", "wrap", "int32",
                                  "empty"])
def test_int_seg_sum_matches_reference(case):
    """The integer branch over rows whose first entry carries no start
    flag, int64 sums that wrap, a narrower input dtype and no entries."""
    rng = np.random.default_rng(5)
    shape = (0, 0) if case == "empty" else (4, 129)
    v = rng.integers(-50, 50, shape).astype(
        "int32" if case == "int32" else "int64")
    if case == "wrap":
        v[:, ::3] = np.int64(2**62) + v[:, ::3]
    starts = rng.random(shape) < 0.1
    if case != "unflagged_first":
        starts[:, :1] = True
    got = radix.seg_sum(torch.from_numpy(v), torch.from_numpy(starts))
    want = np.asarray(jax.jit(lambda a, b: ref_radix.seg_sum(a, b, axis=1))(
        jnp.asarray(v.astype("int64")), jnp.asarray(starts)))
    assert got.dtype == torch.int64 and got.shape == shape
    assert got.numpy().tolist() == want.tolist()


def test_boundaries_match_reference():
    sk = np.sort(np.random.default_rng(2).integers(0, 9, (2, 40)), axis=1)
    got = radix._boundaries(torch.from_numpy(sk))
    want = ref_radix._boundaries(jnp.asarray(sk))
    for g, w in zip(got, want):
        assert g.numpy().tolist() == np.asarray(w).tolist()


class TestMergeTables:
    def _both(self, sk, cols, reds, k):
        got = radix.merge_tables(
            torch.from_numpy(sk), {n: torch.from_numpy(v)
                                   for n, v in cols.items()}, reds, k)
        want = jax.jit(lambda a, c: ref_radix.merge_tables(a, c, reds, k))(
            jnp.asarray(sk), {n: jnp.asarray(v) for n, v in cols.items()})
        return got, want

    def test_cross_shard_key_aligned_merge(self):
        sk = np.array([[2, 5, 9, SEN64], [5, 9, 30, SEN64]], dtype=np.int64)
        cnt = np.array([[2, 1, 3, 0], [4, 1, 1, 0]], dtype=np.int64)
        mn = np.array([[1, 7, 2, 2**62], [3, 1, 8, 2**62]], dtype=np.int64)
        (cols, fk, empty, dist), want = self._both(
            sk, {"gcount": cnt, "m": mn}, {"gcount": "sum", "m": "min"}, 8)
        assert int(dist) == int(want[3]) == 4
        got = {int(k): (int(c), int(m)) for k, c, m, e in zip(
            fk, cols["gcount"], cols["m"], empty) if not bool(e)}
        assert got == {2: (2, 1), 5: (5, 3), 9: (4, 1), 30: (1, 8)}
        assert fk.tolist() == np.asarray(want[1]).tolist()

    def test_empty_slots_carry_neutral_fills(self):
        sk = np.array([[7, SEN64], [7, SEN64]], dtype=np.int64)
        cnt = np.array([[3, 0], [2, 0]], dtype=np.int64)
        f = np.array([[1.5, np.inf], [0.5, np.inf]])
        (cols, fk, empty, dist), want = self._both(
            sk, {"gcount": cnt, "f": f}, {"gcount": "sum", "f": "min"}, 4)
        assert int(dist) == int(want[3]) == 1
        assert cols["gcount"].tolist() == [5, 0, 0, 0]
        assert cols["f"].tolist() == [0.5] + [np.inf] * 3
        assert empty.tolist() == np.asarray(want[2]).tolist()
        assert np.asarray(want[0]["gcount"])[np.asarray(want[2])].max(
            initial=0) == 0

    @pytest.mark.parametrize("D", [2, 4])
    def test_shard_tables_merge_to_the_whole(self, D):
        """Tables built per shard and merged by key equal the table of
        all rows, and the reference's merge of the same tables."""
        rng = np.random.default_rng(20 + D)
        n, K = 4000, 600
        keys = rng.integers(0, 500, n).astype(np.int32)
        iv = rng.integers(-99, 99, n).astype(np.int64)
        fv = rng.uniform(-1, 1, n)
        parts = np.array_split(np.arange(n), D)
        tabs = [radix.chunked_group_aggregate(
            torch.from_numpy(keys[p]),
            {"i": (torch.from_numpy(iv[p]), "int"),
             "f": (torch.from_numpy(fv[p]), "float")},
            {"i", "f"}, {"i"}, {"f"}, K) for p in parts]
        names = ["gcount", "sum::i", "sum::f", "min::i", "max::f"]
        reds = {"gcount": "sum", "sum::i": "sum", "sum::f": "sum",
                "min::i": "min", "max::f": "max"}
        sk = np.stack([t["skeys"].numpy() for t in tabs])
        cols = {nm: np.stack([t[nm].numpy() for t in tabs]) for nm in names}
        (mc, fk, empty, dist), want = self._both(sk, cols, reds, K)
        whole = radix.chunked_group_aggregate(
            torch.from_numpy(keys), {"i": (torch.from_numpy(iv), "int"),
                                     "f": (torch.from_numpy(fv), "float")},
            {"i", "f"}, {"i"}, {"f"}, K)
        assert int(dist) == int(want[3]) == int(whole["n_groups_total"])
        assert fk[:K].tolist() == whole["skeys"].tolist()
        for nm in names:
            np.testing.assert_allclose(mc[nm].numpy(),
                                       whole[nm].numpy(), rtol=1e-12)
            w = np.asarray(want[0][nm])
            np.testing.assert_allclose(mc[nm].numpy(), w, rtol=1e-12)


@pytest.mark.parametrize("dtype,keyspace,n_buckets", [
    ("int32", 5000, 16), ("int32", 4_704_000, 256),
    ("int64", 1 << 40, 64)])
def test_bucket_histogram_matches_bincount_and_reference(dtype, keyspace,
                                                         n_buckets):
    rng = np.random.default_rng(10)
    n = 4096
    keys = rng.integers(0, keyspace, n).astype(dtype)
    mask = rng.random(n) < 0.8
    sen = SEN32 if dtype == "int32" else SEN64
    kj = np.where(mask, keys, sen).astype(dtype)
    got = radix.bucket_histogram(torch.from_numpy(kj), keyspace, n_buckets)
    shift = radix.bucket_shift(keyspace, n_buckets)
    want = np.bincount(keys[mask] >> shift, minlength=n_buckets)
    assert got.tolist() == want.tolist()
    ref = ref_radix.bucket_histogram(jnp.asarray(kj), keyspace, n_buckets,
                                     interpret=True)
    assert got.tolist() == np.asarray(ref).tolist()
