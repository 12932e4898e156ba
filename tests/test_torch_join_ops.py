"""The port's ops/join.py and ops/window.py against the reference's
jitted functions (pinot_tpu/ops/join.py, pinot_tpu/ops/window.py) on
random inputs from a seed: sort / probe / expand over duplicate and
unique builds, an empty side, no matches, int64 keys beside the pad
sentinels; every window function with ties, over several partition and
order layouts. Integer results are compared exactly, float running scans
within ``_rows_close``'s tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pinot_tpu.ops import join as r_join
from pinot_tpu.ops import window as r_window
from pinot_tpu_torch.ops import join as t_join
from pinot_tpu_torch.ops import window as t_window


def ref_pairs(probe: np.ndarray, build: np.ndarray) -> tuple:
    """The reference's solo match pipeline (query2/runner.py
    ``_match_pairs_device``), over numpy keys."""
    sk, perm = r_join.sort_build(jnp.asarray(build))
    lo, counts = r_join.probe_ranges(sk, jnp.asarray(probe))
    total = int(np.asarray(counts).sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    pr, bp, valid = r_join.expand_pairs(
        lo.astype(jnp.int64), counts.astype(jnp.int64),
        r_join.next_pow2(total))
    pr, bp, valid = np.asarray(pr), np.asarray(bp), np.asarray(valid)
    return pr[valid], np.asarray(perm)[bp[valid]]


def port_pairs(probe: np.ndarray, build: np.ndarray) -> tuple:
    sk, perm = t_join.sort_build(torch.from_numpy(build))
    lo, counts = t_join.probe_ranges(sk, torch.from_numpy(probe))
    pr, bp, valid = t_join.expand_pairs(lo, counts)
    assert bool(valid.all())
    return pr.numpy(), perm[bp].numpy()


def _keys(rng, n, hi, base=0):
    return (base + rng.integers(0, hi, n)).astype(np.int64)


CASES = {
    "dup_build": lambda r: (_keys(r, 500, 40), _keys(r, 300, 40)),
    "unique_build": lambda r: (_keys(r, 700, 90),
                               r.permutation(60).astype(np.int64)),
    "no_matches": lambda r: (_keys(r, 200, 50), _keys(r, 80, 50, 1000)),
    "empty_probe": lambda r: (np.zeros(0, np.int64), _keys(r, 50, 10)),
    "empty_build": lambda r: (_keys(r, 50, 10), np.zeros(0, np.int64)),
    "one_hot_key": lambda r: (np.full(64, 7, np.int64),
                              np.full(33, 7, np.int64)),
    "near_sentinels": lambda r: (
        np.concatenate([_keys(r, 300, 6, t_join.BUILD_PAD - 6),
                        np.asarray([0, t_join.BUILD_PAD - 1])]),
        np.concatenate([_keys(r, 200, 6, t_join.BUILD_PAD - 6),
                        np.asarray([t_join.BUILD_PAD - 1, 0, 0])])),
    "wide_int64": lambda r: (
        r.integers(-(1 << 62), 1 << 62, 400).astype(np.int64)[
            r.integers(0, 400, 400)],
        r.integers(-(1 << 62), 1 << 62, 400).astype(np.int64)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_match_pairs_equal_reference(case, seed):
    probe, build = CASES[case](np.random.default_rng(seed))
    if case == "wide_int64":
        probe = np.concatenate([probe, build[::3]])
    want = ref_pairs(probe, build)
    got = port_pairs(probe, build)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_unique_equals_reference(seed):
    rng = np.random.default_rng(seed)
    build = rng.permutation(500)[:200].astype(np.int64)
    probe = rng.integers(-5, 520, 1000).astype(np.int64)
    sk, perm = r_join.sort_build(jnp.asarray(build))
    f_want, row_want = r_join.probe_unique(sk, perm, jnp.asarray(probe))
    tsk, tperm = t_join.sort_build(torch.from_numpy(build))
    f_got, row_got = t_join.probe_unique(tsk, tperm, torch.from_numpy(probe))
    np.testing.assert_array_equal(f_got.numpy(), np.asarray(f_want))
    np.testing.assert_array_equal(row_got.numpy(), np.asarray(row_want))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(sk))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))


def test_probe_unique_empty_build():
    found, row = t_join.probe_unique(torch.zeros(0, dtype=torch.int64),
                                     torch.zeros(0, dtype=torch.int64),
                                     torch.arange(5))
    assert not found.any() and bool((row == -1).all())


def test_expand_pairs_static_bound_pads_invalid():
    lo = torch.tensor([0, 4, 2], dtype=torch.int64)
    counts = torch.tensor([2, 0, 3], dtype=torch.int64)
    pr, bp, valid = t_join.expand_pairs(lo, counts, t_join.next_pow2(5))
    rp, rb, rv = r_join.expand_pairs(jnp.asarray(lo.numpy()),
                                     jnp.asarray(counts.numpy()), 8)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rv))
    with pytest.raises(ValueError):
        t_join.expand_pairs(lo, counts, 4)


ALL_SPECS = (("row_number", -1), ("rank", -1), ("dense_rank", -1),
             ("count", -1), ("sum", 0), ("avg", 0), ("min", 1), ("max", 1),
             ("sum", 1), ("count", 0))


def ref_window(part, order, values, specs):
    n = len(part)
    pp, oo, rr, vv = r_window.pad_inputs(
        part, order, np.arange(n, dtype=np.int64), tuple(values))
    outs = r_window.window_eval(
        jnp.asarray(pp), jnp.asarray(oo), jnp.asarray(rr),
        tuple(jnp.asarray(v) for v in vv), tuple(specs))
    return [np.asarray(o)[:n] for o in outs]


LAYOUTS = {
    "ties": lambda r, n: (r.integers(0, 5, n), r.integers(0, 4, n)),
    "one_partition": lambda r, n: (np.zeros(n, np.int64),
                                   r.integers(0, 50, n)),
    "no_order": lambda r, n: (r.integers(0, 30, n), np.zeros(n, np.int64)),
    "singletons": lambda r, n: (np.arange(n)[::-1].copy(),
                                r.integers(0, 3, n)),
    "wide_codes": lambda r, n: (r.integers(0, 1 << 40, n) % (1 << 33),
                                r.integers(0, 1 << 40, n) % (1 << 31)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_window_eval_equals_reference(layout, n):
    rng = np.random.default_rng(n)
    part, order = (np.asarray(x, dtype=np.int64)
                   for x in LAYOUTS[layout](rng, n))
    values = [np.round(rng.uniform(-100, 100, n), 2),
              rng.integers(-50, 50, n).astype(np.float64)]
    values[0][rng.integers(0, n, max(n // 10, 1))] = 0.0
    want = ref_window(part, order, values, ALL_SPECS)
    got = t_window.window_eval(torch.from_numpy(part),
                               torch.from_numpy(order),
                               tuple(torch.from_numpy(v) for v in values),
                               ALL_SPECS)
    for (fn, vi), g, w in zip(ALL_SPECS, got, want):
        g = g.numpy()
        assert g.dtype == w.dtype, fn
        if fn in t_window.RANK_FUNCTIONS or vi == 1:
            # ranks, counts and running sums of integers: exact
            np.testing.assert_array_equal(g, w, err_msg=fn)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=fn)


def test_window_eval_empty():
    z = torch.zeros(0, dtype=torch.int64)
    outs = t_window.window_eval(z, z, (z.to(torch.float64),),
                                (("rank", -1), ("sum", 0)))
    assert [o.numel() for o in outs] == [0, 0]
    assert outs[0].dtype == torch.int64 and outs[1].dtype == torch.float64


def test_sort_order_is_partition_order_rowid():
    rng = np.random.default_rng(3)
    part = rng.integers(0, 4, 500).astype(np.int64)
    order = rng.integers(0, 3, 500).astype(np.int64)
    want = np.lexsort((np.arange(500), order, part))
    for o in (order, order + (1 << 61)):   # packed, then two stable sorts
        got = t_window.sort_order(torch.from_numpy(part),
                                  torch.from_numpy(o)).numpy()
        np.testing.assert_array_equal(got, want)
