"""K5's two regimes (csrc/cluster_sums.cu) against its plain version, on
the CPU, where the kernel cannot run:

- the exact regime's argument: for integral clusters whose sum of |v| is
  at most 2^53, an int64 sum in any order, converted to float64 with the
  -0.0 rule, equals ``cluster_sums_plain`` (the sequential chain) bit for
  bit (a hypothesis property);
- ``cluster_regimes_plain``, the kernel's choice of regime, at
  chip_smoke.py's adversarial inputs: the regime counts each case
  names;
- the kernel's program emulated in numpy (tiles of ``kTile`` values,
  each cluster's runs in them, the finalize with its lane chains, the
  block chain's aligned body in ring chunks), held against the plain
  version and its choice of regime;
- the constants the wrapper shares with the source.
"""

import math
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from pinot_tpu_torch.ops import kernels

SRC = os.path.join(kernels.CSRC_DIR, kernels.SOURCES["cluster_sums"])


def _const(name: str) -> float:
    text = open(SRC).read()
    m = re.search(rf"constexpr \w+ {name} = ([0-9.]+)", text)
    return float(m.group(1))


TILE = int(_const("kTile"))
WIDE = int(_const("kWide"))
STAGE = int(_const("kStageVals"))


def bits(t) -> bytes:
    return np.asarray(t, dtype=np.float64).tobytes()


def test_constants_match_the_source():
    assert kernels.K5_SHORT == _const("kShort")
    assert kernels.K5_MAX_ABS == _const("kMaxAbs") == 2.0 ** 53
    assert kernels.K5_MAX_SUM_ABS == _const("kMaxSumAbs") == 2.0 ** 52
    assert TILE % WIDE == 0 and STAGE % 2 == 0


# ---------------------------------------------------------------------------
# the exact regime's argument
# ---------------------------------------------------------------------------

VALUE = st.one_of(st.integers(-(2 ** 53), 2 ** 53), st.just("-0"),
                  st.integers(-3, 3))


def _bounded(cluster: list) -> list:
    """The cluster's integers cut so that their sum of |v| is at most
    2^53 (each divided by the same k, toward zero); "-0" is -0.0."""
    ints = [0 if x == "-0" else x for x in cluster]
    k = max(1, -(-sum(abs(x) for x in ints) // 2 ** 53))
    return [-0.0 if x == "-0" else float(int(x / k) if k > 1 else x)
            for x in cluster]


@settings(max_examples=400, deadline=None, derandomize=True)
@given(st.lists(st.lists(VALUE, min_size=1, max_size=60), min_size=1,
                max_size=8), st.randoms(use_true_random=False))
def test_int64_sum_in_any_order_is_the_chain(clusters, rnd):
    clusters = [_bounded(c) for c in clusters]
    vals = np.asarray([x for c in clusters for x in c], dtype=np.float64)
    off = np.concatenate([[0], np.cumsum([len(c) for c in clusters])])
    want = kernels.cluster_sums_plain(torch.from_numpy(vals),
                                      torch.from_numpy(off))
    got = []
    for c in clusters:
        order = list(range(len(c)))
        rnd.shuffle(order)
        total = np.int64(0)
        for i in order:
            total = total + np.int64(c[i])   # |partial| <= 2^53: no overflow
        neg_zero = all(x == 0 and math.copysign(1, x) < 0 for x in c)
        got.append(-0.0 if neg_zero else float(total))
    assert bits(got) == bits(want)
    regimes = kernels.cluster_regimes_plain(torch.from_numpy(vals),
                                            torch.from_numpy(off)).tolist()
    for c, r in zip(clusters, regimes):
        assert (r == 0) == (sum(abs(x) for x in c) <= 2.0 ** 52)


# ---------------------------------------------------------------------------
# the kernel's choice of regime at chip_smoke.py's adversarial inputs
# ---------------------------------------------------------------------------

CASES = chip_smoke.k5_adversarial()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_regimes_at_adversarial_inputs(case):
    _label, vals, off, _start, expect = case
    got = kernels.cluster_regimes_plain(torch.from_numpy(vals),
                                        torch.from_numpy(off))
    assert tuple(np.bincount(got.numpy(), minlength=3)) == expect


def test_regime_counters_start_at_zero_on_the_cpu():
    kernels.reset_cluster_regimes()
    v = torch.tensor([1.0, 2.5], dtype=torch.float64)
    kernels.cluster_sums(v, torch.tensor([0, 1, 2]))
    assert kernels.cluster_regimes() == dict.fromkeys(kernels.K5_REGIMES, 0)


# ---------------------------------------------------------------------------
# the kernel's program, emulated
# ---------------------------------------------------------------------------


def _take(x: np.ndarray) -> tuple:
    """A run's partials as the exact pass forms them: (uint64 sum of the
    exact values, float64 sum of |v|, flags)."""
    ok = (np.abs(x) <= 2.0 ** 53) & (x == np.trunc(x))
    isum = np.where(ok, x, 0).astype(np.int64).astype(np.uint64).sum(
        dtype=np.uint64)
    flags = (0 if ok.all() else 1) | (
        0 if ((x == 0) & np.signbit(x)).all() else 2)
    with np.errstate(invalid="ignore"):
        return isum, float(np.abs(x).sum()), flags


def _chain(vals: np.ndarray, order: list) -> float:
    acc = vals[order[0]]
    with np.errstate(invalid="ignore", over="ignore"):
        for i in order[1:]:
            acc = acc + vals[i]
    return float(acc)


def emulate(vals: np.ndarray, off: np.ndarray, head: int = 0) -> tuple:
    """csrc/cluster_sums.cu in numpy, the values laid ``head`` doubles past
    a 16-byte boundary: (out, regime per cluster)."""
    n, C = vals.size, off.size - 1
    tiles = -(-n // TILE)
    tile_first = np.searchsorted(off[:-1], np.arange(tiles) * TILE,
                                 side="right") - 1
    isum = np.zeros(C, dtype=np.uint64)
    asum = np.zeros(C)
    flags = np.zeros(C, dtype=np.int64)
    seen = np.zeros(n, dtype=np.int64)
    for k in range(tiles):
        t0, t1 = k * TILE, min(k * TILE + TILE, n)
        for c in range(max(tile_first[k], 0), C):
            if off[c] >= t1:
                break
            lo, hi = max(off[c], t0), min(off[c + 1], t1)
            if hi <= lo:
                continue
            seen[lo:hi] += 1
            i, a, f = _take(vals[lo:hi])
            with np.errstate(over="ignore"):   # uint64 wraps, as on the card
                isum[c] += i
            asum[c] += a
            flags[c] |= f
    covered = np.zeros(n, dtype=np.int64)
    for c in range(C):
        covered[off[c]:off[c + 1]] += 1
    assert (seen == covered).all()
    out = np.empty(C)
    regime = np.empty(C, dtype=np.int64)
    for c in range(C):
        s, e = int(off[c]), int(off[c + 1])
        if e <= s:
            out[c], regime[c] = 0.0, 0
        elif not flags[c] & 1 and asum[c] <= 2.0 ** 52:
            out[c] = float(isum[c].astype(np.int64)) if flags[c] & 2 \
                else -0.0
            regime[c] = 0
        elif e - s <= kernels.K5_SHORT:
            out[c], regime[c] = _chain(vals, list(range(s, e))), 1
        else:
            a = s + 1 + ((head + s + 1) % 2)   # the body's 16-byte start
            b = a + ((e - a) & ~1)
            order = [s, *range(s + 1, a)]
            for q in range(a, b, STAGE):
                cnt = min(STAGE, b - q)
                assert cnt % 2 == 0
                order += range(q, q + cnt)
            order += range(b, e)
            assert order == list(range(s, e))
            out[c], regime[c] = _chain(vals, order), 2
    return out, regime


def _same(got, want) -> bool:
    g, w = np.asarray(got), np.asarray(want)
    return bool(((g.view(np.int64) == w.view(np.int64))
                 | (np.isnan(g) & np.isnan(w))).all())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_kernel_at_adversarial_inputs(case):
    _label, vals, off, start, expect = case
    out, regime = emulate(vals, off, start)
    want = kernels.cluster_sums_plain(torch.from_numpy(vals),
                                      torch.from_numpy(off))
    assert _same(out, want.numpy())
    assert tuple(np.bincount(regime, minlength=3)) == expect
    assert (regime == kernels.cluster_regimes_plain(
        torch.from_numpy(vals), torch.from_numpy(off)).numpy()).all()


@pytest.mark.parametrize("seed", range(8))
def test_emulated_kernel_at_random_clusters(seed):
    """Clusters of 1 to 3 tiles' length, and runs of tiny ones, over
    integers, fractions, signed zeros and infinities, laid at either
    alignment."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([rng.integers(1, 3 * TILE, 6),
                            rng.integers(1, 4, 40), [1, 2, 257, 256]])
    rng.shuffle(sizes)
    n = int(sizes.sum())
    kind = seed % 4
    vals = [rng.integers(-10 ** 6, 10 ** 6, n).astype(np.float64),
            rng.normal(0, 100, n),
            rng.choice([-0.0, 0.0, -0.0, 7.0, -7.0], n),
            np.where(rng.random(n) < 1e-4, np.inf,
                     rng.integers(-50, 50, n).astype(np.float64))][kind]
    if kind == 0:   # one fraction somewhere
        vals[rng.integers(0, n)] += 0.25
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    out, regime = emulate(vals, off, seed % 2)
    want = kernels.cluster_sums_plain(torch.from_numpy(vals),
                                      torch.from_numpy(off))
    assert _same(out, want.numpy())
    assert (regime == kernels.cluster_regimes_plain(
        torch.from_numpy(vals), torch.from_numpy(off)).numpy()).all()


def test_plain_version_on_cpu_tensors():
    vals = np.concatenate([np.arange(1.0, 301.0), [-0.0, -0.0], [0.5, 1.0]])
    off = np.array([0, 300, 302, 304])
    got = kernels.cluster_sums(torch.from_numpy(vals), torch.from_numpy(off))
    assert bits(got) == bits([45150.0, -0.0, 1.5])
