"""The arithmetic functions alone at their edge values, bit for bit.

Each function goes through the port's two forms beside the reference's:

- the device template's torch form (pinot_tpu_torch/ops/transform.py,
  what engine/device.py ``_eval_expr`` calls) against the reference's
  ``jnp`` form (pinot_tpu/ops/transform.py) under ``JAX_PLATFORMS=cpu``,
  over int32, int64 and float32 operands;
- the host path's torch form (engine/values.py ``numeric_op``, ``_UNARY``,
  ``_ROUND``) against numpy, the reference host's form, over int32,
  int64, float32 and float64 operands.

The functions are MOD (integer and float divisors), CAST to INT, LONG,
FLOAT, DOUBLE and BOOLEAN, SIGN, ABS, CEIL, FLOOR, LEAST, GREATEST,
DIVIDE and POWER with a non-negative and a negative integer exponent. The
operands are zeros of both signs, NaN, +-inf, the ends of int32 and
int64, floats at and past those ends, and the largest floats inside them.
Results match in dtype and bit for bit, the sign of zero included; a NaN
matches any NaN.

POWER of integers with a negative exponent is refused (ROADMAP queue 3,
D1): the port's device form raises numpy's ``ValueError`` where the
reference's integer power gives no power. POWER has no torch form in the
host path's shape (numpy computes it per distinct tuple of values), so it
is held there by the sweeps only.

One difference is skipped, as queue 3 lists it under "not queued": XLA
on the CPU flushes a denormal result to zero and torch does not, so no
operand here is or makes a denormal float.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinot_tpu.ops.transform as rt
from pinot_tpu_torch.engine import values as pv
from pinot_tpu_torch.ops import transform as pt
from pinot_tpu_torch.query.context import Expression

I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)
F32_BELOW_2E31 = float(np.nextafter(np.float32(2 ** 31), np.float32(0)))
F32_BELOW_2E63 = float(np.nextafter(np.float32(2 ** 63), np.float32(0)))
F64_BELOW_2E63 = float(np.nextafter(2.0 ** 63, 0.0))

EDGES = {
    np.int32: [0, 1, -1, 2, -2, 7, -7, I32.min, I32.max, I32.min + 1],
    np.int64: [0, 1, -1, 2, -2, 7, -7, I64.min, I64.max, I64.min + 1,
               I32.min, I32.max, 2 ** 31, -2 ** 31 - 1],
    np.float32: [0.0, -0.0, 1.0, -1.0, 2.5, -2.5, 0.5, -0.5, np.nan, -np.nan,
                 np.inf, -np.inf, 2.0 ** 31, -2.0 ** 31, F32_BELOW_2E31,
                 -2.0 ** 31 - 256, 3e9, -3e9, 2.0 ** 63, -2.0 ** 63,
                 F32_BELOW_2E63, 1e19, -1e19, 1e30, -1e30, 7.0, -7.0],
}
EDGES[np.float64] = EDGES[np.float32] + [
    2.0 ** 31 - 1, 2.0 ** 31 - 0.5, -2.0 ** 31 - 0.5, -2.0 ** 31 - 1,
    F64_BELOW_2E63, 1e300, -1e300, 0.1]
DEVICE_DTYPES = (np.int32, np.int64, np.float32)
HOST_DTYPES = DEVICE_DTYPES + (np.float64,)
CASTS = ("INT", "LONG", "FLOAT", "DOUBLE", "BOOLEAN")
BINARY = ("mod", "least", "greatest", "divide")
UNARY = ("sign", "abs", "ceil", "floor")


def _pairs(dt, dt_b=None) -> tuple:
    """Every (a, b) of the edge values of ``dt`` and ``dt_b``."""
    a, b = zip(*itertools.product(EDGES[dt], EDGES[dt_b or dt]))
    return (np.array(a, dtype=dt), np.array(b, dtype=dt_b or dt))


def _same(got: np.ndarray, want: np.ndarray, what) -> None:
    """One dtype, every value's bits (a NaN matching any NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind == "f":
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan), (what, got, want)
        bits = {4: np.uint32, 8: np.uint64}[want.dtype.itemsize]
        bad = (got.view(bits) != want.view(bits)) & ~nan
    else:
        bad = got != want
    assert not bad.any(), (what, list(zip(*[x[bad][:8] for x in (got, want)])))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _device(name: str, *args):
    return pt.get_function(name).torch_fn(*[_t(a) for a in args]).numpy()


def _jnp(name: str, *args):
    with np.errstate(all="ignore"):
        return np.asarray(rt.get_function(name).jnp_fn(
            *[jnp.asarray(a) for a in args]))


# ---------------------------------------------------------------------------
# the device template's torch forms against jnp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DEVICE_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", BINARY)
def test_device_binary(name, dt):
    a, b = _pairs(dt)
    _same(_device(name, a, b), _jnp(name, a, b), (name, dt))


@pytest.mark.parametrize("name", BINARY)
def test_device_binary_int_by_float(name):
    """An int32 operand beside a float32 one (MOD's float divisor)."""
    a, b = _pairs(np.int32, np.float32)
    _same(_device(name, a, b), _jnp(name, a, b), name)
    _same(_device(name, b, a), _jnp(name, b, a), name)


@pytest.mark.parametrize("dt", DEVICE_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", UNARY)
def test_device_unary(name, dt):
    a = np.array(EDGES[dt], dtype=dt)
    _same(_device(name, a), _jnp(name, a), (name, dt))


@pytest.mark.parametrize("dt", DEVICE_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("to", CASTS)
def test_device_cast(to, dt):
    a = np.array(EDGES[dt], dtype=dt)
    got = pt.get_function("cast").torch_fn(_t(a), to).numpy()
    with np.errstate(all="ignore"):
        want = np.asarray(rt.get_function("cast").jnp_fn(jnp.asarray(a), to))
    _same(got, want, (to, dt))


EXPONENTS = [0, 1, 2, 3, 31, 63]


@pytest.mark.parametrize("dt", DEVICE_DTYPES, ids=lambda d: d.__name__)
def test_device_power_non_negative_exponent(dt):
    """Integer bases wrap as the reference's do; float bases with a small
    integer exponent are exact in both."""
    base = np.array(EDGES[dt], dtype=dt)
    exps = EXPONENTS if dt != np.float32 else [0, 1, 2]
    a, b = zip(*itertools.product(base, exps))
    a = np.array(a, dtype=dt)
    b = np.array(b, dtype=np.int32 if dt == np.int32 else np.int64)
    if dt == np.float32:
        b = b.astype(np.float32)
    _same(_device("power", a, b), _jnp("power", a, b), dt)


@pytest.mark.parametrize("dt", (np.int32, np.int64),
                         ids=lambda d: d.__name__)
@pytest.mark.parametrize("literal", [True, False], ids=["literal", "column"])
def test_device_power_negative_exponent_refused(dt, literal):
    """D1: integer operands with a negative exponent raise numpy's
    error, whether a literal's sign is known on the host (``negative``)
    or the exponent's values are read; a non-negative column does not."""
    base = _t(np.array(EDGES[dt], dtype=dt))
    exp = _t(np.full(len(EDGES[dt]), -1, dtype=dt))
    power = pt.get_function("power").torch_fn
    with pytest.raises(ValueError, match=pt.NEGATIVE_POWER):
        power(base, exp, negative=True if literal else None)
    exp[1:] = 2
    with pytest.raises(ValueError, match=pt.NEGATIVE_POWER):
        power(base, exp, negative=True if literal else None)
    exp[0] = 2
    assert power(base, exp).dtype == base.dtype
    # a float base takes any exponent
    out = power(base.to(torch.float32), exp * -1, negative=True)
    assert out.dtype == torch.float32


# ---------------------------------------------------------------------------
# the host path's torch forms against numpy
# ---------------------------------------------------------------------------

def _host_binary(name: str, a, b):
    with np.errstate(all="ignore"):
        want = np.asarray(pt.get_function(name).np_fn(a, b))
    got = pv.numeric_op(Expression.function(name), [_t(a), _t(b)],
                        want.dtype)
    return got.numpy(), want


@pytest.mark.parametrize("dt", HOST_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", BINARY)
def test_host_binary(name, dt):
    got, want = _host_binary(name, *_pairs(dt))
    _same(got, want, (name, dt))


@pytest.mark.parametrize("name", BINARY)
def test_host_binary_mixed(name):
    """int32 beside float32 and int64 beside float64, both orders."""
    for dts in ((np.int32, np.float32), (np.int64, np.float64),
                (np.float32, np.float64)):
        a, b = _pairs(*dts)
        _same(*_host_binary(name, a, b), (name, dts))
        _same(*_host_binary(name, b, a), (name, dts))


@pytest.mark.parametrize("dt", HOST_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", UNARY)
def test_host_unary(name, dt):
    a = np.array(EDGES[dt], dtype=dt)
    with np.errstate(all="ignore"):
        want = np.asarray(pt.get_function(name).np_fn(a))
    x = _t(a).to(pv._torch_dtype(want.dtype))
    if name in pv._UNARY:
        got = pv._UNARY[name](x)
    else:   # engine/values.py ``eval``: the identity on integers
        got = pv._ROUND[name](x) if want.dtype.kind == "f" else x
    _same(got.numpy(), want, (name, dt))


@pytest.mark.parametrize("dt", HOST_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("to", CASTS)
def test_host_cast(to, dt):
    a = np.array(EDGES[dt], dtype=dt)
    with np.errstate(all="ignore"):
        want = np.asarray(pt._np_cast(a, to))
    e = Expression.function("cast", Expression.identifier("x"),
                            Expression.literal(to))
    _same(pv.numeric_op(e, [_t(a)], want.dtype).numpy(), want, (to, dt))
