"""Predicate masks over the padded (S, L) segment batch, as torch ops.

The filter result is a dense boolean mask; AND/OR/NOT are elementwise.
Dict-encoded columns arrive in global dictionary id space
(engine/params.py), so predicate literals resolve to batch-wide scalars
or vectors on the host and the device work is a bare comparison. Literal
ids use -2 for "absent" and padding docs carry -1 or the cardinality, so
padding never matches; callers still AND with ``valid_mask``.

Every comparison promotes both operands with ``torch.promote_types``: a
0-d literal tensor would otherwise be cast to the column's dtype under
torch's scalar rules (a uint8 plane compared with -2 would see 254).
"""

from __future__ import annotations

import torch


def _same(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def unpack_subbyte(packed, bits: int):
    """(..., Lp) uint8 sub-byte plane -> (..., Lp * 8 // bits) uint8 dict
    ids, by shifts and masks (FixedBitSVForwardIndexReader's bit
    extraction): id j lives in byte j // f at bit (j % f) * bits, f = 8 //
    bits, little-endian within the byte, as engine/params.py packs it."""
    f = 8 // bits
    shifts = torch.arange(f, dtype=torch.uint8, device=packed.device) * bits
    sub = (packed[..., None] >> shifts) & ((1 << bits) - 1)
    return sub.reshape(packed.shape[:-1] + (packed.shape[-1] * f,))


def valid_mask(n_docs, padded_len: int):
    """(S, L) mask of real (non-padding) docs; ``n_docs`` is (S,) int32."""
    iota = torch.arange(padded_len, dtype=torch.int32, device=n_docs.device)
    return iota[None, :] < n_docs[:, None]


def eq_dict(ids, target_id):
    """EQ: ``target_id`` int32 scalar global id (-2 if value absent)."""
    return torch.eq(*_same(ids, target_id))


def in_dict(ids, id_vector):
    """IN: ``id_vector`` int32 (K,) global ids, padded with -2. One
    comparison per literal keeps the transient at (S, L), not (S, L, K)."""
    ids, vec = _same(ids, id_vector)
    m = ids == vec[0]
    for k in range(1, vec.shape[0]):
        m = m | (ids == vec[k])
    return m


def range_dict(ids, lo, hi):
    """RANGE: global id interval [lo, hi) — a value range on the sorted
    global dictionary is contiguous in id space."""
    a, lo = _same(ids, lo)
    a, hi = _same(a, hi)
    return (a >= lo) & (a < hi)


def lut_dict(ids, lut):
    """Arbitrary predicate via a (C,) boolean LUT over global ids (the host
    evaluated it once per dictionary entry). Padding ids clamp into range;
    callers AND with valid_mask."""
    return lut[torch.clamp(ids.to(torch.int64), 0, lut.shape[0] - 1)]


def eq_raw(values, literal):
    return torch.eq(*_same(values, literal))


def in_raw(values, literals):
    """``literals``: (K,) device vector."""
    v, lit = _same(values, literals)
    m = v == lit[0]
    for k in range(1, lit.shape[0]):
        m = m | (v == lit[k])
    return m


def range_raw(values, lower, upper, lower_inclusive: bool,
              upper_inclusive: bool, has_lower: bool, has_upper: bool):
    """Static inclusivity/boundedness (part of the template); bounds are
    0-d tensors. Out-of-place, so a cohort's stacked bounds
    (engine/cohort.py, under ``torch.func.vmap``) broadcast the mask."""
    m = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    if has_lower:
        v, lo = _same(values, lower)
        m = m & ((v >= lo) if lower_inclusive else (v > lo))
    if has_upper:
        v, hi = _same(values, upper)
        m = m & ((v <= hi) if upper_inclusive else (v < hi))
    return m
