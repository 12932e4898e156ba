"""Theta sketch: mergeable approximate distinct counting (KMV variant).

Equivalent of the reference's theta-sketch distinct count
(DistinctCountThetaSketchAggregationFunction.java over Apache
DataSketches' QuickSelect theta sketch): keep the k smallest 63-bit
hashes; theta is the (k+1)-th smallest, every retained hash is < theta,
and the estimate is |retained| / (theta / 2^63). Merging is
min(theta) + union + re-trim — order-insensitive, fixed-size state that
rides the DataTable wire as a plain int list per group.

Hashing reuses the canonical murmur-finalizer pipeline (ops/hll.py
hash32_np) twice with decorrelated seeds to form 63-bit hashes, so host
and (future) device builders agree bit-for-bit.
"""

from __future__ import annotations

import re

import numpy as np

from pinot_tpu_torch.ops.hll import hash32_np

DEFAULT_NOMINAL = 16384  # reference default nominalEntries
MAX_HASH = np.int64(1) << np.int64(62)  # theta space: hashes in [0, 2^62)


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h.copy()
    h ^= h >> 16
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> 13
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> 16
    return h


def hash63(values: np.ndarray) -> np.ndarray:
    """Deterministic 62-bit hashes as int64 (top bits clear so the values
    survive the int64 wire format and float math without sign trouble)."""
    h1 = hash32_np(values).astype(np.uint64)
    h2 = _fmix32((h1 ^ np.uint64(0x9E3779B9)).astype(np.uint32)).astype(np.uint64)
    h = ((h1 << np.uint64(31)) ^ h2) & np.uint64((1 << 62) - 1)
    return h.astype(np.int64)


def build(values: np.ndarray, k: int) -> tuple:
    """values -> (theta:int, sorted retained hashes:int64 array)."""
    h = np.unique(hash63(values))
    return trim(int(MAX_HASH), h, k)


def trim(theta: int, hashes: np.ndarray, k: int) -> tuple:
    """Enforce the k-entry bound: theta becomes the (k+1)-th smallest and
    only hashes strictly below it are retained."""
    hashes = hashes[hashes < theta]
    if len(hashes) > k:
        hashes = np.sort(hashes)
        theta = int(hashes[k])
        hashes = hashes[:k]
        hashes = hashes[hashes < theta]  # duplicates of theta fall out
    return theta, hashes


def merge(theta_a: int, ha: np.ndarray, theta_b: int, hb: np.ndarray,
          k: int) -> tuple:
    theta = min(theta_a, theta_b)
    union = np.union1d(np.asarray(ha, dtype=np.int64),
                       np.asarray(hb, dtype=np.int64))
    return trim(theta, union, k)


def estimate(theta: int, hashes) -> float:
    n = len(hashes)
    if theta >= int(MAX_HASH):
        return float(n)  # exact mode: never trimmed
    return n / (theta / float(MAX_HASH))


# ---------------------------------------------------------------------------
# set algebra (the reference's Intersection / AnotB / Union post-aggregation
# over theta sketches: DistinctCountThetaSketchAggregationFunction's
# filtered-sketch + set-expression form)
# ---------------------------------------------------------------------------


def intersect(theta_a: int, ha: np.ndarray, theta_b: int, hb: np.ndarray) -> tuple:
    """Sketch intersection (DataSketches Intersection semantics): both
    sides are uniform samples below their thetas, so the common hashes
    below min(theta) are a uniform sample of the value intersection."""
    theta = min(int(theta_a), int(theta_b))
    common = np.intersect1d(np.asarray(ha, dtype=np.int64),
                            np.asarray(hb, dtype=np.int64))
    return theta, common[common < theta]


def a_not_b(theta_a: int, ha: np.ndarray, theta_b: int, hb: np.ndarray) -> tuple:
    """Sketch difference (DataSketches AnotB semantics)."""
    theta = min(int(theta_a), int(theta_b))
    ha = np.asarray(ha, dtype=np.int64)
    keep = ha[ha < theta]
    return theta, np.setdiff1d(keep, np.asarray(hb, dtype=np.int64))


_SET_TOKEN = re.compile(
    r"\s*(SET_INTERSECT|SET_UNION|SET_DIFF|\$\d+|[(),])", re.IGNORECASE)


def parse_set_expression(s: str):
    """'SET_INTERSECT($1, $2)' → nested AST of ('ref', i) leaves and
    ('SET_INTERSECT'|'SET_UNION'|'SET_DIFF', child...) nodes. $1 is the
    FIRST filtered sketch (reference numbering)."""
    toks, pos = [], 0
    while pos < len(s):
        if s[pos:].strip() == "":
            break
        m = _SET_TOKEN.match(s, pos)
        if m is None:
            raise ValueError(f"bad theta set expression at {pos}: {s!r}")
        toks.append(m.group(1))
        pos = m.end()

    def parse(i):
        if i >= len(toks):
            raise ValueError(f"truncated theta set expression: {s!r}")
        t = toks[i]
        if t.startswith("$"):
            ref = int(t[1:])
            if ref < 1:
                raise ValueError(f"sketch refs are 1-based: {t}")
            return ("ref", ref - 1), i + 1
        op = t.upper()
        if op not in ("SET_INTERSECT", "SET_UNION", "SET_DIFF"):
            raise ValueError(f"unknown theta set operator {t!r}")
        if i + 1 >= len(toks) or toks[i + 1] != "(":
            raise ValueError(f"{op} needs parenthesized args: {s!r}")
        args, i = [], i + 2
        while True:
            node, i = parse(i)
            args.append(node)
            if i >= len(toks):
                raise ValueError(f"unclosed {op} in {s!r}")
            if toks[i] == ",":
                i += 1
                continue
            if toks[i] == ")":
                i += 1
                break
            raise ValueError(f"bad token {toks[i]!r} in {s!r}")
        if len(args) < 2:
            raise ValueError(f"{op} needs at least two args: {s!r}")
        if op == "SET_DIFF" and len(args) != 2:
            raise ValueError(f"SET_DIFF is binary: {s!r}")
        return (op,) + tuple(args), i

    node, i = parse(0)
    if i != len(toks):
        raise ValueError(f"trailing tokens in theta set expression: {s!r}")
    return node


def max_ref(node) -> int:
    """Highest 0-based sketch index referenced by a parsed set AST."""
    if node[0] == "ref":
        return node[1]
    return max(max_ref(c) for c in node[1:])


def evaluate_set(node, sketches: list, k: int) -> tuple:
    """Parsed AST + [(theta, hashes)] per filter → (theta, hashes)."""
    op = node[0]
    if op == "ref":
        return sketches[node[1]]
    parts = [evaluate_set(c, sketches, k) for c in node[1:]]
    th, h = parts[0]
    for th2, h2 in parts[1:]:
        if op == "SET_UNION":
            th, h = merge(th, h, th2, h2, k)
        elif op == "SET_INTERSECT":
            th, h = intersect(th, h, th2, h2)
        else:
            th, h = a_not_b(th, h, th2, h2)
    return th, h
