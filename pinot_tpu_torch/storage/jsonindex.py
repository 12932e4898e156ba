"""JSON index: flattened path/value posting lists for JSON_MATCH.

Equivalent of the reference's JSON index
(pinot-segment-local/.../readers/json/ImmutableJsonIndexReader.java and
creator JsonIndexCreator): every doc's JSON flattens into one or more
*flat rows* — one per combination of array elements — each holding
``path → scalar`` entries under both the exact path (``$.arr[0].k``) and
the wildcard form (``$.arr[*].k``). Predicates inside ``JSON_MATCH``
evaluate in flat-row space, so ``"$.a[*].k1" = 'x' AND "$.a[*].k2" = 'y'``
matches only when one array ELEMENT satisfies both — the reference's
same-flattened-doc semantics.

On disk (``<col>.jsonidx.npz``): sorted (path, value) keys with
concatenated flat-row posting lists, plus existence postings per path and
the flat-row → doc map. Query-time the inner expression string parses with
the normal SQL expression parser and evaluates over the postings; segments
without the index take a flatten-per-doc scan with identical semantics.
"""

from __future__ import annotations

import json
import re
from typing import Optional

import numpy as np

from pinot_tpu_torch.query.context import FilterNode, FilterNodeType, Predicate, PredicateType

_IDX_RE = re.compile(r"\[\d+\]")
MAX_FLAT_ROWS_PER_DOC = 1024  # cartesian-blowup guard


def _scalar_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _rec(node, path: str) -> list:
    if isinstance(node, dict):
        rows = [{}]
        for k, v in node.items():
            sub = _rec(v, f"{path}.{k}")
            if len(rows) * len(sub) > MAX_FLAT_ROWS_PER_DOC:
                sub = sub[: max(1, MAX_FLAT_ROWS_PER_DOC // max(1, len(rows)))]
            rows = [dict(a, **b) for a in rows for b in sub]
        return rows
    if isinstance(node, list):
        rows = []
        for i, v in enumerate(node):
            rows.extend(_rec(v, f"{path}[{i}]"))
            if len(rows) >= MAX_FLAT_ROWS_PER_DOC:
                break
        return rows or [{}]
    if node is None:
        return [{}]  # JSON null == absent path (reference semantics)
    return [{path: _scalar_str(node)}]


def flatten_doc(obj) -> list:
    """Flat rows for one parsed JSON value; always >= 1 row per doc."""
    rows = _rec(obj, "$")
    for r in rows:
        for k in list(r):
            w = _IDX_RE.sub("[*]", k)
            if w != k:
                r.setdefault(w, r[k])
    return rows


def _parse_doc(v) -> object:
    if isinstance(v, (dict, list)):
        return v
    try:
        return json.loads(v)
    except (TypeError, ValueError):
        return None  # malformed JSON indexes as empty (no paths)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def build_json_index(values, out_path: str) -> None:
    """values: iterable of JSON strings (or parsed objects), one per doc.
    A string column flattens each distinct string once (``_build_distinct``,
    the same file)."""
    if isinstance(values, np.ndarray) and values.dtype.kind == "U":
        _save_index(out_path, *_build_distinct(values))
        return
    postings: dict = {}  # (path, value_or_None) -> list[flat_row_id]
    row_doc: list = []
    for doc_id, v in enumerate(values):
        for flat in flatten_doc(_parse_doc(v)):
            rid = len(row_doc)
            row_doc.append(doc_id)
            seen_paths = set()
            for path, val in flat.items():
                postings.setdefault((path, val), []).append(rid)
                if path not in seen_paths:
                    seen_paths.add(path)
                    postings.setdefault((path, None), []).append(rid)
    keys = sorted(postings, key=_key_order)
    off = np.zeros(len(keys) + 1, dtype=np.int64)
    rows_concat = np.empty(sum(len(postings[k]) for k in keys), dtype=np.int64)
    pos = 0
    for i, k in enumerate(keys):
        rows = postings[k]
        rows_concat[pos: pos + len(rows)] = rows
        pos += len(rows)
        off[i + 1] = pos
    _save_index(out_path, keys, off, rows_concat,
                np.asarray(row_doc, dtype=np.int64))


def _key_order(k):
    return (k[0], k[1] is not None, k[1] or "")


def _build_distinct(values: np.ndarray) -> tuple:
    """``build_json_index``'s postings for a string column, each distinct
    string flattened once: a doc's flat rows are its string's, numbered
    in doc order, and every key's postings are the rows holding it,
    ascending, as the doc-by-doc loop appends them."""
    uniq, inv = np.unique(values, return_inverse=True)
    inv = inv.reshape(-1)
    key_id: dict = {}
    pair_keys, n_rows = [], np.zeros(len(uniq), dtype=np.int64)
    for u, v in enumerate(uniq.tolist()):
        flats = flatten_doc(_parse_doc(v))
        n_rows[u] = len(flats)
        for flat in flats:
            ks = []
            for path, val in flat.items():
                ks.append(key_id.setdefault((path, val), len(key_id)))
                ks.append(key_id.setdefault((path, None), len(key_id)))
            pair_keys.append(ks)
    keys = sorted(key_id, key=_key_order)
    rank = np.empty(len(keys), dtype=np.int64)
    rank[[key_id[k] for k in keys]] = np.arange(len(keys))
    # flat rows: each doc's string's rows, in doc order
    per_doc = n_rows[inv]
    row_doc = np.repeat(np.arange(len(inv), dtype=np.int64), per_doc)
    start = np.cumsum(per_doc) - per_doc
    pair_base = np.cumsum(n_rows) - n_rows
    rid = np.arange(len(row_doc), dtype=np.int64)
    pair = pair_base[inv[row_doc]] + (rid - start[row_doc])
    # each row once per key of its (string, flat row) pair
    lens = np.asarray([len(ks) for ks in pair_keys], dtype=np.int64)
    flat_keys = rank[np.asarray([k for ks in pair_keys for k in ks],
                                dtype=np.int64)]
    pk_start = np.cumsum(lens) - lens
    n_of_row = lens[pair]
    row_of = np.repeat(rid, n_of_row)
    j = np.arange(len(row_of), dtype=np.int64) \
        - np.repeat(np.cumsum(n_of_row) - n_of_row, n_of_row)
    key_of = flat_keys[pk_start[pair[row_of]] + j]
    order = np.lexsort((row_of, key_of))
    off = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(np.bincount(key_of, minlength=len(keys)), out=off[1:])
    return keys, off, row_of[order], row_doc


def _save_index(out_path: str, keys: list, off, rows_concat, row_doc):
    np.savez(
        out_path,
        paths=np.asarray([k[0] for k in keys], dtype=np.str_),
        vals=np.asarray(["" if k[1] is None else k[1] for k in keys], dtype=np.str_),
        kinds=np.asarray([0 if k[1] is None else 1 for k in keys], dtype=np.uint8),
        off=off,
        rows=rows_concat,
        row_doc=row_doc,
    )


# ---------------------------------------------------------------------------
# Read / match
# ---------------------------------------------------------------------------

class JsonIndexReader:
    def __init__(self, npz_path: str):
        z = np.load(npz_path, allow_pickle=False)
        self._paths = z["paths"]
        self._vals = z["vals"]
        self._kinds = z["kinds"]
        self._off = z["off"]
        self._rows = z["rows"]
        self.row_doc = z["row_doc"]
        self.n_rows = len(self.row_doc)
        self._by_key: dict = {}
        for i in range(len(self._paths)):
            key = (str(self._paths[i]),
                   str(self._vals[i]) if self._kinds[i] else None)
            self._by_key[key] = i

    def _posting(self, path: str, value: Optional[str]) -> np.ndarray:
        i = self._by_key.get((path, value))
        if i is None:
            return np.empty(0, dtype=np.int64)
        return np.asarray(self._rows[self._off[i]: self._off[i + 1]])

    def _value_keys(self, path: str):
        """(value_string, posting) pairs under one path (range scans)."""
        for (p, v), i in self._by_key.items():
            if p == path and v is not None:
                yield v, np.asarray(self._rows[self._off[i]: self._off[i + 1]])

    def match(self, f: FilterNode, n_docs: int) -> np.ndarray:
        """Doc mask for a parsed JSON_MATCH inner filter."""
        rows = _eval_filter(f, _IndexRowSpace(self))
        mask = np.zeros(n_docs, dtype=bool)
        if len(rows):
            mask[self.row_doc[rows]] = True
        return mask


class _IndexRowSpace:
    """Flat-row-space evaluation over the on-disk postings."""

    def __init__(self, reader: JsonIndexReader):
        self.r = reader

    def all_rows(self) -> np.ndarray:
        return np.arange(self.r.n_rows, dtype=np.int64)

    def exists(self, path: str) -> np.ndarray:
        return self.r._posting(path, None)

    def eq(self, path: str, value) -> np.ndarray:
        return self.r._posting(path, _literal_str(value))

    def value_entries(self, path: str):
        return self.r._value_keys(path)

    def rows_of_docs(self, docs: np.ndarray) -> np.ndarray:
        return np.nonzero(np.isin(self.r.row_doc, docs))[0]

    def docs_of_rows(self, rows: np.ndarray) -> np.ndarray:
        return np.unique(self.r.row_doc[rows])

    def all_docs(self) -> np.ndarray:
        return np.unique(self.r.row_doc)


class _ScanRowSpace:
    """Same evaluation over flat rows materialized from raw values at query
    time (segments without the index)."""

    def __init__(self, values):
        self.row_doc_list = []
        self.flat = []
        for doc_id, v in enumerate(values):
            for fr in flatten_doc(_parse_doc(v)):
                self.row_doc_list.append(doc_id)
                self.flat.append(fr)
        self.row_doc = np.asarray(self.row_doc_list, dtype=np.int64)

    def all_rows(self) -> np.ndarray:
        return np.arange(len(self.flat), dtype=np.int64)

    def exists(self, path: str) -> np.ndarray:
        return np.asarray(
            [i for i, fr in enumerate(self.flat) if path in fr], dtype=np.int64)

    def eq(self, path: str, value) -> np.ndarray:
        v = _literal_str(value)
        return np.asarray(
            [i for i, fr in enumerate(self.flat) if fr.get(path) == v],
            dtype=np.int64)

    def value_entries(self, path: str):
        by_val: dict = {}
        for i, fr in enumerate(self.flat):
            v = fr.get(path)
            if v is not None:
                by_val.setdefault(v, []).append(i)
        for v, rows in by_val.items():
            yield v, np.asarray(rows, dtype=np.int64)

    def rows_of_docs(self, docs: np.ndarray) -> np.ndarray:
        return np.nonzero(np.isin(self.row_doc, docs))[0]

    def docs_of_rows(self, rows: np.ndarray) -> np.ndarray:
        return np.unique(self.row_doc[rows])

    def all_docs(self) -> np.ndarray:
        return np.unique(self.row_doc)


def match_scan(values, f: FilterNode, n_docs: int) -> np.ndarray:
    space = _ScanRowSpace(values)
    rows = _eval_filter(f, space)
    mask = np.zeros(n_docs, dtype=bool)
    if len(rows):
        mask[space.row_doc[rows]] = True
    return mask


def _literal_str(v) -> str:
    """Query-literal canonicalization — must stay identical to the
    build-time ``_scalar_str`` or EQ lookups go empty."""
    return _scalar_str(v)


def _try_float(s: str) -> Optional[float]:
    try:
        return float(s)
    except ValueError:
        return None


def _eval_filter(f: FilterNode, space) -> np.ndarray:
    """Flat-row ids matching the filter. AND intersects in flat-row space
    (same-element semantics); NOT complements at DOC level, like the
    reference's exclusive flattened-doc handling."""
    t = f.type
    if t is FilterNodeType.AND:
        rows = _eval_filter(f.children[0], space)
        for c in f.children[1:]:
            rows = np.intersect1d(rows, _eval_filter(c, space),
                                  assume_unique=False)
        return rows
    if t is FilterNodeType.OR:
        rows = _eval_filter(f.children[0], space)
        for c in f.children[1:]:
            rows = np.union1d(rows, _eval_filter(c, space))
        return rows
    if t is FilterNodeType.NOT:
        matched_docs = space.docs_of_rows(_eval_filter(f.children[0], space))
        keep = np.setdiff1d(space.all_docs(), matched_docs)
        return space.rows_of_docs(keep)
    if t is FilterNodeType.CONSTANT_TRUE:
        return space.all_rows()
    if t is FilterNodeType.CONSTANT_FALSE:
        return np.empty(0, dtype=np.int64)
    return _eval_predicate(f.predicate, space)


def _eval_predicate(p: Predicate, space) -> np.ndarray:
    if not p.lhs.is_identifier:
        raise ValueError("JSON_MATCH predicates take a \"$.path\" lhs")
    path = p.lhs.name
    t = p.type
    if t is PredicateType.EQ:
        return space.eq(path, p.value)
    if t is PredicateType.IN:
        rows = np.empty(0, dtype=np.int64)
        for v in p.values:
            rows = np.union1d(rows, space.eq(path, v))
        return rows
    if t is PredicateType.NOT_EQ:
        # path exists with a different value (flat-row level, ref semantics)
        return np.setdiff1d(space.exists(path), space.eq(path, p.value))
    if t is PredicateType.NOT_IN:
        rows = space.exists(path)
        for v in p.values:
            rows = np.setdiff1d(rows, space.eq(path, v))
        return rows
    if t is PredicateType.IS_NOT_NULL:
        return space.exists(path)
    if t is PredicateType.IS_NULL:
        have = space.docs_of_rows(space.exists(path))
        return space.rows_of_docs(np.setdiff1d(space.all_docs(), have))
    if t is PredicateType.RANGE:
        # numeric bounds compare numerically over numeric-looking values;
        # string bounds compare lexicographically (the stored form), the
        # reference's string-range behavior
        lo = None if p.lower is None else _try_float(_literal_str(p.lower))
        hi = None if p.upper is None else _try_float(_literal_str(p.upper))
        numeric = (p.lower is None or lo is not None) and \
            (p.upper is None or hi is not None)
        out = []
        for v, rows in space.value_entries(path):
            if numeric:
                cv = _try_float(v)
                if cv is None:
                    continue
                clo, chi = lo, hi
            else:
                cv = v
                clo = None if p.lower is None else _literal_str(p.lower)
                chi = None if p.upper is None else _literal_str(p.upper)
            if clo is not None and (cv < clo or (cv == clo and not p.lower_inclusive)):
                continue
            if chi is not None and (cv > chi or (cv == chi and not p.upper_inclusive)):
                continue
            out.append(rows)
        if not out:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(out))
    raise ValueError(f"unsupported predicate {t} inside JSON_MATCH")


def parse_match_expression(expr: str) -> FilterNode:
    """'"$.a" = ''x'' AND ...' -> FilterNode, via the SQL expression parser."""
    from pinot_tpu_torch.sql.compiler import _to_filter
    from pinot_tpu_torch.sql.parser import Parser

    return _to_filter(Parser(expr).parse_expr())
