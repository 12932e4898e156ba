"""Text index: tokenized posting lists with positions for TEXT_MATCH.

Equivalent of the reference's Lucene-backed text index
(pinot-segment-local/.../readers/text/LuceneTextIndexReader.java, creator
LuceneTextIndexCreator): documents tokenize to lowercase alphanumeric
terms; TEXT_MATCH(col, '<query>') supports the Lucene query subset the
reference's docs exercise — bare terms, AND/OR (AND binds tighter),
"quoted phrases" (consecutive positions), and trailing-wildcard prefix
terms (``plan*``). Bare terms separated by whitespace OR together, the
Lucene default operator.

On disk (``<col>.textidx.npz``): sorted term array with concatenated
(doc, position) postings. Segments without the index tokenize the column
at query time and evaluate the same semantics (scan path).
"""

from __future__ import annotations

import re

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize_text(s: str) -> list:
    return _TOKEN_RE.findall(str(s).lower())


def _build_postings(values):
    """(terms, off, docs, poss) — shared by the on-disk build and the
    ephemeral scan index so both paths stay byte-identical in layout. A
    string column tokenizes each distinct string once
    (``_postings_distinct``, the same arrays)."""
    if isinstance(values, np.ndarray) and values.dtype.kind == "U" \
            and len(values):
        return _postings_distinct(values)
    postings: dict = {}  # term -> (docs list, positions list)
    for doc_id, s in enumerate(values):
        for pos, tok in enumerate(tokenize_text(s)):
            d, p = postings.setdefault(tok, ([], []))
            d.append(doc_id)
            p.append(pos)
    terms = sorted(postings)
    off = np.zeros(len(terms) + 1, dtype=np.int64)
    total = sum(len(postings[t][0]) for t in terms)
    docs = np.empty(total, dtype=np.int64)
    poss = np.empty(total, dtype=np.int64)
    at = 0
    for i, t in enumerate(terms):
        d, p = postings[t]
        docs[at: at + len(d)] = d
        poss[at: at + len(d)] = p
        at += len(d)
        off[i + 1] = at
    return np.asarray(terms, dtype=np.str_), off, docs, poss


def _postings_distinct(values: np.ndarray) -> tuple:
    """``_build_postings`` over each distinct string's tokens, expanded to
    the docs holding it: every term's (doc, position) pairs in doc, then
    position order, as the doc-by-doc loop appends them."""
    uniq, inv = np.unique(values, return_inverse=True)
    inv = inv.reshape(-1)
    toks = [tokenize_text(u) for u in uniq.tolist()]
    terms = sorted({t for ts in toks for t in ts})
    tid = {t: i for i, t in enumerate(terms)}
    lens = np.asarray([len(ts) for ts in toks], dtype=np.int64)
    flat = np.asarray([tid[t] for ts in toks for t in ts], dtype=np.int64)
    start = np.cumsum(lens) - lens
    per_doc = lens[inv]
    docs = np.repeat(np.arange(len(inv), dtype=np.int64), per_doc)
    poss = np.arange(len(docs), dtype=np.int64) \
        - np.repeat(np.cumsum(per_doc) - per_doc, per_doc)
    term = flat[start[inv[docs]] + poss]
    order = np.argsort(term, kind="stable")
    off = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum(np.bincount(term, minlength=len(terms)), out=off[1:])
    return np.asarray(terms, dtype=np.str_), off, docs[order], poss[order]


def build_text_index(values, out_path: str) -> None:
    terms, off, docs, poss = _build_postings(values)
    np.savez(out_path, terms=terms, off=off, docs=docs, poss=poss)


class TextIndexReader:
    def __init__(self, npz_path: str):
        z = np.load(npz_path, allow_pickle=False)
        self._terms = z["terms"]
        self._off = z["off"]
        self._docs = z["docs"]
        self._poss = z["poss"]

    def _term_slice(self, term: str):
        i = int(np.searchsorted(self._terms, term))
        if i >= len(self._terms) or str(self._terms[i]) != term:
            return None
        return self._off[i], self._off[i + 1]

    def posting(self, term: str):
        s = self._term_slice(term)
        if s is None:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        lo, hi = s
        return np.asarray(self._docs[lo:hi]), np.asarray(self._poss[lo:hi])

    def prefix_posting(self, prefix: str):
        lo_i = int(np.searchsorted(self._terms, prefix))
        hi_i = int(np.searchsorted(self._terms, prefix + "￿"))
        if lo_i == hi_i:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        lo, hi = self._off[lo_i], self._off[hi_i]
        return np.asarray(self._docs[lo:hi]), np.asarray(self._poss[lo:hi])

    def match(self, query: str, n_docs: int) -> np.ndarray:
        docs = _eval_query(parse_text_query(query), self)
        mask = np.zeros(n_docs, dtype=bool)
        valid = docs[docs < n_docs]
        mask[valid] = True
        return mask


class ScanTextIndex(TextIndexReader):
    """Ephemeral in-memory index over raw values (no-index scan path)."""

    def __init__(self, values):
        self._terms, self._off, self._docs, self._poss = _build_postings(values)


# ---------------------------------------------------------------------------
# Query parsing: OR( AND( unit... )... ); unit = term | prefix* | "phrase"
# ---------------------------------------------------------------------------

_QUERY_TOKEN_RE = re.compile(r'"([^"]*)"|\(|\)|[^\s()"]+')


def parse_text_query(query: str):
    """-> nested ('or', [...]) / ('and', [...]) / ('term'|'prefix'|'phrase', s)."""
    tokens = []
    for m in _QUERY_TOKEN_RE.finditer(query):
        if m.group(1) is not None:
            tokens.append(("phrase", m.group(1)))
        else:
            tokens.append(("raw", m.group(0)))
    pos = [0]

    def parse_or():
        parts = [parse_and()]
        while pos[0] < len(tokens):
            kind, text = tokens[pos[0]]
            # operators are case-sensitive, like Lucene's QueryParser:
            # lowercase 'or'/'and' are ordinary search terms
            if kind == "raw" and text == "OR":
                pos[0] += 1
                parts.append(parse_and())
            elif kind == "raw" and text == ")":
                break
            else:
                # bare juxtaposition: Lucene default operator is OR
                parts.append(parse_and())
        return ("or", parts) if len(parts) > 1 else parts[0]

    def parse_and():
        parts = [parse_unit()]
        while pos[0] < len(tokens):
            kind, text = tokens[pos[0]]
            if kind == "raw" and text == "AND":
                pos[0] += 1
                parts.append(parse_unit())
            else:
                break
        return ("and", parts) if len(parts) > 1 else parts[0]

    def parse_unit():
        if pos[0] >= len(tokens):
            raise ValueError(f"bad TEXT_MATCH query: {query!r}")
        kind, text = tokens[pos[0]]
        pos[0] += 1
        if kind == "phrase":
            return ("phrase", text)
        if text == "(":
            node = parse_or()
            if pos[0] < len(tokens) and tokens[pos[0]] == ("raw", ")"):
                pos[0] += 1
            return node
        if text.endswith("*") and len(text) > 1:
            return ("prefix", text[:-1].lower())
        return ("term", text.lower())

    node = parse_or()
    if pos[0] != len(tokens):
        raise ValueError(f"bad TEXT_MATCH query: {query!r}")
    return node


def _eval_query(node, idx: TextIndexReader) -> np.ndarray:
    kind = node[0]
    if kind == "or":
        docs = _eval_query(node[1][0], idx)
        for child in node[1][1:]:
            docs = np.union1d(docs, _eval_query(child, idx))
        return docs
    if kind == "and":
        docs = _eval_query(node[1][0], idx)
        for child in node[1][1:]:
            docs = np.intersect1d(docs, _eval_query(child, idx))
        return docs
    if kind == "term":
        return np.unique(idx.posting(node[1])[0])
    if kind == "prefix":
        return np.unique(idx.prefix_posting(node[1])[0])
    if kind == "phrase":
        return _phrase_docs(node[1], idx)
    raise ValueError(f"bad text query node {node!r}")


def _phrase_docs(phrase: str, idx: TextIndexReader) -> np.ndarray:
    terms = tokenize_text(phrase)
    if not terms:
        return np.empty(0, dtype=np.int64)
    if len(terms) == 1:
        return np.unique(idx.posting(terms[0])[0])
    # offset each term's positions back to the phrase start; a doc matches
    # when some start position appears for every term: (doc, start) pairs
    # as one int64 key each, intersected across the terms at once
    postings = [idx.posting(t) for t in terms]
    top = max((int(p.max()) for _d, p in postings if len(p)), default=0)
    stride = top + len(terms) + 1
    starts = None
    for i, (d, p) in enumerate(postings):
        key = np.asarray(d, dtype=np.int64) * stride \
            + (np.asarray(p, dtype=np.int64) - i)
        starts = np.unique(key) if starts is None \
            else np.intersect1d(starts, key)
        if len(starts) == 0:
            break
    return np.unique(starts // stride).astype(np.int64)
