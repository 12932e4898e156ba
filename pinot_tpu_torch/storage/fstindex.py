"""Regex-acceleration index for LIKE / REGEXP_LIKE on dictionary columns.

The reference's FST index (pinot-segment-local/.../readers/
LuceneFSTIndexReader.java:1 + utils/nativefst/) maps regex patterns to
matching dictionary ids so REGEXP_LIKE avoids evaluating the pattern
against every dictionary entry. A Lucene FST is a pointer-chasing
automaton — the wrong shape for this build. The same CAPABILITY here is a
**trigram posting index** over dictionary values (the pg_trgm design):

- build: every value's 3-grams → sorted posting lists of dict ids;
- query: extract the literal substrings a pattern REQUIRES (conservative
  regex analysis — alternation/optional groups contribute nothing),
  intersect their trigrams' posting lists, and regex-verify only the
  surviving candidates.

O(C) regex evaluations become O(|candidates|); correctness never depends
on the analysis because survivors are always re-verified with the real
pattern, and a pattern with no usable literals simply scans all entries
(the pre-index behavior).
"""

from __future__ import annotations

import os
import re

import numpy as np

IDS_FILE = "{col}.fst.ids.npy"
OFFS_FILE = "{col}.fst.off.npy"
GRAMS_FILE = "{col}.fst.grams.npy"

_QUANTS = "*?{"


def _skip_quant(pattern: str, i: int):
    """i points at a quantifier char; return the index PAST it (handles the
    {m,n} body), or None on unbalanced braces."""
    if pattern[i] == "{":
        j = pattern.find("}", i)
        return None if j < 0 else j + 1
    return i + 1


def required_literals(pattern: str) -> list:
    """Literal substrings every match of ``pattern`` must contain.
    Conservative: returns [] whenever the analysis is unsure (top-level
    alternation, unbalanced syntax, ...) — the caller then scans."""
    literals: list[str] = []
    cur: list[str] = []
    # group bookkeeping: (index into `literals` at group start, tainted)
    stack: list = []
    tainted_depth = 0  # >0: inside a group that contains an alternation

    def flush():
        if cur and tainted_depth == 0:
            literals.append("".join(cur))
        cur.clear()

    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\":
            if i + 1 >= n:
                return []
            nxt = pattern[i + 1]
            if nxt.isalnum():  # \d \w \b ... character classes/anchors
                flush()
            else:  # escaped metachar is a literal char
                cur.append(nxt)
            i += 2
            # an escaped char followed by a quantifier is optional/repeated
            if i < n and pattern[i] in _QUANTS:
                if cur:
                    cur.pop()
                flush()
                nxt_i = _skip_quant(pattern, i)
                if nxt_i is None:
                    return []
                i = nxt_i
            continue
        if c == "|":
            if not stack:
                return []  # top-level alternation: nothing is required
            # group content is alternated: drop its literals, taint it
            start, _ = stack[-1]
            del literals[start:]
            stack[-1] = (start, True)
            tainted_depth = sum(1 for _, t in stack if t)
            cur.clear()
            i += 1
            continue
        if c == "(":
            flush()
            if i + 1 < n and pattern[i + 1] == "?":
                # (?: / (?= / (?! / (?P<...>: bail conservatively — the
                # verify pass keeps correctness, this only costs narrowing
                return []
            stack.append((len(literals), False))
            i += 1
            continue
        if c == ")":
            flush()
            if not stack:
                return []
            start, was_tainted = stack.pop()
            tainted_depth = sum(1 for _, t in stack if t)
            # a quantified group is optional/repeated: its literals are
            # not required ('{m,n}' bodies must be skipped whole — '(x){2}'
            # once leaked '2}' into a literal and false-negatived queries)
            if i + 1 < n and pattern[i + 1] in _QUANTS:
                del literals[start:]
                nxt_i = _skip_quant(pattern, i + 1)
                if nxt_i is None:
                    return []
                i = nxt_i
                continue
            i += 1
            continue
        if c == "[":
            flush()
            j = i + 1
            if j < n and pattern[j] == "^":
                j += 1
            if j < n and pattern[j] == "]":
                j += 1
            while j < n and pattern[j] != "]":
                j += 2 if pattern[j] == "\\" else 1
            if j >= n:
                return []
            i = j + 1
            if i < n and pattern[i] in _QUANTS:
                i = _skip_quant(pattern, i)  # class optional/repeated
                if i is None:
                    return []
            continue
        if c in ".^$":
            flush()
            i += 1
            continue
        if c == "+":
            # previous unit required at least once, but adjacency to what
            # FOLLOWS breaks (ab+c matches 'abbc'): keep the literal up to
            # and including the char, then start fresh
            flush()
            i += 1
            continue
        if c in _QUANTS:
            # previous char optional ({} treated conservatively)
            if cur:
                cur.pop()
            flush()
            i = _skip_quant(pattern, i)
            if i is None:
                return []
            continue
        cur.append(c)
        i += 1
    if stack:
        return []
    flush()
    return [l for l in literals if len(l) >= 3]


def _grams(s: str):
    return {s[i: i + 3] for i in range(len(s) - 2)}


class TrigramIndex:
    """Sorted posting lists of dict ids per trigram."""

    def __init__(self, grams: np.ndarray, ids: np.ndarray, offs: np.ndarray):
        self.grams = grams  # sorted (G,) U3 array
        self.ids = ids      # concatenated int32 postings
        self.offs = offs    # (G+1,) int64

    @classmethod
    def build(cls, values) -> "TrigramIndex":
        posting: dict = {}
        for i, v in enumerate(np.asarray(values)):
            for g in _grams(str(v)):
                posting.setdefault(g, []).append(i)
        grams = np.asarray(sorted(posting), dtype=np.str_)
        offs = np.zeros(len(grams) + 1, dtype=np.int64)
        chunks = []
        for j, g in enumerate(grams):
            chunks.append(np.asarray(posting[g], dtype=np.int32))
            offs[j + 1] = offs[j] + len(chunks[-1])
        ids = np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int32)
        return cls(grams, ids, offs)

    def save(self, dir_path: str, col: str) -> None:
        np.save(os.path.join(dir_path, GRAMS_FILE.format(col=col)),
                self.grams, allow_pickle=False)
        np.save(os.path.join(dir_path, IDS_FILE.format(col=col)),
                self.ids, allow_pickle=False)
        np.save(os.path.join(dir_path, OFFS_FILE.format(col=col)),
                self.offs, allow_pickle=False)

    @classmethod
    def load(cls, dir_path: str, col: str):
        gp = os.path.join(dir_path, GRAMS_FILE.format(col=col))
        if not os.path.exists(gp):
            return None
        return cls(
            np.load(gp, allow_pickle=False),
            np.load(os.path.join(dir_path, IDS_FILE.format(col=col)),
                    allow_pickle=False, mmap_mode="r"),
            np.load(os.path.join(dir_path, OFFS_FILE.format(col=col)),
                    allow_pickle=False),
        )

    def _postings(self, gram: str):
        j = np.searchsorted(self.grams, gram)
        if j >= len(self.grams) or self.grams[j] != gram:
            return np.empty(0, dtype=np.int32)
        return np.asarray(self.ids[self.offs[j]: self.offs[j + 1]])

    def candidates(self, pattern: str, n_values: int):
        """Sorted candidate dict ids, or None → no narrowing possible."""
        lits = required_literals(pattern)
        if not lits:
            return None
        cand = None
        for lit in lits:
            for g in _grams(lit):
                p = self._postings(g)
                cand = p if cand is None else \
                    cand[np.isin(cand, p, assume_unique=True)]
                if len(cand) == 0:
                    return cand
        return cand
