"""Uniform parsing for ``SET``-style boolean query options (a copy of
pinot_tpu/common/options.py).

The SQL layer passes bare ``TRUE``/``FALSE`` through as real booleans,
but quoted literals (``SET useX = 'false'``) arrive as *strings*, and
``'false'`` is truthy; every per-query toggle (``useSortedProjection``,
...) parses through this helper so both spellings mean the same.

Semantics:

- absent / ``None``  -> ``default`` (caller-supplied tri-state allowed)
- real ``bool``      -> itself
- anything else      -> string-folded: ``"true"/"1"/"yes"`` (any case,
  surrounding whitespace ignored) means True, everything else False.
"""

from __future__ import annotations

_TRUTHY = ("true", "1", "yes")


def bool_option(opts, name: str, default=None):
    """Resolve option ``name`` from an ``options_ci()``-style dict.

    ``name`` is matched case-insensitively (``options_ci`` keys are
    already lower-cased; a raw dict is folded here so callers holding
    un-normalized option tuples get the same answer). Returns
    ``default`` when the option is absent — pass ``default=None`` to
    keep the tri-state "unset" visible to the caller."""
    if not opts:
        return default
    key = name.lower()
    val = opts.get(key)
    if val is None and key not in opts:
        # tolerate un-normalized dicts (options straight off q.options)
        for k, v in opts.items():
            if isinstance(k, str) and k.lower() == key:
                val = v
                break
        else:
            return default
    if val is None:
        return default
    if isinstance(val, bool):
        return val
    return str(val).strip().lower() in _TRUTHY

