"""Query rewrite helpers shared by engine and broker."""

from __future__ import annotations

import dataclasses

from pinot_tpu_torch.query.context import Expression, QueryContext


def expand_star(q: QueryContext, column_names) -> QueryContext:
    """SELECT * → explicit schema columns (CalciteSqlParser star expansion);
    both the in-process engine and the broker reduce need identical select
    positions."""
    if not any(e.is_identifier and e.name == "*" for e in q.select_expressions):
        return q
    cols = [Expression.identifier(c) for c in column_names]
    select, aliases = [], []
    for e, a in zip(q.select_expressions, q.aliases or [None] * len(q.select_expressions)):
        if e.is_identifier and e.name == "*":
            select.extend(cols)
            aliases.extend([None] * len(cols))
        else:
            select.append(e)
            aliases.append(a)
    return dataclasses.replace(
        q, select_expressions=tuple(select), aliases=tuple(aliases)
    )
