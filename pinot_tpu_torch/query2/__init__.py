"""The multi-stage engine: join and window queries on the card.

``logical.py`` compiles JOIN / window statements into a two-stage plan (a
copy of the reference's planner), ``runner.py`` executes it: stage-1 leaf
scans in the host path's shape on the card (engine/rows.py), the join as
torch ops (ops/join.py), window functions over one ordering
(ops/window.py), and stage 2's group sums through K1 before
engine/reduce.py's finalize. Plain single-table queries never enter this
package.
"""

from pinot_tpu_torch.query2.logical import (  # noqa: F401
    MultiStagePlan,
    compile_plan,
    is_multistage,
)
