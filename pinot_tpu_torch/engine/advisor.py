"""Feedback-driven plan advisor: per-template memos that turn the roofline
telemetry into execution decisions (a copy of pinot_tpu/engine/advisor.py
for the port).

The engine *measures* everything — per-kernel achieved GB/s, block-skip
pruning ratios, build-side row counts, cache-hit rates, observed group
counts — but used to *decide* almost everything by static constant:
join strategy by ``BROADCAST_MAX_BUILD_ROWS``, block-skip by a fixed
``ceil(total/16)`` candidate bound, trim by a fixed ``group_trim_size``,
cohort windows by scheduler pressure alone. The reference makes these
calls with ``InstancePlanMakerImplV2``'s hand-tuned heuristics; the
advisor replaces the hand-tuning with the measurements the system
already collects (PAPER.md layer 5, ROADMAP item 2).

Design:

- **PlanMemo**: one memo per literal-free ``template_key`` (broker/querylog.py),
  holding EWMA'd measurements — build-side rows per alias, effective
  join strategy, block-skip selectivity (``blocks_scanned /
  blocks_total``), per-rung kernel GB/s (by roofline label), observed
  group counts, cohort sizes, cache-hit counts.
- **Bounded LRU + decay**: memos live per server/broker process (no
  persistence across restarts in v1); the map is LRU-bounded, and a
  measurement that *drifts* (a table's shape changed) halves the
  signal's confidence so advice stands down until it re-converges —
  decisions decay toward the static defaults rather than chasing stale
  measurements.
- **Safety**: every advised decision is either bit-exact by
  construction (join strategies compute identical rows; the dense and
  block-skip forms agree exactly; a candidate-bound overflow runs the
  dense form) or guarded by a no-drop rule (trim tightens only when the
  observed group count plus headroom still fits, so no group the
  default would keep is ever dropped).
- **One rung**: the port has one kernel rung per pipeline (its labels
  carry ``+cuda`` where the reference's carry ``+pallas``), so
  ``_split_label`` files every measurement under the "xla" rung,
  ``advise_pallas`` never sees two rungs and never advises, and the
  executor does not call it: nothing routes a pipeline to a plain
  version.
- **Debuggability**: every overridden decision returns an
  ``ADVISOR(<decision>: measured=X default=Y)`` line that rides the
  response (``advisorDecisions``), the query log, and EXPLAIN ANALYZE.
- ``SET useAdvisor=false`` bypasses both reads and writes for a query
  (zero memo effect, bit-exact against advisor-on by the rules above).

Config (common/config.py Configuration keys):

- ``pinot.advisor.enabled``        (default True)
- ``pinot.advisor.max.memos``      (default 256; LRU bound)
- ``pinot.advisor.min.samples``    (default 3; advice warmup)
- ``pinot.advisor.ewma.alpha``     (default 0.3)
- ``pinot.advisor.reprobe.every``  (default 16; periodic default-probe
  so a sticky decision (e.g. advised-dense block skip, whose ratio is
  only measurable on the skip path) re-measures and can un-stick)
"""

from __future__ import annotations

import threading
from collections import OrderedDict

# relative deviation past which an observation counts as DRIFT: the
# memo's confidence halves so advice stands down toward the default
DRIFT_FACTOR = 3.0
# headroom multipliers: advice must beat the default by a real margin,
# not measurement noise
TRIM_HEADROOM = 1.5       # tightened trim keeps >= groups_hi * this
CAND_HEADROOM = 2.5       # 1/frac must be >= observed ratio * this
PALLAS_MARGIN = 1.15      # rung switch needs >= 15% measured GB/s edge
DENSE_RATIO = 0.75        # skip ratio past this: block-skip buys nothing


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class _Ewma:
    """Mean tracker with drift detection: ``add`` returns True when the
    sample deviated far enough from the converged mean to halve the
    confidence count (decay toward the default)."""

    __slots__ = ("mean", "n", "alpha")

    def __init__(self, alpha: float = 0.3):
        self.mean = 0.0
        self.n = 0
        self.alpha = alpha

    def add(self, x: float) -> bool:
        x = float(x)
        if self.n == 0:
            self.mean = x
            self.n = 1
            return False
        drift = abs(x - self.mean) > DRIFT_FACTOR * max(abs(self.mean), 1e-9)
        self.mean += self.alpha * (x - self.mean)
        if drift:
            # stats drifted: halve confidence so advice stands down and
            # the mean re-converges before decisions resume
            self.n = self.n // 2
        else:
            self.n += 1
        return drift

    def ready(self, min_samples: int) -> bool:
        return self.n >= min_samples


class PlanMemo:
    """Measurements for one query template (one LRU slot)."""

    __slots__ = ("key", "build_rows", "strategies", "demotions",
                 "skip_ratio", "gbps", "groups", "groups_hi",
                 "trim_overflows", "cohort", "partials_hits",
                 "result_hits", "executions", "decisions", "overrides",
                 "drift_cooldown", "_probe_tick")

    def __init__(self, key: str, alpha: float):
        self.key = key
        self.build_rows: dict = {}      # alias -> _Ewma of measured rows
        self.strategies: dict = {}      # effective strategy -> count
        self.demotions = 0              # distributed demotions seen
        self.skip_ratio = _Ewma(alpha)  # blocks_scanned / blocks_total
        self.gbps: dict = {}            # (base label, rung) -> _Ewma GB/s
        self.groups = _Ewma(alpha)      # observed group count
        self.groups_hi = 0              # decaying max (trim safety bound)
        self.trim_overflows = 0         # advised keep < observed groups
        self.cohort = _Ewma(alpha)      # coalescer cohort sizes
        self.partials_hits = [0, 0]     # [hits, total]
        self.result_hits = [0, 0]
        self.executions = 0
        self.decisions = 0              # advise_* calls that were ready
        self.overrides = 0              # decisions that beat the default
        self.drift_cooldown = 0         # observations until "converged"
        self._probe_tick = 0            # periodic default re-probe clock

    def convergence(self, min_samples: int) -> str:
        """"cold" (still warming up), "drifting" (a recent drift reset
        confidence), or "converged" (advice-ready) — the per-template
        state tools/querylog.py renders."""
        if self.drift_cooldown > 0:
            return "drifting"
        signals = [self.skip_ratio, self.groups, self.cohort,
                   *self.build_rows.values(), *self.gbps.values()]
        if any(s.ready(min_samples) for s in signals):
            return "converged"
        return "cold"

    def snapshot(self) -> dict:
        return {
            "executions": self.executions,
            "decisions": self.decisions,
            "overrides": self.overrides,
            "strategies": dict(self.strategies),
            "demotions": self.demotions,
            "skipRatio": round(self.skip_ratio.mean, 4)
            if self.skip_ratio.n else None,
            "groupsHi": self.groups_hi,
            "trimOverflows": self.trim_overflows,
            "cohortMean": round(self.cohort.mean, 2)
            if self.cohort.n else None,
        }


class PlanAdvisor:
    """Thread-safe per-process plan memo store + decision maker.

    ``observe`` records what actually happened; ``advise_*`` feed it
    back. Every advise method returns ``(value, note)`` where ``note``
    is the ``ADVISOR(...)`` stamp when the decision overrode the static
    default and None when it confirmed it (no stamp — a confirming
    decision is not an override and must not imply one)."""

    def __init__(self, max_memos: int = 256, min_samples: int = 3,
                 alpha: float = 0.3, reprobe_every: int = 16):
        self.max_memos = max(1, int(max_memos))
        self.min_samples = max(1, int(min_samples))
        self.alpha = float(alpha)
        self.reprobe_every = max(2, int(reprobe_every))
        self._memos: OrderedDict[str, PlanMemo] = OrderedDict()
        self._lock = threading.RLock()
        self.evictions = 0
        self.observations = 0
        self.decisions = 0
        self.overrides = 0

    @classmethod
    def from_config(cls, conf=None) -> "PlanAdvisor | None":
        """Config-built advisor, or None when disabled process-wide."""
        if conf is None:
            from pinot_tpu_torch.common.config import Configuration

            conf = Configuration()
        if not conf.get_bool("pinot.advisor.enabled", True):
            return None
        return cls(
            max_memos=int(conf.get_float("pinot.advisor.max.memos", 256)),
            min_samples=int(conf.get_float("pinot.advisor.min.samples", 3)),
            alpha=conf.get_float("pinot.advisor.ewma.alpha", 0.3),
            reprobe_every=int(conf.get_float(
                "pinot.advisor.reprobe.every", 16)),
        )

    # ---- memo lifecycle --------------------------------------------------
    def _memo(self, key: str) -> PlanMemo:
        """Get-or-create under the lock; touches LRU order and evicts
        past the bound."""
        m = self._memos.get(key)
        if m is None:
            m = PlanMemo(key, self.alpha)
            self._memos[key] = m
            while len(self._memos) > self.max_memos:
                self._memos.popitem(last=False)
                self.evictions += 1
        else:
            self._memos.move_to_end(key)
        return m

    def peek(self, key: str) -> "PlanMemo | None":
        """Read-only lookup (no create, no LRU touch) — tools/tests."""
        with self._lock:
            return self._memos.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._memos)

    # ---- observation -----------------------------------------------------
    def observe(self, key: str, *, build_rows=None, join_strategy=None,
                demoted: bool = False, skip_ratio=None, label=None,
                gbps=None, groups=None, trim_keep=None, cohort=None,
                partials_hit=None, result_hit=None) -> None:
        """Fold one execution's measurements into the template's memo.
        Any subset of signals may be supplied; unknown templates create
        a memo. Never raises — a measurement must not fail a query."""
        if not key:
            return
        try:
            with self._lock:
                m = self._memo(key)
                self.observations += 1
                m.executions += 1
                if m.drift_cooldown > 0:
                    m.drift_cooldown -= 1
                drifted = False
                if build_rows:
                    for alias, n in build_rows.items():
                        e = m.build_rows.get(alias)
                        if e is None:
                            e = m.build_rows[alias] = _Ewma(self.alpha)
                        drifted |= e.add(n)
                if join_strategy:
                    m.strategies[join_strategy] = \
                        m.strategies.get(join_strategy, 0) + 1
                if demoted:
                    m.demotions += 1
                if skip_ratio is not None:
                    drifted |= m.skip_ratio.add(skip_ratio)
                if gbps is not None and label is not None:
                    base, rung = _split_label(label)
                    e = m.gbps.get((base, rung))
                    if e is None:
                        e = m.gbps[(base, rung)] = _Ewma(self.alpha)
                    e.add(gbps)
                if groups is not None:
                    g = int(groups)
                    drifted |= m.groups.add(g)
                    # decaying max: the trim safety bound follows the
                    # template's real group count down slowly, up fast
                    m.groups_hi = max(g, int(m.groups_hi * 0.9))
                    if trim_keep is not None and g > int(trim_keep):
                        # the advised keep was too tight: count the
                        # overflow and stand the advice down
                        m.trim_overflows += 1
                        m.groups.n = 0
                if cohort is not None:
                    m.cohort.add(cohort)
                if partials_hit is not None:
                    m.partials_hits[1] += 1
                    m.partials_hits[0] += bool(partials_hit)
                if result_hit is not None:
                    m.result_hits[1] += 1
                    m.result_hits[0] += bool(result_hit)
                if drifted:
                    m.drift_cooldown = self.min_samples
        except Exception:  # noqa: BLE001 — observation must never fail
            pass

    # ---- decisions -------------------------------------------------------
    def _decide(self, m: PlanMemo, overrode: bool) -> None:
        m.decisions += 1
        self.decisions += 1
        if overrode:
            m.overrides += 1
            self.overrides += 1

    def advise_join_strategy(self, key: str, default: str,
                             build_alias: str, threshold: int):
        """Measured build rows beat the static dim-table heuristic: a
        small measured build side broadcasts even off a fact table; a
        big one shuffles even off a dim table. Only flips between
        BROADCAST and SHUFFLE (DISTRIBUTED routing is the broker's call
        via measured_build_rows)."""
        if default not in ("BROADCAST", "SHUFFLE"):
            return default, None
        with self._lock:
            m = self._memos.get(key)
            if m is None or m.drift_cooldown > 0:
                return default, None
            e = m.build_rows.get(build_alias)
            if e is None or not e.ready(self.min_samples):
                return default, None
            measured = int(e.mean)
            pick = "SHUFFLE" if measured > threshold else "BROADCAST"
            self._decide(m, pick != default)
            if pick == default:
                return default, None
            return pick, (f"ADVISOR(joinStrategy={pick}: "
                          f"measured={measured} default={default})")

    def measured_build_rows(self, key: str, build_alias: str):
        """Converged measured build-side row count, or None — the
        broker's distributed-demotion probe uses it in place of the
        registry doc-count estimate."""
        with self._lock:
            m = self._memos.get(key)
            if m is None or m.drift_cooldown > 0:
                return None
            e = m.build_rows.get(build_alias)
            if e is None or not e.ready(self.min_samples):
                return None
            return int(e.mean)

    def advise_blockskip(self, key: str, default_frac: int):
        """(candidate fraction, note): 0 = run dense (the measured
        selectivity shows block skip prunes nothing), ``default_frac``
        when unconverged, a larger fraction (tighter static candidate
        bound → smaller gather) when the measured ratio leaves
        CAND_HEADROOM of room. Overflowing a tightened bound falls back
        to the dense branch in kernel (bit-exact), shows up here as a
        ratio-1.0 drift, and stands the advice down."""
        with self._lock:
            m = self._memos.get(key)
            if m is None or m.drift_cooldown > 0 \
                    or not m.skip_ratio.ready(self.min_samples):
                return default_frac, None
            ratio = m.skip_ratio.mean
            if ratio >= DENSE_RATIO:
                # periodic re-probe: the ratio is only measurable on the
                # skip path, so an always-dense decision could never
                # un-stick after the table's shape changes
                m._probe_tick += 1
                if m._probe_tick % self.reprobe_every == 0:
                    return default_frac, None
                self._decide(m, True)
                return 0, (f"ADVISOR(blockSkip=dense: "
                           f"measured={ratio:.3f} default=1/{default_frac})")
            frac = default_frac
            for cand in (64, 32):
                if cand > default_frac and ratio * CAND_HEADROOM <= 1 / cand:
                    frac = cand
                    break
            self._decide(m, frac != default_frac)
            if frac == default_frac:
                return default_frac, None
            return frac, (f"ADVISOR(candBound=1/{frac}: "
                          f"measured={ratio:.3f} default=1/{default_frac})")

    def advise_pallas(self, key: str, default_mode: str, label: str):
        """Pallas-vs-XLA rung selection when BOTH rungs have measured
        GB/s for this template's pipeline label: demote to the XLA rung
        when it measured meaningfully faster (quarantine episodes and
        SET usePallas=false runs are where the XLA rung's numbers come
        from — the advisor never forces exploration)."""
        if default_mode == "off":
            return default_mode, None
        with self._lock:
            m = self._memos.get(key)
            if m is None or m.drift_cooldown > 0:
                return default_mode, None
            base, _ = _split_label(label)
            ep = m.gbps.get((base, "pallas"))
            ex = m.gbps.get((base, "xla"))
            if ep is None or ex is None \
                    or not ep.ready(self.min_samples) \
                    or not ex.ready(self.min_samples):
                return default_mode, None
            if ex.mean > ep.mean * PALLAS_MARGIN:
                # periodic re-probe of the Pallas rung so a transiently
                # slow measurement can be revised
                m._probe_tick += 1
                if m._probe_tick % self.reprobe_every == 0:
                    return default_mode, None
                self._decide(m, True)
                return "off", (
                    f"ADVISOR(pallas=off: measured="
                    f"{ex.mean:.1f}GB/s>{ep.mean:.1f}GB/s "
                    f"default={default_mode})")
            self._decide(m, False)
            return default_mode, None

    def advise_trim(self, key: str, default_trim: int):
        """group_trim_size tightened toward the template's observed
        group count. NO-DROP rule: the tightened bound must still cover
        groups_hi (the decaying max) with TRIM_HEADROOM to spare, so no
        group the default bound would have kept is ever dropped — the
        only effect is a smaller device table + fetch buffer. An
        overflow observation (observe(groups=, trim_keep=)) resets the
        signal and the advice stands down to the default."""
        with self._lock:
            m = self._memos.get(key)
            if m is None or m.drift_cooldown > 0 \
                    or not m.groups.ready(self.min_samples) \
                    or m.groups_hi <= 0:
                return default_trim, None
            tightened = _pow2_at_least(
                max(64, int(m.groups_hi * TRIM_HEADROOM) + 1))
            if tightened >= default_trim:
                self._decide(m, False)
                return default_trim, None
            self._decide(m, True)
            return tightened, (f"ADVISOR(groupTrim={tightened}: "
                               f"measured={m.groups_hi} "
                               f"default={default_trim})")

    def advise_cohort_window(self, key: str, default_s: float):
        """Cohort window sizing from observed arrival cohesion: a
        template whose cohorts stay solo shrinks its window (the wait
        buys nothing), one that reliably finds partners holds it open
        longer. Bounded to [0.5x, 2x] of the configured window."""
        with self._lock:
            m = self._memos.get(key)
            if m is None or m.drift_cooldown > 0 \
                    or not m.cohort.ready(self.min_samples):
                return default_s, None
            mean = m.cohort.mean
            if mean <= 1.25:
                w = default_s * 0.5
            elif mean >= 4.0:
                # cohorts fill fast — the full.wait exits early anyway;
                # keep the configured window
                self._decide(m, False)
                return default_s, None
            else:
                w = default_s * 2.0
            self._decide(m, True)
            return w, (f"ADVISOR(cohortWindow={w * 1e3:.1f}ms: "
                       f"measured={mean:.1f} default={default_s * 1e3:.1f}ms)")

    # ---- introspection ---------------------------------------------------
    def convergence(self, key: str) -> str:
        with self._lock:
            m = self._memos.get(key)
            return "cold" if m is None else m.convergence(self.min_samples)

    def snapshot(self) -> dict:
        """Advisor-wide stats + per-memo summaries (admin / tools)."""
        with self._lock:
            return {
                "memos": len(self._memos),
                "evictions": self.evictions,
                "observations": self.observations,
                "decisions": self.decisions,
                "overrides": self.overrides,
                "templates": {k: m.snapshot()
                              for k, m in self._memos.items()},
            }


def _split_label(label: str):
    """Roofline pipeline label → (base label, rung): the Pallas form of
    a pipeline carries "+pallas" (and possibly "+fused") suffixes; the
    base identifies the same logical pipeline across rungs so their
    measured GB/s compare like for like."""
    rung = "pallas" if "+pallas" in label else "xla"
    base = label.replace("+fused", "").replace("+pallas", "")
    return base, rung


def advisor_enabled(opts, default: bool = True) -> bool:
    """Per-query ``SET useAdvisor`` gate (common/options.py semantics:
    quoted 'false' opts out like bare FALSE)."""
    from pinot_tpu_torch.common.options import bool_option

    v = bool_option(opts, "useadvisor", None)
    return default if v is None else bool(v)
