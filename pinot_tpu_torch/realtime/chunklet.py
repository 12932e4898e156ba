"""Chunklet subsystem: columnar batch ingest + device promotion for
consuming segments (a copy of pinot_tpu/realtime/chunklet.py for the
port; its invalidation hook names the port's executor).

The reference serves CONSUMING segments through ``MutableSegmentImpl`` row
structures and sealed segments through immutable readers, with
``LLRealtimeSegmentDataManager`` walking rows between the two worlds. A
consuming segment as a whole never rides a device batch; chunklets let
most of its rows do so. Its doc space splits into

- a FROZEN PREFIX of fixed-size sealed blocks (``Chunklet``): the
  single-writer contract means docs below the published count never change,
  so once ``rows_per_chunklet`` docs accumulate they re-encode into sorted
  dictionaries + int32 forward ids — the shape
  ``engine/params.BatchContext`` uploads to the card. Chunklets duck-type
  the ImmutableSegment reader protocol, so they ride the same batched
  (S, L) device templates, batch LRU and in-flight pins as sealed
  segments — no new kernel code.
- an UNFROZEN ROW TAIL (``MutableTailView``), which runs in the host
  path's shape on the card (engine/device.py ``launch_host_part``);
  ``engine/engine.py`` merges the partials like any other mix.

Upsert: validDocIds can flip docs INSIDE the frozen prefix (a newer version
of a key arrives in the tail). ``MutableSegment.invalidate`` notifies the
index; a dirtied chunklet leaves the device batch and runs in the host
path's shape with its mask slice — correctness first, device speed for
the untouched blocks.

Ingest: ``MutableSegment.index_batch`` (columnar numpy appends +
vectorized dictionary growth) replaces per-row ``index(dict)`` as the
consume-loop basis, and ``ingest_worker_main`` runs one partition's
consume loop in its own OS process (the controller-HA test's process
harness pattern) so multi-partition ingest scales past the GIL.
"""

from __future__ import annotations

import bisect
import json
import logging
import sys
import threading
import time

import numpy as np

from pinot_tpu_torch.common.datatypes import FieldRole
from pinot_tpu_torch.storage.dictionary import Dictionary
from pinot_tpu_torch.storage.segment import ColumnMetadata, Encoding, SegmentMetadata

log = logging.getLogger("pinot_tpu_torch.realtime.chunklet")


def _invalidate_device_partials(match: str) -> None:
    """Fan a partials-cache invalidation out to every live DeviceExecutor
    (engine/device.py invalidate_cached_partials). Import-free when the
    device module was never loaded — ingest worker processes must not
    import the executor just to notify a cache that cannot exist there.
    Correctness never rides on this hook (batch keys change with the
    chunklet set, so stale entries are unreachable); it frees the device
    bytes they pin."""
    dev_mod = sys.modules.get("pinot_tpu_torch.engine.device")
    if dev_mod is None:
        return
    try:
        dev_mod.invalidate_cached_partials(match)
    except Exception:  # noqa: BLE001 — cache hygiene must not fail ingest
        log.exception("device partials invalidation failed for %r", match)


def _use_dictionary(spec, no_dict_cols) -> bool:
    """Mirror the segment creator's encoding policy (storage/creator.py):
    strings always dict-encode; numeric dimensions/datetimes dict-encode
    unless listed in no_dictionary_columns; metrics stay RAW. Chunklets
    must match sealed segments so the same query templates apply."""
    if spec.data_type.is_string_like:
        return True
    if spec.name in no_dict_cols:
        return False
    return spec.role is not FieldRole.METRIC


class Chunklet:
    """One sealed 64k-row block of a consuming segment's frozen prefix.

    Immutable by construction (docs below the published count never
    mutate), device-eligible while clean, and a full duck-type of the
    ImmutableSegment reader surface the batch/host layers touch:
    ``metadata.columns`` / ``column_metadata`` / ``dictionary`` /
    ``forward`` / ``values`` / ``null_vector`` / ``n_docs`` / ``dir``.
    ``dir`` is the executor's batch cache key — stable per block, so
    repeated queries over the same frozen prefix hit the BatchContext
    resident on the card. Because per-block ColumnMetadata carries exact
    cardinality and min/max (``_seal_column``), the batch layer's width
    planner (engine/params.py ColPlan) narrows chunklet planes exactly
    like sealed segments' — uint8/uint16 dict ids, frame-of-reference
    raw values — pinned by tests/test_narrow.py."""

    is_mutable = False

    def __init__(self, segment, ordinal: int, start: int, stop: int):
        self._seg = segment
        self.ordinal = ordinal
        self.start = start
        self.stop = stop
        self.name = f"{segment.segment_name}__ck{ordinal}"
        self.dir = f"<chunklet:{segment.segment_name}:{ordinal}:{start}-{stop}>"
        # upsert invalidation landed inside [start, stop): invalidations
        # that PREDATE promotion (a newer key version arrived before this
        # block filled) must dirty the block at seal time — note_invalidated
        # only covers blocks that already exist
        v = segment._valid
        self._dirty = bool(v is not None and not v[start:stop].all())
        self._fwd: dict[str, np.ndarray] = {}
        self._dicts: dict[str, Dictionary] = {}
        self._nulls: dict[str, np.ndarray] = {}
        self._zmaps: dict[str, np.ndarray] = {}
        no_dict = getattr(segment.table_config.indexing,
                          "no_dictionary_columns", [])
        cols_meta: dict[str, ColumnMetadata] = {}
        for cname, col in segment._cols.items():
            cols_meta[cname] = self._seal_column(cname, col, no_dict)
        self.metadata = SegmentMetadata(
            segment_name=self.name,
            table_name=segment.schema.name,
            n_docs=stop - start,
            columns=cols_meta,
        )

    def _seal_column(self, name: str, col, no_dict) -> ColumnMetadata:
        start, stop, n = self.start, self.stop, self.stop - self.start
        spec = col.spec
        # null mask over the block (null_docs appends in doc order)
        nd = col.null_docs
        lo = bisect.bisect_left(nd, start)
        hi = bisect.bisect_left(nd, stop)
        has_nulls = hi > lo
        if has_nulls:
            mask = np.zeros(n, dtype=bool)
            mask[np.asarray(nd[lo:hi], dtype=np.int64) - start] = True
            self._nulls[name] = mask
        if col.dict_encoded:
            # insertion-ordered ids → per-block SORTED dictionary: unique
            # over the ids first (distinct count << block rows), decode only
            # the distinct values, rank-remap the forward index
            ids = np.asarray(col._data[start:stop])
            table = col.dict_table()
            uids, inv = np.unique(ids, return_inverse=True)
            uvals = table[uids]
            order = np.argsort(uvals)
            sorted_vals = uvals[order]
            rank = np.empty(len(order), dtype=np.int32)
            rank[order] = np.arange(len(order), dtype=np.int32)
            self._fwd[name] = rank[inv].astype(np.int32)
            self._dicts[name] = Dictionary(sorted_vals)
            return ColumnMetadata(
                name=name, data_type=spec.data_type, encoding=Encoding.DICT,
                cardinality=len(sorted_vals),
                min_value=sorted_vals[0].item() if sorted_vals.dtype.kind
                not in ("U", "S", "O") else sorted_vals[0],
                max_value=sorted_vals[-1].item() if sorted_vals.dtype.kind
                not in ("U", "S", "O") else sorted_vals[-1],
                is_sorted=False, single_value=True, has_dictionary=True,
                has_null_vector=has_nulls, total_number_of_entries=n,
            )
        vals = np.asarray(col._data[start:stop])
        if _use_dictionary(spec, no_dict):
            sorted_vals, inv = np.unique(vals, return_inverse=True)
            self._fwd[name] = inv.astype(np.int32)
            self._dicts[name] = Dictionary(sorted_vals)
            return ColumnMetadata(
                name=name, data_type=spec.data_type, encoding=Encoding.DICT,
                cardinality=len(sorted_vals),
                min_value=sorted_vals[0].item(),
                max_value=sorted_vals[-1].item(),
                is_sorted=False, single_value=True, has_dictionary=True,
                has_null_vector=has_nulls, total_number_of_entries=n,
            )
        self._fwd[name] = vals.copy()
        return ColumnMetadata(
            name=name, data_type=spec.data_type, encoding=Encoding.RAW,
            cardinality=-1,
            min_value=vals.min().item(), max_value=vals.max().item(),
            is_sorted=False, single_value=True, has_dictionary=False,
            has_null_vector=has_nulls, total_number_of_entries=n,
        )

    # ---- reader protocol -------------------------------------------------
    @property
    def n_docs(self) -> int:
        return self.stop - self.start

    def column_names(self) -> list:
        return list(self.metadata.columns)

    def column_metadata(self, col: str) -> ColumnMetadata:
        return self.metadata.columns[col]

    def dictionary(self, col: str):
        return self._dicts.get(col)

    def forward(self, col: str) -> np.ndarray:
        return self._fwd[col]

    def bloom(self, col: str):
        return None

    def zone_map(self, col: str) -> np.ndarray:
        """(2, n_blocks) per-block [min, max] over this chunklet's forward
        index (local dict ids / raw values), same contract as
        ImmutableSegment.zone_map. Computed lazily from the sealed block —
        chunklets are immutable, so one compute per promotion is the
        "refresh": every new frozen block arrives with fresh zone maps and
        the consuming segment's device batch prunes like sealed data."""
        zm = self._zmaps.get(col)
        if zm is None:
            from pinot_tpu_torch.storage.segment import build_zone_map

            zm = build_zone_map(self._fwd[col])
            self._zmaps[col] = zm
        return zm

    def values(self, col: str) -> np.ndarray:
        return self.flat_values(col)

    def flat_values(self, col: str) -> np.ndarray:
        d = self._dicts.get(col)
        if d is None:
            return self._fwd[col]
        return d.take(self._fwd[col])

    def null_vector(self, col: str):
        return self._nulls.get(col)

    # ---- upsert masking --------------------------------------------------
    def mark_dirty(self) -> None:
        self._dirty = True  # one-way: invalidations never un-flip

    @property
    def is_clean(self) -> bool:
        return not self._dirty

    @property
    def valid_docs_mask(self):
        """None while clean (device-eligible); once an upsert invalidation
        lands in range, a SNAPSHOT slice of the segment's validDocIds —
        the same snapshot-at-query semantics the host path applies to the
        whole mutable segment."""
        if not self._dirty:
            return None
        return np.asarray(self._seg._valid[self.start:self.stop]).copy()


class MutableTailView:
    """The unfrozen row tail [start, stop) of a consuming segment, duck-
    typed for the host executor. ``stop`` pins the reader snapshot at
    split time so every column sees the same doc count."""

    is_mutable = True
    valid_docs_mask = None

    def __init__(self, segment, start: int, stop: int):
        self._seg = segment
        self.start = start
        self._n = stop - start
        self.name = f"{segment.segment_name}__tail{start}"
        self.dir = f"<mutable-tail:{segment.segment_name}:{start}:{stop}>"

    @property
    def n_docs(self) -> int:
        return self._n

    @property
    def metadata(self):
        # segment-wide metadata: min/max are a superset of the tail's,
        # so pruning stays conservative-correct
        return self._seg.metadata

    def column_names(self) -> list:
        return self._seg.column_names()

    def column_metadata(self, col: str) -> ColumnMetadata:
        return self._seg.column_metadata(col)

    def dictionary(self, col: str):
        return None

    def bloom(self, col: str):
        return None

    def values(self, col: str) -> np.ndarray:
        # ranged decode: the tail must not pay a full-segment dictionary
        # take per query — that cost is what promotion removed
        return self._seg._cols[col].values_range(
            self.start, self.start + self._n)

    def valid_docs(self, n: int):
        m = self._seg.valid_docs(self.start + n)
        return None if m is None else m[self.start:]

    def null_vector(self, col: str):
        nv = self._seg.null_vector(col)
        if nv is None:
            return None
        nv = nv[self.start:self.start + self._n]
        return nv if nv.any() else None


class ChunkletIndex:
    """Per-consuming-segment promotion state: the grown-but-frozen prefix
    sealed so far, plus the upsert dirty flags. ``chunklets`` is grow-only
    and appended AFTER a block is fully built — the same volatile-publish
    discipline as the segment's doc counter, so query threads can snapshot
    it lock-free."""

    def __init__(self, segment, config):
        self.segment = segment
        self.rows_per_chunklet = max(1024, int(config.rows_per_chunklet))
        self.device_min_rows = int(config.device_min_rows)
        self.chunklets: list[Chunklet] = []
        self._promote_lock = threading.Lock()

    @property
    def frozen_docs(self) -> int:
        cks = self.chunklets
        return cks[-1].stop if cks else 0

    def promote(self, limit: int = None) -> int:
        """Seal every full chunklet below the published doc count (writer
        thread; the lock only defends against an explicit second caller).
        Returns the number of blocks promoted.

        Failure semantics: chunklets publish append-only AFTER they are
        fully built, so a promotion failure (including an injected one)
        leaves the index consistent — the unfrozen rows simply stay on
        the host tail path and queries remain correct; consume loops
        treat the raise as non-fatal and retry on the next batch."""
        made = 0
        with self._promote_lock:
            while limit is None or made < limit:
                start = self.frozen_docs
                stop = start + self.rows_per_chunklet
                if self.segment.n_docs < stop:
                    break
                ck = Chunklet(self.segment, len(self.chunklets), start, stop)
                self.chunklets.append(ck)  # publish fully-built only
                made += 1
        if made:
            # the chunklet set changed: device batches (and their cached
            # partials) built over the OLD frozen prefix retire, and the
            # table's freshness epoch bumps so broker result caches can't
            # serve answers computed over the old split
            from pinot_tpu_torch.common import freshness

            _invalidate_device_partials(
                f"<chunklet:{self.segment.segment_name}:")
            freshness.bump(self.segment.table_config.table_name)
        return made

    def note_invalidated(self, doc_id: int) -> None:
        i = doc_id // self.rows_per_chunklet
        cks = self.chunklets
        if i < len(cks):
            was_clean = cks[i].is_clean
            cks[i].mark_dirty()
            if was_clean:
                # first upsert into this block: cached partials over any
                # batch containing it are stale-by-construction (the
                # table epoch itself bumps in MutableSegment.invalidate)
                _invalidate_device_partials(cks[i].dir)

    def column_with_tail(self, name: str, n: int) -> np.ndarray:
        """Decoded column over docs [0, n): chunklet blocks for the frozen
        prefix + the mutable decode for the tail — the final seal's reuse
        path (RealtimeSegmentConverter analog input)."""
        cks = list(self.chunklets)
        frozen = cks[-1].stop
        parts = [ck.flat_values(name) for ck in cks]
        if n > frozen:
            parts.append(self.segment._cols[name].values_range(frozen, n))
        return np.concatenate(parts) if len(parts) > 1 else parts[0]


def split_for_query(seg):
    """(device_chunklets, host_parts) for a consuming segment, or None when
    the chunklet path doesn't apply (below the crossover, nothing promoted,
    or every block is upsert-dirty) — the engine then runs the whole
    segment in the host path's shape as before.

    Snapshot semantics: the chunklet list and doc count are read once;
    rows and invalidations landing after the split are picked up by the
    next query, exactly like the host path's validDocIds snapshot."""
    ci = getattr(seg, "chunklet_index", None)
    if ci is None:
        return None
    cks = list(ci.chunklets)
    if not cks:
        return None
    frozen = cks[-1].stop
    if frozen < ci.device_min_rows:
        return None
    n = seg.n_docs  # read AFTER the chunklet snapshot: frozen <= n
    device = [ck for ck in cks if ck.is_clean]
    if not device:
        return None
    host = [ck for ck in cks if not ck.is_clean]
    if n > frozen:
        host.append(MutableTailView(seg, frozen, n))
    return device, host


# ---------------------------------------------------------------------------
# per-partition OS-process consume loop (multi-partition ingest harness)
# ---------------------------------------------------------------------------


def consume_stream_batches(segment, consumer, decoder, start_offset,
                           transform=None, on_error=None,
                           promote: bool = True, batch_decoder=None,
                           max_rows: int = 8192):
    """One fetch→decode→index_batch→promote step of a consume loop.
    Returns (rows_indexed, next_offset, fetched_count).

    Fast paths compose when available: ``fetch_payload_batch`` (raw
    payloads, no per-message object construction) and ``batch_decoder``
    (one parser call per fetch). Decode failures skip the row
    (poison-message semantics) by re-decoding the batch row-at-a-time;
    an ``index_batch`` failure likewise falls back to per-row ``index``
    so one bad row can't drop its whole batch."""
    fp = getattr(consumer, "fetch_payload_batch", None)
    if fp is not None:
        payloads, next_offset = fp(start_offset, max_rows)
        fetched = len(payloads)
    else:
        batch = consumer.fetch_messages(start_offset, 100)
        payloads = [m.payload for m in batch.messages]
        next_offset = batch.next_offset
        fetched = len(batch)
    rows = None
    if payloads and batch_decoder is not None and transform is None:
        try:
            rows = batch_decoder(payloads)
        except Exception:  # noqa: BLE001 — isolate below, per payload
            rows = None
    if rows is None:
        rows = []
        for p in payloads:
            try:
                row = decoder(p)
                if transform is not None:
                    row = transform(row)
                    if row is None:
                        continue
                rows.append(row)
            except Exception as e:  # noqa: BLE001 — poison message
                if on_error is not None:
                    on_error(p, e)
    indexed = 0
    if rows:
        try:
            segment.index_batch(rows)
            indexed = len(rows)
        except Exception:  # noqa: BLE001 — isolate the poison row
            for row in rows:
                try:
                    segment.index(row)
                    indexed += 1
                except Exception as e:  # noqa: BLE001
                    if on_error is not None:
                        on_error(None, e)
    if promote and segment.chunklet_index is not None:
        try:
            segment.chunklet_index.promote()
        except Exception:  # noqa: BLE001 — promotion is an optimization
            # a failed promotion must not drop ingested rows or kill the
            # consume loop: the unfrozen rows keep serving from the host
            # tail and the next batch retries the promotion
            log.exception("chunklet promotion failed; rows stay on the "
                          "host tail path")
    return indexed, next_offset, fetched


def ingest_worker_main(spec: dict) -> dict:
    """One partition's consume loop, meant to run in its OWN OS process
    (spawned with ``sys.executable -m pinot_tpu_torch.realtime.chunklet`` — the
    controller-HA test's process-harness pattern): ingests ``rows``
    synthetic events into a MutableSegment via ``index_batch`` with
    chunklet promotion, timing ONLY the ingest phase.

    ``spec["payload"]`` picks the basis:

    - ``"rows"`` (default): pre-decoded dict rows (pure columnar index
      and promotion);
    - ``"json"``: the full stream consume loop — publish serialized JSON
      to an in-process memory stream partition, then fetch→batch-decode→
      index_batch through the stream SPI (decode cost included).

    Returns the rows/s report the parent aggregates."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import (
        ChunkletConfig,
        StreamConfig,
        TableConfig,
        TableType,
    )
    from pinot_tpu_torch.stream.memory_stream import TopicRegistry
    from pinot_tpu_torch.stream.spi import (
        StreamPartitionMsgOffset,
        create_consumer_factory,
        get_decoder,
    )

    n = int(spec.get("rows", 1_000_000))
    partition = int(spec.get("partition", 0))
    rows_per_chunklet = int(spec.get("rows_per_chunklet", 65_536))
    distinct_zones = int(spec.get("distinct_zones", 260))
    seed = int(spec.get("seed", 7)) + partition

    schema = Schema.build(
        name="rtm",
        dimensions=[("zone", DataType.STRING), ("hour", DataType.INT)],
        metrics=[("fare", DataType.INT)],
    )
    cfg = TableConfig(
        table_name="rtm", table_type=TableType.REALTIME,
        stream=StreamConfig(stream_type="memory", topic=f"rtm_p{partition}"),
        chunklets=ChunkletConfig(enabled=True,
                                 rows_per_chunklet=rows_per_chunklet,
                                 device_min_rows=0),
    )

    # synthesize a cycle of events once (producer cost, untimed)
    rng = np.random.default_rng(seed)
    cycle = min(n, 65_536)
    zs = rng.integers(0, distinct_zones, cycle)
    hs = rng.integers(0, 24, cycle)
    fs = rng.integers(100, 10_000, cycle)
    events = [
        {"zone": f"zone_{z:03d}", "hour": int(h), "fare": int(f)}
        for z, h, f in zip(zs, hs, fs)
    ]
    from pinot_tpu_torch.storage.mutable import MutableSegment

    seg = MutableSegment(schema, f"rtm__{partition}__0__0", cfg)
    errors = 0

    if spec.get("payload", "rows") == "json":
        # full consume loop: stream fetch + batched JSON decode included
        from pinot_tpu_torch.stream.spi import get_batch_decoder

        payloads = [json.dumps(e).encode("utf-8") for e in events]
        topic = TopicRegistry.create(f"rtm_p{partition}", 1)
        for i in range(n):
            topic.publish(payloads[i % cycle], 0)
        factory = create_consumer_factory(cfg.stream)
        consumer = factory.create_partition_consumer(0)
        decoder = get_decoder("json", cfg.stream)
        batch_decoder = get_batch_decoder("json", cfg.stream)
        offset = StreamPartitionMsgOffset(0)

        def on_error(_msg, _e):
            nonlocal errors
            errors += 1

        t0 = time.perf_counter()
        while seg.n_docs + errors < n:
            _, offset, got = consume_stream_batches(
                seg, consumer, decoder, offset, on_error=on_error,
                batch_decoder=batch_decoder)
            if got == 0:
                break
        elapsed = time.perf_counter() - t0
    else:
        # pre-decoded rows: pure columnar index + promotion
        rows = [events[i % cycle] for i in range(n)]
        batch = 8192
        t0 = time.perf_counter()
        for i in range(0, n, batch):
            seg.index_batch(rows[i:i + batch])
            seg.chunklet_index.promote()
        elapsed = time.perf_counter() - t0
    return {
        "partition": partition,
        "rows": seg.n_docs,
        "errors": errors,
        "seconds": round(elapsed, 4),
        "rows_per_s": round(seg.n_docs / elapsed) if elapsed > 0 else 0,
        "chunklets": len(seg.chunklet_index.chunklets)
        if seg.chunklet_index is not None else 0,
    }


if __name__ == "__main__":
    _spec = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {}
    print(json.dumps(ingest_worker_main(_spec)))
