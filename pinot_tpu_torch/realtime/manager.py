"""Realtime ingestion managers: consume → index → seal → commit (a copy
of pinot_tpu/realtime/manager.py for the port, over the port's engine
tables and its in-memory stream).

Equivalent of the reference's realtime data-manager layer
(pinot-core/.../data/manager/realtime/LLRealtimeSegmentDataManager.java —
per-partition consume loop with the CONSUMING→HOLDING→COMMITTING state
machine — and RealtimeTableDataManager), single-process edition: the
controller-side commit FSM (SegmentCompletionManager committer election)
collapses to a local checkpoint store; the multi-replica protocol arrives
with the cluster layer.

Crash/restart contract (SURVEY.md §5 checkpoint/resume): sealed segments are
the checkpoints; the CheckpointStore records (segment, end offset, sequence)
per partition, and a restarted manager re-consumes from the last committed
offset — exactly the reference's ZK segment-metadata semantics.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.ingestion.transform import TransformError
from pinot_tpu_torch.realtime import merger
from pinot_tpu_torch.realtime.upsert import PartitionUpsertMetadataManager
from pinot_tpu_torch.storage.mutable import MutableSegment
from pinot_tpu_torch.stream.spi import (
    StreamPartitionMsgOffset,
    create_consumer_factory,
    get_decoder,
)

log = logging.getLogger("pinot_tpu_torch.realtime")


class CheckpointStore:
    """Durable per-partition commit log (segment ZK metadata analog)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._state = {}
        if os.path.exists(path):
            with open(path) as f:
                self._state = json.load(f)

    def _key(self, table: str, partition: int) -> str:
        return f"{table}/{partition}"

    def committed(self, table: str, partition: int) -> Optional[dict]:
        return self._state.get(self._key(table, partition))

    def committed_name(self, table: str, partition: int, sequence: int):
        """Name of the committed segment at ``sequence``, or None if unknown
        (legacy checkpoint written before names were logged)."""
        entry = self._state.get(self._key(table, partition))
        if entry is None:
            return None
        return entry.get("names", {}).get(str(sequence))

    def record_commit(self, table: str, partition: int, segment_name: str,
                      end_offset: str, sequence: int) -> None:
        with self._lock:
            prior = self._state.get(self._key(table, partition), {})
            # full seq→name log (the ZK segment-metadata list analog): restart
            # reconciliation uses it to tell committed dirs from crash orphans
            # at ANY sequence, not just the latest
            names = dict(prior.get("names", {}))
            names[str(sequence)] = segment_name
            self._state[self._key(table, partition)] = {
                "segment": segment_name,
                "offset": end_offset,
                "sequence": sequence,
                "names": names,
            }
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._state, f)
            os.replace(tmp, self.path)


def llc_segment_name(table: str, partition: int, sequence: int,
                     start_offset: str = None) -> str:
    """LLCSegmentName analog: table__partition__sequence__suffix. The suffix
    is the START OFFSET (deterministic), not a creation timestamp: replicas
    consuming the same partition resume from the same committed offset, so
    they agree on the name of the segment they're racing to commit — the
    property the reference gets from the controller assigning the name in
    ZK. Falls back to a timestamp when no offset is known."""
    suffix = start_offset if start_offset is not None \
        else time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    return f"{table}__{partition}__{sequence}__{suffix}"


class RealtimePartitionManager:
    """One partition's consume loop (LLRealtimeSegmentDataManager analog)."""

    CONSUMING = "CONSUMING"
    COMMITTING = "COMMITTING"
    STOPPED = "STOPPED"
    ERROR = "ERROR"

    def __init__(
        self,
        table: str,
        schema: Schema,
        table_config: TableConfig,
        partition: int,
        consumer_factory,
        decoder: Callable,
        checkpoint: CheckpointStore,
        segment_dir: str,
        on_consuming_segment: Callable,    # (partition, MutableSegment) -> None
        on_committed_segment: Callable,    # (partition, mutable, immutable) -> None
        upsert_manager: Optional[PartitionUpsertMetadataManager] = None,
        fetch_timeout_ms: int = 100,
        idle_sleep_s: float = 0.02,
        completion=None,  # SegmentCompletionClient for multi-replica commit
        peer_fetch=None,  # (segment_name, dest_dir) -> path; deep-store-down fallback
    ):
        self.table = table
        self.schema = schema
        self.table_config = table_config
        self.partition = partition
        self.factory = consumer_factory
        self.decoder = decoder
        self.checkpoint = checkpoint
        self.segment_dir = segment_dir
        self.on_consuming_segment = on_consuming_segment
        self.on_committed_segment = on_committed_segment
        self.upsert = upsert_manager
        from pinot_tpu_torch.ingestion.transform import RecordTransformer

        self.record_transformer = RecordTransformer(table_config)
        self.partial_merger = None
        if upsert_manager is not None and table_config.upsert.mode == "PARTIAL":
            self.partial_merger = merger.PartialUpsertMerger(
                schema, table_config.upsert)
        self.fetch_timeout_ms = fetch_timeout_ms
        self.idle_sleep_s = idle_sleep_s
        self.completion = completion
        self.peer_fetch = peer_fetch
        self.adoptions = 0

        stream = table_config.stream
        self.rows_threshold = stream.segment_flush_threshold_rows
        self.time_threshold_s = stream.segment_flush_threshold_seconds
        self.state = self.CONSUMING
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.commits = 0
        self.index_errors = 0

        prior = checkpoint.committed(table, partition)
        if prior is not None:
            self._offset = StreamPartitionMsgOffset.from_string(prior["offset"])
            self._sequence = prior["sequence"] + 1
        else:
            self._offset = self.factory.earliest_offset(partition)
            self._sequence = 0
        self._new_consuming_segment()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"rt-{self.table}-p{self.partition}", daemon=True
        )
        self._thread.start()

    def stop(self, commit_remaining: bool = True, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                # consume thread still running (e.g. mid-seal): committing
                # from this thread too would double-seal the same segment
                log.warning("partition %s did not stop within %ss; skipping "
                            "final commit", self.partition, timeout)
                return
        if commit_remaining and self.segment.n_docs > 0:
            self._commit()
        self.state = self.STOPPED

    # ---- consume loop ----------------------------------------------------
    def _new_consuming_segment(self) -> None:
        name = llc_segment_name(self.table, self.partition, self._sequence,
                                self._offset.to_string())
        self.segment = MutableSegment(
            self.schema, name, self.table_config,
            enable_upsert=self.upsert is not None,
        )
        self.segment.start_offset = self._offset.to_string()
        self._segment_start_time = time.time()
        self.on_consuming_segment(self.partition, self.segment)

    def _run(self) -> None:
        consumer = self.factory.create_partition_consumer(self.partition)
        try:
            while not self._stop.is_set():
                try:
                    batch = consumer.fetch_messages(self._offset, self.fetch_timeout_ms)
                except Exception as e:  # flaky stream: retry from checkpointed offset
                    log.warning("partition %s consumer error: %s; recreating", self.partition, e)
                    time.sleep(self.idle_sleep_s)
                    try:
                        consumer.close()
                    except Exception:
                        pass
                    consumer = self.factory.create_partition_consumer(self.partition)
                    continue
                if self.upsert is None:
                    # columnar batch path (chunklet subsystem ingest basis):
                    # decode + transform per row, ONE index_batch per fetch
                    self._index_message_batch(batch.messages)
                else:
                    # upsert: the primary-key CAS is inherently per-row
                    for msg in batch.messages:
                        # poison messages must not wedge the partition: skip
                        # and count (the reference skips undecodable rows
                        # the same way); the offset still advances past
                        # them. Transform failures are CONFIG bugs, not bad
                        # data — those kill the partition loudly (ERROR
                        # state) instead of silently draining the stream
                        try:
                            row = self.decoder(msg.payload)
                            self._index_row(row, msg)
                        except TransformError:
                            raise
                        except Exception as e:  # noqa: BLE001
                            self._note_bad_message(msg, e)
                if len(batch) > 0:
                    self._offset = batch.next_offset
                    ci = self.segment.chunklet_index
                    if ci is not None:
                        # incremental seal: promote every full frozen block
                        # so queries ride the device path while consuming.
                        # Promotion failure is NON-FATAL: the rows are
                        # already indexed and keep serving from the host
                        # tail; the next batch retries
                        try:
                            ci.promote()
                        except Exception:  # noqa: BLE001 — optimization
                            log.exception(
                                "chunklet promotion failed for %s; rows "
                                "stay on the host tail path",
                                self.segment.name)
                else:
                    time.sleep(self.idle_sleep_s)
                if self._should_flush():
                    self.state = self.COMMITTING
                    self._commit()
                    self._new_consuming_segment()
                    self.state = self.CONSUMING
        except Exception:
            self.state = self.ERROR
            log.exception("partition %s consume loop died", self.partition)
        finally:
            consumer.close()

    def _note_bad_message(self, msg, e) -> None:
        self.index_errors += 1
        if self.index_errors <= 10 or self.index_errors % 1000 == 0:
            log.warning(
                "partition %s: dropping bad message at %s: %s",
                self.partition, getattr(msg, "offset", "?"), e,
            )

    def _index_message_batch(self, messages) -> None:
        """Non-upsert fetch handling: decode + transform row by row (poison
        rows skip, TransformError still kills the partition), then index
        the survivors through ONE columnar index_batch. A batch-level
        failure falls back to row-at-a-time so a single bad row is counted
        alone instead of dropping its whole fetch."""
        rows = []
        for msg in messages:
            try:
                row = self.decoder(msg.payload)
                if self.record_transformer.active:
                    row = self.record_transformer.apply_row(row)
                    if row is None:
                        continue  # filter_function dropped the record
                rows.append(row)
            except TransformError:
                raise
            except Exception as e:  # noqa: BLE001
                self._note_bad_message(msg, e)
        if not rows:
            return
        try:
            self.segment.index_batch(rows)
        except Exception:  # noqa: BLE001 — isolate the poison row
            for row in rows:
                try:
                    self.segment.index(row)
                except Exception as e:  # noqa: BLE001
                    self._note_bad_message(None, e)

    def _index_row(self, row: dict, msg) -> None:
        if self.record_transformer.active:
            row = self.record_transformer.apply_row(row)
            if row is None:
                return  # filter_function dropped the record
        if self.upsert is not None:
            key = tuple(row[k] for k in self.schema.primary_key_columns)
            cmp_col = self.upsert.comparison_column
            cmp_val = row.get(cmp_col) if cmp_col else msg.offset.value
            if self.partial_merger is not None:
                prev = self.upsert.get_location(key)
                # out-of-order events don't merge (the CAS below drops them),
                # mirroring the reference's ordered partial-upsert contract
                if prev is not None and (
                    cmp_col is None or cmp_val >= prev.comparison_value
                ):
                    prev_row = merger.read_row(
                        prev.segment, prev.doc_id, self.schema.column_names())
                    row = self.partial_merger.merge(prev_row, row)
            doc_id = self.segment.index(row)
            self.upsert.add_record(self.segment, doc_id, key, cmp_val)
        else:
            self.segment.index(row)

    def _should_flush(self) -> bool:
        if self.segment.n_docs >= self.rows_threshold:
            return True
        return (
            self.segment.n_docs > 0
            and time.time() - self._segment_start_time >= self.time_threshold_s
        )

    def _commit(self) -> None:
        """Seal → checkpoint → publish (the commit protocol).

        Checkpoint BEFORE publishing: a crash between the two must not leave
        a live registered segment whose offset range the restarted consumer
        re-consumes into a duplicate segment (double counting). The sealed
        dir + checkpoint entry are the durable commit — the reference makes
        segment metadata + offset one atomic ZK write; here restart
        reconciliation (RealtimeTableDataManager.start) republishes a
        committed-but-unpublished segment.

        With a completion client (multi-replica consumption), the commit is
        arbitrated first: exactly one replica builds the segment, the rest
        adopt its output (SegmentCompletionManager FSM semantics)."""
        mutable = self.segment
        mutable.end_offset = self._offset.to_string()
        if self.completion is not None:
            from pinot_tpu_torch.realtime.completion import CommitOutcome

            outcome, entry = self.completion.arbitrate(
                self.partition, self._sequence, mutable.segment_name, self._stop
            )
            if outcome == CommitOutcome.ABORT:
                return  # shutting down while holding: leave rows unconsumed
            if outcome == CommitOutcome.ADOPT:
                self._adopt_committed(entry)
                return
        out = os.path.join(self.segment_dir, mutable.segment_name)
        sealed = mutable.seal(out)
        self.checkpoint.record_commit(
            self.table, self.partition, mutable.segment_name,
            self._offset.to_string(), self._sequence,
        )
        if self.completion is not None:
            self.completion.finish(
                self.partition, self._sequence, mutable.segment_name, out,
                self._offset.to_string(),
            )
        if self.upsert is not None:
            self.upsert.replace_segment(mutable, sealed)
        self.on_committed_segment(self.partition, mutable, sealed)
        self._sequence += 1
        self.commits += 1

    def _adopt_committed(self, entry: dict) -> None:
        """HOLDING replica path: another replica won the commit — discard
        the local in-progress rows, copy its sealed segment, resume from its
        end offset (the reference's download-and-replace)."""
        from pinot_tpu_torch.realtime.completion import adopt_segment
        from pinot_tpu_torch.storage.segment import ImmutableSegment

        try:
            local = adopt_segment(entry, self.segment_dir)
        except OSError:
            # the winner's published location is unreachable (deep store /
            # shared FS down): fetch from a serving replica over the data
            # plane instead (PeerServerSegmentFinder role, server/peer.py)
            if self.peer_fetch is None:
                raise
            local = self.peer_fetch(
                entry["segment"],
                os.path.join(self.segment_dir, entry["segment"]))
        sealed = ImmutableSegment(local)
        self._offset = StreamPartitionMsgOffset.from_string(entry["offset"])
        self.checkpoint.record_commit(
            self.table, self.partition, entry["segment"], entry["offset"],
            self._sequence,
        )
        self.on_committed_segment(self.partition, self.segment, sealed)
        self._sequence += 1
        self.adoptions += 1


class RealtimeTableDataManager:
    """All partitions of one realtime table (RealtimeTableDataManager.java),
    wired to a query-engine TableDataManager so consuming rows are
    immediately queryable."""

    def __init__(self, schema: Schema, table_config: TableConfig,
                 engine_table, data_dir: str, completion_client=None,
                 peer_fetch=None):
        if table_config.stream is None:
            raise ValueError("realtime table needs a stream config")
        self.schema = schema
        self.table_config = table_config
        self.engine_table = engine_table  # engine.TableDataManager
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.checkpoint = CheckpointStore(os.path.join(data_dir, "checkpoints.json"))
        self.partition_managers: dict[int, RealtimePartitionManager] = {}
        self.upsert_managers: dict[int, PartitionUpsertMetadataManager] = {}
        self._factory = create_consumer_factory(table_config.stream)
        self._decoder = get_decoder(table_config.stream.decoder, table_config.stream)
        self.completion = completion_client  # multi-replica commit FSM
        self.peer_fetch = peer_fetch  # deep-store-down adopt fallback
        self._on_commit_cb = None
        self._on_consuming_cb = None

    def start(self, partitions=None, on_commit=None, on_consuming=None) -> None:
        """``partitions``: subset to consume (cluster mode: only the
        partitions assigned to this server); callbacks let the server layer
        publish segment state to the cluster registry."""
        self._on_commit_cb = on_commit
        self._on_consuming_cb = on_consuming
        parts = list(partitions) if partitions is not None \
            else range(self._factory.partition_count())
        for p in parts:
            self.add_partition(p)

    def add_partition(self, p: int) -> None:
        """Start consuming one partition (idempotent) — called at start and
        when the controller reassigns a dead server's partitions here."""
        if p in self.partition_managers:
            return
        upsert = None
        if self.table_config.upsert.mode != "NONE":
            if not self.schema.primary_key_columns:
                raise ValueError("upsert requires schema primaryKeyColumns")
            upsert = PartitionUpsertMetadataManager(
                self.table_config.upsert.comparison_column
            )
            self.upsert_managers[p] = upsert
        self._reconcile_committed(p, upsert)
        mgr = RealtimePartitionManager(
            table=self.table_config.table_name,
            schema=self.schema,
            table_config=self.table_config,
            partition=p,
            consumer_factory=self._factory,
            decoder=self._decoder,
            checkpoint=self.checkpoint,
            segment_dir=self.data_dir,
            on_consuming_segment=self._on_consuming,
            on_committed_segment=self._on_committed,
            upsert_manager=upsert,
            completion=self.completion,
            peer_fetch=self.peer_fetch,
        )
        self.partition_managers[p] = mgr
        mgr.start()

    def stop_partition(self, p: int) -> None:
        """Stop consuming a partition (reassigned away): uncommitted rows
        are dropped — the new owner re-consumes from the last commit."""
        mgr = self.partition_managers.pop(p, None)
        if mgr is not None:
            mgr.stop(commit_remaining=False)
            self.engine_table.remove_segment(mgr.segment.segment_name)

    def stop(self, commit_remaining: bool = True) -> None:
        for mgr in self.partition_managers.values():
            mgr.stop(commit_remaining=commit_remaining)

    def _sealed_on_disk(self, partition: int) -> list:
        """(sequence, name) of this partition's sealed segment dirs, in
        commit order (LLCSegmentName: table__partition__sequence__ts)."""
        prefix = f"{self.table_config.table_name}__{partition}__"
        out = []
        try:
            entries = os.listdir(self.data_dir)
        except OSError:
            return []
        for name in entries:
            if not name.startswith(prefix):
                continue
            if not os.path.isdir(os.path.join(self.data_dir, name)):
                continue
            try:
                seq = int(name.split("__")[2])
            except (IndexError, ValueError):
                continue
            out.append((seq, name))
        out.sort()
        return out

    def _reconcile_committed(self, partition: int, upsert=None) -> None:
        """Restart reconciliation, two duties:

        1. Crash-window repair: if the checkpoint names a sealed segment that
           exists on disk but was never registered (crash after record_commit,
           before publication), publish it now.
        2. Upsert replay: sealed dirs hold ALL rows with no persisted
           validDocIds, and the server layer's registry sync loads them with
           bare add_segment — so replay EVERY sealed segment's primary keys
           through the fresh upsert manager, in commit (sequence) order, so
           stale duplicates are re-invalidated and later stream updates keep
           invalidating them."""
        from pinot_tpu_torch.storage.segment import ImmutableSegment

        prior = self.checkpoint.committed(self.table_config.table_name, partition)
        if prior is None:
            return
        committed_seq = prior["sequence"]
        committed_name = prior["segment"]
        engine_segs = getattr(self.engine_table, "segments", {})
        cmp_base = 0  # running doc base across sealed segments (commit order)
        for seq, name in self._sealed_on_disk(partition):
            if seq > committed_seq:
                continue  # sealed dir past the checkpoint: orphan, not committed
            expected = self.checkpoint.committed_name(
                self.table_config.table_name, partition, seq
            )
            if expected is None and seq == committed_seq:
                expected = committed_name  # legacy checkpoint without names log
            if expected is not None and name != expected:
                # orphan from a crash between seal() and record_commit(): the
                # later re-consumed committed segment shares this sequence
                # (names embed a creation timestamp, so they differ), and its
                # rows are duplicates of the committed one's — quarantine it
                # so neither this pass nor future restarts publish or replay
                # it (an orphan at an OLDER sequence would otherwise inflate
                # cmp_base and make replayed stale rows beat live updates)
                log.warning("partition %s: quarantining orphan segment %s "
                            "(committed name at seq %s is %s)",
                            partition, name, seq, expected)
                orphans = os.path.join(self.data_dir, "_orphans")
                os.makedirs(orphans, exist_ok=True)
                os.replace(os.path.join(self.data_dir, name),
                           os.path.join(orphans, name))
                continue
            # Replay must target the instance the engine queries (the
            # valid_docs_mask attaches to the object), not a fresh load.
            existing = engine_segs.get(name)
            sealed = existing
            if sealed is None:
                sealed = ImmutableSegment(os.path.join(self.data_dir, name))
            if upsert is not None:
                pk_cols = [sealed.values(c) for c in self.schema.primary_key_columns]
                keys = list(zip(*pk_cols))
                if upsert.comparison_column is not None:
                    cmps = sealed.values(upsert.comparison_column)
                else:
                    # doc order == offset order, but only WITHIN a segment:
                    # offset the range by the docs replayed so far so a later
                    # segment's rows compare greater than an earlier one's
                    # (live ingestion uses the global stream offset, which is
                    # >= total replayed docs on resume)
                    cmps = range(cmp_base, cmp_base + sealed.n_docs)
                upsert.add_segment(sealed, keys, cmps)
            cmp_base += sealed.n_docs
            if existing is None and (upsert is not None or seq == committed_seq):
                # non-upsert: only the checkpointed segment can be in the
                # crash window; earlier ones come from the registry sync
                self._publish_committed(partition, sealed)

    # ---- engine wiring ---------------------------------------------------
    def _on_consuming(self, partition: int, segment: MutableSegment) -> None:
        self.engine_table.add_segment(segment)
        cb = getattr(self, "_on_consuming_cb", None)
        if cb is not None:
            cb(self.table_config.table_name, partition, segment)

    def _on_committed(self, partition: int, mutable, sealed) -> None:
        if mutable is not None and mutable.segment_name != sealed.name:
            # adopted segment under a different name: drop the discarded
            # consuming segment so its rows don't double-count
            self.engine_table.remove_segment(mutable.segment_name)
        self._publish_committed(partition, sealed)

    def _publish_committed(self, partition: int, sealed) -> None:
        # same segment name: registering the sealed segment atomically
        # replaces the consuming one in the table's dict
        self.engine_table.add_segment(sealed)
        cb = getattr(self, "_on_commit_cb", None)
        if cb is not None:
            cb(self.table_config.table_name, partition, sealed)

    def total_docs_indexed(self) -> int:
        return sum(m.segment.n_docs for m in self.partition_managers.values())
