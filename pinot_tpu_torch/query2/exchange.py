"""Distributed stage-2 exchange: partition hashing, wire codec, mailbox.

The reference snapshot has NO multi-stage runtime (no
``pinot-query-runtime``; PAPER.md) — modern Pinot's equivalent is the
mailbox service (``GrpcMailboxServer`` / ``MailboxSendOperator`` /
``MailboxReceiveOperator``) that ships shuffled blocks between stage
workers. This module is our leapfrog of that machinery, shaped for the
existing transport: each participating server radix-partitions its
stage-1 rows by join-key hash, ships every partition to its owner over
the gRPC wire (``transport/grpc_transport.py`` ExchangeTransfer), and
the owner's ``ExchangeBuffer`` — the mailbox — buffers payloads until
the barrier releases the per-partition build+probe join.

Design points:

- **numpy-pure.** The broker imports ``query2/`` and must stay jax-free
  (jax-free broker is a repo invariant); everything here is numpy +
  stdlib. Device work stays in ``ops/join.py`` / ``engine/device.py``.
- **Data-independent hashing.** Broker-local SHUFFLE partitions by
  factorized key codes — codes are DATA-dependent, so two servers would
  disagree on them. ``stable_hash64`` hashes raw key VALUES with a
  fixed splitmix64 mix so every sender routes the same key to the same
  owner without coordination. Numerics canonicalize through float64
  (matching ``np.concatenate``'s dtype unification in the runner's
  factorizer, so cross-dtype equi-keys land together); collisions are
  harmless — the owner re-factorizes per partition.
- **Empty partitions ship too.** A zero-row payload still carries dtyped
  arrays, so the receiver's gather never has to invent a schema for an
  empty side (the empty-leaf dtype bug class).
- **Bounded memory.** Payloads past ``spill_limit_bytes`` spill column
  arrays to ``.npy`` files under the warm tier's spill dir and gather
  back via ``np.load(mmap_mode="r")`` — an oversized build side degrades
  to mmap'd files (the tier idea) instead of OOM. ``offer`` returns
  a ``softLimit`` flag the sender uses as backpressure.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import time
import zlib

import numpy as np

from pinot_tpu_torch.common.deadline import Deadline

__all__ = [
    "stable_hash64", "encode_transfer", "decode_transfer",
    "ExchangeTransferError", "ExchangeBuffer", "ExchangeRegistry",
]


class ExchangeTransferError(RuntimeError):
    """A partition transfer to a peer failed. ``peer`` names the
    instance so the broker's retry can exclude it from the next
    attempt's worker set (failure attribution, style)."""

    def __init__(self, peer: str, message: str):
        super().__init__(message)
        self.peer = peer


# ---------------------------------------------------------------------------
# partition hashing
# ---------------------------------------------------------------------------

_FNV_PRIME = np.uint64(0x100000001B3)
_FNV_OFFSET = np.uint64(0xCBF29CE484222325)


def _splitmix64(v: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 → well-mixed uint64."""
    with np.errstate(over="ignore"):
        v = v ^ (v >> np.uint64(30))
        v = v * np.uint64(0xBF58476D1CE4E5B9)
        v = v ^ (v >> np.uint64(27))
        v = v * np.uint64(0x94D049BB133111EB)
        v = v ^ (v >> np.uint64(31))
    return v


def stable_hash64(columns, n: int) -> np.ndarray:
    """Data-independent per-row hash of one or more key columns →
    non-negative (n,) int64. Every sender computes identical hashes for
    equal key values regardless of which rows it holds, so
    ``hash % n_partitions`` is a coordination-free routing function.

    Numeric columns canonicalize through float64 (−0.0 folded into
    +0.0) before hashing — the same unification ``np.concatenate``
    applies when the runner factorizes mixed-dtype equi-keys, so an
    int32 key equals its float64 twin here exactly when the join's
    comparator says they are equal. Strings hash per-value via crc32."""
    h = np.full(max(n, 0), _FNV_OFFSET, dtype=np.uint64)
    for col in columns:
        col = np.asarray(col)
        if col.dtype.kind in ("U", "S", "O"):
            vals = np.fromiter(
                (zlib.crc32(str(v).encode("utf-8")) for v in col),
                dtype=np.uint64, count=len(col))
        else:
            canon = col.astype(np.float64)
            # -0.0 == 0.0 must hash equal
            canon = np.where(canon == 0.0, 0.0, canon)
            vals = canon.view(np.uint64)
        with np.errstate(over="ignore"):
            h = h * _FNV_PRIME + _splitmix64(vals)
    return (_splitmix64(h) >> np.uint64(1)).astype(np.int64)


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------

_MAGIC = b"PXP1"


def _wire_array(col: np.ndarray) -> np.ndarray:
    """Object-dtype columns (python strings) can't ride npz without
    pickle; normalize to a fixed-width unicode array."""
    col = np.asarray(col)
    if col.dtype.kind == "O":
        return col.astype(str) if len(col) else col.astype("U1")
    return col


def encode_transfer(exchange_id: str, sender: str, alias: str,
                    partition: int, cols: dict, n: int, *,
                    done: bool = False, expected=None) -> bytes:
    """One exchange payload: magic + 4-byte header length + JSON header
    + npz column payload. ``done=True`` marks the sender's LAST message
    to this receiver; ``expected`` then carries
    ``{alias: {partition: payload_count}}`` so the receiver's barrier
    knows exactly how many payloads to wait for (unary RPCs from one
    sender thread are ordered, so done-last is a valid completeness
    marker)."""
    names = list(cols)
    header = {
        "id": exchange_id, "sender": sender, "alias": alias,
        "partition": int(partition), "n": int(n), "names": names,
        "done": bool(done), "expected": expected,
    }
    buf = io.BytesIO()
    np.savez(buf, **{f"c{i}": _wire_array(cols[name])
                     for i, name in enumerate(names)})
    hb = json.dumps(header).encode("utf-8")
    return _MAGIC + struct.pack("<I", len(hb)) + hb + buf.getvalue()


def decode_transfer(payload: bytes) -> dict:
    """Inverse of ``encode_transfer``: header dict with ``cols`` mapped
    back to {name: ndarray}."""
    if payload[:4] != _MAGIC:
        raise ValueError("bad exchange payload magic")
    (hlen,) = struct.unpack("<I", payload[4:8])
    header = json.loads(payload[8: 8 + hlen].decode("utf-8"))
    with np.load(io.BytesIO(payload[8 + hlen:])) as z:
        header["cols"] = {name: z[f"c{i}"]
                          for i, name in enumerate(header["names"])}
    return header


# ---------------------------------------------------------------------------
# mailbox buffer
# ---------------------------------------------------------------------------


class ExchangeBuffer:
    """One receiving server's mailbox for one exchange: accepts offered
    partition payloads (in memory, or spilled to ``.npy`` past the byte
    limit), tracks per-sender done markers, and releases ``gather`` once
    the barrier — every sender done AND every announced payload arrived
    — is met."""

    def __init__(self, exchange_id: str, spill_dir: str,
                 spill_limit_bytes: int):
        self.exchange_id = exchange_id
        self.spill_dir = spill_dir
        self.spill_limit_bytes = int(spill_limit_bytes)
        self.created_at = time.monotonic()
        self.buffered_bytes = 0
        self.spill_count = 0
        self.spilled_bytes = 0
        self._cv = threading.Condition()
        self._seq = 0
        # (alias, partition) -> [(sender, seq, kind, payload...)]
        self._slots: dict = {}
        # sender -> expected {alias: {str(partition): count}}
        self._done: dict = {}
        # (sender, alias, partition) -> payloads received
        self._counts: dict = {}
        self._spill_files: list = []
        self._closed = False

    # ---- sender side -----------------------------------------------------
    def offer(self, sender: str, alias: str, partition: int,
              cols: dict, n: int) -> dict:
        """Accept one payload. Returns backpressure/accounting flags:
        ``spilled`` when this payload went to disk, ``softLimit`` when
        the in-memory pool is running hot (sender should pace itself)."""
        norm = {}
        nbytes = 0
        for name, col in cols.items():
            col = _wire_array(col)
            norm[name] = col
            nbytes += int(col.nbytes)
        with self._cv:
            if self._closed:
                raise ExchangeTransferError(
                    "", f"exchange {self.exchange_id} already closed")
            seq = self._seq
            self._seq += 1
            spilled = (nbytes > 0 and
                       self.buffered_bytes + nbytes > self.spill_limit_bytes)
            if spilled:
                entry = ("spill", self._spill(sender, alias, partition,
                                              seq, norm), int(n))
                self.spill_count += 1
                self.spilled_bytes += nbytes
            else:
                entry = ("mem", norm, int(n))
                self.buffered_bytes += nbytes
            key = (alias, int(partition))
            self._slots.setdefault(key, []).append((sender, seq) + entry)
            ck = (sender, alias, int(partition))
            self._counts[ck] = self._counts.get(ck, 0) + 1
            soft = self.buffered_bytes >= 0.75 * self.spill_limit_bytes
            self._cv.notify_all()
        return {"ok": True, "spilled": spilled, "softLimit": soft}

    def _spill(self, sender, alias, partition, seq, cols) -> list:
        os.makedirs(self.spill_dir, exist_ok=True)
        paths = []
        for i, (name, col) in enumerate(cols.items()):
            path = os.path.join(
                self.spill_dir,
                f"{self.exchange_id}_{sender}_{alias}_{partition}"
                f"_{seq}_{i}.npy")
            np.save(path, col)
            paths.append((name, path))
            self._spill_files.append(path)
        return paths

    def mark_done(self, sender: str, expected: dict) -> None:
        with self._cv:
            self._done[sender] = expected or {}
            self._cv.notify_all()

    # ---- receiver side ---------------------------------------------------
    def _barrier_met(self, senders) -> bool:
        for s in senders:
            if s not in self._done:
                return False
            for alias, parts in self._done[s].items():
                for part, count in parts.items():
                    if self._counts.get((s, alias, int(part)), 0) < count:
                        return False
        return True

    def wait_ready(self, senders, deadline: Deadline) -> None:
        """Block until every sender's done marker and all announced
        payloads have arrived; raises QueryTimeout past the deadline so
        a lost sender can never hang the stage."""
        senders = list(senders)
        with self._cv:
            while not self._barrier_met(senders):
                deadline.check("exchange.barrier")
                self._cv.wait(timeout=min(0.05, deadline.remaining_s()))

    def gather(self, alias: str, partition: int):
        """Deterministic concatenation of every payload for one
        (alias, partition): ordered by (sender, seq) so merges are
        reproducible run-to-run. Spilled columns come back mmap'd.
        Returns (cols, n); ({}, 0) when nothing arrived (e.g. a
        partition whose every sender held zero rows AND sent nothing —
        normal senders always send, so this is belt-and-braces)."""
        with self._cv:
            entries = sorted(self._slots.get((alias, int(partition)), []),
                             key=lambda e: (e[0], e[1]))
        if not entries:
            return {}, 0
        chunks = []  # list of (cols, n)
        for sender, seq, kind, payload, n in entries:
            if kind == "mem":
                chunks.append((payload, n))
            else:
                chunks.append(({name: np.load(path, mmap_mode="r")
                                for name, path in payload}, n))
        names = list(chunks[0][0])
        total = sum(c[1] for c in chunks)
        cols = {name: np.concatenate([np.asarray(c[0][name])
                                      for c in chunks])
                for name in names}
        return cols, total

    def close(self) -> None:
        with self._cv:
            self._closed = True
            files, self._spill_files = self._spill_files, []
            self._slots.clear()
            self.buffered_bytes = 0
        for path in files:
            try:
                os.remove(path)
            except OSError:
                pass


class ExchangeRegistry:
    """Per-server map of live exchanges. ``get_or_create`` races safely
    (transfers can land before the owning ExecuteStage request does);
    an age sweep reaps mailboxes orphaned by a sender that died after
    its first transfer."""

    SWEEP_AGE_S = 600.0

    def __init__(self, spill_dir: str, spill_limit_bytes: int):
        self.spill_dir = spill_dir
        self.spill_limit_bytes = int(spill_limit_bytes)
        self._lock = threading.Lock()
        self._exchanges: dict = {}

    def get_or_create(self, exchange_id: str) -> ExchangeBuffer:
        now = time.monotonic()
        with self._lock:
            for xid in [x for x, b in self._exchanges.items()
                        if now - b.created_at > self.SWEEP_AGE_S]:
                self._exchanges.pop(xid).close()
            buf = self._exchanges.get(exchange_id)
            if buf is None:
                buf = ExchangeBuffer(exchange_id, self.spill_dir,
                                     self.spill_limit_bytes)
                self._exchanges[exchange_id] = buf
            return buf

    def release(self, exchange_id: str) -> None:
        with self._lock:
            buf = self._exchanges.pop(exchange_id, None)
        if buf is not None:
            buf.close()

    def close(self) -> None:
        with self._lock:
            bufs = list(self._exchanges.values())
            self._exchanges.clear()
        for buf in bufs:
            buf.close()
