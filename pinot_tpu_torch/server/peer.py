"""Peer segment download: fetch a segment from a serving replica when the
deep-store copy is unreachable.

Reference: PeerServerSegmentFinder
(pinot-core/.../util/PeerServerSegmentFinder.java:1) — on download
failure, the reference resolves ONLINE replicas from the external view
and fetches the segment over the data plane instead of the deep store
(exercised by PeerDownloadLLCRealtimeClusterIntegrationTest). Here the
fetch rides a FetchSegment gRPC method on the existing query transport:
the serving peer streams a tar of the segment dir.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tarfile

log = logging.getLogger("pinot_tpu_torch.server.peer")

_CHUNK = 256 * 1024


def serve_segment_tar(server, request: bytes):
    """Server-side FetchSegment handler: stream a tar of a segment this
    instance serves. The refcount acquire keeps the dir alive for the
    duration (a concurrent unload defers its teardown past the stream)."""
    req = json.loads(request.decode("utf-8"))
    table, name = req["table"], req["segment"]
    tdm = server.engine.tables.get(table)
    if tdm is None:
        raise KeyError(f"table {table!r} not hosted")
    acquired = tdm.acquire()
    try:
        seg = next((s for s in acquired if s.name == name), None)
        if seg is None or getattr(seg, "is_mutable", False) \
                or getattr(seg, "is_cold", False):
            # a cold-tier placeholder has no plane files to serve — a
            # peer must fall through to a replica that still holds them
            raise KeyError(f"segment {name!r} not served here")
        # spool to a temp FILE, not RAM: a multi-GB segment tar held on
        # heap while also serving queries is an OOM hazard exactly when
        # many replicas fall back at once (deep-store outage)
        import tempfile

        with tempfile.TemporaryFile(prefix="peer_tar_") as spool:
            with tarfile.open(fileobj=spool, mode="w") as tar:
                tar.add(seg.dir, arcname=name)
            spool.seek(0)
            while True:
                chunk = spool.read(_CHUNK)
                if not chunk:
                    break
                yield chunk
    finally:
        tdm.release(acquired)


def peer_download(registry, table: str, name: str, dest_dir: str,
                  self_id: str, tls=None, timeout_s: float = 60.0,
                  deadline=None) -> str:
    """Try every ONLINE replica of (table, segment) from the external view
    (excluding ``self_id``); untar the first successful stream into
    ``dest_dir`` (the caller's final path — may carry a CRC-versioned
    dirname). Returns ``dest_dir``; raises RuntimeError when no peer can
    serve it.

    ``deadline`` (common/deadline.py Deadline, optional): the CALLER's
    budget — each replica attempt's stream timeout is clamped to the
    remaining window (previously a fixed 60 s per replica, so a hung
    peer chain could stall a caller for minutes), and no further replica
    is tried once it expires. A mid-stream timeout cleans up the
    partially-written download the same way the ``os.replace``-failure
    path does: the extraction dir is removed in the per-candidate
    ``finally`` and the spool is a TemporaryFile that never survives the
    attempt."""
    from pinot_tpu_torch.common import faults
    from pinot_tpu_torch.transport.grpc_transport import QueryRouterChannel

    ev = registry.external_view(table)
    candidates = [i for i in ev.get(name, ()) if i != self_id]
    infos = {i.instance_id: i for i in registry.instances()}
    req = json.dumps({"table": table, "segment": name}).encode("utf-8")
    errors = []
    for inst_id in candidates:
        if deadline is not None and deadline.expired():
            errors.append("deadline expired before trying remaining "
                          f"replicas {candidates[candidates.index(inst_id):]}")
            break
        attempt_timeout_s = timeout_s if deadline is None \
            else max(0.001, deadline.clamp(timeout_s))
        info = infos.get(inst_id)
        if info is None or not getattr(info, "grpc_port", None):
            continue
        ch = QueryRouterChannel(f"{info.host}:{info.grpc_port}", tls=tls)
        tmp = f"{dest_dir}.peer{os.getpid()}"
        try:
            if faults.ACTIVE:
                faults.inject("peer.fetch", target=inst_id)
            import tempfile

            with tempfile.TemporaryFile(prefix="peer_dl_") as spool:
                for chunk in ch.fetch_segment(
                        req, timeout_s=attempt_timeout_s):
                    spool.write(chunk)
                spool.seek(0)
                shutil.rmtree(tmp, ignore_errors=True)
                with tarfile.open(fileobj=spool, mode="r") as tar:
                    # filter="data" rejects symlink/hardlink/absolute
                    # members — a malicious peer must not write outside
                    # the target dir (hand-rolled name checks miss
                    # symlink-then-write-through sequences)
                    tar.extractall(tmp, filter="data")
            src = os.path.join(tmp, name)  # arcname was the segment name
            if os.path.isdir(dest_dir):
                # a concurrent loader finished first: keep its copy (same
                # keep-existing race semantics as _download_segment)
                return dest_dir
            os.makedirs(os.path.dirname(dest_dir), exist_ok=True)
            os.replace(src, dest_dir)
            log.info("segment %s/%s peer-downloaded from %s",
                     table, name, inst_id)
            return dest_dir
        except Exception as e:  # noqa: BLE001 — try the next replica
            errors.append(f"{inst_id}: {type(e).__name__}: {e}")
        finally:
            # the extraction dir is removed on EVERY exit — including an
            # os.replace failure after extractall, which used to leak it
            # (only the success paths cleaned up)
            shutil.rmtree(tmp, ignore_errors=True)
            ch.close()
    raise RuntimeError(
        f"peer download of {table}/{name} failed "
        f"(candidates={candidates}, errors={errors})")
