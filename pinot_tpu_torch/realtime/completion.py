"""Segment-completion protocol client: multi-replica commit coordination.

A copy of pinot_tpu/realtime/completion.py for the port: the analog of
the reference's controller-side
SegmentCompletionManager FSM (pinot-controller/.../core/realtime/
SegmentCompletionManager.java) plus the server-side commit steps of
LLRealtimeSegmentDataManager (HOLDING / COMMITTING / adopt-committed):

- every replica of a stream partition consumes independently;
- the first replica to hit its flush threshold CAS-claims the commit for
  (partition, sequence) in the cluster registry;
- the winner seals its rows, durably records the segment, and marks the
  entry DONE with the segment location + end offset;
- losers HOLD (poll), then ADOPT the committed segment: discard their
  in-progress rows, copy the winner's sealed dir, resume consuming from the
  winner's end offset — the reference's "download and replace" path;
- if the committer dies mid-build the entry goes stale and a holder takes
  over (the reference's committer-timeout re-election).
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional


class CommitOutcome:
    WON = "WON"          # this replica builds + publishes the segment
    ADOPT = "ADOPT"      # another replica committed: adopt its segment
    ABORT = "ABORT"      # shutdown requested while holding


class SegmentCompletionClient:
    """Registry-backed completion FSM, one per (server, realtime table)."""

    def __init__(self, registry, table: str, instance_id: str,
                 stale_ms: int = 5_000, poll_s: float = 0.05,
                 hold_timeout_s: float = 30.0):
        self.registry = registry
        self.table = table
        self.instance_id = instance_id
        self.stale_ms = stale_ms
        self.poll_s = poll_s
        self.hold_timeout_s = hold_timeout_s

    def arbitrate(self, partition: int, sequence: int, segment_name: str,
                  stop_event=None):
        """Blocks until this replica either WINS the commit or can ADOPT a
        committed segment. Returns (outcome, entry)."""
        entry = self.registry.try_claim_commit(
            self.table, partition, sequence, self.instance_id, segment_name
        )
        if entry["committer"] == self.instance_id and entry["state"] == "COMMITTING":
            return CommitOutcome.WON, entry
        # HOLDING: wait for the winner, taking over if it goes stale
        deadline = time.time() + self.hold_timeout_s
        while time.time() < deadline:
            if stop_event is not None and stop_event.is_set():
                return CommitOutcome.ABORT, entry
            entry = self.registry.takeover_commit(
                self.table, partition, sequence, self.instance_id, self.stale_ms
            )
            if entry["state"] == "DONE":
                return CommitOutcome.ADOPT, entry
            if entry["committer"] == self.instance_id:
                return CommitOutcome.WON, entry  # takeover: dead committer
            time.sleep(self.poll_s)
        raise TimeoutError(
            f"segment completion for {self.table} p{partition} seq{sequence} "
            f"never resolved (committer {entry['committer']})"
        )

    def finish(self, partition: int, sequence: int, segment_name: str,
               location: str, end_offset: str) -> bool:
        return self.registry.finish_commit(
            self.table, partition, sequence, self.instance_id, segment_name,
            location, end_offset
        )

    def committed_entry(self, partition: int, sequence: int) -> Optional[dict]:
        e = self.registry.commit_entry(self.table, partition, sequence)
        return e if e is not None and e["state"] == "DONE" else None


def adopt_segment(entry: dict, dest_dir: str) -> str:
    """Copy the committed segment dir into this server's data dir (the
    download-from-deep-store step). Returns the local path."""
    dest = os.path.join(dest_dir, entry["segment"])
    src = entry["location"]
    if os.path.abspath(src) != os.path.abspath(dest):
        if os.path.exists(dest):
            shutil.rmtree(dest)
        shutil.copytree(src, dest)
    return dest
