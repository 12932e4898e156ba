"""Minion worker: claims queued tasks and runs their executors.

Equivalent of the reference's ``MinionStarter`` + ``TaskFactoryRegistry`` +
``TaskExecutorFactoryRegistry``
(pinot-minion/src/main/java/org/apache/pinot/minion/MinionStarter.java):
a stateless worker role that polls the registry task queue (replacing the
Helix task framework's assignment push), CAS-claims one task at a time,
and reports DONE/FAILED with an output message.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from pinot_tpu_torch.cluster.registry import ClusterRegistry, InstanceInfo, Role
from pinot_tpu_torch.minion.tasks import TASK_EXECUTORS, TaskContext

log = logging.getLogger("pinot_tpu_torch.minion")


class MinionWorker:
    def __init__(self, registry: ClusterRegistry, controller, work_dir: str,
                 instance_id: str = "minion_0", poll_interval_s: float = 0.2,
                 touch_interval_s: float = 5.0,
                 executors: Optional[dict] = None, device=None):
        self.instance_id = instance_id
        self.registry = registry
        # ``device``: where the tasks' device work runs, the card unless
        # the caller asks for "cpu"
        self.ctx = TaskContext(registry, controller, work_dir, device=device)
        self.poll_interval_s = poll_interval_s
        self.touch_interval_s = touch_interval_s
        self.executors = dict(TASK_EXECUTORS if executors is None else executors)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tasks_run = 0

    def start(self) -> None:
        self.registry.register_instance(InstanceInfo(self.instance_id, Role.MINION))
        self._thread = threading.Thread(
            target=self._loop, name=f"minion-{self.instance_id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10)
        self.registry.drop_instance(self.instance_id)

    def run_one(self) -> Optional[dict]:
        """Claim and execute a single task synchronously; returns the
        finished task dict (with output) or None if the queue is empty."""
        task = self.registry.claim_task(self.instance_id,
                                        list(self.executors))
        if task is None:
            return None
        # heartbeat the claim while executing so the controller's stale-task
        # sweep never requeues live work (only genuinely dead claims age out)
        stop_touch = threading.Event()

        def _toucher():
            while not stop_touch.wait(self.touch_interval_s):
                self.registry.touch_task(task["id"])

        toucher = threading.Thread(
            target=_toucher, name=f"touch-{task['id']}", daemon=True
        )
        toucher.start()
        try:
            output = self.executors[task["type"]](self.ctx, task)
            ok = True
        except Exception as e:  # noqa: BLE001 — task failures are data
            log.exception("task %s failed", task["id"])
            output = f"{type(e).__name__}: {e}"
            ok = False
        finally:
            stop_touch.set()
            toucher.join(1)
        self.registry.finish_task(task["id"], ok, output)
        from pinot_tpu_torch.common.metrics import get_metrics

        get_metrics("minion").count(
            "tasksCompleted" if ok else "tasksFailed", tag=task["type"])
        self.tasks_run += 1
        task.update(state="DONE" if ok else "FAILED", output=output)
        return task

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.run_one() is not None:
                    continue  # drain the queue without sleeping
            except Exception:
                log.exception("minion loop error")
            self.registry.heartbeat(self.instance_id)
            self._stop.wait(self.poll_interval_s)
