"""Generic persistent tasks: cluster-state-backed jobs that survive
node loss and master failover.

Reference: persistent/PersistentTasksClusterService.java:50 +
PersistentTasksNodeService — ONE reusable framework for long-lived jobs:
tasks are registered in cluster-state metadata, the elected master
assigns each to a live node, the assigned node runs the registered
executor, and reassignment happens automatically when the assignee
leaves. Round 3's features (transforms, watcher, CCR, ML jobs) each
hand-rolled this pattern; this module is the generic service they (and
new features) can build on.

Task lifecycle:
  submit(id, name, params)     -> stored unassigned in custom metadata
  master tick                  -> assignment {node_id} written to state
  assignee tick                -> registered executor(name) instantiated
                                  and start()ed locally
  update_state(id, body)       -> arbitrary progress state replicated
  complete(id)                 -> entry removed; every node stop()s it
  assignee leaves the cluster  -> master reassigns; the new node starts
                                  from the replicated task state
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

SECTION = "persistent_tasks"
POLL_INTERVAL = 2.0


class PersistentTasksService:
    """Master-side assignment + node-side execution, one service."""

    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        # task_name -> factory(task_id, params, service) -> runner with
        # start()/stop() (the PersistentTasksExecutor registry)
        self._executors: Dict[str, Callable] = {}
        # task_id -> runner instances running on THIS node
        self.local_running: Dict[str, Any] = {}
        self._rr = 0

    # -- SPI ---------------------------------------------------------------

    def register_executor(self, task_name: str, factory: Callable) -> None:
        if task_name in self._executors:
            raise ValueError(
                f"executor already registered for [{task_name}]")
        self._executors[task_name] = factory

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._schedule()

    def stop(self) -> None:
        self._running = False
        if self._timer is not None:
            self._timer.cancel()
        for task_id in list(self.local_running):
            self._stop_local(task_id)

    def _schedule(self) -> None:
        if not self._running:
            return
        self._timer = self.node.scheduler.schedule(POLL_INTERVAL,
                                                   self._tick)

    def _tick(self) -> None:
        if not self._running:
            return
        try:
            if self.node.coordinator.mode == "LEADER":
                self.assign_pass()
            self.reconcile_local()
        except Exception:  # noqa: BLE001 — the loop must survive anything
            logger.exception("persistent tasks tick failed")
        self._schedule()

    # -- state access ------------------------------------------------------

    def tasks(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(SECTION, {}))

    # -- API ---------------------------------------------------------------

    def submit(self, task_id: str, task_name: str,
               params: Optional[Dict[str, Any]], on_done) -> None:
        """Register a task; the master assigns it on its next pass. The
        duplicate check happens master-side against authoritative state
        (create-only semantics), so retries cannot clobber a live task."""
        from elasticsearch_tpu_torch.action.admin import PERSISTENT_UPDATE
        if task_name not in self._executors:
            on_done(None, ValueError(
                f"no executor registered for task type [{task_name}]"))
            return
        self.node.master_client.execute(PERSISTENT_UPDATE, {
            "task_id": task_id,
            "create": {"task_name": task_name,
                       "params": dict(params or {}),
                       "assignment": None, "state": {}}}, on_done)

    def complete(self, task_id: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": SECTION, "name": task_id}, on_done)

    def update_state(self, task_id: str, state: Dict[str, Any],
                     on_done) -> None:
        """Replicate task progress (PersistentTaskState analog) so a
        reassigned runner resumes from it. Field-level merge on the
        master (PERSISTENT_UPDATE): a caller-side read-modify-write
        would race a concurrent reassignment and clobber it."""
        from elasticsearch_tpu_torch.action.admin import PERSISTENT_UPDATE
        self.node.master_client.execute(PERSISTENT_UPDATE, {
            "task_id": task_id, "set": {"state": dict(state)}}, on_done)

    # -- master: assignment ------------------------------------------------

    def assign_pass(self) -> None:
        """Assign unassigned tasks; reassign tasks whose node left
        (PersistentTasksClusterService.shouldReassign)."""
        state = self.node._applied_state()
        live = sorted(state.nodes)
        if not live:
            return
        for task_id, entry in self.tasks().items():
            assignment = entry.get("assignment")
            if assignment is not None and assignment in live:
                continue
            blocked = set(entry.get("blocked_nodes") or [])
            eligible = [n for n in live if n not in blocked]
            if not eligible:
                # every live node has bounced this task: start-failures
                # are often transient, so RESET the block list and retry
                # the full rotation next pass instead of stranding the
                # task forever
                if blocked:
                    logger.warning(
                        "persistent task [%s]: all nodes blocked, "
                        "resetting for retry", task_id)
                    self._merge(task_id, {"blocked_nodes": []})
                continue
            self._rr += 1
            node_id = eligible[self._rr % len(eligible)]
            logger.info("persistent task [%s] -> node [%s]", task_id,
                        node_id)
            self._merge(task_id, {"assignment": node_id})

    def _merge(self, task_id: str, fields: Dict[str, Any]) -> None:
        from elasticsearch_tpu_torch.action.admin import PERSISTENT_UPDATE
        self.node.master_client.execute(
            PERSISTENT_UPDATE, {"task_id": task_id, "set": fields},
            lambda _r, _e: None)

    # -- node: execution ---------------------------------------------------

    def reconcile_local(self) -> None:
        """Start tasks assigned to this node; stop ones that moved away
        or completed (PersistentTasksNodeService.startTask/cancel)."""
        tasks = self.tasks()
        for task_id, entry in tasks.items():
            mine = entry.get("assignment") == self.node.node_id
            running = task_id in self.local_running
            if mine and not running:
                factory = self._executors.get(entry.get("task_name"))
                if factory is None:
                    # this node cannot run the task (executor not
                    # registered here): hand the assignment back and
                    # record the gap so the master's next pass picks a
                    # DIFFERENT node instead of stalling forever
                    blocked = sorted(set(entry.get("blocked_nodes")
                                         or []) | {self.node.node_id})
                    self._merge(task_id, {"assignment": None,
                                          "blocked_nodes": blocked})
                    continue
                try:
                    runner = factory(task_id,
                                     dict(entry.get("params") or {}),
                                     self)
                    self.local_running[task_id] = runner
                    start = getattr(runner, "start", None)
                    if start is not None:
                        start()
                except Exception:  # noqa: BLE001
                    logger.exception("persistent task [%s] failed to "
                                     "start", task_id)
                    self.local_running.pop(task_id, None)
                    # a node-local start failure pins nothing: hand the
                    # assignment back like the missing-executor case so
                    # the master tries a DIFFERENT node next pass
                    blocked = sorted(set(entry.get("blocked_nodes")
                                         or []) | {self.node.node_id})
                    self._merge(task_id, {"assignment": None,
                                          "blocked_nodes": blocked})
            elif running and not mine:
                self._stop_local(task_id)
        for task_id in [t for t in self.local_running if t not in tasks]:
            self._stop_local(task_id)

    def _stop_local(self, task_id: str) -> None:
        runner = self.local_running.pop(task_id, None)
        stop = getattr(runner, "stop", None)
        if stop is not None:
            try:
                stop()
            except Exception:  # noqa: BLE001
                logger.exception("persistent task [%s] failed to stop",
                                 task_id)
