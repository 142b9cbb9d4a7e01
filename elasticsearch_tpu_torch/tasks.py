"""Task management: every long-running operation is a listable,
cancellable task.

Reference analogs: tasks/TaskManager.java:76 (per-node registry, parent →
child chains across nodes), CancellableTask.java:30 (cooperative
cancellation flag checked inside hot loops), the _tasks list/cancel APIs.
Cancellation here is cooperative too: task code calls
``ensure_not_cancelled()`` at loop boundaries (the search phase checks it
between segments, reindex between batches).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import (
    ResourceNotFoundError, SearchEngineError, TaskCancelledError,
)

LIST_TASKS = "cluster:monitor/tasks/lists"
CANCEL_TASKS = "cluster:admin/tasks/cancel"
GET_TASK = "cluster:monitor/task/get"


class Task:
    def __init__(self, task_id: str, action: str, description: str,
                 cancellable: bool, parent_task_id: Optional[str],
                 start_time_ms: float):
        self.task_id = task_id
        self.action = action
        self.description = description
        self.cancellable = cancellable
        self.parent_task_id = parent_task_id
        self.start_time_ms = start_time_ms
        self._cancelled = threading.Event()
        self.cancel_reason: Optional[str] = None
        self.status: Optional[Dict[str, Any]] = None   # progress payload

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self, reason: str = "by user request") -> None:
        self.cancel_reason = reason
        self._cancelled.set()

    def ensure_not_cancelled(self) -> None:
        if self.cancelled:
            raise TaskCancelledError(
                f"task [{self.task_id}] was cancelled: "
                f"{self.cancel_reason}")

    def to_dict(self) -> Dict[str, Any]:
        node, _, num = self.task_id.partition(":")
        out = {"node": node, "id": int(num) if num.isdigit() else num,
               "action": self.action, "description": self.description,
               "start_time_in_millis": int(self.start_time_ms),
               "cancellable": self.cancellable,
               "cancelled": self.cancelled}
        if self.parent_task_id:
            out["parent_task_id"] = self.parent_task_id
        if self.status is not None:
            out["status"] = self.status
        return out


class TaskManager:
    """Per-node task registry (TaskManager.java:76)."""

    def __init__(self, node_id: str,
                 now_ms: Optional[Callable[[], float]] = None):
        self.node_id = node_id
        self._seq = itertools.count(1)
        self._tasks: Dict[str, Task] = {}
        self._lock = threading.Lock()
        import time
        self._now_ms = now_ms or (lambda: time.time() * 1000)

    def now_ms(self) -> float:
        """This registry's clock (scheduler time on a node) — hot-spans
        elapsed times must read the SAME clock start_time_ms uses."""
        return self._now_ms()

    def register(self, action: str, description: str = "",
                 cancellable: bool = False,
                 parent_task_id: Optional[str] = None) -> Task:
        task_id = f"{self.node_id}:{next(self._seq)}"
        task = Task(task_id, action, description, cancellable,
                    parent_task_id, self._now_ms())
        with self._lock:
            self._tasks[task_id] = task
        return task

    def unregister(self, task: Task) -> None:
        with self._lock:
            self._tasks.pop(task.task_id, None)

    def get(self, task_id: str) -> Optional[Task]:
        with self._lock:
            return self._tasks.get(task_id)

    def list(self, actions: Optional[str] = None) -> List[Task]:
        import fnmatch
        with self._lock:
            tasks = list(self._tasks.values())
        if actions:
            patterns = [a.strip() for a in actions.split(",")]
            tasks = [t for t in tasks
                     if any(fnmatch.fnmatch(t.action, p)
                            for p in patterns)]
        return tasks

    def cancel(self, task_id: str, reason: str = "by user request"
               ) -> Task:
        task = self.get(task_id)
        if task is None:
            raise ResourceNotFoundError(
                f"task [{task_id}] is not found")
        if not task.cancellable:
            raise SearchEngineError(
                f"task [{task_id}] is not cancellable")
        task.cancel(reason)
        # cancel local children too (ban propagation, simplified to the
        # local registry; cross-node children carry parent_task_id and
        # are cancelled by the broadcast in TaskActions)
        for t in self.list():
            if t.parent_task_id == task_id and t.cancellable:
                t.cancel(reason)
        return task


class TaskActions:
    """Cluster-wide list/cancel: fan out to every node's registry."""

    def __init__(self, node):
        self.node = node
        ts = node.transport_service
        ts.register_handler(LIST_TASKS, self._on_list)
        ts.register_handler(CANCEL_TASKS, self._on_cancel)
        ts.register_handler(GET_TASK, self._on_get)

    def _on_get(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        task_id = req["task_id"]
        task = self.node.task_manager.get(task_id)
        if task is not None:
            return {"completed": False, "task": task.to_dict()}
        result = self.node.task_results.get(task_id)
        if result is not None:
            node, _, num = task_id.partition(":")
            return {"completed": True,
                    "task": {"node": node,
                             "id": int(num) if num.isdigit() else num},
                    "response": result}
        raise ResourceNotFoundError(f"task [{task_id}] is not found")

    def _on_list(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        return {"tasks": [t.to_dict() for t in
                          self.node.task_manager.list(
                              req.get("actions"))]}

    def _on_cancel(self, req: Dict[str, Any], sender: str
                   ) -> Dict[str, Any]:
        tm = self.node.task_manager
        cancelled = []
        not_cancellable = []
        if req.get("task_id"):
            tid = req["task_id"]
            task = tm.get(tid)
            if task is not None:
                if task.cancellable:
                    cancelled.append(tm.cancel(tid).to_dict())
                else:
                    not_cancellable.append(tid)
            # the task's children may run on THIS node while the parent
            # lives on the coordinator (cross-node ban propagation)
            for t in tm.list():
                if t.parent_task_id == tid and t.cancellable \
                        and not t.cancelled:
                    t.cancel()
                    cancelled.append(t.to_dict())
        else:
            for t in tm.list(req.get("actions")):
                if t.cancellable and not t.cancelled:
                    t.cancel()
                    cancelled.append(t.to_dict())
        return {"tasks": cancelled, "not_cancellable": not_cancellable}

    # -- coordinating side ----------------------------------------------

    def _fan_out(self, action: str, req: Dict[str, Any],
                 on_done: Callable[[Dict[str, Any]], None],
                 raw_sink: Optional[Dict[str, Any]] = None) -> None:
        state = self.node._applied_state()
        node_ids = list(state.nodes) or [self.node.node_id]
        results: Dict[str, Any] = {}
        pending = {"n": len(node_ids)}

        def one(nid: str) -> None:
            def cb(resp, err):
                if err is None and resp is not None:
                    results[nid] = resp["tasks"]
                    if raw_sink is not None:
                        raw_sink[nid] = resp
                pending["n"] -= 1
                if pending["n"] == 0:
                    on_done(results)
            self.node.transport_service.send_request(nid, action, req, cb,
                                                     timeout=30.0)
        for nid in node_ids:
            one(nid)

    def list_tasks(self, on_done, actions: Optional[str] = None) -> None:
        def done(results: Dict[str, Any]) -> None:
            nodes_out = {}
            for nid, tasks in results.items():
                if tasks:
                    nodes_out[nid] = {"tasks": {
                        f"{t['node']}:{t['id']}": t for t in tasks}}
            on_done({"nodes": nodes_out}, None)
        self._fan_out(LIST_TASKS, {"actions": actions}, done)

    def cancel_tasks(self, on_done, task_id: Optional[str] = None,
                     actions: Optional[str] = None) -> None:
        req = {"task_id": task_id, "actions": actions}
        raw: Dict[str, Any] = {}

        def done(results: Dict[str, Any]) -> None:
            per_node = {nid: tasks for nid, tasks in results.items()}
            all_cancelled = [t for tasks in per_node.values()
                             for t in tasks]
            not_cancellable = [tid for resp in raw.values()
                               for tid in resp.get("not_cancellable", [])]
            if task_id and not all_cancelled:
                if not_cancellable:
                    on_done(None, SearchEngineError(
                        f"task [{task_id}] is not cancellable"))
                    return
                on_done(None, ResourceNotFoundError(
                    f"task [{task_id}] is not found"))
                return
            on_done({"nodes": {
                nid: {"tasks": {f"{t['node']}:{t['id']}": t
                                for t in tasks}}
                for nid, tasks in per_node.items() if tasks}}, None)
        self._fan_out(CANCEL_TASKS, req, done, raw_sink=raw)

    def get_task(self, task_id: str, on_done) -> None:
        """Resolve a task on whichever node owns it (id prefix)."""
        owner, _, _ = task_id.partition(":")
        state = self.node._applied_state()
        if owner == self.node.node_id or owner not in state.nodes:
            try:
                on_done(self._on_get({"task_id": task_id},
                                     self.node.node_id), None)
            except SearchEngineError as e:
                on_done(None, e)
            return
        self.node.transport_service.send_request(
            owner, GET_TASK, {"task_id": task_id},
            lambda resp, err: on_done(resp, err), timeout=30.0)
