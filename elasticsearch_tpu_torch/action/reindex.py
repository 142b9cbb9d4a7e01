"""Reindex / update-by-query / delete-by-query: batched read→write loops.

Reference analog: modules/reindex/ — scroll-read + bulk-write loops running
as cancellable tasks. The distributed search path has no scroll PIT, so
by-query operations first COLLECT the matching id worklist (from/size pages
over the not-yet-mutated index — the scroll-snapshot analog: the match set
is frozen before any write), then process it in batches fetched fresh by
ids with seq_no conflict control. Reindex pages its (never self-mutated)
source directly. Batches hop through the scheduler so cancellation and
other work interleave.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, TaskCancelledError, VersionConflictError,
)

DEFAULT_BATCH = 1000

DoneFn = Callable[[Optional[Dict[str, Any]], Optional[Exception]], None]


class _ByQueryRun:
    """Shared task/stat/finish plumbing for one operation run."""

    def __init__(self, node, action: str, description: str,
                 on_done: DoneFn, wait: bool, extra_stats: List[str]):
        self.node = node
        self.on_done = on_done
        self.wait = wait
        self.task = node.task_manager.register(action, description,
                                               cancellable=True)
        self.t0 = node.scheduler.now()
        self.stats: Dict[str, Any] = {
            "total": 0, "batches": 0, "version_conflicts": 0,
            "failures": [], **{k: 0 for k in extra_stats}}
        self.done = False

    def progress(self) -> None:
        self.task.status = {k: v for k, v in self.stats.items()
                            if k != "failures"}

    def cancelled(self) -> bool:
        try:
            self.task.ensure_not_cancelled()
            return False
        except TaskCancelledError as e:
            self.fail(e)
            return True

    def finish(self) -> None:
        if self.done:
            return
        self.done = True
        response = {
            "took": int((self.node.scheduler.now() - self.t0) * 1000),
            "timed_out": False,
            **{k: v for k, v in self.stats.items()},
        }
        if not self.wait:
            # async callers fetch the result via GET /_tasks/{id}
            self.node.task_results[self.task.task_id] = response
            _trim_results(self.node.task_results)
        self.task.status = {**(self.task.status or {}), "completed": True}
        self.node.task_manager.unregister(self.task)
        if self.wait:
            self.on_done(response, None)

    def fail(self, err: Exception) -> None:
        if self.done:
            return
        self.done = True
        if not self.wait:
            self.node.task_results[self.task.task_id] = {
                "error": {"type": type(err).__name__,
                          "reason": str(err)}}
            _trim_results(self.node.task_results)
        self.node.task_manager.unregister(self.task)
        if self.wait:
            self.on_done(None, err)

    def account_bulk(self, bresp: Dict[str, Any],
                     conflicts_proceed: bool,
                     counters: Dict[str, str]) -> Optional[Exception]:
        """Fold a bulk response into stats. Returns an abort error for
        conflicts (when not proceeding) or any non-conflict failure —
        the reference aborts by-query runs on failures too."""
        abort: Optional[Exception] = None
        for it in bresp["items"]:
            result = next(iter(it.values()))
            if "error" in result:
                if result.get("status") == 409:
                    self.stats["version_conflicts"] += 1
                    if not conflicts_proceed and abort is None:
                        abort = VersionConflictError(
                            str(result["error"].get("reason")))
                else:
                    self.stats["failures"].append(result["error"])
            else:
                key = counters.get(result.get("result"))
                if key:
                    self.stats[key] += 1
        if abort is None and self.stats["failures"]:
            abort = IllegalArgumentError(
                f"{len(self.stats['failures'])} bulk failures, first: "
                f"{self.stats['failures'][0].get('reason')}")
        return abort


def _trim_results(results: Dict[str, Any], cap: int = 1000) -> None:
    while len(results) > cap:
        results.pop(next(iter(results)))


class ReindexActions:
    def __init__(self, node):
        self.node = node

    # ------------------------------------------------------------------
    # reindex
    # ------------------------------------------------------------------

    def reindex(self, body: Dict[str, Any], on_done: DoneFn,
                wait_for_completion: bool = True) -> Optional[str]:
        source = (body or {}).get("source") or {}
        dest = (body or {}).get("dest") or {}
        src_index = source.get("index")
        dst_index = dest.get("index")
        if not src_index or not dst_index:
            on_done(None, IllegalArgumentError(
                "reindex requires source.index and dest.index"))
            return None
        # resolve aliases/wildcards before the self-write check — an alias
        # of the source must not slip past it
        from elasticsearch_tpu_torch.cluster.metadata import (
            resolve_index_expression,
        )
        state = self.node._applied_state()
        try:
            src_concrete = set(resolve_index_expression(
                src_index, state.metadata))
        except Exception:
            src_concrete = {src_index}
        try:
            dst_concrete = set(resolve_index_expression(
                dst_index, state.metadata))
        except Exception:   # dest may not exist yet: fine
            dst_concrete = {dst_index}
        if src_index == dst_index or (src_concrete & dst_concrete):
            # writing into the index being paged breaks the
            # never-self-mutated-source invariant from/size relies on
            on_done(None, IllegalArgumentError(
                "reindex cannot write into an index it is reading from "
                f"[{src_index}]"))
            return None
        query = source.get("query", {"match_all": {}})
        batch = int(source.get("size", DEFAULT_BATCH))
        max_docs = body.get("max_docs")
        script = body.get("script")
        op_type = dest.get("op_type", "index")
        pipeline = dest.get("pipeline")
        conflicts_proceed = (body or {}).get("conflicts") == "proceed"

        run = _ByQueryRun(
            self.node, "indices:data/write/reindex",
            f"reindex from [{src_index}] to [{dst_index}]",
            on_done, wait_for_completion,
            ["created", "updated", "deleted", "noops"])

        def page(from_: int) -> None:
            if run.cancelled():
                return
            size = batch
            if max_docs is not None:
                size = min(size, int(max_docs) - run.stats["total"])
                if size <= 0:
                    run.finish()
                    return
            self.node.client.search(src_index, {
                "query": query, "from": from_, "size": size,
            }, lambda resp, err=None: on_page(from_, resp, err))

        def on_page(from_: int, resp, err) -> None:
            if err is not None:
                run.fail(err)
                return
            hits = resp["hits"]["hits"]
            if not hits:
                run.finish()
                return
            run.stats["batches"] += 1
            run.stats["total"] += len(hits)
            items = []
            for h in hits:
                src = dict(h.get("_source") or {})
                doc_id = h["_id"]
                if script is not None:
                    from elasticsearch_tpu_torch.script.engine import (
                        execute_op_script,
                    )
                    op, src = execute_op_script(src, script)
                    if op == "noop":
                        run.stats["noops"] += 1
                        continue
                    if op == "delete":
                        items.append({"action": "delete",
                                      "index": dst_index, "id": doc_id})
                        continue
                item = {"action": "create" if op_type == "create"
                        else "index",
                        "index": dst_index, "id": doc_id, "source": src}
                if pipeline:
                    item["pipeline"] = pipeline
                items.append(item)
            if not items:
                self.node.scheduler.submit(
                    lambda: page(from_ + len(hits)))
                return

            def on_bulk(bresp, berr=None):
                if berr is not None:
                    run.fail(berr)
                    return
                abort = run.account_bulk(
                    bresp, conflicts_proceed,
                    {"created": "created", "updated": "updated",
                     "deleted": "deleted", "not_found": ""})
                if abort is not None:
                    run.fail(abort)
                    return
                run.progress()
                self.node.scheduler.submit(
                    lambda: page(from_ + len(hits)))
            self.node.client.bulk(items, on_bulk)

        page(0)
        if not wait_for_completion:
            on_done({"task": run.task.task_id}, None)
        return run.task.task_id

    # ------------------------------------------------------------------
    # shared by-query machinery: freeze the worklist, then process it
    # ------------------------------------------------------------------

    def _collect_ids(self, index: str, query: Dict[str, Any],
                     batch: int, max_docs: Optional[int],
                     on_ids: Callable[[Optional[List[str]],
                                       Optional[Exception]], None]
                     ) -> None:
        ids: List[str] = []

        def page(from_: int) -> None:
            self.node.client.search(index, {
                "query": query, "from": from_, "size": batch,
                "_source": False,
            }, on_page)

        def on_page(resp, err=None) -> None:
            if err is not None:
                on_ids(None, err)
                return
            hits = resp["hits"]["hits"]
            ids.extend(h["_id"] for h in hits)
            if len(hits) < batch or (max_docs is not None
                                     and len(ids) >= int(max_docs)):
                on_ids(ids[:int(max_docs)] if max_docs is not None
                       else ids, None)
                return
            self.node.scheduler.submit(lambda: page(len(ids)))
        page(0)

    # ------------------------------------------------------------------
    # delete-by-query
    # ------------------------------------------------------------------

    def delete_by_query(self, index: str, body: Dict[str, Any],
                        on_done: DoneFn,
                        wait_for_completion: bool = True
                        ) -> Optional[str]:
        body = body or {}
        query = body.get("query", {"match_all": {}})
        batch = int(body.get("size", DEFAULT_BATCH))
        conflicts_proceed = body.get("conflicts") == "proceed"
        run = _ByQueryRun(self.node, "indices:data/write/delete/byquery",
                          f"delete-by-query [{index}]",
                          on_done, wait_for_completion, ["deleted"])

        def got_ids(ids, err):
            if err is not None:
                run.fail(err)
                return
            run.stats["total"] = len(ids)
            process(ids, 0)

        def process(ids: List[str], pos: int) -> None:
            if run.cancelled():
                return
            if pos >= len(ids):
                self.node.client.refresh(
                    index, lambda _r, _e=None: run.finish())
                return
            chunk = ids[pos:pos + batch]
            run.stats["batches"] += 1
            items = [{"action": "delete", "index": index, "id": i}
                     for i in chunk]

            def on_bulk(bresp, berr=None):
                if berr is not None:
                    run.fail(berr)
                    return
                abort = run.account_bulk(bresp, conflicts_proceed,
                                         {"deleted": "deleted"})
                if abort is not None:
                    run.fail(abort)
                    return
                run.progress()
                self.node.scheduler.submit(
                    lambda: process(ids, pos + len(chunk)))
            self.node.client.bulk(items, on_bulk)

        self._collect_ids(index, query, batch,
                          body.get("max_docs"), got_ids)
        if not wait_for_completion:
            on_done({"task": run.task.task_id}, None)
        return run.task.task_id

    # ------------------------------------------------------------------
    # update-by-query
    # ------------------------------------------------------------------

    def update_by_query(self, index: str, body: Dict[str, Any],
                        on_done: DoneFn,
                        wait_for_completion: bool = True
                        ) -> Optional[str]:
        body = body or {}
        query = body.get("query", {"match_all": {}})
        script = body.get("script")
        conflicts_proceed = body.get("conflicts") == "proceed"
        batch = int(body.get("size", DEFAULT_BATCH))
        run = _ByQueryRun(self.node, "indices:data/write/update/byquery",
                          f"update-by-query [{index}]",
                          on_done, wait_for_completion,
                          ["updated", "deleted", "noops"])

        def got_ids(ids, err):
            if err is not None:
                run.fail(err)
                return
            run.stats["total"] = len(ids)
            process(ids, 0)

        def process(ids: List[str], pos: int) -> None:
            if run.cancelled():
                return
            if pos >= len(ids):
                self.node.client.refresh(
                    index, lambda _r, _e=None: run.finish())
                return
            chunk = ids[pos:pos + batch]
            # fetch fresh sources + seqnos for exactly this chunk
            self.node.client.search(index, {
                "query": {"ids": {"values": chunk}},
                "size": len(chunk), "seq_no_primary_term": True,
            }, lambda resp, err=None: on_fetched(ids, pos, chunk, resp,
                                                 err))

        def on_fetched(ids, pos, chunk, resp, err) -> None:
            if err is not None:
                run.fail(err)
                return
            run.stats["batches"] += 1
            items = []
            for h in resp["hits"]["hits"]:
                src = dict(h.get("_source") or {})
                if script is not None:
                    from elasticsearch_tpu_torch.script.engine import (
                        execute_op_script,
                    )
                    op, src = execute_op_script(src, script)
                    if op == "noop":
                        run.stats["noops"] += 1
                        continue
                    if op == "delete":
                        items.append({"action": "delete",
                                      "index": h["_index"],
                                      "id": h["_id"]})
                        continue
                item = {"action": "index", "index": h["_index"],
                        "id": h["_id"], "source": src}
                if "_seq_no" in h:
                    item["if_seq_no"] = h["_seq_no"]
                    item["if_primary_term"] = h["_primary_term"]
                items.append(item)
            if not items:
                self.node.scheduler.submit(
                    lambda: process(ids, pos + len(chunk)))
                return

            def on_bulk(bresp, berr=None):
                if berr is not None:
                    run.fail(berr)
                    return
                abort = run.account_bulk(
                    bresp, conflicts_proceed,
                    {"updated": "updated", "created": "updated",
                     "deleted": "deleted"})
                if abort is not None:
                    run.fail(abort)
                    return
                run.progress()
                self.node.scheduler.submit(
                    lambda: process(ids, pos + len(chunk)))
            self.node.client.bulk(items, on_bulk)

        self._collect_ids(index, query, batch,
                          body.get("max_docs"), got_ids)
        if not wait_for_completion:
            on_done({"task": run.task.task_id}, None)
        return run.task.task_id
