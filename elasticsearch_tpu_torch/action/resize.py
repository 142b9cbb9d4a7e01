"""Resize APIs: shrink, split, and clone an index.

Reference: action/admin/indices/shrink (TransportResizeAction,
MetadataCreateIndexService resize path, ResizeAllocationDecider): the
target index is created with the new shard count and recovers from the
source's segments via hard links. Here segments are immutable device
arrays, not files — the target is created with the new shard count and
every live doc streams from a source snapshot through the ordinary bulk
path, re-routed by murmur3 onto the new shard space (same documents,
ids, and sources; the hard-link optimization is a documented
divergence). The reference's preconditions hold: the source must be
write-blocked, and split/shrink factors must divide evenly.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

logger = logging.getLogger(__name__)

SCAN_BATCH = 500


class ResizeActions:
    def __init__(self, node) -> None:
        self.node = node

    def resize(self, kind: str, source: str, target: str,
               body: Optional[Dict[str, Any]], on_done: Callable) -> None:
        state = self.node._applied_state()
        try:
            src_meta = state.metadata.index(source)
        except Exception as e:  # noqa: BLE001 — unknown source: 404
            on_done(None, e)
            return
        if not src_meta.settings.get("index.blocks.write"):
            on_done(None, IllegalArgumentError(
                f"index [{source}] must be write-blocked before "
                f"{kind} (set index.blocks.write=true)"))
            return
        body = body or {}
        settings = dict(body.get("settings") or {})
        n_src = src_meta.number_of_shards
        n_target = int(settings.pop("index.number_of_shards",
                                    settings.pop("number_of_shards",
                                                 0)) or 0)
        if kind == "clone":
            n_target = n_target or n_src
            if n_target != n_src:
                on_done(None, IllegalArgumentError(
                    "clone must keep the source's shard count"))
                return
        elif kind == "shrink":
            n_target = n_target or 1
            if n_src % n_target != 0 or n_target > n_src:
                on_done(None, IllegalArgumentError(
                    f"shrink target shards [{n_target}] must evenly "
                    f"divide source shards [{n_src}]"))
                return
        elif kind == "split":
            if not n_target:
                on_done(None, IllegalArgumentError(
                    "split requires [index.number_of_shards]"))
                return
            if n_target % n_src != 0 or n_target < n_src:
                on_done(None, IllegalArgumentError(
                    f"split target shards [{n_target}] must be an even "
                    f"multiple of source shards [{n_src}]"))
                return
        else:
            on_done(None, IllegalArgumentError(
                f"unknown resize kind [{kind}]"))
            return

        # replicas: request (either spelling) > source's count — the
        # target must not silently drop redundancy
        replicas = settings.pop(
            "index.number_of_replicas",
            settings.pop("number_of_replicas",
                         body.get("number_of_replicas",
                                  src_meta.number_of_replicas)))
        create_settings = {
            **{k: v for k, v in dict(src_meta.settings).items()
               if not k.startswith("index.blocks")
               # the target is NEW: it must get its own creation date or
               # age-based ILM/rollover fires immediately
               and k not in ("number_of_shards", "number_of_replicas",
                             "index.creation_date")},
            **settings,
            "number_of_shards": n_target,
            "number_of_replicas": int(replicas),
            "index.resize.source_name": source,
        }

        def created(_resp, err):
            if err is not None:
                on_done(None, err)
                return
            self._copy_shard(source, target, src_meta, 0, 0, on_done)
        # templates bypassed: the target must be an EXACT copy of the
        # source's mappings (the reference's resize sets no templates)
        self.node.client.create_index(target, {
            "settings": create_settings,
            "mappings": dict(src_meta.mappings)}, created,
            ignore_templates=True)

    def _copy_shard(self, source: str, target: str, src_meta,
                    sid: int, copied: int, on_done: Callable) -> None:
        """Stream one source shard's live docs into the target through
        the shared scan pager + bulk, preserving custom routing. A bulk
        failure (including a backpressure rejection) fails the resize
        AND deletes the partial target so the operation is retryable —
        a one-shot copy must never report success over lost documents
        nor leave a half-index squatting on the target name."""
        from elasticsearch_tpu_torch.action.scan_copy import stream_shard
        if sid >= src_meta.number_of_shards:
            # completion marker: ILM's shrink step gates its alias swap +
            # source delete on this setting — bare target existence only
            # proves create_index ran, not that the async copy finished
            # (swapping early is permanent data loss)
            def marked(_r, err):
                if err is not None:
                    # a failed marker write must tear the target down
                    # like every other failure (fail() below): a marker
                    # -less target would wedge ILM — it never re-resizes
                    # while the target exists, and never swaps without
                    # the marker
                    self.node.client.delete_index(
                        target, lambda _r2, _e=None: on_done(None, err))
                    return
                on_done({"acknowledged": True,
                         "shards_acknowledged": True,
                         "index": target, "copied_docs": copied}, None)
            self.node.client.update_settings(
                target, {"index.resize.copy_complete": True}, marked)
            return
        state = self.node._applied_state()

        def fail(err: Any) -> None:
            self.node.client.delete_index(
                target, lambda _r, _e=None: on_done(None, err))

        try:
            sr = state.routing_table.index(source).primary(sid)
        except Exception as e:  # noqa: BLE001
            fail(e)
            return
        if not sr.active or sr.node_id is None:
            fail(IllegalArgumentError(
                f"source shard [{source}][{sid}] has no active primary"))
            return
        counter = {"n": copied}

        def on_page(docs, proceed):
            items = [{"action": "index", "index": target,
                      "id": d["id"], "source": d["source"],
                      "routing": d.get("routing")}
                     for d in docs]

            def bulked(bulk_resp=None):
                if bulk_resp is not None and bulk_resp.get("errors"):
                    if bulk_resp.get("rejected"):
                        reason = "indexing backpressure (429); retry"
                    else:
                        failed = [i for i in bulk_resp.get("items", [])
                                  if "error" in next(iter(i.values()))]
                        reason = (f"{len(failed)} documents failed: "
                                  f"{failed[:1]}")
                    fail(IllegalArgumentError(
                        f"resize copy into [{target}] failed — {reason}"))
                    return
                counter["n"] += len(items)
                proceed()
            if items:
                self.node.bulk_action.execute(items, bulked)
            else:
                proceed()

        stream_shard(
            self.node, source, sid, sr.node_id, SCAN_BATCH,
            on_page,
            on_done=lambda: self._copy_shard(
                source, target, src_meta, sid + 1, counter["n"],
                on_done),
            on_error=lambda err: fail(err or IllegalArgumentError(
                "resize scan failed")))
