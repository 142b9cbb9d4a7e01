"""Shared cursor-paged shard scan (the recovery-style doc stream).

One implementation of the CCR_SCAN paging loop — pinned reader snapshot
on the source node, positional cursor + scan_id continuation, expired-
context failure — shared by CCR bootstrap (xpack/ccr.py) and the resize
family (action/resize.py), which previously each carried a copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError


def stream_shard(node, index: str, shard_id: int, source_node_id: str,
                 batch: int,
                 on_page: Callable[[List[Dict[str, Any]], Callable[[], None]],
                                   None],
                 on_done: Callable[[], None],
                 on_error: Callable[[Any], None]) -> None:
    """Page every live doc of one shard from its holder.

    on_page(docs, proceed) fires per page — the consumer indexes/applies
    the docs, then calls proceed() for the next page; on_done() fires
    after the final page's proceed; errors and expired scan contexts go
    to on_error(reason)."""
    from elasticsearch_tpu_torch.xpack.ccr import CCR_SCAN
    state = {"cursor": None, "scan_id": None}

    def request() -> None:
        node.transport_service.send_request(
            source_node_id, CCR_SCAN,
            {"index": index, "shard": shard_id,
             "cursor": state["cursor"], "scan_id": state["scan_id"],
             "batch": batch}, handle, timeout=60.0)

    def handle(resp, err) -> None:
        if err is not None or resp is None:
            on_error(err)
            return
        if resp.get("expired"):
            on_error(IllegalArgumentError(
                f"scan context for [{index}][{shard_id}] expired"))
            return
        state["cursor"] = resp.get("cursor")
        state["scan_id"] = resp.get("scan_id")
        done = state["cursor"] is None

        def proceed() -> None:
            if done:
                on_done()
            else:
                request()
        on_page(resp.get("docs", []), proceed)

    request()
