"""Searchable snapshots + frozen indices.

Reference: x-pack/plugin/searchable-snapshots
(SearchableSnapshotDirectory.java:95 — a Lucene Directory reading
straight from the blob store) and x-pack frozen-indices (search_throttled
shards whose readers open per search). In this build a mounted index's
shards recover their segment archives from the repository (restore is
already "a recovery source variant") and the index is write-blocked; the
searchable-snapshot property that matters — no ingest path, repository
as the source of truth — holds. Frozen indices additionally drop their
device-resident arrays after every search, trading latency for HBM
(FrozenEngine's per-search reader, re-expressed as device-cache
eviction)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

MOUNT_SETTINGS = {
    "index.blocks.write": True,
}


class SearchableSnapshotsService:
    def __init__(self, node) -> None:
        self.node = node

    def mount(self, repo: str, snap: str, body: Dict[str, Any],
              on_done: Callable) -> None:
        """POST /_snapshot/{repo}/{snap}/_mount — restore one index from
        the repository and write-block it (MountSearchableSnapshotAction
        analog; storage=full_copy semantics)."""
        body = body or {}
        index = body.get("index")
        if not index:
            on_done(None, IllegalArgumentError("mount requires [index]"))
            return
        target = body.get("renamed_index") or index

        def restored(resp, err):
            if err is not None:
                on_done(None, err)
                return
            settings = {**MOUNT_SETTINGS,
                        "index.store.snapshot.repository_name": repo,
                        "index.store.snapshot.snapshot_name": snap,
                        "index.store.snapshot.index_name": index,
                        **(body.get("index_settings") or {})}

            def blocked(_r, err2):
                if err2 is not None:
                    # the restored target exists WITHOUT the snapshot
                    # marker settings ILM's copy-completion gate requires:
                    # left in place it parks the policy forever. Tear the
                    # target down (resize.py's marker-failure teardown)
                    # so the mount can simply be retried.
                    self.node.client.delete_index(
                        target, lambda _r2, _e2: on_done(None, err2))
                    return
                on_done({"snapshot": {"snapshot": snap,
                                      "indices": [target],
                                      "shards": {"failed": 0}}}, None)
            self.node.client.update_settings(target, settings, blocked)

        self.node.snapshot_actions.restore(
            repo, snap, {"indices": index,
                         "rename_pattern": f"^{index}$",
                         "rename_replacement": target}, restored)

    # -- freeze / unfreeze -------------------------------------------------

    def set_frozen(self, index: str, frozen: bool,
                   on_done: Callable) -> None:
        """POST /{index}/_freeze|_unfreeze: a frozen index stays
        searchable but drops device-resident arrays after each search and
        is excluded from wildcard expansion unless ignore_throttled=false
        (FrozenEngine + TransportFreezeIndexAction analogs)."""
        settings: Dict[str, Any] = {"index.frozen": frozen}
        if frozen:
            settings["index.blocks.write"] = True
        else:
            # unfreezing must NOT strip the write block off a mounted
            # searchable snapshot (repository-backed, permanently
            # read-only)
            try:
                current = self.node._applied_state() \
                    .metadata.index(index).settings
                mounted = bool(current.get(
                    "index.store.snapshot.repository_name"))
            except Exception:  # noqa: BLE001
                mounted = False
            if not mounted:
                settings["index.blocks.write"] = False
        self.node.client.update_settings(
            index, settings,
            lambda _r, err: on_done(
                {"acknowledged": True} if err is None else None, err))


def is_frozen(state, index: str) -> bool:
    try:
        settings = state.metadata.index(index).settings
    except Exception:  # noqa: BLE001
        return False
    return bool(settings.get("index.frozen"))


def evict_device_caches(reader) -> None:
    """Frozen semantics: device/HBM residency lasts one search."""
    for seg in reader.segments:
        seg._device_cache.clear()
        # filter-cache entries hold device masks too
        if hasattr(seg, "_filter_cache"):
            seg._filter_cache.clear()
    # a packed multi-segment plane over these segments is residency too
    import sys
    mod = sys.modules.get("elasticsearch_tpu_torch.ops.device_segment")
    if mod is not None:
        mod.PLANES.drop_segments(seg.uid for seg in reader.segments)
        mod.MESH_PLANES.drop_segments(seg.uid for seg in reader.segments)
