"""Node-level registry of index services and their shards.

Reference analog: indices/IndicesService.java:176 — creates/deletes
``IndexService`` instances as cluster state demands; each IndexService owns
that node's shard copies of one index (index/IndexService.java). Storage
paths hang off the node's data directory (env/NodeEnvironment analog).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Iterable, Optional

from elasticsearch_tpu_torch.cluster.metadata import IndexMetadata
from elasticsearch_tpu_torch.index.shard import IndexShard, ShardId
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.utils.errors import (
    IndexNotFoundError, ShardNotFoundError,
)
from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds


def _retention_settings(settings: Dict) -> tuple:
    """(retention ops, lease period seconds) from an index settings dict
    (index.soft_deletes.retention.ops / .retention_lease.period)."""
    raw_ops = settings.get("index.soft_deletes.retention.ops")
    ops = int(raw_ops) if raw_ops is not None else 1024
    raw_period = settings.get("index.soft_deletes.retention_lease.period")
    period = (parse_time_to_seconds(raw_period)
              if raw_period is not None else 12 * 3600.0)
    return max(0, ops), period


class IndexService:
    """This node's view of one index: mapper service + local shard copies."""

    def __init__(self, metadata: IndexMetadata,
                 data_path: Optional[str] = None,
                 disk_io=None, node_id: Optional[str] = None,
                 device=None):
        self.metadata = metadata
        # where this node's shards keep their device arrays (None = the
        # CUDA card); every shard's SearchService runs there
        self.device = device
        self.mapper_service = MapperService(dict(metadata.mappings) or None)
        self.shards: Dict[int, IndexShard] = {}
        self.data_path = data_path
        self.disk_io = disk_io
        self.node_id = node_id

    def _shard_paths(self, shard: int, fresh_store: bool = False):
        if self.data_path is None:
            return None, None
        base = os.path.join(self.data_path, self.metadata.uuid, str(shard))
        if fresh_store:
            # peer recovery builds this copy from scratch off the primary:
            # whatever is on disk (including corruption markers from a
            # previous failed copy) must not leak into the new one
            shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base, exist_ok=True)
        return (Store(os.path.join(base, "index"), disk_io=self.disk_io),
                Translog(os.path.join(base, "translog"),
                         disk_io=self.disk_io))

    def create_shard(self, shard: int, primary: bool, primary_term: int = 1,
                     allocation_id: Optional[str] = None,
                     fresh_store: bool = False) -> IndexShard:
        if shard in self.shards:
            raise ValueError(f"shard [{self.metadata.name}][{shard}] "
                             f"already exists on this node")
        store, translog = self._shard_paths(shard, fresh_store=fresh_store)
        settings = dict(self.metadata.settings or {})
        index_sort = None
        sort_field = settings.get("index.sort.field")
        if sort_field:
            if isinstance(sort_field, list):
                sort_field = sort_field[0]   # one sort key supported
            sort_order = settings.get("index.sort.order", "asc")
            if isinstance(sort_order, list):
                sort_order = sort_order[0]
            index_sort = (str(sort_field), str(sort_order))
        retention_ops, lease_period = _retention_settings(settings)
        index_shard = IndexShard(
            ShardId(self.metadata.name, shard), self.mapper_service,
            primary=primary, primary_term=primary_term,
            allocation_id=allocation_id, store=store, translog=translog,
            index_sort=index_sort,
            check_on_startup=settings.get(
                "index.shard.check_on_startup", False),
            soft_deletes_retention_ops=retention_ops,
            retention_lease_period_s=lease_period,
            node_id=self.node_id, device=self.device)
        self.shards[shard] = index_shard
        return index_shard

    def shard(self, shard: int) -> IndexShard:
        if shard not in self.shards:
            raise ShardNotFoundError(
                f"shard [{self.metadata.name}][{shard}] not on this node")
        return self.shards[shard]

    def remove_shard(self, shard: int, delete_data: bool = False) -> None:
        index_shard = self.shards.pop(shard, None)
        if index_shard is not None:
            index_shard.close()
        if delete_data and self.data_path is not None:
            path = os.path.join(self.data_path, self.metadata.uuid, str(shard))
            shutil.rmtree(path, ignore_errors=True)

    def update_metadata(self, metadata: IndexMetadata) -> None:
        if metadata.mappings and metadata.version > self.metadata.version:
            self.mapper_service.merge(dict(metadata.mappings))
        old_retention = _retention_settings(dict(self.metadata.settings or {}))
        self.metadata = metadata
        new_retention = _retention_settings(dict(metadata.settings or {}))
        if new_retention != old_retention:
            # dynamic soft-deletes settings reach live shards immediately
            retention_ops, lease_period = new_retention
            for index_shard in self.shards.values():
                index_shard.update_retention_settings(
                    retention_ops=retention_ops,
                    lease_period_s=lease_period)

    def close(self) -> None:
        for shard in self.shards.values():
            shard.close()
        self.shards.clear()


class IndicesService:
    def __init__(self, data_path: Optional[str] = None, disk_io=None,
                 node_id: Optional[str] = None, device=None):
        self.indices: Dict[str, IndexService] = {}
        self.device = device
        self.data_path = data_path
        self.node_id = node_id
        # the DiskIO seam every shard Store/Translog writes through
        # (None = the shared default); the chaos harness injects a faulty
        # implementation here
        self.disk_io = disk_io

    def create_index(self, metadata: IndexMetadata) -> IndexService:
        if metadata.name in self.indices:
            return self.indices[metadata.name]
        service = IndexService(metadata, data_path=self.data_path,
                               disk_io=self.disk_io, node_id=self.node_id,
                               device=self.device)
        self.indices[metadata.name] = service
        return service

    def index_service(self, name: str) -> IndexService:
        if name not in self.indices:
            raise IndexNotFoundError(name)
        return self.indices[name]

    def has_index(self, name: str) -> bool:
        return name in self.indices

    def shard(self, index: str, shard: int) -> IndexShard:
        return self.index_service(index).shard(shard)

    def has_shard(self, index: str, shard: int) -> bool:
        return index in self.indices and shard in self.indices[index].shards

    def has_on_disk_data(self, metadata: IndexMetadata, shard: int) -> bool:
        """True if this node's data path holds a committed store for the
        shard (a commit point exists). Used to prefer in-place store
        recovery over failing a copy whose data is intact on disk."""
        if self.data_path is None:
            return False
        import glob as _glob
        return bool(_glob.glob(os.path.join(
            self.data_path, metadata.uuid, str(shard), "index",
            "commit-*.json")))

    def local_shard_state(self, index_uuid: Optional[str],
                          shard: int) -> Optional[Dict[str, object]]:
        """On-disk metadata of this node's copy of one shard (commit
        watermarks, recorded allocation id, corruption markers) WITHOUT
        instantiating an IndexService — the gateway fetch must answer for
        indices a freshly-rebooted process hasn't applied state for yet.
        None when this node has no directory for the copy at all."""
        if self.data_path is None or not index_uuid:
            return None
        base = os.path.join(self.data_path, index_uuid, str(shard), "index")
        if not os.path.isdir(base):
            return None
        return Store(base, disk_io=self.disk_io).local_shard_state()

    def remove_index(self, name: str, delete_data: bool = False) -> None:
        service = self.indices.pop(name, None)
        if service is None:
            return
        uuid = service.metadata.uuid
        service.close()
        if delete_data and self.data_path is not None:
            shutil.rmtree(os.path.join(self.data_path, uuid),
                          ignore_errors=True)

    def all_shards(self) -> Iterable[IndexShard]:
        for service in self.indices.values():
            yield from service.shards.values()

    def stats(self) -> Dict[str, object]:
        return {
            "indices": {
                name: {str(sid): shard.doc_stats()
                       for sid, shard in svc.shards.items()}
                for name, svc in self.indices.items()
            }
        }

    def close(self) -> None:
        for service in self.indices.values():
            service.close()
        self.indices.clear()
