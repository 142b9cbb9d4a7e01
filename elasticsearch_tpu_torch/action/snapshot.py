"""Snapshot / restore orchestration.

Reference analogs: snapshots/SnapshotsService.java:114 (master-side
snapshot state machine), SnapshotShardsService.java:76 (data-node shard
uploader), RestoreService.java:121 (restore as recovery). Collapsed to the
two-plane shape of this framework: the coordinating node fans out
snapshot[s]/restore[s] transport actions to the nodes holding primaries,
and the repository itself is the shared blob store (FsRepository).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.cluster.metadata import resolve_index_expression
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.indices.indices_service import IndicesService
from elasticsearch_tpu_torch.repositories import (
    FsRepository, repository_from_settings,
)
from elasticsearch_tpu_torch.transport.transport import TransportService
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, SearchEngineError, ShardCorruptedError,
)

SNAPSHOT_SHARD = "cluster:admin/snapshot/shard"
RESTORE_SHARD = "cluster:admin/snapshot/restore[s]"

DoneFn = Callable[[Optional[Dict[str, Any]], Optional[Exception]], None]


class SnapshotShardActions:
    """Data-node side: upload / download one shard's segments."""

    def __init__(self, indices: IndicesService, ts: TransportService):
        self.indices = indices
        ts.register_handler(SNAPSHOT_SHARD, self._on_snapshot_shard)
        ts.register_handler(RESTORE_SHARD, self._on_restore_shard)

    def _on_snapshot_shard(self, req: Dict[str, Any], sender: str
                           ) -> Dict[str, Any]:
        shard = self.indices.shard(req["index"], req["shard"])
        repo = FsRepository(req["location"])
        engine = shard.engine
        # never snapshot a copy whose storage is suspect — a backup of a
        # corrupted shard poisons every later restore
        if engine.failed:
            raise ShardCorruptedError(
                f"shard [{req['index']}][{req['shard']}] has a failed "
                f"engine: {engine.failure_reason}")
        if engine.store is not None:
            engine.store.ensure_not_corrupted()
        engine.refresh()
        reader = engine.acquire_reader()
        blobs: List[str] = []
        docs = 0
        import copy
        for seg, live in zip(reader.segments, reader.live_masks):
            # serialize the point-in-time view: a shallow copy carries the
            # snapshot's live mask without mutating the shared segment
            view = copy.copy(seg)
            view.live = live.copy()
            view.invalidate_live_count()
            blobs.append(repo.put_segment(view))
            docs += int(live.sum())
        return {"blobs": blobs, "docs": docs}

    def _on_restore_shard(self, req: Dict[str, Any], sender: str
                          ) -> Dict[str, Any]:
        shard = self.indices.shard(req["index"], req["shard"])
        repo = FsRepository(req["location"])
        segments = [repo.get_segment(sha) for sha in req["blobs"]]
        shard.engine.restore_segments(segments)
        shard.engine.refresh()
        return {"docs": shard.engine.doc_count}


class SnapshotActions:
    """Coordinating-node side: whole-snapshot create / restore / list."""

    def __init__(self, node):
        self.node = node

    def _repo(self, name: str, state: ClusterState) -> FsRepository:
        return repository_from_settings(
            name, dict(state.metadata.persistent_settings))

    def _location(self, name: str, state: ClusterState) -> str:
        return state.metadata.persistent_settings[
            f"repositories.{name}.location"]

    # -- create ----------------------------------------------------------

    def create(self, repo_name: str, snap_name: str,
               body: Optional[Dict[str, Any]], on_done: DoneFn) -> None:
        state = self.node._applied_state()
        try:
            repo = self._repo(repo_name, state)
            if snap_name in repo.list_snapshots():
                raise IllegalArgumentError(
                    f"snapshot [{snap_name}] already exists")
            names = resolve_index_expression(
                (body or {}).get("indices", "_all"), state.metadata)
            location = self._location(repo_name, state)
        except SearchEngineError as e:
            on_done(None, e)
            return

        targets = []
        missing_primaries: List[str] = []
        for name in names:
            n_shards = state.metadata.index(name).number_of_shards
            found = 0
            if state.routing_table.has_index(name):
                for sr in state.routing_table.index(name).all_shards():
                    if sr.primary and sr.active and sr.node_id is not None:
                        targets.append(sr)
                        found += 1
            if found < n_shards:
                missing_primaries.append(
                    f"index [{name}]: {n_shards - found} primary "
                    f"shard(s) not active")
        manifest: Dict[str, Any] = {
            "snapshot": snap_name,
            "state": "SUCCESS",
            "start_time_ms": int(time.time() * 1000),
            "indices": {
                name: {
                    "uuid": state.metadata.index(name).uuid,
                    "settings": dict(state.metadata.index(name).settings),
                    "number_of_shards":
                        state.metadata.index(name).number_of_shards,
                    "number_of_replicas":
                        state.metadata.index(name).number_of_replicas,
                    "mappings": dict(state.metadata.index(name).mappings),
                    "shards": {},
                } for name in names},
            "failures": [],
        }
        if missing_primaries:
            # a snapshot that cannot cover every shard must say so
            # (the reference marks these PARTIAL / fails them)
            manifest["state"] = "PARTIAL"
            manifest["failures"].extend(
                {"reason": m} for m in missing_primaries)
        if not targets:
            manifest["end_time_ms"] = int(time.time() * 1000)
            repo.write_snapshot(snap_name, manifest)
            on_done({"snapshot": _snapshot_info(manifest)}, None)
            return
        pending = {"n": len(targets)}

        def one(sr):
            req = {"index": sr.index, "shard": sr.shard_id,
                   "location": location}

            def cb(resp, err):
                if err is not None:
                    manifest["state"] = "PARTIAL"
                    manifest["failures"].append(
                        {"index": sr.index, "shard": sr.shard_id,
                         "reason": str(err)})
                else:
                    manifest["indices"][sr.index]["shards"][
                        str(sr.shard_id)] = resp["blobs"]
                pending["n"] -= 1
                if pending["n"] == 0:
                    manifest["end_time_ms"] = int(time.time() * 1000)
                    repo.write_snapshot(snap_name, manifest)
                    on_done({"snapshot": _snapshot_info(manifest)}, None)
            self.node.transport_service.send_request(
                sr.node_id, SNAPSHOT_SHARD, req, cb, timeout=600.0)
        for sr in targets:
            one(sr)

    # -- restore ---------------------------------------------------------

    def restore(self, repo_name: str, snap_name: str,
                body: Optional[Dict[str, Any]], on_done: DoneFn) -> None:
        state = self.node._applied_state()
        try:
            repo = self._repo(repo_name, state)
            manifest = repo.read_snapshot(snap_name)
            location = self._location(repo_name, state)
        except SearchEngineError as e:
            on_done(None, e)
            return
        body = body or {}
        if manifest.get("state") != "SUCCESS" and not body.get("partial"):
            on_done(None, IllegalArgumentError(
                f"snapshot [{snap_name}] is [{manifest.get('state')}]; "
                f"pass \"partial\": true to restore what it holds"))
            return
        wanted = body.get("indices")
        rename_pattern = body.get("rename_pattern")
        rename_to = body.get("rename_replacement")
        indices = manifest["indices"]
        if wanted:
            import fnmatch
            patterns = [w.strip() for w in (
                wanted if isinstance(wanted, list) else wanted.split(","))]
            indices = {k: v for k, v in indices.items()
                       if any(fnmatch.fnmatch(k, p) for p in patterns)}
        plan = []   # (target_name, index_manifest)
        for name, imeta in indices.items():
            target = name
            if rename_pattern and rename_to is not None:
                import re
                target = re.sub(rename_pattern, rename_to, name)
            plan.append((target, imeta))
        self._restore_next(plan, 0, location, [], on_done)

    def _restore_next(self, plan, i, location, restored, on_done) -> None:
        if i >= len(plan):
            on_done({"accepted": True,
                     "indices": restored}, None)
            return
        target, imeta = plan[i]

        def after_restore(err2):
            if err2 is not None:
                on_done(None, err2)
                return
            restored.append(target)

            def next_index(*_):
                self._restore_next(plan, i + 1, location, restored,
                                   on_done)
            replicas = imeta["number_of_replicas"]
            if replicas:
                # replicas are added AFTER the primaries hold the restored
                # data, so peer recovery copies real segments — a replica
                # recovered from a still-empty primary would stay empty
                def replicas_set(_r, err3=None):
                    if err3 is not None:
                        on_done(None, SearchEngineError(
                            f"restored [{target}] but failed to raise "
                            f"replicas to {replicas}: {err3}"))
                        return
                    next_index()
                self.node.client.update_settings(
                    target, {"number_of_replicas": replicas},
                    replicas_set)
            else:
                next_index()

        def created(resp, err):
            if err is not None:
                on_done(None, err)
                return
            self._await_primaries_and_restore(target, imeta, location,
                                              after_restore)
        self.node.client.create_index(target, {
            "settings": {
                "number_of_shards": imeta["number_of_shards"],
                "number_of_replicas": 0,
                **{k: v for k, v in imeta.get("settings", {}).items()
                   if k != "number_of_replicas"},
            },
            "mappings": imeta.get("mappings", {}),
        }, created)

    def _await_primaries_and_restore(self, target, imeta, location,
                                     done_cb, attempt: int = 0) -> None:
        state = self.node._applied_state()
        srs = []
        if state.routing_table.has_index(target):
            srs = [sr for sr in
                   state.routing_table.index(target).all_shards()
                   if sr.primary and sr.active and sr.node_id]
        if len(srs) < imeta["number_of_shards"]:
            if attempt > 300:
                done_cb(SearchEngineError(
                    f"timed out waiting for [{target}] primaries"))
                return
            self.node.scheduler.schedule(
                0.1, lambda: self._await_primaries_and_restore(
                    target, imeta, location, done_cb, attempt + 1))
            return
        pending = {"n": 0}
        failures: List[str] = []
        reqs = []
        for sr in srs:
            blobs = imeta["shards"].get(str(sr.shard_id), [])
            pending["n"] += 1
            reqs.append((sr, blobs))

        def cb_for(sr):
            def cb(resp, err):
                if err is not None:
                    failures.append(f"shard {sr.shard_id}: {err}")
                pending["n"] -= 1
                if pending["n"] == 0:
                    done_cb(SearchEngineError("; ".join(failures))
                            if failures else None)
            return cb
        for sr, blobs in reqs:
            self.node.transport_service.send_request(
                sr.node_id, RESTORE_SHARD,
                {"index": target, "shard": sr.shard_id,
                 "location": location, "blobs": blobs},
                cb_for(sr), timeout=600.0)

    # -- read APIs -------------------------------------------------------

    def get(self, repo_name: str, snap_name: str) -> Dict[str, Any]:
        state = self.node._applied_state()
        repo = self._repo(repo_name, state)
        if snap_name in ("_all", "*"):
            return {"snapshots": [
                _snapshot_info(repo.read_snapshot(n))
                for n in repo.list_snapshots()]}
        return {"snapshots": [_snapshot_info(repo.read_snapshot(
            snap_name))]}

    def delete(self, repo_name: str, snap_name: str) -> Dict[str, Any]:
        state = self.node._applied_state()
        self._repo(repo_name, state).delete_snapshot(snap_name)
        return {"acknowledged": True}


def _snapshot_info(manifest: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "snapshot": manifest["snapshot"],
        "state": manifest["state"],
        "indices": sorted(manifest["indices"]),
        "start_time_in_millis": manifest.get("start_time_ms"),
        "end_time_in_millis": manifest.get("end_time_ms"),
        "failures": manifest.get("failures", []),
    }
