"""CCR-lite: a follower index continuously replicating a leader index.

Reference: x-pack/plugin/ccr — ShardFollowNodeTask reads batches of
translog operations from the leader shard (by seqno range) and replays
them on the follower. This build implements the same shape within one
cluster's transport (the remote-cluster hop is a documented limitation —
the TCP address book would carry it, but cross-cluster connection
registration is not built):

  1. PUT /{follower}/_ccr/follow creates the follower from the leader's
     mappings/settings and registers the follow in cluster-state custom
     metadata. The elected master's poll loop then BOOTSTRAPS: refresh
     the leader (buffered ops must become segment-visible), capture each
     leader shard's max seqno, and copy every live doc shard-by-shard
     through a cursor-paged transport scan (translogs trim on flush, so
     history alone cannot rebuild a shard).
  2. after bootstrap the loop fetches translog ops above each shard
     checkpoint from the node holding the leader primary and replays
     index/delete ops through the ordinary bulk path (idempotent by id).
     Checkpoints only advance after a batch applies.
  3. if the leader trimmed past a checkpoint (flush between polls), the
     fetch reports the gap and the follower re-bootstraps — debounced to
     one re-bootstrap at a time — instead of silently diverging.

Runtime state (checkpoints, counters) is master-local like the
reference's persistent-task state; a master failover restarts from a
fresh bootstrap.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, ResourceNotFoundError,
)

logger = logging.getLogger(__name__)

SECTION = "ccr_follows"
AUTO_FOLLOW_SECTION = "ccr_auto_follow"
POLL_INTERVAL = 2.0
BATCH_OPS = 1000
SCAN_BATCH = 1000

CCR_FETCH = "indices:data/read/ccr/fetch_ops"
CCR_SCAN = "indices:data/read/ccr/scan"

# a paged bootstrap scan holds its reader snapshot this long between pages;
# an abandoned scan (master died mid-bootstrap) expires and frees the reader
SCAN_TTL = 120.0


class CcrShardActions:
    """Data-node side: translog ops by seqno + cursor-paged doc scans."""

    def __init__(self, node) -> None:
        self.node = node
        # scan_id -> (reader, expiry): the cursor is POSITIONAL
        # (segment index, doc), so every page of one scan must see the
        # same reader snapshot — a merge between pages would re-pack
        # segments and silently skip docs (the scroll-context discipline,
        # SearchService.java:203, applied to the recovery-style scan)
        self._scans: Dict[str, Any] = {}
        node.transport_service.register_handler(CCR_FETCH, self._on_fetch)
        node.transport_service.register_handler(CCR_SCAN, self._on_scan)

    def _on_fetch(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        shard = self.node.indices_service.shard(req["index"], req["shard"])
        from_seqno = int(req["from_seqno"])
        translog = shard.engine.translog
        max_seq = shard.engine.tracker.max_seqno
        ops: List[Dict[str, Any]] = []
        if translog is not None:
            ops = sorted((op.to_json()
                          for op in translog.read_all(min_seqno=from_seqno)),
                         key=lambda o: o["seqno"])[:BATCH_OPS]
        # seqnos are DENSE per shard (every op is logged), so history is
        # complete iff the first retained op is exactly from_seqno
        gap = from_seqno <= max_seq and (
            not ops or ops[0]["seqno"] > from_seqno)
        return {"ops": ops, "max_seq_no": max_seq, "gap": gap}

    def _on_scan(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        """Live docs in (segment, doc) order from a cursor — the
        bootstrap copy (RecoverySourceHandler's phase-1 analog, shipping
        _source instead of segment files)."""
        now = time.monotonic()
        for k in [k for k, (_r, exp) in self._scans.items() if exp < now]:
            self._scans.pop(k, None)
        scan_id = req.get("scan_id")
        entry = self._scans.get(scan_id) if scan_id else None
        if entry is not None:
            reader = entry[0]
        elif scan_id:
            # the scan context expired: applying the positional cursor to
            # a FRESH reader would be the exact merge-skip hazard the
            # context exists to prevent — fail so the caller re-bootstraps
            return {"expired": True}
        else:
            shard = self.node.indices_service.shard(
                req["index"], req["shard"])
            reader = shard.engine.acquire_reader()
            scan_id = uuid.uuid4().hex
        after_seg, after_doc = req.get("cursor") or [0, -1]
        batch = int(req.get("batch", SCAN_BATCH))
        docs: List[Dict[str, Any]] = []
        cursor = None
        for si in range(int(after_seg), len(reader.segments)):
            seg = reader.segments[si]
            live = reader.live_masks[si]
            start = int(after_doc) + 1 if si == int(after_seg) else 0
            for d in range(start, seg.n_docs):
                if not live[d]:
                    continue
                if len(docs) >= batch:
                    cursor = [si, d - 1]
                    break
                docs.append({"id": seg.ids[d],
                             "source": seg.sources[d] or {},
                             "routing": (seg.routings[d]
                                         if d < len(seg.routings)
                                         else None)})
            if cursor is not None:
                break
        if cursor is None and docs and len(docs) >= batch:
            cursor = [len(reader.segments), -1]
        if cursor is None:
            self._scans.pop(scan_id, None)
        else:
            self._scans[scan_id] = (reader, now + SCAN_TTL)
        return {"docs": docs, "cursor": cursor, "scan_id": scan_id}


class CcrService:
    """Master-side follow coordinator (ShardFollowNodeTask analog)."""

    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        # follower -> {"checkpoints": {shard: seqno}, "bootstrapping",
        # "ops", "bootstraps"} — master-local runtime state
        self._state: Dict[str, Dict[str, Any]] = {}
        # followers whose auto-follow creation is in flight (debounces
        # duplicate creations between poll ticks; master-local, like the
        # reference's AutoFollowCoordinator in-progress tracking)
        self._auto_inflight: set = set()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._schedule()

    def stop(self) -> None:
        self._running = False
        if self._timer is not None:
            self._timer.cancel()

    def _schedule(self) -> None:
        if not self._running:
            return
        self._timer = self.node.scheduler.schedule(POLL_INTERVAL, self._tick)

    def _tick(self) -> None:
        if not self._running:
            return
        try:
            if self.node.coordinator.mode == "LEADER":
                self.poll_all()
        except Exception:  # noqa: BLE001
            logger.exception("ccr tick failed")
        self._schedule()

    def _defs(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(SECTION, {}))

    # -- API --------------------------------------------------------------

    def follow(self, follower_index: str, body: Dict[str, Any],
               on_done) -> None:
        leader = (body or {}).get("leader_index")
        if not leader:
            on_done(None, IllegalArgumentError(
                "follow requires [leader_index]"))
            return
        state = self.node._applied_state()
        try:
            leader_meta = state.metadata.index(leader)
        except Exception as e:  # noqa: BLE001
            on_done(None, e)
            return
        settings = {k: v for k, v in dict(leader_meta.settings).items()
                    if not k.startswith("index.lifecycle")}
        settings["number_of_shards"] = leader_meta.number_of_shards
        settings["number_of_replicas"] = int(
            (body or {}).get("replicas", 0))
        settings["index.ccr.following"] = leader

        def created(_resp, err):
            if err is not None:
                on_done(None, err)
                return
            from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
            self.node.master_client.execute(
                PUT_CUSTOM, {"section": SECTION, "name": follower_index,
                             "body": {"leader_index": leader_meta.name,
                                      # fresh uid per follow creation: a
                                      # master whose local runtime state
                                      # carries a different uid (stale
                                      # from an earlier follow of the
                                      # same name) must re-bootstrap,
                                      # not resume old checkpoints
                                      "uid": uuid.uuid4().hex,
                                      "paused": False}},
                lambda resp, err2: on_done(
                    {"acknowledged": True,
                     "follower_index": follower_index}
                    if err2 is None else None, err2))
        # the MASTER's poll loop bootstraps (its state is authoritative;
        # bootstrapping here would populate the wrong node's checkpoints
        # when the REST call lands on a non-master)
        self.node.client.create_index(follower_index, {
            "settings": settings,
            "mappings": dict(leader_meta.mappings)}, created)

    def unfollow(self, follower_index: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        self._state.pop(follower_index, None)
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": SECTION, "name": follower_index},
            on_done)

    def stats(self, follower_index: Optional[str] = None) -> Dict[str, Any]:
        defs = self._defs()
        if follower_index is not None and follower_index not in defs:
            raise ResourceNotFoundError(
                f"no follow for index [{follower_index}]")
        out = []
        for fid, d in sorted(defs.items()):
            if follower_index is not None and fid != follower_index:
                continue
            st = self._state.get(fid, {})
            out.append({"follower_index": fid, **d,
                        "checkpoints": dict(st.get("checkpoints", {})),
                        "ops_replayed": st.get("ops", 0),
                        "bootstraps": st.get("bootstraps", 0),
                        "bootstrapping": bool(st.get("bootstrapping"))})
        return {"follows": out}

    # -- auto-follow (AutoFollowCoordinator.java:72 analog) ----------------

    def _auto_patterns(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(AUTO_FOLLOW_SECTION, {}))

    def put_auto_follow(self, name: str, body: Dict[str, Any],
                        on_done) -> None:
        """PUT /_ccr/auto_follow/{name}: new leader indices matching any
        pattern get followers automatically. The registry replicates
        through cluster state, so it survives master failover."""
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        body = dict(body or {})
        patterns = body.get("leader_index_patterns")
        if not patterns or not isinstance(patterns, list):
            on_done(None, IllegalArgumentError(
                "auto-follow requires [leader_index_patterns] as a list"))
            return
        entry = {
            "leader_index_patterns": [str(p) for p in patterns],
            "follow_index_pattern": str(
                body.get("follow_index_pattern",
                         "{{leader_index}}-follower")),
            "replicas": int(body.get("replicas", 0)),
        }
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": AUTO_FOLLOW_SECTION, "name": name,
                         "body": entry}, on_done)

    def delete_auto_follow(self, name: str, on_done) -> None:
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": AUTO_FOLLOW_SECTION, "name": name},
            on_done)

    def get_auto_follow(self, name: Optional[str] = None) -> Dict[str, Any]:
        patterns = self._auto_patterns()
        if name is not None and name not in patterns:
            raise ResourceNotFoundError(
                f"no auto-follow pattern [{name}]")
        return {"patterns": [
            {"name": n, "pattern": dict(p)}
            for n, p in sorted(patterns.items())
            if name is None or n == name]}

    def _check_auto_follow(self, defs: Dict[str, Any]) -> None:
        """One coordinator pass: follow every unfollowed leader index
        matching a registered pattern."""
        import fnmatch
        patterns = self._auto_patterns()
        if not patterns:
            return
        state = self.node._applied_state()
        followed_leaders = {d.get("leader_index") for d in defs.values()}
        for meta in list(state.metadata.indices.values()):
            if meta.settings.get("index.ccr.following"):
                continue   # never follow a follower (cycle)
            if meta.name.startswith("."):
                continue   # system/backing indices are not auto-followed
            if meta.name in followed_leaders:
                continue
            for pat in patterns.values():
                if not any(fnmatch.fnmatch(meta.name, p)
                           for p in pat.get("leader_index_patterns", [])):
                    continue
                follower = pat.get(
                    "follow_index_pattern",
                    "{{leader_index}}-follower").replace(
                        "{{leader_index}}", meta.name)
                if follower in defs or \
                        state.metadata.has_index(follower) or \
                        follower in self._auto_inflight:
                    break
                self._auto_inflight.add(follower)
                logger.info("ccr auto-follow: following [%s] as [%s]",
                            meta.name, follower)

                def created(_resp, err, follower=follower):
                    self._auto_inflight.discard(follower)
                    if err is not None:
                        logger.warning(
                            "ccr auto-follow for [%s] failed: %s",
                            follower, err)
                self.follow(follower,
                            {"leader_index": meta.name,
                             "replicas": pat.get("replicas", 0)}, created)
                break

    # -- replication ------------------------------------------------------

    def _following(self, follower: str) -> bool:
        """Guards every async callback: unfollow may land mid-flight."""
        return follower in self._defs()

    def poll_all(self) -> None:
        defs = self._defs()
        self._check_auto_follow(defs)
        # prune runtime state for unfollowed indices (the unfollow REST
        # call may have landed on another node, popping only ITS state)
        for stale in [f for f in self._state if f not in defs]:
            self._state.pop(stale, None)
        for follower, d in defs.items():
            if d.get("paused"):
                continue
            st = self._state.get(follower)
            if st is not None and st.get("uid") != d.get("uid"):
                # same follower name, different follow: old checkpoints
                # would silently skip the new follower's bootstrap
                self._state.pop(follower, None)
                st = None
            if st is None or st.get("bootstrapping"):
                if st is None:
                    self._bootstrap(follower, d["leader_index"],
                                    d.get("uid"))
                continue
            self._poll_follow(follower, d["leader_index"])

    def _leader_primary_node(self, leader: str, sid: int) -> Optional[str]:
        state = self.node._applied_state()
        try:
            sr = state.routing_table.index(leader).primary(sid)
        except Exception:  # noqa: BLE001
            return None
        return sr.node_id if sr.active else None

    # -- bootstrap --------------------------------------------------------

    def _bootstrap(self, follower: str, leader: str,
                   uid: Optional[str] = None) -> None:
        """Refresh leader -> capture checkpoints -> cursor-scan every
        shard into the follower. Checkpoints COMMIT only on success; one
        bootstrap at a time per follow (gap storms debounce here)."""
        st = self._state.setdefault(follower, {})
        if uid is not None:
            st["uid"] = uid
        elif "uid" not in st:
            st["uid"] = self._defs().get(follower, {}).get("uid")
        if st.get("bootstrapping"):
            return
        st["bootstrapping"] = True
        st["bootstraps"] = st.get("bootstraps", 0) + 1
        state = self.node._applied_state()
        if not state.metadata.has_index(leader):
            st["bootstrapping"] = False
            return
        n_shards = state.metadata.index(leader).number_of_shards

        def fail(reason: Any) -> None:
            logger.warning("ccr bootstrap [%s] failed: %s", follower, reason)
            st["bootstrapping"] = False   # poll retries via gap detection

        # the refresh + checkpoint-capture prologue retries with
        # jittered-exponential backoff (utils/retry.py) through transient
        # leader unavailability — a partitioned leader primary delays the
        # bootstrap instead of failing it back to the next poll tick
        def prologue(cb) -> None:
            if not self._following(follower):
                cb({"maxes": None}, None)   # unfollowed mid-retry: stop
                return

            def refreshed(_resp, err=None):
                if err is not None:
                    cb(None, err if isinstance(err, Exception)
                       else RuntimeError(str(err)))
                    return
                self._fetch_max_seqnos(leader, n_shards, captured)

            def captured(maxes: Dict[int, int]) -> None:
                if any(v is None for v in maxes.values()):
                    from elasticsearch_tpu_torch.utils.errors import (
                        UnavailableShardsError,
                    )
                    cb(None, UnavailableShardsError(
                        f"[{leader}] max seqno unavailable"))
                    return
                cb({"maxes": maxes}, None)

            self.node.client.refresh(leader, refreshed)

        def prologue_done(resp, err) -> None:
            if err is not None:
                fail(err)
                return
            maxes = (resp or {}).get("maxes")
            if maxes is None:
                st["bootstrapping"] = False   # unfollowed: quiet stop
                return
            self._scan_shards(follower, leader, n_shards, 0, {}, maxes)

        from elasticsearch_tpu_torch.utils.retry import RetryableAction
        RetryableAction(
            self.node.scheduler, prologue, prologue_done,
            initial_delay=0.5, max_delay=4.0,
            timeout=4 * POLL_INTERVAL).run()

    def _fetch_max_seqnos(self, leader: str, n_shards: int, cb) -> None:
        maxes: Dict[int, Optional[int]] = {}
        pending = {"n": n_shards}
        for sid in range(n_shards):
            node_id = self._leader_primary_node(leader, sid)

            def one(resp, err, sid=sid):
                maxes[sid] = None if err or resp is None \
                    else int(resp.get("max_seq_no", -1))
                pending["n"] -= 1
                if pending["n"] == 0:
                    cb(maxes)
            if node_id is None:
                one(None, IllegalArgumentError("no primary"))
                continue
            self.node.transport_service.send_request(
                node_id, CCR_FETCH,
                {"index": leader, "shard": sid, "from_seqno": 1 << 62},
                one, timeout=30.0)

    def _scan_shards(self, follower: str, leader: str, n_shards: int,
                     sid: int, cursor_state: Dict[str, Any],
                     maxes: Dict[int, int]) -> None:
        st = self._state.get(follower)
        if st is None or not self._following(follower):
            return   # unfollowed mid-bootstrap
        if sid >= n_shards:
            # COMMIT: every shard copied; ops from here replay via polls
            st["checkpoints"] = {str(s): m for s, m in maxes.items()}
            st["bootstrapping"] = False
            return
        node_id = self._leader_primary_node(leader, sid)
        if node_id is None:
            st["bootstrapping"] = False
            return
        from elasticsearch_tpu_torch.action.scan_copy import stream_shard

        def on_page(docs, proceed) -> None:
            if not self._following(follower):
                return   # unfollowed mid-bootstrap: stop quietly
            items = [{"action": "index", "index": follower,
                      "id": d["id"], "source": d["source"],
                      "routing": d.get("routing")}
                     for d in docs]
            if items:
                self.node.bulk_action.execute(items,
                                              lambda _r=None: proceed())
            else:
                proceed()

        def on_error(err) -> None:
            st["bootstrapping"] = False
            logger.warning("ccr bootstrap [%s] scan failed: %s",
                           follower, err)

        stream_shard(
            self.node, leader, sid, node_id, SCAN_BATCH, on_page,
            on_done=lambda: self._scan_shards(
                follower, leader, n_shards, sid + 1, {}, maxes),
            on_error=on_error)

    # -- incremental polls -------------------------------------------------

    def _poll_follow(self, follower: str, leader: str) -> None:
        state = self.node._applied_state()
        if not state.metadata.has_index(leader) or \
                not state.metadata.has_index(follower):
            return
        n_shards = state.metadata.index(leader).number_of_shards
        st = self._state[follower]
        checkpoints = st.setdefault("checkpoints", {})
        for sid in range(n_shards):
            node_id = self._leader_primary_node(leader, sid)
            if node_id is None:
                continue
            ckpt = int(checkpoints.get(str(sid), -1))

            def on_ops(resp, err, sid=sid):
                if err is not None or resp is None or \
                        not self._following(follower) or \
                        st.get("bootstrapping"):
                    return
                if resp.get("gap"):
                    logger.warning(
                        "ccr follow [%s] shard %s: history gap, "
                        "re-bootstrapping", follower, sid)
                    self._bootstrap(follower, leader)
                    return
                ops = resp.get("ops", [])
                if not ops:
                    return
                items = []
                top = int(checkpoints.get(str(sid), -1))
                for op in ops:
                    top = max(top, int(op["seqno"]))
                    if op["op"] == "index":
                        items.append({"action": "index",
                                      "index": follower,
                                      "id": op["id"],
                                      "source": op.get("source") or {},
                                      "routing": op.get("routing")})
                    elif op["op"] == "delete":
                        items.append({"action": "delete",
                                      "index": follower,
                                      "id": op["id"],
                                      "routing": op.get("routing")})

                def applied(_resp) -> None:
                    # checkpoint advances only after the batch APPLIED
                    if self._following(follower):
                        checkpoints[str(sid)] = top
                        st["ops"] = st.get("ops", 0) + len(items)
                if items:
                    self.node.bulk_action.execute(items, applied)
                else:
                    checkpoints[str(sid)] = top
            self.node.transport_service.send_request(
                node_id, CCR_FETCH,
                {"index": leader, "shard": sid, "from_seqno": ckpt + 1},
                on_ops, timeout=30.0)
