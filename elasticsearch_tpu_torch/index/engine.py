"""The per-shard storage engine.

Reference analog: ``InternalEngine`` (index/engine/InternalEngine.java:121):
- ``index()`` (:831): version-conflict plan via a live version map (:879),
  write into the in-memory buffer (≈ indexIntoLucene :1030) and the translog
  (:899);
- ``refresh()`` (:1533): buffered docs become a new immutable searchable
  segment; queued update/delete tombstones flip live bits on older segments
  (Lucene delete-by-term at refresh);
- ``flush()`` (:489): refresh + persist segments + commit point + translog
  generation rollover/trim;
- merges: background-policy'd re-pack of small segments purging deletes.

TPU divergence: a "Lucene document write" is a host-side parsed-columns
append; device arrays are built lazily per segment by the search layer, so
indexing never blocks on device work.
"""

from __future__ import annotations

import itertools
import logging
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.index.segment import Segment, SegmentBuilder, merge_segments
from elasticsearch_tpu_torch.index.seqno import LocalCheckpointTracker, NO_OPS_PERFORMED
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.index.translog import Translog, TranslogOp
from elasticsearch_tpu_torch.mapping import MapperService, ParsedDocument
from elasticsearch_tpu_torch.utils.errors import (
    ShardCorruptedError, VersionConflictError,
)

logger = logging.getLogger(__name__)

# search generation values are drawn from ONE process-global counter
# (atomic in CPython): monotonic per engine AND unique across engine
# incarnations, so a shard torn down and re-created on the same node
# can never reuse a stamp a stale cache entry still carries
_SEARCH_GENERATIONS = itertools.count(1)


@dataclass
class VersionEntry:
    seqno: int
    primary_term: int
    version: int
    deleted: bool = False
    # earliest op seqno THIS engine incarnation observed for the doc
    # (-1 = unknown, e.g. rebuilt from a commit): the rollback path's
    # proof that a doc was created entirely above the rollback target
    first_seqno: int = -1


class RollbackInfeasibleError(RuntimeError):
    """The engine cannot prove what a doc's state was at the rollback
    target (history pruned + segment copy gone) — the caller falls back
    to wipe-and-copy with a typed reason instead of guessing."""


@dataclass
class EngineResult:
    doc_id: str
    seqno: int
    primary_term: int
    version: int
    result: str               # 'created' | 'updated' | 'deleted' | 'noop' | 'not_found'


class _InvertedStr(str):
    """A str whose ordering is reversed (desc index sorts on keywords)."""
    __slots__ = ()

    def __lt__(self, other):  # noqa: D105
        return str.__gt__(self, other)

    def __gt__(self, other):  # noqa: D105
        return str.__lt__(self, other)


def _index_sort_key(value, direction: str):
    """One sortable tuple per doc for index.sort ordering — shared by the
    refresh-path builder sort and the merge-path re-sort so the two can
    never diverge. Missing values last; ties keep arrival order."""
    if isinstance(value, list):
        value = value[0] if value else None
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, (int, float)):
        v = float(value)
        return (0, -v if direction == "desc" else v, "")
    if isinstance(value, str):
        return (0, 0.0, value) if direction == "asc" else \
            (0, 0.0, _InvertedStr(value))
    return (1, 0.0, "")


class Reader:
    """An immutable point-in-time view of the searchable segments.

    Reference analog: the Lucene ``IndexReader`` acquired per search from the
    engine (Engine.acquireSearcher). Live masks are snapshotted so concurrent
    deletes don't shift results mid-search (scroll contexts hold Readers).
    """

    def __init__(self, segments: List[Segment], generation: int = 0):
        self.segments = list(segments)
        self.live_masks = [seg.live.copy() for seg in segments]
        # the engine's search generation at acquisition: request-cache
        # entries filled from this reader are stamped with it, so a hit
        # can only serve data from the exact searchable state the
        # current generation names
        self.generation = int(generation)
        # freshness key for the shard request cache: (segment identity,
        # live count) per segment, so any refresh/merge/delete naturally
        # invalidates cached entries. Computed EAGERLY (acquire_reader
        # holds the engine lock, so the counts match the snapshot masks
        # above) from the segments' cached live counts — O(segments), not
        # O(docs) mask sums per cache lookup.
        self.freshness: Tuple = tuple(
            (seg.uid, seg.live_count) for seg in segments)

    @property
    def doc_count(self) -> int:
        return int(sum(m.sum() for m in self.live_masks))

    def get(self, doc_id: str) -> Optional[Tuple[Segment, int]]:
        # newest segment wins (an id can appear in older segments as a
        # tombstoned entry)
        for seg, mask in zip(reversed(self.segments), reversed(self.live_masks)):
            d = seg.id_to_doc.get(doc_id)
            if d is not None and mask[d]:
                return seg, d
        return None


class InternalEngine:
    def __init__(self, mapper_service: MapperService,
                 store: Optional[Store] = None,
                 translog: Optional[Translog] = None,
                 primary_term: int = 1,
                 shard_label: str = "shard0",
                 index_sort: Optional[Tuple[str, str]] = None,
                 check_on_startup: Any = False):
        self.mappers = mapper_service
        self.store = store
        self.translog = translog
        self.primary_term = primary_term
        self.shard_label = shard_label
        # index.shard.check_on_startup: 'checksum' verifies every store
        # artifact's CRC32 footer (and walks the translog) before the
        # commit is opened (IndexShard.checkIndex analog)
        self.check_on_startup = check_on_startup
        # tragic-event state (Engine.failEngine): once an IO/corruption
        # failure hits the storage path the engine is failed, the store is
        # marked when the cause is corruption, and listeners (the shard /
        # reconciler) turn the failure into a routing event
        self.failed = False
        self.failure_reason: Optional[str] = None
        self.failure_listeners: List[Callable[[str, Exception], None]] = []
        # (field, order) from index.sort.field/index.sort.order
        # (index/IndexSortConfig.java:57): new segments store docs in
        # sort order, so sort-matching scans read presorted data
        self.index_sort = index_sort
        # ride-along commit metadata (ShardStateMetadata analog): the
        # shard stamps its allocation id here so the gateway fetch can
        # match an on-disk copy to its last-known routing identity
        self.commit_extra: Dict[str, Any] = {}
        self.tracker = LocalCheckpointTracker()
        # soft-deletes analog: a bounded seqno-indexed history of EVERY
        # operation — index, delete tombstone, noop — so a recovery
        # source can replay exactly the ops a returning copy missed
        # instead of shipping the whole store
        # (index.soft_deletes.retention.ops). Kept on replicas too: a
        # promoted replica must be able to serve ops-based recovery.
        self.history_retention_ops = 1024
        self._op_history: Dict[int, Dict[str, Any]] = {}
        self._history_min = 0        # lowest seqno possibly retained
        # primary mode installs a supplier that folds retention leases
        # into the prune floor (shard._retention_floor); None = the
        # retention.ops bound alone
        self.retention_floor_supplier: Optional[Callable[[], int]] = None
        # primary mode installs a supplier persisting the tracker's
        # leases into every commit; recover_from_store surfaces what the
        # opened commit carried so the shard can restore them
        self.commit_leases_supplier: \
            Optional[Callable[[], List[Dict[str, Any]]]] = None
        # installed by the shard (primary AND replica): the last global
        # checkpoint this copy knows, persisted into every commit — a
        # returning copy's proof of how much of its commit is canonical
        # (ops at/below a copy's own persisted gcp can never be rolled
        # back, whatever term they carry)
        self.global_checkpoint_supplier: Optional[Callable[[], int]] = None
        self.recovered_commit_extra: Dict[str, Any] = {}
        # rollback feasibility guard: the max_seqno at the most recent
        # merge (persisted across restarts). A merge purges dead docs;
        # if one ran while above-target ops were already searchable it
        # may have destroyed the pre-rollback copy of a doc — absence
        # of a segment entry then proves nothing
        self._max_seqno_at_last_merge = -1
        self.rollbacks_total = 0
        self.ops_rolled_back_total = 0

        self._lock = threading.RLock()
        self.segments: List[Segment] = []
        self._buffer: Dict[str, Tuple[ParsedDocument, int, int, int]] = {}  # id -> (doc, seqno, version, primary_term)
        self._buffer_order: List[str] = []
        self._version_map: Dict[str, VersionEntry] = {}
        # deletes that must be applied to already-searchable segments at refresh
        self._pending_tombstones: List[str] = []
        self._segment_counter = 0
        self._commit_generation = 0
        self._dirty_live: set = set()   # segments whose live mask changed since last flush
        self.refresh_listeners: List[Callable[[], None]] = []
        # search generation stamp (the request-cache freshness key):
        # moved — with a typed cause — at every transition that changes
        # what a NEW reader would see (refresh, delete visibility,
        # merge, restore). One int read replaces the O(segments)
        # freshness-tuple probe on the cache hot path.
        self.search_generation = next(_SEARCH_GENERATIONS)
        self.search_generation_cause = "refresh"

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------

    def index(self, doc_id: str, source: Dict[str, Any],
              routing: Optional[str] = None,
              op_type: str = "index",
              if_seq_no: Optional[int] = None,
              if_primary_term: Optional[int] = None,
              seqno: Optional[int] = None,
              version: Optional[int] = None,
              primary_term: Optional[int] = None) -> EngineResult:
        """Index a document. Primary path assigns seqno/version; replica path
        (seqno/version given) applies without conflict checks, mirroring
        TransportShardBulkAction primary vs replica ops
        (action/bulk/TransportShardBulkAction.java:141,410)."""
        with self._lock:
            is_replica = seqno is not None
            existing = self._version_map.get(doc_id)
            if not is_replica:
                if op_type == "create" and existing is not None and not existing.deleted:
                    raise VersionConflictError(
                        f"[{doc_id}]: version conflict, document already exists "
                        f"(current version [{existing.version}])")
                if if_seq_no is not None or if_primary_term is not None:
                    if existing is None or existing.deleted:
                        raise VersionConflictError(
                            f"[{doc_id}]: version conflict, document does not exist")
                    if (if_seq_no is not None and existing.seqno != if_seq_no) or \
                       (if_primary_term is not None and existing.primary_term != if_primary_term):
                        raise VersionConflictError(
                            f"[{doc_id}]: version conflict, required seqno [{if_seq_no}], "
                            f"primary term [{if_primary_term}], "
                            f"current document has seqNo [{existing.seqno}] and "
                            f"primary term [{existing.primary_term}]")
                seqno = self.tracker.generate_seqno()
                # version continues past delete tombstones (ES semantics:
                # index v1,v2, delete v3, re-index -> v4)
                version = (existing.version + 1) if existing is not None else 1
                primary_term = self.primary_term
            else:
                primary_term = primary_term or self.primary_term
                version = version or 1
                if existing is not None and existing.seqno >= seqno:
                    # redelivery (a resync re-replicates every op above
                    # the global checkpoint, including ones this copy
                    # already applied live): per-doc seqnos are
                    # monotonic, so an op at/below what we hold is the
                    # same op or one it superseded — record it for
                    # translog/history completeness (crash replay is
                    # order-insensitive per doc thanks to this guard)
                    # without touching the doc's newer state
                    if self.translog is not None:
                        self._translog_add(TranslogOp(
                            "index", seqno, primary_term, doc_id=doc_id,
                            source=source, routing=routing,
                            version=version))
                    self.tracker.mark_processed(seqno)
                    self._history_add({"op_type": "index",
                                       "doc_id": doc_id, "source": source,
                                       "routing": routing, "seqno": seqno,
                                       "version": version,
                                       "primary_term": primary_term})
                    return EngineResult(doc_id, seqno, primary_term,
                                        version, "noop")

            created = existing is None or existing.deleted
            parsed = self.mappers.parse_document(doc_id, source, routing)

            if self.translog is not None:
                self._translog_add(TranslogOp("index", seqno, primary_term,
                                              doc_id=doc_id, source=source,
                                              routing=routing, version=version))

            if doc_id not in self._buffer:
                self._buffer_order.append(doc_id)
                if existing is not None and not existing.deleted:
                    # live copy exists in a searchable segment: tombstone at refresh
                    self._pending_tombstones.append(doc_id)
            self._buffer[doc_id] = (parsed, seqno, version, primary_term)
            self._version_map[doc_id] = VersionEntry(
                seqno, primary_term, version,
                first_seqno=(existing.first_seqno if existing is not None
                             else seqno))
            self.tracker.mark_processed(seqno)
            self._history_add({"op_type": "index", "doc_id": doc_id,
                               "source": source, "routing": routing,
                               "seqno": seqno, "version": version,
                               "primary_term": primary_term})
            return EngineResult(doc_id, seqno, primary_term, version,
                                "created" if created else "updated")

    def delete(self, doc_id: str,
               if_seq_no: Optional[int] = None,
               if_primary_term: Optional[int] = None,
               seqno: Optional[int] = None,
               version: Optional[int] = None,
               primary_term: Optional[int] = None) -> EngineResult:
        with self._lock:
            is_replica = seqno is not None
            existing = self._version_map.get(doc_id)
            if not is_replica:
                if if_seq_no is not None or if_primary_term is not None:
                    if existing is None or existing.deleted:
                        raise VersionConflictError(
                            f"[{doc_id}]: version conflict, document does not exist")
                    if (if_seq_no is not None and existing.seqno != if_seq_no) or \
                       (if_primary_term is not None and existing.primary_term != if_primary_term):
                        raise VersionConflictError(f"[{doc_id}]: version conflict on delete")
                seqno = self.tracker.generate_seqno()
                version = (existing.version + 1) if existing is not None else 1
                primary_term = self.primary_term
            else:
                primary_term = primary_term or self.primary_term
                version = version or 1
                if existing is not None and existing.seqno >= seqno:
                    # redelivered delete (see the index() replica guard)
                    if self.translog is not None:
                        self._translog_add(TranslogOp(
                            "delete", seqno, primary_term, doc_id=doc_id,
                            version=version))
                    self.tracker.mark_processed(seqno)
                    self._history_add({"op_type": "delete",
                                       "doc_id": doc_id, "seqno": seqno,
                                       "version": version,
                                       "primary_term": primary_term})
                    return EngineResult(doc_id, seqno, primary_term,
                                        version, "noop")

            found = existing is not None and not existing.deleted
            if self.translog is not None:
                self._translog_add(TranslogOp("delete", seqno, primary_term,
                                              doc_id=doc_id, version=version))
            if doc_id in self._buffer:
                del self._buffer[doc_id]
                self._buffer_order.remove(doc_id)
            if found:
                self._pending_tombstones.append(doc_id)
            self._version_map[doc_id] = VersionEntry(
                seqno, primary_term, version, deleted=True,
                first_seqno=(existing.first_seqno if existing is not None
                             else seqno))
            self.tracker.mark_processed(seqno)
            # the delete TOMBSTONE is what soft-deletes exist for: a
            # file-less catch-up must be able to replay "doc X died at
            # seqno N" — live-doc snapshots can't express that
            self._history_add({"op_type": "delete", "doc_id": doc_id,
                               "seqno": seqno, "version": version,
                               "primary_term": primary_term})
            return EngineResult(doc_id, seqno, primary_term, version,
                                "deleted" if found else "not_found")

    def noop(self, seqno: int, reason: str = "",
             primary_term: Optional[int] = None) -> None:
        """Fill a seqno hole (primary failover safety), reference: Engine.noOp.
        A replica replaying a noop passes the op's ORIGINAL term so the
        history/translog record keeps the primacy it was minted under."""
        term = primary_term if primary_term is not None else self.primary_term
        with self._lock:
            if self.translog is not None:
                self._translog_add(TranslogOp("noop", seqno, term,
                                              reason=reason))
            self.tracker.mark_processed(seqno)
            self._history_add({"op_type": "noop", "seqno": seqno,
                               "primary_term": term,
                               "reason": reason})

    # ------------------------------------------------------------------
    # operation history (soft-deletes analog)
    # ------------------------------------------------------------------

    def _history_floor(self) -> int:
        """Lowest seqno the history must retain. The retention.ops bound
        keeps the last N ops; on a primary, the retention leases fold in
        (Engine.getMinRetainedSeqNo analog) so a tracked-but-departed
        copy's tail outlives the count bound until its lease expires."""
        floor = self.tracker.max_seqno - self.history_retention_ops + 1
        if self.retention_floor_supplier is not None:
            floor = min(floor, self.retention_floor_supplier())
        return floor

    def _history_add(self, op: Dict[str, Any]) -> None:
        """Record a wire-form op; amortized prune below the floor (each
        seqno is pushed and popped at most once, so the while loop is
        O(1) amortized however far the floor jumped)."""
        self._op_history[op["seqno"]] = op
        floor = self._history_floor()
        while self._history_min < floor:
            self._op_history.pop(self._history_min, None)
            self._history_min += 1

    def ops_history_snapshot(self, from_seqno: int
                             ) -> Tuple[List[Dict[str, Any]], bool]:
        """(retained ops with seqno >= from_seqno in order, complete).
        ``complete`` means every seqno in [from_seqno, max_seqno] is
        present — the recovery source's gate for the ops-based path; any
        hole or pruned prefix forces the file-based fallback."""
        with self._lock:
            max_s = self.tracker.max_seqno
            ops: List[Dict[str, Any]] = []
            complete = True
            for s in range(max(0, from_seqno), max_s + 1):
                op = self._op_history.get(s)
                if op is None:
                    complete = False
                else:
                    ops.append(op)
            return ops, complete

    def history_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"retained_ops": len(self._op_history),
                    "history_min_seqno": self._history_min,
                    "retention_ops_setting": self.history_retention_ops}

    # ------------------------------------------------------------------
    # failure handling
    # ------------------------------------------------------------------

    def _translog_add(self, op: TranslogOp) -> None:
        try:
            self.translog.add(op)
        except OSError as e:
            # a failed WAL append is a tragic event: the op was NOT made
            # durable, so the engine must stop acknowledging writes
            self._fail_engine("translog append failed", e)
            raise

    def _fail_engine(self, reason: str, exc: Exception) -> None:
        """Tragic-event handler (Engine.failEngine analog): mark the store
        corrupted when the cause is corruption, then notify listeners so
        the shard is failed to the master instead of limping along."""
        with self._lock:
            if self.failed:
                return
            self.failed = True
            self.failure_reason = f"{reason}: {exc}"
            listeners = list(self.failure_listeners)
        if isinstance(exc, ShardCorruptedError) and self.store is not None:
            try:
                self.store.mark_corrupted(f"{reason}: {exc}")
            except Exception:  # noqa: BLE001 — marking is best-effort
                logger.exception("failed to write corruption marker")
        logger.error("engine [%s] failed: %s: %s",
                     self.shard_label, reason, exc)
        for fn in listeners:
            try:
                fn(reason, exc)
            except Exception:  # noqa: BLE001 — listeners must not mask
                logger.exception("engine failure listener threw")

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------

    def get(self, doc_id: str, realtime: bool = True) -> Optional[Dict[str, Any]]:
        """Realtime get: buffer first (translog-get analog), then segments."""
        with self._lock:
            entry = self._version_map.get(doc_id)
            if entry is not None and entry.deleted:
                return None
            if realtime and doc_id in self._buffer:
                parsed, seqno, version, term = self._buffer[doc_id]
                return {"_id": doc_id, "_source": parsed.source,
                        "_seq_no": seqno, "_version": version,
                        "_primary_term": term}
            reader = self.acquire_reader()
        hit = reader.get(doc_id)
        if hit is None:
            return None
        seg, d = hit
        return {"_id": doc_id, "_source": seg.sources[d],
                "_seq_no": int(seg.seqnos[d]) if len(seg.seqnos) > d else 0,
                "_version": int(seg.versions[d]) if len(seg.versions) > d else 1,
                "_primary_term": int(seg.primary_terms[d]) if len(seg.primary_terms) > d else 1}

    def acquire_reader(self) -> Reader:
        with self._lock:
            return Reader(self.segments,
                          generation=self.search_generation)

    def _bump_search_generation(self, cause: str) -> None:
        """Called under the engine lock at every searchable-state
        transition: the stamp moves and records WHY, so the request
        cache's invalidation counters are typed at the source."""
        self.search_generation = next(_SEARCH_GENERATIONS)
        self.search_generation_cause = cause

    def freshness(self) -> Tuple:
        """The reader freshness key WITHOUT building a reader: no live
        masks are copied, so a cache lookup at batcher intake stays
        O(segments) on a shard of any size."""
        with self._lock:
            return tuple((seg.uid, seg.live_count)
                         for seg in self.segments)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def refresh(self) -> bool:
        """Make buffered writes searchable. Returns True if anything changed."""
        with self._lock:
            if not self._buffer and not self._pending_tombstones:
                return False
            # tombstones becoming VISIBLE is the delete cause; a pure
            # new-segment publish is the refresh cause (an update — new
            # copy + tombstone on the old — attributes to delete, the
            # mutation that can shrink a cached result)
            deletes_visible = bool(self._pending_tombstones)
            # apply tombstones to existing segments (newest copy wins search)
            for doc_id in self._pending_tombstones:
                for seg in self.segments:
                    d = seg.id_to_doc.get(doc_id)
                    if d is not None and seg.live[d]:
                        seg.delete_doc(d)
                        self._dirty_live.add(seg.name)
            self._pending_tombstones.clear()

            if self._buffer:
                self._segment_counter += 1
                builder = SegmentBuilder(
                    f"{self.shard_label}_seg{self._segment_counter}", self.mappers)
                order = list(self._buffer_order)
                if self.index_sort is not None:
                    order = self._sorted_buffer_order(order)
                for doc_id in order:
                    parsed, seqno, version, term = self._buffer[doc_id]
                    builder.add(parsed, seqno, version, term)
                self.segments.append(builder.build())
                self._buffer.clear()
                self._buffer_order.clear()
            self._bump_search_generation(
                "delete" if deletes_visible else "refresh")
            listeners = list(self.refresh_listeners)
        for fn in listeners:
            fn()
        return True

    def _sorted_buffer_order(self, order):
        """Buffer ids reordered by the index sort field (missing values
        last, ties in arrival order — IndexSortConfig semantics)."""
        fname, direction = self.index_sort
        return sorted(order, key=lambda doc_id: _index_sort_key(
            self._buffer[doc_id][0].source.get(fname), direction))

    def flush(self) -> None:
        """Commit: refresh, persist, roll translog. Reference: InternalEngine.flush:489."""
        try:
            self._flush_inner()
        except (ShardCorruptedError, OSError) as e:
            # a failed commit (EIO/ENOSPC/corrupt read-back) is tragic:
            # the on-disk state can no longer be trusted to match memory
            self._fail_engine("flush failed", e)
            raise

    def _flush_inner(self) -> None:
        with self._lock:
            self.refresh()
            if self.store is None:
                return
            committed = set()
            commit = self.store.read_latest_commit()
            if commit:
                committed = set(commit["segments"])
            for seg in self.segments:
                if seg.name not in committed:
                    self.store.write_segment(seg)
                elif seg.name in self._dirty_live:
                    self.store.write_live_mask(seg)
            self._dirty_live.clear()
            translog_gen = self.translog.rollover() if self.translog is not None else 0
            self._commit_generation += 1
            # the term stamps WHICH primacy's history this commit
            # belongs to: recovery reuse must refuse a commit from an
            # older term — the same seqno can name different ops
            # across a failover
            extra = {**self.commit_extra, "primary_term": self.primary_term,
                     "max_seqno_at_last_merge": self._max_seqno_at_last_merge}
            if self.global_checkpoint_supplier is not None:
                # the copy's own durable knowledge of the global
                # checkpoint: after a failover, everything at/below it
                # in this commit is canonical history no new primary
                # can have diverged from
                extra["global_checkpoint"] = \
                    int(self.global_checkpoint_supplier())
            if self.commit_leases_supplier is not None:
                # leases ride every commit (ReplicationTracker persists
                # them in the Lucene commit user data) so a restarted
                # primary keeps honoring history it promised to departed
                # copies
                extra["retention_leases"] = self.commit_leases_supplier()
            self.store.write_commit(
                self._commit_generation,
                [seg.name for seg in self.segments],
                self.tracker.max_seqno,
                self.tracker.checkpoint,
                translog_gen,
                extra=extra,
            )
            if self.translog is not None:
                # retention-aware trim: generations still backing the op
                # history floor survive the commit, so the history can be
                # rebuilt after a restart
                self.translog.trim_below(
                    translog_gen, keep_from_seqno=self._history_floor())
            # remove orphaned segment files from superseded merges
            on_disk = set(self.store.list_segment_files())
            current = {seg.name for seg in self.segments}
            for name in on_disk - current:
                self.store.delete_segment(name)

    def maybe_merge(self, max_segments: int = 8) -> bool:
        """Tiered-lite merge policy: when segment count exceeds the budget,
        merge the smallest half into one (purging deletes)."""
        with self._lock:
            if len(self.segments) <= max_segments:
                return False
            by_size = sorted(self.segments, key=lambda s: s.live_count)
            to_merge = by_size[: len(by_size) // 2 + 1]
            return self._merge(to_merge)

    def force_merge(self, max_num_segments: int = 1) -> bool:
        """Merge down to at most max_num_segments (ES _forcemerge contract).
        Segments with deletes are rewritten even if the count already fits."""
        with self._lock:
            has_deletes = any(not seg.live.all() for seg in self.segments)
            if len(self.segments) <= max_num_segments and not has_deletes:
                return False
            if len(self.segments) > max_num_segments:
                # merge the oldest segments together until the count fits
                n_to_merge = len(self.segments) - max_num_segments + 1
                merged_any = self._merge(self.segments[:n_to_merge])
            else:
                merged_any = False
            # rewrite any remaining segment that still carries deletes
            for seg in [s for s in self.segments if not s.live.all()]:
                merged_any = self._merge([seg]) or merged_any
            return merged_any

    def _merge(self, to_merge: List[Segment]) -> bool:
        self._segment_counter += 1
        name = f"{self.shard_label}_seg{self._segment_counter}"
        if self.index_sort is not None:
            merged = self._merge_sorted(name, to_merge)
        else:
            merged = merge_segments(name, to_merge, self.mappers)
        self.segments = _insert_merged(merged, self.segments, to_merge)
        self._max_seqno_at_last_merge = self.tracker.max_seqno
        self._bump_search_generation("merge")
        # merged-away segments are dead to every FUTURE reader (the plane
        # registry keys on segment uids): free their device planes now
        # instead of leaving the HBM to LRU pressure. A still-open scroll
        # over the pre-merge snapshot will transparently re-pack its
        # plane on its next query — rare, correct, and cheaper than
        # pinning a superseded plane for every merge
        import sys
        mod = sys.modules.get("elasticsearch_tpu_torch.ops.device_segment")
        if mod is not None:
            try:
                mod.PLANES.drop_segments(seg.uid for seg in to_merge)
                mod.MESH_PLANES.drop_segments(
                    seg.uid for seg in to_merge)
            except Exception:  # noqa: BLE001 — cleanup must not fail merge
                logger.exception("plane invalidation after merge failed")
        return True

    def _merge_sorted(self, name: str, to_merge: List[Segment]) -> Segment:
        """Merge live docs REBUILT in index-sort order: a plain
        concatenating merge would violate the index.sort contract the
        refresh path established (the reference re-sorts at merge when an
        index sort is configured, IndexSortConfig + SortingLeafReader)."""
        rows = []   # (id, source, routing, seqno, version, primary_term)
        for seg in to_merge:
            for d in range(seg.n_docs):
                if not seg.live[d]:
                    continue
                rows.append((
                    seg.ids[d], seg.sources[d] or {},
                    seg.routings[d] if d < len(seg.routings) else None,
                    int(seg.seqnos[d]) if d < len(seg.seqnos) else 0,
                    int(seg.versions[d]) if d < len(seg.versions) else 1,
                    int(seg.primary_terms[d])
                    if d < len(seg.primary_terms) else 1))
        fname, direction = self.index_sort
        rows.sort(key=lambda row: _index_sort_key(row[1].get(fname),
                                                  direction))
        # re-parse is the price of the rebuild (merges are rare, heavy
        # operations by contract); versions/terms/seqnos carry over so
        # optimistic concurrency survives the merge
        builder = SegmentBuilder(name, self.mappers)
        for doc_id, source, routing, seqno, version, term in rows:
            builder.add(self.mappers.parse_document(doc_id, source,
                                                    routing=routing),
                        seqno, version, term)
        return builder.build()

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------

    def snapshot_ops(self) -> Tuple[List[Dict[str, Any]], int]:
        """(live ops sorted by seqno, max_seqno) — the recovery source's
        phase1+phase2 payload (every live doc as an index op with its
        original seqno/version/term; history holes are the target's to
        fill). Atomic under the engine lock."""
        with self._lock:
            ops: List[Dict[str, Any]] = []
            reader = Reader(self.segments,
                            generation=self.search_generation)
            for seg, mask in zip(reader.segments, reader.live_masks):
                for doc_id, d in seg.id_to_doc.items():
                    if mask[d]:
                        ops.append({
                            "op_type": "index", "doc_id": doc_id,
                            "source": seg.sources[d],
                            "routing": (seg.routings[d]
                                        if d < len(seg.routings)
                                        else None),
                            "seqno": int(seg.seqnos[d]),
                            "version": int(seg.versions[d]),
                            "primary_term": int(seg.primary_terms[d]),
                        })
            for doc_id in self._buffer_order:
                parsed, seqno, version, term = self._buffer[doc_id]
                ops.append({"op_type": "index", "doc_id": doc_id,
                            "source": parsed.source,
                            "routing": parsed.routing,
                            "seqno": seqno, "version": version,
                            "primary_term": term})
            ops.sort(key=lambda op: op["seqno"])
            return ops, self.tracker.max_seqno

    def recover_from_store(self) -> int:
        """Open the last commit and replay the translog tail.

        Reference analog: InternalEngine opening the last Lucene commit and
        replaying translog ops > local_checkpoint (crash recovery, §5.4).
        Returns the number of replayed ops.

        Integrity gates (in order): a corruption-marked store refuses to
        open at all; ``index.shard.check_on_startup: checksum`` verifies
        every artifact's CRC32 footer up front; and any corruption found
        while actually reading (segments, commit point, translog) marks
        the store and fails the engine — recovery never half-opens over
        bad bytes.
        """
        try:
            return self._recover_from_store_inner()
        except ShardCorruptedError as e:
            self._fail_engine("store recovery failed", e)
            raise

    def _recover_from_store_inner(self) -> int:
        if self.store is not None:
            self.store.ensure_not_corrupted()
            if str(self.check_on_startup).lower() in ("checksum", "true"):
                self.store.verify_integrity()
                if self.translog is not None:
                    self.translog.verify()
        with self._lock:
            commit = self.store.read_latest_commit() if self.store else None
            if commit:
                for name in commit["segments"]:
                    seg = self.store.read_segment(name)
                    liv = self.store.read_live_mask(name)
                    if liv is not None:
                        seg.live = liv
                        seg.invalidate_live_count()
                    self.segments.append(seg)
                    num = int(name.rsplit("_seg", 1)[1]) if "_seg" in name else 0
                    self._segment_counter = max(self._segment_counter, num)
                self._commit_generation = commit["generation"]
                self.tracker = LocalCheckpointTracker(
                    commit["max_seqno"], commit["local_checkpoint"])
                # surface what the opened commit carried (primary term,
                # allocation id, persisted retention leases) so the shard
                # layer can restore leases / report watermarks
                self.recovered_commit_extra = dict(commit.get("extra") or {})
                self._max_seqno_at_last_merge = int(
                    self.recovered_commit_extra.get(
                        "max_seqno_at_last_merge", -1))
                # mark seqnos persisted in segments as processed —
                # CLAMPED to the commit's recorded max: a rolled-back
                # commit can still carry dead docs stamped with
                # discarded seqnos, and resurrecting those watermarks
                # would undo the rollback on the next reopen
                commit_max = int(commit["max_seqno"])
                for seg in self.segments:
                    for s in seg.seqnos:
                        if int(s) <= commit_max:
                            self.tracker.mark_processed(int(s))
            # rebuild version map from segments (newest segment wins)
            for seg in self.segments:
                for doc_id, d in seg.id_to_doc.items():
                    if seg.live[d]:
                        self._version_map[doc_id] = VersionEntry(
                            int(seg.seqnos[d]) if len(seg.seqnos) > d else 0,
                            int(seg.primary_terms[d]) if len(seg.primary_terms) > d else 1,
                            int(seg.versions[d]) if len(seg.versions) > d else 1)

            replayed = 0
            if self.translog is not None:
                start = self.tracker.checkpoint + 1
                # snapshot before replaying: _replay re-logs each op into the
                # current generation, which read_all would otherwise also see
                ops = list(self.translog.read_all(min_seqno=0))
                # ops at/below the checkpoint are already durable in
                # segments — they only REPOPULATE the soft-delete history
                # (retained generations survive trim for exactly this);
                # ops above it are replayed normally (and land in the
                # history via the write path)
                for op in ops:
                    if op.seqno < start:
                        self._history_add(_op_to_wire(op))
                for op in ops:
                    if op.seqno >= start:
                        self._replay(op)
                        replayed += 1
                if self._op_history:
                    self._history_min = min(self._op_history)
            # commit the replayed state so the translog is trimmed; otherwise
            # every crash/recover cycle doubles the translog (replayed ops are
            # re-logged into the new generation)
            if self.store is not None:
                self.flush()
            else:
                self.refresh()
            return replayed

    def rollback_above(self, target: int) -> int:
        """Discard every op with seqno > ``target`` in place (the engine
        half of the reference's resetEngineToGlobalCheckpoint): a copy
        that learns of a new primacy drops its deposed-term tail and
        replays the new primary's history instead of wiping its store.

        Feasibility is proven per touched doc, never guessed: the doc's
        state at ``target`` must be reconstructible from the retained op
        history, from a segment copy whose successor ops are provably
        all above the target, or — for docs created entirely above the
        target — from the version map's first-seqno record (backed by
        the persisted merge watermark when the first write predates this
        incarnation). Anything unprovable raises
        RollbackInfeasibleError BEFORE any state changes, and the caller
        falls back to the typed wipe path. The rollback ends with a
        flush plus a translog trim so a crash immediately after cannot
        replay the discarded tail back in. Returns the number of seqnos
        discarded."""
        with self._lock:
            old_max = self.tracker.max_seqno
            if old_max <= target:
                return 0
            if self.tracker.checkpoint < target:
                raise RollbackInfeasibleError(
                    f"local checkpoint {self.tracker.checkpoint} leaves "
                    f"holes below rollback target {target}")
            touched = [doc_id for doc_id, e in self._version_map.items()
                       if e.seqno > target]
            # plan first — a raise here leaves the engine untouched
            plans = {doc_id: self._rollback_authority(doc_id, target)
                     for doc_id in touched}
            # kill every searchable copy of a discarded op
            for seg in self.segments:
                for d in range(seg.n_docs):
                    if seg.live[d] and int(seg.seqnos[d]) > target:
                        seg.delete_doc(d)
                        self._dirty_live.add(seg.name)
            for doc_id, plan in plans.items():
                self._apply_rollback_plan(doc_id, plan)
            for s in [s for s in self._op_history if s > target]:
                del self._op_history[s]
            self.tracker = LocalCheckpointTracker(target, target)
            self.rollbacks_total += 1
            self.ops_rolled_back_total += old_max - target
            self._bump_search_generation("rollback")
            if self.translog is not None:
                self.translog.trim_ops_above(target)
            if self.store is not None:
                self.flush()
            else:
                self.refresh()
            return old_max - target

    def _history_covers(self, lo: int, hi: int) -> bool:
        return all(s in self._op_history for s in range(lo, hi + 1))

    def _rollback_authority(self, doc_id: str,
                            target: int) -> Dict[str, Any]:
        """What was this doc at seqno ``target``? Returns a restore plan
        or raises RollbackInfeasibleError. An authority is only accepted
        with PROOF it is the doc's newest op at/below the target —
        retained history covering every seqno between it and the target
        with no later op for this doc in between."""
        h_op = None
        for op in self._op_history.values():
            if op.get("doc_id") == doc_id and op["seqno"] <= target:
                if h_op is None or op["seqno"] > h_op["seqno"]:
                    h_op = op
        if h_op is not None and self._history_covers(h_op["seqno"] + 1,
                                                     target):
            return {"kind": h_op["op_type"], "op": h_op}
        best = None   # (seqno, seg, docnum): newest committed copy
        for seg in self.segments:
            d = seg.id_to_doc.get(doc_id)
            if d is None:
                continue
            s = int(seg.seqnos[d])
            if s <= target and (best is None or s > best[0]):
                best = (s, seg, d)
        if best is not None and self._history_covers(best[0] + 1, target):
            return {"kind": "segment", "seg": best[1], "d": best[2],
                    "seqno": best[0]}
        entry = self._version_map[doc_id]
        if h_op is None and best is None and (
                (entry.first_seqno != -1 and entry.first_seqno > target)
                or self._max_seqno_at_last_merge <= target):
            # created entirely above the target: either this incarnation
            # watched its first write land above it, or no merge since
            # the target could have purged a pre-existing copy
            return {"kind": "absent"}
        raise RollbackInfeasibleError(
            f"cannot prove state of doc [{doc_id}] at seqno {target}: "
            f"history pruned and no committed copy at/below the target")

    def _apply_rollback_plan(self, doc_id: str,
                             plan: Dict[str, Any]) -> None:
        if doc_id in self._buffer:
            del self._buffer[doc_id]
            self._buffer_order.remove(doc_id)
        if doc_id in self._pending_tombstones:
            self._pending_tombstones = [
                t for t in self._pending_tombstones if t != doc_id]
        prev = self._version_map.get(doc_id)
        first = prev.first_seqno if prev is not None else -1
        kind = plan["kind"]
        if kind == "absent":
            self._version_map.pop(doc_id, None)
            return
        if kind == "delete":
            op = plan["op"]
            self._version_map[doc_id] = VersionEntry(
                op["seqno"], op["primary_term"], op.get("version", 1),
                deleted=True, first_seqno=first)
            return
        if kind == "segment":
            seg, d, seqno = plan["seg"], plan["d"], plan["seqno"]
            source = seg.sources[d] or {}
            routing = seg.routings[d] if d < len(seg.routings) else None
            version = int(seg.versions[d]) if d < len(seg.versions) else 1
            term = (int(seg.primary_terms[d])
                    if d < len(seg.primary_terms) else 1)
        else:   # "index" — wire-form history op
            op = plan["op"]
            seqno, version = op["seqno"], op.get("version", 1)
            term = op["primary_term"]
            source, routing = op.get("source") or {}, op.get("routing")
        live_at_auth = False
        live_elsewhere = False
        for seg in self.segments:
            d = seg.id_to_doc.get(doc_id)
            if d is not None and seg.live[d]:
                if int(seg.seqnos[d]) == seqno:
                    live_at_auth = True
                else:
                    live_elsewhere = True
        self._version_map[doc_id] = VersionEntry(seqno, term, version,
                                                 first_seqno=first)
        if live_at_auth:
            return   # the committed copy is still searchable as-is
        # re-surface the restored state through the buffer (the uniform
        # path: the closing flush rebuilds the searchable copy); a stale
        # older live copy is tombstoned first, exactly as index() would
        if live_elsewhere:
            self._pending_tombstones.append(doc_id)
        parsed = self.mappers.parse_document(doc_id, source, routing)
        self._buffer_order.append(doc_id)
        self._buffer[doc_id] = (parsed, seqno, version, term)

    def restore_segments(self, segments: List[Segment]) -> None:
        """Replace ALL engine state with the given segments (snapshot
        restore; RestoreService.java:121 runs restore as a special recovery
        source the same way)."""
        with self._lock:
            self.segments = list(segments)
            self._bump_search_generation("restore")
            self._buffer.clear()
            self._buffer_order.clear()
            self._pending_tombstones.clear()
            # continue numbering past the restored names (sparse after
            # merges); a collision would shadow a committed segment file
            self._segment_counter = 0
            for seg in self.segments:
                if "_seg" in seg.name:
                    try:
                        num = int(seg.name.rsplit("_seg", 1)[1])
                        self._segment_counter = max(self._segment_counter,
                                                    num)
                    except ValueError:
                        pass
            max_seq = -1
            self._version_map = {}
            for seg in self.segments:
                for doc_id, d in seg.id_to_doc.items():
                    if seg.live[d]:
                        self._version_map[doc_id] = VersionEntry(
                            int(seg.seqnos[d]) if len(seg.seqnos) > d else 0,
                            int(seg.primary_terms[d])
                            if len(seg.primary_terms) > d else 1,
                            int(seg.versions[d])
                            if len(seg.versions) > d else 1)
                if len(seg.seqnos):
                    max_seq = max(max_seq, int(seg.seqnos.max()))
            self.tracker = LocalCheckpointTracker(max_seq, max_seq)
            if self.store is not None:
                self.flush()

    def _replay(self, op: TranslogOp) -> None:
        if op.op_type == "index":
            self.index(op.doc_id, op.source, routing=op.routing,
                       seqno=op.seqno, version=op.version, primary_term=op.primary_term)
        elif op.op_type == "delete":
            self.delete(op.doc_id, seqno=op.seqno, version=op.version,
                        primary_term=op.primary_term)
        elif op.op_type == "noop":
            self.noop(op.seqno, reason=op.reason or "",
                      primary_term=op.primary_term)

    # ------------------------------------------------------------------

    @property
    def doc_count(self) -> int:
        """Searchable doc count (buffer not visible until refresh)."""
        with self._lock:
            return sum(seg.live_count for seg in self.segments)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "num_segments": len(self.segments),
                "doc_count": self.doc_count,
                "buffered_docs": len(self._buffer),
                "max_seqno": self.tracker.max_seqno,
                "local_checkpoint": self.tracker.checkpoint,
                "translog_ops": self.translog.total_ops if self.translog else 0,
            }

    def close(self) -> None:
        if self.translog is not None:
            try:
                self.translog.close()
            except OSError:
                # a dying disk must not keep a failed shard from being
                # removed (close-on-failure path)
                logger.warning("translog close failed for [%s]",
                               self.shard_label)


def _op_to_wire(op: TranslogOp) -> Dict[str, Any]:
    """TranslogOp -> the wire-form dict the recovery protocol replays
    (the same shape snapshot_ops and the history emit)."""
    d: Dict[str, Any] = {"op_type": op.op_type, "seqno": op.seqno,
                         "primary_term": op.primary_term}
    if op.op_type == "index":
        d.update(doc_id=op.doc_id, source=op.source, routing=op.routing,
                 version=op.version)
    elif op.op_type == "delete":
        d.update(doc_id=op.doc_id, version=op.version)
    else:
        d["reason"] = op.reason or ""
    return d


def _insert_merged(merged: Segment, original: List[Segment],
                   merged_from: List[Segment]) -> List[Segment]:
    """Place the merged segment at the position of its oldest constituent so
    newest-wins id lookups (Reader.get) stay correct."""
    out: List[Segment] = []
    inserted = False
    for seg in original:
        if seg in merged_from:
            if not inserted:
                out.append(merged)
                inserted = True
            continue
        out.append(seg)
    return out
