"""The two-tier request cache for duplicate-heavy traffic.

Reference analog: indices/IndicesRequestCache.java:69 — shard-level
results cached by reader identity and normalized request bytes,
invalidated when the reader changes. This build rebuilds it around the
engine's **search generation stamp** (index/engine.py): every
refresh / delete-visibility / merge / restore bumps a per-shard integer
and records WHY, so

- the hot-path lookup is one attribute read plus one dict probe — no
  engine lock, no O(segments) freshness-tuple build, no reader
  acquisition (the PR 9 intake consult paid a freshness walk per
  lookup);
- every invalidation is **typed**: entries dropped because their
  generation moved count under the cause that moved it
  (refresh / delete / merge / restore — anything else is "unknown",
  which the test suite pins at zero, the telemetry-taxonomy precedent).

Two tiers share the machinery:

- :class:`ShardRequestCache` (one per data node's
  SearchTransportService): response rows keyed by
  (shard, generation, normalized plan). size=0 bodies — counts and the
  aggregation dashboards — cache by default, exactly the reference's
  default coverage; the top-k shapes (text/kNN/sparse hits+totals)
  cache when ``search.request_cache.topk`` is on fleet-wide or the
  request opts in with ``"request_cache": true`` (the reference's
  ``?request_cache=true`` contract for size>0).
- :class:`FusedResultCache` (one per coordinator's
  TransportSearchAction): the FUSED end-to-end response of a whole
  fan-out, keyed by (concrete-indices tenant key, normalized request,
  participating-shard generation **vector**) — a duplicate fan-out
  skips shard dispatch entirely, and the moment ANY member shard's
  generation moves the vector no longer matches. Engages only when
  every target shard is locally present (the mesh co-location shape:
  the coordinator can read every member generation without an RPC).

Memory honesty: entries are charged to the ``request_cache`` breaker
child (indices/breaker.py) and bounded by ``search.request_cache.
max_bytes`` with LRU eviction — cold entries free memory BEFORE a trip,
and a breaker-starved cache refuses new entries (typed
``entries_refused``) while serving every query uncached-identical.
"""

from __future__ import annotations

import json
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

# the typed invalidation taxonomy: every dropped-because-stale entry
# counts under the engine-recorded cause of the generation move; an
# unrecognized cause maps to "unknown", which tests pin at zero (the
# search-telemetry fallback-taxonomy precedent)
INVALIDATION_CAUSES = ("refresh", "delete", "merge", "restore", "clear",
                       "disabled", "rollback", "unknown")


def _typed_cause(raw: Any) -> str:
    return raw if raw in INVALIDATION_CAUSES else "unknown"


def _release_resident(holder: Dict[str, int], breaker_name: str) -> None:
    """GC backstop (the DeviceCharge finalizer precedent): a cache that
    dies with its node (in-process test clusters) hands its whole
    resident charge back to the process-global breaker."""
    try:
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS
        BREAKERS.breaker(breaker_name).release(holder["bytes"])
        holder["bytes"] = 0
    except Exception:  # noqa: BLE001 — teardown must never raise
        pass


class _CacheTier:
    """Shared LRU + breaker accounting: an ordered entry map whose
    resident bytes are charged to the ``request_cache`` breaker child,
    evicted coldest-first against ``max_bytes``, and refused (typed)
    when even a fully-evicted cache cannot fit the budget."""

    BREAKER = "request_cache"

    def __init__(self) -> None:
        # key -> {"stamp": <validity stamp>, "row": <payload>,
        #         "bytes": int}
        self._entries: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
        # one mutable holder shared with the GC finalizer so the charge
        # released at teardown is whatever is resident THEN
        self._resident = {"bytes": 0}
        weakref.finalize(self, _release_resident, self._resident,
                         self.BREAKER)
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "puts": 0, "evictions": 0,
            "entries_refused": 0, "oversize_refused": 0,
        }
        self.invalidations_by_cause: Dict[str, int] = {}
        # dynamic settings (search.request_cache.*), applied from
        # committed cluster state via configure_from_state
        self.enabled = True
        self.topk = False
        self.max_bytes = 32 << 20
        self.max_entry_bytes = 1 << 20
        self._cfg_version: Any = object()   # never equals a real version

    # -- config ---------------------------------------------------------

    def configure_from_state(self, state) -> None:
        """Version-memoized read of the ``search.request_cache.*``
        family (the search.plane.* application pattern): one attribute
        compare per request, a real parse only when the committed state
        changed."""
        version = getattr(state, "version", None)
        if version is not None and version == self._cfg_version:
            return
        self._cfg_version = version
        was_enabled = self.enabled
        self._apply_settings(state)
        if was_enabled and not self.enabled:
            self.clear(cause="disabled")
        elif self._resident["bytes"] > self.max_bytes:
            # a shrunk budget applies NOW, not at the next insert
            self._evict_until(self.max_bytes)

    def _apply_settings(self, state) -> None:
        from elasticsearch_tpu_torch.utils.settings import (
            SEARCH_REQUEST_CACHE_ENABLED, SEARCH_REQUEST_CACHE_MAX_BYTES,
            SEARCH_REQUEST_CACHE_MAX_ENTRY_BYTES,
            SEARCH_REQUEST_CACHE_TOPK, setting_from_state,
        )
        self.enabled = setting_from_state(state,
                                          SEARCH_REQUEST_CACHE_ENABLED)
        self.topk = setting_from_state(state, SEARCH_REQUEST_CACHE_TOPK)
        self.max_bytes = setting_from_state(
            state, SEARCH_REQUEST_CACHE_MAX_BYTES)
        self.max_entry_bytes = setting_from_state(
            state, SEARCH_REQUEST_CACHE_MAX_ENTRY_BYTES)

    # which requests may never cache at THIS tier beyond the shared
    # rules: the coordinator tier refuses [timeout]-carrying bodies (a
    # budgeted fan-out's response is legitimately nondeterministic; the
    # shard tier is safe — a member either completes its row or errors,
    # and errors never fill)
    EXCLUDE_BUDGETED = False

    def covers(self, body: Dict[str, Any], window: int) -> bool:
        """THE cacheability predicate, shared by both tiers so coverage
        rules cannot drift between them: the tier must be enabled, the
        request must carry no per-request state a cached row cannot
        reproduce (profile trees, slices), and size>0 top-k shapes need
        the fleet-wide ``search.request_cache.topk`` gate or the
        request's own ``"request_cache": true`` opt-in (the reference's
        size>0 contract). ``"request_cache": false`` always opts out."""
        if not self.enabled:
            return False
        explicit = body.get("request_cache")
        if isinstance(explicit, str):
            # the reference's ?request_cache=false string form: a client
            # sending "false" asked for UNCACHED — bool("false") being
            # truthy must never read as an opt-in
            lowered = explicit.strip().lower()
            explicit = True if lowered in ("true", "1", "yes") else \
                False if lowered in ("false", "0", "no") else None
        if explicit is False:
            return False
        if body.get("slice") or body.get("profile"):
            return False
        if self.EXCLUDE_BUDGETED and body.get("timeout") is not None:
            return False
        if window <= 0:
            return True
        return bool(explicit) or self.topk

    # -- entry lifecycle ------------------------------------------------

    def _breaker(self):
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS
        return BREAKERS.breaker(self.BREAKER)

    def _drop(self, key: Any, counter: Optional[str] = None,
              cause: Optional[str] = None) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._resident["bytes"] -= entry["bytes"]
        self._breaker().release(entry["bytes"])
        if counter is not None:
            self.stats[counter] += 1
        if cause is not None:
            cause = _typed_cause(cause)
            self.invalidations_by_cause[cause] = \
                self.invalidations_by_cause.get(cause, 0) + 1
        self._on_drop(key)

    def _on_drop(self, key: Any) -> None:
        """Subclass hook: secondary indexes forget the key."""

    def _evict_until(self, budget: int) -> None:
        while self._entries and self._resident["bytes"] > budget:
            self._drop(next(iter(self._entries)), counter="evictions")

    def _estimate_bytes(self, row: Any) -> Optional[int]:
        """Host-memory estimate of one stored row (the serialized size —
        what the response costs to hold). Sizing coerces with str so an
        odd value can't fail the estimate; the STORED row is never
        round-tripped. None = unsizable: don't cache."""
        try:
            return len(json.dumps(row, default=str))
        except Exception:  # noqa: BLE001 — unsizable payloads stay out
            return None

    def _probe_is_stale(self, entry_stamp: Any, probe_stamp: Any) -> bool:
        """True when the PROBE carries the older stamp — the entry must
        survive such a mismatch (dropping it would let a straggler evict
        forward state). The base tier's probes always read CURRENT
        stamps, so a mismatch always means a stale entry."""
        return False

    def _get(self, key: Any, stamp: Any, cause: Any) -> Optional[Any]:
        entry = self._entries.get(key)
        if entry is None:
            self.stats["misses"] += 1
            return None
        if entry["stamp"] != stamp:
            if self._probe_is_stale(entry["stamp"], stamp):
                # a lagging observer (a drain whose reader pre-dates a
                # refresh) misses without touching the newer entry
                self.stats["misses"] += 1
                return None
            # the generation (vector) moved: typed invalidation, and the
            # probe is a miss
            self._drop(key, cause=cause() if callable(cause) else cause)
            self.stats["misses"] += 1
            return None
        self._entries.move_to_end(key)
        self.stats["hits"] += 1
        return entry["row"]

    def _put(self, key: Any, stamp: Any, row: Any) -> None:
        nbytes = self._estimate_bytes(row)
        if nbytes is None or nbytes > self.max_entry_bytes:
            self.stats["oversize_refused"] += 1
            return
        self._drop(key)   # supersede an existing (stale) entry in place
        # LRU eviction BEFORE the charge: cold entries free budget ahead
        # of any breaker trip
        self._evict_until(max(self.max_bytes - nbytes, 0))
        breaker = self._breaker()
        try:
            breaker.add_estimate(nbytes, self.BREAKER)
        except Exception:  # noqa: BLE001 — CircuitBreakingError: a
            # starved breaker means the CACHE gives way, never the query
            # — evict everything resident and retry once
            self._evict_until(0)
            try:
                breaker.add_estimate(nbytes, self.BREAKER)
            except Exception:  # noqa: BLE001
                self.stats["entries_refused"] += 1
                return
        self._entries[key] = {"stamp": stamp, "row": row, "bytes": nbytes}
        self._resident["bytes"] += nbytes
        self.stats["puts"] += 1

    def clear(self, cause: str = "clear") -> None:
        for key in list(self._entries):
            self._drop(key, cause=cause)

    # -- surfaces -------------------------------------------------------

    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        out: Dict[str, Any] = {
            f"{prefix}{name}": count for name, count in self.stats.items()}
        out[f"{prefix}entries"] = len(self._entries)
        out[f"{prefix}resident_bytes"] = self._resident["bytes"]
        out[f"{prefix}invalidations_by_cause"] = dict(
            sorted(self.invalidations_by_cause.items()))
        return out


class ShardRequestCache(_CacheTier):
    """Per-data-node tier: response rows keyed by (shard, generation,
    normalized plan). A per-shard key index makes a generation move an
    O(shard entries) purge the first time the new generation is
    observed, so stale entries stop holding breaker budget the moment
    the shard serves again."""

    def __init__(self) -> None:
        super().__init__()
        self._shard_keys: Dict[Tuple[str, int], set] = {}
        self._shard_gens: Dict[Tuple[str, int], int] = {}

    def _on_drop(self, key: Any) -> None:
        keys = self._shard_keys.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                self._shard_keys.pop(key[0], None)

    def _probe_is_stale(self, entry_stamp: Any, probe_stamp: Any) -> bool:
        # generation stamps are globally monotonic ints: a probe below
        # the entry's stamp is the lagging observer, not the entry
        return probe_stamp < entry_stamp

    def note_generation(self, shard_key: Tuple[str, int], generation: int,
                        cause: Any) -> bool:
        """First observation of a MOVED (strictly newer) generation
        purges the shard's entries under the engine-recorded cause.
        Returns False for a STALE observation — a drain whose reader
        pre-dates a refresh that other drains have already published
        past; purging (or regressing the recorded stamp) on its behalf
        would let one straggler wipe the hot set filled after the
        refresh."""
        recorded = self._shard_gens.get(shard_key)
        if recorded == generation:
            return True
        if recorded is not None and generation < recorded:
            return False
        self._shard_gens[shard_key] = generation
        if recorded is None:
            return True
        typed = cause() if callable(cause) else cause
        for key in list(self._shard_keys.get(shard_key, ())):
            self._drop(key, cause=typed)
        return True

    def get(self, shard_key: Tuple[str, int], generation: int,
            norm_key: str, cause: Any) -> Optional[Dict[str, Any]]:
        self.note_generation(shard_key, generation, cause)
        return self._get((shard_key, norm_key), generation, cause)

    def put(self, shard_key: Tuple[str, int], generation: int,
            norm_key: str, row: Dict[str, Any], cause: Any) -> None:
        if not self.enabled:
            return
        if not self.note_generation(shard_key, generation, cause):
            return   # a stale reader's row can never serve a future probe
        key = (shard_key, norm_key)
        self._put(key, generation, row)
        if key in self._entries:
            self._shard_keys.setdefault(shard_key, set()).add(key)


class FusedResultCache(_CacheTier):
    """Coordinator tier: the fused end-to-end response keyed by
    (tenant key, normalized request) and stamped with the
    participating-shard generation VECTOR — any member shard's
    generation moving unstamps the entry, and the invalidation is typed
    by the cause the MOVED shard's engine recorded."""

    EXCLUDE_BUDGETED = True

    def __init__(self) -> None:
        super().__init__()
        self.stats["not_colocated"] = 0

    def _apply_settings(self, state) -> None:
        super()._apply_settings(state)
        from elasticsearch_tpu_torch.utils.settings import (
            SEARCH_REQUEST_CACHE_COORDINATOR, setting_from_state,
        )
        self.enabled = self.enabled and setting_from_state(
            state, SEARCH_REQUEST_CACHE_COORDINATOR)

    def get(self, key: Any, vector: Tuple,
            cause_of: Callable[[Tuple[str, int]], Any]
            ) -> Optional[Dict[str, Any]]:
        def stale_cause():
            entry = self._entries.get(key)
            if entry is None:
                return "unknown"
            for prev, cur in zip(entry["stamp"], vector):
                if prev != cur:
                    return _typed_cause(cause_of((cur[0], cur[1])))
            # length mismatch (shard count changed): a restore/resize
            # class event — attribute to the restore bucket
            return "restore"
        return self._get(key, vector, stale_cause)

    def put(self, key: Any, vector: Tuple, response: Dict[str, Any]
            ) -> None:
        if not self.enabled:
            return
        self._put(key, vector, response)


def merge_request_cache_sections(sections) -> Dict[str, Any]:
    """Fleet merge of per-node ``request_cache`` stats sections for
    ``_cluster/stats`` (the section-filtered nodes-stats fan-out):
    counters sum, the typed invalidation cause maps sum per cause."""
    out: Dict[str, Any] = {}
    for section in sections:
        for name, value in (section or {}).items():
            if isinstance(value, dict):
                agg = out.setdefault(name, {})
                for cause, n in value.items():
                    agg[cause] = agg.get(cause, 0) + int(n)
            elif isinstance(value, (int, float)):
                out[name] = out.get(name, 0) + int(value)
    for name, value in list(out.items()):
        if isinstance(value, dict):
            out[name] = dict(sorted(value.items()))
    return out
