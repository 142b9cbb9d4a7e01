"""Typed settings registry.

Mirrors the semantics of the reference's setting infrastructure —
``Setting<T>`` (common/settings/Setting.java:87), ``ClusterSettings``
(common/settings/ClusterSettings.java:125) and ``IndexScopedSettings``
(common/settings/IndexScopedSettings.java:56) — re-expressed in Python:

- every setting is declared once, typed, with scope + dynamicity + validator;
- unknown settings are rejected at registration time (the registry doubles
  as documentation and validation, like the reference);
- dynamic updates flow through registered update-consumers.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, Generic, Iterable, List, Mapping, Optional, TypeVar

from elasticsearch_tpu_torch.utils.errors import SettingsError

T = TypeVar("T")


class Scope(enum.Enum):
    NODE = "node"          # static, from config file / env only
    CLUSTER = "cluster"    # cluster-wide, possibly dynamic
    INDEX = "index"        # per-index, validated against IndexScopedSettings


class Property(enum.Flag):
    NONE = 0
    DYNAMIC = enum.auto()       # updatable at runtime
    FINAL = enum.auto()         # may never change after creation
    DEPRECATED = enum.auto()


class Setting(Generic[T]):
    """A single typed setting declaration."""

    def __init__(
        self,
        key: str,
        default: Any,
        parser: Callable[[Any], T],
        scope: Scope = Scope.NODE,
        properties: Property = Property.NONE,
        validator: Optional[Callable[[T], None]] = None,
    ):
        self.key = key
        self._default = default  # value, or callable(settings) -> value
        self.parser = parser
        self.scope = scope
        self.properties = properties
        self.validator = validator

    @property
    def dynamic(self) -> bool:
        return bool(self.properties & Property.DYNAMIC)

    def default(self, settings: "Settings") -> T:
        raw = self._default(settings) if callable(self._default) else self._default
        return self.parse(raw)

    def parse(self, raw: Any) -> T:
        try:
            value = self.parser(raw)
        except (ValueError, TypeError) as e:
            raise SettingsError(f"failed to parse setting [{self.key}] with value [{raw}]: {e}")
        if self.validator is not None:
            self.validator(value)
        return value

    def get(self, settings: "Settings") -> T:
        raw = settings.raw_get(self.key)
        if raw is None:
            return self.default(settings)
        return self.parse(raw)

    def exists(self, settings: "Settings") -> bool:
        return settings.raw_get(self.key) is not None

    # ---- convenience constructors -------------------------------------
    @staticmethod
    def int_setting(key: str, default: int, min_value: Optional[int] = None,
                    max_value: Optional[int] = None, scope: Scope = Scope.NODE,
                    properties: Property = Property.NONE) -> "Setting[int]":
        def validate(v: int) -> None:
            if min_value is not None and v < min_value:
                raise SettingsError(f"[{key}] must be >= {min_value}, got {v}")
            if max_value is not None and v > max_value:
                raise SettingsError(f"[{key}] must be <= {max_value}, got {v}")
        return Setting(key, default, int, scope, properties, validate)

    @staticmethod
    def float_setting(key: str, default: float, min_value: Optional[float] = None,
                      scope: Scope = Scope.NODE,
                      properties: Property = Property.NONE) -> "Setting[float]":
        def validate(v: float) -> None:
            if min_value is not None and v < min_value:
                raise SettingsError(f"[{key}] must be >= {min_value}, got {v}")
        return Setting(key, default, float, scope, properties, validate)

    @staticmethod
    def bool_setting(key: str, default: bool, scope: Scope = Scope.NODE,
                     properties: Property = Property.NONE) -> "Setting[bool]":
        def parse(v: Any) -> bool:
            if isinstance(v, bool):
                return v
            s = str(v).lower()
            if s in ("true", "1", "yes"):
                return True
            if s in ("false", "0", "no"):
                return False
            raise ValueError(f"cannot parse boolean [{v}]")
        return Setting(key, default, parse, scope, properties)

    @staticmethod
    def str_setting(key: str, default: str, scope: Scope = Scope.NODE,
                    properties: Property = Property.NONE,
                    choices: Optional[Iterable[str]] = None) -> "Setting[str]":
        validator = None
        if choices is not None:
            allowed = set(choices)

            def validator(v: str) -> None:
                if v not in allowed:
                    raise SettingsError(f"[{key}] must be one of {sorted(allowed)}, got [{v}]")
        return Setting(key, default, str, scope, properties, validator)

    @staticmethod
    def time_setting(key: str, default: str, scope: Scope = Scope.NODE,
                     properties: Property = Property.NONE) -> "Setting[float]":
        """Time value in seconds; accepts '30s', '1m', '500ms', '2h', or a number."""
        return Setting(key, default, parse_time_to_seconds, scope, properties)

    @staticmethod
    def bytes_setting(key: str, default: str, scope: Scope = Scope.NODE,
                      properties: Property = Property.NONE) -> "Setting[int]":
        """Byte size; accepts '512mb', '1gb', '10%' is NOT supported here, or int bytes."""
        return Setting(key, default, parse_bytes, scope, properties)


def parse_time_to_seconds(raw: Any) -> float:
    if isinstance(raw, (int, float)):
        return float(raw)
    s = str(raw).strip().lower()
    for suffix, mult in (("ms", 1e-3), ("s", 1.0), ("m", 60.0), ("h", 3600.0), ("d", 86400.0)):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    return float(s)


def parse_bytes(raw: Any) -> int:
    if isinstance(raw, int):
        return raw
    s = str(raw).strip().lower()
    for suffix, mult in (("kb", 1 << 10), ("mb", 1 << 20), ("gb", 1 << 30), ("tb", 1 << 40), ("b", 1)):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(s)


class Settings:
    """An immutable bag of raw setting values (string/number keyed by dotted key)."""

    EMPTY: "Settings"

    def __init__(self, values: Optional[Mapping[str, Any]] = None):
        self._values: Dict[str, Any] = dict(_flatten(values or {}))

    def raw_get(self, key: str) -> Any:
        return self._values.get(key)

    def keys(self) -> Iterable[str]:
        return self._values.keys()

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def with_overrides(self, overrides: Mapping[str, Any]) -> "Settings":
        merged = dict(self._values)
        merged.update(_flatten(overrides))
        # None value means "reset to default" (like ES null in settings update)
        return Settings({k: v for k, v in merged.items() if v is not None})

    def filter_prefix(self, prefix: str) -> "Settings":
        return Settings({k: v for k, v in self._values.items() if k.startswith(prefix)})

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Settings) and self._values == other._values

    def __repr__(self) -> str:
        return f"Settings({self._values!r})"


def _flatten(values: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Accept nested dicts ({'index': {'number_of_shards': 2}}) or dotted keys."""
    out: Dict[str, Any] = {}
    for k, v in values.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


Settings.EMPTY = Settings()


class SettingsRegistry:
    """Registry of declared settings for one scope; validates and dispatches updates.

    Reference analog: AbstractScopedSettings / ClusterSettings
    (common/settings/ClusterSettings.java:125).
    """

    def __init__(self, settings: Settings, declared: Iterable[Setting[Any]], scope: Scope):
        self.scope = scope
        self._declared: Dict[str, Setting[Any]] = {}
        for s in declared:
            if s.key in self._declared:
                raise SettingsError(f"duplicate setting registration [{s.key}]")
            self._declared[s.key] = s
        self._lock = threading.Lock()
        self._settings = settings
        self._consumers: List[tuple] = []  # (setting, callback)
        self.validate(settings)

    @property
    def current(self) -> Settings:
        return self._settings

    def register(self, setting: Setting[Any]) -> None:
        """Late registration (plugins contribute settings)."""
        with self._lock:
            if setting.key in self._declared:
                raise SettingsError(f"duplicate setting registration [{setting.key}]")
            self._declared[setting.key] = setting

    def get(self, setting: Setting[T]) -> T:
        return setting.get(self._settings)

    def get_by_key(self, key: str) -> Any:
        s = self._declared.get(key)
        if s is None:
            raise SettingsError(f"unknown setting [{key}]")
        return s.get(self._settings)

    def validate(self, settings: Settings, allow_unknown_prefixes: Iterable[str] = ()) -> None:
        """Unknown settings fail, like the reference's startup validation."""
        for key in settings.keys():
            if key in self._declared:
                self._declared[key].parse(settings.raw_get(key))
                continue
            if any(key.startswith(p) for p in allow_unknown_prefixes):
                continue
            suggestion = _closest(key, self._declared.keys())
            hint = f", did you mean [{suggestion}]?" if suggestion else ""
            raise SettingsError(f"unknown setting [{key}]{hint}")

    def add_settings_update_consumer(self, setting: Setting[T],
                                     consumer: Callable[[T], None]) -> None:
        if not setting.dynamic:
            raise SettingsError(f"setting [{setting.key}] is not dynamic")
        self._consumers.append((setting, consumer))

    def apply_update(self, overrides: Mapping[str, Any]) -> Settings:
        """Apply a dynamic settings update; rejects non-dynamic keys; fires consumers."""
        flat = _flatten(overrides)
        for key in flat:
            s = self._declared.get(key)
            if s is None:
                raise SettingsError(f"unknown setting [{key}]")
            if not s.dynamic:
                raise SettingsError(f"setting [{key}] is not dynamically updateable")
        with self._lock:
            new_settings = self._settings.with_overrides(flat)
            self.validate(new_settings)
            old = self._settings
            self._settings = new_settings
        for setting, consumer in self._consumers:
            new_val = setting.get(new_settings)
            if setting.get(old) != new_val:
                consumer(new_val)
        return new_settings


# ---------------------------------------------------------------------------
# declared cluster settings (the registry entries services read directly
# from committed persistent settings; TransportSearchAction consumes this
# one per request)
# ---------------------------------------------------------------------------

# SearchService.DEFAULT_ALLOW_PARTIAL_SEARCH_RESULTS analog: the cluster-wide
# default for requests that don't set allow_partial_search_results themselves.
SEARCH_DEFAULT_ALLOW_PARTIAL_RESULTS: Setting[bool] = Setting.bool_setting(
    "search.default_allow_partial_results", True,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# Shard-level adaptive micro-batching (search/batch_executor.py): eligible
# concurrent shard queries coalesce into single batched device programs.
# enabled=false restores the one-query-per-dispatch path byte-for-byte.
SEARCH_BATCH_ENABLED: Setting[bool] = Setting.bool_setting(
    "search.batch.enabled", True,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# longest a queued shard query may wait for batch-mates under load; an idle
# batcher drains immediately, so this bounds added latency, not typical
SEARCH_BATCH_MAX_WINDOW_MS: Setting[float] = Setting.float_setting(
    "search.batch.max_window_ms", 2.0, min_value=0.0,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# hard cap on queries per batched dispatch (the query dimension of the
# score plane; kept modest so n_q * n_docs_pad stays inside HBM)
SEARCH_BATCH_MAX_SIZE: Setting[int] = Setting.int_setting(
    "search.batch.max_size", 64, min_value=1, max_value=1024,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# occupancy-feedback window controller (search/batch_executor.py): a key
# whose drains carry at least this many live members keeps growing its
# collection window (toward max_window_ms); drains that come up thin
# (<= 1 member) shrink it back so an isolated query never waits for
# batch-mates that aren't coming
SEARCH_BATCH_TARGET_OCCUPANCY: Setting[int] = Setting.int_setting(
    "search.batch.target_occupancy", 4, min_value=2,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# Packed multi-segment device plane (ops/device_segment.py PlaneRegistry):
# a shard's live segments concatenated into one device-resident plane per
# (kind, field) so scoring is one program regardless of segment count.
# enabled=false restores the per-segment dispatch path byte-for-byte.
SEARCH_PLANE_ENABLED: Setting[bool] = Setting.bool_setting(
    "search.plane.enabled", True,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# shards below this segment count serve per-segment (a one-segment plane
# would only double HBM residency for zero dispatch savings)
SEARCH_PLANE_MIN_SEGMENTS: Setting[int] = Setting.int_setting(
    "search.plane.min_segments", 2, min_value=1,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# quantized coarse-pass re-rank depth (ALL coarse-tier classes: int8
# kNN, bf16 bm25/sparse): the coarse pass keeps this many candidates
# per query for the exact f32 re-rank — the STARTING depth; the margin
# check at position k' deepens adaptively (x2 per escalation) whenever
# it cannot prove the true top-k survived the coarse pass
SEARCH_PLANE_RERANK_DEPTH: Setting[int] = Setting.int_setting(
    "search.plane.rerank_depth", 128, min_value=1, max_value=65536,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# adaptive-depth ceiling: a query whose coarse margin still cannot
# clear the error bound at this depth serves EXACT instead (typed
# plane_quantized_fallback). For the bf16 classes the margin is a real
# proof (the a-priori bound exceeds the worst-case bf16 contribution
# error); for int8 kNN it hardens an empirical estimate — no usable
# closed-form bound exists — with the escalate-then-exact backstop and
# the CHAOS-swept golden suites owning the tail
SEARCH_PLANE_RERANK_DEPTH_MAX: Setting[int] = Setting.int_setting(
    "search.plane.rerank_depth_max", 1024, min_value=1,
    max_value=1 << 20, scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# quantized coarse pass + exact f32 re-rank for the plane's
# scatter-bound classes (int8 mirrors for kNN, bf16 term-frequency /
# norm / weight mirrors for bm25 and sparse); false = every plane query
# runs fully exact
SEARCH_PLANE_QUANTIZED: Setting[bool] = Setting.bool_setting(
    "search.plane.quantized", True,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# per-plane residency ceiling in bytes (0 = breaker-only budgeting); a
# plane over the cap is refused AT ADMISSION and the shard serves
# per-segment. Lazily-added components (quantized mirror, shard IVF)
# are charged to the device breaker and counted in residency stats but
# not re-checked against this cap
SEARCH_PLANE_MAX_BYTES: Setting[int] = Setting.int_setting(
    "search.plane.max_bytes", 0, min_value=0,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# Mesh-sharded device planes (ops/device_segment.py MeshPlaneRegistry +
# search/mesh_executor.py): a co-located fan-out — every target shard's
# plane resident on this node's device mesh — runs as ONE SPMD program
# instead of per-shard dispatches. enabled=false restores the RPC
# scatter-gather byte-for-byte.
SEARCH_MESH_ENABLED: Setting[bool] = Setting.bool_setting(
    "search.mesh.enabled", True,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# fan-outs below this co-located shard count keep the per-shard path (a
# one-shard mesh adds residency for zero dispatch savings — the per-shard
# plane already serves it in one program)
SEARCH_MESH_MIN_SHARDS: Setting[int] = Setting.int_setting(
    "search.mesh.min_shards", 2, min_value=2,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# data-parallel degree of the (dp, shard) mesh: the micro-batched query
# stack splits over this many replicas of the corpus stack (HBM cost:
# dp copies); 1 = pure model parallelism over the corpus axis
SEARCH_MESH_DP: Setting[int] = Setting.int_setting(
    "search.mesh.dp", 1, min_value=1, max_value=64,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# multi-host mesh topology: "" = single-host (all local devices, the
# pre-fleet behaviour), "N" = N equal hosts over the visible devices,
# "NxM" = N hosts x M devices per host (the num_nodes/gpus_per_node
# shape real multi-process deployments pin explicitly). Hosts partition
# the device axis contiguously; fan-outs whose target shards all have
# an active copy on a mesh-member host run as ONE program spanning the
# hosts instead of per-shard RPCs
SEARCH_MESH_HOSTS: Setting[str] = Setting.str_setting(
    "search.mesh.hosts", "",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# pre-init the device backend when a node boots (the legacy mesh
# plane's boot-time warmup): mesh_ready() refuses to pay first-init
# inside a search, so without this the FIRST mesh-eligible search per
# process always takes the RPC detour. Applied at boot from the node's
# initial committed state and re-checked (once) when the setting later
# appears in a committed state; counted as mesh_plane_warmups
SEARCH_MESH_WARMUP_AT_BOOT: Setting[bool] = Setting.bool_setting(
    "search.mesh.warmup_at_boot", False,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# Device observatory (search/device_profile.py) recompile-storm
# detector, promoted from DEVICE_PROFILE.configure() module config to
# dynamic cluster settings (the search.plane.* application pattern):
# more than storm_threshold distinct compiles of one kernel family
# inside storm_window is a recompile storm — a broken shape-bucketing
# invariant burning seconds of serving capacity per compile
SEARCH_DEVICE_PROFILE_STORM_THRESHOLD: Setting[int] = Setting.int_setting(
    "search.device_profile.storm_threshold", 8, min_value=1,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

SEARCH_DEVICE_PROFILE_STORM_WINDOW: Setting[float] = Setting.time_setting(
    "search.device_profile.storm_window", "60s",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# individual compiles slower than this log a slow-compile line even
# without a storm (the storm family's sibling knob, applied together)
SEARCH_DEVICE_PROFILE_SLOW_COMPILE: Setting[float] = Setting.time_setting(
    "search.device_profile.slow_compile_threshold", "1s",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# ---------------------------------------------------------------------------
# overload control plane (utils/threadpool.py + action/response_collector.py)
# ---------------------------------------------------------------------------

# Little's-law queue resizing for the search admission pool
# (QueueResizingEsThreadPoolExecutor analog): the pool moves its queue
# bound toward completion_rate * target_latency, so past saturation the
# queue bounds the LATENCY of admitted work. Resizing engages only when
# min != max (the reference's gate — the defaults keep the static 1000).
SEARCH_ADMISSION_TARGET_LATENCY: Setting[float] = Setting.time_setting(
    "search.admission.target_latency", "1s",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

SEARCH_ADMISSION_QUEUE_MIN: Setting[int] = Setting.int_setting(
    "search.admission.queue.min", 1000, min_value=1,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

SEARCH_ADMISSION_QUEUE_MAX: Setting[int] = Setting.int_setting(
    "search.admission.queue.max", 1000, min_value=1,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# completions per measurement frame (the reference's
# queue_resizing frame): rate = frame / elapsed drives the resize
SEARCH_ADMISSION_FRAME: Setting[int] = Setting.int_setting(
    "search.admission.frame", 100, min_value=1,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# Shard-side shed point (search/batch_executor.py ShardQueryBatcher):
# a data node receiving fan-outs from MANY coordinators bounds its own
# queued + in-flight member count and sheds the overflow AT INTAKE with
# a typed, Retry-After-carrying shard_busy rejection the coordinator
# fails over to the next ranked copy. 0 = unbounded — today's behavior,
# byte-for-byte (the reference's SEARCH threadpool queue bound ->
# es_rejected_execution_exception -> retry-on-next-replica contract).
SEARCH_SHARD_MAX_QUEUED_MEMBERS: Setting[int] = Setting.int_setting(
    "search.shard.max_queued_members", 0, min_value=0,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# Little's-law sizing for the shard shed point (the coordinator pool's
# queue-resizing controller applied node-side): the EFFECTIVE bound is
# min(max_queued_members, drain_rate * target_latency) once NodePressure
# has a drain-measured service EWMA — so past saturation the member
# queue bounds the LATENCY of admitted shard work, not an arbitrary
# count. 0 disables the shrink (the static bound alone applies).
SEARCH_SHARD_QUEUE_TARGET_LATENCY: Setting[float] = Setting.time_setting(
    "search.shard.queue_target_latency", "1s",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# ---------------------------------------------------------------------------
# request cache (indices/request_cache.py — IndicesRequestCache analog)
# ---------------------------------------------------------------------------

# master switch over BOTH tiers (the shard result cache and the
# coordinator fused-result cache); false restores uncached serving
# byte-for-byte and clears resident entries (typed "disabled")
SEARCH_REQUEST_CACHE_ENABLED: Setting[bool] = Setting.bool_setting(
    "search.request_cache.enabled", True,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# coverage gate for the top-k shapes (text/kNN/sparse hits+totals with
# size>0): size=0 bodies — counts, aggregation dashboards — always
# cache while the tier is enabled (the reference's default coverage);
# size>0 caches fleet-wide when this is true, or per request via
# ``"request_cache": true`` in the body (the reference's
# ``?request_cache=true`` opt-in)
SEARCH_REQUEST_CACHE_TOPK: Setting[bool] = Setting.bool_setting(
    "search.request_cache.topk", False,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# coordinator fused-result tier toggle: identical co-located fan-outs
# answered from the coordinator without any shard dispatch; false keeps
# the shard tier alone (duplicates still skip device work per shard)
SEARCH_REQUEST_CACHE_COORDINATOR: Setting[bool] = Setting.bool_setting(
    "search.request_cache.coordinator", True,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# LRU eviction budget per tier: resident entries above this evict
# coldest-first BEFORE the request_cache breaker child can trip
SEARCH_REQUEST_CACHE_MAX_BYTES: Setting[int] = Setting.bytes_setting(
    "search.request_cache.max_bytes", "32mb",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# per-entry cap: one pathological response (deep aggs over a huge key
# space) must not evict the whole hot set to cache itself
SEARCH_REQUEST_CACHE_MAX_ENTRY_BYTES: Setting[int] = Setting.bytes_setting(
    "search.request_cache.max_entry_bytes", "1mb",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# Adaptive per-copy shard-query transport timeout (the PR 13 recorded
# leg): the flat 60s becomes min(ceiling, max(floor, 30x the copy's ARS
# response EWMA)), further bounded by the request's own [timeout]
# budget — a stalled copy fails over in RTT-scale time instead of
# waiting out a minute. Unknown copies (no EWMA yet) keep the ceiling.
SEARCH_SHARD_QUERY_TIMEOUT_FLOOR: Setting[float] = Setting.time_setting(
    "search.shard.query_timeout.floor", "2s",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

SEARCH_SHARD_QUERY_TIMEOUT_CEILING: Setting[float] = Setting.time_setting(
    "search.shard.query_timeout.ceiling", "60s",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)

# C3 adaptive replica selection (OperationRouting.USE_ADAPTIVE_REPLICA_
# SELECTION_SETTING analog): false restores pure round-robin rotation
# of shard copies — the chaos suite's baseline for the reroute proof.
CLUSTER_USE_ADAPTIVE_REPLICA_SELECTION: Setting[bool] = \
    Setting.bool_setting(
        "cluster.routing.use_adaptive_replica_selection", True,
        scope=Scope.CLUSTER, properties=Property.DYNAMIC)


# write-path admission budget (IndexingPressure.MAX_INDEXING_BYTES
# analog — 10% of heap there, a fixed default here): the node-wide cap
# on in-flight indexing bytes. Coordinating and primary admission share
# the limit; the replica stage is granted 1.5x headroom (see
# utils/threadpool.py IndexingPressure) so replication fan-out can never
# deadlock behind coordinating admission on the same node. Removing the
# setting restores the documented 64mb default.
INDEXING_PRESSURE_MEMORY_LIMIT: Setting[int] = Setting.bytes_setting(
    "indexing_pressure.memory.limit", "64mb",
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)


# gateway.recover_after_data_nodes-style fleet-completeness release: when
# this many data nodes have joined AND answered the shard-state fetch,
# allocation stops waiting out EXISTING_COPY_GRACE for absent copy-holders
# (0 = disabled; the grace clock stays the fallback)
GATEWAY_EXPECTED_DATA_NODES: Setting[int] = Setting.int_setting(
    "gateway.expected_data_nodes", 0, min_value=0,
    scope=Scope.CLUSTER, properties=Property.DYNAMIC)


# soft-deletes analog (IndexSettings.INDEX_SOFT_DELETES_RETENTION_
# OPERATIONS_SETTING): every engine retains at least this many of its
# newest operations — INCLUDING delete tombstones and noops — as a
# seqno-indexed history, so a briefly-departed copy can catch up by
# replaying only the ops it missed instead of paying a full store copy.
# Retention leases can extend the retained range further; this is the
# floor. Dynamic: a settings update reaches live engines through the
# reconciler's metadata apply.
INDEX_SOFT_DELETES_RETENTION_OPS: Setting[int] = Setting.int_setting(
    "index.soft_deletes.retention.ops", 1024, min_value=0,
    scope=Scope.INDEX, properties=Property.DYNAMIC)

# peer-recovery retention lease expiry (IndexSettings.INDEX_SOFT_DELETES_
# RETENTION_LEASE_PERIOD_SETTING): a tracked copy's lease is renewed every
# time its local checkpoint advances; once a departed copy has been gone
# longer than this, its lease expires and the history it was holding may
# be pruned — the copy then pays the file-based path on return.
INDEX_RETENTION_LEASE_PERIOD: Setting[float] = Setting.time_setting(
    "index.soft_deletes.retention_lease.period", "12h",
    scope=Scope.INDEX, properties=Property.DYNAMIC)


def setting_from_state(state, setting: Setting[T]) -> T:
    """Read a dynamic cluster setting off a committed cluster state's
    persistent settings. Missing values — and unparseable operator
    values — fall back to the setting's default, so a bad update can
    never wedge a hot path. The one read-side idiom every service that
    consumes dynamic settings directly from state shares."""
    raw = None
    if state is not None:
        raw = state.metadata.persistent_settings.get(setting.key)
    if raw is None:
        return setting.default(None)
    try:
        return setting.parse(raw)
    except Exception:  # noqa: BLE001 — fail toward the default
        return setting.default(None)


def _closest(key: str, candidates: Iterable[str]) -> Optional[str]:
    """Cheap typo suggestion: smallest prefix-distance candidate."""
    best, best_score = None, 0
    for c in candidates:
        score = len(_common_prefix(key, c))
        if score > best_score:
            best, best_score = c, score
    return best if best_score >= 3 else None


def _common_prefix(a: str, b: str) -> str:
    i = 0
    while i < min(len(a), len(b)) and a[i] == b[i]:
        i += 1
    return a[:i]
