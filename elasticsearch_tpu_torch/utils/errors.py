"""Exception hierarchy.

Mirrors the role of ``org.elasticsearch.ElasticsearchException`` and friends
(reference: server/src/main/java/org/elasticsearch/ElasticsearchException.java):
every error carries an HTTP status so the REST layer can map failures
uniformly, and errors serialize to/from JSON for transport.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def exception_type_name(class_name: str) -> str:
    """CamelCase class name -> snake_case '_exception' wire name, e.g.
    IndexNotFoundError -> index_not_found_exception (ES-compatible)."""
    if class_name.endswith("Error"):
        class_name = class_name[: -len("Error")]
    elif class_name.endswith("Exception"):
        class_name = class_name[: -len("Exception")]
    out = []
    for i, ch in enumerate(class_name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out) + "_exception"


class SearchEngineError(Exception):
    """Base for all engine errors. Carries an HTTP status code."""

    status = 500

    def __init__(self, message: str, **metadata: Any):
        super().__init__(message)
        self.message = message
        self.metadata: Dict[str, Any] = metadata

    @property
    def error_type(self) -> str:
        return exception_type_name(type(self).__name__)

    def to_json(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {"type": self.error_type, "reason": self.message}
        body.update(self.metadata)
        return body


class IndexNotFoundError(SearchEngineError):
    status = 404

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)
        self.index = index


class IndexAlreadyExistsError(SearchEngineError):
    status = 400

    def __init__(self, index: str):
        super().__init__(f"index [{index}] already exists", index=index)


class DocumentMissingError(SearchEngineError):
    status = 404

    def __init__(self, index: str, doc_id: str):
        super().__init__(f"[{index}][{doc_id}]: document missing", index=index)


class ShardNotFoundError(SearchEngineError):
    status = 404


class MapperParsingError(SearchEngineError):
    status = 400


class ResourceNotFoundError(SearchEngineError):
    status = 404


class IllegalArgumentError(SearchEngineError):
    status = 400


class QueryParsingError(SearchEngineError):
    status = 400


class VersionConflictError(SearchEngineError):
    """Optimistic-concurrency failure (seq_no/primary_term or version mismatch).

    Reference analog: VersionConflictEngineException
    (server/.../index/engine/VersionConflictEngineException.java).
    """

    status = 409


class CircuitBreakingError(SearchEngineError):
    """Memory budget exceeded; request rejected instead of OOMing the device.

    Reference analog: common/breaker/CircuitBreakingException.java.
    """

    status = 429


class RejectedExecutionError(SearchEngineError):
    """Executor queue full. Reference analog: EsRejectedExecutionException."""

    status = 429


class EsRejectedExecutionError(RejectedExecutionError):
    """Write-path indexing-pressure rejection: in-flight write bytes at
    one of the three stages (coordinating / primary / replica) would
    exceed the node's ``indexing_pressure.memory.limit`` budget.

    Wire name is ``es_rejected_execution_exception`` — the exact type
    the reference's IndexingPressure rejections carry, which client
    bulk-backoff logic keys on.

    Like ShardBusyError, the message carries machine-parseable
    ``stage=<stage>`` and ``retry_after=<s>s`` suffixes because replica
    rejections travel back to the primary through transport error
    STRINGIFICATION (metadata does not survive); the primary re-parses
    them with ``write_pressure_info`` to tell a transiently-starved
    replica (retry, converge) from a broken one (fail from the in-sync
    set)."""

    status = 429


class ShardBusyError(SearchEngineError):
    """Data-node shard query queue at its member bound: the query was shed
    AT INTAKE (it never touched a drain). The coordinator treats this as a
    ROUTING signal — fail over to the next ranked copy — not a failure;
    only an all-copies-shed shard surfaces it to the caller.

    Reference analog: es_rejected_execution_exception from the SEARCH
    threadpool's bounded queue, which the coordinator retries on the next
    replica (AbstractSearchAsyncAction.onShardFailure + the reference's
    "reads go to any replica, all APIs reroute" contract).

    The message carries machine-parseable ``retry_after=<s>s`` and
    ``queued=<n>`` suffixes because transport Deferred rejections and
    remote-handler errors are STRINGIFIED on the wire (PR 9 invariant) —
    metadata does not survive; the coordinator re-parses it with
    ``shard_busy_info``."""

    status = 429


def shard_busy_info(err: Any) -> Optional[Dict[str, int]]:
    """Parse a (possibly wire-stringified) shard_busy rejection out of any
    error: returns {"retry_after": s, "queued": n} or None. Works on a
    local ShardBusyError, a RemoteTransportError wrapping one, and the
    bare cause string — the one decoder every failover site shares."""
    if err is None:
        return None
    name = type(err).__name__
    text = str(err)
    if name != "ShardBusyError" and \
            getattr(err, "cause_type", "") != "ShardBusyError" and \
            "ShardBusyError" not in text:
        return None
    import re
    ra = re.search(r"retry_after=(\d+)s", text)
    q = re.search(r"queued=(\d+)", text)
    return {"retry_after": int(ra.group(1)) if ra else 1,
            "queued": int(q.group(1)) if q else 0}


def write_pressure_info(err: Any) -> Optional[Dict[str, Any]]:
    """Parse a (possibly wire-stringified) indexing-pressure rejection
    out of any error: returns {"stage": str, "retry_after": s} or None.
    Works on a local EsRejectedExecutionError, a RemoteTransportError
    wrapping one, and the bare cause string — the one decoder the
    primary's replica-retry loop and the bulk item mapper share."""
    if err is None:
        return None
    name = type(err).__name__
    text = str(err)
    if name != "EsRejectedExecutionError" and \
            getattr(err, "cause_type", "") != "EsRejectedExecutionError" \
            and "EsRejectedExecutionError" not in text:
        return None
    import re
    stage = re.search(r"stage=(\w+)", text)
    ra = re.search(r"retry_after=(\d+)s", text)
    return {"stage": stage.group(1) if stage else "unknown",
            "retry_after": int(ra.group(1)) if ra else 1}


class SearchPhaseExecutionError(SearchEngineError):
    """Every shard of a search failed — the whole request fails with the
    underlying cause's status (a request-wide 429 when breakers tripped
    everywhere, not a 200 with empty hits).

    Reference analog: action/search/SearchPhaseExecutionException.java
    (status() derives from the grouped shard failures' causes).
    """

    status = 503

    def __init__(self, message: str, cause_status: int = 503,
                 **metadata):
        super().__init__(message, **metadata)
        self.status = cause_status


class ClusterBlockError(SearchEngineError):
    """Operation blocked by cluster-level block (e.g. no master, read-only).

    Reference analog: cluster/block/ClusterBlockException.java.
    """

    status = 503


class NotMasterError(SearchEngineError):
    status = 503


class TaskCancelledError(SearchEngineError):
    status = 400


class SearchBudgetExceededError(SearchEngineError):
    """The per-request [timeout] budget expired while a shard was still
    collecting: the shard stops work instead of computing results the
    coordinator has already given up on (shard-side analog of the
    coordinator's budget timer; the reference checks the timeout inside
    collection via QueryPhase's timeout-checking collectors)."""

    status = 503


class TransportError(SearchEngineError):
    status = 500


class NodeDisconnectedError(TransportError):
    status = 500


class ReceiveTimeoutError(TransportError):
    status = 500


class SettingsError(IllegalArgumentError):
    status = 400


class SnapshotError(SearchEngineError):
    status = 500


class ShardCorruptedError(SearchEngineError):
    """On-disk data failed checksum verification (or a corruption marker
    is present). The shard must not serve from this store copy.

    Reference analog: Lucene's CorruptIndexException surfaced through
    Store.markStoreCorrupted / Store.failIfCorrupted.
    """

    status = 500


class RecoveryFailedError(SearchEngineError):
    status = 500


class UnavailableShardsError(SearchEngineError):
    """No active copy available to execute the operation
    (action/UnavailableShardsException.java)."""
    status = 503


class NotPortedError(SearchEngineError):
    """The request needs a feature this package does not carry yet (the
    JAX package serves it). Raised instead of ever answering with a
    silently different result; ``feature`` names what was missing and is
    the telemetry reason the refusal is counted under."""

    status = 501

    def __init__(self, feature: str, message: Optional[str] = None):
        super().__init__(message or f"[{feature}] is not supported by the "
                         f"PyTorch build yet", feature=feature)
        self.feature = feature
        from elasticsearch_tpu_torch.search import telemetry
        telemetry.TELEMETRY.count_not_ported(feature)


def error_from_json(body: Dict[str, Any]) -> SearchEngineError:
    """Rehydrate an error from its JSON form (transport deserialization)."""
    err = SearchEngineError(body.get("reason", "unknown"))
    err.metadata = {k: v for k, v in body.items() if k not in ("type", "reason")}
    return err
