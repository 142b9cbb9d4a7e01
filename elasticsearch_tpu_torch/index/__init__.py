from elasticsearch_tpu_torch.index.engine import EngineResult, InternalEngine, Reader
from elasticsearch_tpu_torch.index.segment import (
    BLOCK,
    Segment,
    SegmentBuilder,
    merge_segments,
    next_pow2,
)
from elasticsearch_tpu_torch.index.seqno import (
    LocalCheckpointTracker,
    NO_OPS_PERFORMED,
    ReplicationTracker,
)
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.index.translog import Translog, TranslogOp

__all__ = [
    "BLOCK",
    "EngineResult",
    "InternalEngine",
    "LocalCheckpointTracker",
    "NO_OPS_PERFORMED",
    "Reader",
    "ReplicationTracker",
    "Segment",
    "SegmentBuilder",
    "Store",
    "Translog",
    "TranslogOp",
    "merge_segments",
    "next_pow2",
]
