from elasticsearch_tpu_torch.ops.bm25 import Bm25Executor, idf
from elasticsearch_tpu_torch.ops.device_segment import (
    PLANES,
    DevicePostings,
    device_live_mask,
)

__all__ = ["Bm25Executor", "DevicePostings", "PLANES", "device_live_mask",
           "idf"]
