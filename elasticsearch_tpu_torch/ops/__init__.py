from elasticsearch_tpu_torch.ops.bm25 import Bm25Executor, idf
from elasticsearch_tpu_torch.ops.device_segment import (
    PLANES,
    DevicePostings,
    DeviceVectors,
    device_live_mask,
)
from elasticsearch_tpu_torch.ops.knn import KnnExecutor

__all__ = ["Bm25Executor", "DevicePostings", "DeviceVectors", "KnnExecutor",
           "PLANES", "device_live_mask", "idf"]
