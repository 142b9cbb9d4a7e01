from elasticsearch_tpu_torch.ops.bm25 import Bm25Executor, idf
from elasticsearch_tpu_torch.ops.device_segment import (
    PLANES,
    DeviceFeatures,
    DevicePostings,
    DeviceVectors,
    device_live_mask,
)
from elasticsearch_tpu_torch.ops.fusion import linear_fuse, rrf_fuse
from elasticsearch_tpu_torch.ops.knn import KnnExecutor
from elasticsearch_tpu_torch.ops.sparse import (
    SparseExecutor, sparse_scores, sparse_topk,
)

__all__ = ["Bm25Executor", "DeviceFeatures", "DevicePostings",
           "DeviceVectors", "KnnExecutor", "PLANES", "SparseExecutor",
           "device_live_mask", "idf", "linear_fuse", "rrf_fuse",
           "sparse_scores", "sparse_topk"]
