"""The JAX package's ``parallel`` package: the mesh topology and layout,
the mesh text, kNN and sparse kernels (``parallel/mesh.py``), the sharded
data plane's programs and indexes (``parallel/sharded_search.py``) and
the node's mesh data plane (``parallel/mesh_plane.py``)."""

from elasticsearch_tpu_torch.parallel.mesh import (
    HostTopology, Mesh, host_backend, make_mesh, mesh_layout, mesh_ready,
    parse_host_topology, set_host_backend,
)
from elasticsearch_tpu_torch.parallel.sharded_search import (
    ShardedFeaturesIndex,
    ShardedTextIndex,
    ShardedVectorIndex,
    make_sharded_bm25,
    make_sharded_bm25_batch,
    make_sharded_hybrid,
    make_sharded_knn,
    make_sharded_sparse,
    to_original_ids,
)

__all__ = ["HostTopology", "Mesh", "ShardedFeaturesIndex",
           "ShardedTextIndex", "ShardedVectorIndex", "host_backend",
           "make_mesh", "mesh_layout", "mesh_ready", "make_sharded_bm25",
           "make_sharded_bm25_batch", "make_sharded_hybrid",
           "make_sharded_knn", "make_sharded_sparse", "parse_host_topology",
           "set_host_backend", "to_original_ids"]
