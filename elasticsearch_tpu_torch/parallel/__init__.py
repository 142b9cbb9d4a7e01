"""The JAX package's ``parallel`` package so far: the mesh topology and
layout, the mesh text, kNN and sparse kernels (``parallel/mesh.py``) and
the host-only eligibility check of the mesh data plane. The sharded
search programs are not ported yet."""

from elasticsearch_tpu_torch.parallel.mesh import (
    HostTopology, host_backend, mesh_layout, mesh_ready,
    parse_host_topology, set_host_backend,
)

__all__ = ["HostTopology", "host_backend", "mesh_layout", "mesh_ready",
           "parse_host_topology", "set_host_backend"]
