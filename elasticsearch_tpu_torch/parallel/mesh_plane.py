"""The mesh data plane's host half: ``mesh_eligible``.

The JAX package's ``parallel/mesh_plane.py`` runs eligible whole-index
top-k queries as one sharded program when a node drives a multi-device
mesh (``Node(mesh_data_plane=True)``). Its programs (the JAX package's
``parallel/sharded_search.py``) are not ported yet: ``MeshDataPlane``
raises NotPortedError, and ``mesh_eligible`` -- host code the coordinator
calls -- is carried as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.utils.errors import NotPortedError

__all__ = ["MeshDataPlane", "mesh_eligible"]


def mesh_eligible(body: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Describe how the request can run as one mesh program, or None.

    Returns {"kind": "text", "field", "clauses"} for disjunctive text
    queries (Match, or bool of only-should Matches on one field — the
    same shapes the shard WAND collector serves),
    {"kind": "knn", "field", "query"} for unfiltered kNN queries, or
    {"kind": "sparse", "field", "query"} for text_expansion /
    rank-features queries. Structural conditions mirror
    choose_collector_context plus mesh-specific ones (no phases needing
    per-shard readers during query).

    Totals: text serves totals-disabled AND finite-threshold requests
    (counts-then-skip rides the sharded program's psum'd match counts);
    only track_total_hits: true (unbounded exact) falls back to RPC.
    knn/sparse are top-k-exact by construction (total = k, relation eq),
    so any finite threshold is servable."""
    if body.get("aggs") or body.get("aggregations") or body.get("suggest"):
        return None
    if body.get("sort") is not None or body.get("search_after") is not None:
        return None
    if body.get("min_score") is not None:
        return None
    if body.get("rescore") or body.get("collapse") or body.get("slice"):
        return None
    if int(body.get("size", 10)) <= 0:
        return None
    try:
        q = dsl.parse_query(body.get("query"))
    except Exception:  # noqa: BLE001 — let the RPC path raise the real error
        return None
    if body.get("track_total_hits") is True:
        return None   # unbounded exact counting: host path
    if isinstance(q, dsl.Knn) and q.filter is None:
        return {"kind": "knn", "field": q.field, "query": q}
    if isinstance(q, dsl.TextExpansion):
        return {"kind": "sparse", "field": q.field, "query": q}
    got = dsl.disjunctive_clauses(q)
    if got is None:
        return None
    field, clauses = got
    return {"kind": "text", "field": field, "clauses": clauses}


class MeshDataPlane:
    """Stands where the JAX package's mesh data plane is built; refuses
    until the sharded programs are ported."""

    def __init__(self, *args, **kwargs):
        raise NotPortedError("mesh_data_plane")
