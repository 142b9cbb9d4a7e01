"""Graph explore: significant-term vertices and co-occurrence edges.

Reference: x-pack/plugin/graph TransportGraphExploreAction — hops of
sampled significant-terms frontiers, connections scored by shared-doc
overlap. This build runs each hop as a sampler+significant_terms
aggregation through the node's own search path and derives edges from
per-pair doc co-occurrence counts (adjacency-style filters), keeping the
response shape (vertices[], connections[] with weight/doc_count).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

DEFAULT_SIZE = 5
SAMPLE_SIZE = 1000


class GraphService:
    def __init__(self, node) -> None:
        self.node = node

    def explore(self, index: str, body: Dict[str, Any],
                on_done: Callable) -> None:
        body = body or {}
        query = body.get("query", {"match_all": {}})
        vertices_spec = (body.get("vertices")
                         or (body.get("controls") or {}).get("vertices"))
        if not vertices_spec:
            on_done(None, IllegalArgumentError(
                "graph explore requires [vertices]"))
            return
        fields: List[Tuple[str, int]] = []
        for v in vertices_spec:
            fields.append((v["field"], int(v.get("size", DEFAULT_SIZE))))
        use_sig = bool((body.get("controls") or {})
                       .get("use_significance", True))

        aggs: Dict[str, Any] = {}
        for fname, size in fields:
            agg_kind = "significant_terms" if use_sig else "terms"
            aggs[f"v_{fname}"] = {agg_kind: {"field": fname, "size": size}}
        req = {"size": 0, "query": query, "aggs": {
            "sample": {"sampler": {"shard_size": SAMPLE_SIZE},
                       "aggs": aggs}}}

        def cb(resp, err):
            if err is not None:
                on_done(None, err)
                return
            sample = (resp.get("aggregations") or {}).get("sample") or {}
            vertices = []
            for fname, _size in fields:
                node_out = sample.get(f"v_{fname}") or {}
                for b in node_out.get("buckets", []):
                    vertices.append({
                        "field": fname, "term": b["key"],
                        "weight": float(b.get("score", b["doc_count"])),
                        "depth": 0})
            if len(vertices) < 2:
                on_done({"took": resp.get("took", 0), "timed_out": False,
                         "vertices": vertices, "connections": []}, None)
                return
            self._connections(index, query, vertices, resp, on_done)
        self.node.search_action.execute(index, req, cb)

    def _connections(self, index, query, vertices, first_resp,
                     on_done) -> None:
        """Pairwise co-occurrence via one adjacency_matrix request."""
        filters = {}
        for i, v in enumerate(vertices):
            filters[str(i)] = {"term": {v["field"]: v["term"]}}
        req = {"size": 0, "query": query, "aggs": {
            "adj": {"adjacency_matrix": {"filters": filters}}}}

        def cb(resp, err):
            if err is not None:
                on_done(None, err)
                return
            connections = []
            adj = (resp.get("aggregations") or {}).get("adj") or {}
            for b in adj.get("buckets", []):
                key = b["key"]
                if "&" not in key:
                    continue
                a, c = key.split("&", 1)
                connections.append({
                    "source": int(a), "target": int(c),
                    "weight": float(b["doc_count"]),
                    "doc_count": b["doc_count"]})
            on_done({"took": first_resp.get("took", 0),
                     "timed_out": False,
                     "vertices": vertices,
                     "connections": connections}, None)
        self.node.search_action.execute(index, req, cb)
