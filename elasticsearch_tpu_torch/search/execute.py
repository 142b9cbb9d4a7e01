"""Per-segment query execution context, the BM25 executors the text path
plans with, and the kNN executor.

The part of the JAX package's ``search/execute.py`` that the match and
kNN paths run: ``SegmentContext``, ``resolve_aliases``, the cached
per-segment BM25 executors, and the kNN rewrite (``KnnBound``,
``ann_segment_route``, ``knn_shard_winners``, ``rewrite_knn``). The dense
per-node executor (``execute`` and its query handlers: bool, term, range,
...) is not part of this package yet; ``execute`` raises NotPortedError
naming the query node. So are filtered kNN (its filter mask needs the
dense executor), the IVF route, and kNN inside a compound query.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import resolve_device
from elasticsearch_tpu_torch.index.segment import Segment, next_pow2, BLOCK
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import (
    Bm25Executor, DevicePostings, DeviceVectors, KnnExecutor,
    device_live_mask,
)
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.utils.errors import NotPortedError


@dataclass
class SegmentContext:
    """Execution context for one segment of one shard."""
    segment: Segment
    mappers: MapperService
    segment_idx: int = 0
    # shard- or corpus-wide stats for idf (DFS analog); None = segment-local
    doc_count_override: Optional[int] = None
    df_overrides: Optional[Dict[str, Dict[str, int]]] = None  # field -> term -> df
    # field -> (sum_doc_len, docs_with_field): corpus-wide collection stats
    # (the CollectionStatistics half of DFS) so norms use one global avgdl
    field_stats_overrides: Optional[Dict[str, Tuple[float, int]]] = None
    # point-in-time live mask (a Reader snapshot); when set it REPLACES the
    # segment's current mask so mid-scroll deletes stay invisible
    live_override: Optional[torch.Tensor] = None
    # the whole shard snapshot this segment belongs to
    reader: Any = None
    # where this context's device arrays live (None = the CUDA card)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def n_docs(self) -> int:
        return self.segment.n_docs

    @property
    def n_docs_pad(self) -> int:
        return next_pow2(max(self.segment.n_docs, 1), minimum=BLOCK)

    @property
    def live(self) -> torch.Tensor:
        if self.live_override is not None:
            return self.live_override
        return device_live_mask(self.segment, self.device)

    def to_device_mask(self, host_mask: np.ndarray) -> torch.Tensor:
        out = np.zeros(self.n_docs_pad, bool)
        out[: len(host_mask)] = host_mask
        return torch.as_tensor(out, device=self.device)

    def search_analyzer(self, field_name: str):
        mapper = self.mappers.mapper(field_name)
        if mapper is not None and hasattr(mapper, "search_analyzer"):
            return mapper.search_analyzer
        from elasticsearch_tpu_torch.analysis import STANDARD
        return STANDARD

    def doc_count_for_idf(self) -> int:
        # includes deleted docs, like Lucene stats (df may count tombstones)
        return self.doc_count_override or max(self.segment.n_docs, 1)

    def df_for(self, field_name: str) -> Optional[Dict[str, int]]:
        if self.df_overrides is None:
            return None
        return self.df_overrides.get(field_name)

    def avgdl_for(self, field_name: str) -> Optional[float]:
        """Corpus-wide avgdl for the field, if a DFS coordinator shared it."""
        if self.field_stats_overrides is None:
            return None
        got = self.field_stats_overrides.get(field_name)
        if not got:
            return None
        sum_len, n_docs = got
        if n_docs <= 0:
            return None
        return float(sum_len) / float(n_docs)


def resolve_aliases(q: dsl.Query, mappers: MapperService) -> dsl.Query:
    """Rewrite field aliases to their target paths throughout a query
    tree (FieldAliasMapper resolution, applied once per shard query).
    Generic over the dataclass nodes: any attribute named ``field`` is
    resolved; ``fields`` lists resolve per entry (keeping ^boosts);
    nested Query attributes and lists recurse. Nodes without alias
    references are returned unchanged (no copy)."""
    import dataclasses

    def resolve_name(name: str) -> str:
        base, _, boost = name.partition("^")
        resolved = mappers.resolve_field(base)
        return f"{resolved}^{boost}" if boost else resolved

    if not dataclasses.is_dataclass(q):
        return q
    changes = {}
    for f in dataclasses.fields(q):
        v = getattr(q, f.name)
        if f.name == "field" and isinstance(v, str) and v:
            r = mappers.resolve_field(v)
            if r != v:
                changes[f.name] = r
        elif f.name == "fields" and isinstance(v, list):
            r2 = [resolve_name(x) if isinstance(x, str) else x for x in v]
            if r2 != v:
                changes[f.name] = r2
        elif isinstance(v, dsl.Query):
            r3 = resolve_aliases(v, mappers)
            if r3 is not v:
                changes[f.name] = r3
        elif isinstance(v, list) and v and isinstance(v[0], dsl.Query):
            r4 = [resolve_aliases(c, mappers) for c in v]
            if any(a is not b for a, b in zip(r4, v)):
                changes[f.name] = r4
    if not changes:
        return q
    return dataclasses.replace(q, **changes)


def execute(q: dsl.Query, ctx: SegmentContext):
    """The dense per-node executor: not part of this package yet."""
    raise NotPortedError(f"dense_query:{type(q).__name__}")


def _bm25_executor(ctx: SegmentContext, field_name: str) -> Optional[Bm25Executor]:
    """Executor cached on the (immutable) segment so its WAND planning
    tables (TermCellIndex / block bounds) survive across queries; the idf
    doc count is refreshed per query since shard-level stats change as
    sibling segments come and go."""
    dev = DevicePostings.for_segment(ctx.segment, field_name, ctx.device)
    if dev is None:
        return None
    ex = ctx.segment.device(
        ("bm25_exec", field_name, str(dev.device)),
        lambda: Bm25Executor(dev, ctx.segment.postings[field_name]))
    ex.doc_count = ctx.doc_count_for_idf()
    return ex


def _bm25_planner(ctx: SegmentContext, field_name: str
                  ) -> Optional[Bm25Executor]:
    """Host-side executor for PLAN BUILDING only (the plane path): no
    per-segment device mirror is uploaded or breaker-charged — the plane
    already holds the shard's postings on device, and doubling residency
    with mirrors the plane never dispatches would tighten the very budget
    the registry manages. Reuses a full executor when one is already
    cached (its host planning tables are identical)."""
    cached = ctx.segment._device_cache.get(
        ("bm25_exec", field_name, str(ctx.device)))
    if cached is not None:
        cached.doc_count = ctx.doc_count_for_idf()
        return cached
    pf = ctx.segment.postings.get(field_name)
    if pf is None:
        return None
    ex = ctx.segment.device(
        ("bm25_plan", field_name),
        lambda: Bm25Executor(None, pf,
                             total_doc_count=max(ctx.segment.n_docs, 1)))
    ex.doc_count = ctx.doc_count_for_idf()
    return ex


@dataclass
class KnnBound(dsl.Query):
    """A Knn node rewritten to its shard-global top-k doc set.

    Mirrors Lucene's KnnVectorQuery rewrite: per-leaf top-k, merged to a
    global k, then executed as an exact doc-id/score set. Built by
    rewrite_knn() in the shard query phase."""
    per_segment: Dict[int, Tuple[np.ndarray, np.ndarray]] = None  # si -> (docs, scores)
    boost: float = 1.0


# segments at or above this size use the IVF ANN path by default (below it
# exact brute force is both faster and perfectly accurate)
ANN_DEFAULT_MIN_DOCS = 65536


def ann_segment_route(ctx: "SegmentContext", field: str) -> None:
    """IVF routing decision for one segment, shared by the solo kNN
    rewrite and the batched executor: returns (the exact brute-force path
    serves: a small segment, an index type other than ivf, no vector
    column) unless the JAX package would probe the segment's IVF index,
    which is not part of this package yet: NotPortedError("knn_ivf"). A
    segment that holds no vectors is answered with no hits either way, so
    it takes the exact path."""
    seg = ctx.segment
    vf = seg.vectors.get(field)
    if vf is None:
        return
    mapper = ctx.mappers.mapper(field)
    opts = getattr(mapper, "index_options", None) or {}
    wants_ivf = opts.get("type") == "ivf"
    if not wants_ivf and seg.n_docs < ANN_DEFAULT_MIN_DOCS:
        return
    if opts.get("type") not in (None, "ivf"):
        return            # another index type (e.g. flat): exact
    if vf.exists.any():
        raise NotPortedError("knn_ivf")


def knn_shard_winners(ctxs: List["SegmentContext"], field: str, specs,
                      k: int, check_members=None
                      ) -> List[List[Tuple[int, int, float]]]:
    """THE kNN top-k executor for the served path -- Q queries (each a
    spec with query_vector / filter), solo being simply Q=1. Returns one
    sorted ``[(segment_idx, local_doc, raw_score)]`` winner list
    (len <= k) per member, the merge Lucene's KnnVectorQuery rewrite
    performs.

    Route: the resident whole-shard plane (one launch via
    plane_exec.plane_knn_winners), else one [Q, D] x [D, N] launch per
    segment. Filtered members, IVF-routed segments and k above the
    kernels' KMAX raise NotPortedError before any launch."""
    from elasticsearch_tpu_torch.ops.knn import KMAX
    if any(s.filter is not None for s in specs):
        raise NotPortedError("knn_filter")
    if k > KMAX:
        raise NotPortedError(f"knn_k_over_{KMAX}")
    n_q = len(specs)
    if not n_q:
        return []
    per_member_hits: List[List[Tuple[int, int, float]]] = \
        [[] for _ in range(n_q)]
    if ctxs:
        from elasticsearch_tpu_torch.ops.device_segment import PLANES
        part = PLANES.get([c.segment for c in ctxs], "vectors", field,
                          ctxs[0].device)
        if part is not None:
            from elasticsearch_tpu_torch.search.plane_exec import (
                plane_knn_winners,
            )
            return plane_knn_winners(ctxs, part, field, specs, k,
                                     check_members)
    for ctx in ctxs:
        ann_segment_route(ctx, field)
    vectors = np.asarray([s.query_vector for s in specs], np.float32)
    for ctx in ctxs:
        dev = DeviceVectors.for_segment(ctx.segment, field, ctx.device)
        if dev is None:
            continue
        if check_members is not None:
            check_members()
        k_seg = min(k, ctx.n_docs_pad)
        s, d = KnnExecutor(dev).top_k_batch(vectors, ctx.live, k_seg)
        s = s.cpu().numpy()
        d = d.cpu().numpy()
        for row in range(n_q):
            for sc, doc in zip(s[row], d[row]):
                if sc > -np.inf:
                    per_member_hits[row].append(
                        (ctx.segment_idx, int(doc), float(sc)))
    for qi in range(n_q):
        per_member_hits[qi].sort(key=lambda x: -x[2])
        per_member_hits[qi] = per_member_hits[qi][:k]
    return per_member_hits


def rewrite_knn(q: dsl.Query, segment_ctxs: List["SegmentContext"],
                cancel_check=None) -> dsl.Query:
    """Replace a top-level Knn node with a KnnBound node holding the
    shard-global top-k (merged across segments). ``cancel_check``
    (zero-arg, raising) runs between per-segment launches so a cancelled
    or budget-expired task stops paying for vector scans.

    The rewrite IS a batch of one: it calls ``knn_shard_winners`` -- the
    same executor the batched kNN path runs -- with a single spec, so solo
    and batched kNN cannot diverge. A Knn inside a compound query goes to
    the dense collector, which is not part of this package yet, and never
    reaches here."""
    if isinstance(q, dsl.Knn):
        from types import SimpleNamespace
        spec = SimpleNamespace(query_vector=q.query_vector, filter=q.filter)
        winners = knn_shard_winners(segment_ctxs, q.field, [spec], q.k,
                                    check_members=cancel_check)[0]
        per_segment: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for si, d, s in winners:
            docs, scores = per_segment.setdefault(
                si, ([], []))  # type: ignore[assignment]
            docs.append(d)
            scores.append(s * q.boost)
        per_segment = {si: (np.asarray(d, np.int64), np.asarray(s, np.float32))
                       for si, (d, s) in per_segment.items()}
        return KnnBound(per_segment=per_segment, boost=q.boost)
    return q
