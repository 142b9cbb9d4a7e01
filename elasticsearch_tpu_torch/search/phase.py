"""Shard-level query phase.

The analog of SearchService.executeQueryPhase + QueryPhase.executeInternal
(search/SearchService.java:366, search/query/QueryPhase.java:171): runs the
compiled query over every segment of a shard snapshot, applies pagination
and total-hits tracking, and returns light-weight doc references (fetch
happens in a separate phase, like the reference's query_then_fetch).

This is the JAX package's ``search/phase.py`` with the collectors this
package carries: the block-max-pruned text top-k ("wand_topk"), the kNN
top-k ("knn_topk"), the resolved text_expansion top-k ("sparse_topk")
and the dense score-vector collector ("dense": exact totals, ``_count``,
field sorts, search_after, min_score, rescore, collapse, slice,
terminate_after, profile, and every query tree the others do not take).
The collector choice is the JAX package's, unchanged.

Shard-level term statistics: per-segment idf would skew scores across
segments, so we aggregate df over all live segments first — the same
mechanism scales up to the cross-shard DFS phase (search/dfs/DfsPhase.java:43).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.engine import Reader
from elasticsearch_tpu_torch.index.segment import BLOCK, next_pow2
from elasticsearch_tpu_torch.ops.bm25 import P1_BUCKET, _host
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.execute import SegmentContext
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

DEFAULT_TRACK_TOTAL_HITS = 10_000


@dataclass
class SortSpec:
    field: str                  # "_score", "_doc", or a doc-values field
    order: str = "desc"         # asc | desc
    missing: Any = None


@dataclass
class ShardDoc:
    segment_idx: int
    doc: int                    # local doc id within segment
    score: float
    sort_values: Tuple = ()
    # collapse key (CollapseBuilder analog): set when the request collapses
    # on a field; the coordinator merge dedups across shards by this value
    ckey: Any = None


@dataclass
class ShardQueryResult:
    docs: List[ShardDoc]
    total_hits: int
    total_relation: str         # "eq" | "gte"
    max_score: Optional[float]
    # per-field term stats used (exposed for the coordinator's DFS merge)
    doc_count: int = 0
    dfs: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # which collector context ran (TopDocsCollectorContext analog) and, for
    # the pruned path, (posting blocks total, posting blocks scored)
    collector: str = "dense"
    prune_stats: Optional[Tuple[int, int]] = None
    # per-shard profile block when the request set "profile": true
    # (search/profile/query/QueryProfiler analog)
    profile: Optional[Dict[str, Any]] = None
    # the shard stopped counting/collecting at terminate_after
    terminated_early: bool = False


def parse_sort(sort_body: Any) -> List[SortSpec]:
    if sort_body is None:
        return [SortSpec("_score")]
    if isinstance(sort_body, (str, dict)):
        sort_body = [sort_body]
    out: List[SortSpec] = []
    for entry in sort_body:
        if isinstance(entry, str):
            out.append(SortSpec(entry, "asc" if entry not in ("_score",) else "desc"))
        elif isinstance(entry, dict):
            (fname, spec), = entry.items()
            if isinstance(spec, str):
                out.append(SortSpec(fname, spec))
            else:
                out.append(SortSpec(fname, spec.get("order", "asc"),
                                    spec.get("missing")))
        else:
            raise IllegalArgumentError(f"bad sort entry {entry!r}")
    return out


def collect_query_terms(q: dsl.Query) -> Dict[str, List[str]]:
    """Walk the tree for (field -> analyzed terms) needing df stats."""
    from elasticsearch_tpu_torch.analysis import STANDARD
    out: Dict[str, List[str]] = {}

    def walk(node, mappers=None):
        if isinstance(node, dsl.Match):
            out.setdefault(node.field, []).append(node.text)
        elif isinstance(node, (dsl.MatchPhrase, dsl.MatchPhrasePrefix)):
            out.setdefault(node.field, []).append(node.text)
        elif isinstance(node, dsl.MoreLikeThis):
            for f in node.fields:
                for text in node.like:
                    out.setdefault(f, []).append(text)
        elif isinstance(node, dsl.MultiMatch):
            for f in node.fields:
                out.setdefault(f.partition("^")[0], []).append(node.text)
        elif isinstance(node, dsl.Bool):
            for c in node.must + node.should + node.must_not + node.filter:
                walk(c)
        elif isinstance(node, (dsl.ConstantScore,)):
            walk(node.filter)
        elif isinstance(node, dsl.DisMax):
            for c in node.queries:
                walk(c)
        elif isinstance(node, dsl.Boosting):
            walk(node.positive)
            walk(node.negative)
        elif isinstance(node, (dsl.ScriptScore, dsl.FunctionScore, dsl.Nested)):
            if node.query is not None:
                walk(node.query)
        elif isinstance(node, dsl.Knn) and node.filter is not None:
            walk(node.filter)
        elif isinstance(node, dsl.SpanTerm):
            out.setdefault(node.field, []).append(node.value)
        elif isinstance(node, dsl.SpanNear):
            for c in node.clauses:
                walk(c)
        elif isinstance(node, dsl.SpanOr):
            for c in node.clauses:
                walk(c)
        elif isinstance(node, dsl.SpanNot):
            walk(node.include)
        elif isinstance(node, dsl.SpanFirst):
            walk(node.match)
        elif isinstance(node, (dsl.SpanContaining, dsl.SpanWithin)):
            walk(node.big)
            walk(node.little)
        elif isinstance(node, dsl.Pinned) and node.organic is not None:
            walk(node.organic)

    walk(q)
    return out


def contains_term_expansion(q: dsl.Query) -> bool:
    """True when the tree holds a node whose matching terms are EXPANDED
    from the dictionary (prefix and friends): such queries can match even
    when none of their literal texts exist as terms, so the can_match df
    pre-filter must not skip shards for them."""
    found = [False]

    def walk(node):
        if isinstance(node, (dsl.MatchPhrasePrefix, dsl.Prefix,
                             dsl.Wildcard, dsl.Regexp, dsl.Fuzzy,
                             dsl.MoreLikeThis, dsl.SpanMulti,
                             dsl.Intervals, dsl.QueryString,
                             dsl.SimpleQueryString, dsl.TermsSet,
                             dsl.DistanceFeature, dsl.ScriptQuery,
                             dsl.GeoPolygon, dsl.GeoShape,
                             dsl.Percolate)):
            # expanded/derived matching: literal query text existing as a
            # term is NOT a precondition for hits, so can_match must not
            # prune on df. (query_string/simple_query_string parse to
            # plain trees only at execute time, so they are conservative
            # here; span/intervals leaves DO contribute literal terms via
            # collect_query_terms but their structural nodes stay lenient.)
            found[0] = True
        elif isinstance(node, dsl.Bool):
            for c in node.must + node.should + node.must_not + node.filter:
                walk(c)
        elif isinstance(node, dsl.ConstantScore):
            walk(node.filter)
        elif isinstance(node, dsl.DisMax):
            for c in node.queries:
                walk(c)
        elif isinstance(node, dsl.Boosting):
            walk(node.positive)
            walk(node.negative)
        elif isinstance(node, (dsl.ScriptScore, dsl.FunctionScore,
                               dsl.Nested)):
            if node.query is not None:
                walk(node.query)
        elif isinstance(node, dsl.Pinned):
            # pinned ids match regardless of the organic clause's terms
            found[0] = True

    walk(q)
    return found[0]


def shard_term_stats(reader: Reader, mappers: MapperService,
                     q: dsl.Query) -> Tuple[int, Dict[str, Dict[str, int]]]:
    """(doc count, field -> term -> df) aggregated over segments.

    Both counts INCLUDE deleted docs, like Lucene's docFreq/docCount —
    postings still contain tombstoned entries until a merge purges them, and
    df <= doc_count must hold or idf goes negative."""
    doc_count = sum(seg.n_docs for seg in reader.segments)
    field_texts = collect_query_terms(q)
    dfs: Dict[str, Dict[str, int]] = {}
    for fname, texts in field_texts.items():
        mapper = mappers.mapper(fname)
        analyzer = getattr(mapper, "search_analyzer", None)
        if analyzer is None:
            from elasticsearch_tpu_torch.analysis import STANDARD
            analyzer = STANDARD
        terms = set()
        for t in texts:
            terms.update(analyzer.terms(t))
        per_term: Dict[str, int] = {}
        for term in terms:
            df = 0
            for seg in reader.segments:
                pf = seg.postings.get(fname)
                if pf is not None:
                    tid = pf.terms.get(term)
                    if tid is not None:
                        df += int(pf.doc_freq[tid])
            if df:
                per_term[term] = df
        dfs[fname] = per_term
    return doc_count, dfs


def shard_field_stats(reader: Reader, mappers: MapperService,
                      q: dsl.Query) -> Dict[str, Tuple[float, int]]:
    """field -> (sum_doc_len, docs_with_field) over segments — the
    CollectionStatistics half of the DFS phase (search/dfs/DfsPhase.java:43
    ships sumTotalTermFreq + docCount so every shard norms with one global
    avgdl)."""
    out: Dict[str, Tuple[float, int]] = {}
    for fname in collect_query_terms(q):
        sum_len = 0.0
        n_docs = 0
        for seg in reader.segments:
            pf = seg.postings.get(fname)
            if pf is not None:
                sum_len += float(pf.sum_doc_len)
                n_docs += int((pf.doc_lens > 0).sum())
        if n_docs:
            out[fname] = (sum_len, n_docs)
    return out


def wand_clauses(query: dsl.Query, mappers: MapperService
                 ) -> Optional[Tuple[str, List[Tuple[str, float]]]]:
    """(field, [(text, boost)]) if the query is a pure disjunctive text
    scoring query the WAND executor can serve; None otherwise.

    Eligible shapes (the actual weak-AND use cases,
    TopDocsCollectorContext.java:127): a Match with OR semantics, or a
    Bool of ONLY should Match clauses on the SAME analyzed text field —
    per-clause boosts ride into the block weights. Shape extraction is
    shared with the mesh plane (dsl.disjunctive_clauses); this adds the
    field-type check. (Term clauses stay dense: this build's dense
    handler scores term-on-text as constant boost, and collector choice
    must never change scores.)"""
    got = dsl.disjunctive_clauses(query)
    if got is None:
        return None
    field, clauses = got
    if mappers.field_type(field) not in ("text", "search_as_you_type"):
        return None
    return field, clauses


def choose_collector_context(query: dsl.Query,
                             mappers: MapperService,
                             sort: List[SortSpec],
                             search_after: Optional[Sequence[Any]],
                             min_score: Optional[float],
                             collectors: Optional[List],
                             track_total_hits: Any,
                             size: int) -> str:
    """Pick the shard collector the way TopDocsCollectorContext.java:215
    does: a pure score-sorted top-k disjunctive text query with no
    aggregations runs through the block-max-pruned batched device executor
    ("wand_topk"); everything else takes the dense score-vector path
    ("dense").

    Totals semantics on this static-shape machine
    (counts-then-skip, the reference's collector behavior): with a finite
    track_total_hits threshold (the default 10,000 included) the pruned
    path counts matching docs from the score plane of the blocks it
    gathers — if the observed count reaches the threshold the response is
    ("gte", threshold), exactly the reference's early-termination
    contract; if not, the shard re-scores unpruned (cheap: few blocks) for
    an exact count. Only track_total_hits: true (exact count, unbounded)
    forces the dense path."""
    if size <= 0 or collectors or min_score is not None:
        return "dense"
    if search_after is not None:
        return "dense"
    if not (len(sort) == 1 and sort[0].field == "_score"
            and sort[0].order == "desc"):
        return "dense"
    if track_total_hits is True:
        return "dense"
    if wand_clauses(query, mappers) is not None:
        return "wand_topk"
    # pure top-k kNN / resolved-expansion shapes skip the dense score
    # vector when the shard plane is resident (query_shard falls back to
    # "dense" when it is not). The COLLECTOR choice itself never changes
    # results; the quantized plane kNN pass is exact up to its re-rank
    # depth by contract (search.plane.rerank_depth / quantized settings)
    if isinstance(query, dsl.Knn) and \
            mappers.field_type(query.field) == "dense_vector":
        return "knn_topk"
    if isinstance(query, dsl.TextExpansion) and query.tokens:
        return "sparse_topk"
    return "dense"


def query_shard(reader: Reader,
                mappers: MapperService,
                query: dsl.Query,
                size: int = 10,
                from_: int = 0,
                sort: Optional[List[SortSpec]] = None,
                search_after: Optional[Sequence[Any]] = None,
                track_total_hits: Any = DEFAULT_TRACK_TOTAL_HITS,
                min_score: Optional[float] = None,
                doc_count_override: Optional[int] = None,
                df_overrides: Optional[Dict[str, Dict[str, int]]] = None,
                field_stats_overrides: Optional[
                    Dict[str, Tuple[float, int]]] = None,
                collectors: Optional[List] = None,
                rescore: Any = None,
                collapse: Optional[Dict[str, Any]] = None,
                slice_spec: Optional[Dict[str, Any]] = None,
                profile: bool = False,
                terminate_after: Optional[int] = None,
                cancel_check: Optional[Any] = None,
                device: DeviceLike = None) -> ShardQueryResult:
    """Execute one query over all segments of a shard snapshot.

    ``cancel_check``: zero-arg callable raising TaskCancelledError —
    invoked between segments (the reference checks inside the Lucene
    collection loop, search/query/QueryPhase.java:115).

    ``collectors``: optional aggregation collectors, each called with
    (ctx, segment_idx, scores, mask) per segment (two-level agg model).

    ``device``: where the segments' device arrays live (None = the CUDA
    card).
    """
    device = resolve_device(device)
    sort = sort or [SortSpec("_score")]
    from elasticsearch_tpu_torch.search.execute import resolve_aliases
    query = resolve_aliases(query, mappers)
    # sort keys read segment columns directly — resolve aliases here too
    sort = [SortSpec(mappers.resolve_field(s.field), s.order, s.missing)
            if not s.field.startswith("_") else s for s in sort]
    if collapse and isinstance(collapse.get("field"), str):
        collapse = {**collapse,
                    "field": mappers.resolve_field(collapse["field"])}
    doc_count, dfs = shard_term_stats(reader, mappers, query)
    if doc_count_override is not None:
        doc_count = doc_count_override
    if df_overrides is not None:
        merged = {f: dict(v) for f, v in dfs.items()}
        for f, terms in df_overrides.items():
            merged.setdefault(f, {}).update(terms)
        dfs = merged

    want = from_ + size
    exact_total = track_total_hits is True or (
        isinstance(track_total_hits, int) and track_total_hits > 0)
    track_limit = (1 << 62) if track_total_hits is True else (
        int(track_total_hits) if track_total_hits else 0)

    # the reader's snapshot mask governs visibility (point-in-time reads),
    # not the segment's current mask — deletes after snapshot stay invisible
    ctxs = []
    for si, (seg, live_host) in enumerate(zip(reader.segments, reader.live_masks)):
        n_pad = next_pow2(max(seg.n_docs, 1), minimum=BLOCK)
        snap = np.zeros(n_pad, bool)
        snap[: len(live_host)] = live_host
        ctxs.append(SegmentContext(seg, mappers, segment_idx=si,
                                   doc_count_override=doc_count,
                                   df_overrides=dfs,
                                   field_stats_overrides=field_stats_overrides,
                                   live_override=torch.as_tensor(
                                       snap, device=device),
                                   reader=reader, device=device))
    # collector-context dispatch (TopDocsCollectorContext.java:215 analog):
    # pure score-sorted top-k text queries with totals disabled skip the
    # dense score vector entirely and run block-max-pruned device top-k
    collector = choose_collector_context(
        query, mappers, sort, search_after, min_score, collectors,
        track_total_hits, size)
    if rescore is not None or collapse is not None or slice_spec is not None:
        # these phases need the full candidate set / extra doc context —
        # always the dense collector (the reference likewise disables
        # early termination when rescoring or collapsing)
        collector = "dense"
    if terminate_after:
        # the terminate_after counting contract needs per-segment counts
        # (QueryPhase.java:223's early-terminating collector)
        collector = "dense"
    if collector in ("knn_topk", "sparse_topk") and profile:
        # the profile block names the dense collectors; keep it truthful
        collector = "dense"
    if rescore is not None:
        if not (len(sort) == 1 and sort[0].field == "_score"):
            # the reference rejects rescore+sort explicitly; silently
            # returning unrescored hits would be worse than the error
            raise IllegalArgumentError(
                "cannot use [rescore] in combination with [sort]")
        # the first pass must COLLECT at least the rescore window, or docs
        # a rescorer would promote are cut by base score before it runs
        # (SearchService.java sizes the query phase to max(size, window))
        specs = rescore if isinstance(rescore, list) else [rescore]
        want = max(want, max(int(s.get("window_size", 10)) for s in specs))
    import time as _time
    t_query_start = _time.perf_counter_ns()

    def _profile_block(collector_name: str, reason: str) -> Dict[str, Any]:
        """QueryProfiler-shaped block: one entry for the query tree, one
        for the collector, timed wall-to-wall per shard."""
        elapsed = _time.perf_counter_ns() - t_query_start
        return {
            "query": [{
                "type": type(query).__name__,
                "description": repr(query),
                "time_in_nanos": elapsed,
            }],
            "collector": [{
                "name": collector_name,
                "reason": reason,
                "time_in_nanos": elapsed,
            }],
            "segments": len(ctxs),
        }

    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    request_breaker = BREAKERS.breaker("request")
    if collector == "wand_topk":
        wc = wand_clauses(query, mappers)
        assert wc is not None   # choose_collector_context guarantees it
        w_field, w_clauses = wc
        # THE pruned text executor — the same Q-query function the
        # micro-batcher's drains run, with Q=1 (solo is a batch of one:
        # one kernel call-site per query class on the served path)
        from elasticsearch_tpu_torch.search.batch_executor import (
            batched_wand_topk_shard,
        )
        # transient: per-segment phase gathers + top-k outputs, NOT a dense
        # score vector — pruning is precisely what keeps this small
        transient = sum(
            (P1_BUCKET * BLOCK * 8) + want * 8 for _ in ctxs)
        with request_breaker.limit_scope(transient, "wand_topk"):
            candidates, hits, relation, max_score, prune = \
                batched_wand_topk_shard(
                    ctxs, w_field, [w_clauses], want,
                    track_limit if exact_total else 0, cancel_check)[0]
        return ShardQueryResult(
            candidates[from_: from_ + size], hits, relation, max_score,
            doc_count=doc_count, dfs=dfs,
            collector="wand_topk", prune_stats=prune,
            profile=(_profile_block(
                "WandTopKCollector", "search_top_hits (block-max pruned)")
                if profile else None))

    if collector == "sparse_topk":
        # resolved text_expansion through THE sparse executor (the
        # batched path runs the same function): one launch over the
        # rank_features plane when resident, one batched launch per
        # segment otherwise — counts read off the score plane either way
        # (the dense path's mask sum)
        from elasticsearch_tpu_torch.search.batch_executor import (
            sparse_topk_shard,
        )
        expansion = [(t, w * query.boost)
                     for t, w in query.tokens.items()]
        # the executor charges the request breaker at its launch sites
        # (plane scope, or one score plane per segment)
        (cands, total, max_score), = sparse_topk_shard(
            ctxs, query.field, [expansion], want,
            check_members=cancel_check)
        relation = "eq"
        if exact_total and track_limit < (1 << 62) \
                and total > track_limit:
            total, relation = track_limit, "gte"
        result = ShardQueryResult(
            cands[from_: from_ + size], total, relation, max_score,
            doc_count=doc_count, dfs=dfs)
        if profile:
            result.profile = _profile_block(
                "SimpleTopScoreDocCollector", "search_top_hits")
        return result

    # Lucene-style kNN rewrite: per-segment top-k merged to shard-global
    # k through execute.knn_shard_winners — the same executor the
    # batched kNN path runs, with Q=1
    from elasticsearch_tpu_torch.search.execute import KnnBound, rewrite_knn
    query = rewrite_knn(query, ctxs, cancel_check)

    if collector == "knn_topk" and isinstance(query, KnnBound):
        # the rewrite already holds the shard-global winners; reading
        # them off the bound node reproduces the dense path's per-segment
        # collection byte-for-byte without its per-segment launches
        entries: List[ShardDoc] = []
        for si, (docs, doc_scores) in (query.per_segment or {}).items():
            for d, s in zip(docs, doc_scores):
                entries.append(ShardDoc(int(si), int(d), float(s),
                                        (float(s),)))
        entries.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        total = len(entries)
        relation = "eq"
        if exact_total and track_limit < (1 << 62) \
                and total > track_limit:
            total, relation = track_limit, "gte"
        max_score = entries[0].score if entries else None
        return ShardQueryResult(
            entries[from_: from_ + size], total, relation, max_score,
            doc_count=doc_count, dfs=dfs)

    # the dense collector: every segment's query tree compiles to a score
    # row + match mask (execute), top-k'd per segment on the card (K10)
    # or collected whole on the host for field sorts and collapse
    score_sort = sort[0].field == "_score" and len(sort) == 1
    score_asc = score_sort and sort[0].order == "asc"
    # transient device estimate for the dense path: one f32 score vector
    # plus mask/where temporaries per segment (HierarchyCircuitBreakerService
    # request-breaker analog, applied to device memory) — released when the
    # shard query completes; an over-budget query 429s instead of OOMing
    transient = sum(8 * ctx.n_docs_pad for ctx in ctxs)
    request_breaker.add_estimate(transient, "dense_query")
    try:
        result = _query_shard_dense(
            ctxs, query, sort, size, from_, want, search_after, min_score,
            exact_total, track_limit, score_sort, score_asc, collectors,
            cancel_check, doc_count, dfs, rescore, collapse, slice_spec,
            terminate_after)
        if profile:
            name = ("SimpleFieldCollector" if not score_sort
                    else "SimpleTopScoreDocCollector")
            reason = "search_top_hits"
            if collectors:
                name = f"MultiCollector [{name}, aggregations]"
                reason = "search_multi"
            result.profile = _profile_block(name, reason)
        return result
    finally:
        request_breaker.release(transient)


def _slice_mask(ctx: SegmentContext, slice_spec: Dict[str, Any]) -> np.ndarray:
    """Host mask for sliced scroll: murmur3(_id) % max == id, the
    reference's default _id-based slicing (search/slice/SliceBuilder.java)."""
    from elasticsearch_tpu_torch.utils.murmur3 import hash_routing
    sid = int(slice_spec.get("id", 0))
    smax = int(slice_spec.get("max", 1))
    if not (0 <= sid < smax):
        raise IllegalArgumentError(
            f"slice id [{sid}] must be in [0, max={smax})")
    mask = np.zeros(ctx.segment.n_docs, bool)
    for doc_id, local in ctx.segment.id_to_doc.items():
        if hash_routing(doc_id) % smax == sid:
            mask[local] = True
    return mask


def collapse_marker(key: Any) -> Any:
    """Hashable group identity for a collapse key. Docs missing the field
    form one null group (CollapseTopFieldDocs semantics); JSON round-trips
    may turn tuples into lists, so normalize. Shared by the shard-level
    and coordinator-level dedup so their semantics cannot drift."""
    if key is None:
        return ("__missing__",)
    return tuple(key) if isinstance(key, list) else key


def _collapse_keys(ctx: SegmentContext, field_name: str,
                   docs: np.ndarray) -> list:
    """One collapse key per doc from keyword ords or numeric doc values."""
    field_name = ctx.mappers.resolve_field(field_name)
    seg = ctx.segment
    kf = seg.keywords.get(field_name)
    if kf is not None:
        out = []
        for d in docs:
            ords = kf.ord_values[kf.ord_offsets[d]: kf.ord_offsets[d + 1]]
            out.append(kf.term_list[int(ords[0])] if len(ords) else None)
        return out
    dv = seg.doc_values.get(field_name)
    if dv is not None:
        return [float(dv.values[d]) if dv.exists[d] else None for d in docs]
    return [None] * len(docs)


def _apply_rescore(ctxs, candidates, rescore_body, cancel_check):
    """Window re-scoring over the shard's top candidates
    (search/rescore/QueryRescorer.java): combined = query_weight * first +
    rescore_query_weight * second for docs matching the rescore query."""
    from elasticsearch_tpu_torch.search.execute import execute
    specs = rescore_body if isinstance(rescore_body, list) else [rescore_body]
    for spec in specs:
        window = int(spec.get("window_size", 10))
        q = spec.get("query") or {}
        rq = dsl.parse_query(q.get("rescore_query"))
        qw = float(q.get("query_weight", 1.0))
        rqw = float(q.get("rescore_query_weight", 1.0))
        mode = q.get("score_mode", "total")
        head, tail = candidates[:window], candidates[window:]
        by_segment: Dict[int, list] = {}
        for i, c in enumerate(head):
            by_segment.setdefault(c.segment_idx, []).append(i)
        for si, idxs in by_segment.items():
            if cancel_check is not None:
                cancel_check()
            scores, mask = execute(rq, ctxs[si])
            s_host = _host(scores)
            m_host = _host(mask)
            for i in idxs:
                c = head[i]
                first = c.score
                if not m_host[c.doc]:
                    # Lucene's QueryRescorer.combine: a windowed doc the
                    # rescore query does NOT match scores qw * first
                    combined = qw * first
                    head[i] = ShardDoc(c.segment_idx, c.doc, combined,
                                       (combined,), c.ckey)
                    continue
                second = float(s_host[c.doc])
                if mode == "total":
                    combined = qw * first + rqw * second
                elif mode == "multiply":
                    combined = first * rqw * second
                elif mode == "avg":
                    combined = (qw * first + rqw * second) / 2.0
                elif mode == "max":
                    combined = max(qw * first, rqw * second)
                elif mode == "min":
                    combined = min(qw * first, rqw * second)
                else:
                    raise IllegalArgumentError(
                        f"unknown rescore score_mode [{mode}]")
                head[i] = ShardDoc(c.segment_idx, c.doc, combined,
                                   (combined,), c.ckey)
        head.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        candidates = head + tail
    return candidates


def _query_shard_dense(ctxs, query, sort, size, from_, want, search_after,
                       min_score, exact_total, track_limit, score_sort,
                       score_asc, collectors, cancel_check, doc_count, dfs,
                       rescore=None, collapse=None, slice_spec=None,
                       terminate_after=None):
    from elasticsearch_tpu_torch.ops.topk import dense_topk
    from elasticsearch_tpu_torch.search.execute import execute
    terminated = False
    total_hits = 0
    candidates: List[ShardDoc] = []
    for si, ctx in enumerate(ctxs):
        if cancel_check is not None:
            cancel_check()
        seg = ctx.segment
        scores, mask = execute(query, ctx)
        if slice_spec is not None:
            # sliced scroll: this slice only sees docs whose _id hashes
            # into its partition (SliceBuilder.java's _id slicing)
            mask = mask & ctx.to_device_mask(_slice_mask(ctx, slice_spec))
        if min_score is not None:
            mask = mask & (scores >= min_score)
        if terminate_after:
            # collect EXACTLY up to the cap: if this segment would push
            # past it, keep only the first remaining matches in doc order
            # (the reference's collector stops mid-segment the same way).
            # Runs AFTER slice/min_score narrowing — the cap counts docs
            # actually collected, not docs a later filter discards.
            remaining = int(terminate_after) - total_hits
            mask_host = _host(mask)
            if int(mask_host.sum()) > remaining:
                order = np.nonzero(mask_host)[0][:remaining]
                clipped = np.zeros(len(mask_host), bool)
                clipped[order] = True
                mask = mask & torch.as_tensor(clipped, device=ctx.device)
                terminated = True
        scores = torch.where(mask, scores, -math.inf)

        total_hits += int(mask.sum())

        if score_sort and search_after is not None:
            # the cursor must cut BEFORE per-segment top-k, or deeper docs in
            # a segment whose best hit was already returned would be lost
            a_score = float(search_after[0])
            a_si = int(search_after[1]) if len(search_after) > 2 else -1
            a_doc = int(search_after[2]) if len(search_after) > 2 else -1
            doc_idx = torch.arange(ctx.n_docs_pad, device=ctx.device)
            before = (scores > a_score) if score_asc else (scores < a_score)
            at = scores == a_score
            if si < a_si:
                allowed = before
            elif si == a_si:
                allowed = before | (at & (doc_idx > a_doc))
            else:
                allowed = before | at
            scores = torch.where(allowed, scores, -math.inf)

        if score_sort and collapse is None:
            k = min(max(want, 1), ctx.n_docs_pad)
            if score_asc:
                # ascending: select the LOWEST scores among matches
                neg = torch.where(torch.isfinite(scores), -scores,
                                  -math.inf)
                top_s, top_d = dense_topk(neg, k)
                top_s = -_host(top_s)
                top_d = _host(top_d)
                finite = np.isfinite(top_s)
                top_s, top_d = top_s[finite], top_d[finite]
            else:
                top_s, top_d = dense_topk(scores, k)
                top_s = _host(top_s)
                top_d = _host(top_d)
            for s, d in zip(top_s, top_d):
                if s == -np.inf:
                    break
                candidates.append(ShardDoc(si, int(d), float(s), (float(s),)))
        else:
            # field sorts — and collapse, which must see EVERY matching doc
            # so no group's best hit can be cut by a top-k window (the
            # reference's grouping collector guarantees top-N distinct
            # groups; a heuristic over-collect cannot under key skew)
            mask_host = _host(mask)[: seg.n_docs]
            matched = np.nonzero(mask_host)[0]
            if len(matched) == 0:
                continue
            scores_host = _host(scores)[: seg.n_docs]
            keys = _sort_keys(ctx, sort, matched, scores_host)
            for row, d in enumerate(matched):
                candidates.append(ShardDoc(si, int(d), float(scores_host[d]),
                                           tuple(k[row] for k in keys)))

        for collector in (collectors or []):
            collector.collect(ctx, si, scores, mask)

        if terminate_after and total_hits >= int(terminate_after):
            # stop visiting further segments; totals clamp at the cap
            # (SearchService terminate_after contract: relation eq,
            # terminated_early true)
            terminated = True
            break

    # order candidates by the sort spec, (segment, doc) as final tiebreak
    reverse = [s.order == "desc" for s in sort]
    if score_sort:
        candidates.sort(key=lambda c: (-c.score if reverse[0] else c.score,
                                       c.segment_idx, c.doc))
    else:
        import functools
        candidates.sort(key=functools.cmp_to_key(
            lambda a, b: _compare(a, b, reverse)))

    if search_after is not None:
        candidates = [c for c in candidates
                      if _after(c, search_after, sort, reverse)]

    if rescore is not None and score_sort:
        candidates = _apply_rescore(ctxs, candidates, rescore, cancel_check)

    if collapse is not None:
        field_name = collapse.get("field")
        if not field_name:
            raise IllegalArgumentError("collapse requires [field]")
        by_seg: Dict[int, list] = {}
        for i, c in enumerate(candidates):
            by_seg.setdefault(c.segment_idx, []).append(i)
        for si, idxs in by_seg.items():
            keys = _collapse_keys(
                ctxs[si], field_name,
                np.asarray([candidates[i].doc for i in idxs], np.int64))
            for i, key in zip(idxs, keys):
                c = candidates[i]
                candidates[i] = ShardDoc(c.segment_idx, c.doc, c.score,
                                         c.sort_values, key)
        # keep the best hit per key
        seen: set = set()
        deduped = []
        for c in candidates:
            marker = collapse_marker(c.ckey)
            if marker in seen:
                continue
            seen.add(marker)
            deduped.append(c)
        candidates = deduped

    window = candidates[from_: from_ + size]
    max_score = None
    if candidates and score_sort:
        max_score = max(c.score for c in candidates)

    relation = "eq"
    if terminate_after and total_hits > int(terminate_after):
        total_hits = int(terminate_after)
    if exact_total and track_limit < (1 << 62) and total_hits > track_limit:
        relation = "gte"
        total_hits = track_limit
    return ShardQueryResult(window, total_hits, relation, max_score,
                            doc_count=doc_count, dfs=dfs,
                            terminated_early=terminated)


def _sort_keys(ctx: SegmentContext, sort: List[SortSpec],
               matched: np.ndarray, scores_host: np.ndarray) -> List[list]:
    """Per-spec key columns. Numeric keys are floats, keyword keys are
    strings, missing values are None (sorted last like the reference's
    default _last, unless spec.missing overrides)."""
    keys = []
    for spec in sort:
        if spec.field == "_score":
            keys.append([float(scores_host[d]) for d in matched])
        elif spec.field == "_doc":
            keys.append([float(d) for d in matched])
        elif spec.field in ctx.segment.keywords:
            kf = ctx.segment.keywords[spec.field]
            col = []
            for d in matched:
                ords = kf.ord_values[kf.ord_offsets[d]: kf.ord_offsets[d + 1]]
                if len(ords) == 0:
                    col.append(spec.missing if spec.missing is not None else None)
                else:
                    terms = sorted(kf.term_list[int(o)] for o in ords)
                    # multi-valued: min for asc, max for desc (ES default mode)
                    col.append(terms[0] if spec.order == "asc" else terms[-1])
            keys.append(col)
        else:
            dv = ctx.segment.doc_values.get(spec.field)
            if dv is None:
                fill = float(spec.missing) if spec.missing is not None else None
                keys.append([fill] * len(matched))
            else:
                col = []
                for d in matched:
                    if dv.exists[d]:
                        vals = dv.multi.get(int(d), [dv.values[d]])
                        v = (min(vals) if spec.order == "asc" else max(vals))
                        col.append(float(v))
                    elif spec.missing is not None:
                        col.append(float(spec.missing))
                    else:
                        col.append(None)
                keys.append(col)
    return keys


def _cmp_values(a, b, rev: bool) -> int:
    """Element compare with None (missing) always last."""
    if a is None and b is None:
        return 0
    if a is None:
        return 1
    if b is None:
        return -1
    if a == b:
        return 0
    lt = a < b
    if rev:
        return 1 if lt else -1
    return -1 if lt else 1


def _compare(a: ShardDoc, b: ShardDoc, reverse: List[bool]) -> int:
    for av, bv, rev in zip(a.sort_values, b.sort_values, reverse):
        c = _cmp_values(av, bv, rev)
        if c:
            return c
    if (a.segment_idx, a.doc) < (b.segment_idx, b.doc):
        return -1
    if (a.segment_idx, a.doc) > (b.segment_idx, b.doc):
        return 1
    return 0


def _after(c: ShardDoc, after: Sequence[Any], sort: List[SortSpec],
           reverse: List[bool]) -> bool:
    """True if candidate sorts strictly after the cursor. Internal cursors
    (scroll) append (segment_idx, doc) beyond the user sort values; ties on
    user values then break on that, so scroll never drops tied docs."""
    if sort[0].field == "_score":
        a_score = float(after[0])
        if c.score != a_score:
            asc = sort[0].order == "asc"
            return (c.score > a_score) if asc else (c.score < a_score)
        if len(after) >= 3:
            return (c.segment_idx, c.doc) > (int(after[1]), int(after[2]))
        return False
    n = len(sort)
    for v, a, rev in zip(c.sort_values, after[:n], reverse):
        if isinstance(v, str) and not isinstance(a, (str, type(None))):
            raise IllegalArgumentError(
                f"search_after value [{a}] does not match keyword sort field type")
        try:
            av = a if (isinstance(a, str) or a is None or v is None) else float(a)
        except (TypeError, ValueError):
            raise IllegalArgumentError(
                f"search_after value [{a}] does not match numeric sort field type")
        cmp = _cmp_values(v, av, rev)
        if cmp:
            return cmp > 0
    if len(after) >= n + 2:
        return (c.segment_idx, c.doc) > (int(after[n]), int(after[n + 1]))
    return False
