"""Per-segment query execution: Query tree -> (scores, mask) on the card.

The JAX package's ``search/execute.py``, cut to the nodes this package
serves. Every query node compiles to a dense score row [n_docs_pad] f32
and a boolean match mask, which compose on the card (bool = masked sums,
dis_max = masked max, ...). Structural filters (term/terms/range/exists/
ids/prefix/wildcard/regexp/fuzzy) build their masks on the host from
columnar doc values -- the cacheable "filter context" -- while scoring
clauses run the kernels: ``match`` and the phrase family K8
(``bm25_block_scores``), ``script_score``'s vector functions K9
(``vector_scores``), ``knn`` the kNN executor (exact: K5-K7, masked
per query for a filtered ``knn``; approximate: the IVF probe K14 on
segments or planes the JAX package routes to its IVF index),
``rank_feature`` and ``text_expansion`` K19 (``sparse_scores``; a
``model_text`` left unresolved runs the expansion model, K18).

Served nodes: match_all, match_none, match, multi_match, match_phrase,
match_phrase_prefix, term, terms, range, exists, ids, prefix, wildcard,
regexp, fuzzy, bool, constant_score, dis_max, boosting, knn (top-level or
inside a compound query), rank_feature, text_expansion and script_score
with cosineSimilarity / dotProduct / l2norm. Any other node raises
NotPortedError naming it (``dense_query:<Node>``).

The glue between kernels is plain PyTorch, one rounded f32 op at a time
as the JAX package's eager ops run, and sums of several rows are taken
in row order, so the card and the CPU give the same bits.
"""

from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import resolve_device
from elasticsearch_tpu_torch.index.segment import Segment, next_pow2, BLOCK
from elasticsearch_tpu_torch.mapping import MapperService, parse_date_millis
from elasticsearch_tpu_torch.mapping.mappers import RANGE_TYPES
from elasticsearch_tpu_torch.ops import (
    Bm25Executor, DeviceFeatures, DevicePostings, DeviceVectors,
    KnnExecutor, SparseExecutor, device_live_mask,
)
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.utils.errors import (
    NotPortedError, QueryParsingError,
)


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

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.n_docs_pad, dtype=torch.float32,
                           device=self.device)

    def none_mask(self) -> torch.Tensor:
        return torch.zeros(self.n_docs_pad, dtype=torch.bool,
                           device=self.device)

    def all_mask(self) -> torch.Tensor:
        return self.live

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


Result = Tuple[torch.Tensor, torch.Tensor]  # (scores f32, mask bool)


def execute(q: dsl.Query, ctx: SegmentContext) -> Result:
    """(scores [n_docs_pad] f32, mask [n_docs_pad] bool) of one query node
    over one segment; a node this package does not serve yet raises
    NotPortedError naming it."""
    handler = _HANDLERS.get(type(q))
    if handler is None:
        raise NotPortedError(f"dense_query:{type(q).__name__}")
    return handler(q, ctx)


def _where(mask: torch.Tensor, scores, other: float = 0.0) -> torch.Tensor:
    """``jnp.where(mask, scores, other)`` over an f32 row. A Python float
    ``scores`` (a boost) is rounded to f32, as ``jnp.float32(boost)``;
    scalars ride the launch as arguments, with no copy to the card."""
    if not isinstance(scores, torch.Tensor):
        scores = float(scores)
    return torch.where(mask, scores, float(other))


def _sum_rows(rows: List[torch.Tensor]) -> torch.Tensor:
    """Elementwise sum of rows in row order (``jnp.sum`` over a short
    stacked axis), the same bits on every device."""
    total = rows[0]
    for r in rows[1:]:
        total = total + r
    return total


def _max_rows(rows: List[torch.Tensor]) -> torch.Tensor:
    total = rows[0]
    for r in rows[1:]:
        total = torch.maximum(total, r)
    return total


def _any_rows(rows: List[torch.Tensor]) -> torch.Tensor:
    total = rows[0]
    for r in rows[1:]:
        total = total | r
    return total


# ---------------------------------------------------------------------------
# host-side mask builders (filter context)
# ---------------------------------------------------------------------------

def _term_mask_host(ctx: SegmentContext, field_name: str, value: Any) -> np.ndarray:
    """Docs containing the exact term/value in keyword/numeric/text field."""
    seg = ctx.segment
    n = seg.n_docs
    mask = np.zeros(n, bool)
    if field_name == "_id":
        d = seg.id_to_doc.get(str(value))
        if d is not None:
            mask[d] = True
        return mask
    ftype = ctx.mappers.field_type(field_name)
    if ftype == "constant_keyword":
        # every doc of the index carries the constant — a matching term
        # matches ALL docs, even ones that omitted the field
        const = getattr(ctx.mappers.mapper(field_name), "value", None)
        if const is not None and str(value) == const:
            mask[:] = True
        return mask
    if ftype == "ip":
        import ipaddress
        if "/" in str(value):
            # CIDR term query over the (small) ip term dictionary
            try:
                net = ipaddress.ip_network(str(value), strict=False)
            except ValueError:
                raise QueryParsingError(f"failed to parse CIDR [{value}]")

            def in_net(t: str) -> bool:
                try:
                    return ipaddress.ip_address(t) in net
                except ValueError:
                    return False
            kf_ip = seg.keywords.get(field_name)
            if kf_ip is not None:
                for t in kf_ip.terms:
                    if in_net(t):
                        mask[kf_ip.docs_with_term(t)] = True
            return mask
        # exact: canonicalize the query value like the mapper canonicalized
        # the indexed form ('2001:0DB8::1' must find '2001:db8::1')
        try:
            value = str(ipaddress.ip_address(str(value)))
        except ValueError:
            pass   # non-address text simply matches nothing below
    if ftype is None and "." in field_name:
        # keyed lookup into a flattened field: flat.key -> path-prefixed
        # term on the root column (x-pack FlattenedFieldMapper keyed terms)
        root, _, keypath = field_name.partition(".")
        root_m = ctx.mappers.mapper(root)
        if root_m is not None and root_m.type_name == "flattened":
            from elasticsearch_tpu_torch.mapping.mappers import FLATTENED_SEP
            kf_flat = seg.keywords.get(root)
            if kf_flat is not None:
                mask[kf_flat.docs_with_term(
                    f"{keypath}{FLATTENED_SEP}{value}")] = True
            return mask
    kf = seg.keywords.get(field_name)
    if kf is not None:
        mask[kf.docs_with_term(str(value))] = True
        return mask
    dv = seg.doc_values.get(field_name)
    if dv is not None:
        v = _coerce_numeric(ctx, field_name, value)
        np.equal(dv.values, v, out=mask, where=dv.exists)
        mask &= dv.exists
        # multi-valued docs match if ANY value matches
        for doc, extra in dv.multi.items():
            if not mask[doc] and any(x == v for x in extra):
                mask[doc] = True
        return mask
    pf = seg.postings.get(field_name)
    if pf is not None:
        docs, _ = pf.postings_for(str(value))
        mask[docs] = True
        return mask
    return mask


def _coerce_numeric(ctx: SegmentContext, field_name: str, value: Any) -> float:
    t = ctx.mappers.field_type(field_name)
    try:
        if t == "date":
            return parse_date_millis(value)
        if t == "boolean":
            if isinstance(value, bool):
                return 1.0 if value else 0.0
            return 1.0 if str(value).lower() == "true" else 0.0
        return float(value)
    except (TypeError, ValueError):
        raise QueryParsingError(
            f"failed to parse value [{value}] for field [{field_name}]")


def _range_mask_host(ctx: SegmentContext, q: dsl.Range) -> np.ndarray:
    seg = ctx.segment
    if ctx.mappers.field_type(q.field) == "ip":
        # numeric address-space comparison, not lexicographic strings
        import ipaddress
        mask = np.zeros(seg.n_docs, bool)
        kf = seg.keywords.get(q.field)
        if kf is None:
            return mask

        def addr(v):
            return int(ipaddress.ip_address(str(v)))
        try:
            for term in kf.terms:
                a = addr(term)
                if q.gt is not None and not a > addr(q.gt):
                    continue
                if q.gte is not None and not a >= addr(q.gte):
                    continue
                if q.lt is not None and not a < addr(q.lt):
                    continue
                if q.lte is not None and not a <= addr(q.lte):
                    continue
                mask[kf.docs_with_term(term)] = True
        except ValueError as e:
            raise QueryParsingError(f"failed to parse ip range: {e}")
        return mask
    dv = seg.doc_values.get(q.field)
    if dv is None:
        # range over keyword terms (lexicographic)
        kf = seg.keywords.get(q.field)
        mask = np.zeros(seg.n_docs, bool)
        if kf is None:
            return mask
        for term in kf.terms:
            ok = True
            if q.gt is not None and not term > str(q.gt):
                ok = False
            if q.gte is not None and not term >= str(q.gte):
                ok = False
            if q.lt is not None and not term < str(q.lt):
                ok = False
            if q.lte is not None and not term <= str(q.lte):
                ok = False
            if ok:
                mask[kf.docs_with_term(term)] = True
        return mask
    vals = dv.values
    mask = dv.exists.copy()
    if q.gt is not None:
        mask &= vals > _coerce_numeric(ctx, q.field, q.gt)
    if q.gte is not None:
        mask &= vals >= _coerce_numeric(ctx, q.field, q.gte)
    if q.lt is not None:
        mask &= vals < _coerce_numeric(ctx, q.field, q.lt)
    if q.lte is not None:
        mask &= vals <= _coerce_numeric(ctx, q.field, q.lte)
    # multi-valued docs match if ANY value matches
    for doc, extra in dv.multi.items():
        if mask[doc]:
            continue
        for v in extra:
            ok = True
            if q.gt is not None and not v > _coerce_numeric(ctx, q.field, q.gt):
                ok = False
            if q.gte is not None and not v >= _coerce_numeric(ctx, q.field, q.gte):
                ok = False
            if q.lt is not None and not v < _coerce_numeric(ctx, q.field, q.lt):
                ok = False
            if q.lte is not None and not v <= _coerce_numeric(ctx, q.field, q.lte):
                ok = False
            if ok:
                mask[doc] = True
                break
    return mask


def _exists_mask_host(ctx: SegmentContext, field_name: str) -> np.ndarray:
    seg = ctx.segment
    n = seg.n_docs
    # range fields store nothing under their own name — existence lives
    # on the #lo bound companion column
    if f"{field_name}#lo" in seg.doc_values:
        return seg.doc_values[f"{field_name}#lo"].exists.copy()
    if field_name in seg.doc_values:
        return seg.doc_values[field_name].exists.copy()
    if field_name in seg.keywords:
        kf = seg.keywords[field_name]
        return (np.diff(kf.ord_offsets) > 0)
    if field_name in seg.postings:
        return seg.postings[field_name].doc_lens > 0
    if field_name in seg.vectors:
        return seg.vectors[field_name].exists.copy()
    if field_name in seg.features:
        ff = seg.features[field_name]
        mask = np.zeros(n, bool)
        docs = ff.block_docs.reshape(-1)
        mask[docs[docs >= 0]] = True
        return mask
    if field_name in seg.geo:
        return ~np.isnan(seg.geo[field_name][:, 0])
    return np.zeros(n, bool)


def _expand_terms(ctx: SegmentContext, field_name: str, predicate) -> List[str]:
    """All index terms of a field matching a predicate (prefix/wildcard/regexp/fuzzy)."""
    seg = ctx.segment
    terms: List[str] = []
    kf = seg.keywords.get(field_name)
    if kf is not None:
        terms = [t for t in kf.terms if predicate(t)]
    pf = seg.postings.get(field_name)
    if pf is not None:
        terms += [t for t in pf.terms if predicate(t)]
    return terms


def _multi_term_mask(ctx: SegmentContext, field_name: str, terms: List[str]) -> np.ndarray:
    mask = np.zeros(ctx.segment.n_docs, bool)
    for t in terms:
        mask |= _term_mask_host(ctx, field_name, t)
    return mask


def _cached_filter(ctx: SegmentContext, key, build) -> np.ndarray:
    """Filter cache living on the immutable segment itself, so cached masks
    survive across queries; LRU-bounded like the reference's
    IndicesQueryCache.java:53."""
    return ctx.segment.cached_filter(key, build)


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------

def _h_match_all(q: dsl.MatchAll, ctx: SegmentContext) -> Result:
    return torch.full((ctx.n_docs_pad,), q.boost, dtype=torch.float32,
                      device=ctx.device), ctx.all_mask()


def _h_match_none(q: dsl.MatchNone, ctx: SegmentContext) -> Result:
    return ctx.zeros(), ctx.none_mask()


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


def _h_match(q: dsl.Match, ctx: SegmentContext) -> Result:
    analyzer = ctx.search_analyzer(q.field)
    terms = analyzer.terms(q.text)
    if not terms:
        return ctx.zeros(), ctx.none_mask()
    ex = _bm25_executor(ctx, q.field)
    if ex is None:
        # not a text field: fall back to term-equality semantics
        return _h_term(dsl.Term(field=q.field, value=q.text, boost=q.boost), ctx)
    scores = ex.scores(terms, ctx.live, boost=q.boost,
                       df_override=ctx.df_for(q.field),
                       avgdl_override=ctx.avgdl_for(q.field))
    mask = scores > 0.0
    msm = dsl.resolve_minimum_should_match(q.minimum_should_match, len(set(terms)))
    if q.operator == "and" or msm > 1:
        need = len(terms) if q.operator == "and" else msm
        count = np.zeros(ctx.segment.n_docs, np.int32)
        pf = ctx.segment.postings[q.field]
        for t in set(terms):
            docs, _ = pf.postings_for(t)
            count[docs] += 1
        mask = mask & ctx.to_device_mask(count >= min(need, len(set(terms))))
    return _where(mask, scores), mask


def _h_multi_match(q: dsl.MultiMatch, ctx: SegmentContext) -> Result:
    results = []
    expanded: dict = {}   # field -> boost; dedup keeps the highest boost
    for f in q.fields:
        fname, _, fboost = f.partition("^")
        boost = q.boost * (float(fboost) if fboost else 1.0)
        if "*" in fname:
            # wildcard field patterns expand to matching text-ish fields
            # (QueryParserHelper.resolveMappingFields analog; resolved
            # fields are DEDUPED so most_fields never double-counts)
            for name in ctx.mappers.field_names():
                if fnmatch.fnmatch(name, fname) and \
                        ctx.mappers.field_type(name) in (
                            "text", "keyword", "search_as_you_type"):
                    expanded[name] = max(expanded.get(name, 0.0), boost)
        else:
            expanded[fname] = max(expanded.get(fname, 0.0), boost)
    for fname, boost in expanded.items():
        if q.type == "bool_prefix":
            # search-as-you-type: every term matches normally, the LAST
            # term matches as a prefix, joined by the OPERATOR (default
            # OR — any clause suffices; "and" requires all), per
            # MultiMatchQueryBuilder Type.BOOL_PREFIX /
            # MatchBoolPrefixQueryBuilder
            toks = ctx.search_analyzer(fname).terms(q.text)
            if not toks:
                continue
            head = " ".join(toks[:-1])
            clauses: List[dsl.Query] = []
            if head:
                clauses.append(dsl.Match(field=fname, text=head,
                                         operator=q.operator))
            clauses.append(dsl.Prefix(field=fname, value=toks[-1]))
            if q.operator == "and":
                node = dsl.Bool(must=clauses, boost=boost)
            else:
                node = dsl.Bool(should=clauses,
                                minimum_should_match=1, boost=boost)
            results.append(execute(node, ctx))
            continue
        results.append(execute(dsl.Match(field=fname, text=q.text,
                                         operator=q.operator, boost=boost), ctx))
    if not results:
        return ctx.zeros(), ctx.none_mask()
    scores = [r[0] for r in results]
    any_mask = _any_rows([r[1] for r in results])
    if q.type == "most_fields":
        total = _sum_rows(scores)
    else:  # best_fields
        total = _max_rows(scores)
    return _where(any_mask, total), any_mask


def _h_match_phrase(q: dsl.MatchPhrase, ctx: SegmentContext) -> Result:
    analyzer = ctx.search_analyzer(q.field)
    tokens = analyzer.analyze(q.text)
    if not tokens:
        return ctx.zeros(), ctx.none_mask()
    pf = ctx.segment.postings.get(q.field)
    if pf is None:
        return ctx.zeros(), ctx.none_mask()
    # candidates: docs containing all terms (host AND of postings)
    cand: Optional[set] = None
    for tok in tokens:
        docs, _ = pf.postings_for(tok.term)
        s = set(docs.tolist())
        cand = s if cand is None else (cand & s)
        if not cand:
            break
    matched = []
    if cand:
        # verify positions host-side (fetch-sized candidate sets)
        rel = [t.position - tokens[0].position for t in tokens]
        for doc in cand:
            first = pf.positions_for(tokens[0].term, doc)
            ok = False
            for p0 in first:
                if all(_has_position(pf, t.term, doc, p0 + r, q.slop)
                       for t, r in zip(tokens[1:], rel[1:])):
                    ok = True
                    break
            if ok:
                matched.append(doc)
    mask_host = np.zeros(ctx.segment.n_docs, bool)
    mask_host[matched] = True
    mask = ctx.to_device_mask(mask_host) & ctx.live
    # score matched docs with the BM25 of the phrase terms (documented
    # divergence: the reference scores by phrase frequency)
    ex = _bm25_executor(ctx, q.field)
    scores = ex.scores([t.term for t in tokens], ctx.live, boost=q.boost,
                       df_override=ctx.df_for(q.field),
                       avgdl_override=ctx.avgdl_for(q.field))
    return _where(mask, scores), mask


def _h_match_phrase_prefix(q: dsl.MatchPhrasePrefix,
                           ctx: SegmentContext) -> Result:
    """Phrase match with the last term prefix-expanded against the term
    dictionary (MatchPhrasePrefixQueryBuilder's MultiPhrasePrefixQuery,
    capped at max_expansions)."""
    analyzer = ctx.search_analyzer(q.field)
    tokens = analyzer.analyze(q.text)
    if not tokens:
        return ctx.zeros(), ctx.none_mask()
    pf = ctx.segment.postings.get(q.field)
    if pf is None:
        return ctx.zeros(), ctx.none_mask()
    prefix = tokens[-1].term
    expansions = sorted(t for t in pf.terms
                        if t.startswith(prefix))[: q.max_expansions]
    if not expansions:
        return ctx.zeros(), ctx.none_mask()
    head = tokens[:-1]
    # candidates: docs with all head terms AND any expansion
    cand: Optional[set] = None
    for tok in head:
        docs, _ = pf.postings_for(tok.term)
        s = set(docs.tolist())
        cand = s if cand is None else (cand & s)
        if not cand:
            break
    exp_docs: set = set()
    for term in expansions:
        docs, _ = pf.postings_for(term)
        exp_docs.update(docs.tolist())
    cand = exp_docs if cand is None else (cand & exp_docs)
    matched = []
    rel = [t.position - tokens[0].position for t in tokens]
    for doc in cand or ():
        starts = (pf.positions_for(head[0].term, doc)
                  if head else pf.positions_for(expansions[0], doc))
        ok = False
        if not head:
            ok = True   # single prefix term: presence is a match
        else:
            for p0 in starts:
                if all(_has_position(pf, t.term, doc, p0 + r, 0)
                       for t, r in zip(head[1:], rel[1:-1])):
                    if any(_has_position(pf, e, doc, p0 + rel[-1], 0)
                           for e in expansions):
                        ok = True
                        break
        if ok:
            matched.append(doc)
    mask_host = np.zeros(ctx.segment.n_docs, bool)
    mask_host[matched] = True
    mask = ctx.to_device_mask(mask_host) & ctx.live
    # score matched docs with BM25 over the head terms + expansions, the
    # same analog _h_match_phrase documents (constant scoring would rank
    # many-occurrence docs identically to one-occurrence docs)
    ex = _bm25_executor(ctx, q.field)
    score_terms = [t.term for t in head] + expansions
    scores = ex.scores(score_terms, ctx.live, boost=q.boost,
                       df_override=ctx.df_for(q.field),
                       avgdl_override=ctx.avgdl_for(q.field))
    return _where(mask, scores), mask


def _has_position(pf, term: str, doc: int, want: int, slop: int) -> bool:
    pos = pf.positions_for(term, doc)
    if slop == 0:
        return bool(np.any(pos == want))
    return bool(np.any(np.abs(pos - want) <= slop))


def _h_term(q: dsl.Term, ctx: SegmentContext) -> Result:
    key = ("term", q.field, str(q.value))
    mask_host = _cached_filter(ctx, key, lambda: _term_mask_host(ctx, q.field, q.value))
    mask = ctx.to_device_mask(mask_host) & ctx.live
    return _where(mask, q.boost), mask


def _h_terms(q: dsl.Terms, ctx: SegmentContext) -> Result:
    key = ("terms", q.field, tuple(str(v) for v in q.values))
    mask_host = _cached_filter(
        ctx, key, lambda: np.logical_or.reduce(
            [_term_mask_host(ctx, q.field, v) for v in q.values])
        if q.values else np.zeros(ctx.segment.n_docs, bool))
    mask = ctx.to_device_mask(mask_host) & ctx.live
    return _where(mask, q.boost), mask


def _range_field_mask(ctx: SegmentContext, q: dsl.Range,
                      mapper) -> np.ndarray:
    """Interval relations against a RANGE field: the doc's [lo, hi]
    bounds live on the #lo/#hi companion columns
    (RangeFieldMapper.RangeType query semantics)."""
    seg = ctx.segment
    coerce = mapper._coerce
    qlo = coerce(q.gte) if q.gte is not None else (
        coerce(q.gt) if q.gt is not None else -np.inf)
    qhi = coerce(q.lte) if q.lte is not None else (
        coerce(q.lt) if q.lt is not None else np.inf)
    lo_dv = seg.doc_values.get(f"{q.field}#lo")
    hi_dv = seg.doc_values.get(f"{q.field}#hi")
    if lo_dv is None or hi_dv is None:
        return np.zeros(seg.n_docs, bool)

    def relate(lo, hi) -> bool:
        if q.relation == "within":
            return lo >= qlo and hi <= qhi
        if q.relation == "contains":
            return lo <= qlo and hi >= qhi
        return lo <= qhi and hi >= qlo   # intersects

    lo = lo_dv.values.astype(np.float64)
    hi = hi_dv.values.astype(np.float64)
    exists = lo_dv.exists & hi_dv.exists
    if q.relation == "within":
        rel = (lo >= qlo) & (hi <= qhi)
    elif q.relation == "contains":
        rel = (lo <= qlo) & (hi >= qhi)
    else:   # intersects
        rel = (lo <= qhi) & (hi >= qlo)
    mask = exists & rel
    # multi-valued docs: ANY of the doc's ranges may satisfy the relation
    # (lo.multi[d][i] pairs with hi.multi[d][i])
    for d in set(lo_dv.multi) | set(hi_dv.multi):
        los = lo_dv.multi.get(d, [lo[d]])
        his = hi_dv.multi.get(d, [hi[d]])
        mask[d] = any(relate(float(a), float(b))
                      for a, b in zip(los, his))
    return mask


def _h_range(q: dsl.Range, ctx: SegmentContext) -> Result:
    mapper = ctx.mappers.mapper(q.field)
    if mapper is not None and \
            getattr(mapper, "type_name", "") in RANGE_TYPES:
        key = ("range_field", q.field, str(q.gt), str(q.gte), str(q.lt),
               str(q.lte), q.relation)
        mask_host = _cached_filter(
            ctx, key, lambda: _range_field_mask(ctx, q, mapper))
        mask = ctx.to_device_mask(mask_host) & ctx.live
        return _where(mask, q.boost), mask
    key = ("range", q.field, str(q.gt), str(q.gte), str(q.lt), str(q.lte))
    mask_host = _cached_filter(ctx, key, lambda: _range_mask_host(ctx, q))
    mask = ctx.to_device_mask(mask_host) & ctx.live
    return _where(mask, q.boost), mask


def _h_exists(q: dsl.Exists, ctx: SegmentContext) -> Result:
    mask_host = _cached_filter(ctx, ("exists", q.field),
                               lambda: _exists_mask_host(ctx, q.field))
    mask = ctx.to_device_mask(mask_host) & ctx.live
    return _where(mask, q.boost), mask


def _h_ids(q: dsl.Ids, ctx: SegmentContext) -> Result:
    mask_host = np.zeros(ctx.segment.n_docs, bool)
    for doc_id in q.values:
        d = ctx.segment.id_to_doc.get(doc_id)
        if d is not None:
            mask_host[d] = True
    mask = ctx.to_device_mask(mask_host) & ctx.live
    return _where(mask, q.boost), mask


def _h_prefix(q: dsl.Prefix, ctx: SegmentContext) -> Result:
    terms = _expand_terms(ctx, q.field, lambda t: t.startswith(q.value))
    mask = ctx.to_device_mask(_multi_term_mask(ctx, q.field, terms)) & ctx.live
    return _where(mask, q.boost), mask


def _h_wildcard(q: dsl.Wildcard, ctx: SegmentContext) -> Result:
    rx = re.compile(fnmatch.translate(q.value))
    terms = _expand_terms(ctx, q.field, lambda t: rx.match(t) is not None)
    mask = ctx.to_device_mask(_multi_term_mask(ctx, q.field, terms)) & ctx.live
    return _where(mask, q.boost), mask


def _h_regexp(q: dsl.Regexp, ctx: SegmentContext) -> Result:
    rx = re.compile(q.value)
    terms = _expand_terms(ctx, q.field, lambda t: rx.fullmatch(t) is not None)
    mask = ctx.to_device_mask(_multi_term_mask(ctx, q.field, terms)) & ctx.live
    return _where(mask, q.boost), mask


def _h_fuzzy(q: dsl.Fuzzy, ctx: SegmentContext) -> Result:
    max_edits = _fuzziness_to_edits(q.fuzziness, q.value)
    terms = _expand_terms(
        ctx, q.field, lambda t: _levenshtein_within(t, q.value, max_edits))
    mask = ctx.to_device_mask(_multi_term_mask(ctx, q.field, terms)) & ctx.live
    return _where(mask, q.boost), mask


def _fuzziness_to_edits(fuzziness: Any, value: str) -> int:
    if isinstance(fuzziness, int):
        return fuzziness
    s = str(fuzziness).upper()
    if s == "AUTO":
        n = len(value)
        return 0 if n <= 2 else (1 if n <= 5 else 2)
    return int(s)


def _levenshtein_within(a: str, b: str, k: int) -> bool:
    if abs(len(a) - len(b)) > k:
        return False
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        if min(cur) > k:
            return False
        prev = cur
    return prev[-1] <= k


def _h_bool(q: dsl.Bool, ctx: SegmentContext) -> Result:
    scores = ctx.zeros()
    mask = None

    for clause in q.must:
        s, m = execute(clause, ctx)
        scores = scores + s
        mask = m if mask is None else (mask & m)
    for clause in q.filter:
        _, m = execute(clause, ctx)
        mask = m if mask is None else (mask & m)

    if q.should:
        should_scores = ctx.zeros()
        should_count = torch.zeros(ctx.n_docs_pad, dtype=torch.int32,
                                   device=ctx.device)
        for clause in q.should:
            s, m = execute(clause, ctx)
            should_scores = should_scores + _where(m, s)
            should_count = should_count + m.to(torch.int32)
        if q.minimum_should_match is None:
            # should is optional when must/filter exist; required otherwise
            msm = 0 if (q.must or q.filter) else 1
        else:
            msm = dsl.resolve_minimum_should_match(
                q.minimum_should_match, len(q.should))
        if msm > 0:
            should_mask = should_count >= msm
            mask = should_mask if mask is None else (mask & should_mask)
        scores = scores + should_scores

    if mask is None:
        mask = ctx.all_mask()
    for clause in q.must_not:
        _, m = execute(clause, ctx)
        mask = mask & ~m

    mask = mask & ctx.live
    return _where(mask, scores * q.boost), mask


def _h_constant_score(q: dsl.ConstantScore, ctx: SegmentContext) -> Result:
    _, mask = execute(q.filter, ctx)
    return _where(mask, q.boost), mask


def _h_dis_max(q: dsl.DisMax, ctx: SegmentContext) -> Result:
    if not q.queries:
        return ctx.zeros(), ctx.none_mask()
    results = [execute(c, ctx) for c in q.queries]
    scores = [r[0] for r in results]
    best = _max_rows(scores)
    rest = _sum_rows(scores) - best
    total = best + q.tie_breaker * rest
    mask = _any_rows([r[1] for r in results])
    return _where(mask, total * q.boost), mask


def _h_boosting(q: dsl.Boosting, ctx: SegmentContext) -> Result:
    pos_s, pos_m = execute(q.positive, ctx)
    _, neg_m = execute(q.negative, ctx)
    scores = torch.where(neg_m, pos_s * q.negative_boost, pos_s)
    return _where(pos_m, scores), pos_m


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


def ann_segment_route(ctx: "SegmentContext", field: str, k: int,
                      num_candidates: int, filtered: bool = False
                      ) -> Optional[Tuple]:
    """IVF routing decision for one segment, shared by the solo kNN
    rewrite and the batched executor so they cannot diverge.

    None = take the exact brute-force path (small segment, filtered
    query, unknown index type, or no vector column). Otherwise
    (index, rows, oversample, nprobe) -- with index None when the field
    is mapped but this segment holds zero vectors (no hits)."""
    if filtered:
        return None       # filtered kNN stays exact (correctness first)
    seg = ctx.segment
    vf = seg.vectors.get(field)
    if vf is None:
        return None
    mapper = ctx.mappers.mapper(field)
    opts = getattr(mapper, "index_options", None) or {}
    wants_ivf = opts.get("type") == "ivf"
    if not wants_ivf and seg.n_docs < ANN_DEFAULT_MIN_DOCS:
        return None
    if opts.get("type") not in (None, "ivf"):
        return None       # unknown index type: exact
    from elasticsearch_tpu_torch.ops.ivf import IVFIndex

    def build():
        rows = np.nonzero(vf.exists)[0]
        if len(rows) == 0:
            return None, rows.astype(np.int64)
        index = IVFIndex.build(vf.matrix[rows],
                               nlist=opts.get("nlist"),
                               similarity=vf.similarity,
                               device=ctx.device)
        return index, rows.astype(np.int64)
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    from elasticsearch_tpu_torch.utils.errors import CircuitBreakingError
    # budget refusals memoize under the breaker limit they were refused
    # at (the plane registry's budget-token pattern): no re-paying the
    # full k-means per query just to re-trip, but a raised limit retries
    budget_token = BREAKERS.breaker("device").limit
    refused_key = ("ivf_refused", field, str(ctx.device))
    if seg._device_cache.get(refused_key) == budget_token:
        return None
    try:
        index, rows = seg.device(("ivf", field, str(ctx.device)), build)
    except CircuitBreakingError:
        seg._device_cache[refused_key] = budget_token
        return None       # index over the device budget: exact serves
    if index is None:
        return (None, rows, 0, 0)   # mapped, but no vectors here

    oversample = min(max(2 * k, k + 16), len(rows))
    nprobe = opts.get("nprobe") or max(
        1, int(np.ceil(num_candidates / max(index.list_len, 1))))
    return (index, rows, oversample, nprobe)


def filter_context_mask(ctx: "SegmentContext", filt, filter_key,
                        stats: Optional[Dict[str, float]] = None
                        ) -> np.ndarray:
    """Host-side filter-context mask [n_docs_pad] for one segment,
    cached ACROSS drains on the immutable segment keyed by the filter's
    value key (the reader-generation component of the cache key IS the
    segment identity: a refresh produces new segments, deletes ride the
    live mask -- never the match mask). The batched kNN paths execute
    every distinct filter tree once per segment; only the [Q, N_pad]
    stack itself rebuilds per drain."""
    def build():
        _, fmask = execute(filt, ctx)
        return fmask.cpu().numpy()
    if filter_key is None:
        return build()
    key = ("filter_ctx_mask", filter_key)
    hit = key in ctx.segment._filter_cache
    mask = _cached_filter(ctx, key, build)
    if stats is not None and hit:
        stats["filter_mask_reuses"] = stats.get("filter_mask_reuses",
                                                0) + 1
    return mask


def knn_shard_winners(ctxs: List["SegmentContext"], field: str, specs,
                      k: int, check_members=None,
                      stats: Optional[Dict[str, float]] = None
                      ) -> List[List[Tuple[int, int, float]]]:
    """THE kNN top-k executor for the served path -- Q queries (each a
    spec with query_vector / filter / filter_key / num_candidates),
    solo being simply Q=1. Returns one sorted ``[(segment_idx,
    local_doc, raw_score)]`` winner list (len <= k) per member, the
    merge Lucene's KnnVectorQuery rewrite performs.

    Route per segment and member, one shared launch per class: the
    resident whole-shard plane (one launch / one shard-IVF probe via
    plane_exec.plane_knn_winners), else per segment: unfiltered members
    on IVF-routed segments share one batched nprobe probe per DERIVED
    PROBE WIDTH (members whose num_candidates imply different nprobe
    probe in separate groups -- each exactly as it would alone -- instead
    of falling anywhere back), filtered members one (optionally masked)
    [Q, D] x [D, N] launch with filter-context masks computed once per
    distinct filter (cached across drains per segment). A k above the
    kernels' KMAX runs their selection in cursor rounds
    (csrc/topk_common.cuh)."""
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
                                     check_members, stats)
    vectors = np.asarray([s.query_vector for s in specs], np.float32)
    unfiltered = [qi for qi in range(n_q) if specs[qi].filter is None]
    for ctx in ctxs:
        dev = DeviceVectors.for_segment(ctx.segment, field, ctx.device)
        if dev is None:
            continue
        if check_members is not None:
            check_members()
        exact_idx = list(range(n_q))
        if unfiltered and ann_segment_route(
                ctx, field, k, specs[unfiltered[0]].num_candidates,
                filtered=False) is not None:
            # IVF-routed segment: group unfiltered members by the probe
            # width their num_candidates implies; each group probes in
            # one batched launch, exactly as its members would solo
            groups: Dict[int, Tuple[Tuple, List[int]]] = {}
            for qi in unfiltered:
                route = ann_segment_route(
                    ctx, field, k, specs[qi].num_candidates,
                    filtered=False)
                groups.setdefault(route[3], (route, []))[1].append(qi)
            live_host = ctx.live.cpu().numpy()[: ctx.segment.n_docs]
            for nprobe, (route, members) in sorted(groups.items()):
                index, rows, oversample, _n = route
                if index is None:
                    continue     # mapped, but no vectors here
                probed = index.probe_live(
                    vectors[members], k, nprobe, rows, live_host,
                    ctx.segment_idx, oversample)
                for qi, hits in zip(members, probed):
                    per_member_hits[qi].extend(hits)
            exact_idx = [qi for qi in range(n_q)
                         if specs[qi].filter is not None]
        if not exact_idx:
            continue
        # exact path: distinct filters resolve to masks once per segment
        # (cached across drains on the segment itself)
        masks = None
        fkeys = {specs[qi].filter_key for qi in exact_idx}
        if fkeys != {None}:
            by_key: Dict[Optional[str], Any] = {}
            for qi in exact_idx:
                s_qi = specs[qi]
                if s_qi.filter is not None and \
                        s_qi.filter_key not in by_key:
                    by_key[s_qi.filter_key] = filter_context_mask(
                        ctx, s_qi.filter, s_qi.filter_key, stats)
            if len(fkeys) == 1:
                # every member carries the SAME filter: one shared mask
                masks = torch.as_tensor(by_key[next(iter(fkeys))],
                                        device=ctx.device)
                if stats is not None:
                    stats["knn_shared_mask_segments"] = \
                        stats.get("knn_shared_mask_segments", 0) + 1
            else:
                rows_m = np.ones((len(exact_idx), ctx.n_docs_pad), bool)
                for row, qi in enumerate(exact_idx):
                    fk = specs[qi].filter_key
                    if fk is not None:
                        rows_m[row] = by_key[fk]
                masks = rows_m
        ex = KnnExecutor(dev)
        k_seg = min(k, ctx.n_docs_pad)
        s, d = ex.top_k_batch(vectors[exact_idx], ctx.live, k_seg, masks)
        s = s.cpu().numpy()
        d = d.cpu().numpy()
        for row, qi in enumerate(exact_idx):
            for sc, doc in zip(s[row], d[row]):
                if sc > -np.inf:
                    per_member_hits[qi].append(
                        (ctx.segment_idx, int(doc), float(sc)))
    for qi in range(n_q):
        per_member_hits[qi].sort(key=lambda x: -x[2])
        per_member_hits[qi] = per_member_hits[qi][:k]
    return per_member_hits


def rewrite_knn(q: dsl.Query, segment_ctxs: List["SegmentContext"],
                cancel_check=None) -> dsl.Query:
    """Replace every Knn node with a KnnBound node holding the shard-global
    top-k (merged across segments). ``cancel_check`` (zero-arg, raising)
    runs between per-segment launches so a cancelled or budget-expired
    task stops paying for vector scans.

    The rewrite IS a batch of one: it calls ``knn_shard_winners`` -- the
    same executor the batched kNN path runs -- with a single spec, so solo
    and batched kNN cannot diverge. Compound nodes (bool, dis_max,
    constant_score, boosting, script_score, function_score) are rewritten
    clause by clause."""
    if isinstance(q, dsl.Knn):
        from types import SimpleNamespace
        spec = SimpleNamespace(
            query_vector=q.query_vector, filter=q.filter,
            filter_key=repr(q.filter) if q.filter is not None else None,
            num_candidates=q.num_candidates)
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
    # recurse into compound nodes
    if isinstance(q, dsl.Bool):
        return dsl.Bool(must=[rewrite_knn(c, segment_ctxs, cancel_check)
                              for c in q.must],
                        should=[rewrite_knn(c, segment_ctxs, cancel_check)
                                for c in q.should],
                        must_not=[rewrite_knn(c, segment_ctxs, cancel_check)
                                  for c in q.must_not],
                        filter=[rewrite_knn(c, segment_ctxs, cancel_check)
                                for c in q.filter],
                        minimum_should_match=q.minimum_should_match, boost=q.boost)
    if isinstance(q, dsl.DisMax):
        return dsl.DisMax(queries=[rewrite_knn(c, segment_ctxs, cancel_check)
                                   for c in q.queries],
                          tie_breaker=q.tie_breaker, boost=q.boost)
    if isinstance(q, dsl.ConstantScore) and q.filter is not None:
        return dsl.ConstantScore(
            filter=rewrite_knn(q.filter, segment_ctxs, cancel_check),
            boost=q.boost)
    if isinstance(q, dsl.Boosting):
        return dsl.Boosting(
            positive=rewrite_knn(q.positive, segment_ctxs, cancel_check),
            negative=rewrite_knn(q.negative, segment_ctxs, cancel_check),
            negative_boost=q.negative_boost, boost=q.boost)
    if isinstance(q, dsl.ScriptScore) and q.query is not None:
        return dsl.ScriptScore(
            query=rewrite_knn(q.query, segment_ctxs, cancel_check),
            source=q.source, params=q.params, boost=q.boost)
    if isinstance(q, dsl.FunctionScore) and q.query is not None:
        return dsl.FunctionScore(
            query=rewrite_knn(q.query, segment_ctxs, cancel_check),
            functions=q.functions, boost_mode=q.boost_mode,
            score_mode=q.score_mode, boost=q.boost)
    return q


def _h_knn_bound(q: KnnBound, ctx: SegmentContext) -> Result:
    entry = (q.per_segment or {}).get(ctx.segment_idx)
    if entry is None:
        return ctx.zeros(), ctx.none_mask()
    docs, doc_scores = entry
    scores_host = np.zeros(ctx.n_docs_pad, np.float32)
    mask_host = np.zeros(ctx.n_docs_pad, bool)
    scores_host[docs] = doc_scores
    mask_host[docs] = True
    return (torch.as_tensor(scores_host, device=ctx.device),
            torch.as_tensor(mask_host, device=ctx.device))


def _h_knn(q: dsl.Knn, ctx: SegmentContext) -> Result:
    """Direct (single-segment) execution; the shard phase normally rewrites
    Knn to KnnBound first for shard-global k semantics."""
    bound = rewrite_knn(q, [ctx])
    return _h_knn_bound(bound, ctx)


def _h_rank_feature(q: dsl.RankFeature, ctx: SegmentContext) -> Result:
    # rank_feature targets a single feature inside a rank_features field, or a
    # standalone rank_feature field (stored as a single-feature field).
    fname, _, feat = q.field.partition(".")
    if feat and fname in ctx.segment.features:
        field_name, feature = fname, feat
    elif q.field in ctx.segment.features:
        field_name, feature = q.field, q.field
    else:
        return ctx.zeros(), ctx.none_mask()
    dev = DeviceFeatures.for_segment(ctx.segment, field_name, ctx.device)
    ex = SparseExecutor(dev, ctx.segment.features[field_name])
    pivot = q.scaling_factor if q.function == "log" else q.pivot
    scores = ex.scores([(feature, q.boost)], ctx.live,
                       function=q.function, pivot=pivot, exponent=q.exponent)
    return scores, scores > 0.0


def _h_text_expansion(q: dsl.TextExpansion, ctx: SegmentContext) -> Result:
    dev = DeviceFeatures.for_segment(ctx.segment, q.field, ctx.device)
    if dev is None:
        return ctx.zeros(), ctx.none_mask()
    tokens = q.tokens
    if tokens is None:
        # raw query text: run the expansion model on the card at query
        # time (the x-pack inference rewrite, collapsed into one local
        # kernel launch)
        from elasticsearch_tpu_torch.ml import get_model
        tokens = get_model(q.model_id, ctx.device).expand(q.model_text or "")
    ex = SparseExecutor(dev, ctx.segment.features[q.field])
    scores = ex.scores([(t, w * q.boost) for t, w in tokens.items()],
                       ctx.live, function="linear")
    return scores, scores > 0.0


_VECTOR_FN = re.compile(
    r"(cosineSimilarity|dotProduct|l2norm)\s*\(\s*params\.(\w+)\s*,\s*'?\"?([\w.]+)'?\"?\s*\)")


def _h_script_score(q: dsl.ScriptScore, ctx: SegmentContext) -> Result:
    """The reference's vector score functions (ScoreScriptUtils.java:132,
    151) plus '+ N' offsets -- the dominant script_score use in the
    vector-search benchmark configs. The similarity row is K9; undoing its
    positive-score transform and the offset are plain f32 ops (IEEE
    division)."""
    _, base_mask = execute(q.query, ctx)
    m = _VECTOR_FN.search(q.source)
    if not m:
        raise QueryParsingError(
            f"unsupported script_score source [{q.source}]; supported: "
            "cosineSimilarity/dotProduct/l2norm(params.<v>, '<field>') [+ N]")
    fn, param, field_name = m.groups()
    vec = q.params.get(param)
    if vec is None:
        raise QueryParsingError(f"missing script param [{param}]")
    dev = DeviceVectors.for_segment(ctx.segment, field_name, ctx.device)
    if dev is None:
        return ctx.zeros(), ctx.none_mask()
    from elasticsearch_tpu_torch.ops.knn import query_scores
    qv = np.asarray(vec, np.float32)
    if fn == "cosineSimilarity":
        raw = query_scores(dev, qv, "cosine")
        raw = raw * 2.0 - 1.0          # undo (1+cos)/2 -> raw cosine
    elif fn == "dotProduct":
        raw = query_scores(dev, qv, "dot_product")
        raw = (raw - 0.5) * 2.0        # raw dot
    else:
        raw = query_scores(dev, qv, "l2_norm")
        raw = torch.full_like(raw, 1.0) / raw - 1.0   # undo 1/(1+d)
    offset = 0.0
    m_off = re.search(r"\+\s*([\d.]+)\s*$", q.source)
    if m_off:
        offset = float(m_off.group(1))
    scores = (raw + offset) * q.boost
    mask = base_mask & dev.exists & ctx.live
    return _where(mask, scores), mask


class _ScriptDocView:
    """doc['field'].value / doc['field'].values view over segment columns."""

    class _Field:
        __slots__ = ("values",)

        def __init__(self, values):
            self.values = values

        @property
        def value(self):
            return self.values[0] if self.values else None

        @property
        def empty(self):
            return not self.values

        def size(self):
            return len(self.values)

        def __len__(self):
            return len(self.values)

        def __getitem__(self, i):
            return self.values[i]

    def __init__(self, seg, columns, d: int):
        self._seg = seg
        self._columns = columns
        self._d = d

    def __getitem__(self, name: str):
        dv = self._columns.get(name)
        if dv is not None and dv.exists[self._d]:
            # dv.multi holds the FULL value list for multi-valued docs
            # (values[d] is its first entry), matching phase.py/fetch.py
            multi = dv.multi.get(self._d)
            vals = [float(x) for x in multi] if multi is not None \
                else [float(dv.values[self._d])]
            return self._Field(vals)
        kf = self._seg.keywords.get(name)
        if kf is not None:
            ords = kf.ord_values[kf.ord_offsets[self._d]:
                                 kf.ord_offsets[self._d + 1]]
            return self._Field([kf.term_list[int(o)] for o in ords])
        return self._Field([])

    def containsKey(self, name: str) -> bool:  # noqa: N802 — painless API
        return len(self[name].values) > 0


_HANDLERS = {
    KnnBound: _h_knn_bound,
    dsl.MatchAll: _h_match_all,
    dsl.MatchNone: _h_match_none,
    dsl.Match: _h_match,
    dsl.MultiMatch: _h_multi_match,
    dsl.MatchPhrase: _h_match_phrase,
    dsl.MatchPhrasePrefix: _h_match_phrase_prefix,
    dsl.Term: _h_term,
    dsl.Terms: _h_terms,
    dsl.Range: _h_range,
    dsl.Exists: _h_exists,
    dsl.Ids: _h_ids,
    dsl.Prefix: _h_prefix,
    dsl.Wildcard: _h_wildcard,
    dsl.Regexp: _h_regexp,
    dsl.Fuzzy: _h_fuzzy,
    dsl.Bool: _h_bool,
    dsl.ConstantScore: _h_constant_score,
    dsl.DisMax: _h_dis_max,
    dsl.Boosting: _h_boosting,
    dsl.Knn: _h_knn,
    dsl.RankFeature: _h_rank_feature,
    dsl.TextExpansion: _h_text_expansion,
    dsl.ScriptScore: _h_script_score,
}
