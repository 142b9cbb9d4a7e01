"""Immutable segments: the unit of storage and device residency.

Design (SURVEY.md §7 "Segments are the gift"): the reference's core invariant
— immutable Lucene segments, append-only, merged in the background
(index/engine/InternalEngine.java:121, Lucene's IndexWriter) — maps directly
onto XLA's love of static shapes. A segment here is a set of immutable,
padded arrays:

- inverted index per text/keyword field: term dict (host) + postings packed
  into fixed-width blocks of ``BLOCK`` (doc_id, tf) lanes with per-block
  maxima for WAND-style pruning (the analog of Lucene's block postings +
  block-max metadata used by TopScoreDocCollector early termination,
  search/query/TopDocsCollectorContext.java:215);
- numeric doc values columns (int64/float64, host + f32 device mirror);
- dense-vector matrix [n_docs, dims] (the kNN substrate);
- rank_features sparse matrix in the same block layout as postings;
- positions (host-side) for phrase queries;
- _source store (host-side; fetch phase is I/O-bound, SURVEY.md §7).

Deletes never mutate a segment: they flip bits in a side ``live`` mask
(Lucene liveDocs analog). Padding uses doc_id == -1 sentinels; all device
shapes are padded to power-of-two buckets so the XLA compile cache stays warm
while segments grow/merge (SURVEY.md §7 hard part #3).
"""

from __future__ import annotations

import itertools
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from elasticsearch_tpu_torch.mapping import MapperService, ParsedDocument

# Postings block width: one TPU lane row. Each block belongs to exactly one
# term and holds up to BLOCK (doc, tf) entries, padded with doc = -1.
BLOCK = 128


def next_pow2(n: int, minimum: int = 1) -> int:
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


@dataclass
class PostingsField:
    """Inverted index for one field within one segment (host arrays).

    Block layout (built once, never mutated):
      block_docs    int32  [n_blocks, BLOCK]   local doc ids, -1 padding
      block_tfs     float32[n_blocks, BLOCK]   term frequencies (0 padding)
      block_term    int32  [n_blocks]          owning term id per block
      block_max_tf  float32[n_blocks]          max tf in block (pruning bound)
      term_block_start/count int32 [n_terms]   each term's block range
      doc_freq      int32  [n_terms]
    """

    terms: Dict[str, int]                     # term -> term_id
    block_docs: np.ndarray
    block_tfs: np.ndarray
    block_term: np.ndarray
    block_max_tf: np.ndarray
    term_block_start: np.ndarray
    term_block_count: np.ndarray
    doc_freq: np.ndarray
    doc_lens: np.ndarray                      # float32 [n_docs] analyzed length
    sum_doc_len: float
    # Positions CSR aligned with block entries: entry e = block*BLOCK + lane.
    # pos_offsets int32 [n_blocks*BLOCK + 1]; pos_flat int32 [total_positions].
    # Host-only; used for phrase verification (padding entries are empty).
    pos_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    pos_flat: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # derived, lazily computed: (k1, b, avgdl) -> per-block max impact (see
    # block_max_impact); never persisted. avgdl drifts continuously under a
    # DFS coordinator while indexing proceeds, so the cache is bounded
    # (FIFO) to stop unbounded growth on long-lived segments.
    _impact_cache: Dict[Tuple[float, float, float], np.ndarray] = field(
        default_factory=dict, repr=False, compare=False)
    # term -> int32 gather indices of the term's posting blocks. The block
    # layout is immutable, so the lists change only when the segment is
    # replaced (a refresh/merge publishes a NEW PostingsField) — caching
    # here is exactly "per (reader generation, field, term)". FIFO-bounded:
    # high-cardinality query streams must not grow it without limit.
    _term_idx_cache: Dict[str, np.ndarray] = field(
        default_factory=dict, repr=False, compare=False)

    TERM_IDX_CACHE_CAP = 4096

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_blocks(self) -> int:
        return int(self.block_docs.shape[0])

    def term_id(self, term: str) -> Optional[int]:
        return self.terms.get(term)

    def term_blocks(self, term: str) -> Tuple[int, int]:
        tid = self.terms.get(term)
        if tid is None:
            return (0, 0)
        return int(self.term_block_start[tid]), int(self.term_block_count[tid])

    def term_block_idx(self, term: str) -> np.ndarray:
        """int32 gather indices of the term's posting blocks, cached on the
        immutable field so per-query host prep (gather_query_blocks, plane
        gathers) stops rebuilding the same lists between refreshes."""
        got = self._term_idx_cache.get(term)
        if got is None:
            start, count = self.term_blocks(term)
            got = np.arange(start, start + count, dtype=np.int32)
            while len(self._term_idx_cache) >= self.TERM_IDX_CACHE_CAP:
                self._term_idx_cache.pop(next(iter(self._term_idx_cache)))
            self._term_idx_cache[term] = got
        return got

    def postings_for(self, term: str) -> Tuple[np.ndarray, np.ndarray]:
        """(doc_ids, tfs) for a term, unpadded, host-side."""
        start, count = self.term_blocks(term)
        if count == 0:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        docs = self.block_docs[start : start + count].reshape(-1)
        tfs = self.block_tfs[start : start + count].reshape(-1)
        mask = docs >= 0
        return docs[mask], tfs[mask]

    def block_max_impact(self, k1: float, b: float,
                         avgdl: float | None = None) -> np.ndarray:
        """Per-block upper bound of tf/(tf + k1*(1-b+b*dl/avgdl)) — the
        block-max WAND bound (BMW's precomputed per-block max impact;
        reference consumes it via Lucene's block-max scorers behind
        search/query/TopDocsCollectorContext.java:215). Multiplying by
        idf*boost*(k1+1) gives the max BM25 contribution any doc in the
        block can receive from its term. Exact (per-entry, using true doc
        lengths), cached per (k1, b, avgdl); ``avgdl`` lets a DFS
        coordinator substitute the corpus-wide value so the bound stays
        sound against globally-normed scores."""
        if avgdl is None:
            avgdl = float(self.sum_doc_len / max(1, (self.doc_lens > 0).sum()))
        key = (float(k1), float(b), float(avgdl))
        cached = self._impact_cache.get(key)
        if cached is not None:
            return cached
        docs = self.block_docs
        tfs = self.block_tfs
        valid = docs >= 0
        dl = self.doc_lens[np.where(valid, docs, 0)]
        norm = k1 * (1.0 - b + b * dl / max(avgdl, 1e-9))
        impact = np.where(valid, tfs / np.maximum(tfs + norm, 1e-9), 0.0)
        out = impact.max(axis=1).astype(np.float32)
        while len(self._impact_cache) >= 8:   # bound: FIFO-evict oldest
            self._impact_cache.pop(next(iter(self._impact_cache)))
        self._impact_cache[key] = out
        return out

    def positions_for(self, term: str, doc: int) -> np.ndarray:
        tid = self.terms.get(term)
        if tid is None:
            return np.empty(0, np.int32)
        start, count = int(self.term_block_start[tid]), int(self.term_block_count[tid])
        docs = self.block_docs[start : start + count].reshape(-1)
        df = int(self.doc_freq[tid])
        i = int(np.searchsorted(docs[:df], doc))
        if i >= df or docs[i] != doc:
            return np.empty(0, np.int32)
        entry = start * BLOCK + i
        return self.pos_flat[self.pos_offsets[entry] : self.pos_offsets[entry + 1]]


@dataclass
class DocValuesField:
    """Columnar doc values for one numeric/date/boolean field."""
    values: np.ndarray        # int64 or float64 [n_docs]; first value per doc
    exists: np.ndarray        # bool [n_docs]
    multi: Dict[int, List[Any]] = field(default_factory=dict)  # extra values for multi-valued docs


@dataclass
class KeywordField:
    """Keyword ordinals: term dict + per-doc ords (for term filters + terms agg)."""
    terms: Dict[str, int]
    ord_values: np.ndarray    # int32 [total]   CSR values
    ord_offsets: np.ndarray   # int32 [n_docs+1] CSR offsets
    doc_freq: np.ndarray      # int32 [n_terms]
    term_list: List[str]      # term_id -> term

    def docs_with_term(self, term: str) -> np.ndarray:
        tid = self.terms.get(term)
        if tid is None:
            return np.empty(0, np.int32)
        # scan CSR; fine host-side (filters are cached)
        mask = np.zeros(len(self.ord_offsets) - 1, bool)
        counts = np.diff(self.ord_offsets)
        owner = np.repeat(np.arange(len(counts)), counts)
        mask[owner[self.ord_values == tid]] = True
        return np.nonzero(mask)[0].astype(np.int32)


@dataclass
class VectorField:
    matrix: np.ndarray        # float32 [n_docs, dims]; zero rows where missing
    exists: np.ndarray        # bool [n_docs]
    norms: np.ndarray         # float32 [n_docs] l2 norms (0 where missing)
    similarity: str           # cosine | dot_product | l2_norm
    dims: int


@dataclass
class FeaturesField:
    """Sparse rank_features in the same block layout as postings."""
    features: Dict[str, int]  # feature -> feature_id
    block_docs: np.ndarray    # int32 [n_blocks, BLOCK]
    block_weights: np.ndarray # float32 [n_blocks, BLOCK]
    block_max_weight: np.ndarray
    feat_block_start: np.ndarray
    feat_block_count: np.ndarray
    doc_freq: np.ndarray
    # feature -> int32 gather indices of its blocks, FIFO-bounded — the
    # same immutable-layout cache as PostingsField._term_idx_cache
    _feat_idx_cache: Dict[str, np.ndarray] = field(
        default_factory=dict, repr=False, compare=False)

    FEAT_IDX_CACHE_CAP = 4096

    def feature_blocks(self, name: str) -> Tuple[int, int]:
        fid = self.features.get(name)
        if fid is None:
            return (0, 0)
        return int(self.feat_block_start[fid]), int(self.feat_block_count[fid])

    def feature_block_idx(self, name: str) -> np.ndarray:
        """int32 gather indices of the feature's blocks (cached; the block
        layout is immutable — same contract as PostingsField.term_block_idx)."""
        got = self._feat_idx_cache.get(name)
        if got is None:
            start, count = self.feature_blocks(name)
            got = np.arange(start, start + count, dtype=np.int32)
            while len(self._feat_idx_cache) >= self.FEAT_IDX_CACHE_CAP:
                self._feat_idx_cache.pop(next(iter(self._feat_idx_cache)))
            self._feat_idx_cache[name] = got
        return got


_SEGMENT_UID = itertools.count(1)


class Segment:
    """One immutable segment: all fields' columnar data + _source + id map."""

    def __init__(self, name: str, n_docs: int):
        self.name = name
        self.n_docs = n_docs
        # process-unique identity for cache freshness keys — id() would be
        # reused by the allocator after a dead segment is collected
        self.uid = next(_SEGMENT_UID)
        self.postings: Dict[str, PostingsField] = {}
        self.keywords: Dict[str, KeywordField] = {}
        self.doc_values: Dict[str, DocValuesField] = {}
        self.vectors: Dict[str, VectorField] = {}
        self.features: Dict[str, FeaturesField] = {}
        self.geo: Dict[str, np.ndarray] = {}          # float64 [n_docs, 2] (lat, lon), NaN missing
        self.sources: List[Optional[Dict[str, Any]]] = []
        self.ids: List[str] = []
        # per-doc custom routing key (None = routed by id); must survive
        # segment rebuilds so CCR/resize re-route correctly
        self.routings: List[Optional[str]] = []
        self.id_to_doc: Dict[str, int] = {}
        self.seqnos: np.ndarray = np.empty(0, np.int64)   # seqno per doc
        self.versions: np.ndarray = np.empty(0, np.int64) # _version per doc
        self.primary_terms: np.ndarray = np.empty(0, np.int64)  # term each op was indexed under
        # live docs mask — the ONLY mutable piece (Lucene liveDocs analog)
        self.live: np.ndarray = np.ones(n_docs, bool)
        self._device_cache: Dict[Any, Any] = {}
        self._filter_cache: "OrderedDict[Any, Any]" = OrderedDict()
        # cached live.sum(): consulted on every reader acquisition (the
        # request-cache freshness key) — recomputing the mask sum per
        # lookup was a measured hot-path cost. Invalidated wherever the
        # mask mutates (delete_doc; recovery reassigns call
        # invalidate_live_count explicitly).
        self._live_count: int = n_docs

    @property
    def live_count(self) -> int:
        if self._live_count is None:
            self._live_count = int(self.live.sum())
        return self._live_count

    def invalidate_live_count(self) -> None:
        self._live_count = None

    def delete_doc(self, local_doc: int) -> None:
        self.live[local_doc] = False
        self._live_count = None
        self._device_cache.pop("live", None)  # invalidate device mirror

    def doc_for_id(self, doc_id: str) -> Optional[int]:
        d = self.id_to_doc.get(doc_id)
        if d is not None and self.live[d]:
            return d
        return None

    # Device mirrors are created lazily and cached; jax is imported lazily so
    # pure host paths (translog replay, recovery) never touch the device.
    def device(self, key: str, build) -> Any:
        if key not in self._device_cache:
            self._device_cache[key] = build()
        return self._device_cache[key]

    # Filter masks are keyed by query VALUE (e.g. ("term", field, value)), so
    # high-cardinality workloads would grow without bound; the reference's
    # query cache is LRU-bounded (IndicesQueryCache.java:53). Cap + evict.
    FILTER_CACHE_CAP = 256

    def cached_filter(self, key: Any, build) -> Any:
        if key in self._filter_cache:
            self._filter_cache.move_to_end(key)
            return self._filter_cache[key]
        value = build()
        self._filter_cache[key] = value
        while len(self._filter_cache) > self.FILTER_CACHE_CAP:
            self._filter_cache.popitem(last=False)
        return value


class SegmentBuilder:
    """Accumulates parsed documents, then freezes them into a Segment.

    The reference analog is the in-memory indexing buffer feeding
    IndexWriter/DWPT inside InternalEngine.indexIntoLucene
    (index/engine/InternalEngine.java:1030); here refresh() calls build()
    to turn the buffer into arrays.
    """

    def __init__(self, name: str, mapper_service: MapperService):
        self.name = name
        self.mappers = mapper_service
        self.docs: List[ParsedDocument] = []
        self.seqnos: List[int] = []
        self.versions: List[int] = []
        self.primary_terms: List[int] = []

    def add(self, doc: ParsedDocument, seqno: int, version: int = 1,
            primary_term: int = 1) -> int:
        self.docs.append(doc)
        self.seqnos.append(seqno)
        self.versions.append(version)
        self.primary_terms.append(primary_term)
        return len(self.docs) - 1

    def __len__(self) -> int:
        return len(self.docs)

    def build(self) -> Segment:
        n = len(self.docs)
        seg = Segment(self.name, n)
        seg.sources = [d.source for d in self.docs]
        seg.ids = [d.doc_id for d in self.docs]
        seg.routings = [d.routing for d in self.docs]
        seg.seqnos = np.asarray(self.seqnos, np.int64)
        seg.versions = np.asarray(self.versions, np.int64)
        seg.primary_terms = np.asarray(self.primary_terms, np.int64)
        # last write wins within a segment (duplicate ids within one refresh
        # cycle are resolved by the engine before reaching the builder)
        seg.id_to_doc = {doc_id: i for i, doc_id in enumerate(seg.ids)}

        field_kinds: Dict[str, str] = {}
        for d in self.docs:
            for fname, pf in d.fields.items():
                mapper = self.mappers.mapper(fname)
                tname = mapper.type_name if mapper else None
                if pf.terms is not None:
                    field_kinds[fname] = "text"
                elif pf.exact_terms is not None:
                    field_kinds[fname] = "keyword"
                elif pf.numeric is not None:
                    field_kinds.setdefault(fname, "numeric_int" if tname in
                                           ("long", "integer", "short", "byte", "date", "boolean")
                                           else "numeric_float")
                elif pf.vector is not None:
                    field_kinds[fname] = "vector"
                elif pf.features is not None:
                    field_kinds[fname] = "features"
                elif pf.geo is not None:
                    field_kinds[fname] = "geo"

        for fname, kind in field_kinds.items():
            if kind == "text":
                seg.postings[fname] = self._build_postings(fname, n)
            elif kind == "keyword":
                seg.keywords[fname] = self._build_keywords(fname, n)
            elif kind.startswith("numeric"):
                seg.doc_values[fname] = self._build_doc_values(fname, n, kind == "numeric_int")
            elif kind == "vector":
                seg.vectors[fname] = self._build_vectors(fname, n)
            elif kind == "features":
                seg.features[fname] = self._build_features(fname, n)
            elif kind == "geo":
                seg.geo[fname] = self._build_geo(fname, n)
        return seg

    # -- builders per kind ------------------------------------------------

    def _build_postings(self, fname: str, n_docs: int) -> PostingsField:
        terms: Dict[str, int] = {}
        # per term: dict doc -> tf, and doc -> [positions]
        tf_map: List[Dict[int, int]] = []
        pos_map: List[Dict[int, List[int]]] = []
        doc_lens = np.zeros(n_docs, np.float32)
        for local, d in enumerate(self.docs):
            pf = d.fields.get(fname)
            if pf is None or pf.terms is None:
                continue
            doc_lens[local] = len(pf.terms)
            for tok in pf.terms:
                tid = terms.setdefault(tok.term, len(terms))
                if tid == len(tf_map):
                    tf_map.append({})
                    pos_map.append({})
                tf_map[tid][local] = tf_map[tid].get(local, 0) + 1
                pos_map[tid].setdefault(local, []).append(tok.position)
        return _pack_postings(terms, tf_map, pos_map, doc_lens)

    def _build_keywords(self, fname: str, n_docs: int) -> KeywordField:
        terms: Dict[str, int] = {}
        per_doc: List[List[int]] = [[] for _ in range(n_docs)]
        for local, d in enumerate(self.docs):
            pf = d.fields.get(fname)
            if pf is None or pf.exact_terms is None:
                continue
            for t in pf.exact_terms:
                tid = terms.setdefault(t, len(terms))
                per_doc[local].append(tid)
        return _pack_keywords(terms, per_doc)

    def _build_doc_values(self, fname: str, n_docs: int, integral: bool) -> DocValuesField:
        dtype = np.int64 if integral else np.float64
        values = np.zeros(n_docs, dtype)
        exists = np.zeros(n_docs, bool)
        multi: Dict[int, List[Any]] = {}
        for local, d in enumerate(self.docs):
            pf = d.fields.get(fname)
            if pf is None or not pf.numeric:
                continue
            exists[local] = True
            v0 = pf.numeric[0]
            values[local] = int(v0) if integral else float(v0)
            if len(pf.numeric) > 1:
                multi[local] = list(pf.numeric)
        return DocValuesField(values, exists, multi)

    def _build_vectors(self, fname: str, n_docs: int) -> VectorField:
        mapper = self.mappers.mapper(fname)
        dims = getattr(mapper, "dims", None)
        similarity = getattr(mapper, "similarity", "cosine")
        if dims is None:
            for d in self.docs:
                pf = d.fields.get(fname)
                if pf is not None and pf.vector is not None:
                    dims = len(pf.vector)
                    break
        matrix = np.zeros((n_docs, dims), np.float32)
        exists = np.zeros(n_docs, bool)
        for local, d in enumerate(self.docs):
            pf = d.fields.get(fname)
            if pf is None or pf.vector is None:
                continue
            matrix[local] = np.asarray(pf.vector, np.float32)
            exists[local] = True
        norms = np.linalg.norm(matrix, axis=1).astype(np.float32)
        return VectorField(matrix, exists, norms, similarity, dims)

    def _build_features(self, fname: str, n_docs: int) -> FeaturesField:
        feats: Dict[str, int] = {}
        weight_map: List[Dict[int, float]] = []
        for local, d in enumerate(self.docs):
            pf = d.fields.get(fname)
            if pf is None or pf.features is None:
                continue
            for fkey, w in pf.features.items():
                fid = feats.setdefault(fkey, len(feats))
                if fid == len(weight_map):
                    weight_map.append({})
                weight_map[fid][local] = w
        return _pack_features(feats, weight_map)

    def _build_geo(self, fname: str, n_docs: int) -> np.ndarray:
        arr = np.full((n_docs, 2), np.nan, np.float64)
        for local, d in enumerate(self.docs):
            pf = d.fields.get(fname)
            if pf is not None and pf.geo is not None:
                arr[local] = pf.geo
        return arr


def postings_from_token_matrix(tokens: np.ndarray,
                               term_names: Optional[List[str]] = None
                               ) -> PostingsField:
    """Vectorized bulk construction of a PostingsField from a dense token
    matrix [n_docs, doc_len] of term ids (negative = padding/no token).

    Used by benchmarks and bulk loads where per-document analysis is the
    bottleneck: equivalent to feeding each row through SegmentBuilder.add
    (index/engine/InternalEngine.java:1030's indexIntoLucene analog), but
    built with numpy sorts instead of per-token dict updates."""
    n_docs, _L = tokens.shape
    valid = tokens >= 0
    doc_lens = valid.sum(axis=1).astype(np.float32)
    t = tokens[valid].astype(np.int64)
    d = np.repeat(np.arange(n_docs, dtype=np.int64),
                  valid.sum(axis=1))
    # aggregate tf per (term, doc), ordered by term then doc — exactly the
    # posting order the block layout wants
    key = t * n_docs + d
    uniq, counts = np.unique(key, return_counts=True)
    u_term = (uniq // n_docs).astype(np.int64)
    u_doc = (uniq % n_docs).astype(np.int32)
    tfs = counts.astype(np.float32)

    # per-term posting ranges
    term_ids, term_first, term_postings = np.unique(
        u_term, return_index=True, return_counts=True)
    n_terms = int(tokens[valid].max()) + 1 if t.size else 0
    doc_freq = np.zeros(max(n_terms, 1), np.int32)
    doc_freq[term_ids] = term_postings
    nb_per_term = np.zeros(max(n_terms, 1), np.int64)
    nb_per_term[term_ids] = -(-term_postings // BLOCK)
    nb_per_term = np.maximum(nb_per_term, 1)     # every term >= 1 block
    term_block_start = np.zeros(max(n_terms, 1), np.int64)
    term_block_start[1:] = np.cumsum(nb_per_term)[:-1]
    n_blocks = int(nb_per_term.sum())

    block_docs = np.full((n_blocks, BLOCK), -1, np.int32)
    block_tfs = np.zeros((n_blocks, BLOCK), np.float32)
    block_term = np.repeat(np.arange(max(n_terms, 1)), nb_per_term)
    # flat entry index of each posting: entries of term tid start at
    # term_block_start[tid]*BLOCK and are consecutive
    entry_base = term_block_start[u_term] * BLOCK
    within = np.arange(len(u_term)) - term_first[
        np.searchsorted(term_ids, u_term)]
    flat = entry_base + within
    block_docs.reshape(-1)[flat] = u_doc
    block_tfs.reshape(-1)[flat] = tfs

    names = term_names or [f"t{i}" for i in range(max(n_terms, 1))]
    return PostingsField(
        terms={name: i for i, name in enumerate(names)},
        block_docs=block_docs,
        block_tfs=block_tfs,
        block_term=block_term.astype(np.int32),
        block_max_tf=block_tfs.max(axis=1).astype(np.float32),
        term_block_start=term_block_start.astype(np.int32),
        term_block_count=nb_per_term.astype(np.int32),
        doc_freq=doc_freq,
        doc_lens=doc_lens,
        sum_doc_len=float(doc_lens.sum()),
    )


def _pack_postings(terms: Dict[str, int], tf_map: List[Dict[int, int]],
                   pos_map: List[Dict[int, List[int]]],
                   doc_lens: np.ndarray) -> PostingsField:
    n_terms = len(terms)
    doc_freq = np.zeros(max(n_terms, 1), np.int32)
    term_block_start = np.zeros(max(n_terms, 1), np.int32)
    term_block_count = np.zeros(max(n_terms, 1), np.int32)

    blocks_docs: List[np.ndarray] = []
    blocks_tfs: List[np.ndarray] = []
    block_term: List[int] = []
    pos_counts: List[int] = []   # positions per entry, in block-entry order
    pos_flat: List[int] = []

    for tid in range(n_terms):
        entries = sorted(tf_map[tid].items())  # by doc id (ascending, like Lucene)
        doc_freq[tid] = len(entries)
        docs = np.fromiter((e[0] for e in entries), np.int32, len(entries))
        tfs = np.fromiter((e[1] for e in entries), np.float32, len(entries))
        n_blocks = max(1, math.ceil(len(entries) / BLOCK))
        term_block_start[tid] = len(blocks_docs)
        term_block_count[tid] = n_blocks
        padded = n_blocks * BLOCK
        d = np.full(padded, -1, np.int32)
        t = np.zeros(padded, np.float32)
        d[: len(docs)] = docs
        t[: len(tfs)] = tfs
        blocks_docs.extend(d.reshape(n_blocks, BLOCK))
        blocks_tfs.extend(t.reshape(n_blocks, BLOCK))
        block_term.extend([tid] * n_blocks)

        pm = pos_map[tid]
        for i in range(padded):
            if i < len(docs):
                plist = pm.get(int(docs[i]), [])
                pos_flat.extend(plist)
                pos_counts.append(len(plist))
            else:
                pos_counts.append(0)

    if blocks_docs:
        block_docs = np.stack(blocks_docs)
        block_tfs = np.stack(blocks_tfs)
    else:
        block_docs = np.full((1, BLOCK), -1, np.int32)
        block_tfs = np.zeros((1, BLOCK), np.float32)
        block_term = [0]
        pos_counts = [0] * BLOCK
    block_max_tf = block_tfs.max(axis=1)
    pos_offsets = np.zeros(len(pos_counts) + 1, np.int32)
    pos_offsets[1:] = np.cumsum(np.asarray(pos_counts, np.int64)).astype(np.int32)
    return PostingsField(
        terms=terms,
        block_docs=block_docs,
        block_tfs=block_tfs,
        block_term=np.asarray(block_term, np.int32),
        block_max_tf=block_max_tf.astype(np.float32),
        term_block_start=term_block_start,
        term_block_count=term_block_count,
        doc_freq=doc_freq,
        doc_lens=doc_lens,
        sum_doc_len=float(doc_lens.sum()),
        pos_offsets=pos_offsets,
        pos_flat=np.asarray(pos_flat, np.int32),
    )


def _pack_keywords(terms: Dict[str, int], per_doc: List[List[int]]) -> KeywordField:
    n_terms = len(terms)
    doc_freq = np.zeros(max(n_terms, 1), np.int32)
    offsets = np.zeros(len(per_doc) + 1, np.int32)
    values: List[int] = []
    for i, ords in enumerate(per_doc):
        values.extend(ords)
        offsets[i + 1] = len(values)
        for tid in set(ords):
            doc_freq[tid] += 1
    term_list = [""] * n_terms
    for t, tid in terms.items():
        term_list[tid] = t
    return KeywordField(terms, np.asarray(values, np.int32), offsets, doc_freq, term_list)


def _pack_features(feats: Dict[str, int], weight_map: List[Dict[int, float]]) -> FeaturesField:
    n_feats = len(feats)
    doc_freq = np.zeros(max(n_feats, 1), np.int32)
    feat_block_start = np.zeros(max(n_feats, 1), np.int32)
    feat_block_count = np.zeros(max(n_feats, 1), np.int32)
    blocks_docs: List[np.ndarray] = []
    blocks_w: List[np.ndarray] = []
    for fid in range(n_feats):
        entries = sorted(weight_map[fid].items())
        doc_freq[fid] = len(entries)
        docs = np.fromiter((e[0] for e in entries), np.int32, len(entries))
        ws = np.fromiter((e[1] for e in entries), np.float32, len(entries))
        n_blocks = max(1, math.ceil(len(entries) / BLOCK))
        feat_block_start[fid] = len(blocks_docs)
        feat_block_count[fid] = n_blocks
        padded = n_blocks * BLOCK
        d = np.full(padded, -1, np.int32)
        w = np.zeros(padded, np.float32)
        d[: len(docs)] = docs
        w[: len(ws)] = ws
        blocks_docs.extend(d.reshape(n_blocks, BLOCK))
        blocks_w.extend(w.reshape(n_blocks, BLOCK))
    if blocks_docs:
        block_docs = np.stack(blocks_docs)
        block_w = np.stack(blocks_w)
    else:
        block_docs = np.full((1, BLOCK), -1, np.int32)
        block_w = np.zeros((1, BLOCK), np.float32)
    return FeaturesField(
        features=feats,
        block_docs=block_docs,
        block_weights=block_w,
        block_max_weight=block_w.max(axis=1).astype(np.float32),
        feat_block_start=feat_block_start,
        feat_block_count=feat_block_count,
        doc_freq=doc_freq,
    )


def merge_segments(name: str, segments: Sequence[Segment],
                   mapper_service: MapperService) -> Segment:
    """Merge segments into one, purging deleted docs.

    Reference analog: Lucene segment merging driven by the engine's merge
    scheduler (InternalEngine). Live docs from each input get new contiguous
    ids; all columnar data is re-packed. Implemented as re-parse-free array
    surgery: we rebuild from the per-segment host arrays.
    """
    # Map old (segment, local) -> new local id for live docs only
    total = 0
    maps: List[np.ndarray] = []
    for seg in segments:
        m = np.full(seg.n_docs, -1, np.int64)
        live_idx = np.nonzero(seg.live)[0]
        m[live_idx] = np.arange(total, total + len(live_idx))
        maps.append(m)
        total += len(live_idx)

    out = Segment(name, total)
    out.live = np.ones(total, bool)

    ids: List[str] = [""] * total
    routings: List[Optional[str]] = [None] * total
    sources: List[Optional[Dict[str, Any]]] = [None] * total
    seqnos = np.zeros(total, np.int64)
    versions = np.ones(total, np.int64)
    primary_terms = np.ones(total, np.int64)
    for seg, m in zip(segments, maps):
        for old, new in enumerate(m):
            if new >= 0:
                ids[new] = seg.ids[old]
                routings[new] = (seg.routings[old]
                                 if old < len(seg.routings) else None)
                sources[new] = seg.sources[old]
                seqnos[new] = seg.seqnos[old] if len(seg.seqnos) > old else 0
                versions[new] = seg.versions[old] if len(seg.versions) > old else 1
                primary_terms[new] = seg.primary_terms[old] if len(seg.primary_terms) > old else 1
    out.ids = ids
    out.routings = routings
    out.sources = sources
    out.seqnos = seqnos
    out.versions = versions
    out.primary_terms = primary_terms
    out.id_to_doc = {doc_id: i for i, doc_id in enumerate(ids)}

    all_fields: Dict[str, str] = {}
    for seg in segments:
        for f in seg.postings:
            all_fields[f] = "text"
        for f in seg.keywords:
            all_fields[f] = "keyword"
        for f, dv in seg.doc_values.items():
            all_fields[f] = "numeric_int" if dv.values.dtype == np.int64 else "numeric_float"
        for f in seg.vectors:
            all_fields[f] = "vector"
        for f in seg.features:
            all_fields[f] = "features"
        for f in seg.geo:
            all_fields[f] = "geo"

    for fname, kind in all_fields.items():
        if kind == "text":
            out.postings[fname] = _merge_postings(fname, segments, maps, total)
        elif kind == "keyword":
            out.keywords[fname] = _merge_keywords(fname, segments, maps, total)
        elif kind.startswith("numeric"):
            out.doc_values[fname] = _merge_doc_values(fname, segments, maps, total,
                                                      kind == "numeric_int")
        elif kind == "vector":
            out.vectors[fname] = _merge_vectors(fname, segments, maps, total)
        elif kind == "features":
            out.features[fname] = _merge_features(fname, segments, maps, total)
        elif kind == "geo":
            arr = np.full((total, 2), np.nan, np.float64)
            for seg, m in zip(segments, maps):
                if fname in seg.geo:
                    live = m >= 0
                    arr[m[live]] = seg.geo[fname][live]
            out.geo[fname] = arr
    return out


def _merge_postings(fname: str, segments: Sequence[Segment],
                    maps: List[np.ndarray], total: int) -> PostingsField:
    terms: Dict[str, int] = {}
    tf_map: List[Dict[int, int]] = []
    pos_map: List[Dict[int, List[int]]] = []
    doc_lens = np.zeros(total, np.float32)
    for seg, m in zip(segments, maps):
        pf = seg.postings.get(fname)
        if pf is None:
            continue
        live = m >= 0
        doc_lens[m[live]] = pf.doc_lens[live]
        for term, tid_old in pf.terms.items():
            docs, tfs = pf.postings_for(term)
            tid = terms.setdefault(term, len(terms))
            if tid == len(tf_map):
                tf_map.append({})
                pos_map.append({})
            for doc, tf in zip(docs, tfs):
                new = int(m[doc])
                if new < 0:
                    continue
                tf_map[tid][new] = int(tf)
                pos = pf.positions_for(term, int(doc))
                if len(pos):
                    pos_map[tid][new] = pos.tolist()
    return _pack_postings(terms, tf_map, pos_map, doc_lens)


def _merge_keywords(fname: str, segments: Sequence[Segment],
                    maps: List[np.ndarray], total: int) -> KeywordField:
    terms: Dict[str, int] = {}
    per_doc: List[List[int]] = [[] for _ in range(total)]
    for seg, m in zip(segments, maps):
        kf = seg.keywords.get(fname)
        if kf is None:
            continue
        for old in range(len(kf.ord_offsets) - 1):
            new = int(m[old]) if old < len(m) else -1
            if new < 0:
                continue
            for tid_old in kf.ord_values[kf.ord_offsets[old] : kf.ord_offsets[old + 1]]:
                term = kf.term_list[int(tid_old)]
                tid = terms.setdefault(term, len(terms))
                per_doc[new].append(tid)
    return _pack_keywords(terms, per_doc)


def _merge_doc_values(fname: str, segments: Sequence[Segment], maps: List[np.ndarray],
                      total: int, integral: bool) -> DocValuesField:
    dtype = np.int64 if integral else np.float64
    values = np.zeros(total, dtype)
    exists = np.zeros(total, bool)
    multi: Dict[int, List[Any]] = {}
    for seg, m in zip(segments, maps):
        dv = seg.doc_values.get(fname)
        if dv is None:
            continue
        live = m >= 0
        values[m[live]] = dv.values[live].astype(dtype)
        exists[m[live]] = dv.exists[live]
        for old, vals in dv.multi.items():
            if m[old] >= 0:
                multi[int(m[old])] = vals
    return DocValuesField(values, exists, multi)


def _merge_vectors(fname: str, segments: Sequence[Segment],
                   maps: List[np.ndarray], total: int) -> VectorField:
    dims, similarity = None, "cosine"
    for seg in segments:
        vf = seg.vectors.get(fname)
        if vf is not None:
            dims, similarity = vf.dims, vf.similarity
            break
    matrix = np.zeros((total, dims), np.float32)
    exists = np.zeros(total, bool)
    for seg, m in zip(segments, maps):
        vf = seg.vectors.get(fname)
        if vf is None:
            continue
        live = m >= 0
        matrix[m[live]] = vf.matrix[live]
        exists[m[live]] = vf.exists[live]
    norms = np.linalg.norm(matrix, axis=1).astype(np.float32)
    return VectorField(matrix, exists, norms, similarity, dims)


def _merge_features(fname: str, segments: Sequence[Segment],
                    maps: List[np.ndarray], total: int) -> FeaturesField:
    feats: Dict[str, int] = {}
    weight_map: List[Dict[int, float]] = []
    for seg, m in zip(segments, maps):
        ff = seg.features.get(fname)
        if ff is None:
            continue
        for fkey, fid_old in ff.features.items():
            start, count = ff.feature_blocks(fkey)
            docs = ff.block_docs[start : start + count].reshape(-1)
            ws = ff.block_weights[start : start + count].reshape(-1)
            valid = docs >= 0
            fid = feats.setdefault(fkey, len(feats))
            if fid == len(weight_map):
                weight_map.append({})
            for doc, w in zip(docs[valid], ws[valid]):
                new = int(m[doc])
                if new >= 0:
                    weight_map[fid][new] = float(w)
    return _pack_features(feats, weight_map)
