"""Fetch phase: turn shard doc references into full hits.

Reference analog: FetchPhase + its sub-phases (search/fetch/FetchPhase.java,
search/fetch/subphase/): _source loading and filtering, docvalue_fields,
highlighting, version/seqno. Host-side by design — fetch is I/O-bound
(SURVEY.md §7 design stance).
"""

from __future__ import annotations

import fnmatch
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from elasticsearch_tpu_torch.index.engine import Reader
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.phase import ShardDoc


def filter_source(source: Dict[str, Any], includes: Sequence[str],
                  excludes: Sequence[str]) -> Dict[str, Any]:
    """_source filtering with dot paths and wildcards (subphase/FetchSourcePhase)."""
    if not includes and not excludes:
        return source

    def flatten(obj, prefix=""):
        out = {}
        for k, v in obj.items():
            p = f"{prefix}{k}"
            if isinstance(v, dict):
                out.update(flatten(v, p + "."))
            else:
                out[p] = v
        return out

    flat = flatten(source)

    def matches(path, patterns):
        return any(fnmatch.fnmatch(path, pat) or path.startswith(pat + ".")
                   for pat in patterns)

    kept = {}
    for path, v in flat.items():
        if includes and not matches(path, includes):
            continue
        if excludes and matches(path, excludes):
            continue
        kept[path] = v

    # unflatten
    out: Dict[str, Any] = {}
    for path, v in kept.items():
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _field_from_source(source: Dict[str, Any], field: str):
    node: Any = source
    for part in field.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


class Highlighter:
    """Plain highlighter: re-analyze the stored text, wrap matched terms.

    Reference analog: the unified/plain highlighters
    (search/fetch/subphase/highlight/)."""

    def __init__(self, mappers: MapperService,
                 pre_tag: str = "<em>", post_tag: str = "</em>",
                 fragment_size: int = 100, number_of_fragments: int = 5):
        self.mappers = mappers
        self.pre = pre_tag
        self.post = post_tag
        self.fragment_size = fragment_size
        self.n_fragments = number_of_fragments

    def query_terms_for_field(self, q: dsl.Query, field: str
                              ) -> "tuple[set, set]":
        """(exact terms, prefixes): a doc token highlights when it equals
        an exact term OR starts with a prefix (match_phrase_prefix)."""
        terms = set()
        prefixes = set()

        def walk(node):
            if isinstance(node, dsl.Match) and node.field == field:
                terms.update(self._analyze(field, node.text))
            elif isinstance(node, dsl.MatchPhrase) and node.field == field:
                terms.update(self._analyze(field, node.text))
            elif isinstance(node, dsl.MatchPhrasePrefix) and \
                    node.field == field:
                toks = list(self._analyze(field, node.text))
                if toks:
                    # the last token is a PREFIX: expose it via the
                    # prefix marker so doc tokens it expands to highlight
                    terms.update(toks[:-1])
                    prefixes.add(toks[-1])
            elif isinstance(node, dsl.MoreLikeThis) and \
                    (not node.fields or field in node.fields):
                for text in node.like:
                    terms.update(self._analyze(field, text))
            elif isinstance(node, dsl.MultiMatch):
                for f in node.fields:
                    if f.partition("^")[0] == field:
                        terms.update(self._analyze(field, node.text))
            elif isinstance(node, dsl.Term) and node.field == field:
                terms.add(str(node.value).lower())
            elif isinstance(node, dsl.Bool):
                for c in node.must + node.should + node.filter:
                    walk(c)
            elif isinstance(node, dsl.DisMax):
                for c in node.queries:
                    walk(c)
            elif isinstance(node, (dsl.ConstantScore,)):
                walk(node.filter)
            elif isinstance(node, (dsl.ScriptScore, dsl.FunctionScore)):
                if node.query is not None:
                    walk(node.query)

        walk(q)
        return terms, prefixes

    def _analyze(self, field: str, text: str):
        mapper = self.mappers.mapper(field)
        analyzer = getattr(mapper, "search_analyzer", None)
        if analyzer is None:
            from elasticsearch_tpu_torch.analysis import STANDARD
            analyzer = STANDARD
        return analyzer.terms(text)

    def highlight_field(self, q: dsl.Query, field: str, text: str) -> List[str]:
        terms, prefixes = self.query_terms_for_field(q, field)
        if not terms and not prefixes:
            return []
        mapper = self.mappers.mapper(field)
        analyzer = getattr(mapper, "analyzer", None)
        if analyzer is None:
            from elasticsearch_tpu_torch.analysis import STANDARD
            analyzer = STANDARD
        tokens = analyzer.analyze(text)
        matches = [(t.start_offset, t.end_offset) for t in tokens
                   if t.term in terms or
                   any(t.term.startswith(p) for p in prefixes)]
        if not matches:
            return []
        fragments: List[str] = []
        used_until = -1
        for start, end in matches:
            if len(fragments) >= self.n_fragments:
                break
            if start <= used_until:
                continue
            frag_start = max(0, start - self.fragment_size // 2)
            frag_end = min(len(text), frag_start + self.fragment_size)
            used_until = frag_end
            frag_matches = [(s, e) for s, e in matches if frag_start <= s and e <= frag_end]
            out = []
            cursor = frag_start
            for s, e in frag_matches:
                out.append(text[cursor:s])
                out.append(self.pre + text[s:e] + self.post)
                cursor = e
            out.append(text[cursor:frag_end])
            fragments.append("".join(out))
        return fragments


def fetch_hits(reader: Reader,
               mappers: MapperService,
               docs: List[ShardDoc],
               index_name: str,
               query: Optional[dsl.Query] = None,
               source_filter: Any = True,
               docvalue_fields: Optional[List[str]] = None,
               highlight: Optional[Dict[str, Any]] = None,
               include_sort: bool = False,
               seq_no_primary_term: bool = False,
               include_version: bool = False) -> List[Dict[str, Any]]:
    """Build response hit objects for the winning docs."""
    includes: List[str] = []
    excludes: List[str] = []
    source_enabled = True
    if source_filter is False:
        source_enabled = False
    elif isinstance(source_filter, str):
        includes = [source_filter]
    elif isinstance(source_filter, list):
        includes = list(source_filter)
    elif isinstance(source_filter, dict):
        includes = list(source_filter.get("includes", []))
        excludes = list(source_filter.get("excludes", []))

    highlighter = None
    hl_fields: Dict[str, Any] = {}
    if highlight:
        hl_fields = highlight.get("fields", {})
        highlighter = Highlighter(
            mappers,
            pre_tag=(highlight.get("pre_tags") or ["<em>"])[0],
            post_tag=(highlight.get("post_tags") or ["</em>"])[0],
            fragment_size=int(highlight.get("fragment_size", 100)),
            number_of_fragments=int(highlight.get("number_of_fragments", 5)))

    # inner-hit specs are constant per query: collect once, not per hit
    inner_specs = _collect_inner_hit_specs(query) if query is not None else []

    hits = []
    for sd in docs:
        seg = reader.segments[sd.segment_idx]
        src = seg.sources[sd.doc] or {}
        hit: Dict[str, Any] = {
            "_index": index_name,
            "_id": seg.ids[sd.doc],
            "_score": None if sd.score == -np.inf else sd.score,
        }
        if source_enabled:
            hit["_source"] = filter_source(src, includes, excludes)
        if include_version and len(seg.versions) > sd.doc:
            hit["_version"] = int(seg.versions[sd.doc])
        if seq_no_primary_term and len(seg.seqnos) > sd.doc:
            hit["_seq_no"] = int(seg.seqnos[sd.doc])
            hit["_primary_term"] = int(seg.primary_terms[sd.doc])
        if docvalue_fields:
            fields: Dict[str, List[Any]] = {}
            for f in docvalue_fields:
                req_name = f if isinstance(f, str) else f.get("field")
                # columns live under the alias target; the response keys
                # by the REQUESTED name like the reference
                fname = mappers.resolve_field(req_name)
                dv = seg.doc_values.get(fname)
                if dv is not None and dv.exists[sd.doc]:
                    vals = dv.multi.get(sd.doc, [dv.values[sd.doc]])
                    fields[req_name] = [_jsonify(v) for v in vals]
                elif fname in seg.keywords:
                    kf = seg.keywords[fname]
                    ords = kf.ord_values[kf.ord_offsets[sd.doc]: kf.ord_offsets[sd.doc + 1]]
                    if len(ords):
                        fields[req_name] = [kf.term_list[int(o)]
                                            for o in ords]
            if fields:
                hit["fields"] = fields
        if highlighter is not None and query is not None:
            hl_out = {}
            for fname in hl_fields:
                text = _field_from_source(src, fname)
                if text is None:
                    continue
                frags = highlighter.highlight_field(query, fname, str(text))
                if frags:
                    hl_out[fname] = frags
            if hl_out:
                hit["highlight"] = hl_out
        if include_sort and sd.sort_values:
            hit["sort"] = [_jsonify(v) for v in sd.sort_values]
        if inner_specs:
            inner = _inner_hits(src, inner_specs, index_name,
                                seg.ids[sd.doc])
            if inner:
                hit["inner_hits"] = inner
        hits.append(hit)
    return hits


def _collect_inner_hit_specs(q: Optional[dsl.Query]) -> list:
    """Every Nested node in the tree carrying an inner_hits spec."""
    out: list = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dsl.Nested):
            if node.inner_hits is not None:
                out.append(node)
            walk(node.query)
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
        elif isinstance(node, (dsl.ScriptScore, dsl.FunctionScore)):
            if node.query is not None:
                walk(node.query)
    walk(q)
    return out


def _inner_hits(src: Dict[str, Any], specs: list,
                index_name: str, doc_id: str) -> Dict[str, Any]:
    """Matching nested objects per hit (InnerHitsPhase.java analog). The
    nested query family is not part of this package yet."""
    from elasticsearch_tpu_torch.utils.errors import NotPortedError
    raise NotPortedError("inner_hits")


def _jsonify(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return None if (f != f or f in (float("inf"), float("-inf"))) else f
    return v
