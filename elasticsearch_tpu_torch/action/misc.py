"""Assorted read APIs: mget, termvectors, explain, field_caps, analyze.

Reference analogs: action/get/TransportMultiGetAction, action/termvectors/
TransportTermVectorsAction (routed to the shard holding the doc),
action/explain/TransportExplainAction (query executed against one doc),
action/fieldcaps/TransportFieldCapabilitiesAction (mapping-derived),
RestAnalyzeAction (_analyze over the index's analyzer chain).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.cluster.metadata import resolve_index_expression
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.indices.indices_service import IndicesService
from elasticsearch_tpu_torch.transport.transport import TransportService
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, IndexNotFoundError,
)
from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for

TERMVECTORS_SHARD = "indices:data/read/termvectors[s]"
EXPLAIN_SHARD = "indices:data/read/explain[s]"

DoneFn = Callable[[Optional[Dict[str, Any]], Optional[Exception]], None]

NUMERIC_CAPS = {"long", "integer", "short", "byte", "double", "float",
                "half_float", "scaled_float"}


class MiscReadActions:
    def __init__(self, node):
        self.node = node
        ts = node.transport_service
        ts.register_handler(TERMVECTORS_SHARD, self._on_termvectors)
        ts.register_handler(EXPLAIN_SHARD, self._on_explain)

    # ------------------------------------------------------------------
    # mget
    # ------------------------------------------------------------------

    def mget(self, body: Dict[str, Any], default_index: Optional[str],
             on_done: DoneFn) -> None:
        docs_spec = (body or {}).get("docs")
        if docs_spec is None and (body or {}).get("ids") is not None:
            docs_spec = [{"_id": i} for i in body["ids"]]
        if not docs_spec:
            on_done({"docs": []}, None)
            return
        out: List[Optional[Dict[str, Any]]] = [None] * len(docs_spec)
        pending = {"n": len(docs_spec)}

        def one(pos: int, spec: Dict[str, Any]) -> None:
            index = spec.get("_index", default_index)
            doc_id = spec.get("_id")

            def cb(resp, err=None):
                if err is not None:
                    out[pos] = {"_index": index, "_id": doc_id,
                                "error": {"type": type(err).__name__,
                                          "reason": str(err)}}
                else:
                    out[pos] = resp
                pending["n"] -= 1
                if pending["n"] == 0:
                    on_done({"docs": out}, None)
            if index is None or doc_id is None:
                cb(None, IllegalArgumentError(
                    "mget doc requires _index and _id"))
                return
            self.node.get_action.execute(index, doc_id, cb,
                                         routing=spec.get("routing"))
        for pos, spec in enumerate(docs_spec):
            one(pos, spec)

    # ------------------------------------------------------------------
    # termvectors (routed shard action)
    # ------------------------------------------------------------------

    def termvectors(self, index: str, doc_id: str, on_done: DoneFn,
                    fields: Optional[List[str]] = None,
                    routing: Optional[str] = None) -> None:
        self._routed_shard_call(
            TERMVECTORS_SHARD, index, doc_id, routing,
            {"fields": fields}, on_done)

    def _on_termvectors(self, req: Dict[str, Any], sender: str
                        ) -> Dict[str, Any]:
        shard = self.node.indices_service.shard(req["index"], req["shard"])
        engine = shard.engine
        engine.refresh()
        reader = engine.acquire_reader()
        located = reader.get(req["id"])
        if located is None:
            return {"_index": req["index"], "_id": req["id"],
                    "found": False}
        seg, local = located
        wanted = req.get("fields")
        tv: Dict[str, Any] = {}
        # generate from _source (the reference's from-source path):
        # re-analyzing one doc is O(doc length), vs O(vocabulary) for a
        # term-dictionary scan per field
        source = seg.sources[local] if local < len(seg.sources) else None
        for fname, pf in seg.postings.items():
            if wanted and fname not in wanted:
                continue
            value = _source_value(source, fname)
            if value is None:
                continue
            mapper = engine.mappers.mapper(fname)
            analyzer = getattr(mapper, "analyzer", None)
            if analyzer is None:
                from elasticsearch_tpu_torch.analysis import STANDARD
                analyzer = STANDARD
            terms: Dict[str, Any] = {}
            values = value if isinstance(value, list) else [value]
            for v in values:
                for tok in analyzer.analyze(str(v)):
                    entry = terms.setdefault(tok.term, {
                        "term_freq": 0, "tokens": []})
                    entry["term_freq"] += 1
                    entry["tokens"].append(
                        {"position": tok.position,
                         "start_offset": tok.start_offset,
                         "end_offset": tok.end_offset})
            for term, entry in terms.items():
                # shard-level df: sum over every live segment, not just
                # the one holding this doc
                df = 0
                for s in reader.segments:
                    spf = s.postings.get(fname)
                    if spf is not None:
                        tid = spf.terms.get(term)
                        if tid is not None:
                            df += int(spf.doc_freq[tid])
                entry["doc_freq"] = df
            if terms:
                tv[fname] = {"terms": terms}
        return {"_index": req["index"], "_id": req["id"], "found": True,
                "term_vectors": tv}

    # ------------------------------------------------------------------
    # explain (routed shard action)
    # ------------------------------------------------------------------

    def explain(self, index: str, doc_id: str, body: Dict[str, Any],
                on_done: DoneFn, routing: Optional[str] = None) -> None:
        self._routed_shard_call(EXPLAIN_SHARD, index, doc_id, routing,
                                {"body": body or {}}, on_done)

    def _on_explain(self, req: Dict[str, Any], sender: str
                    ) -> Dict[str, Any]:
        from elasticsearch_tpu_torch.search import dsl
        from elasticsearch_tpu_torch.search.execute import (
            SegmentContext, execute, rewrite_knn,
        )
        shard = self.node.indices_service.shard(req["index"], req["shard"])
        engine = shard.engine
        engine.refresh()
        reader = engine.acquire_reader()
        located = reader.get(req["id"])
        base = {"_index": req["index"], "_id": req["id"]}
        if located is None:
            return {**base, "matched": False,
                    "explanation": {"value": 0.0,
                                    "description": "no such document",
                                    "details": []}}
        seg, local = located
        query = dsl.parse_query(req.get("body", {}).get("query"))
        ctxs = []
        seg_idx = None
        for si, s in enumerate(reader.segments):
            # reader= so join queries (has_child/has_parent) see sibling
            # segments, exactly as in the served query phase
            ctxs.append(SegmentContext(s, engine.mappers, segment_idx=si,
                                       reader=reader,
                                       device=shard.search.device))
            if s is seg:
                seg_idx = si
        query = rewrite_knn(query, ctxs)
        scores, mask = execute(query, ctxs[seg_idx])
        matched = bool(mask[local])
        score = float(scores[local]) if matched else 0.0
        return {**base, "matched": matched,
                "explanation": {
                    "value": score,
                    "description": (
                        f"score for [{req['id']}] via device scoring "
                        f"(BM25/kNN kernel; per-clause breakdown not "
                        f"instrumented)"),
                    "details": []}}

    # ------------------------------------------------------------------
    # field_caps (coordinator, mapping-derived)
    # ------------------------------------------------------------------

    def field_caps(self, index_expression: str,
                   fields: Optional[str] = None) -> Dict[str, Any]:
        state = self.node._applied_state()
        names = resolve_index_expression(index_expression, state.metadata)
        import fnmatch
        patterns = [f.strip() for f in (fields or "*").split(",")]
        caps: Dict[str, Dict[str, Any]] = {}
        for name in names:
            meta = state.metadata.index(name)
            props = (meta.mappings or {}).get("properties", {})
            for fname, spec in _walk_fields(props):
                if not any(fnmatch.fnmatch(fname, p) for p in patterns):
                    continue
                ftype = spec.get("type", "object")
                entry = caps.setdefault(fname, {}).setdefault(ftype, {
                    "type": ftype,
                    "metadata_field": False,
                    "searchable": ftype != "object",
                    "aggregatable": ftype in NUMERIC_CAPS or ftype in (
                        "keyword", "date", "boolean", "ip"),
                    "indices": []})
                entry["indices"].append(name)
        for fname, types in caps.items():
            for entry in types.values():
                if len(entry["indices"]) == len(names):
                    del entry["indices"]   # uniform across indices
        return {"indices": names, "fields": caps}

    # ------------------------------------------------------------------
    # analyze
    # ------------------------------------------------------------------

    def analyze(self, body: Dict[str, Any],
                index: Optional[str] = None) -> Dict[str, Any]:
        body = body or {}
        text = body.get("text")
        if text is None:
            raise IllegalArgumentError("_analyze requires [text]")
        texts = text if isinstance(text, list) else [text]

        from elasticsearch_tpu_torch.analysis import AnalysisRegistry
        # the INDEX's analysis settings back both field-derived and
        # explicitly named analyzers (custom analyzers registered at
        # creation); cluster-state derived, NOT from a locally hosted
        # shard — every node must answer the same way
        if index is not None:
            state = self.node._applied_state()
            meta = state.metadata.index(index)
            registry = AnalysisRegistry(
                (meta.settings or {}).get("analysis"))
        else:
            meta = None
            registry = AnalysisRegistry()
        analyzer = None
        if meta is not None and body.get("field"):
            spec = dict(
                _walk_fields((meta.mappings or {}).get("properties", {}))
            ).get(body["field"])
            name = (spec or {}).get("analyzer", "standard")
            analyzer = registry.get(name)
        if analyzer is None:
            analyzer = registry.get(body.get("analyzer", "standard"))
        tokens = []
        for t in texts:
            for tok in analyzer.analyze(t):
                tokens.append({
                    "token": tok.term,
                    "start_offset": tok.start_offset,
                    "end_offset": tok.end_offset,
                    "position": tok.position,
                    "type": "<ALPHANUM>",
                })
        return {"tokens": tokens}

    # ------------------------------------------------------------------

    def _routed_shard_call(self, action: str, index: str, doc_id: str,
                           routing: Optional[str],
                           extra: Dict[str, Any], on_done: DoneFn
                           ) -> None:
        from elasticsearch_tpu_torch.action.document import routed_shard_request
        state = self.node._applied_state()
        # closed indices reject ALL point reads (termvectors/explain
        # included — the search/get paths enforce the same)
        try:
            if state.metadata.index(index).state == "close":
                from elasticsearch_tpu_torch.utils.errors import (
                    IllegalArgumentError,
                )
                err = IllegalArgumentError(
                    f"closed index [{index}] cannot serve reads "
                    f"(index_closed_exception)")
                on_done(None, err)
                return
        except Exception:  # noqa: BLE001 — missing index 404s below
            pass
        self._rr = getattr(self, "_rr", 0) + 1
        routed_shard_request(
            self.node.transport_service, state,
            action, index, doc_id, on_done, routing=routing, extra=extra,
            rotate=self._rr)


def _walk_fields(props: Dict[str, Any], prefix: str = ""):
    for fname, spec in (props or {}).items():
        if not isinstance(spec, dict):
            continue
        full = f"{prefix}{fname}"
        if "properties" in spec and spec.get("type") in (None, "object",
                                                         "nested"):
            yield from _walk_fields(spec["properties"], f"{full}.")
        else:
            yield full, spec
            for sub, sub_spec in (spec.get("fields") or {}).items():
                yield f"{full}.{sub}", sub_spec


def _source_value(source: Optional[Dict[str, Any]], path: str):
    if source is None:
        return None
    cur: Any = source
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur
