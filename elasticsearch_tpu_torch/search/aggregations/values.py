"""Value sources for aggregations: segment columns → (owners, values).

Reference analog: search/aggregations/support/ValuesSource — the
field/script/missing abstraction every agg collects through. Values are
exposed as *occurrence* arrays: ``owners[i]`` is the local doc holding
``values[i]`` (multi-valued docs contribute one occurrence per value, like
SortedNumericDocValues iteration). Built once per (segment, field) and
cached on the segment, so repeated aggs reuse the flattening.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError


def numeric_occurrences(ctx, field_name: str
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(owners int32, values float64) for a numeric/date field."""
    field_name = ctx.mappers.resolve_field(field_name)
    seg = ctx.segment

    def build():
        dv = seg.doc_values.get(field_name)
        if dv is None:
            return (np.empty(0, np.int32), np.empty(0, np.float64))
        if not dv.multi:
            docs = np.nonzero(dv.exists)[0].astype(np.int32)
            return (docs, dv.values[docs].astype(np.float64))
        owners = []
        values = []
        for doc in np.nonzero(dv.exists)[0]:
            extra = dv.multi.get(int(doc))
            vals = extra if extra is not None else [dv.values[doc]]
            owners.extend([int(doc)] * len(vals))
            values.extend(float(v) for v in vals)
        return (np.asarray(owners, np.int32),
                np.asarray(values, np.float64))
    return seg.cached_filter(("agg_num_occ", field_name), build)


def keyword_occurrences(ctx, field_name: str
                        ) -> Tuple[np.ndarray, np.ndarray, list]:
    """(owners int32, ords int32, term_list) for a keyword field."""
    field_name = ctx.mappers.resolve_field(field_name)
    seg = ctx.segment

    def build():
        kf = seg.keywords.get(field_name)
        if kf is None:
            return (np.empty(0, np.int32), np.empty(0, np.int32), [])
        counts = np.diff(kf.ord_offsets)
        owners = np.repeat(
            np.arange(len(counts), dtype=np.int32), counts)
        return (owners, kf.ord_values.astype(np.int32), kf.term_list)
    return seg.cached_filter(("agg_kw_occ", field_name), build)


def field_kind(ctx, field_name: str) -> Optional[str]:
    """'numeric' | 'keyword' | None, judged by what this segment stores."""
    field_name = ctx.mappers.resolve_field(field_name)
    seg = ctx.segment
    if field_name in seg.doc_values:
        return "numeric"
    if field_name in getattr(seg, "keywords", {}):
        return "keyword"
    # segment may simply lack the field; fall back to the mapping
    mapper = ctx.mappers.mapper(field_name)
    if mapper is None:
        return None
    tname = getattr(mapper, "type_name", "")
    if tname in ("keyword", "boolean", "ip"):
        return "keyword"
    if tname in ("text",):
        return None
    return "numeric"


def resolve_numeric(ctx, params: Dict[str, Any], agg_name: str
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(owners, values) for a metric agg over ``field``/``script``/
    ``missing`` params."""
    script = params.get("script")
    if script is not None:
        return _script_values(ctx, script)
    fname = params.get("field")
    if fname is None:
        raise IllegalArgumentError(
            f"aggregation [{agg_name}] requires a [field] or [script]")
    owners, values = numeric_occurrences(ctx, fname)
    missing = params.get("missing")
    if missing is not None:
        have = np.zeros(ctx.segment.n_docs, bool)
        have[owners] = True
        absent = np.nonzero(~have)[0].astype(np.int32)
        owners = np.concatenate([owners, absent])
        values = np.concatenate(
            [values, np.full(len(absent), float(missing))])
    return owners, values


def _script_values(ctx, script: Any) -> Tuple[np.ndarray, np.ndarray]:
    """Host per-doc script loop (AggregationScript context). Slow path by
    design — scripted aggs trade speed for flexibility in the reference
    too (script/AggregationScript.java)."""
    from elasticsearch_tpu_torch.script.engine import execute_field_script
    seg = ctx.segment
    owners = []
    values = []
    for doc in range(seg.n_docs):
        source = seg.sources[doc] if doc < len(seg.sources) else None
        if source is None:
            continue
        doc_vals = _doc_values_view(seg, doc)
        try:
            v = execute_field_script(script, doc_vals, source)
        except Exception:
            continue
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            for x in v:
                owners.append(doc)
                values.append(float(x))
        else:
            owners.append(doc)
            values.append(float(v))
    return (np.asarray(owners, np.int32), np.asarray(values, np.float64))


def _doc_values_view(seg, doc: int) -> Dict[str, Any]:
    """The ``doc['field']`` view scripts read (first value per field)."""
    out: Dict[str, Any] = {}
    for fname, dv in seg.doc_values.items():
        if dv.exists[doc]:
            out[fname] = dv.values[doc]
    for fname, kf in getattr(seg, "keywords", {}).items():
        lo, hi = kf.ord_offsets[doc], kf.ord_offsets[doc + 1]
        if hi > lo:
            out[fname] = kf.term_list[kf.ord_values[lo]]
    return out
