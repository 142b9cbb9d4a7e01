"""Nested query semantics + inner_hits, evaluated over _source objects.

Reference: index/search/NestedHelper.java + the nested query
(index/query/NestedQueryBuilder.java) and inner hits
(search/fetch/subphase/InnerHitsPhase.java). Lucene materializes nested
objects as hidden sub-documents in the same segment; this build keeps
nested objects inside _source (the device-side columns flatten them, which
is exactly the cross-object false-match nested exists to prevent) and
restores PER-OBJECT match semantics host-side: an object matches only if
ALL constraints hold within that one object.

The query-phase mask is a full per-segment scan on first use, cached on
the immutable segment per (path, query) thereafter (execute._h_nested);
inner-hits evaluation touches only the fetched candidates' sources.

Documented divergence: matching nested docs contribute a constant 1.0
(times boost) rather than a per-child BM25 score, so score_mode
avg/sum/max coincide. The reference scores children through the same
similarity as top-level docs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.utils.errors import QueryParsingError

__all__ = ["nested_objects", "match_object", "matching_offsets"]


def nested_objects(source: Dict[str, Any], path: str) -> List[Dict[str, Any]]:
    """The object array at a (possibly dotted) nested path; [] if absent."""
    node: Any = source
    for part in path.split("."):
        if isinstance(node, list):
            # arrays of intermediate objects flatten their children
            out = []
            for item in node:
                if isinstance(item, dict) and part in item:
                    v = item[part]
                    out.extend(v if isinstance(v, list) else [v])
            node = out
            continue
        if not isinstance(node, dict) or part not in node:
            return []
        node = node[part]
    if isinstance(node, dict):
        return [node]
    if isinstance(node, list):
        return [x for x in node if isinstance(x, dict)]
    return []


def _rel_field(field: str, path: str) -> str:
    return field[len(path) + 1:] if field.startswith(path + ".") else field


def _value_of(obj: Dict[str, Any], field: str):
    node: Any = obj
    for part in field.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    return node


def _values(obj: Dict[str, Any], field: str) -> List[Any]:
    v = _value_of(obj, field)
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _tokens(text: Any) -> List[str]:
    import re
    return re.findall(r"[a-z0-9]+", str(text).lower())


def match_object(obj: Dict[str, Any], q: dsl.Query, path: str) -> bool:
    """Does ONE nested object satisfy the query? Field names in the query
    are absolute (``path.field``); they resolve within the object."""
    if isinstance(q, dsl.MatchAll):
        return True
    if isinstance(q, dsl.MatchNone):
        return False
    if isinstance(q, dsl.Term):
        return any(v == q.value or str(v) == str(q.value)
                   for v in _values(obj, _rel_field(q.field, path)))
    if isinstance(q, dsl.Terms):
        wanted = {str(v) for v in q.values}
        return any(str(v) in wanted
                   for v in _values(obj, _rel_field(q.field, path)))
    if isinstance(q, dsl.Match):
        want = set(_tokens(q.text))
        have: set = set()
        for v in _values(obj, _rel_field(q.field, path)):
            have.update(_tokens(v))
        if q.operator == "and":
            return bool(want) and want <= have
        return bool(want & have)
    if isinstance(q, dsl.Exists):
        return bool(_values(obj, _rel_field(q.field, path)))
    if isinstance(q, dsl.Range):
        vals = _values(obj, _rel_field(q.field, path))
        for v in vals:
            try:
                x = float(v)
            except (TypeError, ValueError):
                continue
            ok = True
            if q.gte is not None and not x >= float(q.gte):
                ok = False
            if q.gt is not None and not x > float(q.gt):
                ok = False
            if q.lte is not None and not x <= float(q.lte):
                ok = False
            if q.lt is not None and not x < float(q.lt):
                ok = False
            if ok:
                return True
        return False
    if isinstance(q, dsl.Bool):
        for c in q.must + q.filter:
            if not match_object(obj, c, path):
                return False
        for c in q.must_not:
            if match_object(obj, c, path):
                return False
        if q.should:
            n = sum(1 for c in q.should if match_object(obj, c, path))
            need = dsl.resolve_minimum_should_match(
                q.minimum_should_match,
                len(q.should)) if q.minimum_should_match is not None else (
                    0 if (q.must or q.filter) else 1)
            if n < need:
                return False
        return True
    if isinstance(q, dsl.ConstantScore):
        return match_object(obj, q.filter, path)
    raise QueryParsingError(
        f"query [{type(q).__name__}] is not supported inside nested "
        f"context [{path}]")


def matching_offsets(source: Dict[str, Any], q: dsl.Query,
                     path: str) -> List[int]:
    """Offsets of the nested objects (in array order) matching the query —
    the identity inner hits report (_nested.offset)."""
    return [i for i, obj in enumerate(nested_objects(source, path))
            if match_object(obj, q, path)]
