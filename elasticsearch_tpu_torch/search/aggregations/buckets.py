"""Bucket aggregations: doc partitioning + sub-aggregation recursion.

Reference analog: search/aggregations/bucket/ — terms, histogram,
date_histogram, range, filter(s), global, missing. Buckets are computed as
segment-level masks from columnar values (not per-doc collector callbacks);
sub-aggs recurse with the intersected mask. Partials keep EVERY bucket (no
shard-side trimming), so the coordinator reduce is exact and
doc_count_error_upper_bound is always 0 — a deliberate divergence from the
reference's shard_size approximation, affordable because partials are
columnar and cheap to ship.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.search.aggregations.spec import AggSpec
from elasticsearch_tpu_torch.search.aggregations.values import (
    field_kind, keyword_occurrences, numeric_occurrences,
)
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError


def _collect_subs(spec: AggSpec, ctx, mask: np.ndarray, scores
                  ) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.search.aggregations.engine import collect_one
    return {sub.name: collect_one(sub, ctx, mask, scores)
            for sub in spec.subs if not sub.is_pipeline}


def _merge_subs(spec: AggSpec, a: Dict[str, Any], b: Dict[str, Any]
                ) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.search.aggregations.engine import merge_one
    out = dict(a)
    for sub in spec.subs:
        if sub.is_pipeline:
            continue
        if sub.name in a and sub.name in b:
            out[sub.name] = merge_one(sub, a[sub.name], b[sub.name])
        elif sub.name in b:
            out[sub.name] = b[sub.name]
    return out


def _finalize_subs(spec: AggSpec, subs: Dict[str, Any]) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.search.aggregations.engine import (
        collect_one, empty_partial, finalize_one,
    )
    out: Dict[str, Any] = {}
    for sub in spec.subs:
        if sub.is_pipeline:
            continue
        partial = subs.get(sub.name)
        if partial is None:
            partial = empty_partial(sub)
        out[sub.name] = finalize_one(sub, partial)
    return out


def _doc_count(mask: np.ndarray) -> int:
    return int(mask.sum())


def _dedup_doc_ord(owners: np.ndarray, ords: np.ndarray, n_terms: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Unique (doc, ord) pairs — a doc counts once per term even when the
    stored array repeats a value. Shared by every ordinal counter."""
    pair = owners.astype(np.int64) * max(n_terms, 1) + ords
    _, first = np.unique(pair, return_index=True)
    return owners[first], ords[first]


# ---------------------------------------------------------------------------
# single-bucket aggs: filter / global / missing
# ---------------------------------------------------------------------------

def collect_filter(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    fmask = _filter_mask(ctx, spec.params)
    m = mask & fmask
    return {"doc_count": _doc_count(m),
            "subs": _collect_subs(spec, ctx, m, scores)}


def _filter_mask(ctx, query_body: Any) -> np.ndarray:
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.execute import execute
    q = dsl.parse_query(query_body)
    _, qmask = execute(q, ctx)
    return qmask[: ctx.segment.n_docs].cpu().numpy()


def collect_global(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    # ignores the query entirely: every live doc in the snapshot
    m = ctx.live[: ctx.segment.n_docs].cpu().numpy().astype(bool)
    return {"doc_count": _doc_count(m),
            "subs": _collect_subs(spec, ctx, m, scores)}


def collect_missing(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    fname = spec.params.get("field")
    if fname is None:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] requires a [field]")
    n = ctx.segment.n_docs
    have = np.zeros(n, bool)
    kind = field_kind(ctx, fname)
    if kind == "keyword":
        owners, _, _ = keyword_occurrences(ctx, fname)
        have[owners] = True
    elif kind == "numeric":
        owners, _ = numeric_occurrences(ctx, fname)
        have[owners] = True
    m = mask & ~have
    return {"doc_count": _doc_count(m),
            "subs": _collect_subs(spec, ctx, m, scores)}


def merge_single(spec: AggSpec, a, b) -> Dict[str, Any]:
    return {"doc_count": a["doc_count"] + b["doc_count"],
            "subs": _merge_subs(spec, a["subs"], b["subs"])}


def finalize_single(spec: AggSpec, p) -> Dict[str, Any]:
    out = {"doc_count": p["doc_count"]}
    out.update(_finalize_subs(spec, p["subs"]))
    return out


# ---------------------------------------------------------------------------
# filters (named or anonymous)
# ---------------------------------------------------------------------------

def collect_filters(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    filters = spec.params.get("filters")
    if filters is None:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] requires [filters]")
    if isinstance(filters, list):
        entries = [(str(i), f) for i, f in enumerate(filters)]
        keyed = False
    else:
        entries = list(filters.items())
        keyed = True
    buckets = {}
    for key, fbody in entries:
        m = mask & _filter_mask(ctx, fbody)
        buckets[key] = {"key": key, "doc_count": _doc_count(m),
                        "subs": _collect_subs(spec, ctx, m, scores)}
    return {"buckets": buckets, "keyed": keyed,
            "order": [k for k, _ in entries]}


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------

def _device_terms(spec: AggSpec, ctx, mask) -> Optional[Dict[str, Any]]:
    """One-dispatch device collection for sub-less keyword terms: the
    deduped (doc, ord) occurrence table lives on device, the query's
    device mask gates owners inside ordinal_counts (K20), which counts —
    only the [n_terms] count vector crosses back to the host."""
    fname = spec.params.get("field")
    if fname is None or spec.subs or \
            spec.params.get("missing") is not None or \
            spec.params.get("script") is not None:
        return None
    seg = ctx.segment
    if fname not in getattr(seg, "keywords", {}):
        return None
    dev_mask = getattr(ctx, "_agg_device_mask", None)
    if dev_mask is None or \
            getattr(ctx, "_agg_top_host_mask", None) is not mask:
        # a sub-aggregation context hands us its bucket-intersected host
        # mask; the device copy is the TOP-LEVEL query mask — decline
        return None
    import torch
    from elasticsearch_tpu_torch.index.segment import next_pow2
    from elasticsearch_tpu_torch.ops.aggs import ordinal_counts
    owners, ords, term_list = keyword_occurrences(ctx, fname)
    if not len(term_list):
        return {"buckets": {}}

    def build():
        o, r = _dedup_doc_ord(owners, ords, len(term_list))
        e_pad = next_pow2(max(len(o), 1), minimum=8)
        ow = np.zeros(e_pad, np.int32)
        od = np.full(e_pad, -1, np.int32)
        ow[: len(o)] = o
        od[: len(o)] = r
        return (torch.as_tensor(ow, device=ctx.device),
                torch.as_tensor(od, device=ctx.device))

    owners_dev, ords_dev = seg.device(
        ("agg_kw_dev", fname, str(ctx.device)), build)
    nb_pad = next_pow2(max(len(term_list), 1), minimum=8)
    counts = ordinal_counts(ords_dev, owners_dev, dev_mask,
                            nb_pad)[: len(term_list)].cpu().numpy()
    buckets: Dict[str, Dict[str, Any]] = {}
    for tid in np.nonzero(counts)[0]:
        key = term_list[int(tid)]
        buckets[str(key)] = {"key": key, "doc_count": int(counts[tid]),
                             "subs": {}}
    return {"buckets": buckets}


def collect_terms(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    fname = spec.params.get("field")
    if fname is None and spec.params.get("script") is None:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] requires a [field] or [script]")
    device = _device_terms(spec, ctx, mask)
    if device is not None:
        return device
    kind = field_kind(ctx, fname) if fname else "numeric"
    buckets: Dict[str, Dict[str, Any]] = {}
    missing = spec.params.get("missing")
    seen_docs = np.zeros(ctx.segment.n_docs, bool)

    if fname and kind == "keyword":
        owners, ords, term_list = keyword_occurrences(ctx, fname)
        keep = mask[owners]
        owners, ords = owners[keep], ords[keep]
        seen_docs[owners] = True
        if len(owners):
            owners, ords = _dedup_doc_ord(owners, ords, len(term_list))
            counts = np.bincount(ords, minlength=len(term_list))
            for tid in np.nonzero(counts)[0]:
                key = term_list[tid]
                bmask = np.zeros(ctx.segment.n_docs, bool)
                bmask[owners[ords == tid]] = True
                buckets[str(key)] = {
                    "key": key, "doc_count": int(counts[tid]),
                    "subs": _collect_subs(spec, ctx, bmask, scores)}
    else:
        from elasticsearch_tpu_torch.search.aggregations.values import (
            resolve_numeric,
        )
        params = dict(spec.params)
        params.pop("missing", None)   # handled below as its own bucket
        owners, values = resolve_numeric(ctx, params, spec.name)
        keep = mask[owners]
        owners, values = owners[keep], values[keep]
        seen_docs[owners] = True
        if len(owners):
            uniq = np.unique(values)
            for v in uniq:
                sel = values == v
                docs = np.unique(owners[sel])
                bmask = np.zeros(ctx.segment.n_docs, bool)
                bmask[docs] = True
                key = int(v) if float(v).is_integer() else float(v)
                buckets[str(key)] = {
                    "key": key, "doc_count": int(len(docs)),
                    "subs": _collect_subs(spec, ctx, bmask, scores)}

    if missing is not None:
        m = mask & ~seen_docs
        n = _doc_count(m)
        if n:
            buckets[str(missing)] = {
                "key": missing, "doc_count": n,
                "subs": _collect_subs(spec, ctx, m, scores)}
    return {"buckets": buckets}


# ---------------------------------------------------------------------------
# histogram / date_histogram
# ---------------------------------------------------------------------------

_UNIT_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
            "d": 86_400_000}

# coordinator-side bucket ceiling (search.max_buckets default,
# MultiBucketConsumerService)
MAX_BUCKETS = 65536


def _check_max_buckets(n: float, spec: AggSpec) -> None:
    if n > MAX_BUCKETS:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] would create more than "
            f"[{MAX_BUCKETS}] buckets; raise the interval or set "
            f"min_doc_count > 0")


def parse_interval_ms(expr: Any) -> float:
    if isinstance(expr, (int, float)):
        return float(expr)
    expr = str(expr).strip()
    for unit in sorted(_UNIT_MS, key=len, reverse=True):
        if expr.endswith(unit):
            try:
                return float(expr[: -len(unit)]) * _UNIT_MS[unit]
            except ValueError:
                break
    raise IllegalArgumentError(f"failed to parse interval [{expr}]")


_CALENDAR = {"minute", "1m", "hour", "1h", "day", "1d", "week", "1w",
             "month", "1M", "quarter", "1q", "year", "1y"}


def _calendar_floor(values: np.ndarray, unit: str) -> np.ndarray:
    """Floor epoch-millis to calendar bucket starts (UTC)."""
    ms = values.astype(np.int64)
    if unit in ("minute", "1m"):
        return (ms // 60_000) * 60_000
    if unit in ("hour", "1h"):
        return (ms // 3_600_000) * 3_600_000
    if unit in ("day", "1d"):
        return (ms // 86_400_000) * 86_400_000
    if unit in ("week", "1w"):
        days = ms // 86_400_000
        monday = days - ((days + 3) % 7)   # 1970-01-01 is a Thursday
        return monday * 86_400_000
    dt = ms.astype("datetime64[ms]")
    months = dt.astype("datetime64[M]")
    if unit in ("month", "1M"):
        return months.astype("datetime64[ms]").astype(np.int64)
    if unit in ("quarter", "1q"):
        mi = months.astype(np.int64)       # months since epoch
        return ((mi // 3) * 3).astype("datetime64[M]").astype(
            "datetime64[ms]").astype(np.int64)
    if unit in ("year", "1y"):
        return dt.astype("datetime64[Y]").astype("datetime64[ms]").astype(
            np.int64)
    raise IllegalArgumentError(f"unknown calendar interval [{unit}]")


def format_date_key(ms: float) -> str:
    dt = np.datetime64(int(ms), "ms")
    return str(dt) + "Z"


_DEVICE_SUB_TYPES = {"sum", "avg", "min", "max", "value_count"}


def _device_metric_subs(spec: AggSpec, fname: str) -> bool:
    """Can every sub-agg be answered from the kernel's fused per-bucket
    count/sum/min/max over the SAME field?"""
    for sub in spec.subs:
        if sub.is_pipeline:
            continue
        if sub.type not in _DEVICE_SUB_TYPES or sub.subs or \
                sub.params.get("field") != fname or \
                sub.params.get("missing") is not None or \
                sub.params.get("script") is not None:
            return False
    return True


def _sub_partial_from_stats(sub: AggSpec, count: int, total: float,
                            vmin: float, vmax: float) -> Dict[str, Any]:
    return {"count": count, "sum": total,
            "min": vmin if count else None,
            "max": vmax if count else None, "sum_sq": 0.0}


def _device_histogram(spec: AggSpec, ctx, mask, scores
                      ) -> Optional[Dict[str, Any]]:
    """One-dispatch device collection (ops/aggs.py, K21) for the common
    histogram shape: single-valued numeric column, fixed interval, subs
    absent or metric-on-same-field. Returns None to fall back host-side."""
    fname = spec.params.get("field")
    if fname is None or spec.params.get("missing") is not None or \
            spec.params.get("offset") or spec.params.get("extended_bounds"):
        return None
    if not _device_metric_subs(spec, fname):
        return None
    if getattr(ctx, "_agg_top_host_mask", None) is not mask:
        # sub-aggregation context: the device mask is the top-level one,
        # not this bucket's — decline (see _device_terms)
        return None
    seg = ctx.segment
    dv = seg.doc_values.get(fname)
    if dv is None or dv.multi:
        return None
    if spec.type == "date_histogram":
        if spec.params.get("calendar_interval"):
            return None
        interval = parse_interval_ms(spec.params.get(
            "fixed_interval", spec.params.get("interval", "1d")))
    else:
        interval = float(spec.params.get("interval", 0))
    # the device kernel buckets by INTEGER floor-division for exact parity
    # with the host's float64 floor(v/interval): only integral columns and
    # intervals qualify (f32 division could misbucket at boundaries)
    if interval <= 0 or not float(interval).is_integer() or \
            dv.values.dtype.kind != "i":
        return None
    interval = int(interval)
    dev_mask = getattr(ctx, "_agg_device_mask", None)
    if dev_mask is None:
        return None
    docs = np.nonzero(dv.exists)[0]
    if len(docs) == 0:
        return {"buckets": {}}
    import torch
    from elasticsearch_tpu_torch.index.segment import next_pow2
    from elasticsearch_tpu_torch.ops.aggs import histogram_partials
    vmin = int(dv.values[docs].min())
    vmax = int(dv.values[docs].max())
    if max(abs(vmin), abs(vmax)) >= 2 ** 24:
        # int32-safe AND f32-exact for the fused sum/min/max vectors;
        # epoch-millis dates exceed this and fall back to the host path
        return None
    base_div = vmin // interval
    n_buckets = vmax // interval - base_div + 1
    if n_buckets > MAX_BUCKETS:
        return None
    nb_pad = next_pow2(n_buckets, minimum=8)   # bucketed: caps compiles

    def build():
        values = np.zeros(ctx.n_docs_pad, np.int32)
        values[: seg.n_docs] = dv.values.astype(np.int32)
        exists = np.zeros(ctx.n_docs_pad, bool)
        exists[: seg.n_docs] = dv.exists
        return (torch.as_tensor(values, device=ctx.device),
                torch.as_tensor(exists, device=ctx.device))

    values_dev, exists_dev = seg.device(
        ("agg_dv_i32", fname, str(ctx.device)), build)
    counts, sums, mins, maxs = (t[:n_buckets].cpu().numpy() for t in
                                histogram_partials(
                                    values_dev, exists_dev, dev_mask,
                                    base_div, interval, nb_pad))
    buckets: Dict[str, Dict[str, Any]] = {}
    for i in np.nonzero(counts)[0]:
        # IDENTICAL key derivation to the host path (float key, repr'd
        # bucket id) or segments served by different paths would merge
        # into separate buckets for the same key
        key = float((int(i) + base_div) * interval)
        subs = {sub.name: _sub_partial_from_stats(
                    sub, int(counts[i]), float(sums[i]),
                    float(mins[i]), float(maxs[i]))
                for sub in spec.subs if not sub.is_pipeline}
        buckets[repr(key)] = {"key": key, "doc_count": int(counts[i]),
                              "subs": subs}
    return {"buckets": buckets}


def collect_histogram(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    device = _device_histogram(spec, ctx, mask, scores)
    if device is not None:
        return device
    fname = spec.params.get("field")
    if fname is None:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] requires a [field]")
    owners, values = numeric_occurrences(ctx, fname)
    missing = spec.params.get("missing")
    if missing is not None:
        have = np.zeros(ctx.segment.n_docs, bool)
        have[owners] = True
        absent = np.nonzero(~have)[0].astype(np.int32)
        owners = np.concatenate([owners, absent])
        values = np.concatenate([values,
                                 np.full(len(absent), float(missing))])
    keep = mask[owners]
    owners, values = owners[keep], values[keep]

    is_date = spec.type == "date_histogram"
    calendar = spec.params.get("calendar_interval")
    if is_date and calendar is not None and \
            str(calendar) not in ("", None):
        if str(calendar) not in _CALENDAR:
            raise IllegalArgumentError(
                f"unknown calendar interval [{calendar}]")
        keys = (_calendar_floor(values, str(calendar)).astype(np.float64)
                if len(values) else values)
    else:
        interval = (parse_interval_ms(
            spec.params.get("fixed_interval",
                            spec.params.get("interval", "1d")))
            if is_date else float(spec.params.get("interval", 0)))
        if interval <= 0:
            raise IllegalArgumentError(
                f"[interval] must be >0 for histogram [{spec.name}]")
        offset = float(spec.params.get("offset", 0) or 0)
        keys = np.floor((values - offset) / interval) * interval + offset

    buckets: Dict[str, Dict[str, Any]] = {}
    for k in np.unique(keys) if len(keys) else []:
        sel = keys == k
        docs = np.unique(owners[sel])
        bmask = np.zeros(ctx.segment.n_docs, bool)
        bmask[docs] = True
        key = float(k)
        buckets[repr(key)] = {
            "key": key, "doc_count": int(len(docs)),
            "subs": _collect_subs(spec, ctx, bmask, scores)}
    return {"buckets": buckets}


# ---------------------------------------------------------------------------
# range / date_range
# ---------------------------------------------------------------------------

def collect_range(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    fname = spec.params.get("field")
    ranges = spec.params.get("ranges")
    if fname is None or not ranges:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] requires [field] and [ranges]")
    owners, values = numeric_occurrences(ctx, fname)
    keep = mask[owners]
    owners, values = owners[keep], values[keep]
    buckets = {}
    order = []
    for rng in ranges:
        lo = rng.get("from")
        hi = rng.get("to")
        lo_f = float(lo) if lo is not None else -np.inf
        hi_f = float(hi) if hi is not None else np.inf
        key = rng.get("key") or _range_key(lo, hi)
        sel = (values >= lo_f) & (values < hi_f)
        docs = np.unique(owners[sel])
        bmask = np.zeros(ctx.segment.n_docs, bool)
        bmask[docs] = True
        bucket = {"key": key, "doc_count": int(len(docs)),
                  "subs": _collect_subs(spec, ctx, bmask, scores)}
        if lo is not None:
            bucket["from"] = float(lo)
        if hi is not None:
            bucket["to"] = float(hi)
        buckets[key] = bucket
        order.append(key)
    return {"buckets": buckets, "order": order}


def _range_key(lo, hi) -> str:
    lo_s = "*" if lo is None else _num_s(lo)
    hi_s = "*" if hi is None else _num_s(hi)
    return f"{lo_s}-{hi_s}"


def _num_s(v) -> str:
    return f"{float(v):g}" if float(v) != int(float(v)) \
        else f"{float(v):.1f}"


# ---------------------------------------------------------------------------
# shared multi-bucket merge / finalize
# ---------------------------------------------------------------------------

def merge_multi(spec: AggSpec, a, b) -> Dict[str, Any]:
    out = dict(a)
    # carry structural keys (keyed, order) from whichever side has them —
    # an empty-shard partial is just {"buckets": {}}
    for k, v in b.items():
        if k not in out:
            out[k] = v
    buckets = dict(a["buckets"])
    for bk, bucket in b["buckets"].items():
        if bk in buckets:
            prev = buckets[bk]
            buckets[bk] = {
                **prev,
                "doc_count": prev["doc_count"] + bucket["doc_count"],
                "subs": _merge_subs(spec, prev["subs"], bucket["subs"]),
            }
        else:
            buckets[bk] = bucket
    out["buckets"] = buckets
    if "order" in b and len(b.get("order", [])) > len(a.get("order", [])):
        out["order"] = b["order"]
    return out


def finalize_terms(spec: AggSpec, p) -> Dict[str, Any]:
    buckets = list(p["buckets"].values())
    size = int(spec.params.get("size", 10))
    min_doc_count = int(spec.params.get("min_doc_count", 1))
    order = spec.params.get("order", {"_count": "desc"})
    if isinstance(order, list):
        order = order[0] if order else {"_count": "desc"}
    (okey, odir), = order.items() if order else (("_count", "desc"),)
    reverse = str(odir).lower() == "desc"

    def sort_value(bucket):
        if okey == "_count":
            return bucket["doc_count"]
        if okey == "_key" or okey == "_term":
            return bucket["key"]
        return _subagg_sort_value(spec, bucket, okey)

    buckets = [bkt for bkt in buckets
               if bkt["doc_count"] >= min_doc_count]
    # ties broken by key ascending, like the reference (stable sort keeps
    # the key order for equal primary values even under reverse)
    buckets.sort(key=lambda bkt: bkt["key"] if isinstance(
        bkt["key"], str) else str(bkt["key"]))
    if okey == "_count":
        buckets.sort(key=lambda bkt: bkt["doc_count"],
                     reverse=reverse)
    else:
        buckets.sort(key=sort_value, reverse=reverse)
    total = sum(bkt["doc_count"] for bkt in buckets)
    selected = buckets[:size]
    out_buckets = []
    for bkt in selected:
        node = {"key": bkt["key"], "doc_count": bkt["doc_count"]}
        if isinstance(bkt["key"], bool):
            node["key"] = 1 if bkt["key"] else 0
        node.update(_finalize_subs(spec, bkt["subs"]))
        out_buckets.append(node)
    return {
        "doc_count_error_upper_bound": 0,
        "sum_other_doc_count": total - sum(
            bkt["doc_count"] for bkt in selected),
        "buckets": out_buckets,
    }


def _subagg_sort_value(spec: AggSpec, bucket, path: str):
    from elasticsearch_tpu_torch.search.aggregations.engine import finalize_one
    agg_name, _, metric = path.partition(".")
    sub = next((s for s in spec.subs if s.name == agg_name), None)
    if sub is None:
        raise IllegalArgumentError(
            f"unknown order path [{path}] in terms [{spec.name}]")
    node = finalize_one(sub, bucket["subs"][sub.name])
    v = node.get(metric or "value")
    return v if v is not None else -np.inf


def finalize_histogram(spec: AggSpec, p) -> Dict[str, Any]:
    buckets = sorted(p["buckets"].values(), key=lambda bkt: bkt["key"])
    min_doc_count = int(spec.params.get("min_doc_count", 0))
    is_date = spec.type == "date_histogram"

    # gap filling for min_doc_count=0 (the reference's empty-bucket fill),
    # capped like search.max_buckets so a sparse range with a tiny interval
    # cannot generate unbounded empty buckets
    if min_doc_count == 0 and buckets:
        calendar = spec.params.get("calendar_interval") if is_date else None
        if calendar is None:
            interval = (parse_interval_ms(
                spec.params.get("fixed_interval",
                                spec.params.get("interval", "1d")))
                if is_date else float(spec.params.get("interval")))
            span = buckets[-1]["key"] - buckets[0]["key"]
            _check_max_buckets(span / interval, spec)
            keys_have = {bkt["key"] for bkt in buckets}
            k = buckets[0]["key"]
            fill = []
            while k < buckets[-1]["key"]:
                if k not in keys_have:
                    fill.append({"key": k, "doc_count": 0, "subs": {}})
                k += interval
            buckets = sorted(buckets + fill, key=lambda bkt: bkt["key"])
        else:
            unit = str(calendar)
            min_step = {
                "minute": 60_000, "1m": 60_000,
                "hour": 3_600_000, "1h": 3_600_000,
                "day": 86_400_000, "1d": 86_400_000,
                "week": 604_800_000, "1w": 604_800_000,
                "month": 28 * 86_400_000, "1M": 28 * 86_400_000,
                "quarter": 89 * 86_400_000, "1q": 89 * 86_400_000,
                "year": 365 * 86_400_000, "1y": 365 * 86_400_000,
            }.get(unit, 86_400_000)
            span = buckets[-1]["key"] - buckets[0]["key"]
            _check_max_buckets(span / min_step, spec)
            buckets = _fill_calendar(buckets, unit)
    buckets = [bkt for bkt in buckets
               if bkt["doc_count"] >= min_doc_count]
    out = []
    for bkt in buckets:
        node = {"key": bkt["key"], "doc_count": bkt["doc_count"]}
        if is_date:
            node["key_as_string"] = format_date_key(bkt["key"])
        node.update(_finalize_subs(spec, bkt.get("subs", {})))
        out.append(node)
    return {"buckets": out}


def _fill_calendar(buckets, unit: str):
    """Fill empty calendar buckets by stepping bucket starts."""
    have = {bkt["key"] for bkt in buckets}
    first, last = buckets[0]["key"], buckets[-1]["key"]
    fill = []
    k = first
    while k < last:
        nxt = _next_calendar(k, unit)
        if nxt == k:
            break
        k = nxt
        if k < last and k not in have:
            fill.append({"key": float(k), "doc_count": 0, "subs": {}})
    return sorted(buckets + fill, key=lambda bkt: bkt["key"])


def _next_calendar(ms: float, unit: str) -> float:
    arr = np.asarray([ms])
    if unit in ("minute", "1m", "hour", "1h", "day", "1d", "week", "1w"):
        step = {"minute": 60_000, "1m": 60_000,
                "hour": 3_600_000, "1h": 3_600_000,
                "day": 86_400_000, "1d": 86_400_000,
                "week": 604_800_000, "1w": 604_800_000}[unit]
        return float(ms + step)
    months = np.asarray([int(ms)], np.int64).astype(
        "datetime64[ms]").astype("datetime64[M]").astype(np.int64)
    step = {"month": 1, "1M": 1, "quarter": 3, "1q": 3,
            "year": 12, "1y": 12}[unit]
    return float((months + step).astype("datetime64[M]").astype(
        "datetime64[ms]").astype(np.int64)[0])


def finalize_range(spec: AggSpec, p) -> Dict[str, Any]:
    order = p.get("order") or list(p["buckets"])
    keyed = bool(spec.params.get("keyed"))
    out = []
    for key in order:
        bkt = p["buckets"][key]
        node = {"key": bkt["key"], "doc_count": bkt["doc_count"]}
        for side in ("from", "to"):
            if side in bkt:
                node[side] = bkt[side]
                if spec.type == "date_range":
                    node[f"{side}_as_string"] = format_date_key(bkt[side])
        node.update(_finalize_subs(spec, bkt["subs"]))
        out.append(node)
    if keyed:
        return {"buckets": {n["key"]: {k: v for k, v in n.items()
                                       if k != "key"} for n in out}}
    return {"buckets": out}


def finalize_filters(spec: AggSpec, p) -> Dict[str, Any]:
    order = p.get("order") or list(p["buckets"])
    nodes = {}
    for key in order:
        bkt = p["buckets"][key]
        node = {"doc_count": bkt["doc_count"]}
        node.update(_finalize_subs(spec, bkt["subs"]))
        nodes[key] = node
    if p.get("keyed", True):
        return {"buckets": nodes}
    return {"buckets": [{"key": k, **nodes[k]} for k in order]}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# composite (bucket/composite/CompositeAggregationBuilder analog)
# ---------------------------------------------------------------------------

def _composite_sources(spec: AggSpec) -> List[Tuple[str, str, Dict[str, Any]]]:
    out = []
    for src in spec.params.get("sources") or []:
        (sname, body), = src.items()
        (stype, cfg), = body.items()
        if stype not in ("terms", "histogram", "date_histogram"):
            raise IllegalArgumentError(
                f"unsupported composite source type [{stype}]")
        out.append((sname, stype, cfg))
    if not out:
        raise IllegalArgumentError(
            f"composite [{spec.name}] requires [sources]")
    return out


def collect_composite(spec: AggSpec, ctx, mask, scores) -> Dict[str, Any]:
    """Cartesian bucket keys per doc. Shards keep EVERY bucket (exact
    framework semantics); pagination (after/size) applies at finalize."""
    import json
    sources = _composite_sources(spec)
    n = ctx.segment.n_docs
    cols: List[Optional[list]] = []
    for _sname, stype, cfg in sources:
        f = cfg.get("field")
        col: List[Any] = [None] * n
        if stype == "terms" and field_kind(ctx, f) == "keyword":
            owners, ords, term_list = keyword_occurrences(ctx, f)
            # first value per doc, vectorized (occurrences are doc-sorted)
            uniq, first = np.unique(owners, return_index=True)
            for o, i in zip(uniq, first):
                col[int(o)] = term_list[int(ords[i])]
        else:
            owners, values = numeric_occurrences(ctx, f)
            if stype == "histogram":
                interval = float(cfg.get("interval", 1))
                values = np.floor(values / interval) * interval
            elif stype == "date_histogram":
                cal = cfg.get("calendar_interval")
                if cal:
                    values = _calendar_floor(values, str(cal)).astype(
                        np.float64)
                else:
                    interval = parse_interval_ms(cfg.get(
                        "fixed_interval", cfg.get("interval", "1d")))
                    values = np.floor(values / interval) * interval
            uniq, first = np.unique(owners, return_index=True)
            for o, i in zip(uniq, first):
                key = float(values[i])
                col[int(o)] = int(key) if key.is_integer() else key
        cols.append(col)
    buckets: Dict[str, Dict[str, Any]] = {}
    groups: Dict[str, list] = {}
    for d in np.nonzero(mask[:n])[0]:
        key_vals = [col[d] for col in cols]
        if any(v is None for v in key_vals):
            continue   # a doc missing any source value is skipped
        key = {sname: v for (sname, _t, _c), v in zip(sources, key_vals)}
        bk = json.dumps(key, sort_keys=True)
        groups.setdefault(bk, []).append(d)
        if bk not in buckets:
            buckets[bk] = {"key": key, "doc_count": 0, "subs": {}}
        buckets[bk]["doc_count"] += 1
    for bk, docs in groups.items():
        if spec.subs:
            bmask = np.zeros(n, bool)
            bmask[docs] = True
            buckets[bk]["subs"] = _collect_subs(spec, ctx, bmask, scores)
    return {"buckets": buckets}


def _composite_cmp(sources):
    """Composite key comparator honoring each source's asc/desc order
    (the reference's per-source comparators). Numbers sort before strings
    within a source (type-stable)."""
    def cmp(a: Dict[str, Any], b: Dict[str, Any]) -> int:
        for sname, _t, cfg in sources:
            va, vb = a.get(sname), b.get(sname)
            ka = ((0, float(va)) if isinstance(va, (int, float))
                  else (1, str(va)))
            kb = ((0, float(vb)) if isinstance(vb, (int, float))
                  else (1, str(vb)))
            if ka != kb:
                c = -1 if ka < kb else 1
                if str(cfg.get("order", "asc")).lower() == "desc":
                    c = -c
                return c
        return 0
    return cmp


def finalize_composite(spec: AggSpec, p) -> Dict[str, Any]:
    import functools
    sources = _composite_sources(spec)
    size = int(spec.params.get("size", 10))
    after = spec.params.get("after")
    cmp = _composite_cmp(sources)
    items = sorted(p["buckets"].values(),
                   key=functools.cmp_to_key(
                       lambda x, y: cmp(x["key"], y["key"])))
    if after is not None:
        items = [b for b in items if cmp(b["key"], after) > 0]
    selected = items[:size]
    out_buckets = []
    for b in selected:
        from elasticsearch_tpu_torch.search.aggregations.engine import finalize_one
        entry = {"key": b["key"], "doc_count": b["doc_count"]}
        for sub in spec.subs:
            if not sub.is_pipeline and sub.name in b.get("subs", {}):
                entry[sub.name] = finalize_one(sub, b["subs"][sub.name])
        out_buckets.append(entry)
    out: Dict[str, Any] = {"buckets": out_buckets}
    if out_buckets:
        out["after_key"] = out_buckets[-1]["key"]
    return out


# ---------------------------------------------------------------------------
# significant_terms (bucket/terms/SignificantTermsAggregationBuilder analog;
# JLH significance heuristic)
# ---------------------------------------------------------------------------

def collect_significant_terms(spec: AggSpec, ctx, mask, scores
                              ) -> Dict[str, Any]:
    fname = spec.params.get("field")
    if fname is None:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] requires a [field]")
    n = ctx.segment.n_docs
    live = np.zeros(n, bool)
    live[: len(ctx.segment.live)] = ctx.segment.live
    fg_total = int(np.count_nonzero(mask[:n]))
    bg_total = int(np.count_nonzero(live))
    buckets: Dict[str, Dict[str, Any]] = {}
    if field_kind(ctx, fname) == "keyword":
        owners, ords, term_list = keyword_occurrences(ctx, fname)
        owners, ords = _dedup_doc_ord(owners, ords, len(term_list))
        bg = np.bincount(ords[live[owners]], minlength=len(term_list))
        fg = np.bincount(ords[mask[owners]], minlength=len(term_list))
        for tid in np.nonzero(fg)[0]:
            key = term_list[int(tid)]
            subs: Dict[str, Any] = {}
            if spec.subs:
                # only pay the per-term O(n_docs) mask when there are subs
                bmask = np.zeros(n, bool)
                bmask[owners[(ords == tid)]] = True
                subs = _collect_subs(spec, ctx, bmask & mask, scores)
            buckets[str(key)] = {
                "key": key, "doc_count": int(fg[tid]),
                "bg_count": int(bg[tid]), "subs": subs}
    else:
        owners, values = numeric_occurrences(ctx, fname)
        for v in np.unique(values):
            sel = owners[values == v]
            docs = np.unique(sel)
            fg_n = int(np.count_nonzero(mask[docs]))
            if not fg_n:
                continue
            bmask = np.zeros(n, bool)
            bmask[docs] = True
            key = int(v) if float(v).is_integer() else float(v)
            buckets[str(key)] = {
                "key": key, "doc_count": fg_n,
                "bg_count": int(np.count_nonzero(live[docs])),
                "subs": _collect_subs(spec, ctx, bmask & mask, scores)}
    return {"buckets": buckets, "fg_total": fg_total, "bg_total": bg_total}


def merge_significant(spec: AggSpec, a, b) -> Dict[str, Any]:
    out = merge_multi(spec, a, b)
    for bk, bucket in b["buckets"].items():
        if bk in a["buckets"]:
            out["buckets"][bk]["bg_count"] = \
                a["buckets"][bk]["bg_count"] + bucket["bg_count"]
    out["fg_total"] = a.get("fg_total", 0) + b.get("fg_total", 0)
    out["bg_total"] = a.get("bg_total", 0) + b.get("bg_total", 0)
    return out


def finalize_significant(spec: AggSpec, p) -> Dict[str, Any]:
    """JLH score: (fg_rate - bg_rate) * (fg_rate / bg_rate) for terms
    overrepresented in the foreground (SignificantTermsHeuristic JLH)."""
    from elasticsearch_tpu_torch.search.aggregations.engine import finalize_one
    fg_total = max(int(p.get("fg_total", 0)), 1)
    bg_total = max(int(p.get("bg_total", 0)), 1)
    size = int(spec.params.get("size", 10))
    min_doc = int(spec.params.get("min_doc_count", 3))
    scored = []
    for b in p["buckets"].values():
        if b["doc_count"] < min_doc:
            continue
        fg_rate = b["doc_count"] / fg_total
        bg_rate = max(b["bg_count"], 1) / bg_total
        if fg_rate <= bg_rate:
            continue   # not overrepresented in the foreground
        score = (fg_rate - bg_rate) * (fg_rate / bg_rate)
        scored.append((score, b))
    scored.sort(key=lambda sb: (-sb[0], str(sb[1]["key"])))
    out_buckets = []
    for score, b in scored[:size]:
        entry = {"key": b["key"], "doc_count": b["doc_count"],
                 "bg_count": b["bg_count"], "score": round(score, 6)}
        for sub in spec.subs:
            if not sub.is_pipeline and sub.name in b.get("subs", {}):
                entry[sub.name] = finalize_one(sub, b["subs"][sub.name])
        out_buckets.append(entry)
    return {"doc_count": int(p.get("fg_total", 0)),
            "bg_count": int(p.get("bg_total", 0)),
            "buckets": out_buckets}


def collect_significant_text(spec: AggSpec, ctx, mask, scores
                             ) -> Dict[str, Any]:
    """significant_terms over an ANALYZED text field's postings
    (SignificantTextAggregationBuilder analog): foreground = matched
    docs containing each term, background = live docs containing it.
    Produces the same partial shape as significant_terms so the merge/
    finalize (JLH) stages are shared."""
    fname = spec.params.get("field")
    if fname is None:
        raise IllegalArgumentError(
            f"aggregation [{spec.name}] requires a [field]")
    n = ctx.segment.n_docs
    live = np.zeros(n, bool)
    live[: len(ctx.segment.live)] = ctx.segment.live
    fg_total = int(np.count_nonzero(mask[:n]))
    bg_total = int(np.count_nonzero(live))
    buckets: Dict[str, Dict[str, Any]] = {}
    pf = ctx.segment.postings.get(fname)
    if pf is not None and fg_total:
        for term in pf.terms:
            docs, _tfs = pf.postings_for(term)
            docs = docs[docs < n]
            fg = int(np.count_nonzero(mask[docs]))
            if not fg:
                continue
            subs: Dict[str, Any] = {}
            if spec.subs:
                bmask = np.zeros(n, bool)
                bmask[docs] = True
                subs = _collect_subs(spec, ctx, bmask & mask, scores)
            buckets[str(term)] = {
                "key": term, "doc_count": fg,
                "bg_count": int(np.count_nonzero(live[docs])),
                "subs": subs}
    return {"buckets": buckets, "fg_total": fg_total, "bg_total": bg_total}


BUCKET_COLLECT = {
    "terms": collect_terms,
    "range": collect_range,
    "date_range": collect_range,
    "histogram": collect_histogram,
    "date_histogram": collect_histogram,
    "filter": collect_filter,
    "filters": collect_filters,
    "global": collect_global,
    "missing": collect_missing,
    "composite": collect_composite,
    "significant_terms": collect_significant_terms,
    "significant_text": collect_significant_text,
}
BUCKET_MERGE = {
    "terms": merge_multi, "range": merge_multi, "date_range": merge_multi,
    "histogram": merge_multi, "date_histogram": merge_multi,
    "filters": merge_multi,
    "filter": merge_single, "global": merge_single,
    "missing": merge_single,
    "composite": merge_multi,
    "significant_terms": merge_significant,
    "significant_text": merge_significant,
}
BUCKET_FINALIZE = {
    "terms": finalize_terms,
    "range": finalize_range, "date_range": finalize_range,
    "histogram": finalize_histogram, "date_histogram": finalize_histogram,
    "filter": finalize_single, "global": finalize_single,
    "missing": finalize_single,
    "filters": finalize_filters,
    "composite": finalize_composite,
    "significant_terms": finalize_significant,
    "significant_text": finalize_significant,
}
