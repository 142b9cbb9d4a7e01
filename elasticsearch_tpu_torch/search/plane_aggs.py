"""Drain-wide device aggregation: the ``dense_device`` data plane.

Before this module, every agg-bearing ``dense`` member of a drain ran
``query_shard`` alone and its collectors visited segments one at a time —
per (segment, plan) dispatch costs, the exact shape the packed plane
removed for bm25/knn/sparse scoring. Here a drain's dense members are
planned TOGETHER:

1. shape-eligible top-level aggs (sub-less keyword ``terms``;
   ``histogram``/``date_histogram`` with fixed integral interval and
   metric-on-same-field subs — the same gates as the per-segment device
   collectors in aggregations/buckets.py) are grouped per agg family;
2. each member's filter/query mask is built ONCE via the cross-drain
   filter-context mask cache (execute.filter_context_mask, the batched
   kNN precedent) and scattered into the columns plane's doc space;
3. one ``ordinal_counts_plane`` (K22) / ``histogram_partials_plane``
   (K23) launch serves P distinct plans x all segments per (shard, agg
   family), with per-plan base/interval riding as [P] vectors;
4. the resulting whole-shard partials PRESET the member's
   ShardAggregator (engine.py), which skips per-segment collection for
   those specs — merge/finalize and the coordinator reduce are untouched.

The whole-plane scatter IS the merged per-segment partial (bucket merges
are commutative), so no demux back to segments is needed for these
families; ineligible shapes keep the host path per member, typed under
the ``plane_aggs_*`` fallback taxonomy. Responses are byte-identical
either way — this is a perf tier, never a correctness gate.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.search import telemetry
from elasticsearch_tpu_torch.search.telemetry import (
    PLANE_AGGS_BREAKER_REFUSED, PLANE_AGGS_COLUMN_UNAVAILABLE,
    PLANE_AGGS_EXEC_ERROR, PLANE_AGGS_INELIGIBLE_SHAPE,
)

__all__ = ["plan_drain_aggs"]


def _shape_of(spec) -> Optional[Tuple]:
    """("terms", field) | ("hist", field, interval) for spec shapes the
    plane kernels can serve, None otherwise — the drain-level mirror of
    buckets._device_terms / buckets._device_histogram's SHAPE gates (the
    per-column gates live on the PlaneColumns part itself)."""
    from elasticsearch_tpu_torch.search.aggregations.buckets import (
        _device_metric_subs, parse_interval_ms,
    )
    if spec.type == "terms":
        fname = spec.params.get("field")
        if fname and not spec.subs and \
                spec.params.get("missing") is None and \
                spec.params.get("script") is None:
            return ("terms", fname)
        return None
    if spec.type in ("histogram", "date_histogram"):
        fname = spec.params.get("field")
        if fname is None or spec.params.get("missing") is not None or \
                spec.params.get("offset") or \
                spec.params.get("extended_bounds"):
            return None
        if not _device_metric_subs(spec, fname):
            return None
        if spec.type == "date_histogram":
            if spec.params.get("calendar_interval"):
                return None
            try:
                interval = parse_interval_ms(spec.params.get(
                    "fixed_interval", spec.params.get("interval", "1d")))
            except Exception:  # noqa: BLE001 — host path raises properly
                return None
        else:
            interval = float(spec.params.get("interval", 0))
        if interval <= 0 or not float(interval).is_integer():
            return None
        return ("hist", fname, int(interval))
    return None


def _member_eligible(u) -> bool:
    """Mask-exactness gate: the collected mask equals the query mask only
    when nothing narrows it after execute() (phase._query_shard_dense
    narrows for slice / min_score / terminate_after), and shard-stat
    overrides mark a DFS-phase request whose planning should stay
    untouched."""
    body = u.req.get("body") or {}
    if body.get("slice") or body.get("min_score") is not None or \
            body.get("terminate_after"):
        return False
    if u.req.get("df_overrides") or u.req.get("doc_count_override") or \
            u.req.get("field_stats_overrides"):
        return False
    return True


def _terms_partial(counts: np.ndarray, term_list: List) -> Dict[str, Any]:
    buckets: Dict[str, Dict[str, Any]] = {}
    for tid in np.nonzero(counts)[0]:
        key = term_list[int(tid)]
        buckets[str(key)] = {"key": key, "doc_count": int(counts[tid]),
                             "subs": {}}
    return {"buckets": buckets}


def _hist_partial(spec, counts, sums, mins, maxs, base_div: int,
                  interval: int) -> Dict[str, Any]:
    from elasticsearch_tpu_torch.search.aggregations.buckets import (
        _sub_partial_from_stats,
    )
    buckets: Dict[str, Dict[str, Any]] = {}
    for i in np.nonzero(counts)[0]:
        # IDENTICAL key derivation to the host and per-segment device
        # paths (float key, repr'd bucket id) or plane-served shards
        # would merge into different buckets than host-served ones
        key = float((int(i) + base_div) * interval)
        subs = {sub.name: _sub_partial_from_stats(
                    sub, int(counts[i]), float(sums[i]),
                    float(mins[i]), float(maxs[i]))
                for sub in spec.subs if not sub.is_pipeline}
        buckets[repr(key)] = {"key": key, "doc_count": int(counts[i]),
                              "subs": subs}
    return {"buckets": buckets}


def plan_drain_aggs(shard, reader, uniques,
                    batch_stats: Optional[Dict[str, Any]] = None,
                    device: DeviceLike = None
                    ) -> Dict[int, Dict[str, Any]]:
    """Plan a dense drain's aggregations onto the columns plane.

    Returns ``{unique_index: {agg_name: whole-shard partial}}`` for every
    spec served by a plane kernel — the ShardAggregator preset. An empty
    dict means every member keeps the pure host path. A planning failure
    is a typed fallback, the host collectors still own correctness; a
    fault of the card (a kernel that does not build or launch, an
    allocation the card refuses) is not, and raises. ``device``: where
    the plane lives (None = the CUDA card)."""
    import torch

    from elasticsearch_tpu_torch._build import KernelError
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    device = resolve_device(device)
    try:
        return _plan(shard, reader, uniques, batch_stats, device)
    except (KernelError, torch.cuda.OutOfMemoryError):
        raise
    except Exception:  # noqa: BLE001 — planning must never fail a drain
        telemetry.TELEMETRY.count_fallback(PLANE_AGGS_EXEC_ERROR)
        PLANES.stats["plane_aggs_fallbacks"] += 1
        return {}


def _plan(shard, reader, uniques, batch_stats, device
          ) -> Dict[int, Dict[str, Any]]:
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.aggregations.buckets import MAX_BUCKETS

    count = telemetry.TELEMETRY.count_fallback

    # -- 1. shape-eligible candidate specs per unique -------------------
    candidates: List[Tuple[int, Any, Any, Tuple]] = []  # (ui, u, spec, shape)
    for ui, u in enumerate(uniques):
        if u.error is not None:
            continue
        body = u.req.get("body") or {}
        agg_body = body.get("aggs", body.get("aggregations"))
        if not agg_body:
            continue
        if not _member_eligible(u):
            count(PLANE_AGGS_INELIGIBLE_SHAPE)
            continue
        try:
            specs = parse_aggs(agg_body)
        except Exception:  # noqa: BLE001 — the member's own execution
            continue       # raises the parse error with full context
        for spec in specs:
            if spec.is_pipeline:
                continue
            shape = _shape_of(spec)
            if shape is None:
                count(PLANE_AGGS_INELIGIBLE_SHAPE)
                continue
            candidates.append((ui, u, spec, shape))
    if not candidates:
        return {}

    # -- 2. columns-plane availability per field ------------------------
    segments = list(reader.segments)
    parts: Dict[str, Any] = {}
    preset: Dict[int, Dict[str, Any]] = {}
    served = 0

    def fallback(n: int = 1, reason: Optional[str] = None) -> None:
        PLANES.stats["plane_aggs_fallbacks"] += n
        if reason is not None:
            for _ in range(n):
                count(reason)

    terms_plans: Dict[str, List[Tuple[int, Any]]] = {}
    hist_plans: Dict[str, List[Tuple[int, Any, int, int, int]]] = {}
    for ui, u, spec, shape in candidates:
        fname = shape[1]
        if fname not in parts:
            # the registry counts its own typed reason (disabled /
            # too-few-segments / budget / field-absent) on a None
            parts[fname] = PLANES.get(segments, "columns", fname, device)
        part = parts[fname]
        if part is None:
            fallback()
            continue
        if shape[0] == "terms":
            if not part.has_keyword:
                fallback(reason=PLANE_AGGS_COLUMN_UNAVAILABLE)
                continue
            if part.n_terms == 0:
                preset.setdefault(ui, {})[spec.name] = {"buckets": {}}
                served += 1
                continue
            terms_plans.setdefault(fname, []).append((ui, spec))
        else:
            interval = shape[2]
            if not part.has_numeric:
                fallback(reason=PLANE_AGGS_COLUMN_UNAVAILABLE)
                continue
            if part.vmin is None:
                # the field exists but no doc holds a value: the host
                # collector would emit no buckets either
                preset.setdefault(ui, {})[spec.name] = {"buckets": {}}
                served += 1
                continue
            base_div = part.vmin // interval
            n_buckets = part.vmax // interval - base_div + 1
            if n_buckets > MAX_BUCKETS:
                fallback(reason=PLANE_AGGS_COLUMN_UNAVAILABLE)
                continue
            hist_plans.setdefault(fname, []).append(
                (ui, spec, interval, base_div, n_buckets))

    if not terms_plans and not hist_plans:
        if served:
            PLANES.stats["plane_aggs_queries"] += served
        return preset

    # -- 3. per-member query masks in plane doc space, built once -------
    layout = next(p for p in parts.values() if p is not None)
    need_uis = sorted({ui for plans in terms_plans.values()
                       for ui, _ in plans} |
                      {ui for plans in hist_plans.values()
                       for ui, *_ in plans})
    mask_by_qrepr: Dict[str, np.ndarray] = {}
    mask_by_ui: Dict[int, np.ndarray] = {}
    ctxs = None
    for ui in need_uis:
        u = uniques[ui]
        body = u.req.get("body") or {}
        q = dsl.parse_query(body.get("query"))
        qrepr = repr(q)
        got = mask_by_qrepr.get(qrepr)
        if got is not None:
            mask_by_ui[ui] = got
            continue
        if ctxs is None:
            from elasticsearch_tpu_torch.search.batch_executor import _build_ctxs
            ctxs = _build_ctxs(reader, shard.engine.mappers,
                               sum(s.n_docs for s in segments), None,
                               device=device)
        t0 = time.monotonic_ns()
        with telemetry.activate(u.trace):
            mask = _plane_mask(q, qrepr, ctxs, reader, layout, batch_stats)
        if u.trace is not None:
            u.trace.add_span("plane_aggs_mask",
                             time.monotonic_ns() - t0)
        mask_by_qrepr[qrepr] = mask
        mask_by_ui[ui] = mask

    # -- 4. one dispatch per (shard, agg family) ------------------------
    for fname, plans in terms_plans.items():
        part = parts[fname]
        rows = _dispatch_terms(part, plans, mask_by_ui, uniques)
        if rows is None:
            fallback(len(plans), PLANE_AGGS_BREAKER_REFUSED)
            continue
        for (ui, spec), counts in zip(plans, rows):
            preset.setdefault(ui, {})[spec.name] = \
                _terms_partial(counts, part.term_list)
            served += 1
    for fname, plans in hist_plans.items():
        part = parts[fname]
        rows = _dispatch_hist(part, plans, mask_by_ui, uniques)
        if rows is None:
            fallback(len(plans), PLANE_AGGS_BREAKER_REFUSED)
            continue
        for (ui, spec, interval, base_div, nb), row in zip(plans, rows):
            counts, sums, mins, maxs = row
            preset.setdefault(ui, {})[spec.name] = _hist_partial(
                spec, counts, sums, mins, maxs, base_div, interval)
            served += 1
    if served:
        PLANES.stats["plane_aggs_queries"] += served
    return preset


def _plane_mask(q, qrepr: str, ctxs, reader, layout,
                batch_stats) -> np.ndarray:
    """One member's query-match mask in plane doc space [n_docs_pad]:
    per segment the cached filter-context mask intersected with the
    DRAIN reader's live snapshot, scattered at the plane's doc_base.

    The filter-cache key carries the segment's live COUNT: a cached mask
    bakes the live snapshot it was first built under, and deletes only
    ever shrink a segment's live set — equal count therefore means equal
    set, so a point-in-time reader older than a delete (more docs live)
    never reuses a post-delete mask. Within one delete state the mask is
    shared across drains AND plans, which is the whole point."""
    from elasticsearch_tpu_torch.search.execute import filter_context_mask
    out = np.zeros(layout.n_docs_pad, bool)
    for si, (ctx, seg) in enumerate(zip(ctxs, reader.segments)):
        n = seg.n_docs
        live_host = reader.live_masks[si]
        live = np.zeros(n, bool)
        live[: min(n, len(live_host))] = np.asarray(live_host)[:n]
        fkey = ("plane_aggs", qrepr, int(live.sum()))
        fm = np.asarray(filter_context_mask(ctx, q, fkey,
                                            stats=batch_stats))
        base = int(layout.doc_base[si])
        out[base: base + n] = fm[:n].astype(bool) & live
    return out


def _stack_masks(plans_uis: List[int], mask_by_ui: Dict[int, np.ndarray],
                 n_docs_pad: int) -> np.ndarray:
    """[P_pad, N_pad] host stack, P padded to pow2 so drain occupancy
    never churns compile shapes; padding rows match nothing."""
    from elasticsearch_tpu_torch.index.segment import next_pow2
    p_pad = next_pow2(max(len(plans_uis), 1), minimum=1)
    stack = np.zeros((p_pad, n_docs_pad), bool)
    for i, ui in enumerate(plans_uis):
        stack[i] = mask_by_ui[ui]
    return stack


def _dispatch_terms(part, plans, mask_by_ui, uniques
                    ) -> Optional[List[np.ndarray]]:
    """One ordinal_counts_plane (K22) launch for every terms plan over one
    field; None when the request breaker refuses the transient."""
    import torch

    from elasticsearch_tpu_torch.index.segment import next_pow2
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    from elasticsearch_tpu_torch.ops.aggs import ordinal_counts_plane
    from elasticsearch_tpu_torch.utils.errors import CircuitBreakingError
    stack = _stack_masks([ui for ui, _ in plans], mask_by_ui,
                         part.n_docs_pad)
    nb_pad = next_pow2(max(part.n_terms, 1), minimum=8)
    transient = 2 * stack.nbytes + stack.shape[0] * nb_pad * 4
    trace0 = uniques[plans[0][0]].trace
    t0 = time.monotonic_ns()
    try:
        with telemetry.activate(trace0), \
                BREAKERS.breaker("request").limit_scope(
                    transient, "plane_aggs"):
            counts = ordinal_counts_plane(
                part.kw_ords, part.kw_owners,
                torch.as_tensor(stack, device=part.device),
                nb_pad).cpu().numpy()
    except CircuitBreakingError:
        return None
    _span_family(plans, uniques, "plane_aggs_terms",
                 time.monotonic_ns() - t0)
    return [counts[i][: part.n_terms] for i in range(len(plans))]


def _dispatch_hist(part, plans, mask_by_ui, uniques
                   ) -> Optional[List[Tuple]]:
    """One histogram_partials_plane (K23) launch for every histogram plan
    over one field — per-plan base/interval ride as [P] vectors, so
    distinct intervals share the launch; n_buckets is the pow2-padded
    max over the batch (each plan reads back its own prefix)."""
    import torch

    from elasticsearch_tpu_torch.index.segment import next_pow2
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    from elasticsearch_tpu_torch.ops.aggs import (
        histogram_partials_plane, histogram_scratch_bytes,
    )
    from elasticsearch_tpu_torch.utils.errors import CircuitBreakingError
    stack = _stack_masks([ui for ui, *_ in plans], mask_by_ui,
                         part.n_docs_pad)
    p_pad = stack.shape[0]
    nb_pad = next_pow2(max(nb for *_x, nb in plans), minimum=8)
    bases = np.zeros(p_pad, np.int32)
    intervals = np.ones(p_pad, np.int32)   # padding rows: 1 avoids /0
    for i, (_ui, _spec, interval, base_div, _nb) in enumerate(plans):
        bases[i] = base_div
        intervals[i] = interval
    transient = 2 * stack.nbytes + p_pad * nb_pad * 4 * 4 + \
        histogram_scratch_bytes(part.values.shape[0], p_pad, nb_pad)
    trace0 = uniques[plans[0][0]].trace
    t0 = time.monotonic_ns()
    try:
        with telemetry.activate(trace0), \
                BREAKERS.breaker("request").limit_scope(
                    transient, "plane_aggs"):
            dev = part.device
            counts, sums, mins, maxs = (
                t.cpu().numpy() for t in histogram_partials_plane(
                    part.values, part.exists,
                    torch.as_tensor(stack, device=dev),
                    torch.as_tensor(bases, device=dev),
                    torch.as_tensor(intervals, device=dev), nb_pad))
    except CircuitBreakingError:
        return None
    _span_family(plans, uniques, "plane_aggs_histogram",
                 time.monotonic_ns() - t0)
    return [(counts[i][: plans[i][4]], sums[i][: plans[i][4]],
             mins[i][: plans[i][4]], maxs[i][: plans[i][4]])
            for i in range(len(plans))]


def _span_family(plans, uniques, name: str, dur_ns: int) -> None:
    """Every plan that shared the family dispatch carries the SAME span,
    annotated with the occupancy — the drain-span attribution discipline
    (batch_executor's shared device_dispatch precedent)."""
    seen = set()
    for plan in plans:
        ui = plan[0]
        if ui in seen:
            continue
        seen.add(ui)
        trace = uniques[ui].trace
        if trace is not None:
            trace.add_span(name, dur_ns, {"occupancy": len(plans)})
