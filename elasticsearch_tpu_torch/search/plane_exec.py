"""Shard-plane execution of the text, kNN and sparse classes: the whole
shard's postings (or vectors, or rank_features) in one device plane, one
kernel launch per phase.

The text, kNN and sparse parts of the JAX package's
``search/plane_exec.py``, and its mesh text, kNN and sparse executors.
Both the solo and the batched path call in here when a plane is resident,
so they share one implementation:

- ``plane_wand_topk``: Q text queries through the block-max-pruned BM25
  path in TWO launches for the whole shard (phase 1 theta, phase 2
  survivors) instead of two per segment; per-block avgdl keeps the
  per-segment length norms exact.
- ``_coarse_wand_topk``: the quantized two-tier path (bf16 coarse pass +
  exact f32 re-rank with an adaptive depth) that serves a solo query on a
  large plane first.
- ``plane_knn_winners``: Q kNN queries in ONE launch over the stacked
  vector plane -- the shard-level IVF probe for unfiltered members on an
  IVF-routed field (``plane_ann_route``), else the int8 coarse pass +
  exact re-rank (``_quantized_topk``, adaptive depth) first and the exact
  ``knn_flat`` otherwise, masked per member for filtered kNN -- with the
  per-segment demux reduced to a host-side offset translation.
- ``plane_sparse_topk``: Q resolved text_expansion queries in ONE launch
  over the stacked rank_features blocks (K15, with exact counts), or the
  bf16 coarse pass + exact re-rank (K16 + K17, ``_coarse_sparse_topk``)
  with the same adaptive depth.
- ``mesh_wand_topk``: Q text queries against S co-located shards' stacked
  postings planes (``MeshPlanePart``) in one launch per phase for all
  shards (``mesh_bm25_flat``, or ``mesh_bm25_coarse`` + ``mesh_bm25_rerank``
  on the tier), each shard's result the one ``plane_wand_topk`` gives.
- ``mesh_knn_winners``: Q kNN queries against S co-located shards' stacked
  vector planes in one launch per phase (``mesh_knn_topk``, or
  ``mesh_knn_coarse`` + ``mesh_knn_rerank`` on the tier), masked per
  (filter, shard) for differently filtered members, each shard's winners
  the ones its own plane gives.
- ``mesh_sparse_topk``: Q resolved text_expansion queries against S
  co-located shards' stacked rank_features planes in one launch per phase
  (``mesh_sparse_topk``, or ``mesh_sparse_coarse`` + ``mesh_sparse_rerank``
  on the tier), each shard's result the one ``plane_sparse_topk`` gives.

Callers treat a None result as "run the per-segment path".
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import next_pow2
from elasticsearch_tpu_torch.ops.bm25 import (
    KMAX, DEFAULT_B, DEFAULT_K1, P1_BUCKET, QueryPlan, dispatch_flat,
)
from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES, PLANES
from elasticsearch_tpu_torch.search import telemetry
from elasticsearch_tpu_torch.search.phase import ShardDoc


class PlaneFallback(Exception):
    """This batch cannot run on the plane (e.g. IVF-routed members whose
    num_candidates imply different probe widths); members take the
    per-segment path."""


def _coarse_attempt(cls: str, n_q: int, attempt: Callable[[], Any]):
    """Measured-latency engage rule shared by every coarse-tier class:
    the corpus-size gate decides whether coarse CAN engage; this decides
    whether it SHOULD, from the observed per-query serve latencies. When
    the coarse EWMA for this class runs decisively slower than the exact
    EWMA (re-rank escalations eating the bf16/int8 savings), the class
    disengages — counted ``quantized_disengaged_slow`` — and every 32nd
    query probes coarse again so a shifted workload can re-engage."""
    if not PLANES.quantized_engaged(cls):
        return None
    t0 = time.monotonic()
    got = attempt()
    if got is not None:
        PLANES.note_tier_latency(cls, "coarse",
                                 (time.monotonic() - t0) / max(n_q, 1))
    return got


def _note_exact(cls: str, n_q: int, t0: float) -> None:
    """The exact tier's side of the same comparison — recorded only while
    the quantized tier is configured on (with it off there is nothing to
    disengage), so both EWMAs describe the same workload."""
    if PLANES.quantized:
        PLANES.note_tier_latency(cls, "exact",
                                 (time.monotonic() - t0) / max(n_q, 1))


# ---------------------------------------------------------------------------
# adaptive re-rank depth: the margin rule shared by every coarse tier
# ---------------------------------------------------------------------------

# a-priori per-doc coarse error, relative to the coarse score. bf16
# classes: every contribution is a product/quotient chain of
# bf16-rounded operands (<= ~8 ulps ~ 0.031 relative) summed with f32
# accumulation over strictly positive terms, so 0.04 bounds ANY doc's
# deviation — included or excluded — and the margin below is a real
# proof for bm25/sparse. int8 kNN has no usable closed-form bound (it
# loosens with D and amax/rms), so 0.02 hardens the empirical estimate
# and the escalate-then-serve-exact backstop owns the tail.
REL_BF16 = 0.04
REL_INT8 = 0.02


def _margin_ok(s_k: float, c_cut: float, eps: float, rel: float) -> bool:
    """True when the coarse pass provably kept the true top-k.

    Any EXCLUDED doc's coarse score is <= ``c_cut`` (the k'-th coarse
    score), so its exact score is <= c_cut plus its coarse error. The
    error is bounded two ways at once: ``eps`` is the max observed
    |exact - coarse| among the re-ranked candidates (doubled for
    safety), and ``rel`` is the class's a-priori relative bound
    (REL_BF16 / REL_INT8). When the exact k-th score clears both, no
    excluded doc can enter the served top-k; when it cannot — including
    exact-score ties straddling the cut — the caller deepens k' and
    re-dispatches, bounded by ``search.plane.rerank_depth_max``, past
    which the EXACT path serves (typed fallback): golden parity is an
    invariant, not a tuning goal."""
    if not np.isfinite(c_cut):
        return True     # fewer matches than k': nothing was excluded
    if not np.isfinite(s_k):
        return False
    return (s_k - c_cut) > (2.0 * eps + rel * abs(c_cut) + 1e-6)


def _coarse_depth0(k: int, n_docs_pad: int) -> int:
    return min(max(int(PLANES.rerank_depth), k), n_docs_pad)


def _adaptive_depths(k: int, n_docs_pad: int):
    """Yield (kprime, is_last) re-rank depths for the adaptive loop:
    the configured starting depth, doubling per escalation up to
    ``search.plane.rerank_depth_max`` (or full plane coverage, where
    nothing can be excluded). Resuming the generator IS the escalation
    — it counts ``rerank_escalations`` — so every coarse tier shares
    one depth/bookkeeping discipline; the caller serves and breaks on
    a clean margin, and falls back to exact when ``is_last`` still
    cannot prove parity."""
    depth = _coarse_depth0(k, n_docs_pad)
    max_depth = max(int(PLANES.rerank_depth_max), depth)
    while True:
        kprime = min(depth, n_docs_pad)
        yield kprime, (kprime >= n_docs_pad or depth >= max_depth)
        PLANES.stats["rerank_escalations"] += 1
        depth = min(depth * 2, max_depth)


def _count_plane_quantized_fallback() -> None:
    PLANES.stats["quantized_exact_fallbacks"] += 1
    telemetry.TELEMETRY.count_fallback(telemetry.PLANE_QUANTIZED_FALLBACK)


def _reader_of(ctxs):
    return ctxs[0].reader


# ---------------------------------------------------------------------------
# text: block-max pruned BM25 over the postings plane
# ---------------------------------------------------------------------------

def _coarse_wand_topk(part, per_seg, has_terms, n_q: int, live,
                      eff_block_avgdl, k_plane: int, want: int,
                      track_limit: int, counts_on: bool,
                      check_members: Optional[Callable[[], None]],
                      counter: Optional[list]) -> Optional[List[Tuple]]:
    """The quantized two-tier text path: ONE bf16 coarse dispatch over
    the FULL (unpruned) plans — no WAND host planning, no theta sync, no
    recount — plus ONE exact f32 re-rank of the top-k' candidates, with
    the adaptive-depth margin loop. Totals come EXACT off the coarse
    pass's per-segment counts (both the counts-then-skip and the
    totals-disabled contracts), so no mode needs a second counting
    dispatch. Returns plane_wand_topk's per-member tuples, or None when
    the exact phases must serve (corpus below the engage threshold,
    batch too large for one dispatch, mirror refused, margin exhausted
    — the latter two typed plane_quantized_fallback)."""
    from elasticsearch_tpu_torch.ops.bm25 import (
        MAX_BATCH_CELLS, MAX_CHUNK_Q, bm25_coarse, bm25_rerank,
        flatten_plans, qb_bucket,
    )
    depth0 = _coarse_depth0(k_plane, part.n_docs_pad)
    if part.n_docs_total <= 4 * depth0:
        return None
    offsets = [bb for _c, _p, bb in per_seg]
    rows = [QueryPlan.concat([p[qi] for _c, p, _bb in per_seg],
                             idx_offsets=offsets) for qi in range(n_q)]
    cells = sum(p.n_blocks for p in rows)
    if n_q > MAX_CHUNK_Q or cells > MAX_BATCH_CELLS:
        return None     # chunked batches keep the exact phased path
    mirror = part.quantized_mirror()
    if mirror is None:
        _count_plane_quantized_fallback()
        return None
    tf16, dl16 = mirror
    n_q_pad = next_pow2(max(n_q, 1), minimum=1)
    fb = qb_bucket(max(cells, 1))
    idx, w, qid = flatten_plans(rows, fb)
    flat_avg = eff_block_avgdl[idx].astype(np.float32)
    dev = part.device
    idx_dev = torch.as_tensor(idx, device=dev)
    w_dev = torch.as_tensor(w, device=dev)
    qid_dev = torch.as_tensor(qid, device=dev)
    favg_dev = torch.as_tensor(flat_avg, device=dev)
    seg_ids = part.seg_ids()
    n_segs = len(part.segments)
    blocks_total = [rows[qi].n_blocks for qi in range(n_q)]

    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    for kprime, last in _adaptive_depths(k_plane, part.n_docs_pad):
        if kprime > KMAX:
            # the coarse and re-rank kernels hold k' <= KMAX candidates a
            # row; a wider window is served exact (K1 / K15 with the wide
            # selection), as the kNN tier does
            _count_plane_quantized_fallback()
            return None
        if check_members is not None:
            check_members()
        if counter is not None:
            counter.extend((1, 1))
        # coarse plane (f32 accumulator) + candidate plane temporaries
        transient = 8 * part.n_docs_pad * n_q_pad
        with BREAKERS.breaker("request").limit_scope(
                transient, "plane_coarse_wand"):
            cs, cand, hits = bm25_coarse(
                part.block_docs, tf16, idx_dev, w_dev, qid_dev, dl16,
                favg_dev, live, seg_ids, part.n_docs_pad, n_q_pad,
                n_segs, kprime, k1=DEFAULT_K1, b=DEFAULT_B)
            s, d, eps = bm25_rerank(
                part.block_docs, part.block_tfs, idx_dev, w_dev,
                qid_dev, part.doc_lens, favg_dev, live, cand, cs,
                part.n_docs_pad, n_q_pad, kprime, k_plane,
                k1=DEFAULT_K1, b=DEFAULT_B)
        cs_h = cs.cpu().numpy()
        s_h = s.cpu().numpy()
        eps_h = eps.cpu().numpy()
        k_last = min(k_plane, s_h.shape[1]) - 1
        if all(_margin_ok(float(s_h[qi, k_last]),
                          float(cs_h[qi, kprime - 1]),
                          float(eps_h[qi]), REL_BF16)
               for qi in range(n_q) if has_terms[qi]):
            break
        if last:
            _count_plane_quantized_fallback()
            return None

    hits_h = hits.cpu().numpy()
    d_h = d.cpu().numpy()
    PLANES.note_quantized(kprime, sum(1 for qi in range(n_q)
                                      if has_terms[qi]))
    empty = ([], 0, "eq", None, (0, 0))
    out: List[Tuple] = []
    for qi in range(n_q):
        if not has_terms[qi]:
            out.append(empty)
            continue
        s_row, d_row = s_h[qi], d_h[qi]
        finite = s_row != -np.inf
        si, local = part.demux(d_row[finite])
        candidates = [ShardDoc(int(a), int(b), float(sc), (float(sc),))
                      for a, b, sc in zip(si, local, s_row[finite])]
        candidates.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        max_score = max((c.score for c in candidates), default=None)
        # every block was gathered (twice — once per tier): no pruning
        prune = (blocks_total[qi], blocks_total[qi])
        h_row = hits_h[qi]
        if not counts_on:
            # totals disabled: the per-segment clipped contract, read
            # off the coarse pass's exact per-segment counts
            total = int(np.minimum(h_row, want).sum())
            out.append((candidates, total, "gte", max_score, prune))
            continue
        hits_all = int(h_row.sum())
        if hits_all >= track_limit:
            out.append((candidates, track_limit, "gte", max_score,
                        prune))
        else:
            out.append((candidates, hits_all, "eq", max_score, prune))
    return out


def plane_wand_topk(ctxs, part, field: str,
                    clause_lists: List[List[Tuple[str, float]]],
                    want: int, track_limit: int,
                    check_members: Optional[Callable[[], None]] = None,
                    counter: Optional[list] = None) -> Optional[List[Tuple]]:
    """Q queries through the pruned BM25 path with the whole shard's
    postings in one block store. Member-for-member identical semantics to
    the per-segment loops (scores, candidates, counts-then-skip totals);
    per-member theta comes from that member's own phase-1 partials over
    ALL segments at once, so segments prune each other exactly as the
    shard-global theta barrier did — without the per-segment dispatches.

    Returns per member (candidates, hits, relation, max_score,
    (blocks_total, blocks_scored)).

    Totals-disabled requests (track_limit <= 0) are served too: the
    per-segment contract reports "candidates found" with PER-SEGMENT
    truncation (sum of min(matches, want) per segment), which the fused
    top-k cannot reproduce from a whole-plane count — so the final
    scoring dispatch counts per segment (``part.seg_ids`` channel) and
    the host clips each segment's count at the collection window.

    DFS-normed requests (a corpus-wide avgdl override) are served by the
    second normalization channel: per-doc lengths live on the plane, the
    per-block avgdl rides the dispatch as a kernel argument — an
    override simply replaces the baked per-segment values with the
    corpus-wide one, for plan upper bounds AND the length norm alike."""
    from elasticsearch_tpu_torch.search.execute import _bm25_planner
    telemetry.mark_plane_served()
    counts_on = track_limit > 0
    n_q = len(clause_lists)
    reader = _reader_of(ctxs)

    avgdl_override = None
    per_seg = []        # (ctx, plans[n_q], block_base)
    seen_terms: List[Dict[str, float]] = [{} for _ in range(n_q)]
    has_terms = [False] * n_q
    for pos, pf, block_base, avgdl in part.refs:
        ctx = ctxs[pos]
        override = ctx.avgdl_for(field)
        if override is not None:
            # DFS-normed: every segment norms against the corpus-wide
            # avgdl (it is per-request per-field, so one value for all)
            avgdl_override = float(override)
            avgdl = avgdl_override
        analyzer = ctx.search_analyzer(field)
        ex = _bm25_planner(ctx, field)
        if ex is None:
            continue
        df_map = ctx.df_for(field) or {}
        member_terms: List[List[Tuple[str, float]]] = []
        any_terms = False
        for qi, clauses in enumerate(clause_lists):
            terms: List[Tuple[str, float]] = []
            for text, boost in clauses:
                terms.extend((t, boost) for t in analyzer.terms(text))
            member_terms.append(terms)
            if terms:
                any_terms = True
                has_terms[qi] = True
                for t, _b in terms:
                    if t not in seen_terms[qi]:
                        seen_terms[qi][t] = float(df_map.get(t, 0))
        if not any_terms:
            continue
        plans = ex.build_plans(member_terms, df_override=df_map or None,
                               avgdl=avgdl)
        per_seg.append((ctx, plans, block_base))

    empty = ([], 0, "eq", None, (0, 0))
    if not per_seg:
        return [empty] * n_q

    live = part.live_mask(reader.live_masks)
    k_plane = min(max(want, 1), part.n_docs_pad)
    empty_plan = QueryPlan([], [], [], [])

    hits_upper = [int(sum(s.values())) for s in seen_terms]
    exact_mode = [counts_on and hits_upper[qi] <= track_limit
                  for qi in range(n_q)]
    # the second normalization channel: per-block avgdl is a DISPATCH
    # argument, so a DFS override replaces the baked per-segment values
    eff_block_avgdl = part.block_avgdl if avgdl_override is None else \
        np.full_like(part.block_avgdl, avgdl_override)

    # quantized coarse tier (search.plane.quantized): bf16 coarse pass
    # over the full plans + exact f32 re-rank with adaptive depth — the
    # kNN two-tier pattern generalized to the scatter-bound text class;
    # None = serve the exact phased path below (typed when it is a
    # fallback rather than a sizing decision)
    if PLANES.quantized:
        got = _coarse_attempt("bm25", n_q, lambda: _coarse_wand_topk(
            part, per_seg, has_terms, n_q, live, eff_block_avgdl,
            k_plane, want, track_limit, counts_on, check_members,
            counter))
        if got is not None:
            return got
    t_exact = time.monotonic()

    def _dispatch(rows, k, counted, count_segments=None):
        if check_members is not None:
            check_members()
        # the scatter materializes a [chunk_q, n_docs_pad] f32 score
        # plane sized to the WHOLE shard — charge the request breaker for
        # it (score plane + top-k temporaries) so an over-budget plane
        # dispatch 429s instead of OOMing the chip
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS
        from elasticsearch_tpu_torch.ops.bm25 import MAX_CHUNK_Q
        transient = 8 * part.n_docs_pad * min(max(len(rows), 1),
                                              MAX_CHUNK_Q)
        with BREAKERS.breaker("request").limit_scope(
                transient, "plane_wand_topk"):
            return dispatch_flat(part.block_docs, part.block_tfs,
                                 part.doc_lens, part.n_docs_pad, rows,
                                 live, k, DEFAULT_K1, DEFAULT_B,
                                 block_avgdl=eff_block_avgdl,
                                 counted=counted, counter=counter,
                                 count_segments=count_segments)

    # phase A — ONE dispatch for the whole shard: exact-mode members score
    # every block (counted; final), pruned members their per-segment
    # P1_BUCKET highest-upper-bound blocks (the same block set the
    # per-segment path's phase 1 gathers)
    rows_a = []
    for qi in range(n_q):
        segs = [p[qi] if exact_mode[qi] else p[qi].top_by_ub(P1_BUCKET)
                for _ctx, p, _bb in per_seg]
        rows_a.append(QueryPlan.concat(
            segs, idx_offsets=[bb for _c, _p, bb in per_seg]))
    counted_a = any(exact_mode)
    got_a = _dispatch(rows_a, k_plane, counted_a)
    if counted_a:
        s_a, d_a, h_a = got_a
    else:
        s_a, d_a = got_a
        h_a = None
    s_a_host = np.asarray(s_a)

    theta = np.full(n_q, -np.inf)
    for qi in range(n_q):
        if exact_mode[qi]:
            continue
        finite = s_a_host[qi][np.isfinite(s_a_host[qi])]
        if len(finite) >= want:
            theta[qi] = float(np.sort(finite)[-want])

    # phase B — ONE dispatch: pruned members' WAND survivors scored
    # exactly (+ counted); exact members ride as empty rows. In
    # totals-disabled mode the dispatch counts PER SEGMENT so the host
    # can reproduce the per-segment truncated "candidates found" totals.
    blocks_total = [0] * n_q
    blocks_scored = [0] * n_q
    hits_exact = [True] * n_q
    need_b = not all(exact_mode)
    rows_b = []
    for qi in range(n_q):
        segs = []
        for _ctx, plans, _bb in per_seg:
            p = plans[qi]
            if exact_mode[qi]:
                blocks_total[qi] += p.n_blocks
                blocks_scored[qi] += p.n_blocks
                segs.append(empty_plan)
                continue
            surv = p.survivors(float(theta[qi]))
            p1_cost = min(p.n_blocks, P1_BUCKET)
            blocks_total[qi] += p.n_blocks
            blocks_scored[qi] += min(surv.n_blocks + p1_cost, p.n_blocks)
            hits_exact[qi] = hits_exact[qi] and surv.n_blocks >= p.n_blocks
            segs.append(surv)
        rows_b.append(QueryPlan.concat(
            segs, idx_offsets=[bb for _c, _p, bb in per_seg]))
    if need_b:
        if counts_on:
            s_b, d_b, h_b = _dispatch(rows_b, k_plane, True)
        else:
            s_b, d_b, h_b = _dispatch(
                rows_b, k_plane, False,
                count_segments=(part.seg_ids(), len(part.segments)))
    else:
        s_b = d_b = h_b = None

    out: List[Tuple] = []
    for qi in range(n_q):
        if not has_terms[qi]:
            out.append(empty)
            continue
        if exact_mode[qi]:
            s_row, d_row = np.asarray(s_a)[qi], np.asarray(d_a)[qi]
            hits_seen = int(np.asarray(h_a)[qi]) if h_a is not None else 0
        else:
            s_row, d_row = np.asarray(s_b)[qi], np.asarray(d_b)[qi]
            hits_seen = (int(np.asarray(h_b)[qi].sum())
                         if h_b is not None else 0)
        finite = s_row != -np.inf
        si, local = part.demux(d_row[finite])
        candidates = [ShardDoc(int(s_i), int(d_i), float(sc), (float(sc),))
                      for s_i, d_i, sc in zip(si, local, s_row[finite])]
        candidates.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        max_score = max((c.score for c in candidates), default=None)
        prune = (blocks_total[qi], blocks_scored[qi])
        if not counts_on:
            # totals disabled: per-segment "candidates found", each
            # segment's observed matches truncated at the collection
            # window — sum of min(matches, want) per segment, exactly
            # the per-segment path's len(candidates)
            h_row = np.asarray(h_b)[qi]
            total = int(np.minimum(h_row, want).sum())
            out.append((candidates, total, "gte", max_score, prune))
        elif hits_seen >= track_limit:
            out.append((candidates, track_limit, "gte", max_score, prune))
        elif hits_exact[qi] or exact_mode[qi]:
            out.append((candidates, hits_seen, "eq", max_score, prune))
        else:
            out.append((candidates, None, None, max_score, prune))

    # members whose pruned counts might hide hits: one exact unpruned
    # counted pass (k=1; scores already final) — still ONE dispatch
    recount = [qi for qi in range(n_q) if counts_on and out[qi][1] is None]
    if recount:
        rows_r = []
        for qi in range(n_q):
            if qi in recount:
                rows_r.append(QueryPlan.concat(
                    [p[qi] for _c, p, _bb in per_seg],
                    idx_offsets=[bb for _c, _p, bb in per_seg]))
            else:
                rows_r.append(empty_plan)
        _s, _d, h_r = _dispatch(rows_r, 1, True)
        h_r = np.asarray(h_r)
        for qi in recount:
            candidates, _, _, max_score, prune = out[qi]
            exact_hits = int(h_r[qi])
            # >= so the relation at count == track_limit is "gte" on
            # EVERY path — exact-mode and observed-full members already
            # report "gte" there, and the quantized coarse tier (exact
            # counts, no pruning visibility) must be byte-identical to
            # whichever branch the exact path would have taken
            if exact_hits >= track_limit:
                out[qi] = (candidates, track_limit, "gte", max_score,
                           prune)
            else:
                out[qi] = (candidates, exact_hits, "eq", max_score, prune)
    _note_exact("bm25", n_q, t_exact)
    return out


# ---------------------------------------------------------------------------
# kNN: one launch over the vector plane
# ---------------------------------------------------------------------------

def plane_ann_route(ctx0, part, field: str, k: int,
                    num_candidates: int) -> Optional[Tuple]:
    """Shard-level IVF routing over the plane -- the plane analog of
    execute.ann_segment_route, shared by the solo kNN rewrite and the
    batched executor so their ANN results are identical by construction.
    None = exact plane path; else (index, rows, oversample, nprobe) with
    index None when the field holds no vectors at all."""
    from elasticsearch_tpu_torch.search.execute import ANN_DEFAULT_MIN_DOCS
    mapper = ctx0.mappers.mapper(field)
    opts = getattr(mapper, "index_options", None) or {}
    wants_ivf = opts.get("type") == "ivf"
    if opts.get("type") not in (None, "ivf"):
        return None
    if not wants_ivf:
        # auto-sizing must agree with the per-segment fallback's routing
        # decision, or plane residency would silently flip EXACT results
        # to approximate ones: take the shard-level IVF only when every
        # vector-bearing segment would take the per-segment IVF anyway
        sizes = [s.n_docs for s in part.segments
                 if s.vectors.get(field) is not None]
        if not sizes or min(sizes) < ANN_DEFAULT_MIN_DOCS:
            return None
    from elasticsearch_tpu_torch.utils.errors import CircuitBreakingError
    try:
        index, rows = part.ivf_index(opts.get("nlist"))
    except CircuitBreakingError:
        # over budget: the exact plane path serves
        telemetry.TELEMETRY.count_fallback(
            telemetry.PLANE_IVF_BREAKER_REFUSED)
        return None
    if index is None:
        return (None, rows, 0, 0)
    oversample = min(max(2 * k, k + 16), len(rows))
    nprobe = opts.get("nprobe") or max(
        1, int(np.ceil(num_candidates / max(index.list_len, 1))))
    return (index, rows, oversample, nprobe)


def _live_host(reader) -> np.ndarray:
    return np.concatenate([np.asarray(m) for m in reader.live_masks]) \
        if reader.live_masks else np.zeros(0, bool)


def _probe_plane(index, queries: np.ndarray, k: int, nprobe: int,
                 rows: np.ndarray, live_host: np.ndarray, part,
                 oversample: int) -> List[List[Tuple[int, int, float]]]:
    """Batched shard-IVF probe + the host-side demux: list-row ids map to
    plane docs through ``rows``, deleted docs drop out post-probe, plane
    docs translate to (segment_idx, local_doc) through the base offsets."""
    scores, ids = index.search(np.asarray(queries, np.float32),
                               oversample, nprobe=nprobe)
    out = []
    for qi in range(scores.shape[0]):
        valid = ids[qi] >= 0
        docs = rows[ids[qi][valid]]
        alive = (docs < len(live_host)) & live_host[
            np.minimum(docs, max(len(live_host) - 1, 0))]
        docs, kept = docs[alive], scores[qi][valid][alive]
        si, local = part.demux(docs)       # one vectorized demux per query
        hits = [(int(a), int(b), float(s))
                for a, b, s in zip(si[:k], local[:k], kept[:k])]
        out.append(hits)
    return out


def _filter_mask_rows(ctxs, part, specs, exact_idx) -> Tuple[Any, bool]:
    """Per-member plane filter masks: each DISTINCT filter executes once
    per segment (the solo path's filter-context mask builders) and its
    per-segment masks stack into plane doc space. Returns (masks, shared):
    masks None (no filters), a [N_pad] bool tensor on the plane's device
    (every member agrees -- the autocomplete / faceted-nav shape), or a
    [B, N_pad] numpy stack."""
    from elasticsearch_tpu_torch.search.execute import execute as execute_query
    fkeys = {specs[qi].filter_key for qi in exact_idx}
    if fkeys == {None}:
        return None, False
    by_key: Dict[Optional[str], np.ndarray] = {}
    for qi in exact_idx:
        s_qi = specs[qi]
        if s_qi.filter is None or s_qi.filter_key in by_key:
            continue
        row = np.zeros(part.n_docs_pad, bool)
        for pos, ctx in enumerate(ctxs):
            _, fmask = execute_query(s_qi.filter, ctx)
            base = int(part.doc_base[pos])
            n = ctx.segment.n_docs
            row[base: base + n] = fmask.cpu().numpy()[:n]
        by_key[s_qi.filter_key] = row
    if len(fkeys) == 1:
        return torch.as_tensor(by_key[next(iter(fkeys))],
                               device=part.device), True
    rows = np.ones((len(exact_idx), part.n_docs_pad), bool)
    for r, qi in enumerate(exact_idx):
        fk = specs[qi].filter_key
        if fk is not None:
            rows[r] = by_key[fk]
    return rows, False


def _quantized_topk(part, vectors: np.ndarray, live, masks, k: int):
    """int8 coarse pass over the full plane + exact re-rank of the top-k'
    candidates, with ADAPTIVE depth: the margin at position k' (via the
    re-rank's observed coarse error) must prove the true top-k survived,
    else the pass deepens x2 and re-launches up to
    ``search.plane.rerank_depth_max`` (and the kernels' KMAX), past which
    None is returned and the exact path serves (typed
    plane_quantized_fallback). Also None when the quantized mirror is
    unavailable (breaker) or the corpus is too small for the coarse pass
    to pay. ``masks`` is None, a shared [N_pad] filter mask (folded into
    ``allowed``) or a [B, N_pad] per-member stack (the masked launches)."""
    from elasticsearch_tpu_torch.ops.knn import (
        KMAX, QueryBatch, knn_coarse_candidates,
        knn_coarse_candidates_masked, knn_rerank_exact,
        knn_rerank_exact_masked, pad_mask_rows_pow2,
    )
    depth0 = _coarse_depth0(k, part.n_docs_pad)
    if part.n_docs_total <= 4 * depth0:
        return None         # coarse+rerank would cost more than exact
    mirror = part.quantized_mirror()
    if mirror is None:
        _count_plane_quantized_fallback()
        return None
    q8, scales = mirror
    batch = QueryBatch(vectors, part.device)
    n_real = batch.n_real
    allowed = live & part.exists
    m_dev = None
    if masks is not None and getattr(masks, "ndim", 1) == 2:
        m_dev = torch.as_tensor(
            pad_mask_rows_pow2(masks, batch.queries.shape[0]),
            device=part.device)
    elif masks is not None:
        allowed = allowed & masks       # shared filter mask
    for kprime, last in _adaptive_depths(k, part.n_docs_pad):
        if kprime > KMAX:
            _count_plane_quantized_fallback()
            return None
        if m_dev is not None:
            cs, cand = knn_coarse_candidates_masked(
                q8, scales, part.norms, allowed, batch, m_dev, kprime,
                part.similarity)
            s, d, eps = knn_rerank_exact_masked(
                part.matrix, part.norms, allowed, batch, cand, cs, m_dev,
                k, part.similarity)
        else:
            cs, cand = knn_coarse_candidates(q8, scales, part.norms,
                                             allowed, batch, kprime,
                                             part.similarity)
            s, d, eps = knn_rerank_exact(part.matrix, part.norms, allowed,
                                         batch, cand, cs, k,
                                         part.similarity)
        cs_h = cs.cpu().numpy()
        s_h = s.cpu().numpy()
        eps_h = eps.cpu().numpy()
        k_last = min(k, s_h.shape[1]) - 1
        if all(_margin_ok(float(s_h[row, k_last]),
                          float(cs_h[row, kprime - 1]),
                          float(eps_h[row]), REL_INT8)
               for row in range(n_real)):
            PLANES.note_quantized(kprime, n_real)
            return s[:n_real], d[:n_real]
        if last:
            _count_plane_quantized_fallback()
            return None


def plane_knn_winners(ctxs, part, field: str, specs, k: int,
                      check_members: Optional[Callable[[], None]] = None,
                      stats: Optional[Dict[str, float]] = None
                      ) -> List[List[Tuple[int, int, float]]]:
    """Q kNN queries over the vector plane. ``specs`` need query_vector /
    filter / filter_key / num_candidates attributes (the batch executor's
    BatchSpec, or the solo rewrite's one-element shim). Returns one
    [(segment_idx, local_doc, raw_score)] winner list (len <= k, score
    order) per member -- exactly what the per-segment merge produces.

    Unfiltered members on an IVF-routed field share one shard-IVF probe
    (K14); the rest share one exact launch (the int8 coarse pass +
    re-rank first, knn_flat otherwise), masked per member when their
    filters differ. Raises PlaneFallback when IVF-routed members disagree
    on the implied probe width (mirrors the per-segment batch rule)."""
    from elasticsearch_tpu_torch.ops.knn import KnnExecutor
    telemetry.mark_plane_served()
    reader = _reader_of(ctxs)
    n_q = len(specs)
    vectors = np.asarray([s.query_vector for s in specs], np.float32)
    winners: List[List[Tuple[int, int, float]]] = [[] for _ in range(n_q)]
    unfiltered = [qi for qi in range(n_q) if specs[qi].filter is None]

    route = None
    if unfiltered:
        route = plane_ann_route(ctxs[0], part, field, k,
                                specs[unfiltered[0]].num_candidates)
    if route is not None:
        index, rows, oversample, nprobe = route
        distinct_nc = {specs[qi].num_candidates for qi in unfiltered}
        if index is not None and len(distinct_nc) > 1:
            widths = {plane_ann_route(ctxs[0], part, field, k, nc)[3]
                      for nc in distinct_nc}
            if len(widths) > 1:
                telemetry.TELEMETRY.count_fallback(
                    telemetry.PLANE_IVF_NPROBE_DISAGREEMENT)
                raise PlaneFallback(
                    "IVF-routed members' num_candidates imply different "
                    "nprobe")
        if index is not None:
            if check_members is not None:
                check_members()
            probed = _probe_plane(index, vectors[unfiltered], k, nprobe,
                                  rows, _live_host(reader), part,
                                  oversample)
            for qi, hits in zip(unfiltered, probed):
                winners[qi] = hits
        exact_idx = [qi for qi in range(n_q)
                     if specs[qi].filter is not None]
    else:
        exact_idx = list(range(n_q))

    if exact_idx:
        if check_members is not None:
            check_members()
        live = part.live_mask(reader.live_masks)
        masks, shared = _filter_mask_rows(ctxs, part, specs, exact_idx)
        if shared and stats is not None:
            stats["knn_shared_mask_segments"] = \
                stats.get("knn_shared_mask_segments", 0) + 1
        k_plane = min(k, part.n_docs_pad)
        # the launch writes a [B, n_docs_pad] f32 score plane over the
        # whole shard: charge the request breaker before it
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS
        transient = 8 * part.n_docs_pad * len(exact_idx)
        with BREAKERS.breaker("request").limit_scope(
                transient, "plane_knn"):
            got = None
            if PLANES.quantized:
                got = _coarse_attempt(
                    "knn", len(exact_idx),
                    lambda: _quantized_topk(part, vectors[exact_idx],
                                            live, masks, k_plane))
            if got is None:
                t_exact = time.monotonic()
                got = KnnExecutor(part).top_k_batch(
                    vectors[exact_idx], live, k_plane, masks)
                _note_exact("knn", len(exact_idx), t_exact)
        s, d = got[0].cpu().numpy(), got[1].cpu().numpy()
        for row, qi in enumerate(exact_idx):
            finite = (s[row] > -np.inf) & (d[row] >= 0)
            si, local = part.demux(d[row][finite])
            winners[qi] = [(int(a), int(b), float(sc)) for a, b, sc in
                           zip(si, local, s[row][finite])]
    for qi in range(n_q):
        winners[qi].sort(key=lambda x: -x[2])
        winners[qi] = winners[qi][:k]
    return winners


# ---------------------------------------------------------------------------
# sparse: one gather/scatter over the rank_features plane
# ---------------------------------------------------------------------------

def plane_sparse_topk(ctxs, part, field: str,
                      expansions: List[List[Tuple[str, float]]],
                      want: int,
                      check_members: Optional[Callable[[], None]] = None,
                      counter: Optional[list] = None) -> List[Tuple]:
    """Q resolved expansions scored over the stacked feature blocks in
    ONE launch (K15), exact per-member match counts off the score plane
    -- or, with the quantized tier on, the bf16 coarse pass (K16) and the
    exact re-rank (K17). Returns per member (candidates, total,
    max_score)."""
    from elasticsearch_tpu_torch.ops.sparse import (
        pad_query_rows, sparse_topk_batch,
    )
    telemetry.mark_plane_served()
    reader = _reader_of(ctxs)
    live = part.live_mask(reader.live_masks)
    per = [_expansion_blocks(part.refs, e) for e in expansions]
    idx, w, n_real = pad_query_rows(per, part.device)
    q_n = idx.shape[0]
    k_plane = min(max(want, 1), part.n_docs_pad)

    # quantized coarse tier: bf16 coarse gather/scatter + exact f32
    # re-rank with adaptive depth (the text/kNN pattern on the
    # rank_features class); None = exact single-launch path below
    if PLANES.quantized:
        got = _coarse_attempt("sparse", n_real, lambda: _coarse_sparse_topk(
            part, idx, w, live, k_plane, n_real, check_members, counter))
        if got is not None:
            s, d, h = got
            return _sparse_demux(part, s, d, h, n_real)

    if check_members is not None:
        check_members()
    if counter is not None:
        counter.append(1)
    t_exact = time.monotonic()
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    with BREAKERS.breaker("request").limit_scope(
            8 * part.n_docs_pad * q_n, "plane_sparse"):
        s, d, h = sparse_topk_batch(
            part.block_docs, part.block_weights, idx, w, 1.0, 1.0, live,
            part.n_docs_pad, k_plane, "linear", counted=True)
    s, d, h = s.cpu().numpy(), d.cpu().numpy(), h.cpu().numpy()
    _note_exact("sparse", n_real, t_exact)
    return _sparse_demux(part, s, d, h, n_real)


def _expansion_blocks(refs, expansion) -> Tuple[np.ndarray, np.ndarray]:
    """One expansion's block list over a features plane's segments
    (``refs``: (segment position, FeaturesField, block base)): every
    listed feature's blocks, rebased into the plane's block store, and
    the feature's query weight for each."""
    idx_parts, w_parts = [], []
    for _pos, ff, block_base in refs:
        for name, weight in expansion:
            t_idx = ff.feature_block_idx(name)
            if len(t_idx):
                idx_parts.append(t_idx + np.int32(block_base))
                w_parts.append(np.full(len(t_idx), weight, np.float32))
    if not idx_parts:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    return np.concatenate(idx_parts), np.concatenate(w_parts)


def _sparse_demux(part, s: np.ndarray, d: np.ndarray, h: np.ndarray,
                  n_real: int) -> List[Tuple]:
    """(candidates, total, max_score) per member from the score/doc/hit
    planes — shared by the exact and coarse-tier sparse paths so the
    result shape cannot diverge."""
    out: List[Tuple] = []
    for qi in range(n_real):
        finite = s[qi] != -np.inf
        si, local = part.demux(d[qi][finite])
        cands = [ShardDoc(int(a), int(b), float(sc), (float(sc),))
                 for a, b, sc in zip(si, local, s[qi][finite])]
        cands.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        max_score = max((c.score for c in cands), default=None)
        out.append((cands, int(h[qi]), max_score))
    return out


def _coarse_sparse_topk(part, idx, w, live, k_plane: int, n_real: int,
                        check_members: Optional[Callable[[], None]],
                        counter: Optional[list]):
    """Adaptive coarse+re-rank for the sparse plane: returns host
    (scores, docs, hits) arrays shaped like the exact launch (hits EXACT
    off the coarse pass), or None when the exact path must serve (engage
    threshold, mirror refused, margin exhausted)."""
    from elasticsearch_tpu_torch.ops.sparse import (
        sparse_coarse_kernel, sparse_rerank_kernel,
    )
    depth0 = _coarse_depth0(k_plane, part.n_docs_pad)
    if part.n_docs_total <= 4 * depth0:
        return None
    mirror = part.quantized_mirror()
    if mirror is None:
        _count_plane_quantized_fallback()
        return None
    q_n = idx.shape[0]
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    for kprime, last in _adaptive_depths(k_plane, part.n_docs_pad):
        if kprime > KMAX:
            # the coarse and re-rank kernels hold k' <= KMAX candidates a
            # row; a wider window is served exact (K1 / K15 with the wide
            # selection), as the kNN tier does
            _count_plane_quantized_fallback()
            return None
        if check_members is not None:
            check_members()
        if counter is not None:
            counter.extend((1, 1))
        with BREAKERS.breaker("request").limit_scope(
                8 * part.n_docs_pad * q_n, "plane_coarse_sparse"):
            cs, cand, hits = sparse_coarse_kernel(
                part.block_docs, mirror, idx, w, live, part.n_docs_pad,
                kprime)
            s, d, eps = sparse_rerank_kernel(
                part.block_docs, part.block_weights, idx, w, live, cand, cs,
                part.n_docs_pad, kprime, k_plane)
        cs_h = cs.cpu().numpy()
        s_h = s.cpu().numpy()
        eps_h = eps.cpu().numpy()
        k_last = min(k_plane, s_h.shape[1]) - 1
        if all(_margin_ok(float(s_h[qi, k_last]),
                          float(cs_h[qi, kprime - 1]),
                          float(eps_h[qi]), REL_BF16)
               for qi in range(n_real)):
            PLANES.note_quantized(kprime, n_real)
            return s_h, d.cpu().numpy(), hits.cpu().numpy()
        if last:
            _count_plane_quantized_fallback()
            return None


# ---------------------------------------------------------------------------
# mesh-sharded plane executor: ONE launch per phase for a whole co-located
# fan-out (ops/device_segment.py MeshPlanePart, slots on the node's device)
# ---------------------------------------------------------------------------

class MeshFallback(Exception):
    """This fan-out cannot run on the mesh; the caller runs the per-shard
    RPC fan-out. ``reason`` is the telemetry taxonomy constant the
    executor counts."""

    def __init__(self, msg: str, reason: Optional[str] = None):
        super().__init__(msg)
        self.reason = reason or telemetry.MESH_IVF_ROUTED


def _count_mesh_quantized_fallback() -> None:
    MESH_PLANES.stats["mesh_quantized_fallbacks"] += 1
    telemetry.TELEMETRY.count_fallback(telemetry.MESH_QUANTIZED_FALLBACK)


def _mesh_engages(subs, k: int) -> Optional[bool]:
    """Whether the quantized coarse tier engages for a mesh fan-out:
    True only when EVERY populated slot clears the per-shard engage
    threshold — the same sizing rule the per-shard plane applies — so
    the mesh and the RPC fan-out pick the same tier shard-for-shard.
    None = slots disagree (only the per-shard path can serve each shard
    its own tier)."""
    votes = [s.n_docs_total > 4 * _coarse_depth0(k, s.n_docs_pad)
             for s in subs if s is not None]
    if not votes or not any(votes):
        return False
    if all(votes):
        return True
    return None


def _shard_readers(shard_ctxs):
    return [ctxs[0].reader if ctxs else None for ctxs in shard_ctxs]


def _mesh_live(mpart, shard_ctxs) -> np.ndarray:
    """Reader-snapshot live masks per slot, in each sub's plane doc
    layout (padding slots and padding docs stay False) — built per
    fan-out, like the single-shard plane's ``live_mask``, so deletes
    never invalidate the mesh plane itself."""
    out = np.zeros((mpart.n_slots, mpart.n_docs_pad), bool)
    for i, reader in enumerate(_shard_readers(shard_ctxs)):
        if reader is None:
            continue
        off = 0
        for m in reader.live_masks:
            out[i, off: off + len(m)] = np.asarray(m)
            off += len(m)
    return out


def _mesh_row(sub, s_row, d_row):
    """One (shard, member) row of mesh output -> sorted candidates and
    max score, through the shard's own demux."""
    finite = s_row != -np.inf
    seg, local = sub.demux(d_row[finite])
    cands = [ShardDoc(int(a), int(b), float(sc), (float(sc),))
             for a, b, sc in zip(seg, local, s_row[finite])]
    cands.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
    return cands, max((c.score for c in cands), default=None)


def mesh_wand_topk(shard_ctxs, mpart, field: str,
                   clause_lists: List[List[Tuple[str, float]]],
                   want: int, track_limit: int,
                   check_members: Optional[Callable[[], None]] = None,
                   counter: Optional[list] = None
                   ) -> Optional[List[List[Tuple]]]:
    """Q text queries against S co-located shards' postings planes in
    TWO mesh launches (phase-A theta, phase-B survivors) plus at most one
    recount — per SHARD semantics identical to plane_wand_topk / the
    per-segment loops, so the coordinator merge over the synthesized
    per-shard results equals the RPC fan-out's.

    Returns [shard][member] (candidates, hits, relation, max_score,
    (blocks_total, blocks_scored)).

    DFS-normed fan-outs (coordinator df/avgdl overrides) are served on
    the mesh too, the plane_wand_topk discipline: df overrides flow
    through each segment's planner, the corpus-wide avgdl replaces the
    baked per-block values in the flat launch argument."""
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    from elasticsearch_tpu_torch.ops.bm25 import flatten_plans, qb_bucket
    from elasticsearch_tpu_torch.parallel.mesh import mesh_bm25_flat
    from elasticsearch_tpu_torch.search.execute import _bm25_planner

    counts_on = track_limit > 0
    n_q = len(clause_lists)
    n_sh = mpart.n_shards
    dev = mpart.device
    # the flat gather stacks split over dp (each row scores its own
    # contiguous slice of the micro-batch), so the padded count must
    # fill the rows evenly
    dp = max(1, int(mpart.dp))
    n_q_pad = next_pow2(max(n_q, 1), minimum=1)
    n_q_pad = -(-n_q_pad // dp) * dp
    n_q_row = n_q_pad // dp
    empty = ([], 0, "eq", None, (0, 0))
    empty_plan = QueryPlan([], [], [], [])

    avgdl_override = None
    prepped: List[Optional[Dict]] = []
    for si in range(n_sh):
        sub = mpart.subs[si]
        if sub is None:
            prepped.append(None)
            continue
        ctxs = shard_ctxs[si]
        per_seg = []        # (plans[n_q], block_base)
        seen: List[Dict[str, float]] = [{} for _ in range(n_q)]
        has = [False] * n_q
        for pos, _pf, block_base, avgdl in sub.refs:
            ctx = ctxs[pos]
            override = ctx.avgdl_for(field)
            if override is not None:
                # DFS-normed: one corpus-wide value for every segment
                # of every member shard (it is per-request per-field)
                avgdl_override = float(override)
                avgdl = avgdl_override
            analyzer = ctx.search_analyzer(field)
            ex = _bm25_planner(ctx, field)
            if ex is None:
                continue
            df_map = ctx.df_for(field) or {}
            member_terms: List[List[Tuple[str, float]]] = []
            any_terms = False
            for qi, clauses in enumerate(clause_lists):
                terms: List[Tuple[str, float]] = []
                for text, boost in clauses:
                    terms.extend((t, boost)
                                 for t in analyzer.terms(text))
                member_terms.append(terms)
                if terms:
                    any_terms = True
                    has[qi] = True
                    for t, _b in terms:
                        if t not in seen[qi]:
                            seen[qi][t] = float(df_map.get(t, 0))
            if not any_terms:
                continue
            plans = ex.build_plans(member_terms,
                                   df_override=df_map or None,
                                   avgdl=avgdl)
            per_seg.append((plans, block_base))
        prepped.append({"per_seg": per_seg, "seen": seen, "has": has}
                       if per_seg else None)

    if all(p is None for p in prepped):
        return [[empty] * n_q for _ in range(n_sh)]

    exact_mode = np.zeros((n_sh, n_q), bool)
    for si, p in enumerate(prepped):
        if p is None:
            continue
        for qi in range(n_q):
            upper = int(sum(p["seen"][qi].values()))
            exact_mode[si, qi] = counts_on and upper <= track_limit

    k_mesh = min(max(want, 1), mpart.n_docs_pad)
    live_dev = torch.as_tensor(_mesh_live(mpart, shard_ctxs), device=dev)
    # the launches' accumulator: [S, n_q_pad, n_docs_pad] 64-bit sums
    transient = 8 * mpart.n_docs_pad * n_q_pad * mpart.n_slots

    def _flat_avgdl(si, i_s):
        return avgdl_override if avgdl_override is not None \
            else mpart.subs[si].block_avgdl[i_s]

    def _dispatch(rows_by_shard, k):
        if check_members is not None:
            check_members()
        # one flat bucket for every (slot, dp row) group: per-row flats
        # keep each row's qids local (0..n_q_row-1), so each row's
        # scatter is exactly the single-shard flat kernel's
        fb = qb_bucket(max(
            [sum(p.n_blocks
                 for p in rows[r * n_q_row: (r + 1) * n_q_row])
             for rows in rows_by_shard if rows for r in range(dp)]
            + [1]))
        idx = np.zeros((mpart.n_slots, dp, fb), np.int32)
        w = np.zeros((mpart.n_slots, dp, fb), np.float32)
        qid = np.zeros((mpart.n_slots, dp, fb), np.int32)
        favg = np.ones((mpart.n_slots, dp, fb), np.float32)
        for si, rows in enumerate(rows_by_shard):
            if not rows:
                continue
            for r in range(dp):
                i_s, w_s, q_s = flatten_plans(
                    rows[r * n_q_row: (r + 1) * n_q_row], fb)
                idx[si, r], w[si, r], qid[si, r] = i_s, w_s, q_s
                favg[si, r] = _flat_avgdl(si, i_s)
        with BREAKERS.breaker("request").limit_scope(
                transient, "mesh_wand_topk"):
            if counter is not None:
                counter.append(1)
            s, d, h = mesh_bm25_flat(
                mpart.block_docs, mpart.block_tfs, mpart.doc_lens,
                torch.as_tensor(idx, device=dev),
                torch.as_tensor(w, device=dev),
                torch.as_tensor(qid, device=dev),
                torch.as_tensor(favg, device=dev), live_dev,
                mpart.seg_ids, mpart.n_docs_pad, n_q_row, k,
                mpart.n_segs_max, k1=DEFAULT_K1, b=DEFAULT_B)
        # [S, dp, n_q_row, ...] -> [S, n_q_pad, ...]: contiguous row
        # assignment makes the flatten restore micro-batch order
        s = s.cpu().numpy().reshape(mpart.n_slots, n_q_pad, -1)
        d = d.cpu().numpy().reshape(mpart.n_slots, n_q_pad, -1)
        h = h.cpu().numpy().reshape(mpart.n_slots, n_q_pad, -1)
        return s, d, h

    def _rows(select):
        """[slot][n_q_pad] plan rows; ``select(si, qi, plans)`` -> plan
        for that (shard, member, segment) or empty_plan."""
        out = []
        for si in range(mpart.n_slots):
            p = prepped[si] if si < n_sh else None
            if p is None:
                out.append(None)
                continue
            rows = []
            for qi in range(n_q):
                segs = [select(si, qi, plans[qi])
                        for plans, _bb in p["per_seg"]]
                rows.append(QueryPlan.concat(
                    segs,
                    idx_offsets=[bb for _pl, bb in p["per_seg"]]))
            rows.extend([empty_plan] * (n_q_pad - n_q))
            out.append(rows)
        return out

    def _try_coarse() -> Optional[List[List[Tuple]]]:
        """Quantized two-tier mesh text path: one bf16 coarse launch over
        the full plans + one exact f32 re-rank launch, adaptive depth
        deepening GLOBALLY (any (shard, member) with a tight margin
        re-launches the pair). Per-slot bodies are the single-shard
        coarse/re-rank bodies, so re-ranked scores are bitwise the
        per-shard quantized path's — and counts come exact off the coarse
        pass. None = the exact mesh phases below serve (typed when it is a
        fallback)."""
        from elasticsearch_tpu_torch.parallel.mesh import (
            mesh_bm25_coarse, mesh_bm25_rerank,
        )
        if _mesh_engages(mpart.subs, k_mesh) is not True:
            return None
        mirror = mpart.quantized_mirror()
        if mirror is None:
            _count_mesh_quantized_fallback()
            return None
        tf16, dl16 = mirror
        rows_full = _rows(lambda si, qi, p: p)
        fb = qb_bucket(max(
            [sum(p.n_blocks for p in rows)
             for rows in rows_full if rows] + [1]))
        idx = np.zeros((mpart.n_slots, fb), np.int32)
        w = np.zeros((mpart.n_slots, fb), np.float32)
        qid = np.zeros((mpart.n_slots, fb), np.int32)
        favg = np.ones((mpart.n_slots, fb), np.float32)
        for si, rows in enumerate(rows_full):
            if not rows:
                continue
            i_s, w_s, q_s = flatten_plans(rows, fb)
            idx[si], w[si], qid[si] = i_s, w_s, q_s
            favg[si] = _flat_avgdl(si, i_s)
        idx_dev = torch.as_tensor(idx, device=dev)
        w_dev = torch.as_tensor(w, device=dev)
        qid_dev = torch.as_tensor(qid, device=dev)
        favg_dev = torch.as_tensor(favg, device=dev)
        blocks_full = np.zeros((n_sh, n_q), np.int64)
        for si, rows in enumerate(rows_full):
            if si < n_sh and rows:
                for qi in range(n_q):
                    blocks_full[si, qi] = rows[qi].n_blocks

        for kprime, last in _adaptive_depths(k_mesh, mpart.n_docs_pad):
            if kprime > KMAX:
                # the coarse and re-rank kernels hold k' <= KMAX
                # candidates a row; a wider window is served exact
                # (mesh_bm25_flat with the wide selection)
                _count_mesh_quantized_fallback()
                return None
            if check_members is not None:
                check_members()
            with BREAKERS.breaker("request").limit_scope(
                    transient, "mesh_coarse_wand"):
                if counter is not None:
                    counter.extend((1, 1))
                cs, cand, hits = mesh_bm25_coarse(
                    mpart.block_docs, tf16, dl16, idx_dev, w_dev, qid_dev,
                    favg_dev, live_dev, mpart.seg_ids, mpart.n_docs_pad,
                    n_q_pad, kprime, mpart.n_segs_max, k1=DEFAULT_K1,
                    b=DEFAULT_B)
                s, d, eps = mesh_bm25_rerank(
                    mpart.block_docs, mpart.block_tfs, idx_dev, w_dev,
                    qid_dev, favg_dev, mpart.doc_lens, live_dev, cand, cs,
                    mpart.n_docs_pad, n_q_pad, kprime, k_mesh,
                    k1=DEFAULT_K1, b=DEFAULT_B)
            cs_h, s_h = cs.cpu().numpy(), s.cpu().numpy()
            eps_h = eps.cpu().numpy()
            k_last = min(k_mesh, s_h.shape[2]) - 1
            ok = all(
                _margin_ok(float(s_h[si, qi, k_last]),
                           float(cs_h[si, qi, kprime - 1]),
                           float(eps_h[si, qi]), REL_BF16)
                for si in range(n_sh) if prepped[si] is not None
                for qi in range(n_q) if prepped[si]["has"][qi])
            if ok:
                break
            if last:
                _count_mesh_quantized_fallback()
                return None

        hits_h = hits.cpu().numpy()
        d_h = d.cpu().numpy()
        # members with terms in ANY slot — the same members the
        # per-shard path would have counted as coarse-tier-served
        n_served = sum(
            1 for qi in range(n_q)
            if any(p is not None and p["has"][qi] for p in prepped))
        MESH_PLANES.stats["mesh_quantized_queries"] += n_served
        PLANES.note_quantized(kprime, n_served, mesh=True)
        out: List[List[Tuple]] = []
        for si in range(n_sh):
            p = prepped[si]
            if p is None:
                out.append([empty] * n_q)
                continue
            sub = mpart.subs[si]
            n_segs_here = len(sub.segments)
            row_out: List[Tuple] = []
            for qi in range(n_q):
                if not p["has"][qi]:
                    row_out.append(empty)
                    continue
                cands, max_score = _mesh_row(sub, s_h[si, qi], d_h[si, qi])
                prune = (int(blocks_full[si, qi]),
                         int(blocks_full[si, qi]))
                h_row = hits_h[si, qi][:n_segs_here]
                if not counts_on:
                    total = int(np.minimum(h_row, want).sum())
                    row_out.append((cands, total, "gte", max_score,
                                    prune))
                    continue
                hits_seen = int(h_row.sum())
                if hits_seen >= track_limit:
                    row_out.append((cands, track_limit, "gte",
                                    max_score, prune))
                else:
                    row_out.append((cands, hits_seen, "eq", max_score,
                                    prune))
            out.append(row_out)
        return out

    if PLANES.quantized:
        # the measured-latency engage rule, per MESH class: the mesh
        # coarse tier pays 2 launches over n_slots stacks, so it gets its
        # own EWMAs rather than inheriting the single-shard ones
        got_coarse = _coarse_attempt("mesh_bm25", n_q, _try_coarse)
        if got_coarse is not None:
            return got_coarse
    t_exact = time.monotonic()

    # phase A — one mesh launch: exact-mode (shard, member) pairs score
    # all their blocks (their counts are final), pruned pairs their
    # per-segment P1_BUCKET highest-upper-bound blocks
    rows_a = _rows(lambda si, qi, p:
                   p if exact_mode[si, qi] else p.top_by_ub(P1_BUCKET))
    s_a, d_a, h_a = _dispatch(rows_a, k_mesh)

    theta = np.full((n_sh, n_q), -np.inf)
    for si, p in enumerate(prepped):
        if p is None:
            continue
        for qi in range(n_q):
            if exact_mode[si, qi]:
                continue
            finite = s_a[si, qi][np.isfinite(s_a[si, qi])]
            if len(finite) >= want:
                theta[si, qi] = float(np.sort(finite)[-want])

    # phase B — one mesh launch: per-(shard, member) WAND survivors
    blocks_total = np.zeros((n_sh, n_q), np.int64)
    blocks_scored = np.zeros((n_sh, n_q), np.int64)
    hits_exact = np.ones((n_sh, n_q), bool)

    def _survivors(si, qi, p):
        if exact_mode[si, qi]:
            blocks_total[si, qi] += p.n_blocks
            blocks_scored[si, qi] += p.n_blocks
            return empty_plan
        surv = p.survivors(float(theta[si, qi]))
        p1_cost = min(p.n_blocks, P1_BUCKET)
        blocks_total[si, qi] += p.n_blocks
        blocks_scored[si, qi] += min(surv.n_blocks + p1_cost, p.n_blocks)
        if surv.n_blocks < p.n_blocks:
            hits_exact[si, qi] = False
        return surv

    rows_b = _rows(_survivors)
    need_b = any(
        not exact_mode[si, qi]
        for si in range(n_sh) if prepped[si] is not None
        for qi in range(n_q))
    if need_b:
        s_b, d_b, h_b = _dispatch(rows_b, k_mesh)
    else:
        s_b = d_b = h_b = None

    out: List[List[Tuple]] = []
    for si in range(n_sh):
        p = prepped[si]
        row_out: List[Tuple] = []
        if p is None:
            out.append([empty] * n_q)
            continue
        sub = mpart.subs[si]
        for qi in range(n_q):
            if not p["has"][qi]:
                row_out.append(empty)
                continue
            if exact_mode[si, qi]:
                s_row, d_row = s_a[si, qi], d_a[si, qi]
                h_row = h_a[si, qi]
            else:
                s_row, d_row = s_b[si, qi], d_b[si, qi]
                h_row = h_b[si, qi]
            cands, max_score = _mesh_row(sub, s_row, d_row)
            prune = (int(blocks_total[si, qi]),
                     int(blocks_scored[si, qi]))
            if not counts_on:
                total = int(np.minimum(h_row, want).sum())
                row_out.append((cands, total, "gte", max_score, prune))
                continue
            hits_seen = int(h_row.sum())
            if hits_seen >= track_limit:
                row_out.append((cands, track_limit, "gte", max_score,
                                prune))
            elif hits_exact[si, qi] or exact_mode[si, qi]:
                row_out.append((cands, hits_seen, "eq", max_score,
                                prune))
            else:
                row_out.append((cands, None, None, max_score, prune))
        out.append(row_out)

    # (shard, member) pairs whose pruned counts might hide hits: one
    # exact unpruned counted mesh launch (k=1; scores already final)
    recount = {(si, qi)
               for si in range(n_sh) for qi in range(n_q)
               if counts_on and prepped[si] is not None
               and out[si][qi][1] is None}
    if recount:
        rows_r = _rows(lambda si, qi, p:
                       p if (si, qi) in recount else empty_plan)
        _s, _d, h_r = _dispatch(rows_r, 1)
        for si, qi in recount:
            cands, _, _, max_score, prune = out[si][qi]
            exact_hits = int(h_r[si, qi].sum())
            # >= : relation at count == track_limit is "gte" on every
            # path (the plane recount's boundary rule)
            if exact_hits >= track_limit:
                out[si][qi] = (cands, track_limit, "gte", max_score,
                               prune)
            else:
                out[si][qi] = (cands, exact_hits, "eq", max_score,
                               prune)
    _note_exact("mesh_bm25", n_q, t_exact)
    return out


def mesh_knn_winners(shard_ctxs, mpart, field: str, specs, k: int,
                     check_members: Optional[Callable[[], None]] = None,
                     counter: Optional[list] = None
                     ) -> List[List[List[Tuple[int, int, float]]]]:
    """Q kNN queries against S co-located shards' vector planes in ONE
    launch per phase: the corpus rides the slot axis, and each slot's row
    reproduces that shard's exact plane scores (plane_knn_winners' exact
    path). When EVERY populated slot clears the quantized engage
    threshold, the stacked int8 mirror serves the coarse pass and the
    exact re-rank restores the exact scores (each slot running the
    per-shard two-tier arithmetic, the adaptive depth deepening
    globally).

    Returns [shard][member] winner lists [(segment_idx, local_doc,
    raw_score)]. Raises MeshFallback for IVF-routed shards (mapping
    opt-in or ANN-sized corpora) and for MIXED per-shard quantized
    engagement (only the per-shard fan-out serves each shard its own
    tier) -- those keep the per-shard fan-out."""
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    from elasticsearch_tpu_torch.ops.knn import QueryBatch
    from elasticsearch_tpu_torch.parallel.mesh import mesh_knn_topk
    from elasticsearch_tpu_torch.search.execute import (
        ANN_DEFAULT_MIN_DOCS, execute as execute_query,
    )
    n_q = len(specs)
    n_sh = mpart.n_shards
    dev = mpart.device

    ctx0 = next((ctxs[0] for ctxs in shard_ctxs if ctxs), None)
    if ctx0 is not None:
        mapper = ctx0.mappers.mapper(field)
        opts = getattr(mapper, "index_options", None) or {}
        if opts.get("type") == "ivf":
            raise MeshFallback(
                f"[{field}] is IVF-mapped: the per-shard probe serves")
    for sub in mpart.subs:
        if sub is None:
            continue
        sizes = [s.n_docs for s in sub.segments
                 if s.vectors.get(field) is not None]
        if sizes and min(sizes) >= ANN_DEFAULT_MIN_DOCS:
            raise MeshFallback(
                "ANN-sized shard would take the per-segment IVF route")

    if check_members is not None:
        check_members()
    vectors = np.asarray([s.query_vector for s in specs], np.float32)
    dp = max(1, int(mpart.dp))
    n_q_pad = next_pow2(max(n_q, 1), minimum=1)
    n_q_pad = -(-n_q_pad // dp) * dp
    q_host = np.zeros((n_q_pad, vectors.shape[1]), np.float32)
    q_host[:n_q] = vectors
    # the padded rows, their norm terms and (on the tier) their int8
    # quantization, computed once on the host for every slot
    batch = QueryBatch(q_host, dev)

    live_host = _mesh_live(mpart, shard_ctxs)
    # distinct filters resolve to masks once per (filter, shard) -- the
    # batched executor's sharing rule, stacked into slot space
    fkeys = {s.filter_key for s in specs}
    masks_host = None
    if fkeys != {None}:
        by_key: Dict[Optional[str], np.ndarray] = {}
        for fk in fkeys:
            if fk is None:
                continue
            spec = next(s for s in specs if s.filter_key == fk)
            rows = np.zeros((mpart.n_slots, mpart.n_docs_pad), bool)
            for si in range(n_sh):
                sub = mpart.subs[si]
                if sub is None:
                    continue
                for pos, ctx in enumerate(shard_ctxs[si]):
                    _, fmask = execute_query(spec.filter, ctx)
                    base = int(sub.doc_base[pos])
                    n = ctx.segment.n_docs
                    rows[si, base: base + n] = fmask.cpu().numpy()[:n]
            by_key[fk] = rows
        if len(fkeys) == 1:
            # every member carries the SAME filter: fold it into the
            # allowed mask (one unmasked launch)
            live_host = live_host & by_key[next(iter(fkeys))]
        else:
            masks_host = np.ones(
                (mpart.n_slots, n_q_pad, mpart.n_docs_pad), bool)
            for qi, spec in enumerate(specs):
                if spec.filter_key is not None:
                    masks_host[:, qi, :] = by_key[spec.filter_key]

    k_mesh = min(max(k, 1), mpart.n_docs_pad)
    allowed = torch.as_tensor(live_host, device=dev) & mpart.exists
    masks_dev = None if masks_host is None else \
        torch.as_tensor(masks_host, device=dev)
    # the launches write an [S, n_q_pad, n_docs_pad] f32 score plane
    transient = 8 * mpart.n_docs_pad * n_q_pad * mpart.n_slots

    def _try_quantized():
        """int8 coarse + exact re-rank over the stacked mirror, the
        adaptive-depth loop deepening globally. None = the exact mesh
        kernel serves (mirror refused / margin exhausted / depth past the
        kernels' KMAX, typed)."""
        from elasticsearch_tpu_torch.parallel.mesh import (
            mesh_knn_coarse, mesh_knn_rerank,
        )
        mirror = mpart.quantized_mirror()
        if mirror is None:
            _count_mesh_quantized_fallback()
            return None
        q8, scales = mirror
        qq, qscale = batch.quantized()
        for kprime, last in _adaptive_depths(k_mesh, mpart.n_docs_pad):
            if kprime > KMAX:
                # the coarse and re-rank kernels hold k' <= KMAX
                # candidates a row; a wider window is served exact
                _count_mesh_quantized_fallback()
                return None
            if check_members is not None:
                check_members()
            with BREAKERS.breaker("request").limit_scope(
                    transient, "mesh_coarse_knn"):
                if counter is not None:
                    counter.extend((1, 1))
                cs, cand = mesh_knn_coarse(
                    q8, scales, mpart.norms, allowed, qq, qscale, batch.qn,
                    batch.q2, kprime, mpart.similarity, masks_dev)
                s_q, d_q, eps = mesh_knn_rerank(
                    mpart.matrix, mpart.norms, allowed, batch.queries,
                    batch.qn, batch.q2, cand, cs, k_mesh, mpart.similarity,
                    masks_dev)
            cs_h, s_h = cs.cpu().numpy(), s_q.cpu().numpy()
            eps_h = eps.cpu().numpy()
            k_last = min(k_mesh, s_h.shape[2]) - 1
            if all(_margin_ok(float(s_h[si, qi, k_last]),
                              float(cs_h[si, qi, kprime - 1]),
                              float(eps_h[si, qi]), REL_INT8)
                   for si in range(n_sh)
                   if mpart.subs[si] is not None
                   for qi in range(n_q)):
                MESH_PLANES.stats["mesh_quantized_queries"] += n_q
                PLANES.note_quantized(kprime, n_q, mesh=True)
                return s_h, d_q.cpu().numpy()
            if last:
                _count_mesh_quantized_fallback()
                return None

    got_q = None
    if PLANES.quantized:
        engages = _mesh_engages(mpart.subs, k_mesh)
        if engages is None:
            # counted on the stats surface here (the executor counts the
            # telemetry reason when it converts this to a mesh miss)
            MESH_PLANES.stats["mesh_quantized_fallbacks"] += 1
            raise MeshFallback(
                "per-shard quantized engagement is mixed: the per-shard "
                "fan-out serves each shard its own tier",
                reason=telemetry.MESH_QUANTIZED_FALLBACK)
        if engages:
            got_q = _coarse_attempt("mesh_knn", n_q, _try_quantized)
    if got_q is not None:
        s, d = got_q
    else:
        t_exact = time.monotonic()
        with BREAKERS.breaker("request").limit_scope(transient,
                                                     "mesh_knn"):
            if counter is not None:
                counter.append(1)
            s, d = mesh_knn_topk(mpart.matrix, mpart.norms, allowed,
                                 batch.queries, batch.qn, batch.q2, k_mesh,
                                 mpart.similarity, masks_dev)
        s, d = s.cpu().numpy(), d.cpu().numpy()
        _note_exact("mesh_knn", n_q, t_exact)

    winners: List[List[List[Tuple[int, int, float]]]] = []
    for si in range(n_sh):
        sub = mpart.subs[si]
        row: List[List[Tuple[int, int, float]]] = []
        for qi in range(n_q):
            if sub is None:
                row.append([])
                continue
            finite = s[si, qi] > -np.inf
            seg, local = sub.demux(d[si, qi][finite])
            row.append([(int(a), int(b), float(sc)) for a, b, sc in
                        zip(seg, local, s[si, qi][finite])])
        winners.append(row)
    return winners


def mesh_sparse_topk(shard_ctxs, mpart, field: str,
                     expansions: List[List[Tuple[str, float]]],
                     want: int,
                     check_members: Optional[Callable[[], None]] = None,
                     counter: Optional[list] = None) -> List[List[Tuple]]:
    """Q resolved expansions against S co-located shards' rank_features
    planes in ONE launch per phase (``mesh_sparse_topk``, or
    ``mesh_sparse_coarse`` + ``mesh_sparse_rerank`` on the tier), exact
    per-shard match counts off the score plane. Returns [shard][member]
    (candidates, total, max_score) -- plane_sparse_topk's shape per shard.

    The tier engages only when EVERY populated slot clears the per-shard
    engage threshold (else the exact launch serves: both tiers give the
    same answer), and the adaptive depth deepens globally. A window whose
    depth passes the kernels' KMAX stands the tier down (a counted
    ``mesh_quantized_fallback``) and is served exact, as the one-shard
    sparse tier does."""
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    from elasticsearch_tpu_torch.parallel.mesh import (
        mesh_sparse_topk as _mesh_sparse_kernel,
    )
    n_q = len(expansions)
    n_sh = mpart.n_shards
    dev = mpart.device
    # the exact kernel splits the query stack over dp rows (contiguous
    # slices), so the padded count must fill the rows evenly
    dp = max(1, int(mpart.dp))
    n_q_pad = next_pow2(max(n_q, 1), minimum=1)
    n_q_pad = -(-n_q_pad // dp) * dp
    n_q_row = n_q_pad // dp

    per_shard = [None if sub is None else
                 [_expansion_blocks(sub.refs, e) for e in expansions]
                 for sub in mpart.subs]
    qb_max = max([len(bi) for per in per_shard if per is not None
                  for bi, _bw in per] + [1])
    qb_pad = next_pow2(qb_max, minimum=8)
    idx = np.zeros((mpart.n_slots, n_q_pad, qb_pad), np.int32)
    w = np.zeros((mpart.n_slots, n_q_pad, qb_pad), np.float32)
    for si, per in enumerate(per_shard):
        if per is None:
            continue
        for qi, (bi, bw) in enumerate(per):
            idx[si, qi, : len(bi)] = bi
            w[si, qi, : len(bw)] = bw

    if check_members is not None:
        check_members()
    k_mesh = min(max(want, 1), mpart.n_docs_pad)
    idx_dev = torch.as_tensor(idx, device=dev)
    w_dev = torch.as_tensor(w, device=dev)
    live_dev = torch.as_tensor(_mesh_live(mpart, shard_ctxs), device=dev)
    # the launches write an [S, n_q_pad, n_docs_pad] int64 score plane
    transient = 8 * mpart.n_docs_pad * n_q_pad * mpart.n_slots

    def _try_quantized():
        """bf16 coarse + exact f32 re-rank over the stacked weight
        mirror, the adaptive depth deepening globally; counts come exact
        off the coarse pass. None = the exact mesh kernel serves (typed
        when it is a fallback)."""
        from elasticsearch_tpu_torch.parallel.mesh import (
            mesh_sparse_coarse, mesh_sparse_rerank,
        )
        if _mesh_engages(mpart.subs, k_mesh) is not True:
            return None
        mirror = mpart.quantized_mirror()
        if mirror is None:
            _count_mesh_quantized_fallback()
            return None
        (w16,) = mirror
        for kprime, last in _adaptive_depths(k_mesh, mpart.n_docs_pad):
            if kprime > KMAX:
                # the coarse and re-rank kernels hold k' <= KMAX
                # candidates a row; a wider window is served exact
                _count_mesh_quantized_fallback()
                return None
            if check_members is not None:
                check_members()
            with BREAKERS.breaker("request").limit_scope(
                    transient, "mesh_coarse_sparse"):
                if counter is not None:
                    counter.extend((1, 1))
                cs, cand, hits = mesh_sparse_coarse(
                    mpart.block_docs, w16, idx_dev, w_dev, live_dev,
                    mpart.n_docs_pad, kprime)
                s_q, d_q, eps = mesh_sparse_rerank(
                    mpart.block_docs, mpart.block_weights, idx_dev, w_dev,
                    live_dev, cand, cs, mpart.n_docs_pad, kprime, k_mesh)
            cs_h, s_h = cs.cpu().numpy(), s_q.cpu().numpy()
            eps_h = eps.cpu().numpy()
            k_last = min(k_mesh, s_h.shape[2]) - 1
            if all(_margin_ok(float(s_h[si, qi, k_last]),
                              float(cs_h[si, qi, kprime - 1]),
                              float(eps_h[si, qi]), REL_BF16)
                   for si in range(n_sh)
                   if per_shard[si] is not None
                   for qi in range(n_q)):
                MESH_PLANES.stats["mesh_quantized_queries"] += n_q
                PLANES.note_quantized(kprime, n_q, mesh=True)
                return s_h, d_q.cpu().numpy(), hits.cpu().numpy()
            if last:
                _count_mesh_quantized_fallback()
                return None

    got_q = _coarse_attempt("mesh_sparse", n_q, _try_quantized) \
        if PLANES.quantized else None
    if got_q is not None:
        s, d, h = got_q
    else:
        t_exact = time.monotonic()
        with BREAKERS.breaker("request").limit_scope(transient,
                                                     "mesh_sparse"):
            if counter is not None:
                counter.append(1)
            # the dp-split exact kernel: [S, dp, n_q_row, QB] rows in,
            # [S, dp, n_q_row, ...] out, restitched to batch order
            s, d, h = _mesh_sparse_kernel(
                mpart.block_docs, mpart.block_weights,
                idx_dev.view(mpart.n_slots, dp, n_q_row, qb_pad),
                w_dev.view(mpart.n_slots, dp, n_q_row, qb_pad), live_dev,
                mpart.n_docs_pad, k_mesh)
        s = s.cpu().numpy().reshape(mpart.n_slots, n_q_pad, -1)
        d = d.cpu().numpy().reshape(mpart.n_slots, n_q_pad, -1)
        h = h.cpu().numpy().reshape(mpart.n_slots, n_q_pad)
        _note_exact("mesh_sparse", n_q, t_exact)

    out: List[List[Tuple]] = []
    for si in range(n_sh):
        sub = mpart.subs[si]
        row: List[Tuple] = []
        for qi in range(n_q):
            if sub is None:
                row.append(([], 0, None))
                continue
            cands, max_score = _mesh_row(sub, s[si, qi], d[si, qi])
            row.append((cands, int(h[si, qi]), max_score))
        out.append(row)
    return out
