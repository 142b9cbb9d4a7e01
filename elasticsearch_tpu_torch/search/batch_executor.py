"""THE shard execution path of the text, kNN and sparse classes: every
shard query is a batch member, solo being a batch of one.

``batched_wand_topk_shard``, ``batched_knn_shard``,
``sparse_topk_shard`` / ``batched_sparse_shard`` (and the ``_build_ctxs``
and ``BatchSpec`` they are fed by) from the JAX package's
``search/batch_executor.py``: Q queries share one kernel launch per phase
-- over the shard's plane when one is resident
(``plane_exec.plane_wand_topk`` / ``plane_knn_winners`` /
``plane_sparse_topk``), else one per segment -- and demux back to
per-member results, member-for-member exact in scores, candidates and
totals semantics. The micro-batching queue
around it (``ShardQueryBatcher``) belongs to the node layer and is not
part of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.ops.bm25 import DEFAULT_B, DEFAULT_K1, P1_BUCKET
from elasticsearch_tpu_torch.search.phase import ShardDoc


@dataclass
class BatchSpec:
    """Classification result: the batch key components plus this member's
    private payload (clauses / query vector / expansion tokens -- or, for
    the ``dense`` kind, the canonical request identity the per-drain
    memo dedups on)."""
    kind: str                      # "text" | "knn" | "sparse" | "dense"
    field: str
    window: int
    # text: counts-then-skip limit (0 = totals disabled);
    # knn/sparse: coordinator clip threshold (None = never clip)
    track_limit: int = 0
    clip_limit: Optional[int] = None
    clauses: Optional[List[Tuple[str, float]]] = None
    query_vector: Optional[List[float]] = None
    k: int = 10
    num_candidates: int = 100
    tokens: Optional[Dict[str, float]] = None
    boost: float = 1.0
    # filtered kNN: the parsed filter tree plus a stable value key
    filter: Any = None
    filter_key: Optional[str] = None
    # the parsed + alias-resolved query tree (text class)
    query: Any = None
    # dense kind: the canonical request identity
    dense_key: Optional[str] = None

    def key(self) -> Tuple:
        if self.kind == "text":
            return ("text", self.field, self.window, self.track_limit)
        if self.kind == "knn":
            return ("knn", self.field, self.window, self.clip_limit, self.k)
        if self.kind == "sparse":
            return ("sparse", self.field, self.window, self.clip_limit)
        return ("dense",)


def _build_ctxs(reader, mappers, doc_count: int,
                dfs: Optional[Dict[str, Dict[str, int]]],
                field_stats: Optional[Dict[str, Tuple[float, int]]] = None,
                device: DeviceLike = None):
    """SegmentContexts over the reader snapshot, exactly as query_shard
    builds them (point-in-time live masks, shard-level stat overrides)."""
    import torch

    from elasticsearch_tpu_torch.index.segment import BLOCK, next_pow2
    from elasticsearch_tpu_torch.search.execute import SegmentContext
    device = resolve_device(device)
    ctxs = []
    for si, (seg, live_host) in enumerate(zip(reader.segments,
                                              reader.live_masks)):
        n_pad = next_pow2(max(seg.n_docs, 1), minimum=BLOCK)
        snap = np.zeros(n_pad, bool)
        snap[: len(live_host)] = live_host
        ctxs.append(SegmentContext(seg, mappers, segment_idx=si,
                                   doc_count_override=doc_count,
                                   df_overrides=dfs,
                                   field_stats_overrides=field_stats,
                                   live_override=torch.as_tensor(
                                       snap, device=device),
                                   reader=reader, device=device))
    return ctxs


def batched_wand_topk_shard(ctxs, field: str,
                            clause_lists: List[List[Tuple[str, float]]],
                            want: int, track_limit: int,
                            check_members: Optional[Callable[[], None]]
                            = None) -> List[Tuple]:
    """THE pruned text top-k executor for the served path — Q queries
    in shared device dispatches, solo being simply Q=1 (query_shard
    calls this directly). Member-for-member exact in scores,
    candidates, totals semantics and prune accounting (each member
    keeps its OWN shard-global theta, derived from its own phase-1
    partials).

    Returns per member: (candidates, hits, relation, max_score,
    (blocks_total, blocks_scored))."""
    from elasticsearch_tpu_torch.search.execute import _bm25_executor
    if ctxs:
        from elasticsearch_tpu_torch.ops.device_segment import PLANES
        part = PLANES.get([c.segment for c in ctxs], "postings", field,
                          ctxs[0].device)
        if part is not None:
            from elasticsearch_tpu_torch.search.plane_exec import plane_wand_topk
            got = plane_wand_topk(ctxs, part, field, clause_lists, want,
                                  track_limit,
                                  check_members=check_members)
            if got is not None:
                return got
    count = track_limit > 0
    n_q = len(clause_lists)
    per_seg = []            # (ctx, ex, plans[n_q], k_seg, avgdl)
    seen_terms: List[Dict[str, float]] = [{} for _ in range(n_q)]
    has_terms = [False] * n_q
    for ctx in ctxs:
        analyzer = ctx.search_analyzer(field)
        ex = _bm25_executor(ctx, field)
        if ex is None:
            continue        # field has no postings in this segment
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
        k_seg = min(max(want, 1), ctx.n_docs_pad)
        avgdl = ex._avgdl(ctx.avgdl_for(field))
        plans = ex.build_plans(member_terms, df_override=df_map or None,
                               avgdl=avgdl)
        per_seg.append((ctx, ex, plans, k_seg, avgdl))

    empty = ([], 0, "eq", None, (0, 0))
    if not per_seg:
        return [empty] * n_q

    from elasticsearch_tpu_torch.ops.bm25 import QueryPlan
    empty_plan = QueryPlan([], [], [], [])

    hits_upper = [int(sum(s.values())) for s in seen_terms]
    exact_mode = [count and hits_upper[qi] <= track_limit
                  for qi in range(n_q)]

    # phase A, one dispatch per segment: exact-mode members score ALL
    # their blocks (counted — their results are final); pruned members
    # score their P1_BUCKET highest-upper-bound blocks to establish theta
    counted_a = any(exact_mode)
    res_a = []
    for ctx, ex, plans, k_seg, avgdl in per_seg:
        if check_members is not None:
            check_members()
        rows = [p if exact_mode[qi] else p.top_by_ub(P1_BUCKET)
                for qi, p in enumerate(plans)]
        res_a.append(ex._dispatch_flat(rows, ctx.live, k_seg, DEFAULT_K1,
                                       DEFAULT_B, avgdl, counted=counted_a))

    # per-member shard-global theta from that member's own partials
    theta = np.full(n_q, -np.inf)
    s_a = [np.asarray(r[0]) for r in res_a]
    for qi in range(n_q):
        if exact_mode[qi]:
            continue
        partials = np.concatenate([s[qi] for s in s_a])
        finite = partials[np.isfinite(partials)]
        if len(finite) >= want:
            theta[qi] = float(np.sort(finite)[-want])

    # phase B, one dispatch per segment: pruned members' WAND survivors,
    # scored exactly (exact members ride along as empty rows so the row
    # index stays the member index)
    blocks_total = [0] * n_q
    blocks_scored = [0] * n_q
    hits_exact = [True] * n_q
    res_b = []
    need_b = not all(exact_mode)
    for ctx, ex, plans, k_seg, avgdl in per_seg:
        if check_members is not None:
            check_members()
        rows = []
        for qi, p in enumerate(plans):
            if exact_mode[qi]:
                blocks_total[qi] += p.n_blocks
                blocks_scored[qi] += p.n_blocks
                rows.append(empty_plan)
                continue
            surv = p.survivors(float(theta[qi]))
            p1_cost = min(p.n_blocks, P1_BUCKET)
            blocks_total[qi] += p.n_blocks
            blocks_scored[qi] += min(surv.n_blocks + p1_cost, p.n_blocks)
            hits_exact[qi] = hits_exact[qi] and \
                surv.n_blocks >= p.n_blocks
            rows.append(surv)
        if need_b:
            res_b.append(ex._dispatch_flat(rows, ctx.live, k_seg,
                                           DEFAULT_K1, DEFAULT_B, avgdl,
                                           counted=count))

    # demux: candidates (+ counts) per member
    out: List[Tuple] = []
    for qi in range(n_q):
        if not has_terms[qi]:
            out.append(empty)
            continue
        candidates: List[ShardDoc] = []
        max_score: Optional[float] = None
        hits_seen = 0
        for si_idx, (ctx, ex, plans, k_seg, avgdl) in enumerate(per_seg):
            got = res_a[si_idx] if exact_mode[qi] else res_b[si_idx]
            if count:
                s, d, h = got
                hits_seen += int(np.asarray(h)[qi])
            else:
                s, d = got
            s_row = np.asarray(s)[qi]
            d_row = np.asarray(d)[qi]
            for sc, doc in zip(s_row, d_row):
                if sc == -np.inf:
                    break
                candidates.append(ShardDoc(ctx.segment_idx, int(doc),
                                           float(sc), (float(sc),)))
                if max_score is None or sc > max_score:
                    max_score = float(sc)
        candidates.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        prune = (blocks_total[qi], blocks_scored[qi])
        if not count:
            out.append((candidates, len(candidates), "gte", max_score,
                        prune))
        elif hits_seen >= track_limit:
            out.append((candidates, track_limit, "gte", max_score, prune))
        elif hits_exact[qi] or exact_mode[qi]:
            out.append((candidates, hits_seen, "eq", max_score, prune))
        else:
            out.append((candidates, None, None, max_score, prune))

    # members whose pruned counts might hide hits: one exact unpruned
    # counted pass (k=1, scores already final) — shared dispatches again
    recount = [qi for qi in range(n_q) if count and out[qi][1] is None]
    if recount:
        exact_hits = {qi: 0 for qi in recount}
        for ctx, ex, plans, k_seg, avgdl in per_seg:
            if check_members is not None:
                check_members()
            rows = [plans[qi] if qi in exact_hits else empty_plan
                    for qi in range(n_q)]
            _s, _d, h = ex._dispatch_flat(rows, ctx.live, 1, DEFAULT_K1,
                                          DEFAULT_B, avgdl, counted=True)
            h = np.asarray(h)
            for qi in exact_hits:
                exact_hits[qi] += int(h[qi])
        for qi in recount:
            candidates, _, _, max_score, prune = out[qi]
            # >= : relation at count == track_limit is "gte" on every
            # path — matches exact-mode/observed-full members and the
            # quantized coarse tier (see plane_exec's recount)
            if exact_hits[qi] >= track_limit:
                out[qi] = (candidates, track_limit, "gte", max_score,
                           prune)
            else:
                out[qi] = (candidates, exact_hits[qi], "eq", max_score,
                           prune)
    return out


def batched_knn_shard(ctxs, field: str, specs: List[BatchSpec],
                      k: int, check_members: Optional[Callable[[], None]]
                      = None, stats: Optional[Dict[str, float]] = None
                      ) -> List[Tuple]:
    """Q kNN queries through THE kNN executor (execute.knn_shard_winners
    -- the same call-site the solo rewrite is, with Q>1), demuxed to the
    dense collector's candidates/totals shape. A resident plane may
    raise PlaneFallback (IVF-routed members whose num_candidates imply
    different probe widths); the per-segment routing batches the probe
    per derived width and never falls back. ``stats`` gathers the
    filter-mask counters (``filter_mask_reuses``,
    ``knn_shared_mask_segments``)."""
    from elasticsearch_tpu_torch.search.execute import knn_shard_winners
    per_member_hits = knn_shard_winners(ctxs, field, specs, k,
                                        check_members, stats)
    return _knn_demux(specs, per_member_hits, k)


def _knn_demux(specs: List[BatchSpec],
               per_member_hits: List[List[Tuple[int, int, float]]],
               k: int) -> List[Tuple]:
    """Per-member shard-global merge (rewrite_knn's semantics) shared by
    the plane and per-segment batch paths."""
    out = []
    for qi, spec in enumerate(specs):
        hits = per_member_hits[qi]
        hits.sort(key=lambda x: -x[2])     # rewrite_knn's merge order
        winners = hits[: k]
        boost = spec.boost
        candidates = [ShardDoc(si, doc, sc * boost, (sc * boost,))
                      for si, doc, sc in winners]
        candidates.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        max_score = max((c.score for c in candidates), default=None)
        total = len(winners)
        relation = "eq"
        if spec.clip_limit is not None and total > spec.clip_limit:
            total, relation = spec.clip_limit, "gte"
        out.append((candidates, total, relation, max_score, None))
    return out


def sparse_topk_shard(ctxs, field: str,
                      expansions: List[List[Tuple[str, float]]],
                      want: int,
                      check_members: Optional[Callable[[], None]] = None
                      ) -> List[Tuple]:
    """THE resolved-expansion top-k executor for the served path — Q
    expansions (solo being simply Q=1) through the rank-features plane
    when resident, else one batched launch per segment; exact counts
    read off the score plane (the dense path's mask sum). Returns
    (candidates, total, max_score) per member."""
    from elasticsearch_tpu_torch.ops.device_segment import DeviceFeatures
    from elasticsearch_tpu_torch.ops.sparse import SparseExecutor
    n_q = len(expansions)
    if ctxs:
        from elasticsearch_tpu_torch.ops.device_segment import PLANES
        part = PLANES.get([c.segment for c in ctxs], "features", field,
                          ctxs[0].device)
        if part is not None:
            from elasticsearch_tpu_torch.search.plane_exec import (
                plane_sparse_topk,
            )
            return plane_sparse_topk(ctxs, part, field, expansions, want,
                                     check_members=check_members)
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    candidates: List[List[ShardDoc]] = [[] for _ in range(n_q)]
    totals = [0] * n_q
    for ctx in ctxs:
        dev = DeviceFeatures.for_segment(ctx.segment, field, ctx.device)
        if dev is None:
            continue
        if check_members is not None:
            check_members()
        ex = SparseExecutor(dev, ctx.segment.features[field])
        k_seg = min(max(want, 1), ctx.n_docs_pad)
        # the ONE charge site for per-segment sparse scoring (the plane
        # branch above charges inside plane_sparse_topk): one transient
        # score plane per segment launch
        with BREAKERS.breaker("request").limit_scope(
                8 * ctx.n_docs_pad * n_q, "sparse_topk"):
            s, d, h = ex.top_k_batch(expansions, ctx.live, k_seg,
                                     function="linear", count_hits=True)
        s = s.cpu().numpy()
        d = d.cpu().numpy()
        for qi in range(n_q):
            totals[qi] += int(h[qi])
            for sc, doc in zip(s[qi], d[qi]):
                if sc == -np.inf:
                    break
                candidates[qi].append(ShardDoc(ctx.segment_idx, int(doc),
                                               float(sc), (float(sc),)))
    out = []
    for qi in range(n_q):
        cands = candidates[qi]
        cands.sort(key=lambda c: (-c.score, c.segment_idx, c.doc))
        out.append((cands, totals[qi],
                    max((c.score for c in cands), default=None)))
    return out


def batched_sparse_shard(ctxs, field: str, specs: List[BatchSpec],
                         want: int,
                         check_members: Optional[Callable[[], None]]
                         = None) -> List[Tuple]:
    """Q resolved text_expansion members through ``sparse_topk_shard``,
    demuxed to the dense collector's candidates/totals shape (per-member
    coordinator clip applied)."""
    expansions = [[(t, w * s.boost) for t, w in s.tokens.items()]
                  for s in specs]
    got = sparse_topk_shard(ctxs, field, expansions, want, check_members)
    out = []
    for (cands, total, max_score), spec in zip(got, specs):
        relation = "eq"
        if spec.clip_limit is not None and total > spec.clip_limit:
            total, relation = spec.clip_limit, "gte"
        out.append((cands, total, relation, max_score, None))
    return out
