"""Sparse rank_features / learned-sparse (ELSER-style) scoring on the card.

The JAX package's ``ops/sparse.py``: a query is a bag of (feature,
weight); a document's score is the sum over its matching features of
f(doc weight) * query weight, f one of the rank_feature functions
(saturation, log, sigmoid, linear). The same block-gather + scatter-add
shape as BM25 (``ops/bm25.py``), and the same design: four kernel
families, each a hand-written CUDA kernel (``csrc/<family>.cu``) behind a
wrapper, with its plain PyTorch version beside it:

- ``sparse_flat`` (K15): Q queries' top-k, optionally with exact match
  counts (the JAX package's ``sparse_topk_batch``; at one query its
  ``sparse_topk``);
- ``sparse_scores`` (K19): one query's dense score row, 0 at dead docs
  when a live mask is given (``sparse_scores`` with
  ``SparseExecutor.scores``' mask);
- ``sparse_coarse`` (K16): the coarse tier over the plane's bf16 weight
  mirror (linear), top-k' candidates and exact counts;
- ``sparse_rerank`` (K17): exact f32 re-score of the candidates, top-k
  and ``eps`` = max |exact - coarse|.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; there is no fallback between the two. Both sum the f32
contributions in 64-bit fixed point (scale 2^32, as K1 does) and convert
once, so a doc's score has the same bits in every family, batch and
device for linear and saturation; log and sigmoid call ``logf`` /
``powf`` in the kernel and torch's ``log`` / ``pow`` in the plain
version, which may differ by an ulp. The JAX programs add the f32
contributions one by one in posting order, so the two packages' scores
differ within the rounding of that sum. The coarse contribution is
f32(bf16(qw)) * f32(w_bf16): a product of two bf16 values, exact in f32;
the JAX program widens it to f32 at once and XLA does not round it to
bf16 on the way. Top-k order is score descending, then index ascending,
-inf slots included (``lax.top_k``'s order).

``gather_feature_blocks`` and ``SparseExecutor`` are the JAX package's
host glue, copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import FeaturesField, next_pow2
from elasticsearch_tpu_torch.ops.bm25 import (
    BLOCK_WIDTH, KMAX, _check, _from_fixed, _on_cuda, _ptr, _stream,
    _to_fixed, chunk_entries, launch_kernel, stable_topk,
)
from elasticsearch_tpu_torch.ops.device_segment import DeviceFeatures
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

# function name -> the kernels' code (csrc/sparse_common.cuh Function)
FUNCTIONS = {"saturation": 0, "log": 1, "sigmoid": 2, "linear": 3}
# largest query count of one launch (the kernels' grid.y)
MAX_QUERIES = 65535


def _pivot_pow(pivot: float, exponent: float) -> float:
    """pivot^exponent in f32 (the sigmoid's constant), computed once on the
    host for the kernel and its plain version alike."""
    return float(np.power(np.float32(pivot), np.float32(exponent)))


# ---------------------------------------------------------------------------
# shared arithmetic of the plain versions
# ---------------------------------------------------------------------------

def _transform(w: torch.Tensor, function: str, pivot: float,
               exponent: float) -> torch.Tensor:
    """f(w), one rounded f32 op at a time (``transform`` in
    csrc/sparse_common.cuh)."""
    if function == "saturation":
        return w / (w + pivot)
    if function == "log":
        return torch.log(pivot + w)
    if function == "sigmoid":
        wa = torch.pow(torch.clamp_min(w, 0.0), exponent)
        return wa / (wa + _pivot_pow(pivot, exponent))
    return w


def _postings(block_docs, block_weights, block_idx, query_weight):
    """The gathered postings of every non-padding slot (query weight != 0)
    of a [Q, QB] block list: (query of each slot [n] int64, weights
    [n, BLOCK], query weights [n], valid [n, BLOCK], safe docs [n, BLOCK]
    int64)."""
    q_of, slot = torch.nonzero(query_weight != 0, as_tuple=True)
    blocks = block_idx[q_of, slot].long()
    docs = block_docs[blocks]
    w = block_weights[blocks]
    qw = query_weight[q_of, slot]
    valid = docs >= 0
    safe = torch.where(valid, docs, torch.zeros_like(docs)).long()
    return q_of, w, qw, valid, safe


def _fixed(c: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, _to_fixed(c),
                       torch.zeros((), dtype=torch.int64, device=c.device))


def _contrib(block_docs, block_weights, block_idx, query_weight, function,
             pivot, exponent):
    """(query of each gathered slot, fixed-point contributions [n, BLOCK],
    safe docs): qw * f(w), 0 at padding."""
    q_of, w, qw, valid, safe = _postings(block_docs, block_weights,
                                         block_idx, query_weight)
    c = qw[:, None] * _transform(w, function, pivot, exponent)
    return q_of, _fixed(c, valid), safe


def _contrib_bf16(block_docs, block_weights_q, block_idx, query_weight):
    """The coarse contribution: f32(bf16(qw)) * f32(w_bf16), exact in f32
    (never rounded to bf16), to fixed point."""
    q_of, w16, qw, valid, safe = _postings(block_docs, block_weights_q,
                                           block_idx, query_weight)
    c = qw.to(torch.bfloat16).float()[:, None] * w16.float()
    return q_of, _fixed(c, valid), safe


def _plane(q_of, fx, safe, n_q: int, n_docs_pad: int) -> torch.Tensor:
    """[n_q, n_docs_pad] int64 sums of the contributions."""
    acc = torch.zeros(n_q * n_docs_pad, dtype=torch.int64, device=fx.device)
    tgt = q_of[:, None] * n_docs_pad + safe
    acc.index_add_(0, tgt.reshape(-1), fx.reshape(-1))
    return acc.view(n_q, n_docs_pad)


def _masked_topk(acc, live, k: int):
    matched = live[None, :] & (acc > 0)
    scores = torch.where(matched, _from_fixed(acc),
                         torch.full((), -torch.inf, device=acc.device))
    s, d = stable_topk(scores, k)
    return s, d, matched.sum(dim=1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# plain versions (run for CPU tensors; chip_smoke.py holds the kernels
# against them on the card)
# ---------------------------------------------------------------------------

def sparse_flat_plain(block_docs, block_weights, block_idx, query_weight,
                      pivot: float, exponent: float, live, n_docs_pad: int,
                      k: int, function: str = "saturation",
                      counted: bool = False):
    q_of, fx, safe = _contrib(block_docs, block_weights, block_idx,
                              query_weight, function, pivot, exponent)
    acc = _plane(q_of, fx, safe, block_idx.shape[0], n_docs_pad)
    s, d, hits = _masked_topk(acc, live, k)
    return (s, d, hits) if counted else (s, d)


def sparse_scores_plain(block_docs, block_weights, block_idx, query_weight,
                        pivot: float, exponent: float, n_docs_pad: int,
                        function: str = "saturation",
                        live=None) -> torch.Tensor:
    q_of, fx, safe = _contrib(block_docs, block_weights, block_idx[None],
                              query_weight[None], function, pivot, exponent)
    scores = _from_fixed(_plane(q_of, fx, safe, 1, n_docs_pad)[0])
    if live is None:
        return scores
    return torch.where(live, scores, torch.zeros((), device=scores.device))


def sparse_coarse_plain(block_docs, block_weights_q, block_idx,
                        query_weight, live, n_docs_pad: int, kprime: int):
    q_of, fx, safe = _contrib_bf16(block_docs, block_weights_q, block_idx,
                                   query_weight)
    acc = _plane(q_of, fx, safe, block_idx.shape[0], n_docs_pad)
    return _masked_topk(acc, live, kprime)


def sparse_rerank_plain(block_docs, block_weights, block_idx, query_weight,
                        live, cand, coarse_s, n_docs_pad: int, kprime: int,
                        k: int):
    dev = block_docs.device
    n_q = block_idx.shape[0]
    order = torch.argsort(cand, dim=1, stable=True)
    cand_s = torch.gather(cand, 1, order)
    cs_s = torch.gather(coarse_s, 1, order)
    q_of, fx, safe = _contrib(block_docs, block_weights, block_idx,
                              query_weight, "linear", 1.0, 1.0)
    # each posting's candidate slot by binary search over the rows'
    # sorted (query, doc) keys; postings of non-candidates are dropped
    keys = (torch.arange(n_q, device=dev)[:, None] * n_docs_pad
            + cand_s.long()).reshape(-1)
    want = (q_of[:, None] * n_docs_pad + safe).reshape(-1)
    pos = torch.searchsorted(keys, want)
    pos_c = pos.clamp_max(keys.numel() - 1)
    hit = (pos < keys.numel()) & (keys[pos_c] == want)
    acc = torch.zeros(n_q * kprime, dtype=torch.int64, device=dev)
    acc.index_add_(0, pos_c[hit], fx.reshape(-1)[hit])
    acc = acc.view(n_q, kprime)
    cscores = _from_fixed(acc)
    ok = live[cand_s.long()] & (acc > 0)
    masked = torch.where(ok, cscores, torch.full((), -torch.inf, device=dev))
    s, p = stable_topk(masked, k)
    d = torch.gather(cand_s, 1, p.long())
    both = ok & torch.isfinite(cs_s)
    eps = torch.where(both, (cscores - cs_s).abs(),
                      torch.zeros((), device=dev)).amax(dim=1)
    return s, d, eps


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SIG = {
    "sparse_flat": ["p"] * 5 + ["i", "ll", "i", "i", "i", "i"] + ["f"] * 3
    + ["p"] * 7,
    "sparse_scores": ["p"] * 5 + ["i", "ll", "i"] + ["f"] * 3 + ["p"] * 3,
    "sparse_coarse": ["p"] * 5 + ["i", "ll", "i", "i"] + ["p"] * 7,
    "sparse_rerank": ["p"] * 7 + ["i"] * 4 + ["p"] * 7,
}


def _launch(family: str, *args) -> None:
    launch_kernel(family, _SIG[family], *args)


def _check_store(block_docs, block_weights, weight_dtype) -> None:
    if block_docs.dim() != 2 or block_docs.shape[1] != BLOCK_WIDTH:
        raise ValueError(f"[block_docs] must be [NB, {BLOCK_WIDTH}]")
    nb = block_docs.shape[0]
    _check("block_docs", block_docs, torch.int32, (nb, BLOCK_WIDTH))
    _check("block_weights", block_weights, weight_dtype, (nb, BLOCK_WIDTH))


def _check_rows(block_idx, query_weight) -> Tuple[int, int]:
    if block_idx.dim() != 2:
        raise ValueError("[block_idx] must be [Q, QB]")
    n_q, qb = block_idx.shape
    _check("block_idx", block_idx, torch.int32, (n_q, qb))
    _check("query_weight", query_weight, torch.float32, (n_q, qb))
    if not 1 <= n_q <= MAX_QUERIES:
        raise ValueError(f"Q={n_q} outside [1, {MAX_QUERIES}]")
    return n_q, qb


def _function(function: str) -> int:
    code = FUNCTIONS.get(function)
    if code is None:
        raise ValueError(f"unknown rank_feature function [{function}]")
    return code


def _label(qb: int, n_docs_pad: int, n_q: int, k: int) -> str:
    return f"qb={qb}/n_docs_pad={n_docs_pad}/n_q={n_q}/k={k}"


def _topk_scratch(n_q: int, n_docs_pad: int, k: int, dev):
    ck = chunk_entries(n_q, n_docs_pad, k)
    return (torch.empty(n_q * n_docs_pad, dtype=torch.int64, device=dev),
            torch.empty(ck, dtype=torch.float32, device=dev),
            torch.empty(ck, dtype=torch.int32, device=dev))


def sparse_topk_batch(block_docs, block_weights, block_idx, query_weight,
                      pivot: float, exponent: float, live, n_docs_pad: int,
                      k: int, function: str = "saturation",
                      counted: bool = False):
    """K15. Q rank_features queries' top-k over one block store:
    ``block_idx`` / ``query_weight`` [Q, QB] (block 0 / weight 0 as
    padding), every gathered posting scored qw * f(w), summed per (query,
    doc), masked to live docs with score > 0 (else -inf), top-k per query.
    Returns (s [Q, k] f32, d [Q, k] int32) and, when ``counted``, hits [Q]
    int32 = live docs with score > 0 per query."""
    cuda = _on_cuda(block_docs, block_weights, block_idx, query_weight, live)
    _check_store(block_docs, block_weights, torch.float32)
    n_q, qb = _check_rows(block_idx, query_weight)
    _check("live", live, torch.bool, (n_docs_pad,))
    code = _function(function)
    with DEVICE_PROFILE.call("sparse_flat", _label(qb, n_docs_pad, n_q, k),
                             cuda):
        if not cuda:
            return sparse_flat_plain(block_docs, block_weights, block_idx,
                                     query_weight, pivot, exponent, live,
                                     n_docs_pad, k, function, counted)
        if not 1 <= k <= n_docs_pad:
            raise ValueError(f"k={k} outside [1, {n_docs_pad}]")
        dev = block_docs.device
        acc, chunk_s, chunk_i = _topk_scratch(n_q, n_docs_pad, k, dev)
        s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        d = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        hits = torch.empty(n_q, dtype=torch.int32, device=dev)
        _launch("sparse_flat", _ptr(block_docs), _ptr(block_weights),
                _ptr(block_idx), _ptr(query_weight), _ptr(live), qb,
                n_docs_pad, n_q, k, int(counted), code, pivot, exponent,
                _pivot_pow(pivot, exponent), _ptr(acc), _ptr(chunk_s),
                _ptr(chunk_i), _ptr(s), _ptr(d), _ptr(hits), _stream())
        return (s, d, hits) if counted else (s, d)


def sparse_topk(block_docs, block_weights, block_idx, query_weight,
                pivot: float, exponent: float, live, n_docs_pad: int, k: int,
                function: str = "saturation"):
    """The JAX package's ``sparse_topk``: one query's top-k -> (s [k] f32,
    d [k] int32), which is ``sparse_topk_body`` at Q 1: K15 serves it."""
    s, d = sparse_topk_batch(block_docs, block_weights, block_idx[None],
                             query_weight[None], pivot, exponent, live,
                             n_docs_pad, k, function)
    return s[0], d[0]


def sparse_scores(block_docs, block_weights, block_idx, query_weight,
                  pivot: float, exponent: float, n_docs_pad: int,
                  function: str = "saturation", live=None) -> torch.Tensor:
    """K19. Dense scores [n_docs_pad] f32 of ONE query (``block_idx`` /
    ``query_weight`` [QB]): K15's gather, contribution and fixed-point sum
    at one query, so a doc's score equals K15's for the same blocks bit for
    bit; 0 where no posting lands and, when ``live`` [n_docs_pad] bool is
    given, where the doc is dead."""
    tensors = [block_docs, block_weights, block_idx, query_weight]
    cuda = _on_cuda(*tensors, *([live] if live is not None else []))
    _check_store(block_docs, block_weights, torch.float32)
    if block_idx.dim() != 1:
        raise ValueError("[block_idx] must be [QB]")
    qb = block_idx.shape[0]
    _check("block_idx", block_idx, torch.int32, (qb,))
    _check("query_weight", query_weight, torch.float32, (qb,))
    if live is not None:
        _check("live", live, torch.bool, (n_docs_pad,))
    code = _function(function)
    with DEVICE_PROFILE.call("sparse_scores",
                             f"qb={qb}/n_docs_pad={n_docs_pad}", cuda):
        if not cuda:
            return sparse_scores_plain(block_docs, block_weights, block_idx,
                                       query_weight, pivot, exponent,
                                       n_docs_pad, function, live)
        dev = block_docs.device
        acc = torch.empty(n_docs_pad, dtype=torch.int64, device=dev)
        out = torch.empty(n_docs_pad, dtype=torch.float32, device=dev)
        _launch("sparse_scores", _ptr(block_docs), _ptr(block_weights),
                _ptr(block_idx), _ptr(query_weight),
                _ptr(live) if live is not None else None, qb, n_docs_pad,
                code, pivot, exponent, _pivot_pow(pivot, exponent),
                _ptr(acc), _ptr(out), _stream())
        return out


def sparse_coarse_kernel(block_docs, block_weights_q, block_idx,
                         query_weight, live, n_docs_pad: int, kprime: int):
    """K16. The quantized COARSE tier (linear): K15's gather over the
    plane's bf16 weight mirror, each contribution f32(bf16(qw)) *
    f32(w_bf16), summed wider. Returns (coarse scores [Q, kprime] f32,
    candidate docs [Q, kprime] int32, match counts [Q] int32). The counts
    are EXACT: a positive weight stays positive in bf16, so ``score > 0``
    flags the same docs as the f32 kernel."""
    cuda = _on_cuda(block_docs, block_weights_q, block_idx, query_weight,
                    live)
    _check_store(block_docs, block_weights_q, torch.bfloat16)
    n_q, qb = _check_rows(block_idx, query_weight)
    _check("live", live, torch.bool, (n_docs_pad,))
    with DEVICE_PROFILE.call("sparse_coarse",
                             _label(qb, n_docs_pad, n_q, kprime), cuda):
        if not cuda:
            return sparse_coarse_plain(block_docs, block_weights_q,
                                       block_idx, query_weight, live,
                                       n_docs_pad, kprime)
        if not 1 <= kprime <= min(KMAX, n_docs_pad):
            raise ValueError(
                f"kprime={kprime} outside [1, {min(KMAX, n_docs_pad)}]")
        dev = block_docs.device
        acc, chunk_s, chunk_i = _topk_scratch(n_q, n_docs_pad, kprime, dev)
        cs = torch.empty(n_q, kprime, dtype=torch.float32, device=dev)
        cand = torch.empty(n_q, kprime, dtype=torch.int32, device=dev)
        hits = torch.empty(n_q, dtype=torch.int32, device=dev)
        _launch("sparse_coarse", _ptr(block_docs), _ptr(block_weights_q),
                _ptr(block_idx), _ptr(query_weight), _ptr(live), qb,
                n_docs_pad, n_q, kprime, _ptr(acc), _ptr(chunk_s),
                _ptr(chunk_i), _ptr(cs), _ptr(cand), _ptr(hits), _stream())
        return cs, cand, hits


def sparse_rerank_kernel(block_docs, block_weights, block_idx, query_weight,
                         live, cand, coarse_s, n_docs_pad: int, kprime: int,
                         k: int):
    """K17. The EXACT tier: re-score only the coarse candidates with K15's
    f32 linear contribution (each candidate's score equals K15's for that
    doc, bit for bit), candidates sorted ascending by doc id so score ties
    break toward the lower doc. Returns (scores [Q, k], docs [Q, k], eps
    [Q]) with ``eps`` the max |exact - coarse| among matched candidates
    with a finite coarse score."""
    cuda = _on_cuda(block_docs, block_weights, block_idx, query_weight, live,
                    cand, coarse_s)
    _check_store(block_docs, block_weights, torch.float32)
    n_q, qb = _check_rows(block_idx, query_weight)
    _check("live", live, torch.bool, (n_docs_pad,))
    _check("cand", cand, torch.int32, (n_q, kprime))
    _check("coarse_s", coarse_s, torch.float32, (n_q, kprime))
    with DEVICE_PROFILE.call("sparse_rerank",
                             _label(qb, n_docs_pad, n_q, kprime), cuda):
        if not cuda:
            return sparse_rerank_plain(block_docs, block_weights, block_idx,
                                       query_weight, live, cand, coarse_s,
                                       n_docs_pad, kprime, k)
        if not 1 <= kprime <= KMAX or not 1 <= k <= kprime:
            raise ValueError(f"need 1 <= k={k} <= kprime={kprime} <= {KMAX}")
        dev = block_docs.device
        cand_s = torch.empty(n_q, kprime, dtype=torch.int32, device=dev)
        cs_s = torch.empty(n_q, kprime, dtype=torch.float32, device=dev)
        acc = torch.empty(n_q, kprime, dtype=torch.int64, device=dev)
        s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        d = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        eps = torch.empty(n_q, dtype=torch.float32, device=dev)
        _launch("sparse_rerank", _ptr(block_docs), _ptr(block_weights),
                _ptr(block_idx), _ptr(query_weight), _ptr(live), _ptr(cand),
                _ptr(coarse_s), qb, n_q, kprime, k, _ptr(cand_s), _ptr(cs_s),
                _ptr(acc), _ptr(s), _ptr(d), _ptr(eps), _stream())
        return s, d, eps


# ---------------------------------------------------------------------------
# host glue and the per-segment executor (the JAX package's, copied)
# ---------------------------------------------------------------------------

def gather_feature_blocks(ff: FeaturesField, features_with_weights,
                          bucket_min: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Host prep: (block_indices, query_weights) padded to a pow2 bucket.
    Per-feature block lists come from the immutable field's cache
    (FeaturesField.feature_block_idx) — they only change when a refresh
    publishes a new field, so ELSER-style repeat expansions stop paying
    per-query list construction."""
    idx_parts, w_parts = [], []
    for name, weight in features_with_weights:
        f_idx = ff.feature_block_idx(name)
        if not len(f_idx):
            continue
        idx_parts.append(f_idx)
        w_parts.append(np.full(len(f_idx), weight, np.float32))
    n = sum(len(p) for p in idx_parts)
    qb_pad = next_pow2(max(n, 1), minimum=bucket_min)
    out_idx = np.zeros(qb_pad, np.int32)
    out_w = np.zeros(qb_pad, np.float32)
    if idx_parts:
        out_idx[:n] = np.concatenate(idx_parts)
        out_w[:n] = np.concatenate(w_parts)
    return out_idx, out_w


def pad_query_rows(per, device):
    """Per-query (block_idx, weights) lists -> [Q_pad, QB_pad] device
    tensors: gather lists padded to a shared pow2 bucket (>= 8; block 0 /
    weight 0 pads contribute nothing), the query dimension to a pow2
    bucket. Returns (idx, w, n_real)."""
    qb_pad = next_pow2(max((len(i) for i, _ in per), default=1), minimum=8)
    n_real = len(per)
    q_n = next_pow2(max(n_real, 1), minimum=1)
    idx = np.zeros((q_n, qb_pad), np.int32)
    w = np.zeros((q_n, qb_pad), np.float32)
    for i, (bi, bw) in enumerate(per):
        idx[i, : len(bi)] = bi
        w[i, : len(bw)] = bw
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device), n_real)


class SparseExecutor:
    """Per-(segment, field) sparse retrieval executor (text_expansion analog)."""

    def __init__(self, device_features: DeviceFeatures,
                 host_features: FeaturesField):
        self.dev = device_features
        self.host = host_features

    def _query(self, features_with_weights, bucket_min: int = 8):
        block_idx, qw = gather_feature_blocks(self.host, features_with_weights,
                                              bucket_min)
        dev = self.dev.device
        return (torch.as_tensor(block_idx, device=dev),
                torch.as_tensor(qw, device=dev))

    def scores(self, features_with_weights, live,
               function: str = "linear", pivot: float = 1.0,
               exponent: float = 1.0) -> torch.Tensor:
        block_idx, qw = self._query(features_with_weights)
        return sparse_scores(self.dev.block_docs, self.dev.block_weights,
                             block_idx, qw, pivot, exponent,
                             self.dev.n_docs_pad, function, live)

    def top_k(self, features_with_weights, live, k: int,
              function: str = "linear", pivot: float = 1.0,
              exponent: float = 1.0):
        block_idx, qw = self._query(features_with_weights)
        return sparse_topk(self.dev.block_docs, self.dev.block_weights,
                           block_idx, qw, pivot, exponent, live,
                           self.dev.n_docs_pad, k, function)

    def top_k_batch(self, queries, live, k: int,
                    function: str = "linear", pivot: float = 1.0,
                    exponent: float = 1.0, count_hits: bool = False):
        """``queries``: list of [(feature, weight)] expansions; one launch
        for the whole batch. Per-query gather lists are padded to a shared
        bucket (block 0 / weight 0 pads contribute nothing); the query
        dimension pads to a pow2 bucket. With ``count_hits`` also returns
        exact per-query match counts."""
        per = [gather_feature_blocks(self.host, q, bucket_min=1)
               for q in queries]
        idx, w, n_real = pad_query_rows(per, self.dev.device)
        got = sparse_topk_batch(
            self.dev.block_docs, self.dev.block_weights, idx, w, pivot,
            exponent, live, self.dev.n_docs_pad, k, function,
            counted=count_hits)
        if count_hits:
            s, d, h = got
            return s[:n_real], d[:n_real], h[:n_real].cpu().numpy()
        s, d = got
        return s[:n_real], d[:n_real]
