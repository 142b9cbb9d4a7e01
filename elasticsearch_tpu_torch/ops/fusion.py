"""Hybrid rank fusion on the card: reciprocal-rank and linear fusion.

The JAX package's ``ops/fusion.py``. Three kernel families, each behind a
wrapper with its plain PyTorch version beside it:

- ``rrf_fuse_batch`` (K24, ``csrc/rrf_fuse.cuh`` entered by
  ``csrc/rrf_fuse_batch.cu``): B concurrent RRF
  fusions, the coordinator's ``RrfFusionBatcher`` drain. Row b carries R
  ranked lists of K ids in its own dense id space (-1 pads); every valid
  entry at 1-based rank r adds ``1 / (rank_constant + r)`` (an f32 add,
  then an f32 division) to its doc, and the docs come back by score
  descending, then doc ascending, -1 past the row's matches.
- ``rrf_fuse`` (K24 at B 1, ``csrc/rrf_fuse.cu``): the same for one row, but past the matches
  it returns the lowest-numbered unscored doc ids in ascending order with
  score -inf, as ``lax.top_k`` over the JAX package's dense row does.
- ``linear_fuse`` (K25, ``csrc/linear_fuse.cu``): per retriever an
  optional min-max normalisation over its positive scores, a weighted sum
  over retrievers in retriever order, live and ``> 0`` masks, and the
  top-k of any width.

Sum order: each doc's RRF total starts from 0.0 and adds its entries in
flattened ``(r, k)`` order, the order the JAX package's CPU scatter-add
takes; a doc listed twice in one list counts twice. Ids at or above
``n_docs_pad`` are dropped, never indexed (``mode="drop"``). A wrapper
launches its kernel for CUDA tensors and runs the plain version for CPU
tensors; there is no fallback between the two, and a kernel that fails to
build or launch raises ``KernelError``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from elasticsearch_tpu_torch.index.segment import next_pow2
from elasticsearch_tpu_torch.ops.bm25 import (
    _check, _on_cuda, _ptr, _stream, chunk_entries, launch_kernel,
    stable_topk,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

__all__ = ["rrf_fuse", "rrf_fuse_batch", "linear_fuse",
           "rrf_scratch_bytes"]

# csrc/rrf_fuse.cuh: a row's work arrays (two u64 sort keys and one int a
# slot) stay in shared memory up to this many bytes, else in global scratch
RRF_SMEM_BYTES = 200 * 1024
RRF_SLOT_BYTES = 20

_SIG = {
    "rrf_fuse_batch": ["p", "i", "i", "i", "ll", "i", "i", "p", "p", "p",
                       "p"],
    "rrf_fuse": ["p", "i", "i", "ll", "i", "i", "p", "p", "p", "p"],
    "linear_fuse": ["p", "p", "p", "i", "ll", "i", "i", "p", "p", "p", "p",
                    "p", "p", "p"],
}


def rrf_scratch_bytes(n_rows: int, n_slots: int) -> int:
    """Global scratch a K24 launch allocates: none while a row's work
    arrays fit shared memory, else ``RRF_SLOT_BYTES`` a padded slot."""
    p = next_pow2(n_slots, minimum=2)
    return 0 if p * RRF_SLOT_BYTES <= RRF_SMEM_BYTES else \
        n_rows * p * RRF_SLOT_BYTES


# ---------------------------------------------------------------------------
# K24: reciprocal rank fusion
# ---------------------------------------------------------------------------

def rrf_dense_plain(doc_lists: torch.Tensor, n_docs_pad: int,
                    rank_constant: int) -> torch.Tensor:
    """[B, n_docs_pad] f32 RRF sums of [B, R, K] ranked lists, scores <= 0
    at -inf: the JAX package's scatter-add, entry by entry in flattened
    (r, k) order. The sums are taken on the CPU, where ``index_add_`` is
    a serial loop in index order (on the card it adds with atomics, in no
    fixed order), and the row is returned on the lists' device."""
    b, r, k = doc_lists.shape
    out_dev = doc_lists.device
    doc_lists = doc_lists.cpu()
    dev = doc_lists.device
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
    den = ranks + torch.tensor(float(rank_constant), dtype=torch.float32,
                               device=dev)
    contrib = (torch.ones_like(den) / den).expand(b, r, k).reshape(b, -1)
    docs = doc_lists.reshape(b, -1).long()
    valid = (docs >= 0) & (docs < n_docs_pad)
    rows = torch.arange(b, device=dev)[:, None].expand_as(docs)
    flat = (rows * n_docs_pad + docs)[valid]
    scores = torch.zeros(b * n_docs_pad, dtype=torch.float32, device=dev)
    scores.index_add_(0, flat, contrib[valid])
    scores = scores.view(b, n_docs_pad)
    return torch.where(scores > 0, scores,
                       torch.full_like(scores, float("-inf"))).to(out_dev)


def rrf_fuse_batch_plain(doc_lists: torch.Tensor, n_docs_pad: int, k: int,
                         rank_constant: int = 60
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    s, d = stable_topk(rrf_dense_plain(doc_lists, n_docs_pad,
                                       rank_constant), k)
    return s, torch.where(torch.isfinite(s), d, torch.full_like(d, -1))


def rrf_fuse_plain(doc_lists: torch.Tensor, n_docs_pad: int, k: int,
                   rank_constant: int = 60
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    s, d = stable_topk(rrf_dense_plain(doc_lists[None], n_docs_pad,
                                       rank_constant), k)
    return s[0], d[0]


def _check_rrf(doc_lists, dims: int, n_docs_pad: int, k: int,
               rank_constant: int, cap: int) -> None:
    if doc_lists.dim() != dims:
        raise ValueError(f"[doc_lists] must be {dims}-d, got "
                         f"{tuple(doc_lists.shape)}")
    _check("doc_lists", doc_lists, torch.int32, tuple(doc_lists.shape))
    if n_docs_pad < 1 or not 1 <= k <= cap:
        raise ValueError(f"k={k} outside [1, {cap}] (n_docs_pad "
                         f"{n_docs_pad})")
    if rank_constant < 1 or rank_constant + doc_lists.shape[-1] >= 1 << 24:
        raise ValueError(f"rank_constant={rank_constant} outside [1, "
                         f"2^24 - K)")


def _launch_rrf(doc_lists, n_docs_pad: int, k: int, rank_constant: int,
                tail: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K24 launch over [B, R, K] lists: ``rrf_fuse_batch`` or, with
    ``tail`` (B 1), ``rrf_fuse``."""
    b, r, kk = doc_lists.shape
    dev = doc_lists.device
    n_scratch = rrf_scratch_bytes(b, r * kk)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev) \
        if n_scratch else None
    s = torch.empty(b, k, dtype=torch.float32, device=dev)
    d = torch.empty(b, k, dtype=torch.int32, device=dev)
    family = "rrf_fuse" if tail else "rrf_fuse_batch"
    rows = (r, kk) if tail else (b, r, kk)
    launch_kernel(family, _SIG[family], _ptr(doc_lists), *rows, n_docs_pad,
                  k, rank_constant,
                  _ptr(scratch) if scratch is not None else None, _ptr(s),
                  _ptr(d), _stream())
    return s, d


def rrf_fuse_batch(doc_lists: torch.Tensor, n_docs_pad: int, k: int,
                   rank_constant: int = 60
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K24. (scores [B, k] f32, docs [B, k] int32) of B RRF fusions over
    [B, R, K] int32 ranked lists (-1 pads, ids >= ``n_docs_pad``
    dropped); docs -1 and scores -inf past each row's matches;
    1 <= k <= n_docs_pad."""
    cuda = _on_cuda(doc_lists)
    _check_rrf(doc_lists, 3, n_docs_pad, k, rank_constant, n_docs_pad)
    b, r, kk = doc_lists.shape
    label = f"b={b}/r={r}/k_list={kk}/n_docs_pad={n_docs_pad}/k={k}"
    with DEVICE_PROFILE.call("rrf_fuse_batch", label, cuda):
        if not cuda:
            return rrf_fuse_batch_plain(doc_lists, n_docs_pad, k,
                                        rank_constant)
        return _launch_rrf(doc_lists, n_docs_pad, k, rank_constant, False)


def rrf_fuse(doc_lists: torch.Tensor, n_docs_pad: int, k: int,
             rank_constant: int = 60) -> Tuple[torch.Tensor, torch.Tensor]:
    """K24 at B 1. (scores [k] f32, docs [k] int32) of one RRF fusion over
    [R, K] int32 ranked lists; past the matches, the lowest-numbered
    unscored doc ids ascending at -inf; 1 <= k <= n_docs_pad."""
    cuda = _on_cuda(doc_lists)
    _check_rrf(doc_lists, 2, n_docs_pad, k, rank_constant, n_docs_pad)
    r, kk = doc_lists.shape
    label = f"r={r}/k_list={kk}/n_docs_pad={n_docs_pad}/k={k}"
    with DEVICE_PROFILE.call("rrf_fuse", label, cuda):
        if not cuda:
            return rrf_fuse_plain(doc_lists, n_docs_pad, k, rank_constant)
        s, d = _launch_rrf(doc_lists[None], n_docs_pad, k, rank_constant,
                           True)
        return s[0], d[0]


# ---------------------------------------------------------------------------
# K25: linear fusion
# ---------------------------------------------------------------------------

def linear_fused_plain(score_arrays: torch.Tensor, weights: torch.Tensor,
                       live: torch.Tensor, normalize: bool = True
                       ) -> torch.Tensor:
    """[N_pad] f32 fused row, -inf where not live or not above 0: one
    rounded f32 op at a time, retrievers added in order from 0."""
    s = score_arrays
    if normalize:
        inf = torch.full_like(s, float("inf"))
        mx = s.max(dim=1, keepdim=True).values
        mn = torch.where(s > 0, s, inf).min(dim=1, keepdim=True).values
        mn = torch.where(torch.isfinite(mn), mn, torch.zeros_like(mn))
        rng = torch.clamp_min(mx - mn, 1e-9)
        s = torch.where(s > 0, (s - mn) / rng, torch.zeros_like(s))
    fused = torch.zeros(s.shape[1], dtype=torch.float32, device=s.device)
    for r in range(s.shape[0]):
        fused = fused + s[r] * weights[r]
    return torch.where(live & (fused > 0), fused,
                       torch.full_like(fused, float("-inf")))


def linear_fuse_plain(score_arrays: torch.Tensor, weights: torch.Tensor,
                      live: torch.Tensor, k: int, normalize: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    s, d = stable_topk(linear_fused_plain(score_arrays, weights, live,
                                          normalize)[None], k)
    return s[0], d[0]


def linear_fuse(score_arrays: torch.Tensor, weights: torch.Tensor,
                live: torch.Tensor, k: int, normalize: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K25. (scores [k] f32, docs [k] int32): the top-k of the weighted sum
    of [R, N_pad] f32 retriever scores (each min-max normalised over its
    positive entries when ``normalize``) by ``weights`` [R] f32, -inf
    where ``live`` [N_pad] bool is False or the sum is not above 0;
    1 <= k <= N_pad."""
    cuda = _on_cuda(score_arrays, weights, live)
    if score_arrays.dim() != 2:
        raise ValueError(f"[score_arrays] must be 2-d, got "
                         f"{tuple(score_arrays.shape)}")
    r, n = score_arrays.shape
    _check("score_arrays", score_arrays, torch.float32, (r, n))
    _check("weights", weights, torch.float32, (r,))
    _check("live", live, torch.bool, (n,))
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    label = f"r={r}/n_pad={n}/k={k}/normalize={int(normalize)}"
    with DEVICE_PROFILE.call("linear_fuse", label, cuda):
        if not cuda:
            return linear_fuse_plain(score_arrays, weights, live, k,
                                     normalize)
        dev = score_arrays.device
        bounds = torch.empty(2 * r, dtype=torch.int32, device=dev)
        fused = torch.empty(n, dtype=torch.float32, device=dev)
        ck = chunk_entries(1, n, k)
        chunk_s = torch.empty(ck, dtype=torch.float32, device=dev)
        chunk_i = torch.empty(ck, dtype=torch.int32, device=dev)
        s = torch.empty(k, dtype=torch.float32, device=dev)
        d = torch.empty(k, dtype=torch.int32, device=dev)
        launch_kernel("linear_fuse", _SIG["linear_fuse"],
                      _ptr(score_arrays), _ptr(weights), _ptr(live), r, n,
                      k, int(normalize), _ptr(bounds), _ptr(fused),
                      _ptr(chunk_s), _ptr(chunk_i), _ptr(s), _ptr(d),
                      _stream())
        return s, d
