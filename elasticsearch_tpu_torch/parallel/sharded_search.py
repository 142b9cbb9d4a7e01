"""The JAX package's ``parallel/sharded_search.py``: the sharded data plane.

A corpus is cut round-robin into S slots (doc g -> slot g % S, local
g // S, each slot ``n_per_shard`` docs long) and one program scores every
slot and takes the global top-k -- the JAX package's one-program
replacement of the per-shard RPC fan-out, there a ``shard_map`` over a
``(dp, shard)`` device mesh: local score -> local top-k -> all_gather ->
global top-k. Here the mesh is a layout on one device
(``parallel/mesh.py`` ``make_mesh``): ``n_slots`` is the slot count S.

The device half is five kernel families, each a hand-written CUDA kernel
(``csrc/<family>.cu`` over ``csrc/sharded_common.cuh``) behind a wrapper,
with its plain PyTorch version beside it:

- ``sharded_knn`` (row 40, ``make_sharded_knn``): exact kNN, mesh-global
  ids ``slot * N + local``;
- ``sharded_bm25`` (row 41, ``make_sharded_bm25``): one query's BM25,
  mesh-global ids;
- ``sharded_bm25_batch`` (row 42, ``make_sharded_bm25_batch``): Q
  queries' BM25 in original ids ``local * S + slot``, optionally counted;
- ``sharded_sparse`` (row 43, ``make_sharded_sparse``): one
  rank_features / text_expansion query, mesh-global ids;
- ``sharded_hybrid`` (row 44, ``make_sharded_hybrid``): both branches'
  global top-k fused by RRF.

Each global order is one selection over the whole ``[S * N]`` score space
with a fixed tie key (``csrc/sharded_common.cuh`` sets out why that equals
the JAX program's local top-k, all-gather and global top-k), so the
kernels and their plain versions select once. The BM25 and sparse sums
are 64-bit fixed point, rounded once, as in every other scoring family of
the port: each kernel is bitwise its plain version, and against the JAX
package's f32 scatter-add the scores sit within rtol 1e-6, ids equal
outside near-ties. A wrapper runs the plain version only for CPU tensors;
on CUDA tensors it launches its kernel or raises.

The host half is the three sharded indexes and ``to_original_ids``,
built vectorised (a sort of the postings per slot on the index's device)
into arrays bitwise the JAX package's: in each slot the terms in order of
first appearance and, within a term, the local docs ascending.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import BLOCK, next_pow2
from elasticsearch_tpu_torch.ops.bm25 import (
    CHUNK, DEFAULT_B, DEFAULT_K1, KMAX, P1_BUCKET, QueryPlan, TermCellIndex,
    _check, _consts, _contrib_f32, _from_fixed, _on_cuda, _ptr, _stream,
    build_query_plan, idf as idf_fn, launch_kernel, qb_bucket, stable_topk,
)
from elasticsearch_tpu_torch.ops.knn import (
    MAX_DIMS, _flat_dots, _sim_code, _similarity, query_norms,
)
from elasticsearch_tpu_torch.ops.sparse import _contrib as _sparse_contrib
from elasticsearch_tpu_torch.parallel.mesh import Mesh
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

__all__ = [
    "ShardedFeaturesIndex", "ShardedTextIndex", "ShardedVectorIndex",
    "make_sharded_bm25", "make_sharded_bm25_batch", "make_sharded_hybrid",
    "make_sharded_knn", "make_sharded_sparse", "sharded_bm25",
    "sharded_bm25_batch", "sharded_hybrid", "sharded_knn", "sharded_sparse",
    "to_original_ids",
]


# ---------------------------------------------------------------------------
# shared arithmetic of the plain versions
# ---------------------------------------------------------------------------

def _neg_inf(t: torch.Tensor) -> torch.Tensor:
    return torch.full((), -torch.inf, device=t.device)


def _flat_select(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k of each row of ``scores`` [R, n] (non-matches at -inf),
    ties by lower index, id -1 where the score is not finite, padded with
    (-inf, -1) past n (``_topk_padded``'s padding)."""
    n_rows, n = scores.shape
    kk = min(k, n)
    s, i = stable_topk(scores, kk)
    i = torch.where(torch.isfinite(s), i,
                    torch.full((), -1, dtype=torch.int32, device=i.device))
    if kk < k:
        s = torch.cat([s, torch.full((n_rows, k - kk), -torch.inf,
                                     device=s.device)], dim=1)
        i = torch.cat([i, torch.full((n_rows, k - kk), -1,
                                     dtype=torch.int32, device=i.device)],
                      dim=1)
    return s, i


def _mesh_order(plane: torch.Tensor) -> torch.Tensor:
    """[S, Q, N] -> [Q, S * N], index slot * N + local (mesh-global)."""
    s, q, n = plane.shape
    return plane.permute(1, 0, 2).reshape(q, s * n)


def _original_order(plane: torch.Tensor) -> torch.Tensor:
    """[S, Q, N] -> [Q, N * S], index local * S + slot (original id)."""
    s, q, n = plane.shape
    return plane.permute(1, 2, 0).reshape(q, n * s)


def _fixed_scores(acc: torch.Tensor) -> torch.Tensor:
    """Fixed-point sums -> f32 scores, -inf where the sum is not > 0."""
    return torch.where(acc > 0, _from_fixed(acc), _neg_inf(acc))


def _sharded_dots(matrix, queries, similarity: str) -> torch.Tensor:
    """[S, Q, N] dots of queries [Q, D] with each slot's matrix [N, D]:
    cosine and dot_product with bf16-rounded operands (K5's dots),
    l2_norm with f32 operands, each product rounded before it is added;
    sums in dimension order."""
    if similarity != "l2_norm":
        return torch.stack([_flat_dots(matrix[si], queries)
                            for si in range(matrix.shape[0])])
    s, n, dims = matrix.shape
    acc = torch.zeros(s, queries.shape[0], n, dtype=torch.float32,
                      device=matrix.device)
    for d in range(dims):
        # two rounded ops, never a fused multiply-add
        acc = acc + queries[None, :, d, None] * matrix[:, None, :, d]
    return acc


def _as_f32(x) -> float:
    """A Python float or 1-element tensor -> its f32 value as a float."""
    if isinstance(x, torch.Tensor):
        return float(x.detach().reshape(-1)[0].to(torch.float32).cpu())
    return float(np.float32(x))


def _bm25_acc(block_docs, block_tfs, doc_lens, avgdl: float, block_idx,
              block_w, k1: float, b: float) -> torch.Tensor:
    """[S, Q, N] fixed-point BM25 sums of block lists [S, Q, QB], every
    contribution with the one corpus avgdl."""
    s_n, n_q, qb = block_idx.shape
    n = doc_lens.shape[1]
    dev = block_docs.device
    acc = torch.zeros(s_n, n_q * n, dtype=torch.int64, device=dev)
    q_of = torch.arange(n_q, device=dev).repeat_interleave(qb)
    for si in range(s_n):
        fi = block_idx[si].reshape(-1)
        avg = torch.full(fi.shape, avgdl, dtype=torch.float32, device=dev)
        fx, safe = _contrib_f32(block_docs[si], block_tfs[si], fi,
                                block_w[si].reshape(-1), doc_lens[si], avg,
                                k1, b)
        acc[si].index_add_(0, (q_of[:, None] * n + safe).reshape(-1),
                           fx.reshape(-1))
    return acc.view(s_n, n_q, n)


def _sparse_acc(block_docs, block_weights, block_idx, query_weight,
                n: int) -> torch.Tensor:
    """[S, 1, N] fixed-point sums of qw * w over block lists [S, QB]."""
    s_n = block_idx.shape[0]
    acc = torch.zeros(s_n, n, dtype=torch.int64, device=block_docs.device)
    for si in range(s_n):
        _q, fx, safe = _sparse_contrib(block_docs[si], block_weights[si],
                                       block_idx[si][None],
                                       query_weight[si][None], "linear",
                                       1.0, 1.0)
        acc[si].index_add_(0, safe.reshape(-1), fx.reshape(-1))
    return acc.view(s_n, 1, n)


def _rrf_plain(ids: torch.Tensor, k: int, rank_constant
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RRF over the 2k ids (BM25 branch first): ``make_sharded_hybrid``'s
    fusion, each id's sum over its positions (at most two non-zero
    terms), kept at its first position."""
    dev = ids.device
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
    contrib = 1.0 / (float(rank_constant) + ranks)
    contrib = torch.cat([contrib, contrib])
    present = ids >= 0
    contrib = torch.where(present, contrib, torch.zeros((), device=dev))
    eq = ids[:, None] == ids[None, :]
    fused = (eq.to(torch.float32) * contrib[None, :]).sum(dim=1)
    first = eq.to(torch.int32).argmax(dim=1) == torch.arange(2 * k,
                                                             device=dev)
    fused = torch.where(first & present, fused, _neg_inf(fused))
    s, pos = stable_topk(fused[None], k)
    out = torch.where(torch.isfinite(s[0]), ids[pos[0].long()],
                      torch.full((), -1, dtype=torch.int32, device=dev))
    return s[0], out.to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions (run for CPU tensors; chip_smoke.py holds the kernels
# against them on the card)
# ---------------------------------------------------------------------------

def sharded_knn_plain(matrix, norms, valid, queries, qn, q2, k: int,
                      similarity: str = "cosine"):
    s_n, n, _ = matrix.shape
    flat = _mesh_order(_sharded_dots(matrix, queries, similarity))
    nrm = norms.reshape(1, s_n * n)
    if similarity == "l2_norm":
        # norm * norm + q2 as a rounded product then a rounded add (no
        # fused multiply-add, unlike K5's transform)
        d2 = torch.clamp_min(nrm * nrm + q2[:, None] - 2.0 * flat, 0.0)
        scores = 1.0 / (1.0 + torch.sqrt(d2.double()).float())
    else:
        scores = _similarity(flat, nrm, qn, q2, similarity)
    scores = torch.where(valid.reshape(1, s_n * n), scores,
                         _neg_inf(scores))
    return _flat_select(scores, k)


def sharded_bm25_plain(block_docs, block_tfs, doc_lens, avgdl, block_idx,
                       block_w, k: int, k1: float = DEFAULT_K1,
                       b: float = DEFAULT_B):
    acc = _bm25_acc(block_docs, block_tfs, doc_lens, _as_f32(avgdl),
                    block_idx[:, None, :], block_w[:, None, :], k1, b)
    s, i = _flat_select(_mesh_order(_fixed_scores(acc)), k)
    return s[0], i[0]


def sharded_bm25_batch_plain(block_docs, block_tfs, doc_lens, avgdl,
                             block_idx, block_w, k: int,
                             k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                             counted: bool = False):
    acc = _bm25_acc(block_docs, block_tfs, doc_lens, _as_f32(avgdl),
                    block_idx, block_w, k1, b)
    s, i = _flat_select(_original_order(_fixed_scores(acc)), k)
    if not counted:
        return s, i
    return s, i, (acc > 0).sum(dim=(0, 2), dtype=torch.int32)


def sharded_sparse_plain(block_docs, block_weights, block_idx, query_weight,
                         n_docs_pad: int, k: int):
    acc = _sparse_acc(block_docs, block_weights, block_idx, query_weight,
                      n_docs_pad)
    s, i = _flat_select(_mesh_order(_fixed_scores(acc)), k)
    return s[0], i[0]


def sharded_hybrid_plain(block_docs, block_tfs, doc_lens, avgdl, block_idx,
                         block_w, matrix, norms, valid, qvec, qn, q2, k: int,
                         rank_constant: int = 60, similarity: str = "cosine",
                         k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    _s, b_ids = sharded_bm25_plain(block_docs, block_tfs, doc_lens, avgdl,
                                   block_idx, block_w, k, k1=k1, b=b)
    _s, v_ids = sharded_knn_plain(matrix, norms, valid, qvec[None], qn, q2,
                                  k, similarity)
    return _rrf_plain(torch.cat([b_ids, v_ids[0]]), k, rank_constant)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SIG = {
    "sharded_knn": ["p"] * 6 + ["i", "i", "i", "ll", "i", "i"] + ["p"] * 8,
    "sharded_bm25": ["p"] * 6 + ["i", "ll", "i", "ll", "i"] + ["f"] * 4
    + ["p"] * 8,
    "sharded_bm25_batch": ["p"] * 6 + ["i", "ll", "i", "ll", "i", "i", "i"]
    + ["f"] * 4 + ["p"] * 9,
    "sharded_sparse": ["p"] * 4 + ["i", "ll", "i", "ll", "i"] + ["p"] * 8,
    "sharded_hybrid": ["p"] * 6 + ["ll", "i"] + ["p"] * 6
    + ["i", "i", "i", "ll", "i", "f"] + ["f"] * 4 + ["p"] * 11,
}


def _select_scratch(n_slots: int, n: int, n_q: int, kk: int, dev):
    """The chunk winners and kept winners of one global selection
    (``csrc/sharded_common.cuh`` ``select_scratch``)."""
    nc = -(-(n_slots * n) // CHUNK)
    ck = n_q * nc * min(kk, KMAX) if nc > 1 else 1
    return (torch.empty(ck, dtype=torch.float32, device=dev),
            torch.empty(ck, dtype=torch.int32, device=dev),
            torch.empty(n_q * kk, dtype=torch.float32, device=dev),
            torch.empty(n_q * kk, dtype=torch.int32, device=dev))


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")


def _check_space(n_slots: int, n: int) -> None:
    if n_slots * n > 2 ** 31 - 1:
        raise ValueError(f"{n_slots} x {n} slot docs exceed int32 ids")


def _check_vectors(matrix, norms, valid) -> Tuple[int, int, int]:
    if matrix.dim() != 3:
        raise ValueError(f"[matrix] must be [S, N, D], got "
                         f"{tuple(matrix.shape)}")
    s_n, n, dims = (int(x) for x in matrix.shape)
    _check("matrix", matrix, torch.float32, (s_n, n, dims))
    _check("norms", norms, torch.float32, (s_n, n))
    _check("valid", valid, torch.bool, (s_n, n))
    if not 1 <= dims <= MAX_DIMS:
        raise ValueError(f"[matrix] dims {dims} outside [1, {MAX_DIMS}]")
    _check_space(s_n, n)
    return s_n, n, dims


def _check_postings(block_docs, block_tfs, doc_lens=None
                    ) -> Tuple[int, int]:
    if block_docs.dim() != 3 or block_docs.shape[2] != BLOCK:
        raise ValueError(f"[block_docs] must be [S, NB, {BLOCK}]")
    s_n, nb = int(block_docs.shape[0]), int(block_docs.shape[1])
    _check("block_docs", block_docs, torch.int32, (s_n, nb, BLOCK))
    _check("block_tfs", block_tfs, torch.float32, (s_n, nb, BLOCK))
    if doc_lens is not None:
        if doc_lens.dim() != 2 or doc_lens.shape[0] != s_n:
            raise ValueError(f"[doc_lens] must be [{s_n}, N]")
        _check("doc_lens", doc_lens, torch.float32, tuple(doc_lens.shape))
    return s_n, nb


def _check_lists(block_idx, block_w, lead) -> int:
    """QB of block lists and weights shaped ``lead + (QB,)``, checked."""
    if block_idx.dim() != len(lead) + 1 or \
            tuple(block_idx.shape[:len(lead)]) != tuple(lead):
        raise ValueError(f"[block_idx] must be {list(lead) + ['QB']}, got "
                         f"{tuple(block_idx.shape)}")
    qb = int(block_idx.shape[-1])
    _check("block_idx", block_idx, torch.int32, tuple(lead) + (qb,))
    _check("block_w", block_w, torch.float32, tuple(lead) + (qb,))
    return qb


def _check_terms(qn, q2, n_q: int) -> None:
    _check("qn", qn, torch.float32, (n_q,))
    _check("q2", q2, torch.float32, (n_q,))


def _avgdl_on(avgdl, dev) -> torch.Tensor:
    """The corpus avgdl as one f32 on the kernel's device."""
    if isinstance(avgdl, torch.Tensor):
        t = avgdl.reshape(1).to(device=dev, dtype=torch.float32)
        return t.contiguous()
    return torch.full((1,), float(avgdl), dtype=torch.float32, device=dev)


def sharded_knn(matrix, norms, valid, queries, qn, q2, k: int,
                similarity: str = "cosine"):
    """Row 40. matrix [S, N, D] f32, norms / valid [S, N], queries [B, D]
    with their ``qn`` / ``q2`` [B] -> (scores [B, k] f32, mesh-global ids
    [B, k] int32, -1 where not finite)."""
    cuda = _on_cuda(matrix, norms, valid, queries, qn, q2)
    s_n, n, dims = _check_vectors(matrix, norms, valid)
    if queries.dim() != 2 or queries.shape[1] != dims:
        raise ValueError(f"[queries] must be [B, {dims}]")
    n_q = int(queries.shape[0])
    _check("queries", queries, torch.float32, (n_q, dims))
    _check_terms(qn, q2, n_q)
    _check_k(k)
    code = _sim_code(similarity)
    label = f"s={s_n}/n_per_shard={n}/dims={dims}/n_q={n_q}/k={k}"
    with DEVICE_PROFILE.call("sharded_knn", label, cuda):
        if not cuda:
            return sharded_knn_plain(matrix, norms, valid, queries, qn, q2,
                                     k, similarity)
        dev = matrix.device
        kk = min(k, s_n * n)
        plane = torch.empty(s_n * n_q * n, dtype=torch.float32, device=dev)
        chunk_s, chunk_i, sel_s, sel_i = _select_scratch(s_n, n, n_q, kk,
                                                         dev)
        out_s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        out_i = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        launch_kernel(
            "sharded_knn", _SIG["sharded_knn"], _ptr(matrix), _ptr(norms),
            _ptr(valid), _ptr(queries), _ptr(qn), _ptr(q2), s_n, n_q, dims,
            n, k, code, _ptr(plane), _ptr(chunk_s), _ptr(chunk_i),
            _ptr(sel_s), _ptr(sel_i), _ptr(out_s), _ptr(out_i), _stream())
        return out_s, out_i


def sharded_bm25(block_docs, block_tfs, doc_lens, avgdl, block_idx, block_w,
                 k: int, k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    """Row 41. One query: block_docs / block_tfs [S, NB, 128], doc_lens
    [S, N], the corpus avgdl (a float or a 1-element tensor), block lists
    and weights [S, QB] -> (scores [k] f32, mesh-global ids [k] int32)."""
    tensors = [block_docs, block_tfs, doc_lens, block_idx, block_w]
    if isinstance(avgdl, torch.Tensor):
        tensors.append(avgdl)
    cuda = _on_cuda(*tensors)
    s_n, nb = _check_postings(block_docs, block_tfs, doc_lens)
    n = int(doc_lens.shape[1])
    qb = _check_lists(block_idx, block_w, (s_n,))
    _check_k(k)
    _check_space(s_n, n)
    label = f"s={s_n}/qb={qb}/n_per_shard={n}/k={k}"
    with DEVICE_PROFILE.call("sharded_bm25", label, cuda):
        if not cuda:
            return sharded_bm25_plain(block_docs, block_tfs, doc_lens, avgdl,
                                      block_idx, block_w, k, k1=k1, b=b)
        dev = block_docs.device
        kk = min(k, s_n * n)
        avg = _avgdl_on(avgdl, dev)
        acc = torch.empty(s_n * n, dtype=torch.int64, device=dev)
        chunk_s, chunk_i, sel_s, sel_i = _select_scratch(s_n, n, 1, kk, dev)
        out_s = torch.empty(k, dtype=torch.float32, device=dev)
        out_i = torch.empty(k, dtype=torch.int32, device=dev)
        launch_kernel(
            "sharded_bm25", _SIG["sharded_bm25"], _ptr(block_docs),
            _ptr(block_tfs), _ptr(doc_lens), _ptr(avg), _ptr(block_idx),
            _ptr(block_w), s_n, nb, qb, n, k, *_consts(k1, b), _ptr(acc),
            _ptr(chunk_s), _ptr(chunk_i), _ptr(sel_s), _ptr(sel_i),
            _ptr(out_s), _ptr(out_i), _stream())
        return out_s, out_i


def sharded_bm25_batch(block_docs, block_tfs, doc_lens, avgdl, block_idx,
                       block_w, k: int, k1: float = DEFAULT_K1,
                       b: float = DEFAULT_B, counted: bool = False):
    """Row 42. Q queries: sharded_bm25's operands with block lists and
    weights [S, Q, QB] -> (scores [Q, k] f32, original ids [Q, k] int32,
    -1 where not finite), and with ``counted`` the matches hits [Q] int32
    summed over the slots."""
    tensors = [block_docs, block_tfs, doc_lens, block_idx, block_w]
    if isinstance(avgdl, torch.Tensor):
        tensors.append(avgdl)
    cuda = _on_cuda(*tensors)
    s_n, nb = _check_postings(block_docs, block_tfs, doc_lens)
    n = int(doc_lens.shape[1])
    if block_idx.dim() != 3 or block_idx.shape[0] != s_n:
        raise ValueError(f"[block_idx] must be [{s_n}, Q, QB]")
    n_q = int(block_idx.shape[1])
    qb = _check_lists(block_idx, block_w, (s_n, n_q))
    _check_k(k)
    _check_space(s_n, n)
    if not 1 <= s_n * n_q <= 65535:
        raise ValueError(f"{s_n} x {n_q} (slot, query) rows outside "
                         f"[1, 65535]")
    label = (f"s={s_n}/qb={qb}/n_per_shard={n}/n_q={n_q}/k={k}"
             + ("/counted" if counted else ""))
    with DEVICE_PROFILE.call("sharded_bm25_batch", label, cuda):
        if not cuda:
            return sharded_bm25_batch_plain(
                block_docs, block_tfs, doc_lens, avgdl, block_idx, block_w,
                k, k1=k1, b=b, counted=counted)
        dev = block_docs.device
        kk = min(k, s_n * n)
        avg = _avgdl_on(avgdl, dev)
        acc = torch.empty(s_n * n_q * n, dtype=torch.int64, device=dev)
        chunk_s, chunk_i, sel_s, sel_i = _select_scratch(s_n, n, n_q, kk,
                                                         dev)
        out_s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        out_i = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        hits = torch.empty(n_q, dtype=torch.int32, device=dev)
        launch_kernel(
            "sharded_bm25_batch", _SIG["sharded_bm25_batch"],
            _ptr(block_docs), _ptr(block_tfs), _ptr(doc_lens), _ptr(avg),
            _ptr(block_idx), _ptr(block_w), s_n, nb, qb, n, n_q, k,
            int(counted), *_consts(k1, b), _ptr(acc), _ptr(chunk_s),
            _ptr(chunk_i), _ptr(sel_s), _ptr(sel_i), _ptr(out_s),
            _ptr(out_i), _ptr(hits), _stream())
        return (out_s, out_i, hits) if counted else (out_s, out_i)


def sharded_sparse(block_docs, block_weights, block_idx, query_weight,
                   n_docs_pad: int, k: int):
    """Row 43. One query: block_docs / block_weights [S, NB, 128], block
    lists and query weights [S, QB], ``n_docs_pad`` = N docs a slot ->
    (scores [k] f32, mesh-global ids [k] int32)."""
    cuda = _on_cuda(block_docs, block_weights, block_idx, query_weight)
    s_n, nb = _check_postings(block_docs, block_weights)
    qb = _check_lists(block_idx, query_weight, (s_n,))
    _check_k(k)
    _check_space(s_n, n_docs_pad)
    if s_n > 65535:
        raise ValueError(f"{s_n} slots outside [1, 65535]")
    label = f"s={s_n}/qb={qb}/n_per_shard={n_docs_pad}/k={k}"
    with DEVICE_PROFILE.call("sharded_sparse", label, cuda):
        if not cuda:
            return sharded_sparse_plain(block_docs, block_weights, block_idx,
                                        query_weight, n_docs_pad, k)
        dev = block_docs.device
        kk = min(k, s_n * n_docs_pad)
        acc = torch.empty(s_n * n_docs_pad, dtype=torch.int64, device=dev)
        chunk_s, chunk_i, sel_s, sel_i = _select_scratch(s_n, n_docs_pad, 1,
                                                         kk, dev)
        out_s = torch.empty(k, dtype=torch.float32, device=dev)
        out_i = torch.empty(k, dtype=torch.int32, device=dev)
        launch_kernel(
            "sharded_sparse", _SIG["sharded_sparse"], _ptr(block_docs),
            _ptr(block_weights), _ptr(block_idx), _ptr(query_weight), s_n,
            nb, qb, n_docs_pad, k, _ptr(acc), _ptr(chunk_s), _ptr(chunk_i),
            _ptr(sel_s), _ptr(sel_i), _ptr(out_s), _ptr(out_i), _stream())
        return out_s, out_i


def sharded_hybrid(block_docs, block_tfs, doc_lens, avgdl, block_idx,
                   block_w, matrix, norms, valid, qvec, qn, q2, k: int,
                   rank_constant: int = 60, similarity: str = "cosine",
                   k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    """Row 44. sharded_bm25's operands (one query), sharded_knn's with one
    query vector qvec [D] (``qn`` / ``q2`` [1]) on the same S and N ->
    the RRF-fused (scores [k] f32, mesh-global ids [k] int32); 1 <= k <=
    4,096 on the card."""
    tensors = [block_docs, block_tfs, doc_lens, block_idx, block_w, matrix,
               norms, valid, qvec, qn, q2]
    if isinstance(avgdl, torch.Tensor):
        tensors.append(avgdl)
    cuda = _on_cuda(*tensors)
    s_n, nb = _check_postings(block_docs, block_tfs, doc_lens)
    n = int(doc_lens.shape[1])
    qb = _check_lists(block_idx, block_w, (s_n,))
    vs, vn, dims = _check_vectors(matrix, norms, valid)
    if (vs, vn) != (s_n, n):
        raise ValueError(f"the kNN branch's [S, N] {(vs, vn)} must be the "
                         f"BM25 branch's {(s_n, n)}")
    _check("qvec", qvec, torch.float32, (dims,))
    _check_terms(qn, q2, 1)
    _check_k(k)
    code = _sim_code(similarity)
    label = f"s={s_n}/qb={qb}/n_per_shard={n}/dims={dims}/k={k}"
    with DEVICE_PROFILE.call("sharded_hybrid", label, cuda):
        if not cuda:
            return sharded_hybrid_plain(
                block_docs, block_tfs, doc_lens, avgdl, block_idx, block_w,
                matrix, norms, valid, qvec, qn, q2, k,
                rank_constant=rank_constant, similarity=similarity, k1=k1,
                b=b)
        if k > KMAX:
            raise ValueError(f"k={k} above the fusion's {KMAX}")
        dev = block_docs.device
        kk = min(k, s_n * n)
        avg = _avgdl_on(avgdl, dev)
        acc = torch.empty(s_n * n, dtype=torch.int64, device=dev)
        plane = torch.empty(s_n * n, dtype=torch.float32, device=dev)
        chunk_s, chunk_i, sel_s, sel_i = _select_scratch(s_n, n, 1, kk, dev)
        branch_s = torch.empty(2 * k, dtype=torch.float32, device=dev)
        branch_i = torch.empty(2 * k, dtype=torch.int32, device=dev)
        out_s = torch.empty(k, dtype=torch.float32, device=dev)
        out_i = torch.empty(k, dtype=torch.int32, device=dev)
        launch_kernel(
            "sharded_hybrid", _SIG["sharded_hybrid"], _ptr(block_docs),
            _ptr(block_tfs), _ptr(doc_lens), _ptr(avg), _ptr(block_idx),
            _ptr(block_w), nb, qb, _ptr(matrix), _ptr(norms), _ptr(valid),
            _ptr(qvec), _ptr(qn), _ptr(q2), dims, code, s_n, n, k,
            float(rank_constant), *_consts(k1, b), _ptr(acc), _ptr(plane),
            _ptr(chunk_s), _ptr(chunk_i), _ptr(sel_s), _ptr(sel_i),
            _ptr(branch_s), _ptr(branch_i), _ptr(out_s), _ptr(out_i),
            _stream())
        return out_s, out_i


# ---------------------------------------------------------------------------
# the JAX package's program factories: the wrappers, static arguments bound
# ---------------------------------------------------------------------------

def _query_terms(queries: torch.Tensor):
    """(qn, q2) of a query batch, computed on the host in dimension order
    (``ops/knn.py`` ``query_norms``) and placed beside the queries."""
    qn, q2 = query_norms(queries.detach().cpu().numpy())
    return (torch.as_tensor(qn, device=queries.device),
            torch.as_tensor(q2, device=queries.device))


def make_sharded_knn(k: int, similarity: str = "cosine"):
    """fn(matrix [S,N,D], norms [S,N], valid [S,N], queries [B,D]) ->
    (scores [B,k], mesh-global ids [B,k]): row 40."""
    def fn(matrix, norms, valid, queries):
        qn, q2 = _query_terms(queries)
        return sharded_knn(matrix, norms, valid, queries, qn, q2, k,
                           similarity)
    return fn


def make_sharded_bm25(k: int, k1: float = DEFAULT_K1,
                      b: float = DEFAULT_B):
    """fn(block_docs, block_tfs, doc_lens, avgdl, block_idx [S,QB],
    block_w [S,QB]) -> (scores [k], mesh-global ids [k]): row 41."""
    def fn(block_docs, block_tfs, doc_lens, avgdl, block_idx, block_w):
        return sharded_bm25(block_docs, block_tfs, doc_lens, avgdl,
                            block_idx, block_w, k, k1=k1, b=b)
    return fn


def make_sharded_bm25_batch(k: int, k1: float = DEFAULT_K1,
                            b: float = DEFAULT_B, counted: bool = False):
    """fn(block_docs, block_tfs, doc_lens, avgdl, block_idx [S,Q,QB],
    block_w [S,Q,QB]) -> (scores [Q,k], original ids [Q,k][, hits [Q]]):
    row 42. Ties break by ascending original id."""
    def fn(block_docs, block_tfs, doc_lens, avgdl, block_idx, block_w):
        return sharded_bm25_batch(block_docs, block_tfs, doc_lens, avgdl,
                                  block_idx, block_w, k, k1=k1, b=b,
                                  counted=counted)
    return fn


def make_sharded_sparse(n_per_shard: int, k: int):
    """fn(block_docs [S,NB,B], block_weights [S,NB,B], block_idx [S,QB],
    qw [S,QB]) -> (scores [k], mesh-global ids [k]): row 43."""
    def fn(block_docs, block_weights, block_idx, qw):
        return sharded_sparse(block_docs, block_weights, block_idx, qw,
                              n_per_shard, k)
    return fn


def make_sharded_hybrid(k: int, rank_constant: int = 60,
                        similarity: str = "cosine",
                        k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    """fn(block_docs, block_tfs, doc_lens, avgdl, block_idx, block_w,
    matrix, norms, valid, qvec [D]) -> RRF-fused (scores [k], mesh-global
    ids [k]): row 44."""
    def fn(block_docs, block_tfs, doc_lens, avgdl, block_idx, block_w,
           matrix, norms, valid, qvec):
        qn, q2 = _query_terms(qvec[None])
        return sharded_hybrid(block_docs, block_tfs, doc_lens, avgdl,
                              block_idx, block_w, matrix, norms, valid,
                              qvec, qn, q2, k, rank_constant=rank_constant,
                              similarity=similarity, k1=k1, b=b)
    return fn


def to_original_ids(ids, n_shards: int, n_per_shard: int):
    """Mesh-global ids (shard*per + local) -> original corpus ids under the
    round-robin placement; -1 (empty slot) passes through."""
    ids = np.asarray(ids)
    return np.where(ids >= 0,
                    (ids % n_per_shard) * n_shards + ids // n_per_shard,
                    -1)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the vectorised build: postings -> per-slot packed blocks
# ---------------------------------------------------------------------------

def _term_blocks(starts: np.ndarray, counts: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(block ids, owning list position) of the contiguous block ranges
    [starts[t], starts[t] + counts[t]) concatenated in list order."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    owner = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    if total == 0:
        return np.zeros(0, np.int64), owner
    first = np.cumsum(counts) - counts
    blk = np.arange(total, dtype=np.int64) - first[owner] + \
        starts.astype(np.int64)[owner]
    return blk, owner


class _Postings:
    """Postings of a whole corpus, gathered source by source on
    ``device``: global doc id g, global term id, first-appearance key (the
    position of the (source, term) pair in the JAX package's build loop)
    and value, int32 / f32 tensors."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.vocab: Dict[str, int] = {}
        self.names: List[str] = []
        self.key_base = 0
        self.parts: List[Tuple[torch.Tensor, ...]] = []

    def term_ids(self, names: Sequence[str]) -> np.ndarray:
        vocab, out = self.vocab, np.empty(len(names), np.int64)
        for j, name in enumerate(names):
            t = vocab.get(name)
            if t is None:
                t = vocab[name] = len(self.names)
                self.names.append(name)
            out[j] = t
        return out

    def add_blocks(self, names: Sequence[str], starts, counts, block_docs,
                   block_values, live, base: int) -> None:
        """One source's terms (``names`` in the source's order, each with
        its block range into the source's [NB, 128] store): every posting
        of a doc below ``len(live)`` that ``live`` marks."""
        dev = self.dev
        gterm = torch.as_tensor(self.term_ids(names), device=dev)
        blk, owner = _term_blocks(np.asarray(starts), np.asarray(counts))
        blk = torch.as_tensor(blk, device=dev)
        owner = torch.as_tensor(owner, device=dev)
        bd = torch.as_tensor(block_docs, device=dev)
        # a block whose first entry is padding holds no posting (docs
        # ascend, padding last): skip it before gathering
        full = bd[blk, 0] >= 0
        blk, owner = blk[full], owner[full]
        docs = bd[blk].reshape(-1)
        vals = torch.as_tensor(block_values, device=dev)[blk].reshape(-1)
        pos = owner.repeat_interleave(BLOCK)
        n_docs = len(live)
        live_t = torch.as_tensor(np.asarray(live, bool), device=dev)
        keep = (docs >= 0) & (docs < n_docs) & \
            live_t[docs.clamp(0, max(n_docs - 1, 0)).long()]
        pos = pos[keep]
        self.parts.append(((docs[keep] + base).to(torch.int32),
                           gterm[pos].to(torch.int32),
                           (pos + self.key_base).to(torch.int32),
                           vals[keep].to(torch.float32)))
        self.key_base += len(names)

    def arrays(self):
        if not self.parts:
            z = torch.zeros(0, dtype=torch.int32, device=self.dev)
            return z, z, z, torch.zeros(0, device=self.dev)
        return tuple(torch.cat([p[j] for p in self.parts])
                     for j in range(4))

    def df(self, gterm) -> Dict[str, int]:
        """term -> its live postings over the corpus."""
        counts = _host(torch.bincount(gterm.long(),
                                      minlength=max(len(self.names), 1)))
        return {self.names[t]: int(counts[t]) for t in np.nonzero(counts)[0]}


def _on(x, dev, dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def _block_impacts(bd, bt, doc_lens, avgdl: float) -> np.ndarray:
    """[S, nb_max] per-block max of tf / max(tf + norm, 1e-9) (0 at
    padding), norm = k1 * (1 - b + b * dl / avgdl): the JAX package's
    host computation, op for op in f32 (each division between two tensors,
    never by a scalar, which the card would take as a reciprocal
    product), on the blocks' device."""
    out = torch.zeros(bd.shape[0], bd.shape[1], dtype=torch.float32,
                      device=bd.device)
    avg = max(avgdl, 1e-9)
    for s in range(bd.shape[0]):
        v = bd[s] >= 0
        dl = doc_lens[s][torch.where(v, bd[s], 0).long()]
        norm = DEFAULT_K1 * (1.0 - DEFAULT_B + DEFAULT_B * dl /
                             torch.full_like(dl, avg))
        x = torch.where(v, bt[s] / torch.clamp_min(bt[s] + norm, 1e-9),
                        torch.zeros((), device=bd.device))
        out[s] = x.amax(dim=1)
    return _host(out)


def _pack_slots(n_shards: int, per: int, g, gterm, key, value,
                n_terms: int, device):
    """The per-slot packed blocks of a corpus's postings (global doc g,
    term, first-appearance key, value): in each slot the terms in order of
    their first key, each term's local docs ascending in 128-wide blocks
    padded with (-1, 0), one (-1, 0) block for a slot without postings, and
    every slot padded to nb_max = next_pow2 of the longest. Sorted on
    ``device``. Returns (bd [S, nb_max, 128] int32, bt [S, nb_max, 128]
    f32, [(term ids, first blocks, block counts) per slot], nb_max)."""
    dev = torch.device(device)
    # int32 on the device (ids, terms and keys stay below 2^31); the
    # per-slot sort keys are int64
    g_t = _on(g, dev, torch.int32)
    slot_t = (g_t % n_shards).to(torch.int8 if n_shards < 128
                                 else torch.int32)
    local_t = g_t // n_shards
    del g_t
    term_t = _on(gterm, dev, torch.int32)
    key_t = _on(key, dev, torch.int32)
    val_t = _on(value, dev, torch.float32)
    big = np.iinfo(np.int64).max
    picks, counts, totals = [], [], []
    for s in range(n_shards):
        sel = torch.nonzero(slot_t == s).reshape(-1)
        cnt = torch.bincount(term_t[sel], minlength=n_terms)
        picks.append(sel)
        counts.append(cnt)
        totals.append(max(int(((cnt + BLOCK - 1) // BLOCK).sum()), 1))
    del slot_t
    nb_max = next_pow2(max(totals))
    bd = torch.full((n_shards, nb_max, BLOCK), -1, dtype=torch.int32,
                    device=dev)
    bt = torch.zeros((n_shards, nb_max, BLOCK), dtype=torch.float32,
                     device=dev)
    index = []
    for s in range(n_shards):
        sel, cnt = picks[s], counts[s]
        tm, ky = term_t[sel].long(), key_t[sel].long()
        first = torch.full((n_terms,), big, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, tm, ky, reduce="amin")
        present = torch.nonzero(cnt > 0).reshape(-1)
        order = present[torch.argsort(first[present])]
        rank = torch.full((n_terms,), -1, dtype=torch.int64, device=dev)
        rank[order] = torch.arange(len(order), device=dev)
        loc = local_t[sel].long()
        perm = torch.argsort(rank[tm] * per + loc)
        tcnt = cnt[order]
        nb = (tcnt + BLOCK - 1) // BLOCK
        start = torch.cumsum(nb, 0) - nb
        r_p = rank[tm][perm]
        pos = torch.arange(len(perm), device=dev) - \
            (torch.cumsum(tcnt, 0) - tcnt)[r_p]
        cell = (start[r_p] + pos // BLOCK) * BLOCK + pos % BLOCK
        bd[s].view(-1)[cell] = loc[perm].to(torch.int32)
        bt[s].view(-1)[cell] = val_t[sel][perm]
        index.append((_host(order), _host(start), _host(nb)))
        picks[s] = counts[s] = None
    return bd, bt, index, nb_max


def _term_dicts(index, names: Sequence[str]
                ) -> List[Dict[str, Tuple[int, int]]]:
    return [dict(zip([names[t] for t in terms.tolist()],
                     zip(start.tolist(), nb.tolist())))
            for terms, start, nb in index]


# ---------------------------------------------------------------------------
# sharded kNN
# ---------------------------------------------------------------------------

class ShardedVectorIndex:
    """Corpus of vectors partitioned over the mesh 'shard' axis."""

    def __init__(self, mesh: Mesh, vectors: np.ndarray,
                 similarity: str = "cosine",
                 n_per_shard: Optional[int] = None):
        self.mesh = mesh
        n_shards = mesh.n_slots
        vectors = np.asarray(vectors)
        n, d = vectors.shape
        self.n_docs = n
        per = n_per_shard or next_pow2(max(-(-n // n_shards), 1), minimum=8)
        self.n_per_shard = per
        # round-robin placement: doc g at slot g % S, local g // S
        flat = np.zeros((per * n_shards, d), np.float32)
        flat[:n] = vectors
        mat = np.ascontiguousarray(
            flat.reshape(per, n_shards, d).transpose(1, 0, 2))
        del flat
        valid = np.zeros(per * n_shards, bool)
        valid[:n] = True
        valid = np.ascontiguousarray(valid.reshape(per, n_shards).T)
        norms = np.linalg.norm(mat, axis=2).astype(np.float32)
        dev = mesh.device
        self.matrix = torch.as_tensor(mat, device=dev)
        self.norms = torch.as_tensor(norms, device=dev)
        self.valid = torch.as_tensor(valid, device=dev)
        self.similarity = similarity

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.matrix, self.norms, self.valid))

    def search(self, queries: np.ndarray, k: int):
        """queries [B, D] -> (scores [B, k], original doc ids [B, k]) as
        host arrays."""
        q = np.asarray(queries, np.float32)
        qn, q2 = query_norms(q)
        dev = self.mesh.device
        s, i = sharded_knn(self.matrix, self.norms, self.valid,
                           torch.as_tensor(q, device=dev),
                           torch.as_tensor(qn, device=dev),
                           torch.as_tensor(q2, device=dev), k,
                           self.similarity)
        return _host(s), to_original_ids(
            _host(i), self.mesh.n_slots, self.n_per_shard)


# ---------------------------------------------------------------------------
# sharded BM25
# ---------------------------------------------------------------------------

class ShardedTextIndex:
    """Text corpus partitioned by doc over the mesh 'shard' axis, with
    corpus-GLOBAL document frequencies so every shard scores with the same
    idf.

    The reference routes docs to shards by murmur3 and each shard builds its
    own Lucene index; idf consistency comes from the optional DFS phase. Here
    per-shard dfs are summed host-side at build time for exact global idf,
    and the per-query host prep emits one gather list per shard.
    """

    def __init__(self, mesh: Mesh, docs_terms: Sequence[Sequence[str]],
                 qb_bucket_min: int = 8):
        n_shards = mesh.n_slots
        n = len(docs_terms)
        per = next_pow2(max(-(-n // n_shards), 1), minimum=BLOCK)
        lens = np.fromiter((len(t) for t in docs_terms), np.int64, n)
        tokens: List[str] = [t for terms in docs_terms for t in terms]
        post = _Postings(mesh.device)
        tok_term = post.term_ids(tokens)
        tok_doc = np.repeat(np.arange(n, dtype=np.int64), lens)
        n_terms = max(len(post.names), 1)
        # one posting per (doc, term): tf = its token count, key = its
        # first token's position (the build loop's first insertion)
        pair = tok_doc * n_terms + tok_term
        uniq, first, tf = np.unique(pair, return_index=True,
                                    return_counts=True)
        g, gterm = uniq // n_terms, uniq % n_terms
        doc_lens = np.zeros((n_shards, per), np.float32)
        doc_lens[np.arange(n) % n_shards, np.arange(n) // n_shards] = lens
        df_arr = np.bincount(gterm, minlength=n_terms)
        df = {post.names[t]: int(df_arr[t]) for t in np.nonzero(df_arr)[0]}
        self._finish_init(mesh, n, per, g, gterm, first.astype(np.int64),
                          tf.astype(np.float32), post.names, doc_lens, df,
                          qb_bucket_min)

    @classmethod
    def from_postings_sources(cls, mesh: Mesh, sources,
                              qb_bucket_min: int = 8) -> "ShardedTextIndex":
        """Build directly from already-indexed postings instead of raw docs.

        ``sources``: ordered [(postings_field_or_None, live_mask, n_docs)]
        — one entry per source segment, concatenated into a global doc
        space (global id g = segment base + local doc). Tombstoned docs are
        dropped at build time (the mesh copy is born merged), so df and
        doc_lens reflect live docs only."""
        obj = cls.__new__(cls)
        n_shards = mesh.n_slots
        n = sum(n_docs for _, _, n_docs in sources)
        per = next_pow2(max(-(-n // n_shards), 1), minimum=BLOCK)
        doc_lens = np.zeros((n_shards, per), np.float32)
        post = _Postings(mesh.device)
        base = 0
        for pf, live, n_docs in sources:
            if pf is None or n_docs == 0:
                base += n_docs
                continue
            live = np.asarray(live[:n_docs], bool)
            g = base + np.arange(n_docs)
            lens = np.where(live, pf.doc_lens[:n_docs], 0.0)
            doc_lens[g % n_shards, g // n_shards] = lens
            names = list(pf.terms)
            tids = np.fromiter(pf.terms.values(), np.int64, len(names))
            post.add_blocks(names, pf.term_block_start[tids],
                            pf.term_block_count[tids], pf.block_docs,
                            pf.block_tfs, live, base)
            base += n_docs
        g, gterm, key, tf = post.arrays()
        tf = torch.trunc(tf)      # the build loop stores int(tf)
        obj._finish_init(mesh, n, per, g, gterm, key, tf, post.names,
                         doc_lens, post.df(gterm), qb_bucket_min)
        return obj

    def _finish_init(self, mesh: Mesh, n: int, per: int, g, gterm, key, tf,
                     names: Sequence[str], doc_lens: np.ndarray,
                     df: Dict[str, int], qb_bucket_min: int) -> None:
        self.mesh = mesh
        n_shards = mesh.n_slots
        self.n_shards = n_shards
        self.n_docs = n
        self.n_per_shard = per
        self.df = df
        dev = mesh.device
        bd_t, bt_t, index, nb_max = _pack_slots(
            n_shards, per, g, gterm, key, tf, max(len(names), 1), dev)
        self.nb_max = nb_max
        self.term_index: List[Dict[str, Tuple[int, int]]] = _term_dicts(
            index, names)
        self.block_docs = bd_t
        self.block_tfs = bt_t
        self.doc_lens = torch.as_tensor(doc_lens, device=dev)
        bd, bt = _host(bd_t), _host(bt_t)
        total_len = float(doc_lens.sum())
        self.avgdl = total_len / max(1, n)
        # per-shard block-max impact bounds for WAND pruning (default
        # similarity params — PostingsField.block_max_impact analog)
        self._impacts = _block_impacts(bd_t, bt_t, self.doc_lens,
                                       self.avgdl)
        self._cell_indexes = [
            TermCellIndex(bd[s], bt[s], doc_lens[s], self.avgdl)
            for s in range(n_shards)]
        self.qb_bucket_min = qb_bucket_min
        self.last_prune_stats: Tuple[int, int] = (0, 0)
        self.last_hits_exact = True

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.block_docs, self.block_tfs, self.doc_lens))

    def prep_query(self, terms: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Host prep: per-shard gather indices + per-block weights from
        GLOBAL df (exact idf, no DFS round needed)."""
        per_idx: List[List[np.ndarray]] = [[] for _ in range(self.n_shards)]
        per_w: List[List[np.ndarray]] = [[] for _ in range(self.n_shards)]
        # dedupe but keep ES match semantics: a repeated query term is a
        # repeated bool clause, so its weight scales with multiplicity (qtf)
        # — same scoring as Bm25Executor.query_weights on the segment path.
        # Entries may be (term, boost) pairs (bool/should clause boosts).
        for t, qtf in Counter(terms).items():
            boost = 1.0
            if isinstance(t, tuple):
                t, boost = t
            df = self.df.get(t, 0)
            if df <= 0:
                continue
            w = idf_fn(self.n_docs, df) * qtf * float(boost)
            for s in range(self.n_shards):
                entry = self.term_index[s].get(t)
                if entry is None:
                    continue
                start, count = entry
                per_idx[s].append(np.arange(start, start + count,
                                            dtype=np.int32))
                per_w[s].append(np.full(count, w, np.float32))
        lens = [sum(len(a) for a in x) for x in per_idx]
        qb = max(max(lens, default=1), 1)
        qb_pad = next_pow2(qb, minimum=self.qb_bucket_min)
        idx = np.zeros((self.n_shards, qb_pad), np.int32)
        w = np.zeros((self.n_shards, qb_pad), np.float32)
        for s in range(self.n_shards):
            if per_idx[s]:
                idx[s, : lens[s]] = np.concatenate(per_idx[s])
                w[s, : lens[s]] = np.concatenate(per_w[s])
        return idx, w

    def search(self, terms: Sequence[str], k: int):
        """One query through row 41 -> (scores [k], original ids [k])."""
        idx, w = self.prep_query(terms)
        dev = self.mesh.device
        s, i = sharded_bm25(self.block_docs, self.block_tfs, self.doc_lens,
                            self.avgdl, torch.as_tensor(idx, device=dev),
                            torch.as_tensor(w, device=dev), k)
        return _host(s), to_original_ids(_host(i), self.n_shards,
                                         self.n_per_shard)

    # -- batched + block-max-pruned path ------------------------------------

    def _plans(self, terms: Sequence[str]) -> List[QueryPlan]:
        """One WAND block plan per shard for one query (global idf)."""
        tw = []
        # dedupe keeping order, weight scaled by query-term multiplicity
        # (qtf) to match the repeated-bool-clause semantics of the segment
        # executor (see prep_query); entries may be (term, boost) pairs
        for t, qtf in Counter(terms).items():
            boost = 1.0
            if isinstance(t, tuple):
                t, boost = t
            df = self.df.get(t, 0)
            if df > 0:
                tw.append((t, idf_fn(self.n_docs, df) * qtf * float(boost)))
        out = []
        for s in range(self.n_shards):
            out.append(build_query_plan(
                tw, lambda t, s=s: self.term_index[s].get(t, (0, 0)),
                self._impacts[s], cell_index=self._cell_indexes[s]))
        return out

    def hits_upper(self, terms) -> int:
        """df-based upper bound on matching docs (df per distinct term;
        overlap only lowers the true union)."""
        seen = set()
        total = 0
        for t in terms:
            if isinstance(t, tuple):
                t = t[0]
            if t in seen:
                continue
            seen.add(t)
            total += int(self.df.get(t, 0))
        return total

    def _run_batch(self, k: int, counted: bool,
                   plans: List[List[QueryPlan]], qb_pad: int):
        """plans[q][s] -> one row-42 launch over all (query, shard); host
        arrays back."""
        n_q = len(plans)
        idx = np.zeros((self.n_shards, n_q, qb_pad), np.int32)
        w = np.zeros((self.n_shards, n_q, qb_pad), np.float32)
        for q, per_shard in enumerate(plans):
            for s, p in enumerate(per_shard):
                idx[s, q, : p.n_blocks] = p.idx
                w[s, q, : p.n_blocks] = p.w
        dev = self.mesh.device
        out = sharded_bm25_batch(self.block_docs, self.block_tfs,
                                 self.doc_lens, self.avgdl,
                                 torch.as_tensor(idx, device=dev),
                                 torch.as_tensor(w, device=dev), k,
                                 counted=counted)
        return tuple(_host(t) for t in out)

    def search_batch(self, queries: Sequence[Sequence[str]], k: int,
                     prune: bool = True, count_hits: bool = False):
        """Q queries -> (scores [Q,k], original corpus doc ids [Q,k]) in two
        launches (phase-1 theta + phase-2 exact over survivors).
        See ops/bm25.py Bm25Executor.top_k_batch for the soundness
        argument; here phase-1 theta comes from the GLOBAL top-k across
        shards, so pruning tightens with every shard's evidence.

        With ``count_hits`` a third return carries matched-doc counts
        [Q] from the score plane; ``last_hits_exact`` records whether
        every block was gathered (exact) or only survivors (lower
        bound)."""
        p1_bucket = P1_BUCKET     # read at call time: tests pin a small one
        plans = [self._plans(t) for t in queries]
        total = sum(p.n_blocks for per in plans for p in per)
        qb_max = max((p.n_blocks for per in plans for p in per), default=1)
        qb_pad = qb_bucket(max(qb_max, 1))
        if not prune or qb_max <= p1_bucket:
            # every plan fits phase 1 whole — pruning cannot pay
            self.last_prune_stats = (total, total)
            self.last_hits_exact = True
            return self._run_batch(k, count_hits, plans, qb_pad)
        p1 = [[p.top_by_ub(p1_bucket) for p in per] for per in plans]
        s1 = self._run_batch(k, False, p1, p1_bucket)[0]
        theta = s1[:, k - 1]
        p2 = [[p.survivors(float(theta[q])) for p in per]
              for q, per in enumerate(plans)]
        scored = sum(p.n_blocks for per in p2 for p in per)
        p1_cost = sum(p.n_blocks for per in p1 for p in per)
        self.last_prune_stats = (total, min(scored + p1_cost, total))
        self.last_hits_exact = scored >= total
        qb2_max = max((p.n_blocks for per in p2 for p in per), default=1)
        qb2 = qb_bucket(max(qb2_max, 1))
        return self._run_batch(k, count_hits, p2, qb2)


# ---------------------------------------------------------------------------
# sharded sparse (rank_features / text_expansion)
# ---------------------------------------------------------------------------

class ShardedFeaturesIndex:
    """rank_features corpus partitioned by doc over the mesh 'shard' axis
    (the text_expansion serving substrate — ShardedTextIndex's layout with
    stored weights instead of tfs and linear scoring)."""

    @classmethod
    def from_features_sources(cls, mesh: Mesh, sources,
                              qb_bucket_min: int = 8
                              ) -> "ShardedFeaturesIndex":
        """``sources``: ordered [(features_field_or_None, live, n_docs)]
        concatenated into a global doc space; tombstones dropped at build
        time."""
        obj = cls.__new__(cls)
        n_shards = mesh.n_slots
        n = sum(n_docs for _, _, n_docs in sources)
        per = next_pow2(max(-(-n // max(n_shards, 1)), 1), minimum=BLOCK)
        post = _Postings(mesh.device)
        base = 0
        for ff, live, n_docs in sources:
            if ff is None or n_docs == 0:
                base += n_docs
                continue
            names = list(ff.features)
            fids = np.fromiter(ff.features.values(), np.int64, len(names))
            post.add_blocks(names, ff.feat_block_start[fids],
                            ff.feat_block_count[fids], ff.block_docs,
                            ff.block_weights,
                            np.asarray(live[:n_docs], bool), base)
            base += n_docs
        g, gterm, key, w = post.arrays()
        dev = mesh.device
        bd_t, bw_t, index, nb_max = _pack_slots(
            n_shards, per, g, gterm, key, w, max(len(post.names), 1), dev)
        obj.term_index = _term_dicts(index, post.names)
        obj.nb_max = nb_max
        obj.mesh = mesh
        obj.n_shards = n_shards
        obj.n_docs = n
        obj.n_per_shard = per
        obj.qb_bucket_min = qb_bucket_min
        obj.block_docs = bd_t
        obj.block_weights = bw_t
        return obj

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.block_docs, self.block_weights))

    def _prep(self, expansion) -> Tuple[np.ndarray, np.ndarray]:
        per_idx: List[List[np.ndarray]] = [[] for _ in range(self.n_shards)]
        per_w: List[List[np.ndarray]] = [[] for _ in range(self.n_shards)]
        for feat, weight in expansion:
            for s in range(self.n_shards):
                entry = self.term_index[s].get(feat)
                if entry is None:
                    continue
                start, count = entry
                per_idx[s].append(np.arange(start, start + count,
                                            dtype=np.int32))
                per_w[s].append(np.full(count, float(weight), np.float32))
        lens = [sum(len(a) for a in x) for x in per_idx]
        qb = max(max(lens, default=1), 1)
        qb_pad = next_pow2(qb, minimum=self.qb_bucket_min)
        idx = np.zeros((self.n_shards, qb_pad), np.int32)
        w = np.zeros((self.n_shards, qb_pad), np.float32)
        for s in range(self.n_shards):
            if per_idx[s]:
                idx[s, : lens[s]] = np.concatenate(per_idx[s])
                w[s, : lens[s]] = np.concatenate(per_w[s])
        return idx, w

    def search_batch(self, expansions, k: int):
        """[(feature, weight)] expansions -> (scores [Q, k], original ids
        [Q, k]); one launch per query (expansions are tens of features —
        the gather is tiny)."""
        out_s, out_i = [], []
        dev = self.mesh.device
        for expansion in expansions:
            idx, w = self._prep(expansion)
            s, i = sharded_sparse(self.block_docs, self.block_weights,
                                  torch.as_tensor(idx, device=dev),
                                  torch.as_tensor(w, device=dev),
                                  self.n_per_shard, k)
            out_s.append(_host(s))
            out_i.append(to_original_ids(_host(i), self.n_shards,
                                         self.n_per_shard))
        return np.stack(out_s), np.stack(out_i)
