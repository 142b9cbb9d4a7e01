"""Dense-vector kNN on the card: the exact batched top-k and the two
passes of the quantized tier.

The JAX package's ``ops/knn.py``: the single-query, batched, masked and
unmasked programs. Four kernel families, each a hand-written CUDA kernel
(``csrc/<family>.cu``) behind a wrapper, with its plain PyTorch version
beside it:

- ``knn_flat`` (K5): queries x matrix in bf16 with f32 sums, the
  similarity transform, the ``allowed`` mask (ANDed with each query's own
  filter row when a ``[B, N_pad]`` mask stack is given: the JAX package's
  ``knn_topk_batch_masked``) and the top-k per query (at one query it
  also serves the JAX package's ``knn_topk``); on the card a bf16
  tensor-core screen with a proven bound, then an exact re-score of the
  docs that could reach the top k (``screen_*`` below mirror it);
- ``knn_coarse`` (K6): int8 queries x the plane's int8 mirror with int32
  sums (int8 tensor cores on the card), rescaled, transformed and masked
  (optionally per query), the top-k' candidates;
- ``knn_rerank`` (K7): the candidates sorted by doc id and re-scored with
  K5's arithmetic, masked (optionally per query, at the candidates), the
  top-k and ``eps`` = max |exact - coarse|;
- ``knn_scores`` (K9): one query's dense similarity row with K5's
  arithmetic, 0 at missing vectors (``vector_scores``: ``script_score``).

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; there is no fallback between the two. K5 and K6 select
with a row-batched radix select over a threshold taken from each 128-doc
tile's best scores (``tile_threshold``); a row that threshold cannot
serve is selected over its whole row, counted by ``full_rows``. A call
with a mask stack is profiled as ``<family>_masked``: one launch of the
same kernel with one more operand, counted apart so a run can tell
filtered launches from unfiltered ones. Each dot product is
summed in f32 in dimension order, one query-doc pair at a time (the
product of two bf16 values is exact in f32, so an FMA changes nothing),
and every transform op is one rounded f32 op: kernel and plain version
agree bit for bit, and a row's scores do not depend on the batch it rode
in. Top-k order is score descending, then index ascending, -inf slots
included (``lax.top_k``'s order).

The glue is computed once per query batch on the host (``QueryBatch``):
pow2 padding of the rows, each row's ``q2`` = q . q summed in dimension
order and ``qn`` = sqrt(q2) + 1e-30, and the int8 quantization of the
rows; the same tensors go to a kernel and to its plain version.

Scores use the transforms ES applies to keep them positive:

  cosine:      (1 + cos) / 2
  dot_product: 0.5 + dot / 2
  l2_norm:     1 / (1 + dist)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import next_pow2
from elasticsearch_tpu_torch.ops.bm25 import (
    _check, _on_cuda, _ptr, _stream, launch_kernel, stable_topk,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

# the kernels' limits (csrc/topk_common.cuh KMAX: the largest k' of the
# coarse and re-rank passes; knn_common.cuh)
KMAX = 4096
MAX_DIMS = 4096
# csrc/knn_tc.cuh: docs a tile, most tops a tile, the bf16 stage's dims
TILE = 128
TOPS_MAX = 32
SCREEN_BK = 64
_U = 2.0 ** -24
_SCREEN_ABS = 2.0 ** -100
SPLIT = ("scores", "threshold", "list", "rescore", "final")
SIMILARITY_CODES = {"cosine": 0, "dot_product": 1, "l2_norm": 2}


# ---------------------------------------------------------------------------
# host glue, computed once per query batch
# ---------------------------------------------------------------------------

def pad_queries_pow2(queries) -> Tuple[np.ndarray, int]:
    """Pad the query batch to a pow2 row count (zeros); returns (padded,
    n_real). One implementation shared by the exact executor and the
    quantized plane pass, so their pads stay in lockstep."""
    q_host = np.asarray(queries, np.float32)
    n_real = q_host.shape[0]
    n_pad = next_pow2(max(n_real, 1), minimum=1)
    if n_pad != n_real:
        q_host = np.concatenate(
            [q_host, np.zeros((n_pad - n_real, q_host.shape[1]),
                              np.float32)])
    return q_host, n_real


def pad_mask_rows_pow2(masks, n_pad: int) -> np.ndarray:
    """Stacked per-query filter masks padded to the query batch's pow2
    row count; padded rows stay False (they match nothing)."""
    m = np.asarray(masks)
    out = np.zeros((n_pad, m.shape[1]), bool)
    out[: m.shape[0]] = m
    return out


def query_norms(q_host: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(qn, q2) per row, f32: q2 = q . q summed in dimension order (a
    sequential accumulate, so it has the same bits on every machine), and
    qn = sqrt(q2) + 1e-30, the cosine transform's query norm."""
    q = np.asarray(q_host, np.float32)
    if q.shape[1] == 0:
        q2 = np.zeros(q.shape[0], np.float32)
    else:
        q2 = np.add.accumulate(q * q, axis=1, dtype=np.float32)[:, -1]
    qn = np.sqrt(q2) + np.float32(1e-30)
    return qn.astype(np.float32), q2.astype(np.float32)


def quantize_queries(q_host: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization of the query batch (the doc
    side is quantized once, when the plane's mirror is built): (qq int8
    [B, D], qscale f32 [B])."""
    q = np.asarray(q_host, np.float32)
    qmax = np.abs(q).max(axis=1)
    qscale = np.maximum(qmax / np.float32(127.0), np.float32(1e-30))
    qq = np.clip(np.round(q / qscale[:, None]), -127, 127).astype(np.int8)
    return qq, qscale.astype(np.float32)


class QueryBatch:
    """A query batch on a device: the pow2-padded rows, their (qn, q2), and
    lazily their int8 quantization; ``n_real`` rows are real."""

    def __init__(self, queries, device):
        q_host, self.n_real = pad_queries_pow2(queries)
        self.host = q_host
        qn, q2 = query_norms(q_host)
        self.device = torch.device(device)
        self.queries = torch.as_tensor(q_host, device=self.device)
        self.qn = torch.as_tensor(qn, device=self.device)
        self.q2 = torch.as_tensor(q2, device=self.device)
        self._quantized: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def quantized(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._quantized is None:
            qq, qscale = quantize_queries(self.host)
            self._quantized = (torch.as_tensor(qq, device=self.device),
                               torch.as_tensor(qscale, device=self.device))
        return self._quantized


# ---------------------------------------------------------------------------
# plain versions (run for CPU tensors; chip_smoke.py holds the kernels
# against them on the card)
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _similarity(dots, norms, qn, q2, similarity: str) -> torch.Tensor:
    """The transform of ``_coarse_similarity`` / ``_rerank_scores``, one
    correctly rounded f32 op at a time in the JAX package's order, except
    that norms * norms + q2 is rounded once (XLA compiles it into one fused
    multiply-add; the exact product is formed in f64). ``dots`` and
    ``norms`` broadcast to [B, n]; ``qn``/``q2`` are [B]."""
    if similarity == "dot_product":
        return 0.5 + dots / 2.0
    if similarity == "cosine":
        return (1.0 + dots / (norms * qn[:, None] + 1e-30)) / 2.0
    nd = norms.double()
    n2q2 = (nd * nd + q2.double()[:, None]).float()
    d2 = torch.clamp_min(n2q2 - 2.0 * dots, 0.0)
    # torch's f32 sqrt on the CPU can miss the correct rounding by an ulp;
    # the f64 root rounded to f32 is the correctly rounded f32 root
    return 1.0 / (1.0 + torch.sqrt(d2.double()).float())


def _neg_inf(t: torch.Tensor) -> torch.Tensor:
    return torch.full((), -torch.inf, device=t.device)


def _flat_dots(matrix, queries) -> torch.Tensor:
    """[B, N_pad] dots of bf16-rounded operands, summed in f32 in
    dimension order."""
    n_q, dims = queries.shape
    qb = _bf16(queries)
    cols = _bf16(matrix).t().contiguous()               # [D, N_pad]
    acc = torch.zeros(n_q, matrix.shape[0], dtype=torch.float32,
                      device=matrix.device)
    for d in range(dims):           # f32 sums in dimension order
        # in place; the product of two bf16 values is exact in f32, so
        # this rounds once, as a multiply then an add would
        acc.addcmul_(qb[:, d:d + 1], cols[d][None, :])
    return acc


def _row_mask(allowed, masks):
    """[1 or B, N_pad] eligibility: ``allowed`` ANDed with the per-query
    filter rows when a stack is given."""
    return allowed[None, :] if masks is None else allowed[None, :] & masks


def knn_flat_plain(matrix, norms, allowed, queries, qn, q2, k: int,
                   similarity: str = "cosine", masks=None):
    s = _similarity(_flat_dots(matrix, queries), norms[None, :], qn, q2,
                    similarity)
    s = torch.where(_row_mask(allowed, masks), s, _neg_inf(s))
    return stable_topk(s, k)


def vector_scores_plain(matrix, norms, exists, query, qn, q2,
                        similarity: str = "cosine") -> torch.Tensor:
    s = _similarity(_flat_dots(matrix, query[None, :]), norms[None, :], qn,
                    q2, similarity)[0]
    return torch.where(exists, s, torch.zeros((), device=s.device))


def coarse_scores_plain(q8, scales, norms, allowed, qq, qscale, qn, q2,
                        similarity: str = "cosine", masks=None):
    """[B, N_pad] f32: K6's masked coarse plane."""
    n_q, dims = qq.shape
    qi = qq.to(torch.int32)
    cols = q8.t().to(torch.int32).contiguous()          # [D, N_pad]
    acc = torch.zeros(n_q, q8.shape[0], dtype=torch.int32,
                      device=q8.device)
    for d in range(dims):           # exact in any order
        acc += qi[:, d:d + 1] * cols[d][None, :]
    del cols
    dots = acc.float() * (qscale[:, None] * scales[None, :])
    s = _similarity(dots, norms[None, :], qn, q2, similarity)
    return torch.where(_row_mask(allowed, masks), s, _neg_inf(s))


def knn_coarse_plain(q8, scales, norms, allowed, qq, qscale, qn, q2,
                     kprime: int, similarity: str = "cosine", masks=None):
    return stable_topk(coarse_scores_plain(q8, scales, norms, allowed, qq,
                                           qscale, qn, q2, similarity,
                                           masks), kprime)


def knn_rerank_plain(matrix, norms, allowed, queries, qn, q2, cand,
                     coarse_s, k: int, similarity: str = "cosine",
                     masks=None):
    order = torch.argsort(cand, dim=1, stable=True)
    cand_s = torch.gather(cand, 1, order)
    cs_s = torch.gather(coarse_s, 1, order)
    idx = cand_s.long()
    rows = _bf16(matrix[idx])                           # [B, k', D]
    qb = _bf16(queries)
    acc = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for d in range(queries.shape[1]):
        acc = acc + qb[:, d:d + 1] * rows[:, :, d]
    s = _similarity(acc, norms[idx], qn, q2, similarity)
    ok = allowed[idx]
    if masks is not None:
        ok = ok & torch.gather(masks, 1, idx)
    ts, pos = stable_topk(torch.where(ok, s, _neg_inf(s)), k)
    td = torch.gather(cand_s, 1, pos.long())
    td = torch.where(torch.isfinite(ts), td, torch.full_like(td, -1))
    both = ok & torch.isfinite(cs_s)
    eps = torch.where(both, (s - cs_s).abs(),
                      torch.zeros((), device=s.device)).amax(dim=1)
    return ts, td, eps


# ---------------------------------------------------------------------------
# the card's method in plain PyTorch (csrc/knn_tc.cuh): the tile
# threshold, K5's screen and K6's listing; the CPU tests hold them
# against the plain versions
# ---------------------------------------------------------------------------

def tile_tops_per(n_cols: int, k: int) -> int:
    """t, the tops kept a 128-doc tile: a power of two, at least 2 and at
    least 2k / tiles; 0 where that passes TOPS_MAX (every row is then
    selected whole)."""
    n_tiles = -(-n_cols // TILE)
    t = 2
    while t * n_tiles < 2 * k:
        t *= 2
    return t if t <= TOPS_MAX else 0


def list_cap(k: int) -> int:
    """Entries a row's list holds (csrc/knn_tc.cuh ``layout``)."""
    return 2 * k + 2048


def tile_threshold(values: torch.Tensor, k: int) -> torch.Tensor:
    """[B] f32 tau: the k-th largest of each row's tile tops (the t
    largest values of every 128-column tile, the tail tile padded with
    -inf), -inf for every row when the tops cannot hold k. At least k
    distinct columns hold a value >= tau, so tau never exceeds the row's
    k-th largest value."""
    b, n = values.shape
    t = tile_tops_per(n, k)
    if t == 0:
        return torch.full((b,), -torch.inf, device=values.device)
    n_tiles = -(-n // TILE)
    pad = torch.full((b, n_tiles * TILE), -torch.inf, device=values.device)
    pad[:, :n] = values
    tops = torch.topk(pad.view(b, n_tiles, TILE), t, dim=2).values
    return torch.topk(tops.reshape(b, -1), k, dim=1).values[:, k - 1]


def select_listed(values: torch.Tensor, keep: torch.Tensor, k: int,
                  cap: int) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The final selection: each row's best k (``lax.top_k``'s order)
    among its kept columns, or among all of them where the row has fewer
    than k kept or more than ``cap`` (its list overflowed). Every kept
    value is finite. Returns (s, d, whole) with ``whole`` [B] bool the
    rows selected over the whole row."""
    n_keep = keep.sum(dim=1)
    whole = (n_keep < k) | (n_keep > cap)
    listed = torch.where(keep | whole[:, None], values, _neg_inf(values))
    s, d = stable_topk(listed, k)
    return s, d, whole


def knn_coarse_listed(scores: torch.Tensor, k: int):
    """K6's selection over its exact coarse plane ``scores`` [B, N]
    (masked -inf): tau from the tile tops, the columns that reach it, the
    best k among them (or over the whole row where tau is -inf or the
    list overflows). Equal to ``stable_topk(scores, k)``; returns (s, d,
    whole)."""
    tau = tile_threshold(scores, k)
    keep = (scores >= tau[:, None]) & (tau[:, None] > -torch.inf)
    return select_listed(scores, keep, k, list_cap(k))


def screen_gamma(dims: int) -> float:
    """K5's bound on |dot_tc - dot_plain| / (|x^| |q^|): 5 D 2^-24
    (1 + 2^-8) over D padded to a multiple of 64 (csrc/knn_tc.cuh section
    4, csrc/ivf_assign.cu's derivation)."""
    dp = -(-dims // SCREEN_BK) * SCREEN_BK
    return 5.0 * dp * _U * (1.0 + 2.0 ** -8)


def screen_norms(m: torch.Tensor) -> torch.Tensor:
    """[rows] f32: each bf16-rounded row's L2 norm inflated by 2^-10, as
    the screen computes |x^| and |q^| while staging."""
    b = _bf16(m)
    return torch.sqrt((b * b).sum(dim=1)) * (1.0 + 2.0 ** -10)


def screen_bound(matrix: torch.Tensor, queries: torch.Tensor
                 ) -> torch.Tensor:
    """[B, N] f32: e = |x^| |q^| gamma (1 + 2^-8) + 2^-100, the most by
    which a tensor-core dot of the bf16 operands may stand from the plain
    dot."""
    g1 = screen_gamma(matrix.shape[1]) * (1.0 + 2.0 ** -8)
    p = screen_norms(queries)[:, None] * screen_norms(matrix)[None, :]
    return p * g1 + _SCREEN_ABS


def screen_bounds(dots, matrix, norms, allowed, queries, qn, q2,
                  similarity: str = "cosine", masks=None):
    """(lo, hi) [B, N] f32: the transform of dots -/+ e for screen sums
    ``dots`` (any summation order of the bf16 products), -inf where the
    doc is masked; lo <= the plain score <= hi, bit for bit."""
    e = screen_bound(matrix, queries)
    ok = _row_mask(allowed, masks)
    lo = _similarity(dots - e, norms[None, :], qn, q2, similarity)
    hi = _similarity(dots + e, norms[None, :], qn, q2, similarity)
    return (torch.where(ok, lo, _neg_inf(lo)),
            torch.where(ok, hi, _neg_inf(hi)))


def screen_candidates(dots, matrix, norms, allowed, queries, qn, q2, k: int,
                      similarity: str = "cosine", masks=None):
    """bool [B, N]: the docs K5's screen lists for re-scoring, the upper
    bounds that reach tau, the k-th largest tile top of the lower bounds
    (none where tau is -inf: that row is scored whole)."""
    lo, hi = screen_bounds(dots, matrix, norms, allowed, queries, qn, q2,
                           similarity, masks)
    tau = tile_threshold(lo, k)
    return (hi >= tau[:, None]) & (tau[:, None] > -torch.inf)


def knn_flat_screened(dots, matrix, norms, allowed, queries, qn, q2, k: int,
                      similarity: str = "cosine", masks=None):
    """K5's answer from screen sums ``dots``: the exact scores of the
    screened docs (or of every doc of a row the screen cannot decide), the
    best k of them. Equal to ``knn_flat_plain``; returns (s, d, whole)."""
    keep = screen_candidates(dots, matrix, norms, allowed, queries, qn, q2,
                             k, similarity, masks)
    exact = _similarity(_flat_dots(matrix, queries), norms[None, :], qn, q2,
                        similarity)
    exact = torch.where(_row_mask(allowed, masks), exact, _neg_inf(exact))
    return select_listed(exact, keep, k, list_cap(k))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SIG = {
    "knn_flat": ["p"] * 7 + ["i", "i", "ll", "i", "i"] + ["p"] * 7,
    "knn_coarse": ["p"] * 9 + ["i", "i", "ll", "i", "i"] + ["p"] * 6,
    "knn_rerank": ["p"] * 9 + ["i", "ll"] + ["i"] * 4 + ["p"] * 4,
    "knn_scores": ["p"] * 6 + ["i", "ll", "i"] + ["p"] * 2,
}
_SCRATCH_FNS: Dict[str, object] = {}
# the rows each card family selected over the whole row (K6) or scored in
# the exact branch (K5): a device counter a (family, device)
_FULL: Dict[Tuple[str, str], torch.Tensor] = {}


def _launch(family: str, *args) -> None:
    launch_kernel(family, _SIG[family], *args)


@functools.lru_cache(maxsize=4096)
def scratch_bytes(family: str, *shape: int) -> int:
    """Bytes of one launch's scratch, from the kernel's own
    ``<family>_scratch`` (shape: [n_slots,] n_q, dims, n_docs_pad, k)."""
    fn = _SCRATCH_FNS.get(family)
    if fn is None:
        from elasticsearch_tpu_torch._build import library
        fn = getattr(library(family), f"{family}_scratch")
        fn.restype = ctypes.c_longlong
        fn.argtypes = ([ctypes.c_int] * (len(shape) - 2)
                       + [ctypes.c_longlong, ctypes.c_int])
        _SCRATCH_FNS[family] = fn
    return int(fn(*shape))


def full_counter(family: str, dev) -> torch.Tensor:
    """The device counter of ``family``'s whole-row selections on ``dev``
    (int32 [1]); the kernel adds to it, nothing reads it on the way."""
    key = (family, str(dev))
    t = _FULL.get(key)
    if t is None:
        t = _FULL[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def full_rows() -> Dict[str, int]:
    """family -> rows selected whole (K6, row 36) or scored by the exact
    branch (K5, row 39) on the card since ``reset_full_rows``
    (synchronises)."""
    out: Dict[str, int] = {}
    for (fam, _dev), t in _FULL.items():
        out[fam] = out.get(fam, 0) + int(t.item())
    return out


def reset_full_rows() -> None:
    for t in _FULL.values():
        t.zero_()


def split_buffer(split: bool):
    """(a host float array for a launch's stage times, its address or 0)."""
    if not split:
        return None, 0
    arr = (ctypes.c_float * len(SPLIT))()
    return arr, ctypes.addressof(arr)


def split_of(arr) -> Dict[str, float]:
    """Stage milliseconds by name, with their sum as ``selection`` for
    the threshold, the list and the final selection."""
    ms = {name: float(arr[i]) for i, name in enumerate(SPLIT)}
    ms["selection"] = ms["threshold"] + ms["list"] + ms["final"]
    return ms


def _sim_code(similarity: str) -> int:
    code = SIMILARITY_CODES.get(similarity)
    if code is None:
        raise ValueError(f"unknown similarity [{similarity}]")
    return code


def _check_rows(name: str, t: torch.Tensor, dtype) -> Tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"[{name}] must be 2-d, got {tuple(t.shape)}")
    _check(name, t, dtype, t.shape)
    if not 1 <= t.shape[1] <= MAX_DIMS:
        raise ValueError(f"[{name}] dims {t.shape[1]} outside "
                         f"[1, {MAX_DIMS}]")
    if t.data_ptr() % 4:    # knn_coarse reads int8 rows 4 bytes at a time
        raise ValueError(f"[{name}] must be 4-byte aligned")
    return t.shape[0], t.shape[1]


def _check_query_terms(qn, q2, n_q: int) -> None:
    _check("qn", qn, torch.float32, (n_q,))
    _check("q2", q2, torch.float32, (n_q,))


def _check_k(name: str, k: int, n: int, cap: int = KMAX) -> None:
    if not 1 <= k <= min(cap, n):
        raise ValueError(f"{name}={k} outside [1, {min(cap, n)}]")


def _check_masks(masks, n_q: int, n_pad: int) -> None:
    if masks is not None:
        _check("masks", masks, torch.bool, (n_q, n_pad))


def _opt_ptr(t) -> int:
    """The pointer of an optional operand (0, a null pointer, for None)."""
    return 0 if t is None else _ptr(t)


def _family(name: str, masks) -> str:
    return name if masks is None else f"{name}_masked"


def _flat_shape(matrix, norms, allowed, queries, qn, q2, k: int, masks):
    cuda = _on_cuda(matrix, norms, allowed, queries, qn, q2,
                    *([] if masks is None else [masks]))
    n_pad, dims = _check_rows("matrix", matrix, torch.float32)
    n_q, q_dims = _check_rows("queries", queries, torch.float32)
    if q_dims != dims:
        raise ValueError(f"queries have {q_dims} dims, the matrix {dims}")
    _check("norms", norms, torch.float32, (n_pad,))
    _check("allowed", allowed, torch.bool, (n_pad,))
    _check_masks(masks, n_q, n_pad)
    _check_query_terms(qn, q2, n_q)
    _check_k("k", k, n_pad, cap=n_pad)
    return cuda, n_pad, dims, n_q


def _flat_launch(matrix, norms, allowed, queries, qn, q2, k, similarity,
                 masks, n_pad, dims, n_q, full, probe=None, split_addr=0):
    dev = matrix.device
    scratch = torch.empty(scratch_bytes("knn_flat", n_q, dims, n_pad, k),
                          dtype=torch.uint8, device=dev)
    s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
    d = torch.empty(n_q, k, dtype=torch.int32, device=dev)
    _launch("knn_flat", _ptr(matrix), _ptr(norms), _ptr(allowed),
            _opt_ptr(masks), _ptr(queries), _ptr(qn), _ptr(q2), n_q, dims,
            n_pad, k, _sim_code(similarity), _ptr(scratch), _ptr(full),
            _ptr(s), _ptr(d), _opt_ptr(probe), split_addr, _stream())
    return s, d


def knn_flat(matrix, norms, allowed, queries, qn, q2, k: int,
             similarity: str = "cosine", masks=None):
    """K5. Exact batched kNN top-k: (scores [B, k] f32, docs [B, k]
    int32) of queries [B, D] f32 against matrix [N_pad, D] f32 (both
    rounded to bf16, f32 sums), masked to ``allowed`` [N_pad] bool and,
    when given, to each query's row of ``masks`` [B, N_pad] bool; any
    1 <= k <= N_pad."""
    cuda, n_pad, dims, n_q = _flat_shape(matrix, norms, allowed, queries,
                                         qn, q2, k, masks)
    family = _family("knn_flat", masks)
    label = f"n_docs_pad={n_pad}/dims={dims}/n_q={n_q}/k={k}"
    with DEVICE_PROFILE.call(family, label, cuda):
        if not cuda:
            return knn_flat_plain(matrix, norms, allowed, queries, qn, q2,
                                  k, similarity, masks)
        return _flat_launch(matrix, norms, allowed, queries, qn, q2, k,
                            similarity, masks, n_pad, dims, n_q,
                            full_counter(family, matrix.device))


def knn_flat_probe(matrix, norms, allowed, queries, qn, q2, k: int,
                   similarity: str = "cosine", masks=None,
                   dots: bool = False) -> dict:
    """K5 on the card, uncounted and synchronised: {"out": (s, d),
    "split_ms": the stages' milliseconds (``split_of``), "full_rows":
    rows that took the exact branch, "dots": the tensor cores' raw dots
    [B, N_pad] when ``dots``, else None}."""
    cuda, n_pad, dims, n_q = _flat_shape(matrix, norms, allowed, queries,
                                         qn, q2, k, masks)
    if not cuda:
        raise ValueError("knn_flat_probe runs on the card")
    dev = matrix.device
    full = torch.zeros(1, dtype=torch.int32, device=dev)
    probe = (torch.full((n_q, n_pad), torch.nan, device=dev) if dots
             else None)
    arr, addr = split_buffer(True)
    out = _flat_launch(matrix, norms, allowed, queries, qn, q2, k,
                       similarity, masks, n_pad, dims, n_q, full, probe,
                       addr)
    return {"out": out, "split_ms": split_of(arr),
            "full_rows": int(full.item()), "dots": probe}


def _coarse_shape(q8, scales, norms, allowed, qq, qscale, qn, q2, kprime,
                  masks):
    cuda = _on_cuda(q8, scales, norms, allowed, qq, qscale, qn, q2,
                    *([] if masks is None else [masks]))
    n_pad, dims = _check_rows("q8", q8, torch.int8)
    n_q, q_dims = _check_rows("qq", qq, torch.int8)
    if q_dims != dims:
        raise ValueError(f"queries have {q_dims} dims, the mirror {dims}")
    _check("scales", scales, torch.float32, (n_pad,))
    _check("norms", norms, torch.float32, (n_pad,))
    _check("allowed", allowed, torch.bool, (n_pad,))
    _check("qscale", qscale, torch.float32, (n_q,))
    _check_masks(masks, n_q, n_pad)
    _check_query_terms(qn, q2, n_q)
    _check_k("kprime", kprime, n_pad)
    return cuda, n_pad, dims, n_q


def _coarse_launch(q8, scales, norms, allowed, qq, qscale, qn, q2, kprime,
                   similarity, masks, n_pad, dims, n_q, full, split_addr=0):
    dev = q8.device
    scratch = torch.empty(
        scratch_bytes("knn_coarse", n_q, dims, n_pad, kprime),
        dtype=torch.uint8, device=dev)
    cs = torch.empty(n_q, kprime, dtype=torch.float32, device=dev)
    cand = torch.empty(n_q, kprime, dtype=torch.int32, device=dev)
    _launch("knn_coarse", _ptr(q8), _ptr(scales), _ptr(norms),
            _ptr(allowed), _opt_ptr(masks), _ptr(qq), _ptr(qscale),
            _ptr(qn), _ptr(q2), n_q, dims, n_pad, kprime,
            _sim_code(similarity), _ptr(scratch), _ptr(full), _ptr(cs),
            _ptr(cand), split_addr, _stream())
    return cs, cand


def knn_coarse(q8, scales, norms, allowed, qq, qscale, qn, q2, kprime: int,
               similarity: str = "cosine", masks=None):
    """K6. The quantized coarse pass: (coarse scores [B, k'] f32,
    candidate docs [B, k'] int32) of the int8 queries ``qq`` [B, D] (scale
    ``qscale`` [B]) against the int8 mirror ``q8`` [N_pad, D] (scale
    ``scales`` [N_pad]), int32 sums rescaled by qscale * scales, the
    transform with the f32 queries' ``qn``/``q2``, masked to ``allowed``
    (and to each query's row of ``masks`` [B, N_pad] when given)."""
    cuda, n_pad, dims, n_q = _coarse_shape(q8, scales, norms, allowed, qq,
                                           qscale, qn, q2, kprime, masks)
    family = _family("knn_coarse", masks)
    with DEVICE_PROFILE.call(
            family,
            f"n_docs_pad={n_pad}/dims={dims}/n_q={n_q}/kprime={kprime}",
            cuda):
        if not cuda:
            return knn_coarse_plain(q8, scales, norms, allowed, qq, qscale,
                                    qn, q2, kprime, similarity, masks)
        return _coarse_launch(q8, scales, norms, allowed, qq, qscale, qn, q2,
                              kprime, similarity, masks, n_pad, dims, n_q,
                              full_counter(family, q8.device))


def knn_coarse_probe(q8, scales, norms, allowed, qq, qscale, qn, q2,
                     kprime: int, similarity: str = "cosine",
                     masks=None) -> dict:
    """K6 on the card, uncounted and synchronised: {"out": (cs, cand),
    "split_ms": the stages' milliseconds, "full_rows": rows selected over
    the whole row}."""
    cuda, n_pad, dims, n_q = _coarse_shape(q8, scales, norms, allowed, qq,
                                           qscale, qn, q2, kprime, masks)
    if not cuda:
        raise ValueError("knn_coarse_probe runs on the card")
    full = torch.zeros(1, dtype=torch.int32, device=q8.device)
    arr, addr = split_buffer(True)
    out = _coarse_launch(q8, scales, norms, allowed, qq, qscale, qn, q2,
                         kprime, similarity, masks, n_pad, dims, n_q, full,
                         addr)
    return {"out": out, "split_ms": split_of(arr),
            "full_rows": int(full.item())}


def knn_rerank(matrix, norms, allowed, queries, qn, q2, cand, coarse_s,
               k: int, similarity: str = "cosine", masks=None):
    """K7. The exact re-rank of the coarse candidates: (scores [B, k] f32,
    docs [B, k] int32 with -1 where the score is -inf, eps [B] f32).
    Candidates are sorted by doc id first, so a score tie resolves to the
    lower doc exactly as in ``knn_flat``, and each candidate's score has
    ``knn_flat``'s bits for that doc. With ``masks`` [B, N_pad], a
    candidate outside its query's filter row is excluded even if the
    coarse pass let it in."""
    cuda = _on_cuda(matrix, norms, allowed, queries, qn, q2, cand, coarse_s,
                    *([] if masks is None else [masks]))
    n_pad, dims = _check_rows("matrix", matrix, torch.float32)
    n_q, q_dims = _check_rows("queries", queries, torch.float32)
    if q_dims != dims:
        raise ValueError(f"queries have {q_dims} dims, the matrix {dims}")
    _check("norms", norms, torch.float32, (n_pad,))
    _check("allowed", allowed, torch.bool, (n_pad,))
    _check_masks(masks, n_q, n_pad)
    _check_query_terms(qn, q2, n_q)
    if cand.dim() != 2 or cand.shape[0] != n_q:
        raise ValueError(f"[cand] must be [{n_q}, k'], got "
                         f"{tuple(cand.shape)}")
    kprime = cand.shape[1]
    _check("cand", cand, torch.int32, (n_q, kprime))
    _check("coarse_s", coarse_s, torch.float32, (n_q, kprime))
    if not 1 <= k <= kprime <= KMAX:
        raise ValueError(f"need 1 <= k={k} <= kprime={kprime} <= {KMAX}")
    with DEVICE_PROFILE.call(
            _family("knn_rerank", masks),
            f"n_docs_pad={n_pad}/dims={dims}/n_q={n_q}/kprime={kprime}/k={k}",
            cuda):
        if not cuda:
            return knn_rerank_plain(matrix, norms, allowed, queries, qn, q2,
                                    cand, coarse_s, k, similarity, masks)
        dev = matrix.device
        s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        d = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        eps = torch.empty(n_q, dtype=torch.float32, device=dev)
        _launch("knn_rerank", _ptr(matrix), _ptr(norms), _ptr(allowed),
                _opt_ptr(masks), _ptr(queries), _ptr(qn), _ptr(q2),
                _ptr(cand), _ptr(coarse_s), n_q, n_pad, dims, kprime, k,
                _sim_code(similarity),
                _ptr(s), _ptr(d), _ptr(eps), _stream())
        return s, d, eps


def vector_scores(matrix, norms, exists, query, qn, q2,
                  similarity: str = "cosine") -> torch.Tensor:
    """K9. One query's dense similarity row [N_pad] f32: ``query`` [D] f32
    (with its ``qn`` / ``q2`` [1], as ``QueryBatch`` computes them)
    against ``matrix`` [N_pad, D] f32, both rounded to bf16, f32 sums in
    dimension order, the similarity transform; 0 where ``exists`` is
    False. A doc's score has knn_flat's bits before knn_flat masks it."""
    cuda = _on_cuda(matrix, norms, exists, query, qn, q2)
    n_pad, dims = _check_rows("matrix", matrix, torch.float32)
    _check("query", query, torch.float32, (dims,))
    _check("norms", norms, torch.float32, (n_pad,))
    _check("exists", exists, torch.bool, (n_pad,))
    _check_query_terms(qn, q2, 1)
    code = _sim_code(similarity)
    with DEVICE_PROFILE.call("knn_scores",
                             f"n_docs_pad={n_pad}/dims={dims}", cuda):
        if not cuda:
            return vector_scores_plain(matrix, norms, exists, query, qn, q2,
                                       similarity)
        out = torch.empty(n_pad, dtype=torch.float32, device=matrix.device)
        _launch("knn_scores", _ptr(matrix), _ptr(norms), _ptr(exists),
                _ptr(query), _ptr(qn), _ptr(q2), dims, n_pad, code,
                _ptr(out), _stream())
        return out


# ---------------------------------------------------------------------------
# the JAX package's programs, over a QueryBatch
# ---------------------------------------------------------------------------

def knn_topk_batch(matrix, norms, exists, live, batch: QueryBatch, k: int,
                   similarity: str = "cosine"):
    """Batched exact kNN (``knn_topk_batch``): (scores [B_pad, k], docs
    [B_pad, k]) over the eligible docs ``live & exists``."""
    return knn_flat(matrix, norms, live & exists, batch.queries, batch.qn,
                    batch.q2, k, similarity)


def knn_topk_batch_masked(matrix, norms, exists, live, batch: QueryBatch,
                          masks, k: int, similarity: str = "cosine"):
    """Filtered batched exact kNN (``knn_topk_batch_masked``): per-query
    filter masks [B_pad, N_pad] ride the same launch; (scores [B_pad, k],
    docs [B_pad, k])."""
    return knn_flat(matrix, norms, live & exists, batch.queries, batch.qn,
                    batch.q2, k, similarity, masks)


def knn_coarse_candidates(q8, scales, norms, allowed, batch: QueryBatch,
                          kprime: int, similarity: str = "cosine"):
    """The quantized coarse pass over the full plane
    (``knn_coarse_candidates``): (coarse scores [B_pad, k'], candidate
    docs [B_pad, k']). Ranking only: the exact re-rank restores the
    scores of the survivors, and the k'-th coarse score bounds what any
    excluded doc could have scored (the adaptive depth's margin)."""
    qq, qscale = batch.quantized()
    return knn_coarse(q8, scales, norms, allowed, qq, qscale, batch.qn,
                      batch.q2, kprime, similarity)


def knn_coarse_candidates_masked(q8, scales, norms, allowed,
                                 batch: QueryBatch, masks, kprime: int,
                                 similarity: str = "cosine"):
    """The coarse pass with per-query filter masks [B_pad, N_pad]
    (``knn_coarse_candidates_masked``)."""
    qq, qscale = batch.quantized()
    return knn_coarse(q8, scales, norms, allowed, qq, qscale, batch.qn,
                      batch.q2, kprime, similarity, masks)


def knn_rerank_exact(matrix, norms, allowed, batch: QueryBatch, cand,
                     coarse_s, k: int, similarity: str = "cosine"):
    """Exact re-rank of the coarse candidates (``knn_rerank_exact``):
    identical top-k to the exact path whenever the true top-k survived the
    coarse pass, which the caller proves from ``eps``."""
    return knn_rerank(matrix, norms, allowed, batch.queries, batch.qn,
                      batch.q2, cand, coarse_s, k, similarity)


def knn_rerank_exact_masked(matrix, norms, allowed, batch: QueryBatch,
                            cand, coarse_s, masks, k: int,
                            similarity: str = "cosine"):
    """``knn_rerank_exact`` with the per-query filter masks re-applied at
    the candidates (``knn_rerank_exact_masked``): a masked-out doc stays
    out even if the coarse pass let it in."""
    return knn_rerank(matrix, norms, allowed, batch.queries, batch.qn,
                      batch.q2, cand, coarse_s, k, similarity, masks)


def knn_topk(matrix, norms, exists, live, query, k: int,
             similarity: str = "cosine"):
    """The JAX package's ``knn_topk``: one host query vector's exact
    top-k over ``live & exists`` -> (s [k] f32, d [k] int32). That is
    ``knn_topk_batch`` at one row, so K5 serves it."""
    batch = QueryBatch([query], matrix.device)
    s, d = knn_topk_batch(matrix, norms, exists, live, batch, k, similarity)
    return s[0], d[0]


class KnnExecutor:
    """Per-(segment, field) exact kNN executor over a ``DeviceVectors`` or
    a ``PlaneVectors`` (anything with matrix / norms / exists /
    similarity)."""

    def __init__(self, device_vectors):
        self.dev = device_vectors

    def top_k_batch(self, queries, live, k: int, masks=None):
        """Batched exact kNN over Q query vectors: ONE launch instead of Q.
        The query rows pad to a pow2 bucket (as in the JAX package, so both
        make the same dispatches); padded rows come back sliced off.

        ``masks`` carries the filter context of filtered kNN: a single
        [N_pad] bool mask shared by every query (it folds into ``live``,
        exactly as the solo path's ``live & fmask``: one unmasked launch),
        or a [Q, N_pad] stack of per-query masks (numpy or a tensor),
        applied inside the one masked launch; padded rows match nothing."""
        dev = self.dev.matrix.device
        batch = QueryBatch(queries, dev)
        if masks is not None and getattr(masks, "ndim", 1) == 2:
            m_host = pad_mask_rows_pow2(
                masks.cpu().numpy() if isinstance(masks, torch.Tensor)
                else masks, batch.queries.shape[0])
            s, d = knn_topk_batch_masked(
                self.dev.matrix, self.dev.norms, self.dev.exists, live,
                batch, torch.as_tensor(m_host, device=dev), k,
                self.dev.similarity)
            return s[: batch.n_real], d[: batch.n_real]
        if masks is not None:
            live = live & masks                   # shared filter mask
        s, d = knn_topk_batch(self.dev.matrix, self.dev.norms,
                              self.dev.exists, live, batch, k,
                              self.dev.similarity)
        return s[: batch.n_real], d[: batch.n_real]

    def top_k(self, query, live, k: int):
        """One query's exact top-k (``knn_topk``, K5 at one row)."""
        return knn_topk(self.dev.matrix, self.dev.norms, self.dev.exists,
                        live, query, k, self.dev.similarity)

    def scores(self, query, live) -> torch.Tensor:
        """One query's dense similarity row (K9), 0 at dead docs."""
        s = query_scores(self.dev, query)
        return torch.where(live, s, torch.zeros((), device=s.device))


def query_scores(dev_vectors, query,
                 similarity: Optional[str] = None) -> torch.Tensor:
    """``vector_scores`` of one host query vector over a ``DeviceVectors``
    (its similarity unless ``similarity`` is given); the query's norm
    terms come from ``QueryBatch``, once."""
    batch = QueryBatch([query], dev_vectors.matrix.device)
    return vector_scores(dev_vectors.matrix, dev_vectors.norms,
                         dev_vectors.exists, batch.queries[0], batch.qn,
                         batch.q2, similarity or dev_vectors.similarity)
