"""BM25 scoring on the card: the host WAND planner and the four kernels.

The host half is the JAX package's ``ops/bm25.py`` planner, copied without
logic changes (``idf``, ``P1_BUCKET``, ``MAX_BATCH_CELLS``,
``flatten_plans``, ``qb_bucket``, ``QueryPlan``, ``TermCellIndex``,
``build_query_plan``, ``WAND_GRID``), so pruning decisions and dispatch
counts match the reference's exactly.

The device half is five kernel families, each a hand-written CUDA kernel
(``csrc/<family>.cu``) behind a wrapper, with its plain PyTorch version
beside it:

- ``bm25_flat`` (K1): flat batched BM25 + top-k, optionally counted (at
  one query it also serves the JAX package's ``bm25_topk``);
- ``bm25_flat_seg`` (K2): K1 with per-segment match counts;
- ``bm25_coarse`` (K3): K1's gather over the bf16 mirrors, top-k'
  candidates and exact per-segment counts;
- ``bm25_rerank`` (K4): exact f32 re-score of the coarse candidates;
- ``bm25_scores`` (K8): one query's dense score row (the dense
  collector's ``match`` family of nodes).

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; there is no fallback between the two. Both sum the f32
contributions in 64-bit fixed point (scale 2^32) and convert once, so the
kernel and its plain version agree bit for bit, and K1, K2, K4 and K8 give
the same score for the same doc. Top-k order is score descending, then index
ascending, -inf slots included (``lax.top_k``'s order).

idf follows the reference's BM25: ln(1 + (N - df + 0.5) / (df + 0.5)).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import next_pow2
from elasticsearch_tpu_torch.ops.device_segment import (
    DevicePostings, gather_query_blocks,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from elasticsearch_tpu_torch.index.segment import PostingsField

DEFAULT_K1 = 1.2
DEFAULT_B = 0.75

# the kernels' limits (csrc/topk_common.cuh KMAX, CHUNK; bm25_common.cuh
# MAX_SEGS)
KMAX = 4096
MAX_SEGS = 4096
CHUNK = 65536
BLOCK_WIDTH = 128


def idf(doc_count: int, doc_freq: int) -> float:
    """Reference BM25 idf (Lucene BM25Similarity.idfExplain)."""
    return float(np.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5)))


# number of highest-upper-bound blocks scored in phase 1 of the pruned
# path to establish the top-k score floor (theta)
P1_BUCKET = 64

# per-dispatch ceiling on the FLAT block count; larger batches split into
# query chunks. Kept at the JAX package's value so that both packages
# make the same dispatches (sizing it for an 80 GB card is queued work).
MAX_BATCH_CELLS = 4_000_000


# ---------------------------------------------------------------------------
# shared arithmetic of the plain versions
# ---------------------------------------------------------------------------

FIX_SCALE = 2.0 ** 32


def _to_fixed(c: torch.Tensor) -> torch.Tensor:
    """f32 contributions -> int64 fixed point (scale 2^32, round half to
    even); a positive contribution never rounds to 0 (to_fixed in
    csrc/bm25_common.cuh)."""
    v = torch.round(c.double() * FIX_SCALE).long()
    return torch.where(c > 0, v.clamp_min(1), v)


def _from_fixed(acc: torch.Tensor) -> torch.Tensor:
    return (acc.double() * (1.0 / FIX_SCALE)).float()


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k in ``lax.top_k``'s order: value descending, index
    ascending among equal values (-inf included). ``torch.topk`` does not
    promise the index order, so this sorts stably."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def _gather(block_docs, block_tfs, flat_idx):
    rows = flat_idx.long()
    docs = block_docs[rows]                  # [FB, BLOCK]
    tfs = block_tfs[rows]
    valid = docs >= 0
    safe = torch.where(valid, docs, torch.zeros_like(docs)).long()
    return tfs, valid, safe


def _contrib_f32(block_docs, block_tfs, flat_idx, flat_w, doc_lens,
                 flat_avgdl, k1, b):
    """[FB, BLOCK] fixed-point contributions (0 where docs are -1) and the
    safe doc ids: bm25_flat_body's formula, one rounded f32 op at a time."""
    tfs, valid, safe = _gather(block_docs, block_tfs, flat_idx)
    dl = doc_lens[safe]
    norm = k1 * ((1.0 - b) + b * dl / flat_avgdl[:, None])
    c = flat_w[:, None] * tfs * (k1 + 1.0) / (tfs + norm)
    fx = torch.where(valid, _to_fixed(c), torch.zeros((), dtype=torch.int64,
                                                      device=c.device))
    return fx, safe


def _bf16(x: float) -> float:
    """``x`` rounded to bf16 (as ``jnp.bfloat16(x)``), as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


def _contrib_bf16(block_docs, block_tfs_q, flat_idx, flat_w, doc_lens_q,
                  flat_avgdl, k1, b):
    """bm25_coarse_body's contribution: bf16 operands, every op but the
    last rounded to bf16; the final quotient is taken in f32, as the JAX
    program computes it (XLA drops the bf16 rounding of a value widened to
    f32 right after). Then to fixed point."""
    tfs, valid, safe = _gather(block_docs, block_tfs_q, flat_idx)
    dl = doc_lens_q[safe]
    h = torch.bfloat16
    norm = _bf16(k1) * (_bf16(1.0 - b) + _bf16(b) * dl
                        / flat_avgdl.to(h)[:, None])
    num = flat_w.to(h)[:, None] * tfs * _bf16(k1 + 1.0)
    c = num.float() / (tfs + norm).float()
    fx = torch.where(valid, _to_fixed(c),
                     torch.zeros((), dtype=torch.int64, device=c.device))
    return fx, safe


def _dense_plane(fx, safe, flat_q, live, n_docs_pad: int, n_q: int):
    """Sum contributions into the [n_q, n_docs_pad] plane; (scores with
    non-matches at -inf, matched mask)."""
    tgt = flat_q.long()[:, None] * n_docs_pad + safe
    acc = torch.zeros(n_q * n_docs_pad, dtype=torch.int64, device=fx.device)
    acc.index_add_(0, tgt.reshape(-1), fx.reshape(-1))
    acc = acc.view(n_q, n_docs_pad)
    matched = live[None, :] & (acc > 0)
    scores = torch.where(matched, _from_fixed(acc),
                         torch.full((), -torch.inf, device=fx.device))
    return scores, matched


def _seg_counts(matched, seg_ids, n_segs: int) -> torch.Tensor:
    """[n_q, n_segs] matches per segment; a seg id outside [0, n_segs)
    counts nowhere (``jax.nn.one_hot``'s zero row)."""
    ok = (seg_ids >= 0) & (seg_ids < n_segs)
    hits = torch.zeros(matched.shape[0], n_segs, dtype=torch.int32,
                       device=matched.device)
    hits.index_add_(1, seg_ids.long().clamp(0, n_segs - 1),
                    (matched & ok[None, :]).to(torch.int32))
    return hits


# ---------------------------------------------------------------------------
# plain versions (run for CPU tensors; chip_smoke.py holds the kernels
# against them on the card)
# ---------------------------------------------------------------------------

def bm25_flat_plain(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                    doc_lens, flat_avgdl, live, n_docs_pad: int, n_q: int,
                    k: int, k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                    counted: bool = False):
    fx, safe = _contrib_f32(block_docs, block_tfs, flat_idx, flat_w,
                            doc_lens, flat_avgdl, k1, b)
    scores, matched = _dense_plane(fx, safe, flat_q, live, n_docs_pad, n_q)
    s, d = stable_topk(scores, k)
    if counted:
        return s, d, matched.sum(dim=1, dtype=torch.int32)
    return s, d


def bm25_flat_seg_plain(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                        doc_lens, flat_avgdl, live, seg_ids,
                        n_docs_pad: int, n_q: int, k: int,
                        k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                        n_segs: int = 1):
    fx, safe = _contrib_f32(block_docs, block_tfs, flat_idx, flat_w,
                            doc_lens, flat_avgdl, k1, b)
    scores, matched = _dense_plane(fx, safe, flat_q, live, n_docs_pad, n_q)
    s, d = stable_topk(scores, k)
    return s, d, _seg_counts(matched, seg_ids, n_segs)


def bm25_coarse_plain(block_docs, block_tfs_q, flat_idx, flat_w, flat_q,
                      doc_lens_q, flat_avgdl, live, seg_ids,
                      n_docs_pad: int, n_q: int, n_segs: int, kprime: int,
                      k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    fx, safe = _contrib_bf16(block_docs, block_tfs_q, flat_idx, flat_w,
                             doc_lens_q, flat_avgdl, k1, b)
    scores, matched = _dense_plane(fx, safe, flat_q, live, n_docs_pad, n_q)
    cs, cand = stable_topk(scores, kprime)
    return cs, cand, _seg_counts(matched, seg_ids, n_segs)


def bm25_rerank_plain(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                      doc_lens, flat_avgdl, live, cand, coarse_s,
                      n_docs_pad: int, n_q: int, kprime: int, k: int,
                      k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    dev = block_docs.device
    order = torch.argsort(cand, dim=1, stable=True)
    cand_s = torch.gather(cand, 1, order)
    cs_s = torch.gather(coarse_s, 1, order)
    fx, safe = _contrib_f32(block_docs, block_tfs, flat_idx, flat_w,
                            doc_lens, flat_avgdl, k1, b)
    # each posting's candidate slot by binary search over the rows' sorted
    # (query, doc) keys; postings of non-candidates are dropped
    keys = (torch.arange(n_q, device=dev)[:, None] * n_docs_pad
            + cand_s.long()).reshape(-1)
    want = (flat_q.long()[:, None] * n_docs_pad + safe).reshape(-1)
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


def bm25_block_scores_plain(block_docs, block_tfs, block_idx, block_weight,
                            doc_lens, avgdl: float, n_docs_pad: int,
                            live=None, k1: float = DEFAULT_K1,
                            b: float = DEFAULT_B) -> torch.Tensor:
    qb = block_idx.shape[0]
    avg = torch.full((qb,), float(avgdl), dtype=torch.float32,
                     device=block_idx.device)
    fx, safe = _contrib_f32(block_docs, block_tfs, block_idx, block_weight,
                            doc_lens, avg, k1, b)
    acc = torch.zeros(n_docs_pad, dtype=torch.int64, device=fx.device)
    acc.index_add_(0, safe.reshape(-1), fx.reshape(-1))
    scores = _from_fixed(acc)
    if live is None:
        return scores
    return torch.where(live, scores, torch.zeros((), device=fx.device))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SIG = {
    "bm25_flat": ["p"] * 8 + ["i", "ll", "i", "i", "i"] + ["f"] * 4
    + ["p"] * 7,
    "bm25_flat_seg": ["p"] * 9 + ["i", "ll", "i", "i", "i"] + ["f"] * 4
    + ["p"] * 7,
    "bm25_coarse": ["p"] * 9 + ["i", "ll", "i", "i", "i"] + ["f"] * 4
    + ["p"] * 7,
    "bm25_rerank": ["p"] * 10 + ["i", "i", "i", "i"] + ["f"] * 4
    + ["p"] * 7,
    "bm25_scores": ["p"] * 8 + ["i", "ll"] + ["f"] * 4 + ["p"] * 3,
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "ll": ctypes.c_longlong,
           "f": ctypes.c_float}
_FNS: dict = {}


def launch_kernel(family: str, sig, *args) -> None:
    """Call ``<family>_launch`` of the family's library (built and bound
    with ``sig``'s ctypes on first use; every family's wrapper module
    goes through here) and raise ``KernelError`` if it returns a CUDA
    error."""
    from elasticsearch_tpu_torch._build import KernelError, library
    fn = _FNS.get(family)
    if fn is None:
        fn = getattr(library(family), f"{family}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[t] for t in sig]
        _FNS[family] = fn
    rc = fn(*args)
    if rc != 0:
        raise KernelError(f"[{family}] kernel launch failed: CUDA error {rc}")


def _launch(family: str, *args) -> None:
    launch_kernel(family, _SIG[family], *args)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; anything else is refused."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{dev}]")
    return dev.type == "cuda"


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"[{name}] must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"[{name}] must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"[{name}] must be contiguous")


def _check_flat(block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
                flat_avgdl, live, n_docs_pad, tf_dtype, dl_dtype):
    if block_docs.dim() != 2 or block_docs.shape[1] != BLOCK_WIDTH:
        raise ValueError(f"[block_docs] must be [NB, {BLOCK_WIDTH}]")
    nb = block_docs.shape[0]
    fb = flat_idx.shape[0]
    _check("block_docs", block_docs, torch.int32, (nb, BLOCK_WIDTH))
    _check("block_tfs", block_tfs, tf_dtype, (nb, BLOCK_WIDTH))
    _check("flat_idx", flat_idx, torch.int32, (fb,))
    _check("flat_w", flat_w, torch.float32, (fb,))
    _check("flat_q", flat_q, torch.int32, (fb,))
    _check("flat_avgdl", flat_avgdl, torch.float32, (fb,))
    _check("doc_lens", doc_lens, dl_dtype, (n_docs_pad,))
    _check("live", live, torch.bool, (n_docs_pad,))
    return fb


def chunk_entries(n_rows: int, n_cols: int, k: int) -> int:
    """Scratch entries for the chunk winners of a k-wide selection over
    rows of ``n_cols``: one round's, at most KMAX a chunk
    (csrc/topk_common.cuh ``plane_topk``); at least 1, unused when a row
    is one chunk."""
    nc = -(-n_cols // CHUNK)
    return n_rows * nc * min(k, KMAX) if nc > 1 else 1


def _consts(k1: float, b: float, bf16: bool = False):
    vals = (k1, 1.0 - b, b, k1 + 1.0)
    return tuple(_bf16(v) for v in vals) if bf16 else vals


def _label(fb: int, n_docs_pad: int, n_q: int, k: int) -> str:
    return f"fb={fb}/n_docs_pad={n_docs_pad}/n_q={n_q}/k={k}"


def bm25_flat(block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
              flat_avgdl, live, n_docs_pad: int, n_q: int, k: int,
              k1: float = DEFAULT_K1, b: float = DEFAULT_B,
              counted: bool = False):
    """K1. Flat batched BM25 + top-k over one block store: every gathered
    block tagged with its query id, scores summed per (query, doc), masked
    to live docs with score > 0 (else -inf), top-k per query. Returns
    (s [n_q, k] f32, d [n_q, k] int32) and, when ``counted``,
    hits [n_q] int32 = matches per query (exact for the blocks gathered:
    a lower bound when the plan was pruned)."""
    cuda = _on_cuda(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                    doc_lens, flat_avgdl, live)
    fb = _check_flat(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                     doc_lens, flat_avgdl, live, n_docs_pad, torch.float32,
                     torch.float32)
    with DEVICE_PROFILE.call("bm25_flat", _label(fb, n_docs_pad, n_q, k),
                             cuda):
        if not cuda:
            return bm25_flat_plain(block_docs, block_tfs, flat_idx, flat_w,
                                   flat_q, doc_lens, flat_avgdl, live,
                                   n_docs_pad, n_q, k, k1=k1, b=b,
                                   counted=counted)
        if not 1 <= k <= n_docs_pad:
            raise ValueError(f"k={k} outside [1, {n_docs_pad}]")
        dev = block_docs.device
        acc = torch.empty(n_q * n_docs_pad, dtype=torch.int64, device=dev)
        ck = chunk_entries(n_q, n_docs_pad, k)
        chunk_s = torch.empty(ck, dtype=torch.float32, device=dev)
        chunk_i = torch.empty(ck, dtype=torch.int32, device=dev)
        s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        d = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        hits = torch.empty(n_q, dtype=torch.int32, device=dev)
        _launch("bm25_flat", _ptr(block_docs), _ptr(block_tfs),
                _ptr(flat_idx), _ptr(flat_w), _ptr(flat_q), _ptr(doc_lens),
                _ptr(flat_avgdl), _ptr(live), fb, n_docs_pad, n_q, k,
                int(counted), *_consts(k1, b), _ptr(acc), _ptr(chunk_s),
                _ptr(chunk_i), _ptr(s), _ptr(d), _ptr(hits), _stream())
        return (s, d, hits) if counted else (s, d)


def bm25_topk_flat_counted(*args, **kw):
    return bm25_flat(*args, **kw, counted=True)


def bm25_flat_seg(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                  doc_lens, flat_avgdl, live, seg_ids, n_docs_pad: int,
                  n_q: int, k: int, k1: float = DEFAULT_K1,
                  b: float = DEFAULT_B, n_segs: int = 1):
    """K2. ``bm25_flat`` with PER-SEGMENT match counts: ``seg_ids``
    [n_docs_pad] maps each plane doc to its owning segment's position;
    returns (s, d, hits [n_q, n_segs] int32) — the totals-disabled
    per-segment contract."""
    cuda = _on_cuda(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                    doc_lens, flat_avgdl, live, seg_ids)
    fb = _check_flat(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                     doc_lens, flat_avgdl, live, n_docs_pad, torch.float32,
                     torch.float32)
    _check("seg_ids", seg_ids, torch.int32, (n_docs_pad,))
    with DEVICE_PROFILE.call("bm25_flat_seg",
                             _label(fb, n_docs_pad, n_q, k), cuda):
        if not cuda:
            return bm25_flat_seg_plain(
                block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
                flat_avgdl, live, seg_ids, n_docs_pad, n_q, k, k1=k1, b=b,
                n_segs=n_segs)
        if not 1 <= k <= n_docs_pad:
            raise ValueError(f"k={k} outside [1, {n_docs_pad}]")
        if not 1 <= n_segs <= MAX_SEGS:
            raise ValueError(f"n_segs={n_segs} outside [1, {MAX_SEGS}]")
        dev = block_docs.device
        acc = torch.empty(n_q * n_docs_pad, dtype=torch.int64, device=dev)
        ck = chunk_entries(n_q, n_docs_pad, k)
        chunk_s = torch.empty(ck, dtype=torch.float32, device=dev)
        chunk_i = torch.empty(ck, dtype=torch.int32, device=dev)
        s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        d = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        hits = torch.empty(n_q, n_segs, dtype=torch.int32, device=dev)
        _launch("bm25_flat_seg", _ptr(block_docs), _ptr(block_tfs),
                _ptr(flat_idx), _ptr(flat_w), _ptr(flat_q), _ptr(doc_lens),
                _ptr(flat_avgdl), _ptr(live), _ptr(seg_ids), fb, n_docs_pad,
                n_q, k, n_segs, *_consts(k1, b), _ptr(acc), _ptr(chunk_s),
                _ptr(chunk_i), _ptr(s), _ptr(d), _ptr(hits), _stream())
        return s, d, hits


def bm25_coarse(block_docs, block_tfs_q, flat_idx, flat_w, flat_q,
                doc_lens_q, flat_avgdl, live, seg_ids, n_docs_pad: int,
                n_q: int, n_segs: int, kprime: int, k1: float = DEFAULT_K1,
                b: float = DEFAULT_B):
    """K3. The quantized COARSE tier: K1's gather over the plane's bf16
    mirrors (``block_tfs_q`` / ``doc_lens_q``), contributions computed in
    bf16 and accumulated wider. Returns (coarse scores [n_q, kprime] f32,
    candidate plane docs [n_q, kprime] int32, per-segment match counts
    [n_q, n_segs] int32). The counts are EXACT: a contribution is positive
    wherever the f32 kernel's is, so ``score > 0`` flags the same docs."""
    cuda = _on_cuda(block_docs, block_tfs_q, flat_idx, flat_w, flat_q,
                    doc_lens_q, flat_avgdl, live, seg_ids)
    fb = _check_flat(block_docs, block_tfs_q, flat_idx, flat_w, flat_q,
                     doc_lens_q, flat_avgdl, live, n_docs_pad,
                     torch.bfloat16, torch.bfloat16)
    _check("seg_ids", seg_ids, torch.int32, (n_docs_pad,))
    with DEVICE_PROFILE.call("bm25_coarse",
                             _label(fb, n_docs_pad, n_q, kprime), cuda):
        if not cuda:
            return bm25_coarse_plain(
                block_docs, block_tfs_q, flat_idx, flat_w, flat_q,
                doc_lens_q, flat_avgdl, live, seg_ids, n_docs_pad, n_q,
                n_segs, kprime, k1=k1, b=b)
        if not 1 <= kprime <= min(KMAX, n_docs_pad):
            raise ValueError(
                f"kprime={kprime} outside [1, {min(KMAX, n_docs_pad)}]")
        if not 1 <= n_segs <= MAX_SEGS:
            raise ValueError(f"n_segs={n_segs} outside [1, {MAX_SEGS}]")
        dev = block_docs.device
        acc = torch.empty(n_q * n_docs_pad, dtype=torch.int64, device=dev)
        ck = chunk_entries(n_q, n_docs_pad, kprime)
        chunk_s = torch.empty(ck, dtype=torch.float32, device=dev)
        chunk_i = torch.empty(ck, dtype=torch.int32, device=dev)
        cs = torch.empty(n_q, kprime, dtype=torch.float32, device=dev)
        cand = torch.empty(n_q, kprime, dtype=torch.int32, device=dev)
        hits = torch.empty(n_q, n_segs, dtype=torch.int32, device=dev)
        _launch("bm25_coarse", _ptr(block_docs), _ptr(block_tfs_q),
                _ptr(flat_idx), _ptr(flat_w), _ptr(flat_q), _ptr(doc_lens_q),
                _ptr(flat_avgdl), _ptr(live), _ptr(seg_ids), fb, n_docs_pad,
                n_q, n_segs, kprime, *_consts(k1, b, bf16=True), _ptr(acc),
                _ptr(chunk_s), _ptr(chunk_i), _ptr(cs), _ptr(cand),
                _ptr(hits), _stream())
        return cs, cand, hits


def bm25_rerank(block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
                flat_avgdl, live, cand, coarse_s, n_docs_pad: int, n_q: int,
                kprime: int, k: int, k1: float = DEFAULT_K1,
                b: float = DEFAULT_B):
    """K4. The EXACT tier: re-score only the coarse candidates with K1's
    f32 contributions (so each candidate's score equals K1's for that doc,
    bit for bit), candidates sorted ascending by doc id so score ties
    break toward the lower doc as in the dense kernel. Returns
    (scores [n_q, k], plane docs [n_q, k], eps [n_q]) with ``eps`` the max
    |exact - coarse| among matched candidates."""
    cuda = _on_cuda(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                    doc_lens, flat_avgdl, live, cand, coarse_s)
    fb = _check_flat(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                     doc_lens, flat_avgdl, live, n_docs_pad, torch.float32,
                     torch.float32)
    _check("cand", cand, torch.int32, (n_q, kprime))
    _check("coarse_s", coarse_s, torch.float32, (n_q, kprime))
    with DEVICE_PROFILE.call("bm25_rerank",
                             _label(fb, n_docs_pad, n_q, kprime), cuda):
        if not cuda:
            return bm25_rerank_plain(
                block_docs, block_tfs, flat_idx, flat_w, flat_q, doc_lens,
                flat_avgdl, live, cand, coarse_s, n_docs_pad, n_q, kprime,
                k, k1=k1, b=b)
        if not 1 <= kprime <= KMAX or not 1 <= k <= kprime:
            raise ValueError(f"need 1 <= k={k} <= kprime={kprime} <= {KMAX}")
        dev = block_docs.device
        cand_s = torch.empty(n_q, kprime, dtype=torch.int32, device=dev)
        cs_s = torch.empty(n_q, kprime, dtype=torch.float32, device=dev)
        acc = torch.empty(n_q, kprime, dtype=torch.int64, device=dev)
        s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        d = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        eps = torch.empty(n_q, dtype=torch.float32, device=dev)
        _launch("bm25_rerank", _ptr(block_docs), _ptr(block_tfs),
                _ptr(flat_idx), _ptr(flat_w), _ptr(flat_q), _ptr(doc_lens),
                _ptr(flat_avgdl), _ptr(live), _ptr(cand), _ptr(coarse_s), fb,
                n_q, kprime, k, *_consts(k1, b), _ptr(cand_s), _ptr(cs_s),
                _ptr(acc), _ptr(s), _ptr(d), _ptr(eps), _stream())
        return s, d, eps


def bm25_block_scores(block_docs, block_tfs, block_idx, block_weight,
                      doc_lens, avgdl: float, n_docs_pad: int, live=None,
                      k1: float = DEFAULT_K1,
                      b: float = DEFAULT_B) -> torch.Tensor:
    """K8. Dense BM25 scores [n_docs_pad] f32 of ONE query over one
    segment's block store: every posting of the QB gathered blocks
    (``block_idx`` [QB] int32, ``block_weight`` [QB] f32 = idf * boost;
    block 0 / weight 0 as padding) scored with ``avgdl``, summed per doc;
    0 where no posting lands and, when ``live`` [n_docs_pad] bool is
    given, where the doc is dead. K1's gather, contribution and
    fixed-point sum at one query (flat_q 0, flat_avgdl = avgdl), so a
    doc's score equals K1's for the same blocks, bit for bit."""
    tensors = [block_docs, block_tfs, block_idx, block_weight, doc_lens]
    cuda = _on_cuda(*tensors, *([live] if live is not None else []))
    if block_docs.dim() != 2 or block_docs.shape[1] != BLOCK_WIDTH:
        raise ValueError(f"[block_docs] must be [NB, {BLOCK_WIDTH}]")
    nb = block_docs.shape[0]
    qb = block_idx.shape[0]
    _check("block_docs", block_docs, torch.int32, (nb, BLOCK_WIDTH))
    _check("block_tfs", block_tfs, torch.float32, (nb, BLOCK_WIDTH))
    _check("block_idx", block_idx, torch.int32, (qb,))
    _check("block_weight", block_weight, torch.float32, (qb,))
    _check("doc_lens", doc_lens, torch.float32, (n_docs_pad,))
    if live is not None:
        _check("live", live, torch.bool, (n_docs_pad,))
    with DEVICE_PROFILE.call("bm25_scores",
                             f"qb={qb}/n_docs_pad={n_docs_pad}", cuda):
        if not cuda:
            return bm25_block_scores_plain(
                block_docs, block_tfs, block_idx, block_weight, doc_lens,
                avgdl, n_docs_pad, live, k1=k1, b=b)
        dev = block_docs.device
        block_q = torch.zeros(qb, dtype=torch.int32, device=dev)
        block_avg = torch.full((qb,), float(avgdl), dtype=torch.float32,
                               device=dev)
        acc = torch.empty(n_docs_pad, dtype=torch.int64, device=dev)
        out = torch.empty(n_docs_pad, dtype=torch.float32, device=dev)
        _launch("bm25_scores", _ptr(block_docs), _ptr(block_tfs),
                _ptr(block_idx), _ptr(block_weight), _ptr(block_q),
                _ptr(doc_lens), _ptr(block_avg),
                _ptr(live) if live is not None else None, qb, n_docs_pad,
                *_consts(k1, b), _ptr(acc), _ptr(out), _stream())
        return out


def bm25_topk(block_docs, block_tfs, block_idx, block_weight, doc_lens,
              avgdl: float, live, n_docs_pad: int, k: int,
              k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    """The JAX package's ``bm25_topk``: K8's scores masked to live docs
    with score > 0 (-inf elsewhere), top-k -> (s [k] f32, d [k] int32).
    That is ``bm25_flat_body`` at one query (flat_q 0, flat_avgdl = avgdl
    broadcast): the same gather, mask and top-k, so K1 serves it."""
    qb = block_idx.shape[0]
    dev = block_idx.device
    block_q = torch.zeros(qb, dtype=torch.int32, device=dev)
    block_avg = torch.full((qb,), float(avgdl), dtype=torch.float32,
                           device=dev)
    s, d = bm25_flat(block_docs, block_tfs, block_idx, block_weight,
                     block_q, doc_lens, block_avg, live, n_docs_pad, 1, k,
                     k1=k1, b=b)
    return s[0], d[0]


def flatten_plans(plans, fb_pad: int):
    """Concatenate per-query plans into flat (idx, w, qid) arrays of
    length fb_pad (block 0 / weight 0 / query 0 as padding)."""
    idx = np.zeros(fb_pad, np.int32)
    w = np.zeros(fb_pad, np.float32)
    qid = np.zeros(fb_pad, np.int32)
    off = 0
    for i, p in enumerate(plans):
        n = p.n_blocks
        idx[off : off + n] = p.idx
        w[off : off + n] = p.w
        qid[off : off + n] = i
        off += n
    return idx, w, qid


def qb_bucket(n: int, minimum: int = 32) -> int:
    """Gather-list bucket size: a coarse x8 ladder, x2 above 16K.

    The JAX package buckets gather shapes to bound its compile cache; the
    PyTorch build compiles nothing per shape but keeps the same ladder so
    that both packages pad every dispatch identically."""
    b = max(minimum, 1)
    while b < n:
        b *= 8 if b < 16384 else 2
    return b


class QueryPlan:
    """Host-side per-query block plan with block-max upper bounds.

    For each candidate posting block: its gather index, weight (idf*boost),
    and ub = weight*(k1+1)*block_max_impact — the max BM25 contribution any
    doc in the block can receive from its term. other_ub is the sum of the
    OTHER query terms' global per-doc bounds, so ub + other_ub bounds the
    total score of every doc in the block (the WAND invariant)."""

    __slots__ = ("idx", "w", "ub", "other_ub")

    def __init__(self, idx, w, ub, other_ub):
        self.idx = np.asarray(idx, np.int32)
        self.w = np.asarray(w, np.float32)
        self.ub = np.asarray(ub, np.float64)
        self.other_ub = np.asarray(other_ub, np.float64)

    @property
    def n_blocks(self) -> int:
        return len(self.idx)

    def survivors(self, theta: float) -> "QueryPlan":
        """Blocks whose docs could still reach the top-k given score floor
        theta. Sound: a doc in a dropped block scores at most ub + other_ub
        < theta, so it provably cannot enter the final top-k. The small
        slack absorbs f32-vs-f64 rounding between device scores and host
        bounds."""
        if not np.isfinite(theta):
            return self
        # slack scales with |theta| so accumulated f32 scatter-add error on
        # large scores can't unsoundly drop a block holding a true top-k doc
        slack = max(1e-4, 1e-5 * abs(theta))
        keep = (self.ub + self.other_ub) >= (theta - slack)
        return QueryPlan(self.idx[keep], self.w[keep], self.ub[keep],
                         self.other_ub[keep])

    def top_by_ub(self, m: int) -> "QueryPlan":
        if self.n_blocks <= m:
            return self
        order = np.argsort(-self.ub, kind="stable")[:m]
        return QueryPlan(self.idx[order], self.w[order], self.ub[order],
                         self.other_ub[order])

    @staticmethod
    def concat(plans: "list[QueryPlan]",
               idx_offsets=None) -> "QueryPlan":
        """One plan from many (the plane path: per-segment plans joined
        with each segment's block base added to its gather indices).
        Per-block bounds are segment-local and stay valid unchanged."""
        if not plans:
            return QueryPlan([], [], [], [])
        idx_parts = []
        for i, p in enumerate(plans):
            off = 0 if idx_offsets is None else int(idx_offsets[i])
            idx_parts.append(p.idx + np.int32(off))
        return QueryPlan(np.concatenate(idx_parts),
                         np.concatenate([p.w for p in plans]),
                         np.concatenate([p.ub for p in plans]),
                         np.concatenate([p.other_ub for p in plans]))


# doc-space granularity of the range-partitioned WAND bound: other-term
# maxima are tracked per GRID-doc cell, so a stopword block only inherits a
# rare term's bound if the rare term actually has postings in the block's
# doc range (BMW's aligned block maxima, re-expressed on a fixed grid for
# vectorized host planning). Swept on the zipfian bench corpus (r4):
# 64-doc cells prune ~6 points more of the block space than 256 at equal
# host planning cost; 32 pays more planning than it saves.
WAND_GRID = 64


class _RangeMax:
    """Sparse-table max over a per-term coarse doc-range array: build
    O(R log R), vectorized O(1) range-max queries."""

    def __init__(self, cell_ub: np.ndarray):
        self.levels = [cell_ub]
        r = len(cell_ub)
        span = 1
        while span * 2 <= r:
            prev = self.levels[-1]
            self.levels.append(np.maximum(prev[: r - span * 2 + 1],
                                          prev[span : r - span + 1]))
            span *= 2

    def query(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Elementwise max over cells [lo_i, hi_i] (inclusive, lo <= hi)."""
        length = hi - lo + 1
        j = np.maximum(np.int64(np.log2(np.maximum(length, 1))), 0)
        out = np.zeros(len(lo), np.float64)
        for jj in np.unique(j):
            lvl = self.levels[min(int(jj), len(self.levels) - 1)]
            m = j == jj
            span = 1 << min(int(jj), len(self.levels) - 1)
            a = lvl[np.minimum(lo[m], len(lvl) - 1)]
            b_ = lvl[np.minimum(np.maximum(hi[m] - span + 1, 0),
                                len(lvl) - 1)]
            out[m] = np.maximum(a, b_)
        return out


class TermCellIndex:
    """Per-term posting-level WAND bound index, built lazily once per term.

    For a term, records which WAND_GRID-doc cells hold any of its postings
    and the max impact within each (exact, from true tfs and doc lengths),
    compressed to touched cells with a sparse table for O(1) range-max.
    Query-independent: multiply by idf*boost at query time."""

    PAIR_CACHE_CAP = 8192

    def __init__(self, block_docs: np.ndarray, block_tfs: np.ndarray,
                 doc_lens: np.ndarray, avgdl: float,
                 k1: float = DEFAULT_K1, b: float = DEFAULT_B):
        self.block_docs = block_docs
        self.block_tfs = block_tfs
        self.doc_lens = doc_lens
        self.avgdl = max(avgdl, 1e-9)
        self.k1 = k1
        self.b = b
        self._cache: dict = {}
        self._range_cache: dict = {}
        self._pair_cache: dict = {}

    def term_cells(self, start: int, count: int):
        """(touched cells ascending [int64], RangeMax over their impacts)."""
        got = self._cache.get(start)
        if got is not None:
            return got
        docs = self.block_docs[start : start + count].reshape(-1)
        tfs = self.block_tfs[start : start + count].reshape(-1)
        valid = docs >= 0
        d = docs[valid].astype(np.int64)
        f = tfs[valid].astype(np.float64)
        dl = self.doc_lens[d]
        norm = self.k1 * (1.0 - self.b + self.b * dl / self.avgdl)
        imp = f / np.maximum(f + norm, 1e-9)
        cells = d // WAND_GRID               # ascending: docs are sorted
        uniq, first = np.unique(cells, return_index=True)
        cmax = np.maximum.reduceat(imp, first) if len(first) else \
            np.zeros(0, np.float64)
        got = (uniq, _RangeMax(cmax))
        self._cache[start] = got
        return got

    def term_cell_ranges(self, start: int, count: int):
        """(c_lo, c_hi) cell range per block of the term at ``start``."""
        got = self._range_cache.get(start)
        if got is None:
            blk = self.block_docs[start : start + count]
            mins = np.maximum(blk[:, 0], 0)
            maxs = np.maximum(blk.max(axis=1), 0)
            got = (mins // WAND_GRID, maxs // WAND_GRID)
            self._range_cache[start] = got
        return got

    def pair_bound(self, start_i: int, count_i: int,
                   start_j: int, count_j: int) -> np.ndarray:
        """Unweighted max impact of term_j's actual postings within each
        of term_i's block doc-ranges (len count_i). Cached per
        (start_i, start_j): zipfian query mixes repeat frequent-term pairs
        constantly, so the per-pair range queries — the dominant host
        planning cost — amortize across the whole query stream."""
        key = (start_i, start_j)
        got = self._pair_cache.get(key)
        if got is not None:
            return got
        c_lo, c_hi = self.term_cell_ranges(start_i, count_i)
        cells_j, table_j = self.term_cells(start_j, count_j)
        lo = np.searchsorted(cells_j, c_lo, side="left")
        hi = np.searchsorted(cells_j, c_hi, side="right") - 1
        has = hi >= lo
        out = np.zeros(count_i, np.float64)
        if has.any():
            out[has] = table_j.query(lo[has], hi[has])
        while len(self._pair_cache) >= self.PAIR_CACHE_CAP:
            self._pair_cache.pop(next(iter(self._pair_cache)))
        self._pair_cache[key] = out
        return out


def build_query_plan(terms_with_weights, term_blocks_fn, block_max_impact,
                     cell_index: Optional[TermCellIndex] = None,
                     k1: float = DEFAULT_K1) -> QueryPlan:
    """Shared host prep for the pruned BM25 path.

    terms_with_weights: [(term, idf*boost)];
    term_blocks_fn(term) -> (start, count) into the block arrays;
    block_max_impact: f32 [n_blocks] (PostingsField.block_max_impact);
    per-block doc ranges come from the cell_index's own cached tables.

    other_ub for a block is the sum, over the query's OTHER terms, of that
    term's max possible contribution among its actual postings within the
    block's doc range (via cell_index) — the aligned block-max WAND bound.
    Cell granularity only loosens the bound (still sound). Without a
    cell_index the bound falls back to the terms' global maxima."""
    per_term = []     # (start, count, weight, bounds)
    for term, weight in terms_with_weights:
        start, count = term_blocks_fn(term)
        if count == 0:
            continue
        impacts = block_max_impact[start : start + count]
        bounds = weight * (k1 + 1.0) * impacts.astype(np.float64)
        per_term.append((start, count, weight, bounds))
    if not per_term:
        return QueryPlan([], [], [], [])

    idx_parts = []
    w_parts = []
    ub_parts = []
    other_parts = []
    for t_i, (start, count, weight, bounds) in enumerate(per_term):
        idx_parts.append(np.arange(start, start + count, dtype=np.int32))
        w_parts.append(np.full(count, weight, np.float32))
        ub_parts.append(bounds)
        o = np.zeros(count, np.float64)
        for t_j, (s_j, cnt_j, w_j, bounds_j) in enumerate(per_term):
            if t_j == t_i:
                continue
            if cell_index is None:
                o += float(bounds_j.max())
                continue
            o += cell_index.pair_bound(start, count, s_j, cnt_j) \
                * (w_j * (k1 + 1.0))
        other_parts.append(o)
    return QueryPlan(np.concatenate(idx_parts), np.concatenate(w_parts),
                     np.concatenate(ub_parts), np.concatenate(other_parts))


class Bm25Executor:
    """Per-(segment, field) BM25 query executor with host-side query prep.

    The batched, pruned methods serve the match path; the dense
    single-query methods (``scores``, K8, and ``top_k``, K1 at one query)
    serve the dense collector's query nodes."""

    def __init__(self, device_postings: Optional[DevicePostings],
                 host_postings: PostingsField,
                 total_doc_count: Optional[int] = None):
        self.dev = device_postings
        self.host = host_postings
        # doc count for idf; a coordinator may override with corpus-wide
        # counts (the DFS phase analog, search/dfs/DfsPhase.java:43)
        self.doc_count = total_doc_count or device_postings.n_docs

    def query_weights(self, terms, boost: float = 1.0, df_override=None):
        """(term, idf*boost) pairs; df_override maps term -> corpus-wide df
        (the DFS-phase analog). Falls back to segment-local df per term.
        ``terms`` entries may be plain strings or (term, per_term_boost)
        pairs — the latter carries bool/should per-clause boosts into the
        WAND path."""
        out = []
        for t in terms:
            tb = boost
            if isinstance(t, tuple):
                t, clause_boost = t
                tb = boost * float(clause_boost)
            tid = self.host.terms.get(t)
            df = None
            if df_override is not None:
                df = df_override.get(t)
            if df is None:
                df = int(self.host.doc_freq[tid]) if tid is not None else 0
            if df <= 0 or tid is None:
                continue  # term absent from this segment: no blocks to score
            out.append((t, idf(self.doc_count, df) * tb))
        return out

    def _avgdl(self, avgdl_override=None) -> float:
        """Effective average doc length: a coordinator may override with the
        corpus-wide value (the CollectionStatistics half of the DFS phase —
        search/dfs/DfsPhase.java:43 ships sumTotalTermFreq/docCount so every
        shard norms against the same global avgdl)."""
        if avgdl_override is not None and avgdl_override > 0:
            return float(avgdl_override)
        return float(self.dev.avgdl)

    def _query_blocks(self, terms, boost, df_override):
        tw = self.query_weights(terms, boost, df_override)
        block_idx, block_w = gather_query_blocks(self.host, tw)
        dev = self.dev.block_docs.device
        return (torch.as_tensor(block_idx, device=dev),
                torch.as_tensor(block_w, device=dev))

    def scores(self, terms, live: torch.Tensor, boost: float = 1.0,
               df_override=None, k1: float = DEFAULT_K1,
               b: float = DEFAULT_B, avgdl_override=None) -> torch.Tensor:
        """Dense masked scores for the query terms (used when composing
        inside bool queries): K8, 0 at dead docs."""
        block_idx, block_w = self._query_blocks(terms, boost, df_override)
        return bm25_block_scores(self.dev.block_docs, self.dev.block_tfs,
                                 block_idx, block_w, self.dev.doc_lens,
                                 self._avgdl(avgdl_override),
                                 self.dev.n_docs_pad, live, k1=k1, b=b)

    def top_k(self, terms, live: torch.Tensor, k: int, boost: float = 1.0,
              df_override=None, k1: float = DEFAULT_K1,
              b: float = DEFAULT_B, avgdl_override=None):
        """One query's top-k over live docs with score > 0 (``bm25_topk``,
        served by K1 at one query): (s [k] f32, d [k] int32)."""
        block_idx, block_w = self._query_blocks(terms, boost, df_override)
        return bm25_topk(self.dev.block_docs, self.dev.block_tfs, block_idx,
                         block_w, self.dev.doc_lens,
                         self._avgdl(avgdl_override), live,
                         self.dev.n_docs_pad, k, k1=k1, b=b)

    def top_k_batch(self, queries, live: torch.Tensor, k: int,
                    boost: float = 1.0, df_override=None,
                    k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                    prune: bool = True, avgdl_override=None,
                    count_hits: bool = False):
        """Batched, block-max-pruned BM25 over Q queries (each a term list).

        Two phases, each ONE device dispatch for the whole batch:
          1. score only each query's P1_BUCKET highest-upper-bound blocks;
             the k-th partial score is a floor (theta) on the true k-th
             score — partial sums only underestimate;
          2. re-score exactly, but only blocks whose WAND bound
             (ub + other-term bounds) clears theta. Zipfian stopword
             blocks never get gathered — this is where the HBM-traffic
             saving is (TopDocsCollectorContext.java:215's block-max WAND
             early termination, re-expressed as static-shape phases).
        Returns (scores [Q, k], doc ids [Q, k]) — plus hits [Q] when
        ``count_hits`` — and records
        last_prune_stats = (blocks_total, blocks_scored)."""
        avgdl = self._avgdl(avgdl_override)
        plans = self.build_plans(queries, boost, df_override, k1, b, avgdl)
        total_blocks = sum(p.n_blocks for p in plans)
        max_blocks = max((p.n_blocks for p in plans), default=1)
        if not prune or max_blocks <= P1_BUCKET:
            # every block is gathered — counts (if asked) are EXACT
            self.last_prune_stats = (total_blocks, total_blocks)
            self.last_hits_exact = True
            return self._dispatch_flat(plans, live, k, k1, b, avgdl,
                                       counted=count_hits)
        p1 = [p.top_by_ub(P1_BUCKET) for p in plans]
        s1, _ = self._dispatch_flat(p1, live, k, k1, b, avgdl)
        theta = np.asarray(s1)[:, k - 1]          # -inf when < k matches
        return self.finish_pruned(plans, theta, live, k, k1, b, avgdl,
                                  count_hits)

    def build_plans(self, queries, boost: float = 1.0, df_override=None,
                    k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                    avgdl: Optional[float] = None):
        """Host planning for a batch: one WAND block plan per query."""
        if avgdl is None:
            avgdl = self._avgdl(None)
        hp = self.host
        # per-term cell index for the aligned WAND bound (within a term,
        # blocks are doc-sorted; entry 0 of every block is always valid).
        # Keyed by (k1, b, avgdl) in a small FIFO-bounded dict so DFS
        # (global avgdl) and plain (segment avgdl) traffic interleave
        # without rebuilding each other's lazily-filled cell tables.
        cells_key = (k1, b, avgdl)
        cells = getattr(self, "_cell_cache", None)
        if cells is None:
            cells = self._cell_cache = {}
        cell_index = cells.get(cells_key)
        if cell_index is None:
            while len(cells) >= 4:
                cells.pop(next(iter(cells)))
            cell_index = cells[cells_key] = TermCellIndex(
                hp.block_docs, hp.block_tfs, hp.doc_lens, avgdl, k1=k1, b=b)
        plans = []
        for terms in queries:
            tw = self.query_weights(terms, boost, df_override)
            plans.append(build_query_plan(
                tw, self.host.term_blocks,
                self.host.block_max_impact(k1, b, avgdl),
                cell_index=cell_index, k1=k1))
        return plans

    def phase1(self, plans, live: torch.Tensor, k: int,
               k1: float = DEFAULT_K1, b: float = DEFAULT_B,
               avgdl: Optional[float] = None):
        """Dispatch phase 1 (top-ub blocks) and return the scores [Q, k]
        (host numpy, like every dispatch_flat result)."""
        if avgdl is None:
            avgdl = self._avgdl(None)
        p1 = [p.top_by_ub(P1_BUCKET) for p in plans]
        s1, _ = self._dispatch_flat(p1, live, k, k1, b, avgdl)
        return s1

    def finish_pruned(self, plans, theta, live: torch.Tensor, k: int,
                      k1: float = DEFAULT_K1, b: float = DEFAULT_B,
                      avgdl: Optional[float] = None,
                      count_hits: bool = False):
        """Phase 2: drop blocks whose WAND bound misses theta (one theta
        per query — possibly a shard-global one tighter than this
        segment's own) and score the survivors exactly."""
        if avgdl is None:
            avgdl = self._avgdl(None)
        total_blocks = sum(p.n_blocks for p in plans)
        p2 = [p.survivors(float(t)) for p, t in zip(plans, theta)]
        scored = sum(p.n_blocks for p in p2)
        p1_cost = sum(min(p.n_blocks, P1_BUCKET) for p in plans)
        self.last_prune_stats = (total_blocks,
                                 min(scored + p1_cost, total_blocks))
        # pruned counts observe only survivor blocks: a LOWER bound
        self.last_hits_exact = scored >= total_blocks
        return self._dispatch_flat(p2, live, k, k1, b, avgdl,
                                   counted=count_hits)

    # per-dispatch ceiling on the query dimension: the accumulator is
    # n_q * n_docs_pad * 8 bytes — 64 queries over a 16M-doc pad is 8.6 GB,
    # so bigger batches split (and phase-1 theta syncs once per chunk)
    MAX_CHUNK_Q = 64

    def _dispatch_flat(self, plans, live, k, k1, b, avgdl, counted=False):
        return dispatch_flat(self.dev.block_docs, self.dev.block_tfs,
                             self.dev.doc_lens, self.dev.n_docs_pad,
                             plans, live, k, k1, b, avgdl=avgdl,
                             counted=counted)


MAX_CHUNK_Q = Bm25Executor.MAX_CHUNK_Q


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def dispatch_flat(block_docs, block_tfs, doc_lens, n_docs_pad: int,
                  plans, live, k: int, k1: float, b: float,
                  avgdl: Optional[float] = None,
                  block_avgdl: Optional[np.ndarray] = None,
                  counted: bool = False, counter: Optional[list] = None,
                  count_segments: Optional[Tuple] = None):
    """Flat-dispatch a batch of plans over one block store: device work
    scales with the ACTUAL total block count (one pow-ladder bucket of
    padding), never with Q x max-plan. Chunks bound both the gather
    (MAX_BATCH_CELLS) and the accumulator (MAX_CHUNK_Q); n_q pads to a
    pow2 bucket.

    The block store is either one segment's (scalar ``avgdl``) or a whole
    shard plane's (``block_avgdl`` [NB] host array, gathered per plan so
    every block keeps its owning segment's norm). ``counter``, when given,
    accumulates the number of kernel calls made.

    ``count_segments``: (seg_ids device [n_docs_pad] int32, n_segs) —
    hits come back PER SEGMENT [n_q, n_segs] instead of [n_q] (the
    totals-disabled plane contract); overrides ``counted``.

    Results come back as host numpy arrays."""
    chunks: list = []
    cur: list = []
    cells = 0
    for p in plans:
        nb = max(p.n_blocks, 1)
        if cur and (len(cur) >= MAX_CHUNK_Q
                    or cells + nb > MAX_BATCH_CELLS):
            chunks.append(cur)
            cur, cells = [], 0
        cur.append(p)
        cells += nb
    if cur:
        chunks.append(cur)
    if count_segments is not None:
        counted = True
    dev = block_docs.device
    out_s, out_d, out_h = [], [], []
    for chunk in chunks:
        n_real = len(chunk)
        n_q = next_pow2(n_real, minimum=1)
        fb = qb_bucket(max(sum(p.n_blocks for p in chunk), 1))
        idx, w, qid = flatten_plans(chunk, fb)
        if block_avgdl is not None:
            flat_avg = block_avgdl[idx].astype(np.float32)
        else:
            flat_avg = np.full(fb, avgdl, np.float32)
        if counter is not None:
            counter.append(1)
        flat = [torch.as_tensor(a, device=dev)
                for a in (idx, w, qid, flat_avg)]
        if count_segments is not None:
            seg_ids, n_segs = count_segments
            got = bm25_flat_seg(
                block_docs, block_tfs, flat[0], flat[1], flat[2], doc_lens,
                flat[3], live, seg_ids, n_docs_pad, n_q, k, k1=k1, b=b,
                n_segs=n_segs)
        else:
            # ALWAYS the counted variant: hits are read off the plane the
            # kernel builds anyway, and one variant keeps the launch
            # pattern independent of batch composition
            got = bm25_topk_flat_counted(
                block_docs, block_tfs, flat[0], flat[1], flat[2], doc_lens,
                flat[3], live, n_docs_pad, n_q, k, k1=k1, b=b)
        s, d, h = (_host(t) for t in got)
        out_s.append(s[:n_real])
        out_d.append(d[:n_real])
        out_h.append(h[:n_real])
    s = np.concatenate(out_s)
    d = np.concatenate(out_d)
    if counted:
        return s, d, np.concatenate(out_h)
    return s, d
