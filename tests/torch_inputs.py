"""Seeded kernel inputs shared by the port's kernel tests (numpy only, so
both the JAX-parity tests and the card test can use them)."""

import numpy as np
import torch

from elasticsearch_tpu_torch.ops.bm25 import qb_bucket


def make_inputs(seed: int, n_docs: int = 3000, nb: int = 96, n_q: int = 4,
                per_q: int = 20, n_segs: int = 3):
    """A seeded block store and flat rows padded like ``flatten_plans``."""
    rng = np.random.default_rng(seed)
    docs = np.sort(rng.integers(0, n_docs, (nb, 128)), axis=1).astype(np.int32)
    docs[rng.random((nb, 128)) < 0.1] = -1
    tfs = np.where(docs >= 0, rng.integers(1, 7, (nb, 128)), 0).astype(
        np.float32)
    n_pad = 1
    while n_pad < n_docs:
        n_pad *= 2
    dl = np.zeros(n_pad, np.float32)
    dl[:n_docs] = rng.integers(16, 97, n_docs)
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) > 0.05
    seg = np.minimum(np.arange(n_pad) * n_segs // n_docs,
                     n_segs - 1).astype(np.int32)
    n = n_q * per_q
    fb = qb_bucket(n)
    idx = np.zeros(fb, np.int32)
    w = np.zeros(fb, np.float32)
    q = np.zeros(fb, np.int32)
    avg = np.full(fb, 50.0, np.float32)
    idx[:n] = rng.integers(0, nb, n)
    w[:n] = rng.uniform(0.2, 9.0, n)
    q[:n] = np.repeat(np.arange(n_q), per_q)
    avg[:n] = rng.uniform(40.0, 60.0, n)
    return dict(docs=docs, tfs=tfs, dl=dl, live=live, seg=seg, idx=idx, w=w,
                q=q, avg=avg, n_pad=n_pad, n_q=n_q, n_segs=n_segs)


def tx(inp, *names):
    return [torch.as_tensor(inp[n]) for n in names]


FLAT = ("docs", "tfs", "idx", "w", "q", "dl", "avg", "live")


def make_knn_inputs(seed: int, dims: int, n_q: int, kind: str, n_docs: int,
                    n_pad: int):
    """Seeded kNN inputs (matrix [n_pad, dims] f32, norms, exists, live,
    queries [n_q, dims]): integer-valued (0..255, SIFT1M's kind) or
    Gaussian rows, ~10 % missing vectors and deleted docs, three duplicates
    of row 5 (score ties) and an all-zero last query row."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        m = rng.integers(0, 256, (n_pad, dims)).astype(np.float32)
        q = rng.integers(0, 256, (n_q, dims)).astype(np.float32)
    else:
        m = rng.standard_normal((n_pad, dims)).astype(np.float32)
        q = rng.standard_normal((n_q, dims)).astype(np.float32)
    exists = np.zeros(n_pad, bool)
    exists[:n_docs] = rng.random(n_docs) > 0.1        # missing vectors
    m[~exists] = 0.0
    for dup in (11, 17, 40):                          # score ties
        m[dup] = m[5]
        exists[dup] = exists[5] = True
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) > 0.1          # deleted docs
    live[[5, 11, 17, 40]] = True
    norms = np.linalg.norm(m, axis=1).astype(np.float32)
    q[-1] = 0.0                                       # a zero query row
    return m, norms, exists, live, q


def close_ids(s_ref, d_ref, d_port, rtol: float):
    """Ids equal wherever the reference's neighbouring scores differ by
    more than ``rtol`` (a near-tie may order either way); non-finite
    slots are skipped."""
    s_ref, d_ref, d_port = map(np.asarray, (s_ref, d_ref, d_port))
    for r in range(s_ref.shape[0]):
        s = s_ref[r]
        for j in range(len(s)):
            if not np.isfinite(s[j]):
                continue
            lo = abs(s[j - 1] - s[j]) if j else np.inf
            hi = abs(s[j + 1] - s[j]) if j + 1 < len(s) else np.inf
            if min(lo, hi) > rtol * abs(s[j]):
                assert d_port[r, j] == d_ref[r, j], (r, j)


def make_sparse_inputs(seed: int, n_docs: int = 3000, nb: int = 96,
                       n_q: int = 3, per_q: int = 20, q_pad: int = 4):
    """A seeded rank_features block store (doc ids ascending within a
    block, -1 padding, weights in [0.05, 3)) and [q_pad, QB] block lists
    of n_q real queries padded like ``gather_feature_blocks`` /
    ``top_k_batch``: block 0 / weight 0 past each query's blocks, whole
    weight-0 rows past n_q (the pow2 query padding). Query weights in
    [0.1, 3)."""
    rng = np.random.default_rng(seed)
    docs = np.sort(rng.integers(0, n_docs, (nb, 128)), axis=1).astype(np.int32)
    docs[rng.random((nb, 128)) < 0.1] = -1
    weights = np.where(docs >= 0, rng.uniform(0.05, 3.0, (nb, 128)),
                       0.0).astype(np.float32)
    n_pad = 128
    while n_pad < n_docs:
        n_pad *= 2
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) > 0.05
    qb = 8
    while qb < per_q:
        qb *= 2
    idx = np.zeros((q_pad, qb), np.int32)
    qw = np.zeros((q_pad, qb), np.float32)
    for q in range(n_q):
        n = int(rng.integers(per_q // 2, per_q + 1))
        idx[q, :n] = rng.integers(0, nb, n)
        qw[q, :n] = rng.uniform(0.1, 3.0, n)
    return dict(docs=docs, weights=weights, idx=idx, qw=qw, live=live,
                n_pad=n_pad, n_q=n_q)
