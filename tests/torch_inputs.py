"""Seeded kernel inputs shared by the port's kernel tests (numpy only, so
both the JAX-parity tests and the card test can use them)."""

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import BLOCK, next_pow2
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


N_SEGS = 3


def mesh_inputs(seed: int, n_slots: int, dp: int, n_q: int, per_q: int = 20,
                empty: int = -1, one_seg: int = -1, n_docs: int = 3000):
    """Stacked postings planes of ``n_slots`` shards of different sizes
    (below ``n_docs`` docs each; slot ``empty`` holds no field data, slot
    ``one_seg`` one segment where the others hold three), padded as
    ``MeshPlaneRegistry._stack`` pads them, and flat operands [S, DP, FB]
    per (slot, dp row) laid out as ``flatten_plans`` lays them out."""
    rng = np.random.default_rng(seed)
    n_docs = [int(rng.integers(n_docs * 3 // 10, n_docs))
              for _ in range(n_slots)]
    nbs = [int(rng.integers(30, 96)) for _ in range(n_slots)]
    n_pads = [next_pow2(n, minimum=BLOCK) for n in n_docs]
    n_max = max(n_pads)
    nb_max = next_pow2(max(nbs))
    docs = np.full((n_slots, nb_max, BLOCK), -1, np.int32)
    tfs = np.zeros((n_slots, nb_max, BLOCK), np.float32)
    dl = np.zeros((n_slots, n_max), np.float32)
    live = np.zeros((n_slots, n_max), bool)
    seg = np.zeros((n_slots, n_max), np.int32)
    fb = qb_bucket(n_q * per_q)
    idx = np.zeros((n_slots, dp, fb), np.int32)
    w = np.zeros((n_slots, dp, fb), np.float32)
    q = np.zeros((n_slots, dp, fb), np.int32)
    avg = np.ones((n_slots, dp, fb), np.float32)
    own = []
    for s in range(n_slots):
        own.append((n_pads[s], nbs[s], 1 if s == one_seg else N_SEGS))
        if s == empty:
            continue
        n, nb = n_docs[s], nbs[s]
        d = np.sort(rng.integers(0, n, (nb, BLOCK)), axis=1).astype(np.int32)
        d[rng.random((nb, BLOCK)) < 0.1] = -1
        docs[s, :nb] = d
        tfs[s, :nb] = np.where(d >= 0, rng.integers(1, 7, (nb, BLOCK)), 0)
        dl[s, :n] = rng.integers(16, 97, n)
        live[s, :n] = rng.random(n) > 0.05
        n_segs = own[s][2]
        cuts = np.sort(rng.integers(1, n, n_segs - 1))
        base = np.concatenate([[0], cuts])
        seg[s] = np.maximum(np.searchsorted(base, np.arange(n_max),
                                            side="right") - 1, 0)
        m = n_q * per_q
        for r in range(dp):
            idx[s, r, :m] = rng.integers(0, nb, m)
            w[s, r, :m] = rng.uniform(0.2, 9.0, m)
            q[s, r, :m] = np.repeat(np.arange(n_q), per_q)
            avg[s, r, :m] = rng.uniform(40.0, 60.0, m)
    return dict(docs=docs, tfs=tfs, dl=dl, idx=idx, w=w, q=q, avg=avg,
                live=live, seg=seg, n_pad=n_max, n_q=n_q, own=own)


# mesh_bm25_flat / mesh_bm25_coarse operand order
FLAT_ORDER = ("docs", "tfs", "dl", "idx", "w", "q", "avg", "live", "seg")


def row0(inp):
    """The [S, FB] flat operands of the coarse and re-rank tiers (each
    slot's dp row 0)."""
    out = dict(inp)
    for name in ("idx", "w", "q", "avg"):
        out[name] = np.ascontiguousarray(inp[name][:, 0])
    return out


def mesh_knn_inputs(seed: int, n_slots: int, n_q: int, dims: int = 16,
                    kind: str = "int", empty: int = -1, n_docs: int = 900):
    """Stacked vector planes of ``n_slots`` shards of different sizes (below
    ``n_docs`` docs each; slot ``empty`` holds no vectors), padded as
    ``MeshPlaneRegistry._stack`` pads them (zero rows, exists False), with
    integer-valued (0..255) or Gaussian rows, ~10 % missing vectors and
    deleted docs, duplicate rows in every slot (score ties), queries [n_q,
    D] with an all-zero last row, and per-query filter rows [S, n_q, N_pad]
    (about half of each slot's docs; padding docs False)."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(n_docs // 3, n_docs)) for _ in range(n_slots)]
    n_pads = [next_pow2(n, minimum=BLOCK) for n in sizes]
    n_max = max(n_pads)
    matrix = np.zeros((n_slots, n_max, dims), np.float32)
    exists = np.zeros((n_slots, n_max), bool)
    live = np.zeros((n_slots, n_max), bool)
    masks = np.zeros((n_slots, n_q, n_max), bool)
    for s, n in enumerate(sizes):
        if s == empty:
            continue
        m, _nr, ex, lv, _q = make_knn_inputs(seed * 31 + s, dims, 1, kind, n,
                                             n_max)
        matrix[s], exists[s], live[s] = m, ex, lv
        masks[s, :, :n] = rng.random((n_q, n)) < 0.5
    norms = np.linalg.norm(matrix, axis=2).astype(np.float32)
    if kind == "int":
        queries = rng.integers(0, 256, (n_q, dims)).astype(np.float32)
    else:
        queries = rng.standard_normal((n_q, dims)).astype(np.float32)
    queries[-1] = 0.0
    return dict(matrix=matrix, norms=norms, exists=exists, live=live,
                allowed=live & exists, masks=masks, queries=queries,
                n_pad=n_max, own=n_pads, empty=empty)


def mesh_sparse_inputs(seed: int, n_slots: int, dp: int, n_q: int,
                       per_q: int = 20, empty: int = -1, n_docs: int = 3000):
    """Stacked rank_features planes of ``n_slots`` shards of different sizes
    (below ``n_docs`` docs each; slot ``empty`` holds no field data), padded
    as ``MeshPlaneRegistry._stack`` pads them (NB to a power of two over
    the slots, block docs -1, weights 0, live False), and block lists and
    query weights [S, DP, n_q, QB] per (slot, dp row) padded like
    ``plane_exec.mesh_sparse_topk``'s: block 0 / weight 0 past each query's
    blocks, whole weight-0 rows for the last query (the pow2 query
    padding). Doc weights in [0.05, 3), query weights in [0.1, 3), ~10 %
    padding postings and ~5 % deleted docs."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(n_docs * 3 // 10, n_docs))
             for _ in range(n_slots)]
    nbs = [int(rng.integers(30, 96)) for _ in range(n_slots)]
    n_pads = [next_pow2(n, minimum=BLOCK) for n in sizes]
    n_max = max(n_pads)
    nb_max = next_pow2(max(nbs))
    docs = np.full((n_slots, nb_max, BLOCK), -1, np.int32)
    weights = np.zeros((n_slots, nb_max, BLOCK), np.float32)
    live = np.zeros((n_slots, n_max), bool)
    qb = next_pow2(per_q, minimum=8)
    idx = np.zeros((n_slots, dp, n_q, qb), np.int32)
    qw = np.zeros((n_slots, dp, n_q, qb), np.float32)
    own = []
    for s in range(n_slots):
        own.append((n_pads[s], nbs[s]))
        if s == empty:
            continue
        n, nb = sizes[s], nbs[s]
        d = np.sort(rng.integers(0, n, (nb, BLOCK)), axis=1).astype(np.int32)
        d[rng.random((nb, BLOCK)) < 0.1] = -1
        docs[s, :nb] = d
        weights[s, :nb] = np.where(d >= 0, rng.uniform(0.05, 3.0,
                                                       (nb, BLOCK)), 0.0)
        live[s, :n] = rng.random(n) > 0.05
        for r in range(dp):
            for q in range(max(n_q - 1, 1)):
                m = int(rng.integers(per_q // 2, per_q + 1))
                idx[s, r, q, :m] = rng.integers(0, nb, m)
                qw[s, r, q, :m] = rng.uniform(0.1, 3.0, m)
    return dict(docs=docs, weights=weights, idx=idx, qw=qw, live=live,
                n_pad=n_max, own=own)


# ---------------------------------------------------------------------------
# the sharded data plane (parallel/sharded_search.py, rows 40-44)
# ---------------------------------------------------------------------------

# integer triples of integer norm (3, 7, 9, 9, 11, 11); a dot of two rows
# built from them stays within 3 * 9 * 9 = 243, exact even in bf16
INT_TRIPLES = ((1, 2, 2), (2, 3, 6), (1, 4, 8), (4, 4, 7), (2, 6, 9),
               (6, 6, 7))


def int_norm_vectors(rng, n: int, dims: int, dup: float = 0.1):
    """[n, dims] f32 rows, each a signed, permuted triple of INT_TRIPLES in
    3 random dims (so norms, dots and every similarity's intermediate are
    exact in f32 whatever the order of the operations), a ``dup`` share of
    them copies of earlier rows (score ties)."""
    out = np.zeros((n, dims), np.float32)
    for i in range(n):
        if i >= 4 and rng.random() < dup:
            out[i] = out[int(rng.integers(0, i))]
            continue
        t = np.array(INT_TRIPLES[int(rng.integers(len(INT_TRIPLES)))],
                     np.float32) * rng.choice([-1.0, 1.0], 3)
        out[i, rng.choice(dims, 3, replace=False)] = rng.permutation(t)
    return out


def vector_slots(vectors, n_slots: int, per: int):
    """The sharded placement of ``vectors`` (doc g at slot g % S, local
    g // S): (matrix [S, per, D] f32, norms [S, per], valid [S, per])."""
    n, d = vectors.shape
    flat = np.zeros((per * n_slots, d), np.float32)
    flat[:n] = vectors
    mat = np.ascontiguousarray(flat.reshape(per, n_slots, d)
                               .transpose(1, 0, 2))
    valid = np.zeros(per * n_slots, bool)
    valid[:n] = True
    valid = np.ascontiguousarray(valid.reshape(per, n_slots).T)
    return mat, np.linalg.norm(mat, axis=2).astype(np.float32), valid


def text_docs(seed: int, n: int, vocab: int = 60, dup_every: int = 9):
    """Token lists of 2-12 Zipf(1.3) words over ``vocab``; every
    ``dup_every``-th doc repeats an earlier one (BM25 score ties)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        if i and i % dup_every == 0:
            docs.append(list(docs[int(rng.integers(0, i))]))
            continue
        docs.append([f"t{min(int(rng.zipf(1.3)) - 1, vocab - 1)}"
                     for _ in range(int(rng.integers(2, 13)))])
    return docs


def sharded_inputs(seed: int, n_slots: int, n_docs: int = 600,
                   dims: int = 16, n_q: int = 4, kind: str = "int",
                   vocab: int = 60):
    """Seeded operands of rows 40-44 on one slot layout, numpy: a text
    corpus packed by the port's ``ShardedTextIndex`` (block_docs,
    block_tfs, doc_lens [S, N], avgdl) with n_q queries' block lists
    (bm25_idx / bm25_w [S, n_q, QB]; row 41 takes query 0's), the same
    docs' vectors (integer rows of integer norm, or Gaussian) placed on
    the same N (matrix, norms, valid) with queries and their qn / q2,
    and rank_features operands on the text blocks (block_weights, and
    sparse_idx / sparse_w [S, QB], a few padding entries included)."""
    from elasticsearch_tpu_torch.ops.knn import query_norms
    from elasticsearch_tpu_torch.parallel.mesh import make_mesh
    from elasticsearch_tpu_torch.parallel.sharded_search import (
        ShardedTextIndex,
    )
    rng = np.random.default_rng(seed)
    docs = text_docs(seed, n_docs, vocab)
    text = ShardedTextIndex(make_mesh(n_slots, device="cpu"), docs)
    per = text.n_per_shard
    if kind == "int":
        vectors = int_norm_vectors(rng, n_docs, dims)
        queries = int_norm_vectors(rng, n_q, dims, dup=0.0)
    else:
        vectors = rng.standard_normal((n_docs, dims)).astype(np.float32)
        queries = rng.standard_normal((n_q, dims)).astype(np.float32)
    matrix, norms, valid = vector_slots(vectors, n_slots, per)
    qn, q2 = query_norms(queries)
    lists = [text.prep_query([f"t{int(t)}" for t in
                              rng.integers(0, vocab // 3,
                                           int(rng.integers(1, 4)))])
             for _ in range(n_q)]
    qb = max(x[0].shape[1] for x in lists)
    bm25_idx = np.zeros((n_slots, n_q, qb), np.int32)
    bm25_w = np.zeros((n_slots, n_q, qb), np.float32)
    for q, (idx, w) in enumerate(lists):
        bm25_idx[:, q, : idx.shape[1]] = idx
        bm25_w[:, q, : w.shape[1]] = w
    bd = text.block_docs.numpy()
    nb = bd.shape[1]
    weights = np.where(bd >= 0, text.block_tfs.numpy() * rng.uniform(
        0.1, 3.0, bd.shape), 0.0).astype(np.float32)
    sqb = 16
    sparse_idx = rng.integers(0, nb, (n_slots, sqb)).astype(np.int32)
    sparse_w = rng.uniform(0.2, 2.0, (n_slots, sqb)).astype(np.float32)
    sparse_idx[:, -3:] = 0
    sparse_w[:, -3:] = 0.0
    return dict(block_docs=bd, block_tfs=text.block_tfs.numpy(),
                doc_lens=text.doc_lens.numpy(), avgdl=text.avgdl,
                bm25_idx=bm25_idx, bm25_w=bm25_w, matrix=matrix,
                norms=norms, valid=valid, queries=queries, qn=qn, q2=q2,
                block_weights=weights, sparse_idx=sparse_idx,
                sparse_w=sparse_w, n_per_shard=per, n_docs=n_docs,
                vectors=vectors, docs=docs)
