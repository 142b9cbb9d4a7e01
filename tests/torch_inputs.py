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


# ---------------------------------------------------------------------------
# the BM25 tile pipeline's cases (csrc/tiles.cuh; ops/bm25.py
# ``bm25_tiles_mirror``): postings whose docs ascend through each term's
# blocks, at a small tile on the CPU and, scaled, at the card's 8,192
# ---------------------------------------------------------------------------

def tile_postings(rng, n_docs: int, n_terms: int, rare: float,
                  flat: bool = False):
    """(block_docs [NB, 128] int32, block_tfs [NB, 128] f32, term -> its
    block ids): each term's docs ascend through its blocks, -1 pads the
    last one; a share ``rare`` of the terms hold a few docs spread over
    the whole range, the others a dense run of a narrow range. ``flat``:
    every tf 1 (with equal doc lengths, every score of a term ties)."""
    blocks, tfs, of_term = [], [], []
    for _ in range(n_terms):
        if rng.random() < rare:
            docs = np.sort(rng.choice(n_docs, int(rng.integers(2, 40)),
                                      replace=False))
        else:
            width = int(rng.integers(100, max(101, n_docs // 4)))
            start = int(rng.integers(0, n_docs - width))
            df = int(rng.integers(20, min(width, 600)))
            docs = np.sort(rng.choice(width, df, replace=False)) + start
        ids = []
        for i in range(0, len(docs), 128):
            part = docs[i: i + 128]
            row = np.full(128, -1, np.int32)
            row[: len(part)] = part
            tf = np.zeros(128, np.float32)
            tf[: len(part)] = 1 if flat else rng.integers(1, 7, len(part))
            ids.append(len(blocks))
            blocks.append(row)
            tfs.append(tf)
        of_term.append(ids)
    return np.stack(blocks), np.stack(tfs), of_term


def tile_flat(rng, of_term, n_q: int, terms_per_q: int, fb_pad: int,
              skip_rows=(), flat: bool = False):
    """flatten_plans-shaped (idx, w, q, avgdl): each query's blocks of
    ``terms_per_q`` terms, then padding (block 0, weight 0, query 0)."""
    idx, w, q, avg = [], [], [], []
    for qi in range(n_q):
        if qi in skip_rows:
            continue
        for term in rng.choice(len(of_term), terms_per_q, replace=False):
            weight = 2.0 if flat else float(rng.uniform(0.2, 9.0))
            for blk in of_term[term]:
                idx.append(blk)
                w.append(weight)
                q.append(qi)
                avg.append(50.0 if flat else float(rng.uniform(40.0, 60.0)))
    n = len(idx)
    fb = max(fb_pad, n)
    out = (np.zeros(fb, np.int32), np.zeros(fb, np.float32),
           np.zeros(fb, np.int32), np.full(fb, 50.0, np.float32))
    for arr, vals in zip(out, (idx, w, q, avg)):
        arr[:n] = vals
    return out


def tile_doc_arrays(rng, n_pad: int, n_docs: int, dead: float, n_segs: int,
                    flat: bool = False):
    """(doc lengths, live mask, seg ids) over n_pad docs; seg ids contiguous
    (with a few past n_segs, which count nowhere) or, above 8 segments,
    cycling through all n_segs."""
    dl = np.zeros(n_pad, np.float32)
    dl[:n_docs] = 50 if flat else rng.integers(16, 97, n_docs)
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) >= dead
    if n_segs > 8:
        seg = (np.arange(n_pad) % n_segs).astype(np.int32)
    else:
        seg = np.minimum(np.arange(n_pad) * n_segs // max(n_docs, 1),
                         n_segs - 1).astype(np.int32)
        seg[-3:] = n_segs + 5
    return dl, live, seg


# name -> (seed, n_docs, n_pad, tile, n_q, k, k', terms a query, share of
# rare terms, dead share, n_segs, rows with no entries, tied scores)
TILE_CASES = {
    "spanning_blocks": (1, 3000, 4096, 64, 4, 10, 64, 6, 0.7, 0.05, 3, (),
                        False),
    "empty_rows": (2, 2000, 2048, 128, 8, 10, 96, 3, 0.2, 0.05, 3, (3, 6),
                   False),
    "fill_in_untouched_tiles": (3, 2000, 2048, 64, 3, 700, 700, 1, 1.0, 0.3,
                                2, (), False),
    "k_above_4096": (4, 12000, 16384, 1024, 2, 5000, 4096, 30, 0.1, 0.05, 3,
                     (), False),
    "kprime_4096_reruns": (5, 9000, 16384, 512, 2, 4096, 4096, 12, 0.05,
                           0.0, 3, (), False),
    "mid_k_reruns": (6, 6000, 8192, 256, 4, 200, 300, 4, 0.0, 0.0, 3, (),
                     False),
    "dead_docs_and_padding": (7, 2500, 4096, 128, 4, 50, 128, 4, 0.3, 0.5,
                              3, (), False),
    "n_segs_4096": (8, 5000, 8192, 256, 2, 20, 64, 5, 0.3, 0.05, 4096, (),
                    False),
    "ragged_last_tile": (9, 1900, 2000, 256, 3, 40, 100, 4, 0.3, 0.05, 3,
                         (), False),
    "ties_across_tiles": (10, 3000, 4096, 128, 3, 20, 200, 1, 0.0, 0.1, 3,
                          (), True),
}

CARD_TILE = 8192      # csrc/tiles.cuh TILE


def tile_case(name: str, scale: int = 1):
    """One case as tensors (CPU); ``scale`` spreads every doc id d to
    d * scale over n_pad * scale docs, so that the case's tiles become
    tiles of tile * scale docs (scale CARD_TILE // tile puts them on the
    card's tiles)."""
    (seed, n_docs, n_pad, tile, n_q, k, kp, per_q, rare, dead, n_segs,
     skip, flat) = TILE_CASES[name]
    rng = np.random.default_rng(seed)
    bd, bt, of_term = tile_postings(rng, n_docs, 60, rare, flat)
    idx, w, q, avg = tile_flat(rng, of_term, n_q, per_q, qb_bucket(1), skip,
                               flat)
    dl, live, seg = tile_doc_arrays(rng, n_pad, n_docs, dead, n_segs, flat)
    if scale > 1:
        bd = np.where(bd >= 0, bd * scale, -1).astype(np.int32)
        big = n_pad * scale
        dl2 = np.zeros(big, np.float32)
        live2 = np.zeros(big, bool)
        dl2[::scale] = dl
        live2[::scale] = live
        seg2 = np.repeat(seg, scale) if n_segs <= 8 else \
            (np.arange(big) % n_segs).astype(np.int32)
        dl, live, seg, n_pad = dl2, live2, seg2.astype(np.int32), big
    T = torch.as_tensor
    return dict(bd=T(bd), bt=T(bt), fi=T(idx), fw=T(w), fq=T(q), fa=T(avg),
                dl=T(dl), live=T(live), seg=T(seg), n_pad=n_pad,
                tile=tile * scale, n_q=n_q, k=min(k, n_pad),
                kp=min(kp, n_pad), n_segs=n_segs)


def tile_slots(seed: int = 21, scale: int = 1, n_slots: int = 4):
    """A stack of n_slots tile-case planes (the last one empty) for the
    mesh's rows 31 and 32: block stores [S, 512, 128], doc arrays
    [S, 4096 * scale], flat operands [S, FB]; tile 128 * scale."""
    n_pad, n_docs = 4096, 3000
    rng = np.random.default_rng(seed)
    stores, flats, docs = [], [], []
    for slot in range(n_slots):
        bd, bt, of_term = tile_postings(rng, n_docs, 40, 0.3)
        pad_bd = np.full((512, 128), -1, np.int32)
        pad_bt = np.zeros((512, 128), np.float32)
        if slot < n_slots - 1:
            pad_bd[: len(bd)] = np.where(bd >= 0, bd * scale, -1)
            pad_bt[: len(bt)] = bt
        stores.append((pad_bd, pad_bt))
        flats.append(tile_flat(rng, of_term, 2, 4, 1024))
        dl, live, seg = tile_doc_arrays(rng, n_pad, n_docs, 0.1, 3)
        if scale > 1:
            big = n_pad * scale
            dl2, live2 = np.zeros(big, np.float32), np.zeros(big, bool)
            dl2[::scale], live2[::scale] = dl, live
            dl, live, seg = dl2, live2, np.repeat(seg, scale)
        docs.append((dl, live, seg.astype(np.int32)))
    T = torch.as_tensor
    return dict(
        bd=T(np.stack([x[0] for x in stores])),
        bt=T(np.stack([x[1] for x in stores])),
        dl=T(np.stack([x[0] for x in docs])),
        live=T(np.stack([x[1] for x in docs])),
        seg=T(np.stack([x[2] for x in docs])),
        fi=T(np.stack([f[0] for f in flats])),
        fw=T(np.stack([f[1] for f in flats])),
        fq=T(np.stack([f[2] for f in flats])),
        fa=T(np.stack([f[3] for f in flats])),
        n_pad=n_pad * scale, tile=128 * scale, n_q=2, n_segs=3)


# ---------------------------------------------------------------------------
# the rank_features tile pipeline's cases (csrc/tiles.cuh FeaturePolicy;
# ops/sparse.py ``sparse_tiles_mirror``): features whose docs ascend
# through their blocks, at a small tile on the CPU and, scaled, at the
# card's 8,192
# ---------------------------------------------------------------------------

def feature_postings(rng, n_docs: int, n_feats: int, rare: float,
                     flat: bool = False, shuffled: int = 0):
    """(block_docs [NB, 128] int32, block_weights [NB, 128] f32, feature ->
    its block ids): each feature's docs ascend through its blocks, -1 pads
    the last one and ~5 % of positions (holes); a share ``rare`` of the
    features hold a few hundred docs spread over the whole range (their
    blocks span many tiles), the others a dense run of a narrow range.
    Weights uniform in [0.05, 3), or all 1 with ``flat``. The first
    ``shuffled`` blocks of the rare features have their docs out of order
    (the kernels then read such a block whole in every tile)."""
    blocks, weights, of_feat = [], [], []
    left = shuffled
    for _ in range(n_feats):
        is_rare = rng.random() < rare
        if is_rare:
            docs = np.sort(rng.choice(n_docs, int(rng.integers(60, 300)),
                                      replace=False))
        else:
            width = int(rng.integers(100, max(101, n_docs // 4)))
            start = int(rng.integers(0, n_docs - width))
            df = int(rng.integers(20, min(width, 600)))
            docs = np.sort(rng.choice(width, df, replace=False)) + start
        ids = []
        for i in range(0, len(docs), 128):
            part = docs[i: i + 128]
            row = np.full(128, -1, np.int32)
            row[: len(part)] = part
            row[rng.random(128) < 0.05] = -1
            if is_rare and left > 0 and len(part) > 8:
                row[: len(part)] = rng.permutation(row[: len(part)])
                left -= 1
            w = np.where(row >= 0, 1.0 if flat else
                         rng.uniform(0.05, 3.0, 128), 0.0).astype(np.float32)
            ids.append(len(blocks))
            blocks.append(row)
            weights.append(w)
        of_feat.append(ids)
    return np.stack(blocks), np.stack(weights), of_feat


def feature_lists(rng, of_feat, n_q: int, q_pad: int, feats_per_q: int,
                  skip_rows=(), flat: bool = False):
    """[q_pad, QB] block lists and query weights as ``pad_query_rows``
    lays them: each real query's blocks of ``feats_per_q`` features, block
    0 / weight 0 past them, whole weight-0 rows past n_q and for
    ``skip_rows``; QB a power of two. Query weights in [0.1, 3), or 2."""
    per = []
    for qi in range(n_q):
        idx, w = [], []
        if qi not in skip_rows:
            for feat in rng.choice(len(of_feat), feats_per_q, replace=False):
                weight = 2.0 if flat else float(rng.uniform(0.1, 3.0))
                idx += of_feat[feat]
                w += [weight] * len(of_feat[feat])
        per.append((idx, w))
    qb = next_pow2(max(max(len(i) for i, _ in per), 1), minimum=8)
    bi = np.zeros((q_pad, qb), np.int32)
    bq = np.zeros((q_pad, qb), np.float32)
    for qi, (idx, w) in enumerate(per):
        bi[qi, : len(idx)] = idx
        bq[qi, : len(w)] = w
    return bi, bq


# name -> (seed, n_docs, n_pad, tile, n_q, q_pad, k, k', features a query,
# share of rare features, dead share, rows with no entries, tied weights,
# blocks out of order)
SPARSE_TILE_CASES = {
    "spanning_blocks": (31, 3000, 4096, 64, 4, 4, 10, 64, 6, 0.7, 0.05, (),
                        False, 0),
    "empty_rows": (32, 2000, 2048, 128, 6, 8, 10, 96, 3, 0.3, 0.05, (2, 4),
                   False, 0),
    "fill_in_untouched_tiles": (33, 2000, 2048, 64, 3, 4, 700, 700, 1, 1.0,
                                0.3, (), False, 0),
    "k_above_4096": (34, 12000, 16384, 1024, 2, 2, 5000, 4096, 30, 0.2,
                     0.05, (), False, 0),
    "kprime_4096_reruns": (35, 9000, 16384, 512, 2, 2, 4096, 4096, 12, 0.1,
                           0.0, (), False, 0),
    "mid_k_reruns": (36, 6000, 8192, 256, 4, 4, 200, 300, 4, 0.0, 0.0, (),
                     False, 0),
    "dead_docs_and_padding_rows": (37, 2500, 4096, 128, 3, 8, 50, 128, 4,
                                   0.4, 0.5, (), False, 0),
    "ragged_last_tile": (38, 1900, 2000, 256, 3, 4, 40, 100, 4, 0.4, 0.05,
                         (), False, 0),
    "ties_across_tiles": (39, 3000, 4096, 128, 3, 4, 20, 200, 1, 0.0, 0.1,
                          (), True, 0),
    "blocks_out_of_order": (40, 3000, 4096, 64, 3, 4, 10, 64, 5, 0.8, 0.05,
                            (), False, 1000),
}


def sparse_tile_case(name: str, scale: int = 1):
    """One case as CPU tensors: block store, [q_pad, QB] lists, live mask;
    ``scale`` spreads every doc id d to d * scale over n_pad * scale docs
    (scale CARD_TILE // tile puts the case's tiles on the card's)."""
    (seed, n_docs, n_pad, tile, n_q, q_pad, k, kp, per_q, rare, dead, skip,
     flat, shuffled) = SPARSE_TILE_CASES[name]
    rng = np.random.default_rng(seed)
    bd, bw, of_feat = feature_postings(rng, n_docs, 60, rare, flat, shuffled)
    bi, bq = feature_lists(rng, of_feat, n_q, q_pad, per_q, skip, flat)
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) >= dead
    if scale > 1:
        bd = np.where(bd >= 0, bd * scale, -1).astype(np.int32)
        big = np.zeros(n_pad * scale, bool)
        big[::scale] = live
        live, n_pad = big, n_pad * scale
    T = torch.as_tensor
    return dict(bd=T(bd), bw=T(bw), bi=T(bi), bq=T(bq), live=T(live),
                n_pad=n_pad, tile=tile * scale, n_q=q_pad, n_real=n_q,
                k=min(k, n_pad), kp=min(kp, n_pad))


def sparse_tile_slots(seed: int = 41, scale: int = 1, n_slots: int = 4,
                      dp: int = 2):
    """A stack of n_slots feature stores (the last one empty) for the
    mesh's rows 38 and 34: block stores [S, 512, 128], live [S, 4096 *
    scale], lists [S, DP, 2, QB] (row 38) whose dp row 0 also serves row
    34; tile 128 * scale."""
    n_pad, n_docs = 4096, 3000
    rng = np.random.default_rng(seed)
    bd = np.full((n_slots, 512, 128), -1, np.int32)
    bw = np.zeros((n_slots, 512, 128), np.float32)
    live = np.zeros((n_slots, n_pad * scale), bool)
    lists = []
    for slot in range(n_slots):
        d, w, of_feat = feature_postings(rng, n_docs, 40, 0.4)
        if slot < n_slots - 1:
            bd[slot, : len(d)] = np.where(d >= 0, d * scale, -1)
            bw[slot, : len(w)] = w
        lists.append([feature_lists(rng, of_feat, 2, 2, 4)
                      for _ in range(dp)])
        lv = rng.random(n_docs) >= 0.1
        live[slot, : n_docs * scale: scale] = lv
    qb = max(x[0].shape[1] for row in lists for x in row)
    bi = np.zeros((n_slots, dp, 2, qb), np.int32)
    bq = np.zeros((n_slots, dp, 2, qb), np.float32)
    for s, row in enumerate(lists):
        for r, (i, w) in enumerate(row):
            bi[s, r, :, : i.shape[1]] = i
            bq[s, r, :, : w.shape[1]] = w
    T = torch.as_tensor
    return dict(bd=T(bd), bw=T(bw), bi=T(bi), bq=T(bq), live=T(live),
                n_pad=n_pad * scale, tile=128 * scale, n_q=2)


# ---------------------------------------------------------------------------
# the dense row of the tile pipeline (csrc/tiles.cuh section 5: K8 under
# Bm25Policy, K19 under FeaturePolicy; ops/bm25.py ``bm25_dense_mirror``,
# ops/sparse.py ``sparse_dense_mirror``): one query's blocks over one
# store, at a small tile on the CPU and, scaled, at the card's 8,192
# ---------------------------------------------------------------------------

def dense_postings(rng, n_docs: int, n_terms: int, rare: float,
                   shuffled: int = 0):
    """(block_docs [NB, 128] int32, tfs [NB, 128] f32, feature weights
    [NB, 128] f32, term -> its block ids): each term's docs ascend through
    its blocks, -1 pads the last one and ~5 % of positions (holes); a share
    ``rare`` of the terms hold up to a few hundred docs spread over the
    whole range (their blocks span many tiles), the others a run of a
    narrow range. The first ``shuffled`` blocks of the rare terms have
    their docs out of order."""
    blocks, of_term = [], []
    left = shuffled
    narrow = min(100, n_docs)
    for _ in range(n_terms):
        is_rare = rng.random() < rare
        if is_rare:
            df = int(rng.integers(2, min(300, n_docs) + 1))
            docs = np.sort(rng.choice(n_docs, df, replace=False))
        else:
            width = int(rng.integers(narrow, max(narrow + 1, n_docs // 4)))
            start = int(rng.integers(0, n_docs - width + 1))
            df = int(rng.integers(1, min(width, 600) + 1))
            docs = np.sort(rng.choice(width, df, replace=False)) + start
        ids = []
        for i in range(0, len(docs), 128):
            part = docs[i: i + 128]
            row = np.full(128, -1, np.int32)
            row[: len(part)] = part
            row[rng.random(128) < 0.05] = -1
            if is_rare and left > 0 and len(part) > 8:
                row[: len(part)] = rng.permutation(row[: len(part)])
                left -= 1
            ids.append(len(blocks))
            blocks.append(row)
        of_term.append(ids)
    bd = np.stack(blocks)
    tfs = np.where(bd >= 0, rng.integers(1, 7, bd.shape), 0).astype(
        np.float32)
    fw = np.where(bd >= 0, rng.uniform(0.05, 3.0, bd.shape), 0.0).astype(
        np.float32)
    return bd, tfs, fw, of_term


# name -> (seed, n_docs, n_pad, tile, terms in the query, share of rare
# terms, dead share, blocks out of order, what else)
DENSE_TILE_CASES = {
    "spanning_blocks": (51, 3000, 4096, 64, 6, 0.7, 0.05, 0, None),
    "crowded_tiles": (52, 3000, 4096, 1024, 40, 0.0, 0.05, 0, None),
    "all_padding": (53, 3000, 4096, 64, 0, 0.5, 0.05, 0, None),
    "repeated_term": (54, 3000, 4096, 128, 4, 0.5, 0.05, 0, "repeat"),
    "block_spanning_most_tiles": (55, 3000, 4096, 64, 3, 0.3, 0.05, 0,
                                  "wide"),
    "blocks_out_of_order": (56, 3000, 4096, 64, 5, 0.9, 0.05, 1000, None),
    "ragged_last_tile": (57, 1900, 2000, 256, 4, 0.4, 0.05, 0, None),
    "below_one_tile": (58, 90, 100, 128, 3, 0.5, 0.2, 0, None),
    "dead_docs_and_padding": (59, 2500, 4096, 128, 4, 0.4, 0.5, 0, "pad"),
}


def dense_tile_case(name: str, scale: int = 1):
    """One case as CPU tensors: a block store (``bd``, tfs ``bt``, feature
    weights ``bw``), one query's [QB] list (``bi``, weights ``w``) padded
    as ``gather_query_blocks`` pads (block 0, weight 0; "pad" also
    interleaves padding entries), doc lengths ``dl``, ``live`` and
    ``avgdl``. "repeat" lists a term's blocks twice; "wide" adds a block
    whose 128 docs spread over the whole range. ``scale`` spreads every doc
    id d to d * scale over n_pad * scale docs (scale CARD_TILE // tile puts
    the case's tiles on the card's)."""
    (seed, n_docs, n_pad, tile, n_terms, rare, dead, shuffled,
     extra) = DENSE_TILE_CASES[name]
    rng = np.random.default_rng(seed)
    bd, bt, bw, of_term = dense_postings(rng, n_docs, max(n_terms, 8) * 3,
                                         rare, shuffled)
    idx, w = [], []
    terms = rng.choice(len(of_term), n_terms, replace=False)
    for term in terms:
        weight = float(rng.uniform(0.2, 9.0))
        idx += of_term[term]
        w += [weight] * len(of_term[term])
        if extra == "pad":
            idx.append(0)
            w.append(0.0)
    if extra == "repeat":
        first = len(of_term[terms[0]])
        idx += idx[:first]
        w += w[:first]
    if extra == "wide":
        row = np.sort(rng.choice(n_docs, 128, replace=False)).astype(np.int32)
        bd = np.concatenate([bd, row[None]])
        bt = np.concatenate([bt, rng.integers(1, 7, (1, 128)).astype(
            np.float32)])
        bw = np.concatenate([bw, rng.uniform(0.05, 3.0, (1, 128)).astype(
            np.float32)])
        idx.append(len(bd) - 1)
        w.append(float(rng.uniform(0.2, 9.0)))
    qb = next_pow2(max(len(idx), 1), minimum=8)
    bi = np.zeros(qb, np.int32)
    bq = np.zeros(qb, np.float32)
    bi[: len(idx)] = idx
    bq[: len(w)] = w
    dl = np.zeros(n_pad, np.float32)
    dl[:n_docs] = rng.integers(16, 97, n_docs)
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) >= dead
    avgdl = float(rng.uniform(40.0, 60.0))
    if scale > 1:
        bd = np.where(bd >= 0, bd * scale, -1).astype(np.int32)
        dl2 = np.zeros(n_pad * scale, np.float32)
        live2 = np.zeros(n_pad * scale, bool)
        dl2[::scale] = dl
        live2[::scale] = live
        dl, live, n_pad = dl2, live2, n_pad * scale
    T = torch.as_tensor
    return dict(bd=T(bd), bt=T(bt), bw=T(bw), bi=T(bi), w=T(bq), dl=T(dl),
                live=T(live), avgdl=avgdl, n_pad=n_pad, tile=tile * scale)


# ---------------------------------------------------------------------------
# histogram aggregations (K21 / K23): the exact-bucket rule's edges
# ---------------------------------------------------------------------------

HIST_CASES = ("abs_sum_under_2p24", "abs_sum_at_2p24", "abs_sum_over_2p24",
              "negatives", "at_2p24_minus_1", "constant_no_data_bucket",
              "interval_0_plan", "drops", "padding_rows", "wide_buckets",
              "p64")


def _fill(rng, rows, parts):
    """``rows`` slots holding each (value, count) of ``parts`` in a random
    order."""
    vals = np.concatenate([np.full(c, v, np.int64) for v, c in parts])
    assert len(vals) <= rows
    out = np.zeros(rows, np.int64)
    out[: len(vals)] = vals
    return out[rng.permutation(rows)]


def hist_case(name: str, scale: int = 1):
    """One histogram case as numpy arrays: (values [N] int32, exists [N]
    bool, masks [P, N] bool, bases [P] int32, intervals [P] int32,
    n_buckets). Bucket 0 of plan 0 sits at a named edge of the
    exact-bucket rule (a bucket whose |v| sum is at most 2^24 has an exact
    integer sum): just under, at and just over 2^24; the other cases are
    negatives, values at +-(2^24 - 1), a -9999 no-data bucket of 10 % of
    the rows (past 2^24 after 1,678 of them), an interval-0 plan, buckets
    dropped at both ends, padding rows (exists false, value 0), more than
    12,288 buckets and 64 plans. ``scale`` multiplies the row count."""
    rng = np.random.default_rng(1800 + HIST_CASES.index(name))
    n = 20_000 * scale
    nb = 64
    p_count = 64 if name == "p64" else 3
    exists = np.ones(n, bool)
    bases = np.zeros(p_count, np.int64)
    intervals = np.full(p_count, 1000, np.int64)
    if name.startswith("abs_sum"):
        # bucket 0 of interval 2048: 16,777 rows of 1,000 and one of 215 /
        # 216 / 217 (|v| sums 2^24 - 1, 2^24, 2^24 + 1), the rest of the
        # rows in higher buckets
        last = {"abs_sum_under_2p24": 215, "abs_sum_at_2p24": 216,
                "abs_sum_over_2p24": 217}[name]
        values = _fill(rng, n, [(1000, 16_777), (last, 1)])
        values[values == 0] = rng.integers(2048, 2048 * 40,
                                           int((values == 0).sum()))
        intervals[:] = 2048
    elif name == "negatives":
        values = rng.integers(-(1 << 23), 1 << 23, n)
        intervals[:] = (1 << 24) // 32
        bases[:] = -16
    elif name == "at_2p24_minus_1":
        top = (1 << 24) - 1
        values = _fill(rng, n, [(top, 3), (-top, 2), (top - 1, 4), (7, 9)])
        values[values == 0] = rng.integers(-top, top, int((values == 0).sum()))
        intervals[:] = 1 << 20
        bases[:] = -16
        nb = 32
    elif name == "constant_no_data_bucket":
        values = np.minimum(rng.exponential(400.0, n), 8848).astype(np.int64)
        values[rng.random(n) < 0.1] = -9999
        intervals[:] = 100
        bases[:] = -100
        nb = 256
    elif name == "interval_0_plan":
        values = rng.integers(-5000, 5000, n)
        bases[:] = -5
        intervals[1] = 0
    elif name == "drops":
        values = rng.integers(-(1 << 22), 1 << 22, n)
        intervals[:] = 1 << 15
        bases[:] = -20        # buckets -128 .. 127 of which 0 .. 63 count
    elif name == "padding_rows":
        values = rng.integers(0, 1 << 23, n)
        pad = n - n // 7
        exists[pad:] = False
        values[pad:] = 0
        intervals[:] = 1 << 17
    elif name == "wide_buckets":
        values = rng.integers(0, 1 << 23, n)
        intervals[:] = 500
        nb = 20_000
    else:                     # p64: plans of mixed intervals and masks
        values = rng.integers(-9999, 1 << 23, n)
        values[rng.random(n) < 0.1] = -9999
        intervals[:] = rng.integers(1 << 12, 1 << 18, p_count)
        intervals[0] = (1 << 24) // (nb - 2)
        bases[:] = -9999 // intervals
    masks = rng.random((p_count, n)) < rng.uniform(0.05, 1.0, (p_count, 1))
    masks[0] = True
    return (values.astype(np.int32), exists, masks, bases.astype(np.int32),
            intervals.astype(np.int32), nb)
