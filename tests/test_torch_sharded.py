"""The sharded data plane of elasticsearch_tpu_torch against the JAX package.

``parallel/sharded_search.py``'s five programs (rows 40-44) and its three
indexes, on the same seeded inputs in both packages; the JAX programs run
as shard_maps over ``tests/conftest.py``'s 8 virtual CPU devices in (dp,
shard) layouts (4, 2), (8, 1), (2, 1) and (4, 1), the port's plain
versions on the CPU over the same slot layout:

- the reference's own identities (``tests/test_parallel.py``'s 11 tests)
  on the port, the cases that repeat each other merged into parametrised
  ones;
- each row's plain version against its ``make_sharded_*`` program:
  the three similarities, k past n_per_shard, a batch that does not
  divide dp, slots without docs, -1 ids in the fusion;
- the indexes' packed arrays, bitwise the reference's, on corpora with
  deletes, empty segments and a shard without the field, and the pruned
  two-phase ``search_batch``'s ``last_prune_stats`` / ``last_hits_exact``.

Tolerances: ids, hits and every count exact; where the inputs make every
intermediate exact (integer vectors of integer norm, row 44's fused
ranks) scores bitwise; BM25 and sparse scores to rtol 1e-6 (the reference
adds f32 contributions one by one, the port sums 64-bit fixed point and
rounds once: ROADMAP queue 3, item 5), Gaussian kNN scores to rtol 4e-6,
ids whose reference scores lie within the tolerance of each other compared
as a set -- but a run of exactly equal scores on both sides (duplicate
docs) must list the same ids in the same order: the tie order is part of
the answer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import elasticsearch_tpu.ops.bm25 as ref_bm25_mod
import elasticsearch_tpu.parallel.sharded_search as ref_sh
from elasticsearch_tpu.ops.bm25 import DEFAULT_B, DEFAULT_K1
from elasticsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh
import elasticsearch_tpu_torch.parallel.sharded_search as sh
from elasticsearch_tpu_torch.parallel import (
    ShardedFeaturesIndex, ShardedTextIndex, ShardedVectorIndex, make_mesh,
    make_sharded_hybrid, to_original_ids,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from test_torch_bm25 import assert_topk_match
from torch_inputs import int_norm_vectors, sharded_inputs, text_docs

RTOL = 1e-6
RTOL_GAUSS = 4e-6
LAYOUTS = [(4, 2), (8, 1), (2, 1), (4, 1)]
LAYOUT_IDS = ["4x2", "8x1", "2x1", "4x1"]


def ref_mesh(n_shards: int, n_dp: int):
    return ref_make_mesh(n_shards=n_shards, n_dp=n_dp,
                         devices=jax.devices()[: n_shards * n_dp])


def port_mesh(n_slots: int):
    """The port's layout: S slots on the CPU. It has no dp axis (its
    answers do not depend on one); the JAX side runs every layout."""
    return make_mesh(n_slots, device="cpu")


def put(mesh, x, *axes):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*axes)))


def t(x):
    return torch.as_tensor(np.asarray(x))


def assert_ties_in_order(ref_s, ref_i, got_s, got_i):
    """Where both sides hold a run of exactly equal finite scores (a tie
    the inputs make exact), the ids come in the same order."""
    ref_s, ref_i = np.atleast_2d(ref_s), np.atleast_2d(ref_i)
    got_s, got_i = np.atleast_2d(got_s), np.atleast_2d(got_i)
    for r in range(ref_s.shape[0]):
        k = ref_s.shape[1]
        i = 0
        while i < k:
            j = i + 1
            while j < k and np.isfinite(ref_s[r, i]) and \
                    ref_s[r, j] == ref_s[r, i]:
                j += 1
            if j - i > 1 and j < k and np.all(got_s[r, i:j] == got_s[r, i]):
                np.testing.assert_array_equal(got_i[r, i:j], ref_i[r, i:j])
            i = j


def assert_same_answer(ref_s, ref_i, got_s, got_i, rtol=RTOL):
    ref_s, ref_i = np.atleast_2d(ref_s), np.atleast_2d(ref_i)
    got_s, got_i = np.atleast_2d(got_s), np.atleast_2d(got_i)
    assert_topk_match(ref_s, ref_i, got_s, got_i, rtol=rtol)
    assert_ties_in_order(ref_s, ref_i, got_s, got_i)


# ---------------------------------------------------------------------------
# the reference's identities (tests/test_parallel.py) on the port
# ---------------------------------------------------------------------------

def test_mesh_shapes():
    """The reference's layouts and the port's: the port lays a JAX mesh's
    shard axis as its slots on one device, and refuses a layout without
    slots as the reference refuses one that does not cover its devices."""
    for n_shards, n_dp in LAYOUTS:
        ref = ref_mesh(n_shards, n_dp)
        mesh = port_mesh(ref.shape["shard"])
        assert (mesh.n_slots, mesh.device) == (n_shards, torch.device("cpu"))
    with pytest.raises(ValueError):
        ref_make_mesh(n_shards=3, n_dp=3, devices=jax.devices()[:8])
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    assert make_mesh(4).device == torch.device("cuda")


def _knn_oracle(rng):
    mesh = port_mesh(4)
    vectors = rng.normal(size=(1000, 16)).astype(np.float32)
    idx = ShardedVectorIndex(mesh, vectors, "cosine")
    queries = rng.normal(size=(8, 16)).astype(np.float32)
    scores, ids = idx.search(queries, k=10)
    for bi in range(8):
        sims = vectors @ queries[bi] / (
            np.linalg.norm(vectors, axis=1) * np.linalg.norm(queries[bi])
            + 1e-30)
        oracle = np.argsort(-(1 + sims) / 2)[:10]
        assert len(set(ids[bi].tolist()) & set(oracle.tolist())) >= 8


def _knn_dot_product(rng):
    mesh = port_mesh(8)
    vectors = rng.normal(size=(64, 8)).astype(np.float32)
    vectors[17] *= 10.0
    idx = ShardedVectorIndex(mesh, vectors, "dot_product")
    _scores, ids = idx.search(vectors[17:18], k=5)
    assert ids[0][0] == 17


def _knn_batch_not_divisible_by_dp(rng):
    # the reference's dp-2 case; the port's layout has no dp axis, so a
    # one-query batch is its own case here
    mesh = port_mesh(4)
    vectors = rng.normal(size=(100, 8)).astype(np.float32)
    idx = ShardedVectorIndex(mesh, vectors, "cosine")
    scores, ids = idx.search(vectors[42:43], k=5)
    assert scores.shape == (1, 5) and ids.shape == (1, 5)
    assert 42 in ids[0].tolist()


def _knn_l2_norm(rng):
    mesh = port_mesh(8)
    vectors = rng.normal(size=(64, 8)).astype(np.float32)
    idx = ShardedVectorIndex(mesh, vectors, "l2_norm")
    scores, ids = idx.search(vectors[9:10], k=3)
    assert ids[0][0] == 9
    assert np.isclose(scores[0][0], 1.0, atol=1e-2)


def _knn_k_exceeds_per_shard(rng):
    mesh = port_mesh(4)
    vectors = rng.normal(size=(100, 8)).astype(np.float32)
    idx = ShardedVectorIndex(mesh, vectors, "cosine")
    scores, ids = idx.search(vectors[7:8], k=40)
    ids, scores = ids[0], scores[0]
    assert ids.shape == (40,) and ids[0] == 7
    finite = ids[np.isfinite(scores)]
    assert finite.min() >= 0
    assert len(set(finite.tolist())) == len(finite)


KNN_IDENTITIES = {
    "matches_oracle": _knn_oracle, "dot_product": _knn_dot_product,
    "batch_not_divisible_by_dp": _knn_batch_not_divisible_by_dp,
    "l2_norm": _knn_l2_norm, "k_exceeds_per_shard": _knn_k_exceeds_per_shard,
}


@pytest.mark.parametrize("case", sorted(KNN_IDENTITIES))
def test_sharded_knn_identities(case, rng):
    """test_parallel.py's five kNN tests on the port."""
    KNN_IDENTITIES[case](rng)


def bm25_oracle(docs_terms, query_terms, k1=DEFAULT_K1, b=DEFAULT_B):
    n = len(docs_terms)
    dls = np.array([len(d) for d in docs_terms], float)
    avgdl = dls.sum() / n
    scores = np.zeros(n)
    for term in set(query_terms):
        df = sum(1 for d in docs_terms if term in d)
        if df == 0:
            continue
        w = np.log(1 + (n - df + 0.5) / (df + 0.5))
        for i, d in enumerate(docs_terms):
            tf = d.count(term)
            if tf:
                scores[i] += w * tf * (k1 + 1) / (
                    tf + k1 * (1 - b + b * dls[i] / avgdl))
    return scores


def _bm25_oracle(rng):
    docs_terms = [[f"t{rng.integers(0, 40)}"
                   for _ in range(rng.integers(3, 15))] for _ in range(500)]
    idx = ShardedTextIndex(port_mesh(4), docs_terms)
    query = ["t1", "t5", "t22"]
    scores, ids = idx.search(query, k=10)
    oracle = bm25_oracle(docs_terms, query)
    oracle_top = np.argsort(-oracle)[:10]
    got = [g for g in ids if g < len(docs_terms)]
    assert len(set(got) & set(oracle_top.tolist())) >= 8
    np.testing.assert_allclose(scores[0], oracle[oracle_top[0]], rtol=1e-4)


def _bm25_global_idf(rng):
    docs = [["common"] for _ in range(400)]
    docs[0] = ["common", "rare"]
    idx = ShardedTextIndex(port_mesh(4), docs)
    scores, ids = idx.search(["rare"], k=3)
    assert ids[0] == 0
    expected_idf = np.log(1 + (400 - 1 + 0.5) / (1 + 0.5))
    avgdl = (400 + 1) / 400
    k1, b = DEFAULT_K1, DEFAULT_B
    expected = expected_idf * (k1 + 1) / (1 + k1 * (1 - b + b * 2.0 / avgdl))
    assert scores[0] == pytest.approx(expected, rel=1e-4)


@pytest.mark.parametrize("case", ["matches_oracle", "global_idf"])
def test_sharded_bm25_identities(case, rng):
    """test_parallel.py's two single-query BM25 tests on the port."""
    {"matches_oracle": _bm25_oracle, "global_idf": _bm25_global_idf}[case](
        rng)


def _hybrid_rrf(rng):
    mesh = port_mesh(4)
    docs_terms = [["alpha", "alpha"] if i == 3 else
                  (["alpha"] if i % 3 == 0 else ["beta"]) for i in range(200)]
    text = ShardedTextIndex(mesh, docs_terms)
    vectors = rng.normal(size=(200, 8)).astype(np.float32)
    vec = ShardedVectorIndex(mesh, vectors, "cosine",
                             n_per_shard=text.n_per_shard)
    assert text.n_per_shard == vec.n_per_shard
    k = 10
    fn = make_sharded_hybrid(k)
    bidx, bw = text.prep_query(["alpha"])
    scores, ids = fn(text.block_docs, text.block_tfs, text.doc_lens,
                     text.avgdl, t(bidx), t(bw), vec.matrix, vec.norms,
                     vec.valid, t(vectors[3]))
    ids = to_original_ids(ids.numpy(), 4, text.n_per_shard)
    scores = scores.numpy()
    assert ids[0] == 3 and scores[0] > scores[1]
    valid = ids[scores > -np.inf]
    assert len(set(valid.tolist())) == len(valid)


def _hybrid_l2_phantoms(rng):
    mesh = port_mesh(4)
    docs_terms = [["rare"] if i in (5, 40) else ["common"] for i in range(64)]
    text = ShardedTextIndex(mesh, docs_terms)
    vectors = rng.normal(size=(64, 8)).astype(np.float32)
    vectors[40] = -8.0 * vectors[5]
    vec = ShardedVectorIndex(mesh, vectors, "l2_norm",
                             n_per_shard=text.n_per_shard)
    fn = make_sharded_hybrid(10, similarity="l2_norm")
    bidx, bw = text.prep_query(["rare"])
    scores, ids = fn(text.block_docs, text.block_tfs, text.doc_lens,
                     text.avgdl, t(bidx), t(bw), vec.matrix, vec.norms,
                     vec.valid, t(vectors[5]))
    ids = to_original_ids(ids.numpy(), 4, text.n_per_shard)
    finite = ids[np.isfinite(scores.numpy())]
    assert finite.min() >= 0 and finite.max() < 64
    assert ids[0] == 5


@pytest.mark.parametrize("case", ["rrf", "l2_and_phantom_masking"])
def test_sharded_hybrid_identities(case, rng):
    """test_parallel.py's two hybrid tests on the port."""
    {"rrf": _hybrid_rrf, "l2_and_phantom_masking": _hybrid_l2_phantoms}[
        case](rng)


def test_sharded_bm25_batch_pruned_parity(rng, monkeypatch):
    """test_parallel.py's pruned-batch test on the port: pruning is early
    termination, never approximation, and the single-query program
    agrees."""
    docs_terms = [[f"t{min(int(rng.zipf(1.3)) - 1, 499)}"
                   for _ in range(int(rng.integers(3, 12)))]
                  for _ in range(40000)]
    idx = ShardedTextIndex(port_mesh(4), docs_terms)
    queries = [["t0", "t300", "t400"], ["t0", "t1"], ["t480"],
               ["t5", "t200"]]
    ps, _pids = idx.search_batch(queries, k=10, prune=True)
    us, _uids = idx.search_batch(queries, k=10, prune=False)
    np.testing.assert_allclose(ps, us, rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(sh, "P1_BUCKET", 8)
    idx.search_batch([["t0", "t300", "t400"]], k=10, prune=True)
    total, scored = idx.last_prune_stats
    assert scored < total
    for q, terms in enumerate(queries):
        ss, _sids = idx.search(terms, k=10)
        np.testing.assert_allclose(ps[q], ss, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# each row's plain version against its make_sharded_* program
# ---------------------------------------------------------------------------

def _knn_ref(inp, mesh, k, sim, queries):
    fn = ref_sh.make_sharded_knn(mesh, inp["n_per_shard"],
                                 queries.shape[1], k, sim)
    s, i = fn(put(mesh, inp["matrix"], "shard", None, None),
              put(mesh, inp["norms"], "shard", None),
              put(mesh, inp["valid"], "shard", None),
              put(mesh, queries, "dp", None))
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_row40_knn_matches_the_program(layout, sim, kind):
    """Row 40 at k 10 and at k past n_per_shard: integer vectors of
    integer norm give every intermediate exact, so scores are bitwise and
    the ids equal, ties (duplicate rows) in the program's order; Gaussian
    ones hold scores to rtol 4e-6."""
    n_shards, dp = layout
    inp = sharded_inputs(40, n_shards, n_docs=300, kind=kind, n_q=2 * dp)
    mesh = ref_mesh(n_shards, dp)
    for k in (10, inp["n_per_shard"] + 7):
        want_s, want_i = _knn_ref(inp, mesh, k, sim, inp["queries"])
        got_s, got_i = sh.sharded_knn_plain(
            t(inp["matrix"]), t(inp["norms"]), t(inp["valid"]),
            t(inp["queries"]), t(inp["qn"]), t(inp["q2"]), k, sim)
        if kind == "int":
            np.testing.assert_array_equal(got_s.numpy(), want_s)
            np.testing.assert_array_equal(got_i.numpy(), want_i)
        else:
            assert_same_answer(want_s, want_i, got_s, got_i, RTOL_GAUSS)


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_row41_bm25_matches_the_program(layout):
    """Row 41 per query (the k past n_per_shard case pads with (-inf,
    -1)): scores to rtol 1e-6, duplicate docs' ties in the program's
    order."""
    n_shards, dp = layout
    inp = sharded_inputs(41, n_shards, n_docs=500)
    mesh = ref_mesh(n_shards, dp)
    for k in (10, inp["n_per_shard"] + 3):
        fn = ref_sh.make_sharded_bm25(mesh, inp["n_per_shard"], k)
        for q in range(inp["bm25_idx"].shape[1]):
            want_s, want_i = fn(
                put(mesh, inp["block_docs"], "shard", None, None),
                put(mesh, inp["block_tfs"], "shard", None, None),
                put(mesh, inp["doc_lens"], "shard", None),
                jnp.float32(inp["avgdl"]),
                put(mesh, inp["bm25_idx"][:, q], "shard", None),
                put(mesh, inp["bm25_w"][:, q], "shard", None))
            got_s, got_i = sh.sharded_bm25_plain(
                t(inp["block_docs"]), t(inp["block_tfs"]),
                t(inp["doc_lens"]), inp["avgdl"],
                t(np.ascontiguousarray(inp["bm25_idx"][:, q])),
                t(np.ascontiguousarray(inp["bm25_w"][:, q])), k)
            assert_same_answer(want_s, want_i, got_s, got_i)


@pytest.mark.parametrize("counted", [False, True],
                         ids=["uncounted", "counted"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_row42_bm25_batch_matches_the_program(layout, counted):
    """Row 42: original ids, ties (duplicate docs) by ascending original
    id as the program's two-key sort gives them, hits exact."""
    n_shards, dp = layout
    inp = sharded_inputs(42, n_shards, n_docs=700, n_q=5)
    mesh = ref_mesh(n_shards, dp)
    k = 12
    fn = ref_sh.make_sharded_bm25_batch(mesh, inp["n_per_shard"], k,
                                        counted=counted)
    want = fn(put(mesh, inp["block_docs"], "shard", None, None),
              put(mesh, inp["block_tfs"], "shard", None, None),
              put(mesh, inp["doc_lens"], "shard", None),
              jnp.float32(inp["avgdl"]),
              put(mesh, inp["bm25_idx"], "shard", None, None),
              put(mesh, inp["bm25_w"], "shard", None, None))
    got = sh.sharded_bm25_batch_plain(
        t(inp["block_docs"]), t(inp["block_tfs"]), t(inp["doc_lens"]),
        inp["avgdl"], t(inp["bm25_idx"]), t(inp["bm25_w"]), k,
        counted=counted)
    assert_same_answer(want[0], want[1], got[0], got[1])
    if counted:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_row43_sparse_matches_the_program(layout):
    """Row 43 at k 10 and past n_per_shard, padding entries in the block
    lists: scores to rtol 1e-6, ties in the program's order."""
    n_shards, dp = layout
    inp = sharded_inputs(43, n_shards, n_docs=500)
    mesh = ref_mesh(n_shards, dp)
    for k in (10, inp["n_per_shard"] + 5):
        fn = ref_sh.make_sharded_sparse(mesh, inp["n_per_shard"], k)
        want_s, want_i = fn(
            put(mesh, inp["block_docs"], "shard", None, None),
            put(mesh, inp["block_weights"], "shard", None, None),
            put(mesh, inp["sparse_idx"], "shard", None),
            put(mesh, inp["sparse_w"], "shard", None))
        got_s, got_i = sh.sharded_sparse_plain(
            t(inp["block_docs"]), t(inp["block_weights"]),
            t(inp["sparse_idx"]), t(inp["sparse_w"]), inp["n_per_shard"], k)
        assert_same_answer(want_s, want_i, got_s, got_i)


@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("case", ["overlap", "few_matches"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_row44_hybrid_matches_the_program(layout, case, sim):
    """Row 44: the fused ids equal and the fused scores bitwise (each a
    sum of at most two rank terms); ``few_matches`` leaves most of the
    BM25 branch at -1, ``overlap`` queries with a matching doc's own
    vector so both branches list it."""
    n_shards, dp = layout
    inp = sharded_inputs(44, n_shards, n_docs=400)
    mesh = ref_mesh(n_shards, dp)
    k = 10
    idx, w = inp["bm25_idx"][:, 0], inp["bm25_w"][:, 0]
    if case == "few_matches":
        # one entry: the block holding the fewest docs
        fill = (inp["block_docs"] >= 0).sum(axis=2)
        fill[fill == 0] = 1 << 30
        s_min, b_min = np.unravel_index(np.argmin(fill), fill.shape)
        idx, w = np.zeros_like(idx), np.zeros_like(w)
        idx[s_min, 0], w[s_min, 0] = b_min, 1.5
    bm25 = sh.sharded_bm25_plain(
        t(inp["block_docs"]), t(inp["block_tfs"]), t(inp["doc_lens"]),
        inp["avgdl"], t(np.ascontiguousarray(idx)),
        t(np.ascontiguousarray(w)), k)
    top = int(bm25[1][0])
    qvec = inp["matrix"].reshape(-1, inp["matrix"].shape[2])[top]
    fn = ref_sh.make_sharded_hybrid(mesh, inp["n_per_shard"], k,
                                    similarity=sim)
    want_s, want_i = fn(put(mesh, inp["block_docs"], "shard", None, None),
                        put(mesh, inp["block_tfs"], "shard", None, None),
                        put(mesh, inp["doc_lens"], "shard", None),
                        jnp.float32(inp["avgdl"]),
                        put(mesh, idx, "shard", None),
                        put(mesh, w, "shard", None),
                        put(mesh, inp["matrix"], "shard", None, None),
                        put(mesh, inp["norms"], "shard", None),
                        put(mesh, inp["valid"], "shard", None),
                        jnp.asarray(qvec))
    qn, q2 = sh.query_norms(qvec[None])
    got_s, got_i = sh.sharded_hybrid_plain(
        t(inp["block_docs"]), t(inp["block_tfs"]), t(inp["doc_lens"]),
        inp["avgdl"], t(np.ascontiguousarray(idx)),
        t(np.ascontiguousarray(w)), t(inp["matrix"]), t(inp["norms"]),
        t(inp["valid"]), t(qvec), t(qn), t(q2), k, similarity=sim)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if case == "few_matches":
        assert (np.asarray(bm25[1]) == -1).any()


def test_empty_slots_and_no_match():
    """Three docs on eight slots (five slots hold nothing: one (-1, 0)
    block each), a query matching nothing (every id -1), and k past the
    whole slot space (padding)."""
    docs = [["a", "b"], ["b"], ["c", "a", "a"]]
    ref = ref_sh.ShardedTextIndex(ref_mesh(8, 1), docs)
    port = ShardedTextIndex(port_mesh(8), docs)
    np.testing.assert_array_equal(port.block_docs.numpy(),
                                  np.asarray(ref.block_docs))
    for terms in (["a"], ["zz"]):
        for k in (2, 8 * port.n_per_shard + 4):
            want = ref.search_batch([terms], k, count_hits=True)
            got = port.search_batch([terms], k, count_hits=True)
            for w_, g_ in zip(want, got):
                np.testing.assert_array_equal(g_, np.asarray(w_))
    s, i = port.search(["zz"], 4)
    assert np.all(i == -1) and np.all(np.isneginf(s))


def test_wrappers_refuse_bad_inputs_and_count_no_launch_on_cpu():
    inp = sharded_inputs(7, 2, n_docs=50)
    before = DEVICE_PROFILE.family("sharded_sparse").launches
    sh.sharded_sparse(t(inp["block_docs"]), t(inp["block_weights"]),
                      t(inp["sparse_idx"]), t(inp["sparse_w"]),
                      inp["n_per_shard"], 5)
    assert DEVICE_PROFILE.family("sharded_sparse").launches == before
    with pytest.raises(TypeError):
        sh.sharded_sparse(t(inp["block_docs"]), t(inp["block_weights"]),
                          t(inp["sparse_idx"]).long(), t(inp["sparse_w"]),
                          inp["n_per_shard"], 5)
    with pytest.raises(ValueError):
        sh.sharded_knn(t(inp["matrix"]), t(inp["norms"]), t(inp["valid"]),
                       t(inp["queries"][:, :3]), t(inp["qn"]), t(inp["q2"]),
                       5)
    with pytest.raises(ValueError):
        sh.sharded_bm25(t(inp["block_docs"]), t(inp["block_tfs"]),
                        t(inp["doc_lens"]), inp["avgdl"],
                        t(inp["bm25_idx"][:, 0]), t(inp["bm25_w"][:, 0]), 0)


# ---------------------------------------------------------------------------
# the indexes: packed arrays bitwise the reference's; the pruned batch
# ---------------------------------------------------------------------------

from elasticsearch_tpu.index import InternalEngine as RefEngine  # noqa: E402
from elasticsearch_tpu.mapping import MapperService as RefMappers  # noqa: E402,E501
from elasticsearch_tpu_torch.index import InternalEngine  # noqa: E402
from elasticsearch_tpu_torch.mapping import MapperService  # noqa: E402

MAPPING = {"properties": {"body": {"type": "text"},
                          "feats": {"type": "rank_features"}}}


def _segments(engine_cls, mappers_cls, seed: int, n_shards: int,
              no_field=()):
    """Per shard: docs of 3-12 Zipf words and 1-4 of 30 features (none
    on the shards in ``no_field``), refreshed into three segments (one of
    them empty after its docs are deleted), every 11th doc deleted."""
    readers = []
    for s in range(n_shards):
        rng = np.random.default_rng(seed + 97 * s)
        eng = engine_cls(mappers_cls(MAPPING), shard_label=f"sb{seed}_{s}")
        n = 0
        for part in (40, 6, 50):
            first = n
            for _ in range(part):
                src = {}
                if s not in no_field:
                    src["body"] = " ".join(
                        f"w{min(int(rng.zipf(1.3)) - 1, 79)}"
                        for _ in range(int(rng.integers(3, 13))))
                    src["feats"] = {
                        f"f{int(f)}": round(float(rng.uniform(0.1, 3.0)), 3)
                        for f in rng.integers(0, 30, int(rng.integers(1, 5)))}
                else:
                    src["other"] = "x"
                eng.index(str(n), src)
                n += 1
            eng.refresh()
            if part == 6:
                for d in range(first, n):
                    eng.delete(str(d))
        for d in range(0, n, 11):
            eng.delete(str(d))
        eng.refresh()
        readers.append(eng.acquire_reader())
    return readers


def _sources(readers, field: str, kind: str):
    out = []
    for reader in readers:
        for seg, live in zip(reader.segments, reader.live_masks):
            store = seg.postings if kind == "text" else seg.features
            out.append((store.get(field), live, seg.n_docs))
    return out


@pytest.mark.parametrize("n_shards", [4, 8])
def test_builds_are_the_references_bitwise(n_shards):
    """ShardedTextIndex.from_postings_sources, ShardedFeaturesIndex and
    ShardedVectorIndex pack the reference's arrays bit for bit: 3 source
    shards (one without the field) of three segments each (one emptied by
    deletes), every 11th doc deleted, onto 4 and 8 slots."""
    ref_readers = _segments(RefEngine, RefMappers, 5, 3, no_field=(1,))
    port_readers = _segments(InternalEngine, MapperService, 5, 3,
                             no_field=(1,))
    rm, pm = ref_mesh(n_shards, 1), port_mesh(n_shards)
    ref_t = ref_sh.ShardedTextIndex.from_postings_sources(
        rm, _sources(ref_readers, "body", "text"))
    got_t = ShardedTextIndex.from_postings_sources(
        pm, _sources(port_readers, "body", "text"))
    for name in ("block_docs", "block_tfs", "doc_lens"):
        np.testing.assert_array_equal(getattr(got_t, name).numpy(),
                                      np.asarray(getattr(ref_t, name)))
    assert got_t.term_index == ref_t.term_index
    assert got_t.df == ref_t.df
    assert got_t.avgdl == ref_t.avgdl
    assert got_t.n_per_shard == ref_t.n_per_shard
    assert got_t.nb_max == ref_t.block_docs.shape[1]
    np.testing.assert_array_equal(got_t._impacts, ref_t._impacts)
    ref_f = ref_sh.ShardedFeaturesIndex.from_features_sources(
        rm, _sources(ref_readers, "feats", "features"))
    got_f = ShardedFeaturesIndex.from_features_sources(
        pm, _sources(port_readers, "feats", "features"))
    for name in ("block_docs", "block_weights"):
        np.testing.assert_array_equal(getattr(got_f, name).numpy(),
                                      np.asarray(getattr(ref_f, name)))
    assert got_f.term_index == ref_f.term_index
    assert got_f.n_per_shard == ref_f.n_per_shard
    rng = np.random.default_rng(9)
    vectors = rng.standard_normal((301, 12)).astype(np.float32)
    ref_v = ref_sh.ShardedVectorIndex(ref_mesh(n_shards, 1), vectors)
    got_v = ShardedVectorIndex(pm, vectors)
    for name in ("matrix", "norms", "valid"):
        np.testing.assert_array_equal(getattr(got_v, name).numpy(),
                                      np.asarray(getattr(ref_v, name)))


def test_raw_docs_build_is_the_references_bitwise():
    docs = text_docs(3, 2500, vocab=90)
    for n_shards in (2, 8):
        ref = ref_sh.ShardedTextIndex(ref_mesh(n_shards, 1), docs)
        got = ShardedTextIndex(port_mesh(n_shards), docs)
        for name in ("block_docs", "block_tfs", "doc_lens"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        assert got.term_index == ref.term_index and got.df == ref.df
        assert got.avgdl == ref.avgdl
        np.testing.assert_array_equal(got._impacts, ref._impacts)


@pytest.mark.parametrize("count_hits", [False, True],
                         ids=["uncounted", "counted"])
@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "unpruned"])
def test_search_batch_prune_stats_are_the_references(prune, count_hits,
                                                     monkeypatch):
    """The two-phase search_batch with a test-scale phase-1 budget on both
    packages: the same answers, ``last_prune_stats`` and
    ``last_hits_exact``, and the same counts."""
    docs = text_docs(11, 6000, vocab=300, dup_every=13)
    ref = ref_sh.ShardedTextIndex(ref_mesh(4, 2), docs)
    got = ShardedTextIndex(port_mesh(4), docs)
    monkeypatch.setattr(ref_bm25_mod, "P1_BUCKET", 8)
    monkeypatch.setattr(ref_sh, "P1_BUCKET", 8)
    monkeypatch.setattr(sh, "P1_BUCKET", 8)
    for queries in ([["t0", "t120", "t250"]], [["t0", "t1"], ["t7"]],
                    [["t2", ("t40", 2.0), "t2"]]):
        want = ref.search_batch(queries, 10, prune=prune,
                                count_hits=count_hits)
        out = got.search_batch(queries, 10, prune=prune,
                               count_hits=count_hits)
        assert got.last_prune_stats == ref.last_prune_stats
        assert got.last_hits_exact == ref.last_hits_exact
        assert_same_answer(want[0], want[1], out[0], out[1])
        if count_hits:
            np.testing.assert_array_equal(out[2], np.asarray(want[2]))
        assert got.hits_upper(queries[0]) == ref.hits_upper(queries[0])


def test_features_search_batch_is_the_references():
    ref_readers = _segments(RefEngine, RefMappers, 8, 2)
    port_readers = _segments(InternalEngine, MapperService, 8, 2)
    ref = ref_sh.ShardedFeaturesIndex.from_features_sources(
        ref_mesh(8, 1), _sources(ref_readers, "feats", "features"))
    got = ShardedFeaturesIndex.from_features_sources(
        port_mesh(8), _sources(port_readers, "feats", "features"))
    expansions = [[("f1", 1.5), ("f3", 0.7), ("f8", 2.0)], [("f29", 1.0)],
                  [("nothing", 1.0)]]
    want_s, want_i = ref.search_batch(expansions, 7)
    got_s, got_i = got.search_batch(expansions, 7)
    assert_same_answer(want_s, want_i, got_s, got_i)


def test_int_norm_vectors_have_integer_norms():
    v = int_norm_vectors(np.random.default_rng(0), 200, 9)
    n = np.linalg.norm(v, axis=1)
    np.testing.assert_array_equal(n, np.round(n))


@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm"])
def test_vector_index_search_is_the_references(sim):
    """ShardedVectorIndex.search on both packages: three queries, on a
    dp-2 layout on the JAX side (padded to four there, the pad row
    dropped), k past n_per_shard;
    integer vectors of integer norm, so scores are bitwise and ids
    equal, ties in the program's order."""
    rng = np.random.default_rng(71)
    vectors = int_norm_vectors(rng, 150, 12)
    queries = int_norm_vectors(rng, 3, 12, dup=0.0)
    ref = ref_sh.ShardedVectorIndex(ref_mesh(4, 2), vectors, sim)
    got = ShardedVectorIndex(port_mesh(4), vectors, sim)
    for k in (7, got.n_per_shard + 9):
        want_s, want_i = ref.search(queries, k)
        got_s, got_i = got.search(queries, k)
        np.testing.assert_array_equal(got_s, np.asarray(want_s))
        np.testing.assert_array_equal(got_i, np.asarray(want_i))
