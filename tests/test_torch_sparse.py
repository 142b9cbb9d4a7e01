"""The four rank_features kernel families of elasticsearch_tpu_torch
(``ops/sparse.py``) against the JAX package's programs they replace.

Inputs are made from a seed with numpy and handed to both packages: the
JAX programs (``sparse_topk``, ``sparse_topk_batch``, ``sparse_scores``,
``sparse_coarse_kernel``, ``sparse_rerank_kernel``; XLA programs with no
Pallas) run jitted on the CPU, the port's wrappers run their plain PyTorch
versions on CPU tensors.

Tolerances: f32 scores to rtol 1e-6 (16 ulps). The reference adds a doc's
f32 contributions one by one in posting order, which for n positive terms
is within (n - 1) * 2^-24 of the exact sum; the port sums them exactly in
fixed point and rounds once; and XLA's CPU ``log`` / ``pow`` and torch's
may differ by an ulp or two in each contribution. The docs here carry at
most a handful of contributions per query; the largest difference seen
is 4 ulps. Ids and counts exact, except that ids whose reference scores
lie within that tolerance of each other (a tie group) are compared as a
set. The coarse tier is held to the same: both packages form the same
exact f32 products of bf16 values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.index.segment import FeaturesField as RefFeatures
from elasticsearch_tpu.ops import sparse as ref
from elasticsearch_tpu_torch.index.segment import FeaturesField
from elasticsearch_tpu_torch.ops import sparse as port
from test_torch_bm25 import assert_topk_match
from torch_inputs import make_sparse_inputs

RTOL = 1e-6
K = 10
FUNCTIONS = {"saturation": (0.7, 1.0), "log": (1.5, 1.0),
             "sigmoid": (1.2, 0.6), "linear": (1.0, 1.0)}


def jx(inp, *names):
    return [jnp.asarray(inp[n]) for n in names]


def tx(inp, *names):
    return [torch.as_tensor(inp[n]) for n in names]


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("function", sorted(FUNCTIONS))
@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_topk_batch_matches_reference(seed, function, counted):
    """K15's plain version against ``sparse_topk_batch``: all four
    functions, counted and not, with padding slots and pow2 padding
    rows."""
    inp = make_sparse_inputs(seed)
    pivot, exponent = FUNCTIONS[function]
    docs, weights, idx, qw, live = jx(inp, "docs", "weights", "idx", "qw",
                                      "live")
    want = ref.sparse_topk_batch(docs, weights, idx, qw, jnp.float32(pivot),
                                 jnp.float32(exponent), live, inp["n_pad"], K,
                                 function, counted=counted)
    got = port.sparse_topk_batch(*tx(inp, "docs", "weights", "idx", "qw"),
                                 pivot, exponent, torch.as_tensor(inp["live"]),
                                 inp["n_pad"], K, function, counted=counted)
    assert len(got) == len(want) == (3 if counted else 2)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_topk_match(want[0], want[1], got[0], got[1], rtol=RTOL)
    if counted:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[2][inp["n_q"]:].eq(0).all()       # padding rows
    assert torch.isinf(got[0][inp["n_q"]:]).all()


@pytest.mark.parametrize("function", sorted(FUNCTIONS))
def test_sparse_topk_matches_reference(function):
    """``sparse_topk`` (one query) is K15 at Q 1."""
    inp = make_sparse_inputs(2, n_q=1, q_pad=1, per_q=30)
    pivot, exponent = FUNCTIONS[function]
    docs, weights, live = jx(inp, "docs", "weights", "live")
    s_r, d_r = ref.sparse_topk(docs, weights, jnp.asarray(inp["idx"][0]),
                               jnp.asarray(inp["qw"][0]), jnp.float32(pivot),
                               jnp.float32(exponent), live, inp["n_pad"], K,
                               function)
    s, d = port.sparse_topk(*tx(inp, "docs", "weights"),
                            torch.as_tensor(inp["idx"][0]),
                            torch.as_tensor(inp["qw"][0]), pivot, exponent,
                            torch.as_tensor(inp["live"]), inp["n_pad"], K,
                            function)
    assert s.shape == (K,) and d.shape == (K,)
    assert_topk_match(np.asarray(s_r)[None], np.asarray(d_r)[None], s[None],
                      d[None], rtol=RTOL)


@pytest.mark.parametrize("function", sorted(FUNCTIONS))
def test_sparse_scores_matches_reference(function):
    """K19's plain version against ``sparse_scores``; with a live mask it
    is ``SparseExecutor.scores``' where(live, s, 0)."""
    inp = make_sparse_inputs(3, n_q=1, q_pad=1, per_q=40)
    pivot, exponent = FUNCTIONS[function]
    want = np.asarray(ref.sparse_scores(
        *jx(inp, "docs", "weights"), jnp.asarray(inp["idx"][0]),
        jnp.asarray(inp["qw"][0]), jnp.float32(pivot), jnp.float32(exponent),
        inp["n_pad"], function))
    args = (*tx(inp, "docs", "weights"), torch.as_tensor(inp["idx"][0]),
            torch.as_tensor(inp["qw"][0]), pivot, exponent, inp["n_pad"],
            function)
    got = port.sparse_scores(*args).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    live = torch.as_tensor(inp["live"])
    masked = port.sparse_scores(*args, live=live).numpy()
    np.testing.assert_array_equal(masked, np.where(inp["live"], got, 0.0))


@pytest.mark.parametrize("seed", [4, 5])
def test_sparse_coarse_matches_reference(seed):
    """K16's plain version against ``sparse_coarse_kernel`` over the bf16
    weight mirror: candidates and coarse scores, exact counts."""
    inp = make_sparse_inputs(seed)
    kprime = 64
    docs, idx, qw, live = jx(inp, "docs", "idx", "qw", "live")
    cs_r, cand_r, hits_r = ref.sparse_coarse_kernel(
        docs, jnp.asarray(inp["weights"]).astype(jnp.bfloat16), idx, qw,
        live, inp["n_pad"], kprime)
    w16 = torch.as_tensor(inp["weights"]).to(torch.bfloat16)
    cs, cand, hits = port.sparse_coarse_kernel(
        torch.as_tensor(inp["docs"]), w16, *tx(inp, "idx", "qw", "live"),
        inp["n_pad"], kprime)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(hits_r))
    assert_topk_match(cs_r, cand_r, cs, cand, rtol=RTOL)


@pytest.mark.parametrize("seed", [6, 7])
def test_sparse_rerank_matches_reference(seed):
    """K17's plain version against ``sparse_rerank_kernel`` on the same
    coarse candidates: top-k, and eps within the score tolerance."""
    inp = make_sparse_inputs(seed)
    kprime = 64
    docs, weights, idx, qw, live = jx(inp, "docs", "weights", "idx", "qw",
                                      "live")
    cs_r, cand_r, _ = ref.sparse_coarse_kernel(
        docs, weights.astype(jnp.bfloat16), idx, qw, live, inp["n_pad"],
        kprime)
    s_r, d_r, eps_r = ref.sparse_rerank_kernel(
        docs, weights, idx, qw, live, cand_r, cs_r, inp["n_pad"], kprime, K)
    s, d, eps = port.sparse_rerank_kernel(
        *tx(inp, "docs", "weights", "idx", "qw", "live"),
        torch.as_tensor(np.array(cand_r)), torch.as_tensor(np.array(cs_r)),
        inp["n_pad"], kprime, K)
    assert_topk_match(s_r, d_r, s, d, rtol=RTOL)
    # eps is a difference of an exact and a coarse score: it moves by the
    # exact scores' own tolerance (two scores' worth, at the largest)
    top = float(np.max(np.where(np.isfinite(s_r), s_r, 0)))
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_r), rtol=0,
                               atol=2 * RTOL * top)


def test_coarse_product_is_exact_not_rounded_to_bf16():
    """The coarse contribution is f32(bf16(qw)) * f32(w_bf16), the exact
    product of two bf16 values, never rounded to bf16: the JAX program on
    the CPU computes that (XLA drops the bf16 rounding of a product widened
    to f32 at once), and so does the port."""
    qw, w = 1.0390625, 4.09375                 # 8 significant bits each
    assert float(torch.tensor(qw).bfloat16()) == qw
    assert float(torch.tensor(w).bfloat16()) == w
    exact = qw * w                             # 14 significant bits
    rounded = float(torch.tensor(exact).bfloat16())
    assert rounded != exact
    docs = np.full((1, 128), -1, np.int32)
    docs[0, 0] = 3
    weights = np.zeros((1, 128), np.float32)
    weights[0, 0] = w
    idx = np.zeros((1, 8), np.int32)
    qws = np.zeros((1, 8), np.float32)
    qws[0, 0] = qw
    live = np.ones(128, bool)
    cs_r, cand_r, _ = ref.sparse_coarse_kernel(
        jnp.asarray(docs), jnp.asarray(weights).astype(jnp.bfloat16),
        jnp.asarray(idx), jnp.asarray(qws), jnp.asarray(live), 128, 4)
    cs, cand, hits = port.sparse_coarse_kernel(
        torch.as_tensor(docs), torch.as_tensor(weights).to(torch.bfloat16),
        torch.as_tensor(idx), torch.as_tensor(qws), torch.as_tensor(live),
        128, 4)
    assert float(np.asarray(cs_r)[0, 0]) == exact
    assert float(cs[0, 0]) == exact and int(cand[0, 0]) == 3
    assert int(hits[0]) == 1


def test_rerank_and_scores_equal_flat_bitwise():
    """The port's own identity: K17 re-derives K15's score for every
    candidate, and K19's row holds K15's scores, bit for bit (fixed-point
    sums of the same contributions)."""
    inp = make_sparse_inputs(8, n_q=3, q_pad=4, per_q=40)
    t = dict(zip(("docs", "weights", "idx", "qw", "live"),
                 tx(inp, "docs", "weights", "idx", "qw", "live")))
    n_pad, kprime = inp["n_pad"], 256
    s15, d15 = port.sparse_topk_batch(t["docs"], t["weights"], t["idx"],
                                      t["qw"], 1.0, 1.0, t["live"], n_pad,
                                      kprime, "linear")
    cs, cand, _ = port.sparse_coarse_kernel(
        t["docs"], t["weights"].to(torch.bfloat16), t["idx"], t["qw"],
        t["live"], n_pad, kprime)
    s17, d17, _ = port.sparse_rerank_kernel(
        t["docs"], t["weights"], t["idx"], t["qw"], t["live"], cand, cs,
        n_pad, kprime, K)
    for q in range(inp["n_q"]):
        exact = dict(zip(d15[q].tolist(), s15[q].tolist()))
        for sc, doc in zip(s17[q].tolist(), d17[q].tolist()):
            if np.isfinite(sc):
                assert exact[doc] == sc
        row = port.sparse_scores(t["docs"], t["weights"], t["idx"][q],
                                 t["qw"][q], 1.0, 1.0, n_pad, "linear",
                                 live=t["live"])
        fin = torch.isfinite(s15[q])
        assert torch.equal(row[d15[q][fin].long()], s15[q][fin])


def test_gather_feature_blocks_matches_reference():
    feats = {"a": 0, "b": 1, "c": 2}
    kw = dict(features=feats,
              block_docs=np.zeros((6, 128), np.int32),
              block_weights=np.zeros((6, 128), np.float32),
              block_max_weight=np.zeros(6, np.float32),
              feat_block_start=np.array([0, 2, 5]),
              feat_block_count=np.array([2, 3, 1]),
              doc_freq=np.array([200, 300, 7]))
    query = [("c", 0.5), ("zz", 9.0), ("a", 1.25), ("b", 2.0)]
    for bucket_min in (1, 8):
        want = ref.gather_feature_blocks(RefFeatures(**kw), query, bucket_min)
        got = port.gather_feature_blocks(FeaturesField(**kw), query,
                                         bucket_min)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_unknown_function_is_refused():
    inp = make_sparse_inputs(9, n_q=1, q_pad=1)
    with pytest.raises(ValueError):
        port.sparse_scores(*tx(inp, "docs", "weights"),
                           torch.as_tensor(inp["idx"][0]),
                           torch.as_tensor(inp["qw"][0]), 1.0, 1.0,
                           inp["n_pad"], "cubic")
