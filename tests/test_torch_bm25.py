"""The four BM25 kernel families of elasticsearch_tpu_torch against the JAX
package's programs they replace.

Inputs are made from a seed with numpy and handed to both packages: the
JAX programs (``_bm25_flat_kernel``, ``_bm25_flat_kernel_seg``,
``_bm25_coarse_kernel``, ``_bm25_rerank_kernel``) run jitted on the CPU,
the port's wrappers run their plain PyTorch versions on CPU tensors.

Tolerances: f32 scores to rtol 1e-6 (the reference adds f32 contributions
one by one, the port sums them exactly in fixed point and rounds once, so
the two differ by a few ulps); ids and counts exact, except that ids whose
reference scores lie within that tolerance of each other (a tie group)
are compared as a set. The bf16 coarse tier is held to the same: both
packages round the same bf16 operations (the final quotient in f32, as
XLA compiles the JAX program), so its scores agree far inside REL_BF16
(0.04), and its counts exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import bm25 as ref
from elasticsearch_tpu_torch.ops import bm25 as port
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from torch_inputs import FLAT, make_inputs, tx

RTOL = 1e-6
REL_BF16 = 0.04
K = 10


def jx(inp, *names):
    return [jnp.asarray(inp[n]) for n in names]


def assert_topk_match(ref_s, ref_d, got_s, got_d, rtol=RTOL):
    """Row-wise top-k agreement: -inf slots and their ids exact, scores to
    rtol, ids exact outside tie groups and as a set inside one. A tie
    group that reaches the last slot may continue past k, so only its
    size is held."""
    ref_s, ref_d = np.asarray(ref_s), np.asarray(ref_d)
    got_s, got_d = np.asarray(got_s), np.asarray(got_d)
    assert ref_s.shape == got_s.shape and ref_d.shape == got_d.shape
    for r in range(ref_s.shape[0]):
        fin = np.isfinite(ref_s[r])
        np.testing.assert_array_equal(np.isfinite(got_s[r]), fin)
        np.testing.assert_allclose(got_s[r][fin], ref_s[r][fin], rtol=rtol)
        np.testing.assert_array_equal(got_d[r][~fin], ref_d[r][~fin])
        s = ref_s[r][fin]
        i = 0
        while i < len(s):
            j = i + 1
            while j < len(s) and abs(s[j] - s[i]) <= rtol * abs(s[i]):
                j += 1
            if j < len(s) or len(s) < ref_s.shape[1]:
                assert set(got_d[r][i:j]) == set(ref_d[r][i:j]), (r, i, j)
            i = j


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bm25_flat_matches_reference(seed, counted):
    inp = make_inputs(seed)
    want = ref._bm25_flat_kernel(*jx(inp, *FLAT), n_docs_pad=inp["n_pad"],
                                 n_q=inp["n_q"], k=K, counted=counted)
    got = port.bm25_flat(*tx(inp, *FLAT), inp["n_pad"], inp["n_q"], K,
                         counted=counted)
    assert len(got) == len(want) == (3 if counted else 2)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_topk_match(want[0], want[1], got[0], got[1])
    if counted:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("seed", [2, 3])
def test_bm25_flat_seg_matches_reference(seed):
    inp = make_inputs(seed)
    want = ref._bm25_flat_kernel_seg(
        *jx(inp, *FLAT, "seg"), n_docs_pad=inp["n_pad"], n_q=inp["n_q"],
        k=K, n_segs=inp["n_segs"])
    got = port.bm25_flat_seg(*tx(inp, *FLAT, "seg"), inp["n_pad"],
                             inp["n_q"], K, n_segs=inp["n_segs"])
    assert_topk_match(want[0], want[1], got[0], got[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].shape == (inp["n_q"], inp["n_segs"])


def coarse_inputs(inp):
    j = jx(inp, *FLAT, "seg")
    j[1] = j[1].astype(jnp.bfloat16)
    j[5] = j[5].astype(jnp.bfloat16)
    t = tx(inp, *FLAT, "seg")
    t[1] = t[1].to(torch.bfloat16)
    t[5] = t[5].to(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("seed", [4, 5])
def test_bm25_coarse_matches_reference(seed):
    inp = make_inputs(seed)
    kprime = 64
    j, t = coarse_inputs(inp)
    cs_r, cand_r, hits_r = ref._bm25_coarse_kernel(
        *j, n_docs_pad=inp["n_pad"], n_q=inp["n_q"], n_segs=inp["n_segs"],
        kprime=kprime)
    cs, cand, hits = port.bm25_coarse(*t, inp["n_pad"], inp["n_q"],
                                      inp["n_segs"], kprime)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(hits_r))
    # the contract is REL_BF16; both packages round the same bf16 ops, so
    # the coarse scores agree far closer, and the candidates with them
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_r), rtol=REL_BF16)
    assert_topk_match(cs_r, cand_r, cs, cand)


@pytest.mark.parametrize("seed", [6, 7])
def test_bm25_rerank_matches_reference(seed):
    inp = make_inputs(seed)
    kprime = 64
    j, t = coarse_inputs(inp)
    cs_r, cand_r, _ = ref._bm25_coarse_kernel(
        *j, n_docs_pad=inp["n_pad"], n_q=inp["n_q"], n_segs=inp["n_segs"],
        kprime=kprime)
    # both tiers re-rank the SAME candidates (the reference's)
    s_r, d_r, eps_r = ref._bm25_rerank_kernel(
        *jx(inp, *FLAT), cand_r, cs_r, n_docs_pad=inp["n_pad"],
        n_q=inp["n_q"], kprime=kprime, k=K)
    s, d, eps = port.bm25_rerank(
        *tx(inp, *FLAT), torch.as_tensor(np.array(cand_r)),
        torch.as_tensor(np.array(cs_r)), inp["n_pad"], inp["n_q"], kprime,
        K)
    assert_topk_match(s_r, d_r, s, d)
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_r), rtol=1e-4,
                               atol=1e-5)


def test_rerank_scores_equal_flat_scores_bitwise():
    """The exact tier re-derives the flat kernel's score for every
    candidate, bit for bit (both sum the same contributions in fixed
    point), so the quantized tier serves the exact path's results."""
    inp = make_inputs(8)
    kprime = 64
    _j, t = coarse_inputs(inp)
    cs, cand, _ = port.bm25_coarse(*t, inp["n_pad"], inp["n_q"],
                                   inp["n_segs"], kprime)
    s4, d4, _ = port.bm25_rerank(*tx(inp, *FLAT), cand, cs, inp["n_pad"],
                                 inp["n_q"], kprime, K)
    s1, d1, _ = port.bm25_flat(*tx(inp, *FLAT), inp["n_pad"], inp["n_q"], K,
                               counted=True)
    assert torch.equal(s4, s1) and torch.equal(d4, d1)


def test_topk_tie_order_matches_lax_top_k():
    """Score descending, then index ascending, for -inf slots too —
    ``lax.top_k``'s order, which ``torch.topk`` does not promise."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0],
                      [-np.inf, 5.0, -np.inf, -np.inf, 5.0]])
    s, i = port.stable_topk(x, 4)
    assert i.tolist() == [[1, 2, 4, 3], [1, 4, 0, 2]]
    import jax
    rs, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(ri).tolist() == i.tolist()
    np.testing.assert_array_equal(np.asarray(rs), s.numpy())


def test_flat_ties_and_empty_rows_match_reference():
    """Docs with identical postings tie exactly in both packages and come
    back lowest id first; a row with fewer matches than k fills with -inf
    slots at the lowest unmatched ids; an all-padding row is all -inf."""
    n_pad = 512
    docs = np.full((4, 128), -1, np.int32)
    docs[0, :20] = np.arange(100, 120)        # 20 docs, same tf, same length
    docs[1, :3] = [5, 7, 9]
    tfs = np.where(docs >= 0, 2.0, 0.0).astype(np.float32)
    dl = np.full(n_pad, 40.0, np.float32)
    live = np.ones(n_pad, bool)
    live[103] = False
    idx = np.array([0, 1] + [0] * 30, np.int32)
    w = np.array([1.5, 2.0] + [0.0] * 30, np.float32)
    q = np.array([0, 1] + [0] * 30, np.int32)
    avg = np.full(32, 40.0, np.float32)
    inp = dict(docs=docs, tfs=tfs, dl=dl, live=live, idx=idx, w=w, q=q,
               avg=avg)
    n_q = 4
    want = ref._bm25_flat_kernel(*jx(inp, *FLAT), n_docs_pad=n_pad,
                                 n_q=n_q, k=K, counted=True)
    got = port.bm25_flat(*tx(inp, *FLAT), n_pad, n_q, K, counted=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1][0].tolist() == [100, 101, 102, 104, 105, 106, 107, 108,
                                  109, 110]
    assert got[1][1].tolist()[:3] == [5, 7, 9]
    assert got[1][1].tolist()[3:] == [0, 1, 2, 3, 4, 6, 8]
    assert got[2].tolist() == [19, 3, 0, 0]


def test_dispatch_flat_chunks_like_reference(monkeypatch):
    """Batches past MAX_CHUNK_Q / MAX_BATCH_CELLS split into the same
    dispatches in both packages, and the results agree."""
    inp = make_inputs(9, nb=256)
    rng = np.random.default_rng(9)
    plans_r, plans_p = [], []
    for _ in range(70):
        n = int(rng.integers(1, 40))
        rows = rng.integers(0, 256, n)
        wts = rng.uniform(0.5, 5.0, n)
        plans_r.append(ref.QueryPlan(rows, wts, wts, np.zeros(n)))
        plans_p.append(port.QueryPlan(rows, wts, wts, np.zeros(n)))
    cnt_r, cnt_p = [], []
    s_r, d_r, h_r = ref.dispatch_flat(
        jnp.asarray(inp["docs"]), jnp.asarray(inp["tfs"]),
        jnp.asarray(inp["dl"]), inp["n_pad"], plans_r,
        jnp.asarray(inp["live"]), K, ref.DEFAULT_K1, ref.DEFAULT_B,
        avgdl=45.0, counted=True, counter=cnt_r)
    s_p, d_p, h_p = port.dispatch_flat(
        torch.as_tensor(inp["docs"]), torch.as_tensor(inp["tfs"]),
        torch.as_tensor(inp["dl"]), inp["n_pad"], plans_p,
        torch.as_tensor(inp["live"]), K, port.DEFAULT_K1, port.DEFAULT_B,
        avgdl=45.0, counted=True, counter=cnt_p)
    assert len(cnt_r) == len(cnt_p) == 2          # 64 + 6 queries
    assert_topk_match(s_r, d_r, s_p, d_p)
    np.testing.assert_array_equal(h_p, np.asarray(h_r))


def test_plain_versions_do_not_count_as_launches():
    inp = make_inputs(10)
    DEVICE_PROFILE.reset_launches()
    before = DEVICE_PROFILE.family("bm25_flat").calls
    port.bm25_flat(*tx(inp, *FLAT), inp["n_pad"], inp["n_q"], K)
    assert DEVICE_PROFILE.family("bm25_flat").calls == before + 1
    assert DEVICE_PROFILE.launches().get("bm25_flat", 0) == 0


def test_wrappers_refuse_bad_inputs():
    inp = make_inputs(11)
    args = tx(inp, *FLAT)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(TypeError):
        port.bm25_flat(*bad, inp["n_pad"], inp["n_q"], K)
    bad = list(args)
    bad[5] = bad[5][:-1]
    with pytest.raises(ValueError):
        port.bm25_flat(*bad, inp["n_pad"], inp["n_q"], K)
    bad = list(args)
    bad[0] = bad[0].t().contiguous().t()
    with pytest.raises(ValueError):
        port.bm25_flat(*bad, inp["n_pad"], inp["n_q"], K)
