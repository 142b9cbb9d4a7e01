"""The fusion kernels' plain versions against the JAX package's programs.

``elasticsearch_tpu_torch.ops.fusion`` (K24 ``rrf_fuse_batch`` /
``rrf_fuse``, K25 ``linear_fuse``; CPU tensors run the plain PyTorch
versions) against ``elasticsearch_tpu.ops.fusion`` on seeded numpy
inputs: R 2-4 lists of K 8-256 ids, B 1-8 rows, -1 pads, ids at and above
``n_docs_pad`` (dropped), the same doc at equal ranks in different lists
(equal scores, ordered by doc id), a doc repeated within one list (both
entries count) and row 28's unscored tail.

Tolerances: RRF ids exact and RRF scores bitwise at every R tried, R 3
and 4 included -- the JAX package's CPU scatter-add adds a doc's entries
in flattened (r, k) order, the order the port keeps (ROADMAP queue 3,
item 10). ``linear_fuse``: scores to 1e-6 of the sum of the terms'
magnitudes, sum |s_r * w_r| (the JAX package's einsum over r may fuse a
multiply into an add, the port rounds each, and a sum of terms of both
signs cancels, so its error scales with the terms, not the result); ids
exact outside groups whose reference scores tie within that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import fusion as ref

from elasticsearch_tpu_torch.ops import fusion as port

RTOL = 1e-6


def ranked_lists(rng, b: int, r: int, k: int, n_docs: int, n_docs_pad: int):
    """[B, R, K] int32 ranked lists with every awkward case."""
    out = rng.integers(0, n_docs, (b, r, k)).astype(np.int32)
    out[rng.random((b, r, k)) < 0.15] = -1                  # pads
    # ids at and past the pad: dropped, never indexed
    out[rng.random((b, r, k)) < 0.05] = n_docs_pad + rng.integers(0, 9)
    out[:, :, -1] = -1
    out[(out >= n_docs) & (out < n_docs_pad)] = -1
    tie_a, tie_b = n_docs, n_docs + 1          # listed nowhere else
    for row in range(b):
        # the same doc at the same rank in two lists
        out[row, 0, 6] = out[row, 1, 6] = 5
        # two docs whose entries mirror each other: equal scores
        out[row, 0, 1] = out[row, 1, 2] = tie_b
        out[row, 0, 2] = out[row, 1, 1] = tie_a
        # a doc repeated within one list: both entries count
        out[row, 0, 4] = out[row, 0, 5] = 11
    return out


def ref_batch(lists, n_docs_pad, k, rc):
    s, d = ref.rrf_fuse_batch(jnp.asarray(lists), n_docs_pad=n_docs_pad,
                              k=k, rank_constant=rc)
    return np.asarray(s), np.asarray(d)


CASES = [
    # (b, r, k_list, n_docs, n_docs_pad, k, rank_constant)
    (1, 2, 8, 20, 32, 16, 60),
    (4, 2, 128, 200, 256, 256, 60),
    (8, 2, 16, 40, 64, 32, 1),
    (3, 3, 32, 50, 64, 64, 60),
    (2, 4, 64, 100, 128, 128, 20),
    (5, 3, 256, 900, 1024, 512, 60),
    (2, 4, 256, 29, 32, 32, 7),
]


@pytest.mark.parametrize("case", CASES, ids=[
    "b{}_r{}_k{}_n{}_pad{}_top{}_c{}".format(*c) for c in CASES])
def test_rrf_fuse_batch_plain_is_the_reference(case):
    b, r, kk, n_docs, n_pad, k, rc = case
    rng = np.random.default_rng(sum(case))
    lists = ranked_lists(rng, b, r, kk, n_docs, n_pad)
    want_s, want_d = ref_batch(lists, n_pad, k, rc)
    got_s, got_d = port.rrf_fuse_batch(torch.as_tensor(lists), n_pad, k, rc)
    assert got_s.dtype == torch.float32 and got_d.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    # bitwise, -inf slots included, at every R
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  want_s.view(np.uint32))
    # mirrored entries tie; the lower id comes first
    row = list(got_d[0].numpy())
    assert row.index(n_docs) + 1 == row.index(n_docs + 1)
    assert got_s[0, row.index(n_docs)] == got_s[0, row.index(n_docs + 1)]


@pytest.mark.parametrize("case", [(2, 8, 20, 32, 32, 60),
                                  (3, 128, 300, 512, 512, 60),
                                  (4, 64, 100, 4096, 700, 5)],
                         ids=["r2_tail_to_the_end", "r3_whole_row",
                              "r4_wide_pad"])
def test_rrf_fuse_plain_keeps_the_unscored_tail(case):
    """Row 28: past the matches, the lowest-numbered unscored doc ids in
    ascending order at -inf, as lax.top_k over the dense row."""
    r, kk, n_docs, n_pad, k, rc = case
    rng = np.random.default_rng(sum(case))
    lists = ranked_lists(rng, 1, r, kk, n_docs, n_pad)[0]
    want_s, want_d = ref.rrf_fuse(jnp.asarray(lists), n_docs_pad=n_pad, k=k,
                                  rank_constant=rc)
    got_s, got_d = port.rrf_fuse(torch.as_tensor(lists), n_pad, k, rc)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  np.asarray(want_s).view(np.uint32))
    scored = int(np.isfinite(np.asarray(want_s)).sum())
    tail = got_d.numpy()[scored:]
    assert len(tail) and (np.diff(tail) > 0).all()
    assert not set(tail) & set(got_d.numpy()[:scored])


def test_rrf_fuse_batch_past_the_matches_is_minus_one():
    lists = np.full((2, 2, 8), -1, np.int32)
    lists[0, 0, :3] = [5, 1, 5]
    lists[1, 1, 0] = 40                      # dropped: >= n_docs_pad
    s, d = port.rrf_fuse_batch(torch.as_tensor(lists), 32, 6, 60)
    want_s, want_d = ref_batch(lists, 32, 6, 60)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  want_s.view(np.uint32))
    assert list(d[0].numpy()) == [5, 1, -1, -1, -1, -1]
    assert (d[1].numpy() == -1).all() and torch.isinf(s[1]).all()


def _linear_inputs(seed: int, r: int, n: int):
    rng = np.random.default_rng(seed)
    scores = rng.gamma(2.0, 1.5, (r, n)).astype(np.float32)
    scores[rng.random((r, n)) < 0.3] = 0.0
    scores[rng.random((r, n)) < 0.05] *= -1.0        # negatives
    if r > 2:
        scores[2] = 0.0        # a retriever with no positive score
    weights = rng.uniform(0.1, 2.0, r).astype(np.float32)
    live = rng.random(n) > 0.1
    return scores, weights, live


def _magnitudes(scores, weights, normalize):
    """Per doc, the sum of |s_r * w_r| (float64): the scale a sum's
    rounding error is relative to when its terms differ in sign."""
    s = scores.astype(np.float64)
    if normalize:
        mx = s.max(axis=1, keepdims=True)
        pos = np.where(s > 0, s, np.inf).min(axis=1, keepdims=True)
        mn = np.where(np.isfinite(pos), pos, 0.0)
        s = np.where(s > 0, (s - mn) / np.maximum(mx - mn, 1e-9), 0.0)
    return np.abs(s * weights.astype(np.float64)[:, None]).sum(axis=0)


def _assert_linear(got, want, mags):
    gs, gd = got[0].numpy(), got[1].numpy()
    ws, wd = np.asarray(want[0]), np.asarray(want[1])
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    tols = RTOL * mags[wd[fin]]
    assert (np.abs(gs[fin].astype(np.float64) - ws[fin]) <= tols).all()
    i = 0
    while i < len(ws):
        j = i + 1
        tol = RTOL * mags[wd[i]] if np.isfinite(ws[i]) else 0.0
        while j < len(ws) and (ws[j] == ws[i] or
                               abs(ws[j] - ws[i]) <= 2 * tol):
            j += 1
        # a tie group at the cut may continue past it
        if j < len(ws) and np.isfinite(ws[i]):
            assert sorted(gd[i:j]) == sorted(wd[i:j])
        i = j
    # the -inf tail is in index order on both sides
    np.testing.assert_array_equal(gd[~fin], wd[~fin])


@pytest.mark.parametrize("r,n,k,normalize", [
    (2, 64, 10, True), (3, 1000, 50, True), (4, 513, 513, True),
    (2, 4096, 10, False), (3, 300, 300, False)],
    ids=["r2_k10", "r3_k50", "r4_all", "r2_raw", "r3_raw_all"])
def test_linear_fuse_plain_is_the_reference(r, n, k, normalize):
    scores, weights, live = _linear_inputs(r * n + k, r, n)
    want = ref.linear_fuse(jnp.asarray(scores), jnp.asarray(weights),
                           jnp.asarray(live), k=k, normalize=normalize)
    got = port.linear_fuse(torch.as_tensor(scores), torch.as_tensor(weights),
                           torch.as_tensor(live), k, normalize)
    _assert_linear(got, want, _magnitudes(scores, weights, normalize))


def test_wrappers_refuse_bad_inputs():
    lists = torch.zeros(2, 2, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        port.rrf_fuse_batch(lists, 8, 9, 60)           # k > n_docs_pad
    with pytest.raises(ValueError):
        port.rrf_fuse_batch(lists[0], 8, 4, 60)        # not [B, R, K]
    with pytest.raises(TypeError):
        port.rrf_fuse(lists[0].long(), 8, 4, 60)
    with pytest.raises(ValueError):
        port.rrf_fuse(lists[0], 8, 4, 0)               # rank_constant < 1
    with pytest.raises(ValueError):
        port.linear_fuse(torch.zeros(2, 8), torch.ones(2),
                         torch.ones(8, dtype=torch.bool), 9)
