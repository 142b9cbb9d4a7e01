"""The expansion model of elasticsearch_tpu_torch (``ml/text_expansion.py``)
against the JAX package's (``elasticsearch_tpu/ml/text_expansion.py``).

The weights are made from the same ``default_rng(seed)`` draws and must
be bitwise equal. The forward's plain PyTorch version (K18's) is held
against the JAX program ``text_expansion_forward`` on the CPU, at a
narrow width and at the default one (vocab 8,192, hidden 256, 32,768
hash rows, 64 tokens, top-32).

Tolerance of the forward's weights: atol 2e-5. A weight is an exact
anchor (2.0 per occurrence) plus out / (1e-6 + max(out)), out a relu'd
256-term f32 dot; the port sums each dot in k order with every product
and sum rounded once, XLA in its own blocked order, and the gelu's tanh
comes from two libraries. Two summation orders of H terms differ by at
most H * 2^-24 of the sum of the terms' magnitudes (1.5e-5 of it at H
256); the largest difference seen at the default width is 7.2e-7. Ids
equal except where the reference's neighbouring weights lie within twice
that tolerance (a near-tie may order either way). ``expand_batch`` keeps
weights above 1e-4 rounded to 4 decimals: keys equal except a feature
whose unrounded weight lies within the tolerance of the cut, values within
1e-4 (a weight within the tolerance of a rounding boundary may round
either way).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.ml import text_expansion as ref
from elasticsearch_tpu.utils.errors import ResourceNotFoundError as RefNotFound
from elasticsearch_tpu_torch.convert import expansion_model_from_reference
from elasticsearch_tpu_torch.ml import text_expansion as port
from elasticsearch_tpu_torch.utils.errors import ResourceNotFoundError

ATOL = 2e-5
NARROW = dict(vocab_size=512, hidden=32, n_hash=1 << 10)
TEXTS = ["quick brown fox", "the lazy dog jumps over the fence", "alpha",
         "", "Fox, fox; FOX!", "word1 word2 word3 word1 word2",
         " ".join(f"w{i}" for i in range(80))]

_MODELS = {}


def models(width: str):
    """(reference model, port model on the CPU) of one width, built once."""
    if width not in _MODELS:
        kw = NARROW if width == "narrow" else {}
        _MODELS[width] = (ref.TextExpansionModel(model_id="t-" + width, **kw),
                          port.TextExpansionModel(model_id="t-" + width,
                                                  device="cpu", **kw))
    return _MODELS[width]


def featurized(model, texts):
    ids = np.stack([model._featurize(t)[0] for t in texts])
    direct = np.stack([model._featurize(t)[1] for t in texts])
    return ids, direct


def assert_weights_match(w_ref, f_ref, w_got, f_got):
    w_ref, f_ref = np.asarray(w_ref), np.asarray(f_ref)
    w_got, f_got = np.asarray(w_got), np.asarray(f_got)
    assert w_ref.shape == w_got.shape and f_ref.shape == f_got.shape
    for r in range(w_ref.shape[0]):
        s = w_ref[r]
        for j in range(len(s)):
            lo = abs(s[j - 1] - s[j]) if j else np.inf
            hi = abs(s[j + 1] - s[j]) if j + 1 < len(s) else np.inf
            if min(lo, hi) > 2 * ATOL:
                assert f_got[r, j] == f_ref[r, j], (r, j)
        # a near-tie may swap ids, never the sorted weights
        np.testing.assert_allclose(w_got[r], s, rtol=0, atol=ATOL)


@pytest.mark.parametrize("width", ["narrow", "default"])
def test_featurize_matches_reference(width):
    r, p = models(width)
    for text in TEXTS:
        for a, b in zip(r._featurize(text), p._featurize(text)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("width", ["narrow", "default"])
def test_weights_from_the_seed_are_bitwise_equal(width):
    r, p = models(width)
    for a, b in ((r._emb, p._emb), (r._w1, p._w1), (r._w2, p._w2)):
        a = np.asarray(a)
        assert b.dtype == torch.float32 and a.dtype == np.float32
        np.testing.assert_array_equal(b.numpy(), a)
    assert not p._emb[0].any()          # the padding row


@pytest.mark.parametrize("width", ["narrow", "default"])
def test_forward_plain_matches_reference(width):
    """K18's plain version against ``text_expansion_forward``."""
    r, p = models(width)
    ids, direct = featurized(r, TEXTS)
    w_ref, f_ref = r._forward(ids, direct)
    w, f = port.text_expansion_forward(
        torch.as_tensor(ids), torch.as_tensor(direct), p._emb, p._w1, p._w2,
        p.top_m)
    assert w.dtype == torch.float32 and f.dtype == torch.int32
    assert_weights_match(w_ref, f_ref, w, f)


def test_expansion_model_from_reference_computes_the_same():
    """The converted model holds the reference's weights and widths and
    serves the same forward as a port model made from the seed."""
    r, p = models("narrow")
    c = expansion_model_from_reference(r, device="cpu")
    assert (c.model_id, c.vocab_size, c.hidden, c.n_hash, c.max_tokens,
            c.top_m) == (r.model_id, r.vocab_size, r.hidden, r.n_hash,
                         r.max_tokens, r.top_m)
    for a, b in ((r._emb, c._emb), (r._w1, c._w1), (r._w2, c._w2)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ids, direct = featurized(r, TEXTS)
    for got, want in zip(c._forward(ids, direct), p._forward(ids, direct)):
        assert torch.equal(got, want)
    w_ref, f_ref = r._forward(ids, direct)
    assert_weights_match(w_ref, f_ref, *c._forward(ids, direct))


@pytest.mark.parametrize("width", ["narrow", "default"])
def test_expand_batch_matches_reference(width):
    r, p = models(width)
    ids, direct = featurized(r, TEXTS)
    w_ref = np.asarray(r._forward(ids, direct)[0])
    got = p.expand_batch(TEXTS)
    want = r.expand_batch(TEXTS)
    for i, (a, b) in enumerate(zip(want, got)):
        last = float(w_ref[i][-1])      # the top-m's smallest weight
        for k in set(a) ^ set(b):
            # only a feature at the 1e-4 cut, or in a near-tie at the
            # top-m's last slot, may be kept by one side alone
            v = a.get(k, b.get(k))
            assert (abs(v - 1e-4) <= ATOL + 1e-4
                    or abs(v - last) <= 2 * ATOL + 1e-4), (i, k)
        for k in set(a) & set(b):
            assert abs(a[k] - b[k]) <= 1e-4 + 1e-9, (i, k, a[k], b[k])
            assert b[k] == round(b[k], 4)
    assert p.expand_batch(TEXTS) == got          # served from the cache
    assert p.expand("quick brown fox") == got[0]


def test_unknown_model_id_is_404():
    with pytest.raises(ResourceNotFoundError) as e:
        port.get_model(".elser-typo-9", device="cpu")
    assert e.value.status == 404
    with pytest.raises(RefNotFound):
        ref.get_model(".elser-typo-9")


def test_registry_deploys_per_device():
    m = port.TextExpansionModel(model_id="custom-1", device="cpu", **NARROW)
    port.register_model(m)
    assert port.get_model("custom-1", "cpu") is m
    assert port.get_model(None, "cpu") is port.get_model(
        port.DEFAULT_MODEL_ID, "cpu")


def test_rewrite_body_expansions_matches_reference():
    """The coordinator rewrite: every model_text clause, nested ones too,
    becomes tokens in one batched call per model; the caller's body is left
    as it was; a body without model_text is returned as it is."""
    body = {"query": {"bool": {
        "should": [{"text_expansion": {"ml": {"model_text": "quick fox"}}},
                   {"text_expansion": {"ml": {"model_text": "lazy dog",
                                              "model_id": None}}}],
        "filter": [{"term": {"tag": "a"}}]}}, "size": 3}
    before = repr(body)
    got = port.rewrite_body_expansions(body, "cpu")
    want = ref.rewrite_body_expansions(body)
    assert repr(body) == before
    g_sites = got["query"]["bool"]["should"]
    w_sites = want["query"]["bool"]["should"]
    for g, w in zip(g_sites, w_sites):
        g, w = g["text_expansion"]["ml"], w["text_expansion"]["ml"]
        assert set(g) == set(w) == {"tokens"}
        assert set(g["tokens"]) == set(w["tokens"])
        for k, v in w["tokens"].items():
            assert abs(g["tokens"][k] - v) <= 1e-4 + 1e-9
    assert got["query"]["bool"]["filter"] == body["query"]["bool"]["filter"]
    plain = {"query": {"match": {"body": "x"}}}
    assert port.rewrite_body_expansions(plain, "cpu") is plain
    with pytest.raises(ResourceNotFoundError):
        port.rewrite_body_expansions({"query": {"text_expansion": {"ml": {
            "model_text": "x", "model_id": "nope"}}}}, "cpu")
