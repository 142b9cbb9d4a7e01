"""The four BM25 kernels on the card, bitwise against their plain PyTorch
versions. Needs a CUDA card and nvcc; skipped without a card.

It imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import pytest
import torch

from elasticsearch_tpu_torch.ops import bm25 as port
from torch_inputs import FLAT, make_inputs, tx

K = 10


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """On the card every family is bitwise equal to its plain version,
    at a shape that takes the chunked top-k's merge pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    inp = make_inputs(12, n_docs=150_000, nb=2048, n_q=8, per_q=200)
    cpu = tx(inp, *FLAT, "seg")
    dev = [t.cuda() for t in cpu]
    n_pad, n_q, n_segs = inp["n_pad"], inp["n_q"], inp["n_segs"]
    for counted in (False, True):
        got = port.bm25_flat(*dev[:8], n_pad, n_q, K, counted=counted)
        want = port.bm25_flat_plain(*dev[:8], n_pad, n_q, K, counted=counted)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = port.bm25_flat_seg(*dev, n_pad, n_q, K, n_segs=n_segs)
    want = port.bm25_flat_seg_plain(*dev, n_pad, n_q, K, n_segs=n_segs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    q16 = list(dev)
    q16[1] = q16[1].to(torch.bfloat16)
    q16[5] = q16[5].to(torch.bfloat16)
    got = port.bm25_coarse(*q16, n_pad, n_q, n_segs, 256)
    want = port.bm25_coarse_plain(*q16, n_pad, n_q, n_segs, 256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = port.bm25_rerank(*dev[:8], want[1], want[0], n_pad, n_q, 256, K)
    want = port.bm25_rerank_plain(*dev[:8], want[1], want[0], n_pad, n_q,
                                  256, K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
