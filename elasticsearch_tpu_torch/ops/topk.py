"""The dense collector's top-k on the card.

``dense_topk`` (K10, ``csrc/dense_topk.cu``): the top-k of one dense
score row, the eager ``lax.top_k`` that the JAX package's dense collector
runs on every segment of every dense request (``search/phase.py``
``_topk``), for any k <= n. A CTA holds at most KMAX (4,096) winners, so
a wider k runs in rounds of at most KMAX, each after the cursor the round
before left (``csrc/topk_common.cuh``); every selecting family (K1, K2,
K5, K10, K14, K15) runs the same rounds inside its own launch.

Order: score descending, then index ascending, -inf slots included --
the order ``lax.top_k`` returns, which decides the hits of ``match_all``
and ``constant_score`` (every match scores the same).

The wrapper launches its kernel for a CUDA tensor and runs the plain
version (a stable sort) for a CPU tensor; there is no fallback between
the two.
"""

from __future__ import annotations

from typing import Tuple

import torch

from elasticsearch_tpu_torch.ops.bm25 import (
    _check, _on_cuda, _ptr, _stream, chunk_entries, launch_kernel,
    stable_topk,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

_SIG = ["p", "ll", "i"] + ["p"] * 5


def dense_topk_plain(scores: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    s, d = stable_topk(scores[None, :], k)
    return s[0], d[0]


def dense_topk(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10. (s [k] f32, d [k] int32): the k best entries of ``scores``
    [n] f32 (non-matches at -inf), 1 <= k <= n."""
    cuda = _on_cuda(scores)
    if scores.dim() != 1:
        raise ValueError(f"[scores] must be 1-d, got {tuple(scores.shape)}")
    n = scores.shape[0]
    _check("scores", scores, torch.float32, (n,))
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    label = f"n_docs_pad={n}/k={k}"
    with DEVICE_PROFILE.call("dense_topk", label, cuda):
        if not cuda:
            return dense_topk_plain(scores, k)
        dev = scores.device
        ck = chunk_entries(1, n, k)
        chunk_s = torch.empty(ck, dtype=torch.float32, device=dev)
        chunk_i = torch.empty(ck, dtype=torch.int32, device=dev)
        s = torch.empty(k, dtype=torch.float32, device=dev)
        d = torch.empty(k, dtype=torch.int32, device=dev)
        launch_kernel("dense_topk", _SIG, _ptr(scores), n, k, _ptr(chunk_s),
                      _ptr(chunk_i), _ptr(s), _ptr(d), _stream())
        return s, d
