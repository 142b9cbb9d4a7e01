"""The dense collector's top-k on the card.

``dense_topk`` (K10, ``csrc/dense_topk.cu``): the top-k of one dense
score row, the eager ``lax.top_k`` that the JAX package's dense collector
runs on every segment of every dense request (``search/phase.py``
``_topk``), for any k <= n, by a card-wide radix select
(``csrc/radix_select.cuh``) over one 64-bit key per entry:
``selection_keys`` below is that key in plain PyTorch, and
``dense_topk_by_keys`` the selection it implies.

Order: score descending (+0.0 above -0.0, as ``lax.top_k``'s total
order has it: a ``script_score`` can return either), then index
ascending, -inf slots included -- the order ``lax.top_k`` returns, which
decides the hits of ``match_all`` and ``constant_score`` (every match
scores the same).

The wrapper launches its kernel for a CUDA tensor and runs the plain
version (a stable sort of the scores' ordered bits) for a CPU tensor;
there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from elasticsearch_tpu_torch.ops.bm25 import (
    _check, _on_cuda, _ptr, _stream, launch_kernel,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

_SIG = ["p", "ll", "i"] + ["p"] * 6
# csrc/radix_select.cuh CAP: the most keys one CTA sorts in shared memory;
# a wider k sorts runs of CAP and merges them
SORT_CAP = 16384
_SCRATCH = []


def score_words(scores: torch.Tensor) -> torch.Tensor:
    """int64 [n]: each f32 score's bits mapped so that integer order is
    ``lax.top_k``'s total order (``csrc/radix_select.cuh``
    ``score_bits``): -0.0 just below +0.0, every NaN as one NaN above
    +inf; in [0, 2^32)."""
    s = scores.float()
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(torch.isnan(s), torch.full_like(u, 0x7FC00000), u)
    return torch.where((u & 0x80000000) != 0, u ^ 0xFFFFFFFF,
                       u | 0x80000000)


def selection_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 [n]: K10's 64-bit key of each entry of ``scores`` [n] f32
    (``csrc/radix_select.cuh`` ``make_key``), minus 2^63, so that signed
    order is the key's unsigned order. The high word is
    ``score_words``, the low word n - 1 - index: a larger key is a
    better entry, and no two keys are equal."""
    n = scores.shape[0]
    low = n - 1 - torch.arange(n, dtype=torch.int64, device=scores.device)
    return (score_words(scores) - (1 << 31)) * (1 << 32) + low


def dense_topk_by_keys(scores: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest ``selection_keys``, decoded as K10 decodes them: the
    index from the low word, the score read back from the row."""
    keys = torch.sort(selection_keys(scores), descending=True).values[:k]
    d = scores.shape[0] - 1 - (keys & 0xFFFFFFFF)
    return scores[d], d.to(torch.int32)


def rows_topk_by_keys(values: torch.Tensor, ids: torch.Tensor, n: int,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/rows_select.cuh``'s selection in plain PyTorch: each row of
    ``values`` [R, m] (entries indexed by ``ids`` [R, m], distinct ids
    in [0, n) a row) keyed as K10 keys an entry (``score_words`` high,
    n - 1 - id low), the k largest keys, the score decoded from the key
    and the id from its low word. -> (s [R, k] f32, d [R, k] int32)."""
    keys = ((score_words(values) - (1 << 31)) * (1 << 32)
            + (n - 1 - ids.long()))
    top = torch.sort(keys, dim=1, descending=True).values[:, :k]
    words = (top >> 32) + (1 << 31)
    u = torch.where(words >= (1 << 31), words - (1 << 31),
                    words ^ 0xFFFFFFFF)
    s = u.to(torch.int64).to(torch.int32).view(torch.float32)
    return s, (n - 1 - (top & 0xFFFFFFFF)).to(torch.int32)


def dense_topk_plain(scores: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stable sort of ``score_words``: score descending with +0.0 above
    -0.0, the lower index first among equal bits."""
    d = torch.sort(score_words(scores), descending=True, stable=True
                   ).indices[:k]
    return scores[d], d.to(torch.int32)


@functools.lru_cache(maxsize=1024)
def _scratch_sizes(n: int, k: int) -> Tuple[int, int, int]:
    """(state bytes, key entries, second key entries) of a launch, from
    the kernel's own ``dense_topk_scratch``."""
    if not _SCRATCH:
        from elasticsearch_tpu_torch._build import library
        fn = library("dense_topk").dense_topk_scratch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        _SCRATCH.append(fn)
    sizes = (ctypes.c_longlong * 3)()
    _SCRATCH[0](n, k, sizes)
    return sizes[0], sizes[1], sizes[2]


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
        state_bytes, n_keys, n_keys2 = _scratch_sizes(n, k)
        n_state = -(-state_bytes // 8)
        scratch = torch.empty(n_state + n_keys + n_keys2, dtype=torch.int64,
                              device=dev)
        base = _ptr(scratch)
        keys2 = base + 8 * (n_state + n_keys) if n_keys2 else None
        s = torch.empty(k, dtype=torch.float32, device=dev)
        d = torch.empty(k, dtype=torch.int32, device=dev)
        launch_kernel("dense_topk", _SIG, _ptr(scores), n, k, base,
                      base + 8 * n_state, keys2, _ptr(s), _ptr(d),
                      _stream())
        return s, d
