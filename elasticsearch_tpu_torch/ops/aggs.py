"""Aggregation collection on the card: the terms and histogram kernels.

The JAX package's ``ops/aggs.py``: the device half of the "device partial
agg + host reduce" split. The per-segment collectors (``search/
aggregations/buckets.py`` ``_device_terms`` / ``_device_histogram``) and
the drain-wide planner over the columns plane (``search/plane_aggs.py``)
turn query masks into per-bucket partials; the host keeps the map-shaped
merge and finalize.

Four kernel families, each a hand-written CUDA kernel behind a wrapper,
with its plain PyTorch version beside it:

- ``aggs_ordinal_counts`` (K20, ``csrc/aggs_ordinal_counts.cu``): int32
  counts per ordinal over one segment's deduped (owner, ord) table; the
  caller's ``dev_mask[owners]`` gather is fused in;
- ``aggs_histogram`` (K21, ``csrc/aggs_histogram.cu``): per bucket
  ``floor_div(v, interval) - base`` of an int32 column, int32 counts and
  f32 sums, mins and maxs;
- ``aggs_ordinal_counts_plane`` (K22) and ``aggs_histogram_plane`` (K23):
  the same for P plans over a whole columns plane in one launch.

Counts, mins and maxs do not depend on the order of their terms. The
sums do once a bucket's running sum passes 2^24, and the JAX package adds
each bucket's terms in row order on the CPU, so both the kernels and the
plain versions add in row order: the kernels after a stable counting sort
by bucket, the plain versions with a CPU ``index_add_`` (a serial loop in
index order), so the three agree bit for bit. A wrapper launches its
kernel for CUDA tensors and runs the plain version for CPU tensors; there
is no fallback between the two.
"""

from __future__ import annotations

from typing import Tuple

import torch

from elasticsearch_tpu_torch.ops.bm25 import (
    _check, _on_cuda, _ptr, _stream, launch_kernel,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

__all__ = ["ordinal_counts", "histogram_partials", "ordinal_counts_plane",
           "histogram_partials_plane", "histogram_scratch_bytes"]

# csrc/aggs_histogram.cuh: rows a counting-sort chunk holds at least, and
# the entries its [P, n_chunks, n_buckets] count table may take
HIST_ROWS_PER_CHUNK = 4096
HIST_TABLE_BUDGET = 1 << 26

_SIG = {
    "aggs_ordinal_counts": ["p", "p", "p", "ll", "ll", "i", "p", "p"],
    "aggs_ordinal_counts_plane": ["p", "p", "p", "ll", "ll", "i", "i", "p",
                                  "p"],
    "aggs_histogram": ["p"] * 5 + ["ll", "i", "i"] + ["p"] * 8,
    "aggs_histogram_plane": ["p"] * 5 + ["ll", "i", "i", "i"] + ["p"] * 8,
}

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# plain versions (run for CPU tensors; chip_smoke.py holds the kernels
# against them on the card)
# ---------------------------------------------------------------------------

def ordinal_counts_plane_plain(ords, owners, masks,
                               n_buckets: int) -> torch.Tensor:
    base_ok = (ords >= 0) & (ords < n_buckets)
    safe = torch.where(base_ok, ords, torch.zeros_like(ords)).long()
    own = owners.long()
    out = torch.zeros(masks.shape[0], n_buckets, dtype=torch.int32,
                      device=ords.device)
    for p in range(masks.shape[0]):
        valid = masks[p][own] & base_ok
        out[p].index_add_(0, safe[valid], torch.ones_like(safe[valid],
                                                          dtype=torch.int32))
    return out


def ordinal_counts_plain(ords, owners, mask, n_buckets: int) -> torch.Tensor:
    return ordinal_counts_plane_plain(ords, owners, mask[None, :],
                                      n_buckets)[0]


def histogram_partials_plane_plain(values, exists, masks, bases, intervals,
                                   n_buckets: int) -> Partials:
    dev = values.device
    n_plans = masks.shape[0]
    counts = torch.zeros(n_plans, n_buckets, dtype=torch.int32, device=dev)
    sums = torch.zeros(n_plans, n_buckets, dtype=torch.float32)
    mins = torch.full((n_plans, n_buckets), torch.inf, device=dev)
    maxs = torch.full((n_plans, n_buckets), -torch.inf, device=dev)
    vals = values.long()
    vf = values.float()
    for p in range(n_plans):
        interval = int(intervals[p])
        if interval <= 0:
            continue
        ids = torch.div(vals, interval, rounding_mode="floor") - int(bases[p])
        ok = exists & masks[p] & (ids >= 0) & (ids < n_buckets)
        rows = torch.nonzero(ok)[:, 0]          # ascending row order
        b = ids[rows]
        v = vf[rows]
        counts[p].index_add_(0, b, torch.ones_like(b, dtype=torch.int32))
        mins[p].scatter_reduce_(0, b, v, "amin")
        maxs[p].scatter_reduce_(0, b, v, "amax")
        # a CPU index_add_ over a 1-d row adds in index order, one f32 add
        # at a time: each bucket's terms in row order
        sums[p].index_add_(0, b.cpu(), v.cpu())
    return counts, sums.to(dev), mins, maxs


def histogram_partials_plain(values, exists, mask, base: int, interval: int,
                             n_buckets: int) -> Partials:
    dev = values.device
    out = histogram_partials_plane_plain(
        values, exists, mask[None, :],
        torch.tensor([base], dtype=torch.int32, device=dev),
        torch.tensor([interval], dtype=torch.int32, device=dev), n_buckets)
    return tuple(t[0] for t in out)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_table(ords, owners) -> int:
    if ords.dim() != 1:
        raise ValueError(f"[ords] must be 1-d, got {tuple(ords.shape)}")
    e = ords.shape[0]
    _check("ords", ords, torch.int32, (e,))
    _check("owners", owners, torch.int32, (e,))
    return e


def _check_buckets(n_buckets: int) -> None:
    if n_buckets < 1:
        raise ValueError(f"n_buckets={n_buckets} must be >= 1")


def _check_masks(masks, n: int) -> int:
    if masks.dim() != 2 or masks.shape[1] != n:
        raise ValueError(f"[masks] must be [P, {n}], got "
                         f"{tuple(masks.shape)}")
    n_plans = masks.shape[0]
    _check("masks", masks, torch.bool, (n_plans, n))
    if not 1 <= n_plans <= 65535:
        raise ValueError(f"{n_plans} plans; 1 to 65535 are taken")
    return n_plans


def hist_rows_per_chunk(n: int, n_plans: int, n_buckets: int) -> int:
    """Rows a counting-sort chunk holds: HIST_ROWS_PER_CHUNK, or more so
    that the [P, n_chunks, n_buckets] count table stays within
    HIST_TABLE_BUDGET entries; a multiple of 32 (one warp places them)."""
    max_chunks = max(1, HIST_TABLE_BUDGET // (n_plans * n_buckets))
    rows = max(HIST_ROWS_PER_CHUNK, -(-n // max_chunks))
    return -(-rows // 32) * 32


def histogram_scratch_bytes(n: int, n_plans: int, n_buckets: int) -> int:
    """Device bytes a K21 / K23 launch over ``n`` rows allocates besides
    its outputs: the [P, n_chunks, n_buckets] chunk counts, the
    [P, n_buckets] bucket offsets and the [P, n] values in bucket order
    (``_launch_hist``)."""
    n_chunks = -(-n // hist_rows_per_chunk(n, n_plans, n_buckets))
    return 4 * n_plans * (n_chunks * n_buckets + n_buckets + n)


def _launch_counts(family: str, ords, owners, masks, n_docs: int,
                   n_buckets: int, plane: bool) -> torch.Tensor:
    e = ords.shape[0]
    n_plans = masks.shape[0] if plane else 1
    counts = torch.empty(n_plans, n_buckets, dtype=torch.int32,
                         device=ords.device)
    extra = [n_plans] if plane else []
    launch_kernel(family, _SIG[family], _ptr(ords), _ptr(owners),
                  _ptr(masks), e, n_docs, *extra, n_buckets, _ptr(counts),
                  _stream())
    return counts if plane else counts[0]


def ordinal_counts(ords, owners, mask, n_buckets: int) -> torch.Tensor:
    """K20. int32 [n_buckets]: per ordinal, the entries of a deduped
    (owner, ord) table (``ords`` / ``owners`` [E] int32, ords -1 padded,
    owners in [0, N)) whose ordinal is in [0, n_buckets) and whose owner
    matched (``mask`` [N] bool, gathered at the owners here)."""
    cuda = _on_cuda(ords, owners, mask)
    e = _check_table(ords, owners)
    if mask.dim() != 1:
        raise ValueError(f"[mask] must be 1-d, got {tuple(mask.shape)}")
    n = mask.shape[0]
    _check("mask", mask, torch.bool, (n,))
    _check_buckets(n_buckets)
    with DEVICE_PROFILE.call("aggs_ordinal_counts",
                             f"e={e}/n={n}/n_buckets={n_buckets}", cuda):
        if not cuda:
            return ordinal_counts_plain(ords, owners, mask, n_buckets)
        return _launch_counts("aggs_ordinal_counts", ords, owners, mask, n,
                              n_buckets, plane=False)


def ordinal_counts_plane(ords, owners, masks, n_buckets: int
                         ) -> torch.Tensor:
    """K22. int32 [P, n_buckets]: ``ordinal_counts`` for each of the P
    query masks ``masks`` [P, N_pad] bool over a columns plane's table of
    GLOBAL ordinals, in one launch."""
    cuda = _on_cuda(ords, owners, masks)
    e = _check_table(ords, owners)
    if masks.dim() != 2:
        raise ValueError(f"[masks] must be 2-d, got {tuple(masks.shape)}")
    n = masks.shape[1]
    n_plans = _check_masks(masks, n)
    _check_buckets(n_buckets)
    with DEVICE_PROFILE.call(
            "aggs_ordinal_counts_plane",
            f"e={e}/n={n}/p={n_plans}/n_buckets={n_buckets}", cuda):
        if not cuda:
            return ordinal_counts_plane_plain(ords, owners, masks, n_buckets)
        return _launch_counts("aggs_ordinal_counts_plane", ords, owners,
                              masks, n, n_buckets, plane=True)


def _check_column(values, exists) -> int:
    if values.dim() != 1:
        raise ValueError(f"[values] must be 1-d, got {tuple(values.shape)}")
    n = values.shape[0]
    _check("values", values, torch.int32, (n,))
    _check("exists", exists, torch.bool, (n,))
    if n < 1:
        raise ValueError("empty column")
    return n


def _launch_hist(family: str, values, exists, masks, bases, intervals,
                 n_plans: int, n_buckets: int, plane: bool) -> Partials:
    dev = values.device
    n = values.shape[0]
    rows = hist_rows_per_chunk(n, n_plans, n_buckets)
    n_chunks = -(-n // rows)
    cc = torch.empty(n_plans * n_chunks * n_buckets, dtype=torch.int32,
                     device=dev)
    offsets = torch.empty(n_plans * n_buckets, dtype=torch.int32,
                          device=dev)
    ordered = torch.empty(n_plans * n, dtype=torch.float32, device=dev)
    counts = torch.empty(n_plans, n_buckets, dtype=torch.int32, device=dev)
    sums, mins, maxs = (torch.empty(n_plans, n_buckets, dtype=torch.float32,
                                    device=dev) for _ in range(3))
    extra = [n_plans] if plane else []
    launch_kernel(family, _SIG[family], _ptr(values), _ptr(exists),
                  _ptr(masks), _ptr(bases), _ptr(intervals), n, *extra,
                  n_buckets, rows, _ptr(cc), _ptr(offsets), _ptr(ordered),
                  _ptr(counts), _ptr(sums), _ptr(mins), _ptr(maxs),
                  _stream())
    if plane:
        return counts, sums, mins, maxs
    return counts[0], sums[0], mins[0], maxs[0]


def histogram_partials(values, exists, mask, base: int, interval: int,
                       n_buckets: int) -> Partials:
    """K21. (counts int32, sums f32, mins f32, maxs f32), each
    [n_buckets]: per bucket ``floor_div(v, interval) - base`` of the rows
    of ``values`` [N] int32 that exist and match (``exists`` / ``mask``
    [N] bool); other buckets are dropped, empty ones hold +inf / -inf as
    min / max. Sums add each bucket's values in row order. Exact for
    integral |v| < 2^24 (the callers' gate)."""
    cuda = _on_cuda(values, exists, mask)
    n = _check_column(values, exists)
    _check("mask", mask, torch.bool, (n,))
    _check_buckets(n_buckets)
    if interval <= 0:
        raise ValueError(f"interval={interval} must be > 0")
    with DEVICE_PROFILE.call(
            "aggs_histogram",
            f"n={n}/interval={interval}/n_buckets={n_buckets}", cuda):
        if not cuda:
            return histogram_partials_plain(values, exists, mask, base,
                                            interval, n_buckets)
        dev = values.device
        scal = torch.tensor([base, interval], dtype=torch.int32).to(dev)
        return _launch_hist("aggs_histogram", values, exists, mask,
                            scal[0:1], scal[1:2], 1, n_buckets, plane=False)


def histogram_partials_plane(values, exists, masks, bases, intervals,
                             n_buckets: int) -> Partials:
    """K23. ``histogram_partials`` for each of the P plans ``masks``
    [P, N_pad] bool with their ``bases`` / ``intervals`` [P] int32 (an
    interval <= 0 counts nothing) over a columns plane, in one launch:
    four [P, n_buckets] arrays. Each bucket's sum runs over the whole
    plane in row order."""
    cuda = _on_cuda(values, exists, masks, bases, intervals)
    n = _check_column(values, exists)
    n_plans = _check_masks(masks, n)
    _check("bases", bases, torch.int32, (n_plans,))
    _check("intervals", intervals, torch.int32, (n_plans,))
    _check_buckets(n_buckets)
    with DEVICE_PROFILE.call("aggs_histogram_plane",
                             f"n={n}/p={n_plans}/n_buckets={n_buckets}",
                             cuda):
        if not cuda:
            return histogram_partials_plane_plain(values, exists, masks,
                                                  bases, intervals,
                                                  n_buckets)
        return _launch_hist("aggs_histogram_plane", values, exists, masks,
                            bases, intervals, n_plans, n_buckets, plane=True)
