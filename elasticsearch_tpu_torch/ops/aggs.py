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
each bucket's terms in row order on the CPU, so the plain versions add in
row order with a CPU ``index_add_`` (a serial loop in index order). The
kernels add in row order only where it can matter: a bucket whose |v| sum
is at most 2^24 has an exact integer sum whatever the order
(``csrc/aggs_histogram.cuh`` section 1 proves it), the others' rows are
sorted stably by bucket and added one rounded f32 add at a time.
``histogram_partials_plane_mirror`` is that arithmetic on the CPU; the
three agree bit for bit. A wrapper launches its kernel for CUDA tensors
and runs the plain version for CPU tensors; there is no fallback between
the two.
"""

from __future__ import annotations

from typing import Tuple

import torch

from elasticsearch_tpu_torch.ops.bm25 import (
    _check, _on_cuda, _ptr, _stream, launch_kernel,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

__all__ = ["ordinal_counts", "histogram_partials", "ordinal_counts_plane",
           "histogram_partials_plane", "histogram_scratch_bytes",
           "histogram_probe"]

# csrc/aggs_histogram.cuh: rows a sort chunk holds at least (a multiple of
# the CTA's threads), and the entries its [P, n_chunks, n_buckets] look-back
# table may take; a bucket is exact when its |v| sum is at most EXACT_LIMIT
HIST_ROWS_PER_CHUNK = 4096
HIST_TABLE_BUDGET = 1 << 26
HIST_THREADS = 256
EXACT_LIMIT = 1 << 24
HIST_MAX_ROWS = (1 << 30) - 1

_SIG = {
    "aggs_ordinal_counts": ["p", "p", "p", "ll", "ll", "i", "p", "p"],
    "aggs_ordinal_counts_plane": ["p", "p", "p", "ll", "ll", "i", "i", "p",
                                  "p"],
    "aggs_histogram": ["p"] * 3 + ["i", "i", "ll", "i", "i"] + ["p"] * 8,
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


def histogram_partials_plane_mirror(values, exists, masks, bases, intervals,
                                    n_buckets: int):
    """The kernels' arithmetic on the CPU (``csrc/aggs_histogram.cuh``):
    counts, mins and maxs from the int32 values (int64 here; f32 of the
    integer min / max), a bucket whose |v| sum is at most EXACT_LIMIT summed
    exactly in int64 and converted once, every other ("chain") bucket's
    values added one rounded f32 add at a time in row order. Returns the
    four [P, n_buckets] partials and the chain buckets ([P, n_buckets]
    bool); the partials equal ``histogram_partials_plane_plain``'s bit for
    bit."""
    vals = values.long().cpu()
    ex = exists.cpu()
    n_plans = masks.shape[0]
    counts = torch.zeros(n_plans, n_buckets, dtype=torch.int32)
    sums = torch.zeros(n_plans, n_buckets, dtype=torch.float32)
    mins = torch.full((n_plans, n_buckets), torch.inf)
    maxs = torch.full((n_plans, n_buckets), -torch.inf)
    chain = torch.zeros(n_plans, n_buckets, dtype=torch.bool)
    for p in range(n_plans):
        interval = int(intervals[p])
        if interval <= 0:
            continue
        ids = torch.div(vals, interval, rounding_mode="floor") - int(bases[p])
        ok = ex & masks[p].cpu() & (ids >= 0) & (ids < n_buckets)
        rows = torch.nonzero(ok)[:, 0]          # ascending row order
        b, v = ids[rows], vals[rows]
        cnt = torch.zeros(n_buckets, dtype=torch.int64).index_add_(
            0, b, torch.ones_like(b))
        lo = torch.full((n_buckets,), 1 << 40).scatter_reduce_(0, b, v,
                                                               "amin")
        hi = torch.full((n_buckets,), -(1 << 40)).scatter_reduce_(0, b, v,
                                                                  "amax")
        exact = torch.zeros(n_buckets, dtype=torch.int64).index_add_(0, b, v)
        mag = torch.zeros(n_buckets, dtype=torch.int64).index_add_(
            0, b, v.abs())
        seen = cnt > 0
        counts[p] = cnt.int()
        mins[p] = torch.where(seen, lo.float(), mins[p])
        maxs[p] = torch.where(seen, hi.float(), maxs[p])
        chain[p] = seen & (mag > EXACT_LIMIT)
        sums[p] = torch.where(chain[p], sums[p], exact.float())
        on = chain[p][b]
        # the chain buckets: a CPU index_add_ adds in index order, one
        # rounded f32 add at a time from +0.0
        sums[p].index_add_(0, b[on], v[on].float())
    dev = values.device
    return ((counts.to(dev), sums.to(dev), mins.to(dev), maxs.to(dev)),
            chain.to(dev))


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
    """Rows a sort chunk holds: HIST_ROWS_PER_CHUNK, or more so that the
    [P, n_chunks, n_buckets] look-back table stays within
    HIST_TABLE_BUDGET entries; a multiple of HIST_THREADS (each of the
    CTA's warps ranks an equal slice)."""
    max_chunks = max(1, HIST_TABLE_BUDGET // (n_plans * n_buckets))
    rows = max(HIST_ROWS_PER_CHUNK, -(-n // max_chunks))
    return -(-rows // HIST_THREADS) * HIST_THREADS


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def histogram_scratch_bytes(n: int, n_plans: int, n_buckets: int) -> int:
    """Device bytes a K21 / K23 launch over ``n`` rows allocates besides
    its outputs: ``csrc/aggs_histogram.cuh`` ``layout`` -- a header, the
    [P, n_buckets] statistics, the [P, n_chunks, n_buckets] look-back
    words, the chain buckets' ids, regions, counts and list, the
    [P, n + 4 n_buckets] values of the chain buckets in bucket order."""
    n_chunks = -(-n // hist_rows_per_chunk(n, n_plans, n_buckets))
    cells = n_plans * n_buckets
    stride = -(-(n + 4 * n_buckets) // 4) * 4
    sizes = (4 * cells, 4 * cells, 4 * cells, 8 * cells,
             4 * cells * n_chunks, 4 * cells, 8 * cells, 4 * cells,
             4 * cells, 4 * n_plans, 4 * cells, 4 * n_plans * stride)
    return _up16(64) + sum(_up16(x) for x in sizes)


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
                 n_plans: int, n_buckets: int, host=None, split=None
                 ) -> Partials:
    """One K21 / K23 call (``bases`` / ``intervals``: ints for K21, [P]
    int32 tensors for K23); ``host`` / ``split`` (ctypes arrays) receive
    the probe's readings."""
    dev = values.device
    n = values.shape[0]
    if n > HIST_MAX_ROWS:
        raise ValueError(f"{n} rows; at most {HIST_MAX_ROWS} are taken")
    rows = hist_rows_per_chunk(n, n_plans, n_buckets)
    ws = torch.empty(histogram_scratch_bytes(n, n_plans, n_buckets),
                     dtype=torch.uint8, device=dev)
    counts = torch.empty(n_plans, n_buckets, dtype=torch.int32, device=dev)
    sums, mins, maxs = (torch.empty(n_plans, n_buckets, dtype=torch.float32,
                                    device=dev) for _ in range(3))
    plane = family == "aggs_histogram_plane"
    if plane:
        head = [_ptr(bases), _ptr(intervals), n, n_plans]
    else:
        head = [int(bases), int(intervals), n]
    launch_kernel(family, _SIG[family], _ptr(values), _ptr(exists),
                  _ptr(masks), *head, n_buckets, rows, _ptr(ws),
                  _ptr(counts), _ptr(sums), _ptr(mins), _ptr(maxs), host,
                  split, _stream())
    if plane:
        return counts, sums, mins, maxs
    return counts[0], sums[0], mins[0], maxs[0]


HIST_STAGES = ("memset", "sort", "chains")


def histogram_probe(values, exists, masks, bases, intervals, n_buckets: int,
                    plane: bool) -> dict:
    """K21 (``plane`` False: ``masks`` the [N] mask, ``bases`` /
    ``intervals`` ints) or K23 on the card, uncounted: its outputs
    (``out``), each operation's event ms (``split_ms``: the memset, the
    cooperative sort launch, the chains; ``sort_ns``: that launch's
    counting, offsets and sort passes by the card's clock), the chain
    buckets, the rows of the longest chain and the chains of at least
    16,384 rows (run first)."""
    import ctypes
    host = (ctypes.c_longlong * 6)()
    split = (ctypes.c_float * 3)()
    family = "aggs_histogram_plane" if plane else "aggs_histogram"
    n_plans = masks.shape[0] if plane else 1
    out = _launch_hist(family, values, exists, masks, bases, intervals,
                       n_plans, n_buckets, host, split)
    return {"out": out,
            "split_ms": dict(zip(HIST_STAGES, (float(x) for x in split))),
            "sort_ns": dict(zip(("count", "offsets", "place"),
                                (int(x) for x in host[3:6]))),
            "chain_buckets": int(host[0]), "longest_chain": int(host[1]),
            "long_chains": int(host[2])}


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
        return _launch_hist("aggs_histogram", values, exists, mask, base,
                            interval, 1, n_buckets)


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
                            bases, intervals, n_plans, n_buckets)
