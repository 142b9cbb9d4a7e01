"""IVF approximate nearest neighbour on the card.

The JAX package's ``ops/ivf.py``: an IVF (inverted-file) index, the
design that stands in for HNSW there (the reference snapshot has no ANN).
Search is two passes -- score the queries against the ``[nlist, D]``
centroid matrix and keep the top ``nprobe`` lists, then score every slot
of those padded lists exactly and keep the top-k -- and the build is
k-means (farthest-point seeding, then Lloyd iterations of assign +
update) followed by a balanced packing on the host.

Four kernel families, each a hand-written CUDA kernel
(``csrc/<family>.cu``) behind a wrapper, with its plain PyTorch version
beside it:

- ``ivf_assign`` (K11, ``_assign``): each row's nearest centroid,
  argmin of c2 - 2 * dot with bf16 operands and f32 sums -- on the card a
  screen on the tensor cores, then an exact re-score of the centroids it
  cannot rule out (``screen_bound`` and ``screen_candidates`` below are
  the screen's bound and choice in plain PyTorch);
- ``ivf_update`` (K12, ``_update``): per-cluster means, summed in
  ascending row order (no float atomics);
- ``ivf_init`` (K13, ``_farthest_point_init``): the farthest-point seeding
  loop, one cooperative launch for all nlist - 1 steps, which skips the
  rows a proven test shows the new centroid cannot bring nearer
  (``init_skip`` and ``ivf_init_pruned_plain`` below are that test and
  that seeding in plain PyTorch);
- ``ivf_search`` (K14, ``_ivf_search``): the probe, reading each probed
  list once a launch (and the centroids once for up to 64 queries), with
  the top-k kept per
  (query, probe) and merged per query (``ivf_search_grouped_plain`` below
  is that order in plain PyTorch).

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; there is no fallback between the two. Every sum that
decides an output is taken in an order that the plain version repeats
with tensor ops (dimension order for the dots of K11's re-score and of
K14 and the centroid norms, ascending row order for K12's sums, a fixed
32-lane order for K13's distances), and every other op is one rounded
f32 op, so kernel and plain version agree bit for bit. Ties follow the
JAX programs: argmin / argmax take the first index, and the top-k orders
by score, then position.

The host code (``kmeans``'s sampling, ``IVFIndex.build``'s balanced
packing, ``probe_live``'s demux) is the JAX package's, line for line, so
both packages take the same subsample and the same first point and pack
the same lists from the same assignment.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.ops.bm25 import (
    _check, _on_cuda, _ptr, _stream, launch_kernel, stable_topk,
)
from elasticsearch_tpu_torch.ops.knn import (
    KMAX, MAX_DIMS, QueryBatch, _bf16, _flat_dots, _sim_code, _similarity,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE

# rows per assignment launch: the [chunk, nlist] distance plane of the JAX
# program at a GIST1M-class build (nlist 4,096) is 2 GB at 128K rows
ASSIGN_CHUNK = 1 << 17
# csrc/ivf_update.cu ROWS_PER_CHUNK (the counting sort's chunk)
UPDATE_CHUNK = 4096
# csrc/ivf_assign.cu: BK (dims a stage of the tensor-core screen; the
# padded width enters its bound) and CAND (centroids it lists a row)
SCREEN_BK = 64
SCREEN_CAND = 32
# csrc/ivf_search.cu KCAP: the most entries a (query, probe) partial keeps;
# a wider k takes the wide path
SEARCH_KCAP = 256
_U = 2.0 ** -24
_SCREEN_ABS = 2.0 ** -100
# K13's absolute slack: the underflow of D squares (each <= 2^-150)
_INIT_ABS = 2.0 ** -100
_SCRATCH = []

_SIG = {
    "ivf_assign": ["p", "p", "i", "i", "i"] + ["p"] * 11,
    "ivf_update": ["p", "p", "p", "ll", "i", "i"] + ["p"] * 6,
    "ivf_init": ["p", "ll", "i", "ll", "i", "d", "d"] + ["p"] * 10,
    "ivf_search": ["p"] * 8 + ["i"] * 7 + ["p"] * 4,
}


def _check_matrix(name: str, t: torch.Tensor) -> Tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"[{name}] must be 2-d, got {tuple(t.shape)}")
    _check(name, t, torch.float32, t.shape)
    if not 1 <= t.shape[1] <= MAX_DIMS:
        raise ValueError(f"[{name}] dims {t.shape[1]} outside "
                         f"[1, {MAX_DIMS}]")
    if t.shape[0] < 1:
        raise ValueError(f"[{name}] has no rows")
    return t.shape[0], t.shape[1]


def _col_sum_sq(m: torch.Tensor) -> torch.Tensor:
    """[rows] f32: sum_d m[:, d] * m[:, d] in dimension order, the product
    and the sum each rounded."""
    acc = torch.zeros(m.shape[0], dtype=torch.float32, device=m.device)
    for d in range(m.shape[1]):
        acc = acc + m[:, d] * m[:, d]
    return acc


# ---------------------------------------------------------------------------
# plain versions (run for CPU tensors; chip_smoke.py holds the kernels
# against them on the card)
# ---------------------------------------------------------------------------

def ivf_assign_plain(x: torch.Tensor, centroids: torch.Tensor
                     ) -> torch.Tensor:
    c2 = _col_sum_sq(centroids)
    dots = _flat_dots(centroids, x)                   # [n, nlist]
    # c2 - 2 * dots, in place: -2 * dots is exact, and c2 + (-2 * dots)
    # rounds as c2 - 2 * dots does
    return torch.argmin(dots.mul_(-2.0).add_(c2[None, :]),
                        dim=1).to(torch.int32)


def screen_gamma(dims: int) -> float:
    """K11's bound on |dot_tc - dot_plain| / (|x^| |c^|): 5 D 2^-24
    (1 + 2^-8) over the padded width D (csrc/ivf_assign.cu's
    derivation)."""
    dp = -(-dims // SCREEN_BK) * SCREEN_BK
    return 5.0 * dp * _U * (1.0 + 2.0 ** -8)


def screen_norms(m: torch.Tensor) -> torch.Tensor:
    """[rows] f32: each bf16-rounded row's L2 norm inflated by 2^-10, as
    the screen's pre-pass writes it."""
    b = _bf16(m)
    return torch.sqrt((b * b).sum(dim=1)) * (1.0 + 2.0 ** -10)


def screen_bound(x: torch.Tensor, centroids: torch.Tensor,
                 c2: torch.Tensor) -> torch.Tensor:
    """[n, nlist] f32: the screen's E(c) = g1 |x^| |c^| + g2 c2[c] +
    2^-100, the most by which its t(c) = c2 - 2 dot_tc and t -/+ E may
    stand from the plain value."""
    widen = 1.0 + 2.0 ** -8
    g1 = (2.0 * screen_gamma(x.shape[1]) + 6.0 * _U) * widen
    g2 = 3.0 * _U * widen
    p = screen_norms(x)[:, None] * screen_norms(centroids)[None, :]
    return p * g1 + (c2 * g2 + _SCREEN_ABS)[None, :]


def screen_candidates(dots: torch.Tensor, x: torch.Tensor,
                      centroids: torch.Tensor) -> torch.Tensor:
    """bool [n, nlist]: the centroids the screen keeps for each row when
    its tensor-core sums are ``dots`` (any summation order of the bf16
    products): t(c) - E(c) <= min_c (t(c) + E(c))."""
    c2 = _col_sum_sq(centroids)
    t = c2[None, :] - 2.0 * dots
    e = screen_bound(x, centroids, c2)
    upper = (t + e).min(dim=1, keepdim=True).values
    return t - e <= upper


def ivf_assign_screened(dots: torch.Tensor, x: torch.Tensor,
                        centroids: torch.Tensor) -> torch.Tensor:
    """int32 [n]: K11's answer from screen sums ``dots``: the plain value's
    argmin (first index on ties) over each row's screened centroids, or
    over all of them where more than SCREEN_CAND pass."""
    keep = screen_candidates(dots, x, centroids)
    keep[keep.sum(dim=1) > SCREEN_CAND] = True
    c2 = _col_sum_sq(centroids)
    v = _flat_dots(centroids, x).mul_(-2.0).add_(c2[None, :])
    v = torch.where(keep, v, torch.full((), torch.inf, device=v.device))
    return torch.argmin(v, dim=1).to(torch.int32)


def ivf_update_plain(x: torch.Tensor, assign: torch.Tensor,
                     centroids: torch.Tensor) -> torch.Tensor:
    nlist = centroids.shape[0]
    a = assign.long()
    keep = (a >= 0) & (a < nlist)           # segment_sum drops the rest
    rows = torch.nonzero(keep).flatten()
    a = a[rows]
    counts = torch.bincount(a, minlength=nlist)
    order = rows[torch.argsort(a, stable=True)]        # by cluster, rows asc
    starts = torch.cumsum(counts, 0) - counts
    sums = torch.zeros_like(centroids)
    # the r-th row of every cluster that has one, added in rank order: the
    # rows of a cluster are summed in ascending row order
    for r in range(int(counts.max()) if len(rows) else 0):
        cl = torch.nonzero(counts > r).flatten()
        sums[cl] = sums[cl] + x[order[starts[cl] + r]]
    fresh = sums / torch.clamp_min(counts, 1).to(torch.float32)[:, None]
    return torch.where((counts > 0)[:, None], fresh, centroids)


def _lane_dist(xp: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[n] f32 |x - c|^2 in ivf_init's order: xp [n, M, 32] (the dims
    zero-padded to M * 32), lane l sums the dims l, l + 32, ... in order,
    then the 32 lane sums are added as a halving tree."""
    cp = c.reshape(xp.shape[1], 32)
    acc = torch.zeros(xp.shape[0], 32, dtype=torch.float32, device=xp.device)
    for m in range(xp.shape[1]):
        diff = xp[:, m, :] - cp[m]
        acc = acc + diff * diff
    h = 16
    while h >= 1:
        acc = acc[:, :h] + acc[:, h: 2 * h]
        h //= 2
    return acc[:, 0]


def ivf_init_plain(x: torch.Tensor, first: int, nlist: int
                   ) -> torch.Tensor:
    n, d = x.shape
    m = -(-d // 32)
    xp = torch.zeros(n, m * 32, dtype=torch.float32, device=x.device)
    xp[:, :d] = x
    xp = xp.reshape(n, m, 32)
    cents = torch.zeros(nlist, d, dtype=torch.float32, device=x.device)
    cents[0] = x[first]
    d2 = _lane_dist(xp, xp[first].reshape(-1))
    for i in range(1, nlist):
        idx = int(torch.argmax(d2))
        cents[i] = x[idx]
        if i + 1 < nlist:
            d2 = torch.minimum(d2, _lane_dist(xp, xp[idx].reshape(-1)))
    return cents


def init_margin(dims: int) -> Tuple[float, float]:
    """K13's skip test constants (csrc/ivf_init.cu's derivation): (F, lo)
    with F >= 4 / (1 - 2^-24)^K, K = ceil(D / 32) + 8 roundings of the
    plain f32 distance, padded by 2^-30 for the test's own f64 rounding,
    and lo <= 1 / (1 + 2^-53)^(D + 1), the f64 centroid distance's
    relative error."""
    k = -(-dims // 32) + 8
    return (4.0 / (1.0 - _U) ** k * (1.0 + 2.0 ** -30),
            1.0 - (dims + 4) * 2.0 ** -52)


def init_skip(cd: torch.Tensor, d2: torch.Tensor, dims: int
              ) -> torch.Tensor:
    """bool: K13 skips a row -- its plain f32 distance to the new centroid
    c_i cannot fall below its d2 -- when d2 is 0, or when the squared
    distance cd (f64) between c_i and the centroid that set d2 is more
    than 4 (d2 + 2^-100) times the f32 sum's error factor: the triangle
    inequality then puts the row at least as far from c_i as from its
    own centroid."""
    f, lo = init_margin(dims)
    d2 = d2.double()
    return (d2 == 0) | (cd.double() * lo > f * (d2 + _INIT_ABS))


def centroid_dists(cents: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[m] f64: |cents[j] - c|^2 summed in f64 (any order: the bound of
    ``init_margin`` holds for every order)."""
    diff = cents.double() - c.double()[None, :]
    return (diff * diff).sum(dim=1)


def ivf_init_pruned_plain(x: torch.Tensor, first: int, nlist: int
                          ) -> Tuple[torch.Tensor, list]:
    """K13's pruned seeding in plain PyTorch: ``ivf_init_plain``'s answer
    (bitwise, when ``init_skip`` is conservative) and the rows whose
    distance each step computed (the first step computes all of them).
    Each row keeps the index of a centroid whose distance equals its d2
    (its owner); a step skips the rows ``init_skip`` clears against the
    new centroid's distance to their owner -- the first step, every 16th,
    and every step after one that computed under 15/16 of the rows, as
    the kernel decides; the others compute every row. For the tests and
    measurements; the main path calls the kernel."""
    n, d = x.shape
    m = -(-d // 32)
    xp = torch.zeros(n, m * 32, dtype=torch.float32, device=x.device)
    xp[:, :d] = x
    xp = xp.reshape(n, m, 32)
    cents = torch.zeros(nlist, d, dtype=torch.float32, device=x.device)
    cents[0] = x[first]
    d2 = _lane_dist(xp, xp[first].reshape(-1))
    owner = torch.zeros(n, dtype=torch.int64, device=x.device)
    computed = [n]
    for i in range(1, nlist):
        idx = int(torch.argmax(d2))
        cents[i] = x[idx]
        if i + 1 == nlist:
            break
        if i == 1 or i % 16 == 0 or 16 * computed[-1] < 15 * n:
            cd = centroid_dists(cents[:i], x[idx])
            rows = torch.nonzero(~init_skip(cd[owner], d2, d)).flatten()
        else:
            rows = torch.arange(n, device=x.device)
        t = _lane_dist(xp[rows], xp[idx].reshape(-1))
        lower = t < d2[rows]
        d2[rows] = torch.minimum(d2[rows], t)
        owner[rows[lower]] = i
        computed.append(int(rows.numel()))
    return cents, computed


def ivf_search_plain(queries, qn, q2, centroids, lists, valid, ids, norms,
                     k: int, nprobe: int, similarity: str):
    n_q, dims = queries.shape
    list_len = lists.shape[1]
    cscores = _flat_dots(centroids, queries)          # [Q, nlist]
    if similarity == "l2_norm":
        cscores = 2.0 * cscores - _col_sum_sq(centroids)[None, :]
    _, probes = stable_topk(cscores, nprobe)          # [Q, nprobe]
    pl = probes.long()
    qb = _bf16(queries)
    dots = torch.zeros(n_q, nprobe * list_len, dtype=torch.float32,
                       device=queries.device)
    # the JAX program's [Q, nprobe, L, D] gather, a few queries at a time
    step = max(1, IVFIndex.GATHER_BYTES_BUDGET //
               max(nprobe * list_len * dims * 4, 1))
    for lo in range(0, n_q, step):
        hi = min(lo + step, n_q)
        blocks = _bf16(lists[pl[lo:hi]]).reshape(hi - lo, -1, dims)
        acc = torch.zeros(hi - lo, blocks.shape[1], dtype=torch.float32,
                          device=queries.device)
        for d in range(dims):
            acc = acc + qb[lo:hi, d:d + 1] * blocks[:, :, d]
        dots[lo:hi] = acc
        del blocks
    bnorms = norms[pl].reshape(n_q, -1)
    scores = _similarity(dots, bnorms, qn, q2, similarity)
    scores = torch.where(valid[pl].reshape(n_q, -1), scores,
                         torch.full((), -torch.inf, device=scores.device))
    top_s, pos = stable_topk(scores, k)
    top_i = torch.gather(ids[pl].reshape(n_q, -1), 1, pos.long())
    fin = torch.isfinite(top_s)
    top_i = torch.where(fin, top_i, torch.full_like(top_i, -1))
    top_s = torch.where(fin, top_s, torch.zeros_like(top_s))
    return top_s, top_i


def ivf_search_grouped_plain(queries, qn, q2, centroids, lists, valid, ids,
                             norms, k: int, nprobe: int, similarity: str,
                             splits: int = 1):
    """K14's list-grouped order in plain PyTorch: each (query, probe) scans
    its list in ``splits`` row ranges (the card's are its 128-row blocks,
    ceil(L / 128) of them) and keeps the best min(k, rows) slots of each
    range under (score desc, list position asc); a query's merge
    takes the top-k of those partials under (score desc, probe rank, list
    position) -- the flattened [nprobe, L] order of ``ivf_search_plain``,
    whose answer it must give. For the tests; the card runs the kernel."""
    n_q, dims = queries.shape
    list_len = lists.shape[1]
    cscores = _flat_dots(centroids, queries)
    if similarity == "l2_norm":
        cscores = 2.0 * cscores - _col_sum_sq(centroids)[None, :]
    _, probes = stable_topk(cscores, nprobe)
    pl = probes.long()
    qb = _bf16(queries)
    rows = -(-list_len // splits)
    part_s, part_f = [], []
    for p in range(nprobe):
        block = _bf16(lists[pl[:, p]])                   # [Q, L, D]
        dots = torch.zeros(n_q, list_len, dtype=torch.float32,
                           device=queries.device)
        for d in range(dims):
            dots = dots + qb[:, d:d + 1] * block[:, :, d]
        sc = _similarity(dots, norms[pl[:, p]], qn, q2, similarity)
        sc = torch.where(valid[pl[:, p]], sc,
                         torch.full((), -torch.inf, device=sc.device))
        for r0 in range(0, list_len, rows):
            seg = sc[:, r0: r0 + rows]
            s, pos = stable_topk(seg, min(k, seg.shape[1]))
            part_s.append(s)
            part_f.append(p * list_len + r0 + pos.long())
    cand_s, cand_f = torch.cat(part_s, 1), torch.cat(part_f, 1)
    order = torch.argsort(cand_f, dim=1, stable=True)
    cand_s = torch.gather(cand_s, 1, order)
    cand_f = torch.gather(cand_f, 1, order)
    top_s, j = stable_topk(cand_s, k)
    flat = torch.gather(cand_f, 1, j.long())
    lst = torch.gather(pl, 1, flat // list_len)
    top_i = ids[lst, flat % list_len]
    fin = torch.isfinite(top_s)
    return (torch.where(fin, top_s, torch.zeros_like(top_s)),
            torch.where(fin, top_i, torch.full_like(top_i, -1)))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def ivf_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """K11. int32 [n]: each row of x [n, D] f32 (n <= ASSIGN_CHUNK) to the
    centroid of centroids [nlist, D] f32 minimising
    c2 - 2 * dot(bf16 x, bf16 c) (f32 sums, c2 over the f32 centroids),
    the lowest index on ties."""
    cuda = _on_cuda(x, centroids)
    n, dims = _check_matrix("x", x)
    nlist, c_dims = _check_matrix("centroids", centroids)
    if c_dims != dims:
        raise ValueError(f"centroids have {c_dims} dims, the rows {dims}")
    if n > ASSIGN_CHUNK:
        raise ValueError(f"{n} rows in one launch; at most {ASSIGN_CHUNK}")
    with DEVICE_PROFILE.call("ivf_assign",
                             f"n={n}/nlist={nlist}/dims={dims}", cuda):
        if not cuda:
            return ivf_assign_plain(x, centroids)
        return _assign_on_card(x, centroids)[0]


def _assign_scratch(n: int, nlist: int, dims: int):
    """csrc/ivf_assign.cu ``ivf_assign_scratch``: the entries of the bf16
    row and centroid tiles, the row and centroid norms and the candidate
    lists."""
    if not _SCRATCH:
        from elasticsearch_tpu_torch._build import library
        fn = library("ivf_assign").ivf_assign_scratch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        _SCRATCH.append(fn)
    sizes = (ctypes.c_longlong * 5)()
    _SCRATCH[0](n, nlist, dims, sizes)
    return list(sizes)


def _assign_on_card(x: torch.Tensor, centroids: torch.Tensor,
                    probe: bool = False):
    """Launch K11 on CUDA tensors: (out [n] int32, candidates [n] int32,
    overflow [1] int32, the tensor cores' raw dots [n, nlist] f32 or
    None); ``ivf_assign_probe`` says what each holds."""
    n, dims = x.shape
    nlist = centroids.shape[0]
    dev = x.device
    n_xa, n_ca, n_xn, n_cn, n_cand = _assign_scratch(n, nlist, dims)
    f32, i32 = torch.float32, torch.int32
    c2 = torch.empty(nlist, dtype=f32, device=dev)
    xa = torch.empty(n_xa, dtype=torch.bfloat16, device=dev)
    ca = torch.empty(n_ca, dtype=torch.bfloat16, device=dev)
    xn = torch.empty(n_xn, dtype=f32, device=dev)
    cn = torch.empty(n_cn, dtype=f32, device=dev)
    cand_n = torch.empty(n, dtype=i32, device=dev)
    cand_i = torch.empty(n_cand, dtype=i32, device=dev)
    overflow = torch.empty(1, dtype=i32, device=dev)
    dots = torch.empty(n, nlist, dtype=f32, device=dev) if probe else None
    out = torch.empty(n, dtype=i32, device=dev)
    launch_kernel("ivf_assign", _SIG["ivf_assign"], _ptr(x),
                  _ptr(centroids), n, nlist, dims, _ptr(c2), _ptr(xa),
                  _ptr(ca), _ptr(xn), _ptr(cn), _ptr(cand_n), _ptr(cand_i),
                  _ptr(overflow), None if dots is None else _ptr(dots),
                  _ptr(out), _stream())
    return out, cand_n, overflow, dots


def ivf_assign_probe(x: torch.Tensor, centroids: torch.Tensor,
                     dots: bool = False):
    """K11 on CUDA tensors with what its screen did, for measuring it:
    (out [n] int32 as ``ivf_assign`` returns it; candidates [n] int32, the
    centroids listed a row, -1 where the list overflowed; overflow [1]
    int32, the rows re-scored against every centroid; with ``dots`` the
    tensor cores' raw dots [n, nlist] f32, else None). A measurement, not
    a main-path call: it is not counted as a launch."""
    if not _on_cuda(x, centroids):
        raise ValueError("ivf_assign_probe measures the card's kernel")
    n, dims = _check_matrix("x", x)
    nlist, c_dims = _check_matrix("centroids", centroids)
    if c_dims != dims or n > ASSIGN_CHUNK:
        raise ValueError("ivf_assign_probe takes ivf_assign's inputs")
    return _assign_on_card(x, centroids, probe=dots)


def ivf_update(x: torch.Tensor, assign: torch.Tensor,
               centroids: torch.Tensor) -> torch.Tensor:
    """K12. [nlist, D] f32: the mean of each cluster's rows of x [n, D]
    under ``assign`` [n] int32 (ids outside [0, nlist) dropped), summed in
    ascending row order; the previous centroid where a cluster is
    empty."""
    cuda = _on_cuda(x, assign, centroids)
    n, dims = _check_matrix("x", x)
    nlist, c_dims = _check_matrix("centroids", centroids)
    if c_dims != dims:
        raise ValueError(f"centroids have {c_dims} dims, the rows {dims}")
    _check("assign", assign, torch.int32, (n,))
    with DEVICE_PROFILE.call("ivf_update",
                             f"n={n}/nlist={nlist}/dims={dims}", cuda):
        if not cuda:
            return ivf_update_plain(x, assign, centroids)
        dev = x.device
        n_chunks = -(-n // UPDATE_CHUNK)
        cc = torch.empty(n_chunks * nlist, dtype=torch.int32, device=dev)
        counts = torch.empty(nlist, dtype=torch.int32, device=dev)
        offsets = torch.empty(nlist, dtype=torch.int32, device=dev)
        perm = torch.empty(n, dtype=torch.int32, device=dev)
        out = torch.empty(nlist, dims, dtype=torch.float32, device=dev)
        launch_kernel("ivf_update", _SIG["ivf_update"], _ptr(x),
                      _ptr(assign), _ptr(centroids), n, nlist, dims,
                      _ptr(cc), _ptr(counts), _ptr(offsets), _ptr(perm),
                      _ptr(out), _stream())
        return out


def ivf_init(x: torch.Tensor, first: int, nlist: int) -> torch.Tensor:
    """K13. [nlist, D] f32: farthest-point seeding over x [n, D] f32 from
    row ``first``: each next centroid is the row farthest from every
    centroid so far (the first index on ties)."""
    cuda = _on_cuda(x)
    n, dims = _check_matrix("x", x)
    first = int(first)
    if not 0 <= first < n:
        raise ValueError(f"first={first} outside [0, {n})")
    if nlist < 1:
        raise ValueError(f"nlist={nlist} must be >= 1")
    with DEVICE_PROFILE.call("ivf_init",
                             f"n={n}/nlist={nlist}/dims={dims}", cuda):
        if not cuda:
            return ivf_init_plain(x, first, nlist)
        return _init_on_card(x, first, nlist)[0]


def _init_grid(n: int, dims: int) -> int:
    """csrc/ivf_init.cu ``ivf_init_grid``: the CTAs of a launch (the
    partials' entries)."""
    from elasticsearch_tpu_torch._build import KernelError, library
    fn = library("ivf_init").ivf_init_grid
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    grid = ctypes.c_int()
    rc = fn(n, dims, ctypes.byref(grid))
    if rc != 0:
        raise KernelError(f"[ivf_init] grid query failed: CUDA error {rc}")
    return grid.value


def _init_on_card(x: torch.Tensor, first: int, nlist: int,
                  probe: bool = False):
    """Launch K13 on a CUDA tensor: (cents [nlist, D] f32, the rows each
    step computed [nlist] int64, SM cycles per CTA [grid, 3] int64 --
    scanning, the centroid distances, the barriers and argmax -- or
    None). One workspace holds d2, the owners, cd, the double-buffered
    partials, the barrier and the step counts."""
    n, dims = x.shape
    grid = _init_grid(n, dims)
    f, lo = init_margin(dims)
    # 8-byte words: cd [nlist] f64, d2 + owner [n] f32/int32, the
    # partials [2, grid] f32 + int32, the barrier, the step counts [nlist]
    ws = torch.empty(2 * nlist + n + 2 * grid + 1, dtype=torch.int64,
                     device=x.device)
    base = _ptr(ws)
    cd, d2 = base, base + 8 * nlist
    owner = d2 + 4 * n
    part_v = base + 8 * (nlist + n)
    part_i = part_v + 8 * grid
    bar = base + 8 * (nlist + n + 2 * grid)
    rows = ws[nlist + n + 2 * grid + 1:]
    cents = torch.empty(nlist, dims, dtype=torch.float32, device=x.device)
    cycles = torch.zeros(grid, 3, dtype=torch.int64, device=x.device) \
        if probe else None
    launch_kernel("ivf_init", _SIG["ivf_init"], _ptr(x), n, dims, first,
                  nlist, f, lo, d2, owner, cd, part_v, part_i, bar,
                  _ptr(cents), _ptr(rows),
                  None if cycles is None else _ptr(cycles), _stream())
    return cents, rows, cycles


def ivf_init_probe(x: torch.Tensor, first: int, nlist: int):
    """K13 on a CUDA tensor with what its pruning did, for measuring it:
    (cents as ``ivf_init`` returns them; the rows whose distance each
    step computed [nlist] int64, the first step all n; per CTA the SM
    cycles spent scanning, on the centroid distances, and at the barriers
    and the argmax [grid, 3] int64). A measurement, not a main-path call:
    it is not counted as a launch."""
    if not _on_cuda(x):
        raise ValueError("ivf_init_probe measures the card's kernel")
    n, dims = _check_matrix("x", x)
    if not 0 <= int(first) < n or nlist < 1:
        raise ValueError("ivf_init_probe takes ivf_init's inputs")
    return _init_on_card(x, int(first), nlist, probe=True)


@functools.lru_cache(maxsize=1024)
def _search_workspace(n_q: int, dims: int, nlist: int, list_len: int,
                      nprobe: int, k: int) -> int:
    """The workspace bytes of a K14 launch, from the kernel's own
    ``ivf_search_workspace``."""
    from elasticsearch_tpu_torch._build import library
    fn = library("ivf_search").ivf_search_workspace
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    nbytes = ctypes.c_longlong()
    fn(n_q, dims, nlist, list_len, nprobe, k, ctypes.byref(nbytes))
    return nbytes.value


def ivf_search(queries, qn, q2, centroids, lists, valid, ids, norms,
               k: int, nprobe: int, similarity: str = "cosine"):
    """K14. (scores [Q, k] f32, ids [Q, k] int32) of queries [Q, D] f32
    (with their ``qn`` / ``q2`` [Q], as ``QueryBatch`` computes them)
    probing the ``nprobe`` best of the centroids [nlist, D] and scanning
    those lists [nlist, L, D] in place (``valid``, ``ids``, ``norms``
    [nlist, L]); ids -1 and scores 0 where fewer than k slots are
    valid. Above k ``SEARCH_KCAP`` the card takes the wide path (a
    per-query plane of the probed slots), labelled ``/wide``."""
    cuda = _on_cuda(queries, qn, q2, centroids, lists, valid, ids, norms)
    n_q, dims = _check_matrix("queries", queries)
    nlist, c_dims = _check_matrix("centroids", centroids)
    if c_dims != dims or lists.dim() != 3 or lists.shape[0] != nlist or \
            lists.shape[2] != dims:
        raise ValueError(f"lists must be [{nlist}, L, {dims}], got "
                         f"{tuple(lists.shape)}")
    list_len = lists.shape[1]
    _check("lists", lists, torch.float32, (nlist, list_len, dims))
    _check("valid", valid, torch.bool, (nlist, list_len))
    _check("ids", ids, torch.int32, (nlist, list_len))
    _check("norms", norms, torch.float32, (nlist, list_len))
    _check("qn", qn, torch.float32, (n_q,))
    _check("q2", q2, torch.float32, (n_q,))
    n_cand = nprobe * list_len
    if not 1 <= nprobe <= min(nlist, KMAX):
        raise ValueError(f"nprobe={nprobe} outside [1, {min(nlist, KMAX)}]")
    if not 1 <= k <= n_cand:
        raise ValueError(f"k={k} outside [1, {n_cand}]")
    code = _sim_code(similarity)
    label = (f"n_q={n_q}/nlist={nlist}/L={list_len}/dims={dims}/"
             f"nprobe={nprobe}/k={k}" + ("/wide" if k > SEARCH_KCAP else ""))
    with DEVICE_PROFILE.call("ivf_search", label, cuda):
        if not cuda:
            return ivf_search_plain(queries, qn, q2, centroids, lists,
                                    valid, ids, norms, k, nprobe,
                                    similarity)
        dev = queries.device
        work = torch.empty(_search_workspace(n_q, dims, nlist, list_len,
                                             nprobe, k),
                           dtype=torch.uint8, device=dev)
        out_s = torch.empty(n_q, k, dtype=torch.float32, device=dev)
        out_i = torch.empty(n_q, k, dtype=torch.int32, device=dev)
        launch_kernel("ivf_search", _SIG["ivf_search"], _ptr(queries),
                      _ptr(qn), _ptr(q2), _ptr(centroids), _ptr(lists),
                      _ptr(valid), _ptr(ids), _ptr(norms), n_q, dims, nlist,
                      list_len, nprobe, k, code, _ptr(work), _ptr(out_s),
                      _ptr(out_i), _stream())
        return out_s, out_i


# ---------------------------------------------------------------------------
# k-means (device)
# ---------------------------------------------------------------------------

def assign_chunked(x: torch.Tensor, centroids: torch.Tensor, nlist: int
                   ) -> torch.Tensor:
    """ivf_assign in row chunks of ASSIGN_CHUNK, one launch each (the JAX
    package pads the tail to keep one compiled shape; a launch here takes
    the short tail as it is, with the same assignments)."""
    n = x.shape[0]
    if n <= ASSIGN_CHUNK:
        return ivf_assign(x, centroids)
    return torch.cat([ivf_assign(x[i: i + ASSIGN_CHUNK], centroids)
                      for i in range(0, n, ASSIGN_CHUNK)])


def _kmeans_device(x: torch.Tensor, vectors: np.ndarray, nlist: int,
                   iters: int, seed: int,
                   init_centroids: Optional[np.ndarray]) -> torch.Tensor:
    """kmeans over the rows already on the device (x) and on the host
    (vectors); [nlist, D] f32 on x's device."""
    n, d = vectors.shape
    rng = np.random.default_rng(seed)
    if n <= nlist:
        reps = np.resize(vectors.astype(np.float32), (nlist, d))
        return torch.as_tensor(reps, device=x.device)
    if init_centroids is not None and \
            init_centroids.shape == (nlist, d):
        c = torch.as_tensor(np.asarray(init_centroids, np.float32),
                            device=x.device)
        warm_iters = max(2, iters // 3)
        for _ in range(warm_iters):
            c = ivf_update(x, assign_chunked(x, c, nlist), c)
        return c
    # seed on a subsample to bound init cost at ~25*nlist points
    cap = min(n, max(25 * nlist, 2 * nlist))
    sample = (np.arange(n) if n <= cap
              else rng.choice(n, size=cap, replace=False))
    sampled = x[torch.as_tensor(sample, device=x.device)]
    c = ivf_init(sampled, int(rng.integers(len(sample))), nlist)
    del sampled
    for _ in range(iters):
        c = ivf_update(x, assign_chunked(x, c, nlist), c)
    return c


def kmeans(vectors: np.ndarray, nlist: int, iters: int = 10,
           seed: int = 17, init_centroids: Optional[np.ndarray] = None,
           device: DeviceLike = None) -> np.ndarray:
    """Farthest-point init + Lloyd's on the device; [nlist, D] f32
    centroids.

    ``init_centroids`` [nlist, D] warm-starts Lloyd's from a previous
    generation's solution (the plane registry's incremental-refresh
    case): an append-only refresh barely moves the optimal centroids, so
    seeding from them converges in a fraction of the cold iterations."""
    vectors = np.asarray(vectors, np.float32)
    x = torch.as_tensor(vectors, device=resolve_device(device))
    return _kmeans_device(x, vectors, nlist, iters, seed,
                          init_centroids).cpu().numpy()


# ---------------------------------------------------------------------------
# index build (host packing, device math)
# ---------------------------------------------------------------------------

class IVFIndex:
    """Padded inverted-file index over one vector corpus, on one device.

    centroids: [nlist, D]    float32
    lists:     [nlist, L, D] float32 (zero-padded)
    valid:     [nlist, L]    bool
    ids:       [nlist, L]    int32 (-1 where padded) -- original row indices
    norms:     [nlist, L]    float32 doc norms
    """

    def __init__(self, centroids, lists, valid, ids, similarity: str,
                 norms):
        self.centroids = centroids
        self.lists = lists
        self.valid = valid
        self.ids = ids
        self.similarity = similarity
        self.norms = norms
        self.nlist = int(centroids.shape[0])
        self.list_len = int(lists.shape[1])

    @property
    def device(self) -> torch.device:
        return self.lists.device

    @staticmethod
    def build(vectors: np.ndarray, nlist: Optional[int] = None,
              similarity: str = "cosine", iters: int = 10,
              slack: float = 1.5, seed: int = 17,
              init_centroids: Optional[np.ndarray] = None,
              device: DeviceLike = None) -> "IVFIndex":
        n, d = vectors.shape
        if n == 0:
            raise ValueError("cannot build an IVF index over zero vectors")
        if nlist is None:
            nlist = max(1, min(n, int(4 * np.sqrt(n))))
        nlist = max(1, min(nlist, n))
        vectors = np.asarray(vectors, np.float32)
        warm = init_centroids is not None and \
            np.asarray(init_centroids).shape == (nlist, d) and n > nlist
        dev = resolve_device(device)
        x = torch.as_tensor(vectors, device=dev)
        cents_dev = _kmeans_device(
            x, vectors, nlist, iters, seed,
            np.asarray(init_centroids, np.float32) if warm else None)
        cents = cents_dev.cpu().numpy()
        assign = assign_chunked(x, cents_dev, nlist).cpu().numpy()
        del x, cents_dev
        cap = max(1, int(np.ceil(n / nlist * slack)))
        # balanced packing: overflow spills to the next-nearest centroid
        order = np.argsort(assign, kind="stable")
        buckets: list = [[] for _ in range(nlist)]
        spilled = []
        for row in order:
            a = assign[row]
            if len(buckets[a]) < cap:
                buckets[a].append(row)
            else:
                spilled.append(row)
        if spilled:
            xs = vectors[np.asarray(spilled)]
            dots = xs @ cents.T
            c2 = (cents * cents).sum(axis=1)
            dist = c2[None, :] - 2 * dots
            ranked = np.argsort(dist, axis=1)
            for i, row in enumerate(spilled):
                placed = False
                for c_idx in ranked[i]:
                    if len(buckets[c_idx]) < cap:
                        buckets[c_idx].append(row)
                        placed = True
                        break
                if not placed:   # all full (can't happen with slack > 1)
                    buckets[int(ranked[i][0])].append(row)
        L = max(cap, max(len(b) for b in buckets))
        lists = np.zeros((nlist, L, d), np.float32)
        valid = np.zeros((nlist, L), bool)
        ids = np.full((nlist, L), -1, np.int32)
        for ci, rows in enumerate(buckets):
            m = len(rows)
            if m:
                lists[ci, :m] = vectors[rows]
                valid[ci, :m] = True
                ids[ci, :m] = rows
        norms = np.linalg.norm(lists, axis=2).astype(np.float32)
        # budget-gate the device residency BEFORE the upload, like every
        # other device-resident structure (indices/breaker.py): an
        # over-budget index build trips the breaker instead of running the
        # card out of memory; the shard-plane route catches the trip and
        # serves exact
        index = IVFIndex(cents, lists, valid, ids, similarity, norms)
        from elasticsearch_tpu_torch.indices.breaker import (
            account_device_arrays,
        )
        # the charge handle rides on the index so owners that evict
        # early (the plane registry) can release ahead of GC
        index.warm_started = warm
        index._charge = account_device_arrays(
            index, (cents, lists, valid, ids, norms), "ivf",
            return_charge=True)
        index.centroids = torch.as_tensor(cents, device=dev)
        index.lists = torch.as_tensor(lists, device=dev)
        del lists
        index.valid = torch.as_tensor(valid, device=dev)
        index.ids = torch.as_tensor(ids, device=dev)
        index.norms = torch.as_tensor(norms, device=dev)
        return index

    # -- search ----------------------------------------------------------

    # the JAX program's budget for its [chunk, nprobe, L, D] gather; the
    # query chunk follows it (pow-2), so both packages split a batch into
    # the same launches (the kernel here scans the lists in place)
    GATHER_BYTES_BUDGET = 1 << 30

    def _chunk_for(self, nprobe: int) -> int:
        dims = int(self.lists.shape[2])
        per_query = nprobe * self.list_len * dims * 4
        chunk = max(1, self.GATHER_BYTES_BUDGET // max(per_query, 1))
        chunk = min(chunk, 256)
        return 1 << (chunk.bit_length() - 1)      # floor to pow-2

    def _launch(self, batch: QueryBatch, k: int, nprobe: int):
        return ivf_search(batch.queries, batch.qn, batch.q2, self.centroids,
                          self.lists, self.valid, self.ids, self.norms, k,
                          nprobe, self.similarity)

    def search_device(self, queries, k: int, nprobe: int = 8
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Single-launch search returning device tensors (no copy back):
        the benchmark's pipelined form. ``queries`` [Q, D] (host array or
        tensor) pad to a pow2 row count; the padded rows come back too."""
        nprobe = max(1, min(int(nprobe), self.nlist))
        k = max(1, min(int(k), nprobe * self.list_len))
        if isinstance(queries, torch.Tensor):
            queries = queries.cpu().numpy()
        return self._launch(QueryBatch(queries, self.device), k, nprobe)

    def probe_live(self, queries: np.ndarray, k: int, nprobe: int,
                   rows: np.ndarray, live: np.ndarray, segment_idx: int,
                   oversample: int) -> list:
        """Batched nprobe-probe for the serving path: ONE launch covers Q
        queries (centroid scoring + list scanning + top-k), then the
        host-side demux the per-query ANN path performs -- list-row ids
        map back through ``rows`` (the segment's rows that actually hold
        vectors), deleted docs drop out post-probe (the Lucene-HNSW-style
        post-filter the oversample exists for), and each query keeps its
        best ``k``. Returns one [(segment_idx, doc, score)] list per
        query, in score order."""
        scores, ids = self.search(np.asarray(queries, np.float32),
                                  oversample, nprobe=nprobe)
        out = []
        for qi in range(scores.shape[0]):
            hits = []
            for s, i in zip(scores[qi], ids[qi]):
                if i < 0:
                    continue
                doc = int(rows[i])
                if doc < len(live) and live[doc]:
                    hits.append((segment_idx, doc, float(s)))
                if len(hits) >= k:
                    break
            out.append(hits)
        return out

    def search(self, queries: np.ndarray, k: int, nprobe: int = 8
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched ANN: (scores [Q, k], ids [Q, k]) on the host; ids -1
        past matches. Scores use the same positive transforms as
        ops/knn.py."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nprobe = max(1, min(int(nprobe), self.nlist))
        # k cannot exceed the probed candidate pool (top_k width)
        k = max(1, min(int(k), nprobe * self.list_len))
        nq = q.shape[0]
        chunk = self._chunk_for(nprobe)
        if nq <= chunk:
            # one launch, rows padded to the next pow-2 of the batch
            batch = QueryBatch(q, self.device)
            s, i = self._launch(batch, k, nprobe)
            return s[:nq].cpu().numpy(), i[:nq].cpu().numpy()
        out_s = np.empty((nq, k), np.float32)
        out_i = np.empty((nq, k), np.int32)
        for lo in range(0, nq, chunk):
            hi = min(lo + chunk, nq)
            s, i = self.search(q[lo:hi], k, nprobe)
            out_s[lo:hi], out_i[lo:hi] = s, i
        return out_s, out_i
