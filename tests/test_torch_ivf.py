"""The IVF path of elasticsearch_tpu_torch against the JAX package, on the
CPU, on the same seeded numpy inputs:

- the four kernels' plain PyTorch versions (ops/ivf.py) against the JAX
  programs they replace: ``ivf_assign`` (K11) against ``_assign``,
  ``ivf_update`` (K12) against ``_update``, ``ivf_init`` (K13) against
  ``_farthest_point_init``, ``ivf_search`` (K14) against ``_ivf_search``;
- K11's screen in plain PyTorch (``screen_bound``, ``screen_candidates``,
  ``ivf_assign_screened``) fed dots summed in other orders: it keeps the
  plain argmin, and its answer is the plain version's;
- ``kmeans`` and ``IVFIndex.build`` (device math + the host packing)
  against the JAX package's, and the port's search on a JAX-built index
  carried across by ``convert.ivf_from_reference``;
- served ``_search`` responses for ``knn`` on IVF-routed fields
  (``index_options.type: ivf`` on small segments), plane and per-segment,
  quantized tier on and off, with deletes after the build and a refresh
  that warm-starts k-means.

Tolerance. With integer-valued vectors in [0, 255] every bf16 operand is
exact, every product and partial sum an integer below 2^24, so dots,
centroid norms and distances are exact in any order: assignments,
seeding and searches must be equal bit for bit. Once the centroids are
means (after the first update) they are no longer integers, so later
assignments compare equal only where no two centroids' distances lie
within the summation-order bound below; the clustered test corpora keep
every row far from every other cluster, so their builds are equal. The
update sums each cluster's rows in ascending row order, the order in
which the JAX package's segment_sum adds them, and divides once: its
centroids are bit-equal on Gaussian data too. On Gaussian vectors the
assignment may differ only at a near-tie: the two packages' values of
c2 - 2 * dot for the two chosen centroids must lie within D * 2^-24 times
the sum of the magnitudes of their terms, for each of the two packages'
sums. Gaussian searches compare scores to rtol 4e-6 (f32 re-association
of the dot products and of the query's norm, as in tests/test_torch_knn.py)
and ids wherever neighbouring scores are further apart than that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ops import ivf as ref
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService

from elasticsearch_tpu_torch.convert import ivf_from_reference
from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import ivf as port
from elasticsearch_tpu_torch.ops import knn
from elasticsearch_tpu_torch.ops.device_segment import PLANES
from elasticsearch_tpu_torch.search import SearchService
from test_torch_knn_slice import planes  # noqa: F401 (a fixture)
from torch_inputs import close_ids

RTOL = 4e-6
SIMS = ("cosine", "dot_product", "l2_norm")
T = torch.as_tensor


def gaussian_or_int(seed: int, n: int, dims: int, kind: str):
    rng = np.random.default_rng(seed)
    if kind == "int":
        x = rng.integers(0, 256, (n, dims)).astype(np.float32)
    else:
        x = rng.standard_normal((n, dims)).astype(np.float32)
    x[7] = x[3]                 # duplicate rows: tied distances
    x[11] = x[3]
    return x


def clustered(seed: int, n_clusters: int, per_cluster, dims: int,
              spacing: int = 32):
    """Integer rows in [0, 255] around ``n_clusters`` distinct lattice
    points ``spacing`` apart, each row moved by 0 or 1 per dim: every row
    is far nearer its own cluster than any other. ``per_cluster`` is a
    count or one count per cluster. Rows come shuffled."""
    rng = np.random.default_rng(seed)
    side = 256 // spacing
    codes = rng.choice(side ** min(dims, 6), n_clusters, replace=False)
    centers = np.zeros((n_clusters, dims), np.float32)
    for d in range(min(dims, 6)):
        centers[:, d] = (codes // side ** d) % side * spacing
    centers[:, 6:] = rng.integers(0, 256 - spacing, (n_clusters,
                                                     max(dims - 6, 0)))
    counts = np.broadcast_to(per_cluster, (n_clusters,))
    which = np.repeat(np.arange(n_clusters), counts)
    x = centers[which] + rng.integers(0, 2, (len(which), dims))
    return x[rng.permutation(len(which))].astype(np.float32)


# ---------------------------------------------------------------------------
# the four programs
# ---------------------------------------------------------------------------

def _bf16(a):
    return T(a).to(torch.bfloat16).double().numpy()


def assert_assign_near_ties(x, cents, got, want):
    """Rows whose assignment differs are near-ties: both packages' values
    of c2 - 2 * dot for the two centroids lie within the f32
    summation-order bound of each other."""
    diff = np.nonzero(got != want)[0]
    assert len(diff) <= max(2, len(x) // 200), len(diff)
    d = x.shape[1]
    gamma = d * 2.0 ** -24
    xb, cb = _bf16(x[diff]), _bf16(cents)
    c64 = cents.astype(np.float64)
    for r, i in enumerate(diff):
        vals, bounds = [], []
        for c in (got[i], want[i]):
            prod = xb[r] * cb[c]
            vals.append((c64[c] ** 2).sum() - 2 * prod.sum())
            bounds.append(gamma * ((c64[c] ** 2).sum() +
                                   2 * np.abs(prod).sum()))
        assert abs(vals[0] - vals[1]) <= 2 * sum(bounds), (i, vals, bounds)


ASSIGN_CASES = [(kind, dims, nlist) for kind in ("int", "gauss")
                for dims, nlist in ((16, 37), (40, 200), (128, 64))]


@pytest.mark.parametrize("kind,dims,nlist", ASSIGN_CASES,
                         ids=["-".join(map(str, c)) for c in ASSIGN_CASES])
def test_assign_matches_reference(kind, dims, nlist):
    x = gaussian_or_int(1, 2500, dims, kind)
    rng = np.random.default_rng(2)
    cents = x[rng.choice(len(x), nlist, replace=False)].copy()
    cents[5] = cents[2]          # tied centroids: the lower index wins
    if kind == "gauss":
        cents += np.float32(0.01) * rng.standard_normal(
            cents.shape).astype(np.float32)
        cents[5] = cents[2]
    want = np.asarray(ref._assign(jnp.asarray(x), jnp.asarray(cents),
                                  nlist))
    got = port.ivf_assign(T(x), T(cents)).numpy()
    assert got.dtype == np.int32
    assert not (got == 5).any()
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        assert_assign_near_ties(x, cents, got, want)


# ---------------------------------------------------------------------------
# K11's screen: its bound E and its choice of centroids, in plain PyTorch
# ---------------------------------------------------------------------------

SCREEN_KINDS = ("random", "duplicated", "tied", "ulp")


def screen_inputs(kind: str, dims: int):
    """160 Gaussian rows and 96 centroids. ``duplicated``: each row of the
    first half repeated in the second, and 8 rows equal to centroids;
    ``tied``: 41 equal centroids (more than the screen lists), rows close
    to them; ``ulp``: 20 centroids each one f32 ulp from the last (the
    same bf16 values, c2 a few ulps apart), rows close to them."""
    rng = np.random.default_rng(dims + 100 * SCREEN_KINDS.index(kind))
    x = rng.standard_normal((160, dims)).astype(np.float32)
    cents = rng.standard_normal((96, dims)).astype(np.float32)
    noise = np.float32(0.01) * rng.standard_normal((40, dims)).astype(
        np.float32)
    if kind == "duplicated":
        x[80:] = x[:80]
        x[:8] = cents[:8]
    elif kind == "tied":
        cents[10:50] = cents[9]
        x[:40] = cents[9] + noise
    elif kind == "ulp":
        for c in range(60, 80):
            cents[c] = np.nextafter(cents[c - 1], np.float32(np.inf))
        x[:40] = cents[59] + noise
        x[40] = cents[59]
    return T(x), T(cents)


def dots_in_order(x, cents, order: str):
    """[n, nlist] f32 dots of the bf16-rounded operands, summed in another
    order than the plain version's: the dimensions reversed, as a
    pairwise tree, or by torch.matmul in f32."""
    xb, cb = x.to(torch.bfloat16).float(), cents.to(torch.bfloat16).float()
    if order == "matmul":
        return torch.matmul(xb, cb.t())
    prods = xb[:, None, :] * cb[None, :, :]        # exact in f32
    if order == "reversed":
        acc = torch.zeros(prods.shape[:2])
        for d in reversed(range(prods.shape[2])):
            acc = acc + prods[:, :, d]
        return acc
    width = 1 << (prods.shape[2] - 1).bit_length()
    prods = torch.nn.functional.pad(prods, (0, width - prods.shape[2]))
    while prods.shape[2] > 1:
        half = prods.shape[2] // 2
        prods = prods[:, :, :half] + prods[:, :, half:]
    return prods[:, :, 0]


SCREEN_CASES = [(kind, dims, order) for kind in SCREEN_KINDS
                for dims in (16, 100, 960)
                for order in ("reversed", "pairwise", "matmul")]


@pytest.mark.parametrize("kind,dims,order", SCREEN_CASES,
                         ids=["-".join(map(str, c)) for c in SCREEN_CASES])
def test_screen_keeps_the_plain_argmin(kind, dims, order):
    """ops/ivf.py's mirror of K11's screen, fed dots summed in another
    order than the plain version's (as the tensor cores sum them): every
    plain value lies within t -/+ E, so the plain argmin is always among
    the screened centroids, and the re-score over them (or over every
    centroid, where more than SCREEN_CAND pass) is the plain answer."""
    x, cents = screen_inputs(kind, dims)
    dots = dots_in_order(x, cents, order)
    c2 = port._col_sum_sq(cents)
    plain = (knn._flat_dots(cents, x) * -2.0) + c2[None, :]
    t = c2[None, :] - 2.0 * dots
    e = port.screen_bound(x, cents, c2)
    assert ((t - e <= plain) & (plain <= t + e)).all()
    want = port.ivf_assign_plain(x, cents)
    keep = port.screen_candidates(dots, x, cents)
    assert keep[torch.arange(len(want)), want.long()].all()
    if kind == "tied":
        # the tied rows list more centroids than the screen holds
        assert (keep.sum(dim=1) > port.SCREEN_CAND).any()
    got = port.ivf_assign_screened(dots, x, cents)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("dims,nlist", [(16, 40), (96, 300)])
def test_update_matches_reference_bit_for_bit(kind, dims, nlist):
    """Row-order sums: equal bits on Gaussian data too; ids outside
    [0, nlist) are dropped and empty clusters keep their centroid."""
    x = gaussian_or_int(3, 3000, dims, kind)
    rng = np.random.default_rng(4)
    assign = rng.integers(0, nlist - 7, len(x)).astype(np.int32)
    assign[:5] = -1
    assign[5:9] = nlist + 3
    cents = rng.standard_normal((nlist, dims)).astype(np.float32)
    want = np.asarray(ref._update(jnp.asarray(x), jnp.asarray(assign),
                                  jnp.asarray(cents), nlist))
    got = port.ivf_update(T(x), T(assign), T(cents)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[nlist - 7:], cents[nlist - 7:])


@pytest.mark.parametrize("dims,nlist,first", [(16, 50, 0), (40, 64, 17),
                                              (100, 33, 1999)])
def test_farthest_point_init_matches_reference(dims, nlist, first):
    """Integer-valued rows (with duplicates): distances are exact in any
    order, so the seeding is equal bit for bit, first-index ties
    included."""
    x = gaussian_or_int(5, 2000, dims, "int")
    x[100:140] = x[0]            # many equal farthest candidates
    want = np.asarray(ref._farthest_point_init(
        jnp.asarray(x), jnp.asarray(first), nlist))
    got = port.ivf_init(T(x), first, nlist).numpy()
    np.testing.assert_array_equal(got, want)


def _plain_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """ivf_init's plain f32 distance of every row of x to c (lane order)."""
    n, d = x.shape
    m = -(-d // 32)
    xp = torch.zeros(n, m * 32)
    xp[:, :d] = x
    cp = torch.zeros(m * 32)
    cp[:d] = c
    return port._lane_dist(xp.reshape(n, m, 32), cp)


def skip_rows(kind: str, dims: int, seed: int):
    """(rows [n, D], owner centroid, new centroid) as f32 tensors: every
    centroid is a copy of a row, as in the seeding. ``midpoint`` puts the
    rows at the midpoint of the two centroids, moved by a few ulps: the
    triangle inequality is tight there, so only the test's margin keeps it
    from skipping a row that the new centroid does bring nearer."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if kind == "random":
        x = rng.standard_normal((600, dims)).astype(f32)
    elif kind == "duplicates":
        x = rng.standard_normal((600, dims)).astype(f32)
        x[1::3] = x[0]
        x[2::3] = x[5]
    elif kind == "ulp_chain":
        base = rng.standard_normal(dims).astype(f32)
        x = np.repeat(base[None, :], 600, 0)
        for i in range(1, 600):           # each row one ulp up in one dim
            x[i] = x[i - 1]
            j = i % dims
            x[i, j] = np.nextafter(x[i, j], f32(np.inf))
    elif kind == "tight_cluster":
        far = 30 * rng.standard_normal((8, dims)).astype(f32)
        x = np.concatenate([
            far[0] + f32(1e-4) * rng.standard_normal((300, dims)).astype(f32),
            far[rng.integers(1, 8, 300)] +
            rng.standard_normal((300, dims)).astype(f32)])
    else:                                  # midpoint
        p = rng.standard_normal(dims)
        q = p + (1e-3 if seed % 2 else 1.0) * rng.standard_normal(dims)
        mid = (p + q) / 2
        x = (mid[None, :] + (np.abs(mid) + 1e-3)[None, :] * 1e-7 *
             rng.standard_normal((600, dims))).astype(f32)
        x[0], x[1] = p.astype(f32), q.astype(f32)
    return T(x), T(x[0]).clone(), T(x[1]).clone()


SKIP_KINDS = ("random", "duplicates", "ulp_chain", "tight_cluster",
              "midpoint")
SKIP_CASES = [(kind, dims) for kind in SKIP_KINDS for dims in (16, 100, 960)]


@pytest.mark.parametrize("kind,dims", SKIP_CASES,
                         ids=["-".join(map(str, c)) for c in SKIP_CASES])
def test_init_skip_never_skips_a_row_that_would_move(kind, dims):
    """K13's skip test (its mirror ``init_skip``) never clears a row whose
    plain distance to the new centroid is below its d2 (the distance to
    the centroid that set it), over several (owner, new) centroid pairs
    drawn from the rows. On the midpoint rows a margin of zero (skip when
    cd > 4 d2) does clear such rows, so these inputs test the margin."""
    skipped = zero_margin_wrong = 0
    for seed in range(6):
        x, c_a, c_i = skip_rows(kind, dims, seed)
        if kind != "midpoint":
            g = torch.Generator().manual_seed(seed)
            a, i = torch.randint(0, x.shape[0], (2,), generator=g).tolist()
            c_a, c_i = x[a].clone(), x[i].clone()
        d2 = _plain_dist(x, c_a)
        t = _plain_dist(x, c_i)
        cd = port.centroid_dists(c_a[None, :], c_i).expand(x.shape[0])
        skip = port.init_skip(cd, d2, dims)
        moved = t < d2
        assert not bool((skip & moved).any()), (seed, int((skip & moved)
                                                          .sum()))
        skipped += int(skip.sum())
        zero = (d2.double() == 0) | (cd > 4 * d2.double())
        zero_margin_wrong += int((zero & moved).sum())
    if kind == "midpoint":
        assert zero_margin_wrong > 0
    if kind == "tight_cluster":
        assert skipped > 0


@pytest.mark.parametrize("dims,nlist,first", [(16, 60, 0), (40, 48, 17),
                                              (100, 33, 1999)])
def test_pruned_seeding_matches_plain_and_reference(dims, nlist, first):
    """K13's plain pruned seeding (``ivf_init_pruned_plain``) gives
    ``ivf_init_plain``'s centroids and the JAX ``_farthest_point_init``'s
    bit for bit on clustered integer rows (every distance exact, with
    duplicate rows and many equal farthest candidates), computes far
    fewer distances than a full scan a step there, and equals
    ``ivf_init_plain`` on Gaussian clusters too."""
    x = clustered(30 + dims, 12, 167, dims)[:2000]
    x[100:140] = x[0]
    want = np.asarray(ref._farthest_point_init(
        jnp.asarray(x), jnp.asarray(first), nlist))
    got, computed = port.ivf_init_pruned_plain(T(x), first, nlist)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), port.ivf_init_plain(T(x), first, nlist).numpy())
    assert computed[0] == len(x) and len(computed) == nlist - 1
    assert sum(computed) < 0.3 * len(x) * (nlist - 1)
    rng = np.random.default_rng(dims)
    means = rng.standard_normal((24, dims)).astype(np.float32)
    g = (means[rng.integers(0, 24, 1500)] + 0.35 *
         rng.standard_normal((1500, dims))).astype(np.float32)
    got, _ = port.ivf_init_pruned_plain(T(g), first % 1500, nlist)
    np.testing.assert_array_equal(
        got.numpy().view(np.int32),
        port.ivf_init_plain(T(g), first % 1500, nlist).numpy().view(
            np.int32))


def test_kmeans_cold_and_warm_match_reference():
    x = clustered(6, 24, 60, 16)
    want = ref.kmeans(x, 24, seed=3)
    got = port.kmeans(x, 24, seed=3, device="cpu")
    np.testing.assert_array_equal(got, want)
    y = np.concatenate([x, clustered(7, 24, 10, 16)])
    np.testing.assert_array_equal(
        port.kmeans(y, 24, init_centroids=got, device="cpu"),
        ref.kmeans(y, 24, init_centroids=want))
    # fewer rows than lists: the rows, repeated
    np.testing.assert_array_equal(port.kmeans(x[:5], 8, device="cpu"),
                                  ref.kmeans(x[:5], 8))


@pytest.mark.parametrize("sim", SIMS)
def test_build_matches_reference(sim):
    """Same centroids, lists, valid, ids and norms, including rows that
    overflow their list and spill to the next-nearest centroid."""
    sizes = np.full(20, 40)
    sizes[0], sizes[1] = 170, 95            # over the lists' cap (66)
    x = clustered(8, 20, sizes, 24)
    r = ref.IVFIndex.build(x, nlist=20, similarity=sim)
    p = port.IVFIndex.build(x, nlist=20, similarity=sim, device="cpu")
    assert (p.nlist, p.list_len) == (r.nlist, r.list_len)
    for name in ("centroids", "lists", "valid", "ids", "norms"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)))
    assert not p.warm_started
    assert p._charge.n_bytes == r._charge.n_bytes


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("sim", SIMS)
def test_search_matches_reference_on_one_index(kind, sim):
    """The port's probe on a JAX-built index, carried across as arrays:
    the same ids, scores within the stated bound; nprobe up to nlist and k
    above the probed pool (clamped)."""
    rng = np.random.default_rng(9)
    x = gaussian_or_int(10, 1500, 32, kind)
    r = ref.IVFIndex.build(x, nlist=30, similarity=sim)
    p = ivf_from_reference(r.centroids, r.lists, r.valid, r.ids, r.norms,
                           sim, "cpu")
    q = x[rng.integers(0, len(x), 7)] + (
        rng.integers(-2, 3, (7, 32)) if kind == "int"
        else 0.1 * rng.standard_normal((7, 32))).astype(np.float32)
    q[-1] = 0.0                                   # an all-zero query
    for nprobe, k in ((1, 10), (4, 10), (4, 10 ** 4), (30, 50)):
        rs, ri = r.search(q, k, nprobe)
        ps, pi = p.search(q, k, nprobe)
        assert ps.shape == rs.shape and pi.dtype == np.int32
        if kind == "int":
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(ps, rs)
        else:
            np.testing.assert_allclose(ps, rs, rtol=RTOL)
            close_ids(rs, ri, pi, RTOL)


def test_tied_scores_resolve_in_probe_order():
    """Equal scores order by probe rank, then list position -- not by doc
    id -- in both packages, and ids past the valid slots are -1 with score
    0. Under dot_product an axis query scores a doc by one coordinate, so
    docs of different lists tie."""
    x = clustered(11, 6, 12, 16)
    r = ref.IVFIndex.build(x, nlist=6, similarity="dot_product")
    p = ivf_from_reference(r.centroids, r.lists, r.valid, r.ids, r.norms,
                           "dot_product", "cpu")
    q = np.zeros((2, 16), np.float32)
    q[0, 0] = 1.0
    q[1, 3] = 1.0
    rs, ri = r.search(q, 72, 6)
    ps, pi = p.search(q, 72, 6)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(ps, rs)
    runs = [pi[0][ps[0] == s] for s in np.unique(ps[0])]
    assert any(len(run) > 1 for run in runs)
    assert any(list(run) != sorted(run) for run in runs)
    # a pool larger than the valid slots: the tail is -1 / 0.0
    rs, ri = r.search(q, 10 ** 6, 2)
    ps, pi = p.search(q, 10 ** 6, 2)
    np.testing.assert_array_equal(pi, ri)
    assert (pi[0] == -1).any() and (ps[0][pi[0] == -1] == 0).all()


def _search_args(index, q):
    batch = knn.QueryBatch(q, "cpu")
    return (batch.queries, batch.qn, batch.q2, index.centroids, index.lists,
            index.valid, index.ids, index.norms)


GROUPED_CASES = [(name, splits) for name in ("duplicated_queries",
                                             "ties_across_lists", "wide_k")
                 for splits in (1, 3)]


@pytest.mark.parametrize("name,splits", GROUPED_CASES,
                         ids=["-".join(map(str, c)) for c in GROUPED_CASES])
def test_grouped_merge_order_matches_plain(name, splits):
    """K14's list-grouped order (``ivf_search_grouped_plain``: per (query,
    probe) partials of each row range, merged by probe rank) gives
    ``ivf_search_plain``'s ids and score bits: on duplicated queries (two
    queries sharing every list), on scores tied across lists (the
    dot_product axis queries of ``test_tied_scores_resolve_in_probe_order``)
    and at k above the partials' cap (``SEARCH_KCAP``), with lists split
    into 1 and 3 row ranges."""
    if name == "ties_across_lists":
        x = clustered(11, 6, 12, 16)
        r = ref.IVFIndex.build(x, nlist=6, similarity="dot_product")
        index = ivf_from_reference(r.centroids, r.lists, r.valid, r.ids,
                                   r.norms, "dot_product", "cpu")
        q = np.zeros((3, 16), np.float32)
        q[0, 0] = q[2, 0] = 1.0
        q[1, 3] = 1.0
        runs = [(72, 6), (10, 2), (5, 6)]
        sim = "dot_product"
    else:
        x = clustered(40, 8, 90, 16)
        sim = "cosine" if name == "wide_k" else "l2_norm"
        index = port.IVFIndex.build(x, nlist=8, similarity=sim, device="cpu")
        rng = np.random.default_rng(41)
        q = x[rng.integers(0, len(x), 5)] + rng.integers(
            -2, 3, (5, 16)).astype(np.float32)
        q[1] = q[0]
        q[3] = q[0]
        runs = ([(port.SEARCH_KCAP + 40, 4), (port.SEARCH_KCAP + 1, 8)]
                if name == "wide_k" else [(10, 3), (26, 8), (1, 1)])
    args = _search_args(index, q)
    for k, nprobe in runs:
        k = min(k, nprobe * index.list_len)
        want = port.ivf_search_plain(*args, k, nprobe, sim)
        got = port.ivf_search_grouped_plain(*args, k, nprobe, sim,
                                            splits=splits)
        assert torch.equal(got[1], want[1]), (k, nprobe)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), (k, nprobe)
        if name == "duplicated_queries":
            assert torch.equal(got[1][0], got[1][1])


def test_probe_live_matches_reference():
    x = clustered(12, 10, 30, 16)
    rows = np.arange(len(x)) * 2 + 1          # the segment rows with vectors
    live = np.ones(2 * len(x) + 1, bool)
    live[rows[::3]] = False
    r = ref.IVFIndex.build(x, nlist=10, similarity="cosine")
    p = ivf_from_reference(r.centroids, r.lists, r.valid, r.ids, r.norms,
                           "cosine", "cpu")
    q = x[[4, 50, 120]]
    want = r.probe_live(q, 10, 3, rows, live, 2, 26)
    assert p.probe_live(q, 10, 3, rows, live, 2, 26) == want


def test_probe_k_above_kmax_is_refused():
    """(The name predates the wide selection, which this test once proved
    refused.) A probe whose k passes the kernels' 4,096-entry selection is
    served as the JAX package serves it: ids and scores equal."""
    x = clustered(13, 4, 1500, 8)
    r = ref.IVFIndex.build(x, nlist=4, similarity="cosine")
    p = port.IVFIndex.build(x, nlist=4, device="cpu")
    rs, ri = r.search(x[:1], 5000, 4)
    ps, pi = p.search(x[:1], 5000, 4)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(ps, rs)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """An IVF wrapper given CUDA tensors launches its kernel or raises:
    with the kernel library unavailable it raises instead of computing on
    the host."""
    from elasticsearch_tpu_torch import _build
    from elasticsearch_tpu_torch.ops import bm25 as port_bm25

    def no_library(family):
        raise _build.KernelBuildError("kernel library unavailable")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(port_bm25, "_FNS", {})
    monkeypatch.setattr(port, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(port, "_stream", lambda: 0)
    for name in ("ivf_assign_plain", "ivf_update_plain", "ivf_init_plain",
                 "ivf_search_plain"):
        monkeypatch.setattr(port, name, lambda *a, **k: pytest.fail(
            "plain version ran for a CUDA call"))
    x = T(gaussian_or_int(14, 64, 8, "int"))
    c = x[:4].clone()
    with pytest.raises(_build.KernelBuildError):
        port.ivf_assign(x, c)
    with pytest.raises(_build.KernelBuildError):
        port.ivf_update(x, torch.zeros(64, dtype=torch.int32), c)
    with pytest.raises(_build.KernelBuildError):
        port.ivf_init(x, 0, 4)
    lists = x.reshape(4, 16, 8)
    with pytest.raises(_build.KernelBuildError):
        port.ivf_search(x[:2], torch.ones(2), torch.ones(2), c, lists,
                        torch.ones(4, 16, dtype=torch.bool),
                        torch.zeros(4, 16, dtype=torch.int32),
                        torch.ones(4, 16), 5, 2)


# ---------------------------------------------------------------------------
# served: knn on IVF-routed fields, against a JAX node
# ---------------------------------------------------------------------------

DIMS = 16


def ivf_mapping(sim: str, nlist: int):
    return {"properties": {
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": sim,
                "index_options": {"type": "ivf", "nlist": nlist}},
        "tag": {"type": "keyword"}}}


def add_docs(engines, vectors, start: int, refresh_at=()):
    for i, v in enumerate(vectors, start):
        body = {"vec": [float(x) for x in v], "tag": f"t{i % 5}"}
        for e in engines:
            e.index(str(i), body)
        if i in refresh_at:
            for e in engines:
                e.refresh()
    for e in engines:
        e.refresh()


def knn_bodies(rng, corpus, n: int):
    out = []
    for i in range(n):
        q = corpus[rng.integers(0, len(corpus))] + rng.integers(0, 3, DIMS)
        k, nc = ((10, 40), (5, 200), (25, 90), (10, 10))[i % 4]
        body = {"query": {"knn": {"field": "vec",
                                  "query_vector": [float(v) for v in q],
                                  "k": k, "num_candidates": nc}},
                "size": 10}
        if i % 4 == 2:
            body["from"] = 5
        if i % 4 == 3:
            body["query"]["knn"]["boost"] = 2.0
        out.append(body)
    return out


def assert_same(ref_svc, port_svc, bodies):
    for body in bodies:
        a, b = ref_svc.search(body), port_svc.search(body)
        assert a["hits"]["total"] == b["hits"]["total"]
        assert [h["_id"] for h in a["hits"]["hits"]] == \
            [h["_id"] for h in b["hits"]["hits"]]
        assert [h["_score"] for h in a["hits"]["hits"]] == \
            [h["_score"] for h in b["hits"]["hits"]]
        assert a["hits"]["max_score"] == b["hits"]["max_score"]


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("route", ["plane", "per_segment"])
@pytest.mark.parametrize("quantized", [True, False])
def test_ivf_knn_responses_match_reference(sim, route, quantized, planes):
    """index_options {type: ivf, nlist: 12} on small segments: each
    segment (or the shard plane) probes its own IVF index. Then deletes
    after the build, and a refresh that starts a new plane generation
    (warm-started k-means on the plane route)."""
    for p in (REF_PLANES, PLANES):
        p.enabled = route == "plane"
        p.quantized = quantized
    corpus = clustered(20, 12, 40, DIMS)
    ref_e = RefEngine(RefMappers(ivf_mapping(sim, 12)), shard_label="ref")
    port_e = InternalEngine(MapperService(ivf_mapping(sim, 12)),
                            shard_label="port")
    add_docs((ref_e, port_e), corpus[:300], 0, refresh_at=(150,))
    ref_svc, port_svc = RefService(ref_e), SearchService(port_e,
                                                         device="cpu")
    rng = np.random.default_rng(21)
    assert_same(ref_svc, port_svc, knn_bodies(rng, corpus, 8))
    for i in (3, 77, 160, 299):                   # deletes after the build
        ref_e.delete(str(i))
        port_e.delete(str(i))
    for e in (ref_e, port_e):
        e.refresh()
    assert_same(ref_svc, port_svc, knn_bodies(rng, corpus, 8))
    warm0 = (REF_PLANES.stats["ivf_warm_starts"],
             PLANES.stats["ivf_warm_starts"])
    add_docs((ref_e, port_e), corpus[300:], 300)   # a new segment
    assert_same(ref_svc, port_svc, knn_bodies(rng, corpus, 8))
    warm = (REF_PLANES.stats["ivf_warm_starts"] - warm0[0],
            PLANES.stats["ivf_warm_starts"] - warm0[1])
    assert warm[0] == warm[1] == (1 if route == "plane" else 0)
