"""The aggregation kernels' plain PyTorch versions (K20-K23,
``elasticsearch_tpu_torch/ops/aggs.py``) against the JAX package's
``ops/aggs.py`` on the same seeded inputs.

Tolerance: none. Counts, mins and maxs do not depend on the order of their
terms; the sums add each bucket's terms in row order in both packages, so
they are bitwise equal too, also where a bucket's sum passes 2^24 (a named
case) and where negative values, out-of-range buckets and padded table
entries are dropped.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import aggs as ref

from elasticsearch_tpu_torch.ops import aggs


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, want):
    port = [np.asarray(t) for t in port]
    want = [np.asarray(t) for t in want]
    assert len(port) == len(want)
    for p, w in zip(port, want):
        assert p.dtype == w.dtype and p.shape == w.shape
        np.testing.assert_array_equal(_bits(p), _bits(w))


def _table(seed: int, n_docs: int, n_terms: int, e_pad: int):
    """A deduped (owner, ord) table padded like ``_device_terms`` (owners
    0, ords -1), with a few ordinals past ``n_terms`` (dropped)."""
    rng = np.random.default_rng(seed)
    e = e_pad - 5
    owners = np.sort(rng.integers(0, n_docs, e)).astype(np.int32)
    ords = rng.integers(0, n_terms + 3, e).astype(np.int32)
    ow = np.zeros(e_pad, np.int32)
    od = np.full(e_pad, -1, np.int32)
    ow[:e], od[:e] = owners, ords
    return ow, od


@pytest.mark.parametrize("seed,n_docs,n_terms", [(1, 512, 13), (2, 4096, 250),
                                                 (3, 300, 1)])
def test_ordinal_counts_equals_reference(seed, n_docs, n_terms):
    rng = np.random.default_rng(seed + 100)
    ow, od = _table(seed, n_docs, n_terms, 2048)
    mask = rng.random(n_docs) < 0.6
    nb = 1 << max(3, (n_terms - 1).bit_length())
    want = ref.ordinal_counts(jnp.asarray(od), jnp.asarray(mask)[ow], nb)
    got = aggs.ordinal_counts(torch.as_tensor(od), torch.as_tensor(ow),
                              torch.as_tensor(mask), nb)
    _same([got], [want])


@pytest.mark.parametrize("n_plans", [1, 4, 8])
def test_ordinal_counts_plane_equals_reference(n_plans):
    rng = np.random.default_rng(7 + n_plans)
    n_pad, n_terms = 2048, 40
    ow, od = _table(n_plans, 1900, n_terms, 4096)
    masks = rng.random((n_plans, n_pad)) < rng.uniform(0.05, 0.95,
                                                       (n_plans, 1))
    want = ref.ordinal_counts_plane(jnp.asarray(od), jnp.asarray(ow),
                                    jnp.asarray(masks), 64)
    got = aggs.ordinal_counts_plane(torch.as_tensor(od), torch.as_tensor(ow),
                                    torch.as_tensor(masks), 64)
    _same([got], [want])


def _column(seed: int, n: int, lo: int, hi: int):
    rng = np.random.default_rng(seed)
    values = rng.integers(lo, hi, n).astype(np.int32)
    exists = rng.random(n) > 0.1
    values[~exists] = 0
    return values, exists, rng


@pytest.mark.parametrize("interval", [1, 7, 100])
def test_histogram_negative_values_and_drops(interval):
    # dem-like values: many negatives, so floor division (not truncation)
    # decides the bucket; base one bucket up and n_buckets short drop rows
    # at both ends
    values, exists, rng = _column(interval, 5000, -9999, 8849)
    mask = rng.random(5000) < 0.7
    base = (-9999 // interval) + 1
    nb = max(8, (8848 // interval - base) // 2)
    want = ref.histogram_partials(jnp.asarray(values), jnp.asarray(exists),
                                  jnp.asarray(mask), jnp.int32(base),
                                  jnp.int32(interval), nb)
    got = aggs.histogram_partials(torch.as_tensor(values),
                                  torch.as_tensor(exists),
                                  torch.as_tensor(mask), base, interval, nb)
    _same(got, want)


def test_histogram_sums_past_2_24_bitwise():
    # large same-bucket values: every bucket's running sum passes 2^24
    # within a few rows, so from there on each add rounds and the result
    # depends on the order (a pairwise sum differs)
    n = 200_000
    values, exists, rng = _column(11, n, 0, (1 << 24) - 1)
    mask = rng.random(n) < 0.9
    interval = 1 << 21
    nb = 8
    want = ref.histogram_partials(jnp.asarray(values), jnp.asarray(exists),
                                  jnp.asarray(mask), jnp.int32(0),
                                  jnp.int32(interval), nb)
    got = aggs.histogram_partials(torch.as_tensor(values),
                                  torch.as_tensor(exists),
                                  torch.as_tensor(mask), 0, interval, nb)
    _same(got, want)
    sums = np.asarray(want[1])
    assert (np.abs(sums) > 2 ** 24).all()
    ok = exists & mask
    ids = values // interval
    pairwise = np.array([values[ok & (ids == b)].astype(np.float32).sum()
                         for b in range(nb)], np.float32)
    seq = np.array([np.add.accumulate(np.concatenate(
        [[np.float32(0)], values[ok & (ids == b)].astype(np.float32)]))[-1]
        for b in range(nb)], np.float32)
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(seq))
    assert not np.array_equal(_bits(pairwise), _bits(seq))


def test_histogram_empty_buckets_and_padding():
    values, exists, rng = _column(5, 1024, -50, 50)
    exists[512:] = False                  # padding rows past the segment
    mask = np.zeros(1024, bool)
    mask[:40] = True
    want = ref.histogram_partials(jnp.asarray(values), jnp.asarray(exists),
                                  jnp.asarray(mask), jnp.int32(-10),
                                  jnp.int32(5), 32)
    got = aggs.histogram_partials(torch.as_tensor(values),
                                  torch.as_tensor(exists),
                                  torch.as_tensor(mask), -10, 5, 32)
    _same(got, want)
    assert np.isinf(np.asarray(want[2])).any()


@pytest.mark.parametrize("n_plans", [1, 3, 8])
def test_histogram_plane_equals_reference(n_plans):
    values, exists, rng = _column(20 + n_plans, 8192, -3000, 40000)
    masks = rng.random((n_plans, 8192)) < rng.uniform(0.1, 1.0,
                                                      (n_plans, 1))
    intervals = rng.integers(1, 500, n_plans).astype(np.int32)
    intervals[-1] = 1                      # a padding row's interval
    bases = np.array([(-3000 // int(i)) for i in intervals], np.int32)
    nb = 256
    want = ref.histogram_partials_plane(
        jnp.asarray(values), jnp.asarray(exists), jnp.asarray(masks),
        jnp.asarray(bases), jnp.asarray(intervals), nb)
    got = aggs.histogram_partials_plane(
        torch.as_tensor(values), torch.as_tensor(exists),
        torch.as_tensor(masks), torch.as_tensor(bases),
        torch.as_tensor(intervals), nb)
    _same(got, want)


def test_plane_rows_equal_single_plan_calls():
    values, exists, rng = _column(31, 4096, -100, 100)
    masks = rng.random((4, 4096)) < 0.5
    bases = np.array([-20, -10, -5, -100], np.int32)
    intervals = np.array([5, 10, 20, 1], np.int32)
    plane = aggs.histogram_partials_plane(
        *map(torch.as_tensor, (values, exists, masks, bases, intervals)), 64)
    for p in range(4):
        one = aggs.histogram_partials(
            torch.as_tensor(values), torch.as_tensor(exists),
            torch.as_tensor(masks[p]), int(bases[p]), int(intervals[p]), 64)
        _same([t[p] for t in plane], one)


def test_hist_chunking_bounds_the_count_table():
    assert aggs.hist_rows_per_chunk(4096, 1, 8) == 4096
    rows = aggs.hist_rows_per_chunk(1 << 24, 64, 65536)
    n_chunks = -(-(1 << 24) // rows)
    assert rows % 32 == 0
    assert 64 * n_chunks * 65536 <= aggs.HIST_TABLE_BUDGET
    rows = aggs.hist_rows_per_chunk(1 << 24, 64, 256)
    assert rows == aggs.HIST_ROWS_PER_CHUNK


def test_wrappers_refuse_bad_operands():
    v = torch.zeros(16, dtype=torch.int32)
    e = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError):
        aggs.histogram_partials(v, e, e, 0, 0, 8)
    with pytest.raises(TypeError):
        aggs.histogram_partials(v.long(), e, e, 0, 1, 8)
    with pytest.raises(ValueError):
        aggs.ordinal_counts(v, v, e, 0)
    with pytest.raises(ValueError):
        aggs.ordinal_counts_plane(v, v, e, 8)
