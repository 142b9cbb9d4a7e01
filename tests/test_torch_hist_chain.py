"""The histogram kernels' arithmetic (K21 / K23, ``csrc/aggs_histogram.cuh``)
on the CPU: ``histogram_partials_plane_mirror`` takes mins and maxs from the
integers, sums a bucket whose |v| sum is at most 2^24 exactly in int64 and
adds every other bucket's values one rounded f32 add at a time in row
order. Held bitwise (no tolerance) against the plain versions and the JAX
package's ``histogram_partials`` / ``histogram_partials_plane`` on the
cases of ``tests/torch_inputs.py`` ``HIST_CASES``: the rule's edge (|v|
sums just under, at and just over 2^24), negatives, values at
+-(2^24 - 1), a -9999 no-data bucket, an interval-0 plan, drops, padding
rows, more than 12,288 buckets, P 1 and P 64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import aggs as ref

from elasticsearch_tpu_torch.ops import aggs
from torch_inputs import HIST_CASES, hist_case


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, want):
    assert len(port) == len(want)
    for p, w in zip(port, want):
        p, w = np.asarray(p), np.asarray(w)
        assert p.dtype == w.dtype and p.shape == w.shape
        np.testing.assert_array_equal(_bits(p), _bits(w))


def _tensors(case):
    values, exists, masks, bases, intervals, nb = case
    return (torch.as_tensor(values), torch.as_tensor(exists),
            torch.as_tensor(masks), torch.as_tensor(bases),
            torch.as_tensor(intervals)), nb


@pytest.mark.parametrize("name", HIST_CASES)
def test_mirror_equals_plain_and_reference(name):
    case = hist_case(name)
    cols, nb = _tensors(case)
    got, chain = aggs.histogram_partials_plane_mirror(*cols, nb)
    _same(got, aggs.histogram_partials_plane_plain(*cols, nb))
    values, exists, masks, bases, intervals, _ = case
    want = ref.histogram_partials_plane(
        jnp.asarray(values), jnp.asarray(exists), jnp.asarray(masks),
        jnp.asarray(bases), jnp.asarray(intervals), nb)
    # an interval-0 plan: the port counts nothing (the drain pads plans
    # with interval 1 and the per-segment wrapper refuses 0); XLA's integer
    # division by zero puts every row in one bucket, so only the plans of
    # positive interval are held against the reference
    real = intervals > 0
    _same([t[torch.as_tensor(real)] for t in got],
          [np.asarray(t)[real] for t in want])
    assert chain.shape == (masks.shape[0], nb)
    assert not bool(chain[got[0] == 0].any())      # empty: never a chain


@pytest.mark.parametrize("name", HIST_CASES)
def test_one_plan_equals_reference(name):
    """P 1 (K21's shape): plan 0 alone, through the mirror, the wrapper on
    the CPU and the JAX package's per-segment program."""
    values, exists, masks, bases, intervals, nb = hist_case(name)
    assert int(intervals[0]) > 0
    cols = (torch.as_tensor(values), torch.as_tensor(exists),
            torch.as_tensor(masks[:1]), torch.as_tensor(bases[:1]),
            torch.as_tensor(intervals[:1]))
    got, _ = aggs.histogram_partials_plane_mirror(*cols, nb)
    one = aggs.histogram_partials(cols[0], cols[1], cols[2][0],
                                  int(bases[0]), int(intervals[0]), nb)
    _same([t[0] for t in got], one)
    want = ref.histogram_partials(
        jnp.asarray(values), jnp.asarray(exists), jnp.asarray(masks[0]),
        jnp.int32(bases[0]), jnp.int32(intervals[0]), nb)
    _same(one, want)


@pytest.mark.parametrize("name,chained", [("abs_sum_under_2p24", False),
                                          ("abs_sum_at_2p24", False),
                                          ("abs_sum_over_2p24", True),
                                          ("constant_no_data_bucket", True)])
def test_exact_rule_edges(name, chained):
    """Plan 0's bucket 0: |v| sums 2^24 - 1 and 2^24 are exact (no
    chain), 2^24 + 1 and the -9999 bucket chain."""
    cols, nb = _tensors(hist_case(name))
    (counts, sums, _mins, _maxs), chain = \
        aggs.histogram_partials_plane_mirror(*cols, nb)
    assert bool(chain[0, 0]) is chained
    values = cols[0].long()
    ids = torch.div(values, int(cols[4][0]), rounding_mode="floor") \
        - int(cols[3][0])
    rows = cols[1] & cols[2][0] & (ids == 0)
    mag = int(values[rows].abs().sum())
    assert int(counts[0, 0]) == int(rows.sum())
    assert (mag > aggs.EXACT_LIMIT) is chained
    if not chained:
        assert float(sums[0, 0]) == float(values[rows].sum())


def test_no_data_bucket_rounds_past_2p24():
    """The -9999 bucket's chain differs from its exact integer sum (so a
    kernel that summed it exactly would be caught)."""
    cols, nb = _tensors(hist_case("constant_no_data_bucket"))
    (_c, sums, _lo, _hi), chain = \
        aggs.histogram_partials_plane_mirror(*cols, nb)
    values = cols[0].long()
    rows = cols[1] & cols[2][0] & (values == -9999)
    assert bool(chain[0, 0])
    assert float(sums[0, 0]) != float(values[rows].sum())


def test_interval_0_plan_counts_nothing():
    cols, nb = _tensors(hist_case("interval_0_plan"))
    (counts, sums, mins, maxs), chain = \
        aggs.histogram_partials_plane_mirror(*cols, nb)
    assert int(cols[4][1]) == 0
    assert int(counts[1].sum()) == 0 and not bool(chain[1].any())
    assert bool(torch.isinf(mins[1]).all() and torch.isinf(maxs[1]).all())
    assert (sums[1].view(torch.int32) == 0).all()        # +0.0


def test_scratch_bytes_cover_the_layout():
    """``histogram_scratch_bytes`` counts the look-back table, the
    statistics and the chain buckets' values region ([P, n + 4 n_buckets]
    f32), so it grows with each of them."""
    base = aggs.histogram_scratch_bytes(1 << 20, 1, 256)
    assert base >= 4 * ((1 << 20) + 4 * 256) + 20 * 256
    assert aggs.histogram_scratch_bytes(1 << 20, 2, 256) > 2 * base - 256
    assert aggs.histogram_scratch_bytes(1 << 21, 1, 256) > base
    rows = aggs.hist_rows_per_chunk(1 << 20, 1, 256)
    assert rows % aggs.HIST_THREADS == 0
