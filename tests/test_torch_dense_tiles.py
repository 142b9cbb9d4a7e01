"""The dense row of the tile pipeline (csrc/tiles.cuh section 5: K8
``bm25_scores`` under Bm25Policy, K19 ``sparse_scores`` under
FeaturePolicy) mirrored on the CPU.

``ops/bm25.py`` ``bm25_dense_mirror`` and ``ops/sparse.py``
``sparse_dense_mirror`` run the kernels' algorithm step by step -- each
gathered block of non-zero weight binned under the tiles holding its docs
(``doc_tiles``: a block spanning tiles read whole in each for BM25, one
run of positions a tile for rank_features, whole when its docs are out of
order), each listed tile summed in 64-bit fixed point, masked by ``live``
and converted once, tiles no block reaches left 0 -- and must give
bitwise what the plain versions give: ``bm25_block_scores_plain`` (with
and without ``live``) and ``sparse_scores_plain`` (the four functions:
the mirror takes the plain version's own contributions). Inputs are
``tests/torch_inputs.py``'s DENSE_TILE_CASES at a small tile (64 to 1,024
docs) so that every path is reached at a small size, and scaled onto the
card's 8,192-doc tile. Two cases are also held against the JAX package's
``bm25_block_scores`` and ``sparse_scores`` on the CPU, within the
tolerance of ``tests/test_torch_dense.py`` / ``tests/test_torch_sparse.py``
(the reference adds f32 contributions in posting order, the port sums them
exactly and rounds once).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import bm25 as ref_bm25
from elasticsearch_tpu.ops import sparse as ref_sparse
from elasticsearch_tpu_torch.ops import bm25 as bm
from elasticsearch_tpu_torch.ops import sparse
from torch_inputs import CARD_TILE, DENSE_TILE_CASES, dense_tile_case

FUNCTIONS = {"saturation": (0.7, 1.0), "log": (1.5, 1.0),
             "sigmoid": (1.2, 0.6), "linear": (1.0, 1.0)}
RTOL = 1e-6
ATOL = 1e-8


def same_bits(got, want):
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def bm25_args(c, live):
    return (c["bd"], c["bt"], c["bi"], c["w"], c["dl"], c["avgdl"],
            c["n_pad"], c["live"] if live else None)


def sparse_args(c, function, live):
    pivot, exponent = FUNCTIONS[function]
    return (c["bd"], c["bw"], c["bi"], c["w"], pivot, exponent, c["n_pad"],
            function, c["live"] if live else None)


@pytest.mark.parametrize("live", [False, True], ids=["all_live", "live"])
@pytest.mark.parametrize("name", sorted(DENSE_TILE_CASES))
def test_bm25_mirror_equals_plain(name, live):
    """K8: the mirror is ``bm25_block_scores_plain`` bitwise."""
    c = dense_tile_case(name)
    args = bm25_args(c, live)
    row, stats = bm.bm25_dense_mirror(*args, tile_docs=c["tile"])
    same_bits(row, bm.bm25_block_scores_plain(*args))
    assert stats["list_entries"] >= stats["entries_binned"]


@pytest.mark.parametrize("live", [False, True], ids=["all_live", "live"])
@pytest.mark.parametrize("function", sorted(FUNCTIONS))
@pytest.mark.parametrize("name", sorted(DENSE_TILE_CASES))
def test_sparse_mirror_equals_plain(name, function, live):
    """K19: the mirror is ``sparse_scores_plain`` bitwise, each function."""
    c = dense_tile_case(name)
    args = sparse_args(c, function, live)
    row, stats = sparse.sparse_dense_mirror(*args, tile_docs=c["tile"])
    same_bits(row, sparse.sparse_scores_plain(*args))
    assert (stats["extra_posting_reads"] > 0) == (
        name == "blocks_out_of_order")


def test_cases_reach_every_path():
    """The cases take every branch of the dense row: a query of padding
    alone (nothing binned, a row of zeros), tiles no block reaches, blocks
    within one tile and spanning many (one spanning most of the row's
    tiles), a repeated term binned twice, blocks out of order read whole,
    a tile of at least 16 blocks (Bm25Policy stages its doc lengths), a
    ragged last tile and a row below one tile."""
    stats = {}
    for name in DENSE_TILE_CASES:
        c = dense_tile_case(name)
        row, st = bm.bm25_dense_mirror(*bm25_args(c, True),
                                       tile_docs=c["tile"])
        stats[name] = (c, row, st)
    c, row, st = stats["all_padding"]
    assert st["entries_binned"] == 0 and not bool(row.any())
    assert all(stats[n][2]["tiles_reached"] < stats[n][2]["n_tiles"]
               for n in ("spanning_blocks", "crowded_tiles",
                         "block_spanning_most_tiles",
                         "dead_docs_and_padding"))
    assert all(s["spans"] > 0 for n, (_c, _r, s) in stats.items()
               if n not in ("all_padding", "below_one_tile"))
    assert stats["crowded_tiles"][2]["entries_binned"] > \
        stats["crowded_tiles"][2]["spans"]
    c, _row, st = stats["block_spanning_most_tiles"]
    wide = c["bd"][c["bi"][int((c["w"] != 0).sum()) - 1]].tolist()
    tiles, ascending = bm.doc_tiles(wide, st["n_tiles"], c["tile"])
    assert ascending and len(tiles) > st["n_tiles"] // 2
    c, _row, st = stats["repeated_term"]
    listed = c["bi"][c["w"] != 0].tolist()
    assert len(listed) > len(set(listed))
    assert st["entries_binned"] == len(listed)
    c, _row, st = stats["blocks_out_of_order"]
    blocks = c["bi"][c["w"] != 0].tolist()
    assert any(not bm.doc_tiles(c["bd"][b].tolist(), st["n_tiles"],
                                c["tile"])[1] for b in blocks)
    c, _row, st = stats["crowded_tiles"]
    per_tile = {}
    for b in c["bi"][c["w"] != 0].tolist():
        for t, _p0, _p1 in bm.doc_tiles(c["bd"][b].tolist(), st["n_tiles"],
                                        c["tile"])[0]:
            per_tile[t] = per_tile.get(t, 0) + 1
    assert max(per_tile.values()) >= 16
    c, _row, st = stats["ragged_last_tile"]
    assert c["n_pad"] % c["tile"] != 0
    c, _row, st = stats["below_one_tile"]
    assert c["n_pad"] < c["tile"] and st["n_tiles"] == 1


@pytest.mark.parametrize("name", sorted(DENSE_TILE_CASES))
def test_scaled_cases_at_the_card_tile(name):
    """Each case spread onto the card's 8,192-doc tiles (as
    ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` launch it): the
    mirror at that tile is still the plain versions bitwise, and bins what
    it binned at the small tile."""
    small = dense_tile_case(name)
    c = dense_tile_case(name, CARD_TILE // small["tile"])
    assert c["tile"] == bm.TILE_DOCS
    args = bm25_args(c, True)
    row, stats = bm.bm25_dense_mirror(*args)
    same_bits(row, bm.bm25_block_scores_plain(*args))
    small_stats = bm.bm25_dense_mirror(*bm25_args(small, True),
                                       tile_docs=small["tile"])[1]
    assert stats == small_stats
    args = sparse_args(c, "linear", True)
    row, stats = sparse.sparse_dense_mirror(*args)
    same_bits(row, sparse.sparse_scores_plain(*args))
    assert stats == sparse.sparse_dense_mirror(
        *sparse_args(small, "linear", True), tile_docs=small["tile"])[1]


def test_doc_tiles_partitions_a_block():
    """``doc_tiles`` (csrc/tiles.cuh's): docs that ascend, with holes,
    give each tile holding a doc one run, the runs partition the block
    from its first valid doc, and every valid doc lies in its own tile's
    run; docs out of order give each such tile once, read whole."""
    rng = np.random.default_rng(7)
    tile, n_tiles = 64, 40
    for _ in range(200):
        docs = np.sort(rng.choice(n_tiles * tile, 128, replace=False))
        docs[rng.random(128) < rng.uniform(0.0, 0.9)] = -1
        docs = docs.tolist()
        runs, ascending = bm.doc_tiles(docs, n_tiles, tile)
        valid = [i for i, d in enumerate(docs) if d >= 0]
        assert ascending
        assert [t for t, _p0, _p1 in runs] == sorted(
            {docs[i] // tile for i in valid})
        if valid:
            assert runs[0][1] == valid[0] and runs[-1][2] == 128
        assert all(a[2] == b[1] for a, b in zip(runs, runs[1:]))
        for i in valid:
            t, p0, p1 = next(r for r in runs if r[1] <= i < r[2])
            assert t == docs[i] // tile
        shuffled = rng.permutation(docs).tolist()
        runs, ascending = bm.doc_tiles(shuffled, n_tiles, tile)
        order = [d for d in shuffled if d >= 0]
        if any(b < a for a, b in zip(order, order[1:])):
            assert not ascending
            assert sorted(t for t, _p0, _p1 in runs) == sorted(
                {d // tile for d in order})
            assert all((p0, p1) == (0, 128) for _t, p0, p1 in runs)


@pytest.mark.parametrize("name", ["spanning_blocks", "dead_docs_and_padding"])
def test_cases_against_the_reference(name):
    """The port's K8 and K19 (their wrappers on CPU tensors: the plain
    versions) against the JAX package's ``bm25_block_scores`` and
    ``sparse_scores`` on two cases; the live mask applied as
    ``Bm25Executor.scores`` / ``SparseExecutor.scores`` apply it."""
    c = dense_tile_case(name)
    live = c["live"].numpy()
    ref_in = [jnp.asarray(c[k].numpy()) for k in ("bd", "bt", "bi", "w",
                                                  "dl")]
    want = np.where(live, np.asarray(ref_bm25.bm25_block_scores(
        *ref_in, jnp.float32(c["avgdl"]), c["n_pad"])), 0.0)
    got = bm.bm25_block_scores(*bm25_args(c, True)).numpy()
    np.testing.assert_array_equal(got > 0.0, want > 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for function, (pivot, exponent) in FUNCTIONS.items():
        want = np.where(live, np.asarray(ref_sparse.sparse_scores(
            jnp.asarray(c["bd"].numpy()), jnp.asarray(c["bw"].numpy()),
            jnp.asarray(c["bi"].numpy()), jnp.asarray(c["w"].numpy()),
            jnp.float32(pivot), jnp.float32(exponent), c["n_pad"],
            function)), 0.0)
        got = sparse.sparse_scores(*sparse_args(c, function, True)).numpy()
        np.testing.assert_array_equal(got != 0.0, want != 0.0)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
