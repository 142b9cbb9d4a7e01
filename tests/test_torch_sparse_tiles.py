"""The rank_features tile pipeline (csrc/tiles.cuh, FeaturePolicy) mirrored
on the CPU.

``ops/sparse.py`` ``sparse_tiles_mirror`` runs the kernels' algorithm step
by step -- binning through the block ranges, each spanning block's run of
positions a tile, tile sums, tile tops, the threshold, the reruns, the
final selection and the -inf fill -- over the plain version's own
contributions, and must give bitwise what the plain versions give:
``sparse_flat_plain`` (K15, the four functions, counted and not),
``sparse_coarse_plain`` (K16) and, slot by slot,
``mesh_sparse_topk_plain`` / ``mesh_sparse_coarse_plain`` (rows 38 and
34). Inputs are seeded numpy features whose docs ascend through their
blocks, frequent features packed in narrow doc ranges and rare ones spread
over many tiles, at a small tile (64 to 1,024 docs) so that every path is
reached at a small size. One case is held against the JAX package's
``sparse_topk_batch`` and ``sparse_coarse_kernel`` on the CPU: ids exact
outside near-ties, scores within rtol 1e-6 (the reference adds f32
contributions in posting order, the port sums them exactly and rounds
once).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import sparse as ref
from elasticsearch_tpu_torch.ops import bm25 as bm
from elasticsearch_tpu_torch.ops import sparse
from elasticsearch_tpu_torch.parallel import mesh
from test_torch_bm25 import assert_topk_match
from torch_inputs import (
    CARD_TILE, SPARSE_TILE_CASES, feature_postings, sparse_tile_case,
    sparse_tile_slots,
)

FUNCTIONS = {"saturation": (0.7, 1.0), "log": (1.5, 1.0),
             "sigmoid": (1.2, 0.6), "linear": (1.0, 1.0)}


def same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)) \
            if g.dtype.is_floating_point else torch.equal(g, w)


def mirror(c, k, function="linear", bf16=False, **kw):
    pivot, exponent = FUNCTIONS[function]
    bw = c["bw"].to(torch.bfloat16) if bf16 else c["bw"]
    return sparse.sparse_tiles_mirror(
        c["bd"], bw, c["bi"], c["bq"], c["live"], c["n_pad"], k,
        function=function, pivot=pivot, exponent=exponent, bf16=bf16,
        tile_docs=c["tile"], **kw)


def check_stats(stats, name):
    assert all(n <= cap for n, cap in zip(stats["final_lengths"],
                                          stats["final_caps"])), stats
    assert stats["list_entries"] >= stats["entries_binned"]
    if name == "spanning_blocks":
        assert stats["list_entries"] > 2 * stats["entries_binned"]
    assert (stats["extra_posting_reads"] > 0) == (
        name == "blocks_out_of_order")


@pytest.mark.parametrize("function", sorted(FUNCTIONS))
@pytest.mark.parametrize("name", sorted(SPARSE_TILE_CASES))
def test_mirror_equals_flat_plain(name, function):
    """K15: the mirror is ``sparse_flat_plain`` bitwise, counted and not
    (log and sigmoid too: the mirror takes the plain version's ops)."""
    c = sparse_tile_case(name)
    pivot, exponent = FUNCTIONS[function]
    args = (c["bd"], c["bw"], c["bi"], c["bq"], pivot, exponent, c["live"],
            c["n_pad"], c["k"], function)
    s, d, matches, stats = mirror(c, c["k"], function)
    same_bits((s, d), sparse.sparse_flat_plain(*args))
    same_bits((s, d, matches), sparse.sparse_flat_plain(*args,
                                                        counted=True))
    assert torch.isinf(s[c["n_real"]:]).all()
    check_stats(stats, name)


@pytest.mark.parametrize("name", sorted(SPARSE_TILE_CASES))
def test_mirror_equals_coarse_plain(name):
    """K16: the mirror over the bf16 mirror is ``sparse_coarse_plain``
    bitwise, counts included."""
    c = sparse_tile_case(name)
    s, d, matches, stats = mirror(c, c["kp"], bf16=True)
    want = sparse.sparse_coarse_plain(
        c["bd"], c["bw"].to(torch.bfloat16), c["bi"], c["bq"], c["live"],
        c["n_pad"], c["kp"])
    same_bits((s, d, matches), want)
    check_stats(stats, name)


def test_cases_reach_every_path():
    """The cases take the threshold path with reruns, the -inf fill in
    tiles no entry touched, rows with no entries, t of 1, 16 (the tops
    alone), 64 and 256, and a block read whole for being out of order."""
    seen = {"reruns": 0, "fill": 0, "empty": 0, "extra": 0, "tops": set()}
    for name in sorted(SPARSE_TILE_CASES):
        c = sparse_tile_case(name)
        for k in (c["k"], c["kp"]):
            s, d, matches, stats = mirror(c, k)
            seen["reruns"] += stats["reruns"]
            seen["extra"] += stats["extra_posting_reads"]
            seen["tops"].add(stats["tops"])
            for r in range(c["n_q"]):
                m = int(matches[r])
                touched = stats["tiles_of_row"][r]
                seen["empty"] += not touched
                seen["fill"] += m < k and any(
                    int(x) // c["tile"] not in touched for x in d[r, m:])
    assert seen["reruns"] > 0 and seen["fill"] > 0 and seen["empty"] > 0
    assert seen["extra"] > 0
    assert seen["tops"] == {1, 16, 64, 256}


def test_block_runs():
    """``block_runs``: consecutive runs that partition an ascending block
    (holes included), one tile a run; a block out of order whole in every
    tile, its reads beyond one pass counted."""
    docs = [-1, 3, 5, 70, -1, 71, 200, 260, -1] + [-1] * 119
    runs, extra = bm.block_runs(docs, 0, 4, tile_docs=64)
    assert extra == 0
    assert runs == {0: (0, 3), 1: (3, 6), 2: (6, 6), 3: (6, 7),
                    4: (7, 128)}
    runs, extra = bm.block_runs([5, 3] + [-1] * 126, 0, 2, tile_docs=2)
    assert runs == {t: (0, 128) for t in range(3)} and extra == 256


@pytest.mark.parametrize("family", ["mesh_sparse_topk",
                                    "mesh_sparse_coarse"])
def test_mirror_per_slot_equals_mesh_plain(family):
    """S 4 slots (the last empty), DP 2 for row 38: each (slot, dp row) of
    rows 38 / 34's plain versions is the mirror on that slot's store."""
    c = sparse_tile_slots()
    n_pad = c["n_pad"]
    bd, bw, bi, bq, live = c["bd"], c["bw"], c["bi"], c["bq"], c["live"]
    if family == "mesh_sparse_topk":
        k = 10
        want = mesh.mesh_sparse_topk_plain(bd, bw, bi, bq, live, n_pad, k)
        lists = [(s, r) for s in range(bd.shape[0])
                 for r in range(bi.shape[1])]
    else:
        k = 128
        bw = bw.to(torch.bfloat16)
        bi, bq = bi[:, 0].contiguous(), bq[:, 0].contiguous()
        want = mesh.mesh_sparse_coarse_plain(bd, bw, bi, bq, live, n_pad, k)
        lists = [(s,) for s in range(bd.shape[0])]
    for at in lists:
        s = at[0]
        got = sparse.sparse_tiles_mirror(
            bd[s], bw[s], bi[at], bq[at], live[s], n_pad, k,
            bf16=family == "mesh_sparse_coarse", tile_docs=c["tile"])
        same_bits(got[:3], [x[at] for x in want])


@pytest.mark.parametrize("name", ["spanning_blocks", "blocks_out_of_order",
                                  "ties_across_tiles"])
def test_scaled_cases_at_the_card_tile(name):
    """A case spread onto the card's 8,192-doc tiles (as
    ``tests/test_torch_cuda.py`` launches it): the mirror at that tile is
    still K15's plain version bitwise and reaches the same pairs."""
    small = sparse_tile_case(name)
    c = sparse_tile_case(name, CARD_TILE // small["tile"])
    assert c["tile"] == bm.TILE_DOCS
    s, d, matches, stats = sparse.sparse_tiles_mirror(
        c["bd"], c["bw"], c["bi"], c["bq"], c["live"], c["n_pad"], c["k"])
    want = sparse.sparse_flat_plain(
        c["bd"], c["bw"], c["bi"], c["bq"], 1.0, 1.0, c["live"], c["n_pad"],
        c["k"], "linear", counted=True)
    same_bits((s, d, matches), want)
    assert stats["pairs"] == mirror(small, small["k"])[3]["pairs"]


@pytest.mark.parametrize("function", ["saturation", "linear"])
def test_mirror_against_the_reference(function):
    """The mirror against the JAX package's ``sparse_topk_batch`` (K15,
    counted) and ``sparse_coarse_kernel`` (K16) on a spanning case: ids
    exact outside near-ties, scores within rtol 1e-6, counts exact."""
    c = sparse_tile_case("spanning_blocks")
    pivot, exponent = FUNCTIONS[function]
    j = {key: jnp.asarray(c[key].numpy()) for key in ("bd", "bw", "bi",
                                                      "bq", "live")}
    want = ref.sparse_topk_batch(j["bd"], j["bw"], j["bi"], j["bq"],
                                 jnp.float32(pivot), jnp.float32(exponent),
                                 j["live"], c["n_pad"], c["k"], function,
                                 counted=True)
    s, d, matches, _stats = mirror(c, c["k"], function)
    assert_topk_match(want[0], want[1], s, d, rtol=1e-6)
    np.testing.assert_array_equal(matches.numpy(), np.asarray(want[2]))
    cs, cand, hits = ref.sparse_coarse_kernel(
        j["bd"], jnp.asarray(c["bw"].to(torch.bfloat16).float().numpy()
                             ).astype(jnp.bfloat16), j["bi"], j["bq"],
        j["live"], c["n_pad"], c["kp"])
    s, d, matches, _stats = mirror(c, c["kp"], bf16=True)
    assert_topk_match(cs, cand, s, d, rtol=1e-6)
    np.testing.assert_array_equal(matches.numpy(), np.asarray(hits))


def test_every_features_store_carries_block_ranges():
    """A segment's ``DeviceFeatures``, the features plane and the mesh
    stack compute their block ranges when they upload (the tile kernels
    bin by them), and the bf16 mirrors share the block docs."""
    from elasticsearch_tpu_torch.index.segment import FeaturesField, Segment
    from elasticsearch_tpu_torch.ops import device_segment as ds
    rng = np.random.default_rng(5)
    segs = []
    for i in range(2):
        bd, bw, of_feat = feature_postings(rng, 900, 12, 0.5)
        starts = [ids[0] for ids in of_feat]
        seg = Segment(f"s{i}", 900)
        seg.features["ml"] = FeaturesField(
            features={f"f{j}": j for j in range(len(of_feat))},
            block_docs=bd, block_weights=bw,
            block_max_weight=bw.max(axis=1),
            feat_block_start=np.asarray(starts, np.int64),
            feat_block_count=np.asarray([len(x) for x in of_feat], np.int64),
            doc_freq=np.asarray([int((bd[ids] >= 0).sum()) for ids in of_feat],
                                np.int64))
        seg.ids = [str(j) for j in range(900)]
        seg.invalidate_live_count()
        segs.append(seg)

    def cached(store):
        hit = ds._RANGES.get(id(store))
        return hit is not None and hit[0]() is store

    dev = ds.DeviceFeatures.for_segment(segs[0], "ml", "cpu")
    assert cached(dev.block_docs)
    ds.PLANES.clear()
    part = ds.PLANES.get(segs, "features", "ml", device="cpu")
    assert part is not None and cached(part.block_docs)
    assert torch.equal(ds.block_ranges(part.block_docs),
                       ds.block_ranges(part.block_docs.clone()))
    stack = ds.MESH_PLANES.get([(("idx", i), [seg]) for i, seg in
                                enumerate(segs)], "features", "ml",
                               device="cpu")
    assert stack is not None and cached(stack.block_docs)
    assert stack.quantized_mirror()[0].shape == stack.block_docs.shape
    ds.PLANES.clear()
    ds.MESH_PLANES.clear()
