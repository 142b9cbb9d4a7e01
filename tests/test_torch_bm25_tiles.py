"""The BM25 tile pipeline (csrc/tiles.cuh, Bm25Policy) mirrored on the CPU.

``ops/bm25.py`` ``bm25_tiles_mirror`` runs the kernels' algorithm step by
step -- binning through the block ranges, tile sums, tile tops, the
threshold, the reruns, the final selection and the -inf fill -- and must
give bitwise what the plain versions give: ``bm25_flat_plain`` (K1, with
its count), ``bm25_flat_seg_plain`` (K2), ``bm25_coarse_plain`` (K3) and,
slot by slot, ``mesh_bm25_flat_plain`` / ``mesh_bm25_coarse_plain`` (rows
31 and 32). Inputs are seeded numpy postings: terms whose docs ascend
through their blocks, frequent terms packed in narrow doc ranges and rare
ones spread over many tiles, at a small tile (64 to 1,024 docs) so that
every path is reached at a small size.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import bm25 as bm
from elasticsearch_tpu_torch.ops.device_segment import block_ranges
from elasticsearch_tpu_torch.parallel import mesh
from torch_inputs import TILE_CASES, tile_case, tile_slots


def run_mirror(c, family, k):
    bf16 = family == "bm25_coarse"
    bt = c["bt"].to(torch.bfloat16) if bf16 else c["bt"]
    dl = c["dl"].to(torch.bfloat16) if bf16 else c["dl"]
    return bm.bm25_tiles_mirror(
        c["bd"], bt, c["fi"], c["fw"], c["fq"], dl, c["fa"], c["live"],
        c["seg"], c["n_pad"], c["n_q"], k, bf16=bf16, n_segs=c["n_segs"],
        tile_docs=c["tile"])


def check_stats(stats, name):
    assert all(n <= cap for n, cap in zip(stats["final_lengths"],
                                          stats["final_caps"])), stats
    assert stats["list_entries"] >= stats["entries_binned"]
    if name == "spanning_blocks":
        assert stats["list_entries"] > 2 * stats["entries_binned"]


@pytest.mark.parametrize("family", ["bm25_flat", "bm25_flat_seg",
                                    "bm25_coarse"])
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_mirror_equals_plain(name, family):
    c = tile_case(name)
    args = (c["bd"], c["bt"], c["fi"], c["fw"], c["fq"], c["dl"], c["fa"],
            c["live"])
    if family == "bm25_flat":
        k = c["k"]
        s, d, hits = bm.bm25_flat_plain(*args, c["n_pad"], c["n_q"], k,
                                        counted=True)
        want = (s, d, hits)
    elif family == "bm25_flat_seg":
        k = c["k"]
        want = bm.bm25_flat_seg_plain(*args, c["seg"], c["n_pad"], c["n_q"],
                                      k, n_segs=c["n_segs"])
    else:
        k = c["kp"]
        want = bm.bm25_coarse_plain(
            c["bd"], c["bt"].to(torch.bfloat16), c["fi"], c["fw"], c["fq"],
            c["dl"].to(torch.bfloat16), c["fa"], c["live"], c["seg"],
            c["n_pad"], c["n_q"], c["n_segs"], k)
    s, d, matches, seg_hits, stats = run_mirror(c, family, k)
    got = (s, d, matches if family == "bm25_flat" else seg_hits)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) if not g.dtype.is_floating_point else \
            torch.equal(g.view(torch.int32), w.view(torch.int32))
    check_stats(stats, name)


def test_cases_reach_every_path():
    """The cases above take the threshold path with reruns, the -inf fill
    in tiles no entry touched, rows with no entries, and t of 1, 16 (the
    tops alone), 64 and 256."""
    seen = {"reruns": 0, "fill": 0, "tops": set()}
    for name in sorted(TILE_CASES):
        c = tile_case(name)
        for k in (c["k"], c["kp"]):
            s, d, matches, _h, stats = run_mirror(c, "bm25_flat", k)
            seen["reruns"] += stats["reruns"]
            seen["tops"].add(stats["tops"])
            for r in range(c["n_q"]):
                m = int(matches[r])
                touched = stats["tiles_of_row"][r]
                seen["fill"] += m < k and any(
                    int(x) // c["tile"] not in touched for x in d[r, m:])
    assert seen["reruns"] > 0
    assert seen["fill"] > 0
    assert seen["tops"] == {1, 16, 64, 256}


def test_block_ranges():
    """The least and greatest valid doc of every block, whatever the order
    of its docs; (2^31 - 1, -1) for an empty block; cached per store."""
    rng = np.random.default_rng(11)
    bd = rng.integers(0, 5000, (300, 128)).astype(np.int32)
    bd[rng.random((300, 128)) < 0.3] = -1
    bd[7] = -1
    t = torch.as_tensor(bd)
    got = block_ranges(t)
    for i in range(300):
        v = bd[i][bd[i] >= 0]
        want = (v.min(), v.max()) if v.size else (2 ** 31 - 1, -1)
        assert tuple(got[i].tolist()) == tuple(int(x) for x in want)
    assert block_ranges(t) is got
    t[0, 0] = 4999
    assert int(block_ranges(t)[0, 1]) == 4999
    stacked = torch.stack([t, t.flip(1)])
    assert torch.equal(block_ranges(stacked)[0], block_ranges(stacked)[1])


@pytest.mark.parametrize("family", ["mesh_bm25_flat", "mesh_bm25_coarse"])
def test_mirror_per_slot_equals_mesh_plain(family):
    """S 4 slots (the last empty): each slot of rows 31 / 32's plain
    versions is the mirror on that slot's plane."""
    c = tile_slots()
    n_pad, n_q, n_segs = c["n_pad"], c["n_q"], c["n_segs"]
    bd, bt, dl = c["bd"], c["bt"], c["dl"]
    fi, fw, fq, fa = c["fi"], c["fw"], c["fq"], c["fa"]
    bf16 = family == "mesh_bm25_coarse"
    if bf16:
        k = 256
        bt, dl = bt.to(torch.bfloat16), dl.to(torch.bfloat16)
        want = mesh.mesh_bm25_coarse_plain(
            bd, bt, dl, fi, fw, fq, fa, c["live"], c["seg"], n_pad, n_q, k,
            n_segs)
    else:
        k = 10
        want = mesh.mesh_bm25_flat_plain(
            bd, bt, dl, fi[:, None], fw[:, None], fq[:, None], fa[:, None],
            c["live"], c["seg"], n_pad, n_q, k, n_segs)
        want = tuple(x[:, 0] for x in want)
    for s in range(bd.shape[0]):
        got = bm.bm25_tiles_mirror(
            bd[s], bt[s], fi[s], fw[s], fq[s], dl[s], fa[s], c["live"][s],
            c["seg"][s], n_pad, n_q, k, bf16=bf16, n_segs=n_segs,
            tile_docs=c["tile"])
        assert torch.equal(got[0].view(torch.int32),
                           want[0][s].view(torch.int32))
        assert torch.equal(got[1], want[1][s])
        assert torch.equal(got[3], want[2][s])


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_scaled_cases_at_the_card_tile(name):
    """Each case spread onto the card's 8,192-doc tiles (as
    ``tests/test_torch_cuda.py`` launches it): the mirror at that tile is
    still K1's plain version bitwise, and reaches the same tiles."""
    small = tile_case(name)
    scale = 8192 // small["tile"]
    c = tile_case(name, scale)
    assert c["tile"] == bm.TILE_DOCS
    k = c["k"]
    want = bm.bm25_flat_plain(c["bd"], c["bt"], c["fi"], c["fw"], c["fq"],
                              c["dl"], c["fa"], c["live"], c["n_pad"],
                              c["n_q"], k, counted=True)
    s, d, matches, _h, stats = bm.bm25_tiles_mirror(
        c["bd"], c["bt"], c["fi"], c["fw"], c["fq"], c["dl"], c["fa"],
        c["live"], None, c["n_pad"], c["n_q"], k)
    assert torch.equal(s.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(d, want[1])
    assert torch.equal(matches, want[2])
    small_stats = run_mirror(small, "bm25_flat", small["k"])[4]
    assert stats["pairs"] == small_stats["pairs"]
