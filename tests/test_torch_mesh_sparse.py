"""The mesh's sparse path of elasticsearch_tpu_torch against the JAX package.

Four layers, each on the same seeded inputs in both packages:

- the kernels: the plain versions of ``mesh_sparse_topk``,
  ``mesh_sparse_coarse`` and ``mesh_sparse_rerank`` (``parallel/mesh.py``)
  against the JAX package's shard_map programs, which run on the CPU under
  ``tests/conftest.py``'s 8 virtual devices in 1-device, 2-device and 2x2
  ``(dp, shard)`` layouts, at 2 and 4 slots (one of the 4 empty); and each
  slot against the one-shard plain versions (K15 / K16 / K17's) on that
  shard's own plane;
- the stacked rank_features plane: ``MeshPlaneRegistry``'s features kind
  against the reference's stack, and its bf16 mirror bitwise against each
  shard's own ``PlaneFeatures.quantized_mirror()`` and the reference's;
- ``plane_exec.mesh_sparse_topk`` against the reference's on the same
  shards (tier on and off, deletes, a shard without the field, a window of
  5,000), and the reference's own identities on the port (mesh == the
  shard batcher's ``batched_sparse_shard``, the dp split, mesh == the
  per-shard plane);
- the served path: a port node's ``_search`` JSON against a reference
  node's on 2 and 4 shards for ``text_expansion`` bodies (``tokens``,
  ``model_text``, ``boost``, totals tracked / clipped / disabled, a
  ``bool`` wrapper, ``rank.rrf`` with a sparse leg), ``_data_plane``
  included, and the port's own mesh == fan-out identity.

Tolerances (ROADMAP queue 3, items 3 and 4): ids, hits, totals and counts
exact; f32 scores to rtol 1e-6, because the reference adds f32
contributions one by one in posting order and the port sums them in 64-bit
fixed point and rounds once (at most a few ulps apart); ids whose reference
scores lie within that tolerance of each other are compared as a set; eps
(a difference of scores) to that tolerance times the scores' scale. A
``model_text`` score also takes the expansion rounding bound of item 4.
The port's own mesh == one-shard == fan-out identities are bitwise.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import device_segment as ref_ds
from elasticsearch_tpu.parallel import mesh as ref_mesh
from elasticsearch_tpu_torch.ops import device_segment as ds
from elasticsearch_tpu_torch.ops import sparse as port_sparse
from elasticsearch_tpu_torch.parallel import mesh as port_mesh
from elasticsearch_tpu_torch.search import batch_executor as be
from elasticsearch_tpu_torch.search import plane_exec as pe
from elasticsearch_tpu_torch.search import telemetry
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from test_torch_bm25 import assert_topk_match
from test_torch_mesh import (  # noqa: F401 (an autouse fixture)
    PORT, REF, _mesh_defaults, _reset, _set_mesh, node_pair,
)
from test_torch_node import bulk_lines, same
from torch_inputs import mesh_sparse_inputs

RTOL = 1e-6
K = 10
N_Q = 4


def T(a):
    return torch.as_tensor(a)


def J(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# kernels: seeded stacked planes (torch_inputs.mesh_sparse_inputs)
# ---------------------------------------------------------------------------

def ref_layout(n_slots: int, dp: int, devices: int):
    mesh, n_slots_got, _ = ref_mesh.mesh_layout(n_slots, dp=dp,
                                                max_devices=devices)
    assert n_slots_got == n_slots
    return mesh


LAYOUTS = [(1, 1), (1, 2), (2, 4)]      # (dp, devices)
SLOTS = [(2, -1), (4, 2)]               # (S, empty slot)


def _row0(inp):
    """The [S, Q, QB] lists of the coarse and re-rank tiers (each slot's
    dp row 0)."""
    return (np.ascontiguousarray(inp["idx"][:, 0]),
            np.ascontiguousarray(inp["qw"][:, 0]))


@pytest.mark.parametrize("n_slots,empty", SLOTS,
                         ids=["s2", "s4_empty_slot"])
@pytest.mark.parametrize("dp,devices", LAYOUTS,
                         ids=["1dev", "2dev", "dp2x2dev"])
def test_mesh_sparse_topk_matches_reference(dp, devices, n_slots, empty):
    inp = mesh_sparse_inputs(61 + n_slots + 7 * dp, n_slots, dp, N_Q,
                             empty=empty)
    n_pad = inp["n_pad"]
    fn = ref_mesh.mesh_sparse_topk(ref_layout(n_slots, dp, devices), n_pad,
                                   K)
    names = ("docs", "weights", "idx", "qw", "live")
    s_r, d_r, h_r = fn(*(J(inp[n]) for n in names))
    s, d, h = port_mesh.mesh_sparse_topk(*(T(inp[n]) for n in names), n_pad,
                                         K)
    assert s.shape == d.shape == (n_slots, dp, N_Q, K)
    assert h.shape == (n_slots, dp, N_Q) and h.dtype == torch.int32
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_r))
    for si in range(n_slots):
        for r in range(dp):
            assert_topk_match(np.asarray(s_r)[si, r], np.asarray(d_r)[si, r],
                              s[si, r], d[si, r], rtol=RTOL)
    if empty >= 0:
        assert not torch.isfinite(s[empty]).any()
        assert int(h[empty].sum()) == 0
        # all -inf: lax.top_k's lower-index-first order
        assert (d[empty] == torch.arange(K, dtype=torch.int32)).all()


@pytest.mark.parametrize("n_slots,empty", SLOTS,
                         ids=["s2", "s4_empty_slot"])
@pytest.mark.parametrize("dp,devices", LAYOUTS,
                         ids=["1dev", "2dev", "dp2x2dev"])
def test_mesh_sparse_coarse_and_rerank_match_reference(dp, devices, n_slots,
                                                       empty):
    inp = mesh_sparse_inputs(73 + n_slots + 5 * dp, n_slots, 1, N_Q,
                             empty=empty)
    n_pad, kprime = inp["n_pad"], 64
    idx, qw = _row0(inp)
    mesh = ref_layout(n_slots, dp, devices)
    c_fn = ref_mesh.mesh_sparse_coarse(mesh, n_pad, kprime)
    cs_r, cand_r, h_r = c_fn(J(inp["docs"]),
                             J(inp["weights"]).astype(jnp.bfloat16), J(idx),
                             J(qw), J(inp["live"]))
    cs, cand, h = port_mesh.mesh_sparse_coarse(
        T(inp["docs"]), T(inp["weights"]).to(torch.bfloat16), T(idx), T(qw),
        T(inp["live"]), n_pad, kprime)
    assert cs.shape == cand.shape == (n_slots, N_Q, kprime)
    assert h.shape == (n_slots, N_Q)
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_r))
    for si in range(n_slots):
        assert_topk_match(np.asarray(cs_r)[si], np.asarray(cand_r)[si],
                          cs[si], cand[si], rtol=RTOL)
    # both tiers re-rank the SAME candidates (the reference's)
    r_fn = ref_mesh.mesh_sparse_rerank(mesh, n_pad, kprime, K)
    s_r, d_r, eps_r = r_fn(J(inp["docs"]), J(inp["weights"]), J(idx), J(qw),
                           J(inp["live"]), cand_r, cs_r)
    cand_h, cs_h = np.array(cand_r), np.array(cs_r)
    s, d, eps = port_mesh.mesh_sparse_rerank(
        T(inp["docs"]), T(inp["weights"]), T(idx), T(qw), T(inp["live"]),
        T(cand_h), T(cs_h), n_pad, kprime, K)
    assert s.shape == d.shape == (n_slots, N_Q, K)
    assert eps.shape == (n_slots, N_Q)
    for si in range(n_slots):
        assert_topk_match(np.asarray(s_r)[si], np.asarray(d_r)[si], s[si],
                          d[si], rtol=RTOL)
    top = 1.0 + np.abs(cs_h[np.isfinite(cs_h)]).max(initial=0.0)
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_r), rtol=0,
                               atol=2 * RTOL * top)
    if empty >= 0:
        assert (eps[empty] == 0).all() and int(h[empty].sum()) == 0


def _own(inp, si):
    """Slot ``si``'s store and live mask at its own size (its shard's
    one-plane layout)."""
    n_pad, nb = inp["own"][si]
    return (T(np.ascontiguousarray(inp["docs"][si, :nb])),
            T(np.ascontiguousarray(inp["weights"][si, :nb])),
            T(np.ascontiguousarray(inp["live"][si, :n_pad])), n_pad)


@pytest.mark.parametrize("n_slots,empty", SLOTS,
                         ids=["s2", "s4_empty_slot"])
def test_each_slot_is_the_one_shard_kernel_on_its_plane(n_slots, empty):
    """Per slot, the mesh plain versions equal K15/K16/K17's plain
    versions bitwise, on the slot of the stack and, for the finite hits
    and the counts, on the shard's own unpadded plane."""
    dp = 2
    inp = mesh_sparse_inputs(83 + n_slots, n_slots, dp, N_Q, empty=empty)
    n_pad, kprime = inp["n_pad"], 64
    docs, w, live = T(inp["docs"]), T(inp["weights"]), T(inp["live"])
    w16 = w.to(torch.bfloat16)
    idx4, qw4 = T(inp["idx"]), T(inp["qw"])
    idx, qw = (T(x) for x in _row0(inp))
    s, d, h = port_mesh.mesh_sparse_topk(docs, w, idx4, qw4, live, n_pad, K)
    cs, cand, ch = port_mesh.mesh_sparse_coarse(docs, w16, idx, qw, live,
                                                n_pad, kprime)
    ss, dd, eps = port_mesh.mesh_sparse_rerank(docs, w, idx, qw, live, cand,
                                               cs, n_pad, kprime, K)
    for si in range(n_slots):
        for r in range(dp):
            want = port_sparse.sparse_topk_batch(
                docs[si], w[si], idx4[si, r], qw4[si, r], 1.0, 1.0, live[si],
                n_pad, K, "linear", counted=True)
            for got, ref in zip((s[si, r], d[si, r], h[si, r]), want):
                assert torch.equal(got, ref)
        for got, ref in zip((cs[si], cand[si], ch[si]),
                            port_sparse.sparse_coarse_kernel(
                                docs[si], w16[si], idx[si], qw[si], live[si],
                                n_pad, kprime)):
            assert torch.equal(got, ref)
        for got, ref in zip((ss[si], dd[si], eps[si]),
                            port_sparse.sparse_rerank_kernel(
                                docs[si], w[si], idx[si], qw[si], live[si],
                                cand[si], cs[si], n_pad, kprime, K)):
            assert torch.equal(got, ref)
        # the shard's own plane: the same finite hits and counts
        odocs, ow, olive, on = _own(inp, si)
        want = port_sparse.sparse_topk_batch(
            odocs, ow, idx4[si, 0], qw4[si, 0], 1.0, 1.0, olive, on,
            min(K, on), "linear", counted=True)
        fin = torch.isfinite(s[si, 0])
        assert torch.equal(fin, torch.isfinite(want[0]))
        assert torch.equal(s[si, 0][fin], want[0][fin])
        assert torch.equal(d[si, 0][fin], want[1][fin])
        assert torch.equal(h[si, 0], want[2])


def test_wide_k_runs_over_every_slot_row():
    """k above the kernels' KMAX (the selection's rounds): each slot's row
    is still K15's plain version at that k, and the reference's."""
    inp = mesh_sparse_inputs(97, 2, 1, 2, per_q=60, n_docs=12_000)
    k, n_pad = 5000, inp["n_pad"]
    assert n_pad >= k
    names = ("docs", "weights", "idx", "qw", "live")
    s, d, h = port_mesh.mesh_sparse_topk(*(T(inp[n]) for n in names), n_pad,
                                         k)
    assert s.shape == (2, 1, 2, k)
    for si in range(2):
        want = port_sparse.sparse_topk_batch(
            T(inp["docs"][si]), T(inp["weights"][si]), T(inp["idx"][si, 0]),
            T(inp["qw"][si, 0]), 1.0, 1.0, T(inp["live"][si]), n_pad, k,
            "linear", counted=True)
        assert torch.equal(s[si, 0], want[0])
        assert torch.equal(d[si, 0], want[1])
        assert torch.equal(h[si, 0], want[2])
    fn = ref_mesh.mesh_sparse_topk(ref_layout(2, 1, 1), n_pad, k)
    s_r, d_r, h_r = fn(*(J(inp[n]) for n in names))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_r))
    for si in range(2):
        assert_topk_match(np.asarray(s_r)[si, 0], np.asarray(d_r)[si, 0],
                          s[si, 0], d[si, 0], rtol=RTOL)


def test_plain_mesh_sparse_calls_are_not_launches():
    """A call on CPU tensors runs the plain version: one call of each
    family, no launch."""
    inp = mesh_sparse_inputs(5, 2, 1, 2)
    n_pad = inp["n_pad"]
    fams = [DEVICE_PROFILE.family(f) for f in (
        "mesh_sparse_topk", "mesh_sparse_coarse", "mesh_sparse_rerank")]
    before = [(f.calls, f.launches) for f in fams]
    docs, w, live = T(inp["docs"]), T(inp["weights"]), T(inp["live"])
    idx, qw = (T(x) for x in _row0(inp))
    port_mesh.mesh_sparse_topk(docs, w, T(inp["idx"]), T(inp["qw"]), live,
                               n_pad, K)
    cs, cand, _h = port_mesh.mesh_sparse_coarse(
        docs, w.to(torch.bfloat16), idx, qw, live, n_pad, 16)
    port_mesh.mesh_sparse_rerank(docs, w, idx, qw, live, cand, cs, n_pad, 16,
                                 K)
    assert [(f.calls, f.launches) for f in fams] == \
        [(c + 1, n) for c, n in before]


def test_mesh_sparse_wrappers_refuse_bad_inputs():
    inp = mesh_sparse_inputs(6, 2, 1, 2)
    n_pad = inp["n_pad"]
    docs, w, live = T(inp["docs"]), T(inp["weights"]), T(inp["live"])
    idx4, qw4 = T(inp["idx"]), T(inp["qw"])
    idx, qw = (T(x) for x in _row0(inp))
    with pytest.raises(ValueError):             # a one-shard [NB, 128] store
        port_mesh.mesh_sparse_topk(docs[0], w[0], idx4, qw4, live, n_pad, K)
    with pytest.raises(ValueError):             # [S, Q, QB] lists to topk
        port_mesh.mesh_sparse_topk(docs, w, idx, qw, live, n_pad, K)
    with pytest.raises(ValueError):             # lists of the wrong slots
        port_mesh.mesh_sparse_coarse(docs, w.to(torch.bfloat16), idx[:1],
                                     qw[:1], live, n_pad, 16)
    with pytest.raises(ValueError):             # k above the plane
        port_mesh.mesh_sparse_topk(docs, w, idx4, qw4, live, n_pad,
                                   n_pad + 1)
    with pytest.raises(TypeError):              # the coarse pass given f32
        port_mesh.mesh_sparse_coarse(docs, w, idx, qw, live, n_pad, 16)
    cand = torch.zeros(2, 2, 8, dtype=torch.int32)
    with pytest.raises(ValueError):             # k above k'
        port_mesh.mesh_sparse_rerank(docs, w, idx, qw, live, cand,
                                     torch.zeros(2, 2, 8), n_pad, 8, 9)


# ---------------------------------------------------------------------------
# shards in both packages: the stacked plane and mesh_sparse_topk
# ---------------------------------------------------------------------------

FEATURES = [f"f{i}" for i in range(40)]
MAPPING = {"properties": {"feats": {"type": "rank_features"},
                          "tag": {"type": "keyword"}}}


def _shard_ops(seed: int, n_docs: int, with_feats: bool = True):
    """One shard's writes: 2-7 features of 40 a doc, weights in (0.1,
    3.1) at 3 decimals (every fifth doc without the field; docs 3, 17 and
    40 share one map, for score ties), refreshes splitting three segments,
    every 13th doc deleted."""
    rng = np.random.default_rng(seed)
    dup = {f: round(float(rng.random() * 3 + 0.1), 3)
           for f in rng.choice(FEATURES, 4, replace=False)}
    ops = []
    for i in range(n_docs):
        src = {"tag": f"t{i % 3}"}
        if with_feats and i % 5:
            src["feats"] = dict(dup) if i in (3, 17, 40) else {
                str(f): round(float(rng.random() * 3 + 0.1), 3)
                for f in rng.choice(FEATURES, int(rng.integers(2, 8)),
                                    replace=False)}
        ops.append(("index", str(i), src))
        if i in (n_docs // 3, 2 * n_docs // 3):
            ops.append(("refresh",))
    ops += [("delete", str(i)) for i in range(0, n_docs, 13)]
    ops.append(("refresh",))
    return ops


def _engines(pkg, seed: int, sizes, no_feats=()):
    engines = []
    for s, n_docs in enumerate(sizes):
        eng = pkg["engine"](pkg["mappers"](MAPPING),
                            shard_label=f"ms{seed}_{s}")
        for op in _shard_ops(seed + 100 * s, n_docs, s not in no_feats):
            if op[0] == "index":
                eng.index(op[1], op[2])
            elif op[0] == "delete":
                eng.delete(op[1])
            else:
                eng.refresh()
        engines.append(eng)
    return engines


def _ctxs(pkg, reader, mappers):
    return pkg["be"]._build_ctxs(reader, mappers,
                                 sum(s.n_docs for s in reader.segments),
                                 None, **pkg["kw"])


def _shard_set(pkg, seed, sizes, no_feats=()):
    engines = _engines(pkg, seed, sizes, no_feats)
    readers = [e.acquire_reader() for e in engines]
    mappers = engines[0].mappers
    ctxs = [_ctxs(pkg, r, mappers) for r in readers]
    segs = [(("idx", sid), list(r.segments)) for sid, r in enumerate(readers)]
    mpart = pkg["ds"].MESH_PLANES.get(segs, "features", "feats", **pkg["kw"])
    return readers, mappers, ctxs, mpart


def _expansions(seed: int = 3, n: int = 3):
    rng = np.random.default_rng(seed)
    out = [[(str(f), round(float(rng.random() * 2 + 0.2), 3))
            for f in rng.choice(FEATURES, int(rng.integers(2, 6)),
                                replace=False)] for _ in range(n - 1)]
    return out + [[("nowhere", 1.0)]]


def assert_rows_match(mine, ref, exact=False):
    """(candidates, total, max_score) rows: totals exact, ids exact
    outside tie groups (reference scores within RTOL), scores to RTOL
    (bitwise when ``exact``)."""
    assert mine[1] == ref[1]
    a = [(c.segment_idx, c.doc) for c in mine[0]]
    b = [(c.segment_idx, c.doc) for c in ref[0]]
    sa = np.array([c.score for c in mine[0]])
    sb = np.array([c.score for c in ref[0]])
    assert len(a) == len(b)
    if exact:
        assert a == b and mine[2] == ref[2]
        np.testing.assert_array_equal(sa, sb)
        return
    np.testing.assert_allclose(sa, sb, rtol=RTOL)
    i = 0
    while i < len(sb):
        j = i + 1
        while j < len(sb) and abs(sb[j] - sb[i]) <= RTOL * abs(sb[i]):
            j += 1
        if j < len(sb):
            assert sorted(a[i:j]) == sorted(b[i:j])
        i = j
    if ref[2] is None:
        assert mine[2] is None
    else:
        assert abs(mine[2] - ref[2]) <= RTOL * abs(ref[2])


def _mesh_rows(pkg, seed, sizes, expansions, want, no_feats=()):
    _r, _m, ctxs, mpart = _shard_set(pkg, seed, sizes, no_feats)
    assert mpart is not None
    counter = []
    got = pkg["pe"].mesh_sparse_topk(ctxs, mpart, "feats", expansions, want,
                                     counter=counter)
    return got, counter, mpart


@pytest.mark.parametrize("tier", [False, True], ids=["exact", "tier"])
@pytest.mark.parametrize("case", ["plain", "no_feats_shard"])
def test_plane_exec_mesh_sparse_topk_matches_reference(case, tier):
    sizes = (90, 120, 75) if case == "plain" else (90, 120, 75, 60)
    no_feats = (3,) if case == "no_feats_shard" else ()
    for pkg in (PORT, REF):
        # a shallow starting depth lets the tier engage on small shards
        _reset(pkg, depth=8 if tier else 128, quantized=tier)
    stat = "mesh_quantized_queries"
    base = (ds.MESH_PLANES.stats[stat], ref_ds.MESH_PLANES.stats[stat])
    exps = _expansions()
    mine, counter, mpart = _mesh_rows(PORT, 7, sizes, exps, 10, no_feats)
    ref, ref_counter, _ = _mesh_rows(REF, 7, sizes, exps, 10, no_feats)
    assert len(mine) == len(ref) == len(sizes)
    for si in range(len(sizes)):
        for qi in range(len(exps)):
            assert_rows_match(mine[si][qi], ref[si][qi])
    assert len(counter) == len(ref_counter)
    served = ds.MESH_PLANES.stats[stat] - base[0]
    assert served == ref_ds.MESH_PLANES.stats[stat] - base[1]
    assert (served > 0) == tier
    assert all(row[-1] == ([], 0, None) for row in mine)   # "nowhere"
    if no_feats:
        assert mpart.subs[3] is None
        assert mine[3] == [([], 0, None)] * len(exps)


def test_wide_window_stands_the_tier_down():
    """A window of 5,000 on shards large enough for the tier to engage:
    the port's coarse and re-rank kernels hold at most KMAX candidates a
    row, so it stands the tier down before any coarse launch, counts a
    ``mesh_quantized_fallback`` and serves exact (one launch); the
    reference dispatches its coarse tier at k' 5,000 first (and here, its
    margin unproven at k' == k, falls back too). Both give the same
    answer."""
    sizes = (20_200, 20_300)
    for pkg in (PORT, REF):
        _reset(pkg, depth=8, quantized=True)
    engines = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        out = []
        for s, n in enumerate(sizes):
            eng = pkg["engine"](pkg["mappers"](MAPPING),
                                shard_label=f"wide{s}")
            rng = np.random.default_rng(11 + s)
            for i in range(n):
                eng.index(str(i), {"feats": {
                    f"f{int(rng.integers(0, 6))}":
                        round(float(rng.random() * 3 + 0.1), 2)}})
                if i == n // 2:
                    eng.refresh()
            eng.refresh()
            out.append(eng)
        engines[name] = out
    exps = [[("f1", 1.0), ("f3", 0.5)]]
    rows = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        readers = [e.acquire_reader() for e in engines[name]]
        mappers = engines[name][0].mappers
        ctxs = [_ctxs(pkg, r, mappers) for r in readers]
        segs = [(("idx", sid), list(r.segments))
                for sid, r in enumerate(readers)]
        mpart = pkg["ds"].MESH_PLANES.get(segs, "features", "feats",
                                          **pkg["kw"])
        stats = dict(pkg["ds"].MESH_PLANES.stats)
        counter = []
        rows[name] = pkg["pe"].mesh_sparse_topk(ctxs, mpart, "feats", exps,
                                                5000, counter=counter)
        after = pkg["ds"].MESH_PLANES.stats
        rows[name + "_delta"] = {
            k: after[k] - stats[k] for k in ("mesh_quantized_queries",
                                             "mesh_quantized_fallbacks")}
        rows[name + "_launches"] = len(counter)
    assert rows["port_delta"] == {"mesh_quantized_queries": 0,
                                  "mesh_quantized_fallbacks": 1}
    assert rows["port_launches"] == 1
    assert rows["ref_launches"] >= 3
    assert sum(rows["ref_delta"].values()) == 1
    for si in range(2):
        assert len(rows["port"][si][0][0]) == 5000
        assert_rows_match(rows["port"][si][0], rows["ref"][si][0])


def _specs(expansions, boosts=None, clip=None):
    boosts = boosts or [1.0] * len(expansions)
    return [be.BatchSpec(kind="sparse", field="feats", window=10,
                         clip_limit=clip, tokens=dict(e), boost=b)
            for e, b in zip(expansions, boosts)]


@pytest.mark.parametrize("dp", [1, 2], ids=["dp1", "dp2_split"])
@pytest.mark.parametrize("tier", [False, True], ids=["exact", "tier"])
def test_mesh_sparse_equals_the_per_shard_batch_bitwise(tier, dp):
    """The reference's identities (test_mesh_exec.py:177-186, :249-281) on
    the port: every shard's mesh answer equals the shard batcher's
    ``batched_sparse_shard`` for that shard, ids, scores and totals
    bitwise; with the query stack split over two dp rows (three queries,
    padded unevenly into the rows) too."""
    _reset(PORT, depth=8 if tier else 128, quantized=tier)
    readers, mappers, ctxs, mpart = _shard_set(PORT, 17, (90, 80, 100))
    mpart.dp = dp
    exps = _expansions(5, 3)
    raw = pe.mesh_sparse_topk(ctxs, mpart, "feats", exps, 10)
    specs = _specs(exps)
    for si, r in enumerate(readers):
        want = be.batched_sparse_shard(_ctxs(PORT, r, mappers), "feats",
                                       specs, 10)
        for qi in range(len(specs)):
            cands, total, max_score = raw[si][qi]
            assert [(c.segment_idx, c.doc, c.score) for c in cands] == \
                [(c.segment_idx, c.doc, c.score) for c in want[qi][0]]
            assert (total, max_score) == (want[qi][1], want[qi][3])


def test_mesh_sparse_equals_the_per_shard_plane_on_the_tier():
    """test_quantized_tier.py:368-371 on the port: with the tier on, the
    mesh's answer per shard is ``plane_sparse_topk``'s on that shard's
    own plane, bitwise, and the stacked bf16 mirror was built."""
    _reset(PORT, depth=8, quantized=True)
    readers, _m, ctxs, mpart = _shard_set(PORT, 19, (110, 95))
    exps = [[("f1", 1.2), ("f4", 0.7)], [("f2", 0.9), ("f9", 0.4)]]
    builds = ds.MESH_PLANES.stats["mesh_quantized_mirror_builds"]
    tiered = ds.MESH_PLANES.stats["mesh_quantized_queries"]
    mesh = pe.mesh_sparse_topk(ctxs, mpart, "feats", exps, 10)
    assert ds.MESH_PLANES.stats["mesh_quantized_mirror_builds"] == builds + 1
    assert ds.MESH_PLANES.stats["mesh_quantized_queries"] > tiered
    for s, r in enumerate(readers):
        part = ds.PLANES.get(list(r.segments), "features", "feats",
                             device="cpu")
        fan = pe.plane_sparse_topk(ctxs[s], part, "feats", exps, 10)
        for q in range(2):
            assert [(c.segment_idx, c.doc, c.score)
                    for c in mesh[s][q][0]] == \
                [(c.segment_idx, c.doc, c.score) for c in fan[q][0]]
            assert mesh[s][q][1:] == fan[q][1:]


def test_the_stacked_features_plane_matches_the_reference():
    """The features kind of ``MeshPlaneRegistry``: the stacked block docs
    and weights equal the reference's (NB padded to a power of two over
    the slots, -1 docs and 0 weights in padding blocks and in the slot of
    a shard without the field); the bf16 mirror is bitwise each shard's own
    ``PlaneFeatures.quantized_mirror()`` and the reference's stacked one,
    charged once and cached."""
    _r, _m, _c, mpart = _shard_set(PORT, 29, (90, 40, 120), no_feats=(1,))
    _r, _m, _c, ref_part = _shard_set(REF, 29, (90, 40, 120), no_feats=(1,))
    assert mpart.n_docs_pad == ref_part.n_docs_pad
    assert mpart.subs[1] is None
    for name in ("block_docs", "block_weights"):
        np.testing.assert_array_equal(getattr(mpart, name).numpy(),
                                      np.asarray(getattr(ref_part, name)))
    nb = mpart.block_docs.shape[1]
    assert nb & (nb - 1) == 0
    assert (mpart.block_docs[1] == -1).all()
    assert not mpart.block_weights[1].any()
    builds = ds.MESH_PLANES.stats["mesh_quantized_mirror_builds"]
    nbytes = mpart.nbytes
    (w16,) = mpart.quantized_mirror()
    assert mpart.quantized_mirror()[0] is w16          # cached
    assert ds.MESH_PLANES.stats["mesh_quantized_mirror_builds"] == builds + 1
    assert w16.dtype == torch.bfloat16
    assert mpart.nbytes == nbytes + 2 * w16.numel()
    (rw16,) = ref_part.quantized_mirror()
    np.testing.assert_array_equal(w16.float().numpy(),
                                  np.asarray(rw16).astype(np.float32))
    for si, sub in enumerate(mpart.subs):
        if sub is None:
            continue
        own = ds.PlaneFeatures("feats", sub.segments, torch.device("cpu"))
        own.upload(own.build(None))
        ow16 = own.quantized_mirror()
        assert torch.equal(w16[si, : ow16.shape[0]], ow16)
        assert not w16[si, ow16.shape[0]:].any()


def test_a_refused_mirror_serves_exact_and_counts():
    """A device breaker too small for the stacked bf16 mirror: the mirror
    is refused once (memoized), the fan-out is served exact with the
    same answer, and each query counts a ``mesh_quantized_fallback``."""
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    _reset(PORT, depth=8, quantized=True)
    _r, _m, ctxs, mpart = _shard_set(PORT, 31, (100, 90))
    exps = _expansions(7, 2)
    want = pe.mesh_sparse_topk(ctxs, mpart, "feats", exps, 10)
    ds.MESH_PLANES.clear()
    _r, _m, ctxs, mpart = _shard_set(PORT, 31, (100, 90))
    dev = BREAKERS.breaker("device")
    limit = dev.limit
    dev.limit = dev.used + 1
    try:
        before = ds.MESH_PLANES.stats["mesh_quantized_fallbacks"]
        got = pe.mesh_sparse_topk(ctxs, mpart, "feats", exps, 10)
        assert mpart.quantized_mirror() is None
        assert ds.MESH_PLANES.stats["mesh_quantized_fallbacks"] == before + 1
    finally:
        dev.limit = limit
    assert got == want


# ---------------------------------------------------------------------------
# the served path: a port node against a reference node, and against itself
# ---------------------------------------------------------------------------

TE_WORDS = [f"w{i}" for i in range(30)]
SPARSE_MAPPINGS = {"properties": {"body": {"type": "text"},
                                  "tag": {"type": "keyword"},
                                  "ml": {"type": "rank_features"}}}


def _sparse_docs():
    """240 docs whose ``ml`` features are the port's expansion of their
    body (computed once here, so both nodes index the same maps)."""
    from elasticsearch_tpu_torch.ml import text_expansion as te
    model = te.get_model(device="cpu")
    rng = np.random.default_rng(53)
    out = []
    for i in range(240):
        body = " ".join(rng.choice(TE_WORDS, size=int(rng.integers(3, 9))))
        out.append((f"s{i}", {"body": body, "tag": f"t{i % 3}",
                              "ml": model.expand(body)}))
    return out


_LOADED = set()


def sparse_pair(shards: int):
    """node_pair's two nodes with index ``sp{shards}`` loaded the same way
    on both: two ``_bulk`` loads with a refresh between, then deletes."""
    ref, port = node_pair(shards)
    if shards not in _LOADED:
        docs = _sparse_docs()
        index = f"sp{shards}"
        for drive in (ref, port):
            for method, path, body in (
                    ("PUT", f"/{index}", {"settings": {
                        "number_of_shards": shards,
                        "number_of_replicas": 0},
                        "mappings": SPARSE_MAPPINGS}),
                    ("POST", "/_bulk", bulk_lines(index, docs[:150])),
                    ("POST", f"/{index}/_refresh", None),
                    ("POST", "/_bulk", bulk_lines(
                        index, docs[150:],
                        deletes=[f"s{i}" for i in range(0, 240, 19)])),
                    ("POST", f"/{index}/_refresh", None)):
                status, resp = drive(method, path, body)
                assert status < 300, (path, status, resp)
        _LOADED.add(shards)
    return ref, port


def te(**kw):
    return {"text_expansion": {"ml": kw}}


TOKENS = {"f7410": 1.3, "f1159": 0.8, "f2458": 0.6, "f4228": 1.1,
          "f5965": 0.4}
SPARSE_BODIES = [
    ("tokens", {"query": te(tokens=TOKENS), "size": 8}),
    ("tokens_boost", {"query": te(tokens=TOKENS, boost=2.5), "size": 6}),
    ("model_text", {"query": te(model_text="w1 w3 w5"), "size": 10}),
    ("totals_true", {"query": te(tokens={"f7410": 1.0, "f2923": 0.7}),
                     "track_total_hits": True, "size": 5}),
    ("totals_false", {"query": te(tokens={"f7410": 1.0}),
                      "track_total_hits": False, "size": 5}),
    ("totals_100", {"query": te(tokens={"f7410": 1.0, "f1159": 1.0,
                                        "f4228": 1.0}),
                    "track_total_hits": 100, "size": 5}),
    ("bool_wrapped", {"query": {"bool": {"must": [te(tokens=TOKENS)]}},
                      "size": 7}),
    ("rrf_sparse_leg", {"sub_searches": [
        {"query": te(tokens=TOKENS)},
        {"query": {"match": {"body": "w1 w3"}}}],
        "rank": {"rrf": {"rank_window_size": 20, "rank_constant": 20}},
        "size": 10}),
]
MESH_SERVED = ("tokens", "tokens_boost", "model_text", "totals_true",
               "totals_false", "totals_100")


def _model_text_atol(resp) -> float:
    """ROADMAP queue 3, item 4: the most a ``model_text`` score may move
    when the two packages' models round a query weight 1e-4 apart."""
    from elasticsearch_tpu.ml import text_expansion as ref_ml
    query = ref_ml.get_model().expand("w1 w3 w5")
    docs = max((sum(h["_source"]["ml"].get(f, 0.0) for f in query)
                for h in resp["hits"]["hits"]), default=0.0)
    return 1e-4 * (sum(query.values()) + docs + len(query))


@pytest.mark.parametrize("name", [n for n, _ in SPARSE_BODIES])
@pytest.mark.parametrize("shards", [2, 4], ids=["two_shards", "four_shards"])
def test_sparse_search_gives_the_reference_json(shards, name):
    """A text_expansion body on 2 and 4 shards: the port's JSON is the
    reference's, ``_data_plane`` (the mesh routing label) included; the
    plain text_expansion bodies are mesh-served on both."""
    ref, port = sparse_pair(shards)
    body = dict(SPARSE_BODIES)[name]
    path = f"/sp{shards}/_search"
    s_r, want = ref("POST", path, copy.deepcopy(body))
    s_p, got = port("POST", path, copy.deepcopy(body))
    assert s_r == s_p == 200, (want, got)
    assert got.get("_data_plane") == want.get("_data_plane"), \
        (got.get("_data_plane"), want.get("_data_plane"))
    if name in MESH_SERVED:
        assert got["_data_plane"] == "mesh_plane"
        assert got["hits"]["hits"], got
    same(want, got, atol=_model_text_atol(want) if name == "model_text"
         else 0.0)


@pytest.mark.parametrize("tier", [False, True], ids=["exact", "tier"])
def test_port_mesh_sparse_equals_its_own_fanout(tier):
    """test_mesh_exec.py:422 on the port for text_expansion: mesh-served
    JSON equals the same node's answers with ``search.mesh.enabled:
    false`` (the RPC fan-out through K15-K17), bitwise, after deletes;
    ``mesh_searches`` grows by one a body and nothing is declined."""
    _ref, port = sparse_pair(4)
    node = next(iter(port.cluster.nodes.values()))
    status, _ = port("PUT", "/_cluster/settings", {"persistent": {
        "search.plane.quantized": tier, "search.plane.rerank_depth": 8}})
    assert status == 200
    executor = node.search_transport.mesh_executor
    bodies = [b for n, b in SPARSE_BODIES if n in MESH_SERVED]
    try:
        searches = executor.stats["mesh_searches"]
        fallbacks = executor.stats["mesh_fallbacks"]
        not_ported = dict(telemetry.TELEMETRY.not_ported)
        meshed = []
        for body in bodies:
            status, resp = port("POST", "/sp4/_search", copy.deepcopy(body))
            assert status == 200 and resp["_data_plane"] == "mesh_plane", \
                (body, resp)
            meshed.append(resp)
        assert executor.stats["mesh_searches"] == searches + len(bodies)
        assert executor.stats["mesh_fallbacks"] == fallbacks
        assert dict(telemetry.TELEMETRY.not_ported) == not_ported
        _set_mesh(port, False)
        try:
            for body, m in zip(bodies, meshed):
                status, resp = port("POST", "/sp4/_search",
                                    copy.deepcopy(body))
                assert status == 200 and "_data_plane" not in resp
                a = {k: v for k, v in m.items()
                     if k not in ("took", "_data_plane")}
                b = {k: v for k, v in resp.items() if k != "took"}
                assert json.dumps(a, sort_keys=True) == \
                    json.dumps(b, sort_keys=True), body
        finally:
            _set_mesh(port, True)
    finally:
        port("PUT", "/_cluster/settings", {"persistent": {
            "search.plane.quantized": None,
            "search.plane.rerank_depth": None}})


def test_a_wave_of_sparse_bodies_shares_one_drain():
    """Three text_expansion bodies submitted in one tick share one mesh
    drain (one ``mesh_sparse_topk`` call answers them all), each equal to
    its own solo answer."""
    _ref, port = sparse_pair(2)
    client = port.cluster.client()
    bodies = [{"query": te(tokens={f: 1.0}), "size": 5}
              for f in ("f7410", "f1159", "f2923")]
    fam = DEVICE_PROFILE.family("mesh_sparse_topk")
    calls = fam.calls
    boxes = []
    for body in bodies:
        box = []
        client.search("sp2", copy.deepcopy(body),
                      lambda resp, err=None, box=box: box.append(
                          (resp, err)))
        boxes.append(box)
    port.cluster.run_until(lambda: all(boxes), 120.0)
    assert fam.calls == calls + 1
    for body, box in zip(bodies, boxes):
        resp, err = box[0]
        assert err is None and resp["_data_plane"] == "mesh_plane"
        status, solo = port("POST", "/sp2/_search", copy.deepcopy(body))
        assert status == 200 and solo["hits"] == resp["hits"]


def test_a_sparse_fanout_builds_a_features_stack():
    """The sparse kind reaches the drain: a two-shard text_expansion
    fan-out on the port builds a features stack in ``MESH_PLANES``."""
    _ref, port = sparse_pair(2)
    builds = ds.MESH_PLANES.stats["mesh_plane_builds"]
    ds.MESH_PLANES.clear()
    status, resp = port("POST", "/sp2/_search",
                        {"query": te(tokens=TOKENS), "size": 3})
    assert status == 200 and resp["_data_plane"] == "mesh_plane"
    assert ds.MESH_PLANES.stats["mesh_plane_builds"] == builds + 1
    kinds = {p.kind for p in ds.MESH_PLANES._parts.values()}
    assert kinds == {"features"}

