"""The mesh's kNN path of elasticsearch_tpu_torch against the JAX package.

Four layers, each on the same seeded inputs in both packages:

- the kernels: the plain versions of ``mesh_knn_topk``,
  ``mesh_knn_coarse`` and ``mesh_knn_rerank`` (``parallel/mesh.py``)
  against the JAX package's shard_map programs, which run on the CPU under
  ``tests/conftest.py``'s 8 virtual devices in 1-device, 2-device and 2x2
  ``(dp, shard)`` layouts, at 2 and 4 slots (one of the 4 empty), masked
  and unmasked, over the three similarities; and each slot against the
  one-shard plain versions (K5 / K6 / K7's) on that shard's own plane;
- the stacked vector plane: ``MeshPlaneRegistry``'s vectors kind against
  the reference's stack, and its int8 mirror bitwise against each shard's
  own ``PlaneVectors.quantized_mirror()``;
- ``mesh_knn_winners`` against the reference's on the same shards: tier on
  and off, no filter, one shared filter, mixed filters, deletes, a shard
  without the field, and the three ``MeshFallback``s (IVF-mapped,
  ANN-sized, mixed engagement);
- the served path: a port node's ``_search`` JSON against a reference
  node's on 2 and 4 shards for ``knn`` bodies (filtered, k above 4,096,
  hybrid ``rank.rrf``), ``_data_plane`` included, and the port's own
  mesh == fan-out identity.

Tolerances (the ones ``test_torch_knn.py`` states): with integer-valued
vectors every product and partial sum is an integer below 2^24, so ids,
scores and eps are equal bit for bit; with Gaussian vectors the two
packages sum the D products in another order, so scores agree to rtol
4e-6 and ids wherever neighbouring scores are further apart than that,
and eps (a difference of scores) to the same tolerance times the scores'
scale. K6's int32 sums are exact in any order, and with integer-valued
vectors its candidates and scores are equal too -- but for the 2x2
layout, where the reference's split of the query stack over ``dp``
rounds the rescale differently from its own one-row layout (1 ulp), and
the coarse pass is held to the Gaussian tolerance. The engines of the
executor and node tests hold integer-valued vectors, so those
comparisons are exact.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import device_segment as ref_ds
from elasticsearch_tpu.parallel import mesh as ref_mesh
from elasticsearch_tpu.search import execute as ref_execute
from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import device_segment as ds
from elasticsearch_tpu_torch.ops import knn as port_knn
from elasticsearch_tpu_torch.ops.device_segment import quantize_rows
from elasticsearch_tpu_torch.parallel import mesh as port_mesh
from elasticsearch_tpu_torch.search import batch_executor as be
from elasticsearch_tpu_torch.search import telemetry
from elasticsearch_tpu_torch.search import execute as port_execute
from elasticsearch_tpu_torch.search import plane_exec as pe
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from test_torch_mesh import (  # noqa: F401 (an autouse fixture)
    PORT, REF, _both, _mesh_defaults, _port_node, _reset, _set_mesh,
    node_pair,
)
from test_torch_node import bulk_lines, same
from torch_inputs import close_ids, mesh_knn_inputs

RTOL = 4e-6
SIMS = ("cosine", "dot_product", "l2_norm")
K = 10
N_Q = 4


# ---------------------------------------------------------------------------
# kernels: seeded stacked vector planes (torch_inputs.mesh_knn_inputs)
# ---------------------------------------------------------------------------

def ref_layout(n_slots: int, dp: int, devices: int):
    mesh, n_slots_got, _ = ref_mesh.mesh_layout(n_slots, dp=dp,
                                                max_devices=devices)
    assert n_slots_got == n_slots
    return mesh


LAYOUTS = [(1, 1), (1, 2), (2, 4)]      # (dp, devices)
SLOTS = [(2, -1), (4, 2)]               # (S, empty slot)


def _terms(queries):
    """The port's host glue of a query batch: (qn, q2), and the int8
    quantization the coarse kernels take."""
    qn, q2 = port_knn.query_norms(queries)
    qq, qscale = port_knn.quantize_queries(queries)
    return [torch.as_tensor(x) for x in (qn, q2, qq, qscale)]


def _masks(inp, masked: bool):
    return torch.as_tensor(inp["masks"]) if masked else None


def _jmask(inp, masked: bool):
    return (jnp.asarray(inp["masks"]),) if masked else ()


def assert_topk(got_s, got_d, want_s, want_d, exact: bool):
    got_s, got_d, want_s, want_d = map(np.asarray,
                                       (got_s, got_d, want_s, want_d))
    np.testing.assert_array_equal(np.isfinite(got_s), np.isfinite(want_s))
    if exact:
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_d, want_d)
        return
    fin = np.isfinite(want_s)
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=RTOL)
    for si in range(want_s.shape[0]):
        close_ids(want_s[si], want_d[si], got_d[si], RTOL)


CASES = [(kind, sim, masked) for kind in ("int", "gauss") for sim in SIMS
         for masked in (False, True)]


def _ids(c):
    return "-".join(str(x) if not isinstance(x, bool)
                    else ("masked" if x else "unmasked") for x in c)


@pytest.mark.parametrize("kind,sim,masked", CASES, ids=map(_ids, CASES))
@pytest.mark.parametrize("n_slots,empty", SLOTS,
                         ids=["s2", "s4_empty_slot"])
@pytest.mark.parametrize("dp,devices", LAYOUTS,
                         ids=["1dev", "2dev", "dp2x2dev"])
def test_mesh_knn_topk_matches_reference(dp, devices, n_slots, empty, kind,
                                         sim, masked):
    inp = mesh_knn_inputs(11 + n_slots + 3 * dp, n_slots, N_Q, kind=kind,
                          empty=empty)
    fn = ref_mesh.mesh_knn_topk(ref_layout(n_slots, dp, devices), K, sim,
                                masked)
    s_r, d_r = fn(jnp.asarray(inp["matrix"]), jnp.asarray(inp["norms"]),
                  jnp.asarray(inp["allowed"]), jnp.asarray(inp["queries"]),
                  *_jmask(inp, masked))
    qn, q2, _qq, _qs = _terms(inp["queries"])
    s, d = port_mesh.mesh_knn_topk(
        torch.as_tensor(inp["matrix"]), torch.as_tensor(inp["norms"]),
        torch.as_tensor(inp["allowed"]), torch.as_tensor(inp["queries"]),
        qn, q2, K, sim, _masks(inp, masked))
    assert s.shape == d.shape == (n_slots, N_Q, K)
    assert d.dtype == torch.int32
    assert_topk(s, d, s_r, d_r, exact=kind == "int")
    if empty >= 0:
        assert not torch.isfinite(s[empty]).any()
        # all -inf: lax.top_k's lower-index-first order
        assert (d[empty] == torch.arange(K, dtype=torch.int32)).all()


@pytest.mark.parametrize("kind,sim,masked", CASES, ids=map(_ids, CASES))
@pytest.mark.parametrize("n_slots,empty", SLOTS,
                         ids=["s2", "s4_empty_slot"])
@pytest.mark.parametrize("dp,devices", LAYOUTS,
                         ids=["1dev", "2dev", "dp2x2dev"])
def test_mesh_knn_coarse_and_rerank_match_reference(dp, devices, n_slots,
                                                    empty, kind, sim,
                                                    masked):
    inp = mesh_knn_inputs(23 + n_slots + 5 * dp, n_slots, N_Q, kind=kind,
                          empty=empty)
    mesh = ref_layout(n_slots, dp, devices)
    s_, n_pad, dims = inp["matrix"].shape
    q8, scales = quantize_rows(inp["matrix"].reshape(s_ * n_pad, dims))
    q8, scales = q8.reshape(s_, n_pad, dims), scales.reshape(s_, n_pad)
    kprime = 64
    c_fn = ref_mesh.mesh_knn_coarse(mesh, kprime, sim, masked)
    cs_r, cand_r = c_fn(jnp.asarray(q8), jnp.asarray(scales),
                        jnp.asarray(inp["norms"]), jnp.asarray(inp["allowed"]),
                        jnp.asarray(inp["queries"]), *_jmask(inp, masked))
    qn, q2, qq, qscale = _terms(inp["queries"])
    T = torch.as_tensor
    cs, cand = port_mesh.mesh_knn_coarse(
        T(q8), T(scales), T(inp["norms"]), T(inp["allowed"]), qq, qscale, qn,
        q2, kprime, sim, _masks(inp, masked))
    assert cs.shape == cand.shape == (n_slots, N_Q, kprime)
    # the reference's dp split rounds the rescale once differently from
    # its own one-row layout (1 ulp): exact there only at dp 1
    assert_topk(cs, cand, cs_r, cand_r, exact=kind == "int" and dp == 1)
    # both tiers re-rank the SAME candidates (the reference's)
    r_fn = ref_mesh.mesh_knn_rerank(mesh, K, sim, masked)
    s_r, d_r, eps_r = r_fn(
        jnp.asarray(inp["matrix"]), jnp.asarray(inp["norms"]),
        jnp.asarray(inp["allowed"]), jnp.asarray(inp["queries"]), cand_r,
        cs_r, *_jmask(inp, masked))
    cand_h, cs_h = np.array(cand_r), np.array(cs_r)
    s, d, eps = port_mesh.mesh_knn_rerank(
        T(inp["matrix"]), T(inp["norms"]), T(inp["allowed"]),
        T(inp["queries"]), qn, q2, T(cand_h), T(cs_h), K, sim,
        _masks(inp, masked))
    assert s.shape == d.shape == (n_slots, N_Q, K)
    assert eps.shape == (n_slots, N_Q)
    exact = kind == "int"
    assert_topk(s, d, s_r, d_r, exact=exact)
    if exact:
        np.testing.assert_array_equal(eps.numpy(), np.asarray(eps_r))
    else:
        scale = 1.0 + np.abs(cs_h[np.isfinite(cs_h)]).max()
        np.testing.assert_allclose(eps.numpy(), np.asarray(eps_r), rtol=0,
                                   atol=RTOL * scale)
    if empty >= 0:
        assert (d[empty] == -1).all() and (eps[empty] == 0).all()


def _own(inp, si):
    """Slot ``si``'s plane at its own size (its shard's one-plane
    layout)."""
    n = inp["own"][si]
    return [torch.as_tensor(np.ascontiguousarray(inp[k][si, :n]))
            for k in ("matrix", "norms", "allowed")], n


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("n_slots,empty", SLOTS,
                         ids=["s2", "s4_empty_slot"])
def test_each_slot_is_the_one_shard_kernel_on_its_plane(n_slots, empty, sim,
                                                        masked):
    """Per slot, the mesh plain versions equal the one-shard plain
    versions (K5/K6/K7's) bitwise, on the slot of the stack and, for the
    finite hits, on the shard's own unpadded plane."""
    inp = mesh_knn_inputs(41 + n_slots, n_slots, N_Q, kind="gauss",
                          empty=empty)
    T = torch.as_tensor
    qn, q2, qq, qscale = _terms(inp["queries"])
    m, nr, al, qs = (T(inp[k]) for k in ("matrix", "norms", "allowed",
                                         "queries"))
    mk = _masks(inp, masked)
    s_, n_pad, dims = m.shape
    q8, scales = quantize_rows(inp["matrix"].reshape(s_ * n_pad, dims))
    q8, scales = T(q8.reshape(s_, n_pad, dims)), T(scales.reshape(s_, n_pad))
    s, d = port_mesh.mesh_knn_topk(m, nr, al, qs, qn, q2, K, sim, mk)
    cs, cand = port_mesh.mesh_knn_coarse(q8, scales, nr, al, qq, qscale, qn,
                                         q2, 64, sim, mk)
    ss, dd, eps = port_mesh.mesh_knn_rerank(m, nr, al, qs, qn, q2, cand, cs,
                                            K, sim, mk)
    for si in range(n_slots):
        mks = None if mk is None else mk[si]
        for got, ref in zip((s[si], d[si]), port_knn.knn_flat_plain(
                m[si], nr[si], al[si], qs, qn, q2, K, sim, mks)):
            assert torch.equal(got, ref)
        for got, ref in zip((cs[si], cand[si]), port_knn.knn_coarse_plain(
                q8[si], scales[si], nr[si], al[si], qq, qscale, qn, q2, 64,
                sim, mks)):
            assert torch.equal(got, ref)
        for got, ref in zip((ss[si], dd[si], eps[si]),
                            port_knn.knn_rerank_plain(
                                m[si], nr[si], al[si], qs, qn, q2, cand[si],
                                cs[si], K, sim, mks)):
            assert torch.equal(got, ref)
        # the shard's own plane: the same finite hits
        (om, onr, oal), n = _own(inp, si)
        own_mask = None if mk is None else mk[si, :, :n].contiguous()
        want = port_knn.knn_flat_plain(om, onr, oal, qs, qn, q2, min(K, n),
                                       sim, own_mask)
        fin = torch.isfinite(s[si])
        assert torch.equal(fin, torch.isfinite(want[0]))
        assert torch.equal(s[si][fin], want[0][fin])
        assert torch.equal(d[si][fin], want[1][fin])


def test_wide_k_runs_over_every_slot_row():
    """k above the kernels' KMAX (the selection's rounds): each slot's row
    is still the one-shard K5 plain version's at that k."""
    inp = mesh_knn_inputs(57, 2, 2, kind="int", n_docs=9000)
    k = 4100
    assert inp["n_pad"] >= k
    T = torch.as_tensor
    qn, q2, _qq, _qs = _terms(inp["queries"])
    s, d = port_mesh.mesh_knn_topk(T(inp["matrix"]), T(inp["norms"]),
                                   T(inp["allowed"]), T(inp["queries"]), qn,
                                   q2, k, "cosine")
    assert s.shape == (2, 2, k)
    for si in range(2):
        want = port_knn.knn_flat_plain(
            T(inp["matrix"][si]), T(inp["norms"][si]),
            T(inp["allowed"][si]), T(inp["queries"]), qn, q2, k, "cosine")
        assert torch.equal(s[si], want[0]) and torch.equal(d[si], want[1])


def test_plain_mesh_knn_calls_are_not_launches():
    """A call on CPU tensors runs the plain version: one call, no launch,
    and a masked call is labelled ``/masked`` within its one family."""
    inp = mesh_knn_inputs(5, 2, 2)
    fam = DEVICE_PROFILE.family("mesh_knn_topk")
    calls, launches = fam.calls, fam.launches
    qn, q2, _qq, _qs = _terms(inp["queries"])
    T = torch.as_tensor
    for masks in (None, T(inp["masks"])):
        port_mesh.mesh_knn_topk(T(inp["matrix"]), T(inp["norms"]),
                                T(inp["allowed"]), T(inp["queries"]), qn,
                                q2, K, "cosine", masks)
    assert fam.calls == calls + 2 and fam.launches == launches
    assert any(label.endswith("/masked") for label in fam.shapes)


def test_mesh_knn_wrappers_refuse_bad_inputs():
    inp = mesh_knn_inputs(6, 2, 2)
    T = torch.as_tensor
    qn, q2, qq, qscale = _terms(inp["queries"])
    m, nr, al, qs = (T(inp[k]) for k in ("matrix", "norms", "allowed",
                                         "queries"))
    with pytest.raises(ValueError):             # a 2-d matrix
        port_mesh.mesh_knn_topk(m[0], nr, al, qs, qn, q2, K)
    with pytest.raises(ValueError):             # masks of the wrong slots
        port_mesh.mesh_knn_topk(m, nr, al, qs, qn, q2, K, "cosine",
                                T(inp["masks"][:1]))
    with pytest.raises(ValueError):
        port_mesh.mesh_knn_topk(m, nr, al, qs, qn, q2, K, "hamming")
    with pytest.raises(TypeError):              # the coarse pass given f32
        port_mesh.mesh_knn_coarse(m, nr, nr, al, qq, qscale, qn, q2, 16)
    cand = torch.zeros(2, 2, 8, dtype=torch.int32)
    with pytest.raises(ValueError):             # k above k'
        port_mesh.mesh_knn_rerank(m, nr, al, qs, qn, q2, cand,
                                  torch.zeros(2, 2, 8), 9)


# ---------------------------------------------------------------------------
# shards in both packages: the stacked plane and mesh_knn_winners
# ---------------------------------------------------------------------------

# (test_torch_mesh's autouse fixture resets both packages' registries)
EXECUTE = ((PORT, port_execute), (REF, ref_execute))


def _mapping(ivf: bool = False):
    vec = {"type": "dense_vector", "dims": 8, "similarity": "cosine"}
    if ivf:
        vec["index_options"] = {"type": "ivf", "nlist": 4, "nprobe": 4}
    return {"properties": {"vec": vec, "tag": {"type": "keyword"}}}


def _shard_ops(seed: int, n_docs: int, with_vec: bool = True):
    """One shard's writes: integer-valued 8-dim vectors (every fifth doc
    without one; duplicates of doc 3 for score ties), a tag t0-t2,
    refreshes splitting three segments, every 13th doc deleted."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-9, 10, 8)
    ops = []
    for i in range(n_docs):
        src = {"tag": f"t{i % 3}"}
        if with_vec and i % 5:
            v = base if i in (3, 17, 40) else rng.integers(-9, 10, 8)
            src["vec"] = [float(x) for x in v]
        ops.append(("index", str(i), src))
        if i in (n_docs // 3, 2 * n_docs // 3):
            ops.append(("refresh",))
    ops += [("delete", str(i)) for i in range(0, n_docs, 13)]
    ops.append(("refresh",))
    return ops


def _engines(pkg, seed: int, sizes, no_vec=(), ivf: bool = False):
    engines = []
    for s, n_docs in enumerate(sizes):
        eng = pkg["engine"](pkg["mappers"](_mapping(ivf)),
                            shard_label=f"mk{seed}_{s}{'i' if ivf else ''}")
        for op in _shard_ops(seed + 100 * s, n_docs, s not in no_vec):
            if op[0] == "index":
                eng.index(op[1], op[2])
            elif op[0] == "delete":
                eng.delete(op[1])
            else:
                eng.refresh()
        engines.append(eng)
    return engines


def _shard_set(pkg, seed, sizes, no_vec=(), ivf=False):
    engines = _engines(pkg, seed, sizes, no_vec, ivf)
    readers = [e.acquire_reader() for e in engines]
    mappers = engines[0].mappers
    ctxs = [pkg["be"]._build_ctxs(r, mappers,
                                  sum(s.n_docs for s in r.segments), None,
                                  **pkg["kw"]) for r in readers]
    segs = [(("idx", sid), list(r.segments)) for sid, r in enumerate(readers)]
    mpart = pkg["ds"].MESH_PLANES.get(segs, "vectors", "vec", **pkg["kw"])
    return readers, mappers, ctxs, mpart


def _specs(pkg, filters, seed: int = 3, k: int = 5):
    rng = np.random.default_rng(seed)
    out = []
    for f in filters:
        q = None if f is None else pkg["dsl"].parse_query(
            {"term": {"tag": f}})
        out.append(pkg["be"].BatchSpec(
            kind="knn", field="vec", window=10, k=k, num_candidates=50,
            boost=1.0, query_vector=[float(x) for x in
                                     rng.integers(-9, 10, 8)],
            filter=q, filter_key=None if q is None else repr(q)))
    return out


def _winners(pkg, seed, sizes, filters, no_vec=(), k=5):
    _r, _m, ctxs, mpart = _shard_set(pkg, seed, sizes, no_vec)
    assert mpart is not None
    counter = []
    got = pkg["pe"].mesh_knn_winners(ctxs, mpart, "vec",
                                     _specs(pkg, filters, k=k), k,
                                     counter=counter)
    return got, counter, mpart


FILTERS = {"none": [None, None, None],
           "shared": ["t1", "t1", "t1"],
           "mixed": ["t1", None, "t2"]}


@pytest.mark.parametrize("filters", list(FILTERS))
@pytest.mark.parametrize("tier", [False, True], ids=["exact", "tier"])
@pytest.mark.parametrize("case", ["plain", "no_vec_shard"])
def test_mesh_knn_winners_match_reference(case, tier, filters):
    sizes = (90, 120, 75) if case == "plain" else (90, 120, 75, 60)
    no_vec = (3,) if case == "no_vec_shard" else ()
    for pkg in (PORT, REF):
        # a shallow starting depth lets the tier engage on small shards
        _reset(pkg, depth=8 if tier else 128, quantized=tier)
    stat = "mesh_quantized_queries"
    base = (ds.MESH_PLANES.stats[stat], ref_ds.MESH_PLANES.stats[stat])
    mine, counter, mpart = _winners(PORT, 7, sizes, FILTERS[filters], no_vec)
    ref, ref_counter, _ = _winners(REF, 7, sizes, FILTERS[filters], no_vec)
    assert mine == ref
    assert len(counter) == len(ref_counter)
    served = ds.MESH_PLANES.stats[stat] - base[0]
    assert served == ref_ds.MESH_PLANES.stats[stat] - base[1]
    assert (served > 0) == tier
    if no_vec:
        assert mpart.subs[3] is None
        assert mine[3] == [[], [], []]


@pytest.mark.parametrize("tier", [False, True], ids=["exact", "tier"])
def test_mesh_knn_equals_the_per_shard_batch_bitwise(tier):
    """The port's golden identity (test_mesh_exec.py:156-172): every
    shard's mesh winners, demuxed, equal the shard batcher's own answer
    for that shard, scores bitwise, filtered members included."""
    _reset(PORT, depth=8 if tier else 128, quantized=tier)
    readers, mappers, ctxs, mpart = _shard_set(PORT, 17, (90, 80, 100))
    specs = _specs(PORT, ["t1", None, "t2", None], k=7)
    raw = pe.mesh_knn_winners(ctxs, mpart, "vec", specs, 7)
    for si, r in enumerate(readers):
        want = be.batched_knn_shard(
            be._build_ctxs(r, mappers, sum(s.n_docs for s in r.segments),
                           None, device="cpu"), "vec", specs, 7)
        got = be._knn_demux(specs, raw[si], 7)
        for qi in range(len(specs)):
            assert [(c.segment_idx, c.doc, c.score) for c in got[qi][0]] == \
                [(c.segment_idx, c.doc, c.score) for c in want[qi][0]]
            assert got[qi][1:4] == want[qi][1:4]


def test_the_stacked_vector_plane_matches_the_reference():
    """The vectors kind of ``MeshPlaneRegistry`` (test_torch_mesh's
    ``[vectors]`` case builds it): the stack, its norms and exists flags
    equal the reference's; padding slots and docs are zero rows with
    exists False; the int8 mirror is bitwise each shard's own
    ``PlaneVectors.quantized_mirror()`` and the reference's stacked one."""
    _r, _m, _c, mpart = _shard_set(PORT, 29, (90, 40, 120), no_vec=(1,))
    _r, _m, _c, ref_part = _shard_set(REF, 29, (90, 40, 120), no_vec=(1,))
    assert mpart.n_docs_pad == ref_part.n_docs_pad
    assert (mpart.dims, mpart.similarity) == (8, "cosine")
    for name in ("matrix", "norms", "exists"):
        np.testing.assert_array_equal(getattr(mpart, name).numpy(),
                                      np.asarray(getattr(ref_part, name)))
    assert not mpart.exists[1].any() and not mpart.matrix[1].any()
    builds = ds.MESH_PLANES.stats["mesh_quantized_mirror_builds"]
    q8, scales = mpart.quantized_mirror()
    assert mpart.quantized_mirror()[0] is q8          # cached
    assert ds.MESH_PLANES.stats["mesh_quantized_mirror_builds"] == builds + 1
    rq8, rscales = ref_part.quantized_mirror()
    np.testing.assert_array_equal(q8.numpy(), np.asarray(rq8))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(rscales))
    for si, sub in enumerate(mpart.subs):
        if sub is None:
            continue
        own = ds.PlaneVectors("vec", sub.segments, torch.device("cpu"))
        own.upload(own.build(None))
        oq8, oscales = own.quantized_mirror()
        n = own.n_docs_pad
        assert torch.equal(q8[si, :n], oq8)
        assert torch.equal(scales[si, :n], oscales)


def test_mixed_dims_are_refused():
    """Shards whose vector fields differ in dims cannot share a stack:
    the stacking pass raises PlaneUnavailable, as the reference's does."""
    engines = []
    for s, dims in enumerate((8, 4)):
        eng = InternalEngine(MapperService({"properties": {"vec": {
            "type": "dense_vector", "dims": dims,
            "similarity": "cosine"}}}), shard_label=f"mixdims{s}")
        for i in range(20):
            eng.index(str(i), {"vec": [float(i % 7 + j) for j in
                                       range(dims)]})
        eng.refresh()
        engines.append(eng)
    segs = [(("idx", s), list(e.acquire_reader().segments))
            for s, e in enumerate(engines)]
    with pytest.raises(ds.PlaneUnavailable):
        ds.MESH_PLANES.get(segs, "vectors", "vec", device="cpu")


def test_ivf_mapped_field_falls_back():
    """test_mesh_exec.py:303-315 on both packages: IVF-routed shards keep
    the per-shard fan-out; the mesh executor refuses, typed
    ``mesh_ivf_routed``."""
    for pkg in (PORT, REF):
        _r, _m, ctxs, mpart = _shard_set(pkg, 23, (60, 70), ivf=True)
        assert mpart is not None
        with pytest.raises(pkg["pe"].MeshFallback) as err:
            pkg["pe"].mesh_knn_winners(ctxs, mpart, "vec",
                                       _specs(pkg, [None]), 5)
        assert err.value.reason == telemetry.MESH_IVF_ROUTED


def test_ann_sized_shard_falls_back(monkeypatch):
    """A shard whose every segment holds at least ANN_DEFAULT_MIN_DOCS
    docs would take the per-segment IVF route: the mesh refuses in both
    packages (the threshold lowered here to the test's segment sizes)."""
    for pkg, execute in EXECUTE:
        monkeypatch.setattr(execute, "ANN_DEFAULT_MIN_DOCS", 20)
        _r, _m, ctxs, mpart = _shard_set(pkg, 31, (90, 100))
        with pytest.raises(pkg["pe"].MeshFallback) as err:
            pkg["pe"].mesh_knn_winners(ctxs, mpart, "vec",
                                       _specs(pkg, [None]), 5)
        assert err.value.reason == telemetry.MESH_IVF_ROUTED
        monkeypatch.setattr(execute, "ANN_DEFAULT_MIN_DOCS", 65536)
        assert pkg["pe"].mesh_knn_winners(ctxs, mpart, "vec",
                                          _specs(pkg, [None]), 5)


def test_mixed_engagement_falls_back():
    """One tiny shard beside big ones: the tier would engage on some
    shards and not others, so both packages count
    ``mesh_quantized_fallbacks`` and hand the fan-out back, typed
    ``mesh_quantized_fallback``; with the tier off the mesh serves."""
    for pkg in (PORT, REF):
        _reset(pkg, depth=8, quantized=True)
        _r, _m, ctxs, mpart = _shard_set(pkg, 37, (90, 20, 110))
        before = pkg["ds"].MESH_PLANES.stats["mesh_quantized_fallbacks"]
        with pytest.raises(pkg["pe"].MeshFallback) as err:
            pkg["pe"].mesh_knn_winners(ctxs, mpart, "vec",
                                       _specs(pkg, [None]), 5)
        assert err.value.reason == telemetry.MESH_QUANTIZED_FALLBACK
        assert pkg["ds"].MESH_PLANES.stats["mesh_quantized_fallbacks"] == \
            before + 1
        pkg["ds"].PLANES.quantized = False
        assert pkg["pe"].mesh_knn_winners(ctxs, mpart, "vec",
                                          _specs(pkg, [None]), 5)


# ---------------------------------------------------------------------------
# the served path: a port node against a reference node, and against itself
# ---------------------------------------------------------------------------

QV = [0.3, -1.2, 0.5, 0.0, 1.1, -0.4, 0.2, 0.9]
KNN_BODIES = [
    ("knn", {"query": {"knn": {"field": "vec", "k": 6,
                               "query_vector": QV}}, "size": 6}),
    ("knn_k100", {"query": {"knn": {"field": "vec", "k": 100,
                                    "num_candidates": 150,
                                    "query_vector": QV[::-1]}},
                  "size": 20}),
    ("knn_filtered", {"query": {"knn": {
        "field": "vec", "k": 8, "query_vector": QV,
        "filter": {"term": {"tag": "t1"}}}}, "size": 8}),
    ("knn_k5000", {"query": {"knn": {"field": "vec", "k": 5000,
                                     "num_candidates": 5000,
                                     "query_vector": QV}}, "size": 30}),
    ("hybrid_rrf", {"query": {"match": {"body": "w1 w3"}},
                    "knn": {"field": "vec", "k": 10, "num_candidates": 20,
                            "query_vector": QV},
                    "rank": {"rrf": {"rank_window_size": 20,
                                     "rank_constant": 20}}, "size": 10}),
]


@pytest.mark.parametrize("name", [n for n, _ in KNN_BODIES])
@pytest.mark.parametrize("shards", [2, 4], ids=["two_shards", "four_shards"])
def test_knn_search_gives_the_reference_json(shards, name):
    """A knn body on 2 and 4 shards: the port's JSON is the reference's,
    ``_data_plane`` (the mesh routing label) included; the plain and
    filtered bodies are mesh-served on both."""
    body = dict(KNN_BODIES)[name]
    (s_r, want), (s_p, got) = _both(shards, body)
    assert s_r == s_p == 200, (want, got)
    assert got.get("_data_plane") == want.get("_data_plane"), \
        (got.get("_data_plane"), want.get("_data_plane"))
    if name.startswith("knn"):
        assert got["_data_plane"] == "mesh_plane"
    same(want, got)


def test_wide_knn_on_big_shards_gives_the_reference_json():
    """k 5,000 on 2 shards of more than 4,096 docs each (the mesh kernel's
    selection rounds above KMAX): the reference's JSON, mesh-served on
    both."""
    ref, port = node_pair(2)
    rng = np.random.default_rng(43)
    docs = [(f"w{i}", {"tag": f"t{i % 3}", "vec": [
        float(x) for x in rng.integers(-9, 10, 8)]}) for i in range(9000)]
    for drive in (ref, port):
        if drive("HEAD", "/wide")[0] == 200:
            continue
        for method, path, body in (
                ("PUT", "/wide", {"settings": {
                    "number_of_shards": 2, "number_of_replicas": 0},
                    "mappings": {"properties": {
                        "vec": {"type": "dense_vector", "dims": 8,
                                "similarity": "dot_product"},
                        "tag": {"type": "keyword"}}}}),
                ("POST", "/_bulk", bulk_lines("wide", docs)),
                ("POST", "/wide/_refresh", None)):
            assert drive(method, path, body)[0] < 300, path
    body = {"query": {"knn": {"field": "vec", "k": 5000,
                              "num_candidates": 5000,
                              "query_vector": [1, -2, 3, 0, 2, -1, 1, 2]}},
            "size": 40, "from": 4060}
    want = ref("POST", "/wide/_search", copy.deepcopy(body))
    got = port("POST", "/wide/_search", copy.deepcopy(body))
    assert want[0] == got[0] == 200, (want, got)
    assert got[1]["_data_plane"] == want[1]["_data_plane"] == "mesh_plane"
    same(want[1], got[1])


@pytest.mark.parametrize("tier", [False, True], ids=["exact", "tier"])
def test_port_mesh_knn_equals_its_own_fanout(tier):
    """test_mesh_exec.py:422 on the port for kNN: mesh-served JSON equals
    the same node's answers with ``search.mesh.enabled: false`` (the RPC
    fan-out through K5-K7), bitwise, after writes (deletes, a refresh);
    ``mesh_searches`` grows by one a body."""
    port, node = _port_node(4)
    status, _ = port("PUT", "/_cluster/settings", {"persistent": {
        "search.plane.quantized": tier, "search.plane.rerank_depth": 8}})
    assert status == 200
    executor = node.search_transport.mesh_executor
    bodies = [b for n, b in KNN_BODIES if n.startswith("knn")]
    try:
        searches = executor.stats["mesh_searches"]
        tiered = ds.MESH_PLANES.stats["mesh_quantized_queries"]
        meshed = []
        for body in bodies:
            status, resp = port("POST", "/m4/_search", copy.deepcopy(body))
            assert status == 200 and resp["_data_plane"] == "mesh_plane", \
                (body, resp)
            meshed.append(resp)
        assert executor.stats["mesh_searches"] == searches + len(bodies)
        assert (ds.MESH_PLANES.stats["mesh_quantized_queries"] > tiered) \
            == tier
        _set_mesh(port, False)
        try:
            for body, m in zip(bodies, meshed):
                status, resp = port("POST", "/m4/_search",
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


def test_differently_filtered_wave_takes_the_masked_launch():
    """Two differently filtered knn bodies submitted in one tick share one
    mesh drain: one masked call (``/masked``) answers both, each equal to
    its own solo answer."""
    port, node = _port_node(4)
    client = port.cluster.client()
    bodies = [{"query": {"knn": {"field": "vec", "k": 5, "query_vector": QV,
                                 "filter": {"term": {"tag": t}}}},
               "size": 5} for t in ("t0", "t2")]
    fam = DEVICE_PROFILE.family("mesh_knn_topk")
    masked0 = sum(n for label, n in fam.shapes.items()
                  if label.endswith("/masked"))
    boxes = []
    for body in bodies:
        box = []
        client.search("m4", copy.deepcopy(body),
                      lambda resp, err=None, box=box: box.append(
                          (resp, err)))
        boxes.append(box)
    port.cluster.run_until(lambda: all(boxes), 120.0)
    masked = sum(n for label, n in fam.shapes.items()
                 if label.endswith("/masked"))
    assert masked == masked0 + 1
    for body, box in zip(bodies, boxes):
        resp, err = box[0]
        assert err is None and resp["_data_plane"] == "mesh_plane"
        status, solo = port("POST", "/m4/_search", copy.deepcopy(body))
        assert status == 200 and solo["hits"] == resp["hits"]
