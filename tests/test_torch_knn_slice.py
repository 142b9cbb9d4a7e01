"""The served kNN path of elasticsearch_tpu_torch against the JAX package,
end to end: the same documents through each package's ``InternalEngine`` +
``SearchService`` (the port on ``device="cpu"``, i.e. the kernels' plain
PyTorch versions) must give the same ``knn`` responses, over the three
similarities, with the vector plane resident and without it (per-segment
route), and with the quantized tier on and off.

Tolerance. The vectors are integer-valued (SIFT1M's kind: 0..255), so
every dot product is exact in any summation order and the two packages'
scores, ids and totals must be equal exactly. One Gaussian case compares
scores to rtol 4e-6 (f32 re-association of the dot products, as in
tests/test_torch_knn.py) and ids exactly outside near-ties.

The port's own identities are bitwise: solo == batch, quantized tier ==
exact path, plane == per-segment. Requests outside the port's slice raise
NotPortedError (status 501). Filtered kNN and the IVF route have files of
their own (tests/test_torch_knn_filtered.py, tests/test_torch_ivf.py); the
65,536-doc default IVF route is served here.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService

from elasticsearch_tpu_torch.convert import segments_from_reference
from elasticsearch_tpu_torch.index import InternalEngine, Reader
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops.device_segment import PLANES
from elasticsearch_tpu_torch.search import SearchService, dsl
from elasticsearch_tpu_torch.search.batch_executor import (
    BatchSpec, _build_ctxs, batched_knn_shard,
)
from elasticsearch_tpu_torch.search.phase import query_shard
from elasticsearch_tpu_torch.utils.errors import NotPortedError

RTOL = 4e-6
DIMS = 16
SIMS = ("cosine", "dot_product", "l2_norm")


def mapping(sim: str, index_options=None):
    vec = {"type": "dense_vector", "dims": DIMS, "similarity": sim}
    if index_options is not None:
        vec["index_options"] = index_options
    return {"properties": {"vec": vec, "tag": {"type": "keyword"}}}


def make_vectors(seed: int, n: int, kind: str = "int"):
    rng = np.random.default_rng(seed)
    if kind == "int":
        v = rng.integers(0, 256, (n, DIMS)).astype(np.float32)
    else:
        v = rng.standard_normal((n, DIMS)).astype(np.float32)
    if n > 300:
        v[7] = v[3]      # duplicate rows: score ties
        v[300] = v[3]
    return v


def index_both(sim, vectors, refresh_at=(), deletes=(), missing=(),
               index_options=None):
    ref = RefEngine(RefMappers(mapping(sim, index_options)),
                    shard_label="ref")
    port = InternalEngine(MapperService(mapping(sim, index_options)),
                          shard_label="port")
    for i, v in enumerate(vectors):
        body = {"tag": f"t{i % 5}"}
        if i not in missing:
            body["vec"] = [float(x) for x in v]
        ref.index(str(i), body)
        port.index(str(i), body)
        if i in refresh_at:
            ref.refresh()
            port.refresh()
    ref.refresh()
    port.refresh()
    for i in deletes:
        ref.delete(str(i))
        port.delete(str(i))
    ref.refresh()
    port.refresh()
    return ref, port


@pytest.fixture
def planes():
    """Both packages' plane registries, restored after the test."""
    keep = [(p, p.enabled, p.quantized, p.rerank_depth, p.rerank_depth_max,
             p.min_segments) for p in (REF_PLANES, PLANES)]
    REF_PLANES.clear()
    PLANES.clear()
    yield
    for p, en, q, d, dm, ms in keep:
        p.enabled, p.quantized = en, q
        p.rerank_depth, p.rerank_depth_max, p.min_segments = d, dm, ms
        p.clear()


def knn_body(vec, k=10, num_candidates=50, size=10, **extra):
    body = {"query": {"knn": {"field": "vec",
                              "query_vector": [float(x) for x in vec],
                              "k": k, "num_candidates": num_candidates}},
            "size": size}
    body["query"]["knn"].update(extra.pop("knn", {}))
    body.update(extra)
    return body


def bodies(seed: int, n: int, kind: str = "int"):
    qs = make_vectors(seed, n, kind)
    qs[1] = 0.0                                   # an all-zero query
    out = []
    for i, q in enumerate(qs):
        if i % 4 == 0:
            out.append(knn_body(q))
        elif i % 4 == 1:
            out.append(knn_body(q, k=5, size=3, track_total_hits=2))
        elif i % 4 == 2:
            out.append(knn_body(q, k=25, size=10, **{"from": 5}))
        else:
            out.append(knn_body(q, k=10, knn={"boost": 2.0}))
    return out


def assert_same_response(a, b, exact: bool):
    ha, hb = a["hits"], b["hits"]
    assert ha["total"] == hb["total"]
    ids_a = [h["_id"] for h in ha["hits"]]
    ids_b = [h["_id"] for h in hb["hits"]]
    sa = np.array([h["_score"] for h in ha["hits"]])
    sb = np.array([h["_score"] for h in hb["hits"]])
    if exact:
        assert ids_a == ids_b
        assert sa.tolist() == sb.tolist()
        assert ha["max_score"] == hb["max_score"]
        return
    assert len(ids_a) == len(ids_b)
    np.testing.assert_allclose(sb, sa, rtol=RTOL)
    for j in range(len(sa)):
        near = [abs(sa[i] - sa[j]) <= RTOL * abs(sa[j])
                for i in (j - 1, j + 1) if 0 <= i < len(sa)]
        if not any(near):
            assert ids_a[j] == ids_b[j]


def run(ref_svc, port_svc, body_list, exact=True):
    for body in body_list:
        assert_same_response(ref_svc.search(body), port_svc.search(body),
                             exact)


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("route", ["plane", "per_segment"])
@pytest.mark.parametrize("quantized", [True, False])
def test_knn_responses_match_reference(sim, route, quantized, planes):
    ref, port = index_both(sim, make_vectors(1, 1400),
                           refresh_at=(400, 900), deletes=(5, 401, 1000),
                           missing=(9, 950))
    for p in (REF_PLANES, PLANES):
        p.enabled = route == "plane"
        p.quantized = quantized
        # a shallow first depth makes the margin fail and escalate
        p.rerank_depth, p.rerank_depth_max = 16, 64
    served0 = PLANES.stats["quantized_queries"]
    builds0 = PLANES.stats["plane_builds"]
    run(RefService(ref), SearchService(port, device="cpu"), bodies(2, 12))
    assert (PLANES.stats["plane_builds"] > builds0) == (route == "plane")
    assert (PLANES.stats["quantized_queries"] > served0) == (
        route == "plane" and quantized)


def test_gaussian_vectors_match_reference_within_tolerance(planes):
    ref, port = index_both("cosine", make_vectors(3, 900, "gauss"),
                           refresh_at=(450,), deletes=(2,))
    run(RefService(ref), SearchService(port, device="cpu"),
        bodies(4, 8, "gauss"), exact=False)


def test_solo_batch_tier_and_routes_are_bitwise_equal(planes):
    """Solo query_shard == batched_knn_shard, quantized tier == exact plane
    == per-segment route: same ids, same score bits."""
    _ref, port = index_both("cosine", make_vectors(5, 1400),
                            refresh_at=(500, 1000), deletes=(11, 600))
    reader = port.acquire_reader()
    mappers = port.mappers
    queries = make_vectors(6, 8)
    specs = [BatchSpec(kind="knn", field="vec", window=10,
                       query_vector=[float(x) for x in q], k=10,
                       num_candidates=50) for q in queries]
    ctxs = _build_ctxs(reader, mappers, None, None, device="cpu")

    def solo():
        return [query_shard(reader, mappers, dsl.Knn(
            field="vec", query_vector=s.query_vector, k=10,
            num_candidates=50), size=10, device="cpu") for s in specs]

    def key_solo(results):
        return [[(d.segment_idx, d.doc, d.score) for d in r.docs]
                for r in results]

    def key_batch(out):
        return [[(d.segment_idx, d.doc, d.score) for d in c[:10]]
                for c, _t, _r, _m, _p in out]

    PLANES.quantized = True
    served0 = PLANES.stats["quantized_queries"]
    tier_solo = key_solo(solo())
    assert PLANES.stats["quantized_queries"] > served0
    tier_batch = key_batch(batched_knn_shard(ctxs, "vec", specs, 10))
    PLANES.quantized = False
    exact_batch = key_batch(batched_knn_shard(ctxs, "vec", specs, 10))
    exact_solo = key_solo(solo())
    PLANES.enabled = False
    seg_batch = key_batch(batched_knn_shard(ctxs, "vec", specs, 10))
    seg_solo = key_solo(solo())
    for other in (tier_batch, exact_batch, exact_solo, seg_batch, seg_solo):
        assert other == tier_solo


def test_converted_segments_and_mirror_bytes_match_reference(planes):
    ref, _port = index_both("cosine", make_vectors(7, 800),
                            refresh_at=(400,), deletes=(1,))
    reader = ref.acquire_reader()
    segs = segments_from_reference(reader.segments)
    for a, b in zip(reader.segments, segs):
        va, vb = a.vectors["vec"], b.vectors["vec"]
        for name in ("matrix", "exists", "norms"):
            np.testing.assert_array_equal(getattr(va, name),
                                          getattr(vb, name))
    ref_part = REF_PLANES.get(reader.segments, "vectors", "vec")
    part = PLANES.get(segs, "vectors", "vec", "cpu")
    rq8, rscales = ref_part.quantized_mirror()
    q8, scales = part.quantized_mirror()
    np.testing.assert_array_equal(q8.numpy(), np.asarray(rq8))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(rscales))
    np.testing.assert_array_equal(part.matrix.numpy(),
                                  np.asarray(ref_part.matrix))
    from elasticsearch_tpu.search.phase import query_shard as ref_query
    from elasticsearch_tpu.search import dsl as ref_dsl
    mappers = MapperService(mapping("cosine"))
    for q in make_vectors(8, 4):
        qv = [float(x) for x in q]
        want = ref_query(reader, ref.mappers, ref_dsl.Knn(
            field="vec", query_vector=qv, k=10), size=10)
        got = query_shard(Reader(segs), mappers, dsl.Knn(
            field="vec", query_vector=qv, k=10), size=10, device="cpu")
        assert [(d.segment_idx, d.doc, d.score) for d in got.docs] == \
            [(d.segment_idx, d.doc, d.score) for d in want.docs]


def big_segment(seg_module, n_docs: int):
    """One segment of ``n_docs`` docs with a vector each (no engine: the
    routing decision and its probe are under test), as a ``seg_module``
    Segment: integer vectors around 1,024 lattice points 32 apart, moved
    by 0 or 1 a dim, n_docs / 1,024 docs each -- one cluster per list of
    the IVF index (nlist 4 * sqrt(65,536) = 1,024), so k-means finds the
    same lists in both packages. Returns (segment, lattice points)."""
    rng = np.random.default_rng(41)
    codes = rng.choice(8 ** 6, 1024, replace=False)
    centers = rng.integers(0, 224, (1024, DIMS)).astype(np.float32)
    for d in range(6):
        centers[:, d] = (codes // 8 ** d) % 8 * 32
    which = rng.permutation(np.repeat(np.arange(1024), n_docs // 1024))
    m = (centers[which] + rng.integers(0, 2, (n_docs, DIMS))).astype(
        np.float32)
    seg = seg_module.Segment("big0", n_docs)
    seg.vectors["vec"] = seg_module.VectorField(
        matrix=m, exists=np.ones(n_docs, bool),
        norms=np.linalg.norm(m, axis=1).astype(np.float32),
        similarity="cosine", dims=DIMS)
    seg.ids = [str(j) for j in range(n_docs)]
    seg.invalidate_live_count()
    return seg, centers


@pytest.mark.parametrize("plane", [True, False])
def test_ivf_routed_knn_raises_not_ported(plane, planes):
    """(The name predates the IVF route, which this test once proved
    refused.) A default-mapped field whose segments hold 65,536 docs or
    more takes the JAX package's IVF route -- the shard-level index with
    the plane resident, the segment's own without -- and the port serves
    it: query_shard equals the JAX package's, ids and score bits; the
    same segment mapped as a flat (brute-force) index is served
    exactly."""
    from elasticsearch_tpu.index import segment as ref_seg
    from elasticsearch_tpu.index.engine import Reader as RefReader
    from elasticsearch_tpu.search import dsl as ref_dsl
    from elasticsearch_tpu.search.phase import query_shard as ref_query
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    for p in (REF_PLANES, PLANES):
        p.enabled, p.min_segments = plane, 1
    ref_segment, centers = big_segment(ref_seg, 65536)
    segs = segments_from_reference([ref_segment])
    rng = np.random.default_rng(42)
    queries = centers[rng.integers(0, 1024, 4)] + 1.0
    calls0 = DEVICE_PROFILE.family("ivf_search").calls
    builds0 = PLANES.stats["plane_builds"]
    for opts in (None, {"type": "flat"}):
        for qv in queries:
            qv = [float(x) for x in qv]
            want = ref_query(
                RefReader([ref_segment]), RefMappers(mapping("cosine", opts)),
                ref_dsl.Knn(field="vec", query_vector=qv, k=10,
                            num_candidates=150), size=10)
            got = query_shard(Reader(segs), MapperService(mapping(
                "cosine", opts)), dsl.Knn(field="vec", query_vector=qv,
                                          k=10, num_candidates=150),
                size=10, device="cpu")
            assert [(d.segment_idx, d.doc, d.score) for d in got.docs] == \
                [(d.segment_idx, d.doc, d.score) for d in want.docs]
            assert len(got.docs) == 10
        if opts is None:
            # every query probed the IVF index, one launch each
            assert DEVICE_PROFILE.family("ivf_search").calls - calls0 == \
                len(queries)
    assert (PLANES.stats["plane_builds"] > builds0) == plane


@pytest.mark.parametrize("body,feature", [
    # (the id predates filtered kNN, which the port now serves --
    # tests/test_torch_knn_filtered.py -- and is kept for a filtered knn
    # whose filter holds a query node still outside the port)
    pytest.param(knn_body([1.0] * DIMS, knn={"filter": {"query_string": {
        "query": "t1"}}}), "dense_query:QueryString", id="body0-knn_filter"),
    # (the ids of body1 and body3 predate the wide selection, which now
    # serves windows above the kernels' 4,096-entry top-k: those bodies
    # are held to the reference's answer; feature None)
    pytest.param(knn_body([1.0] * DIMS, k=5000, num_candidates=5000), None,
                 id="body1-knn_k_over_4096"),
    # (the ids predate the dense collector, which now serves knn inside
    # bool and refuses a non-vector script_score source as the JAX
    # package does, with a 400 -- tests/test_torch_dense_slice.py -- and
    # are kept for requests still outside the port)
    pytest.param({"query": {"nested": {"path": "parts", "query": {
        "knn": {"field": "vec", "query_vector": [1.0] * DIMS, "k": 3}}}}},
        "dense_query:Nested", id="body2-dense_collector"),
    pytest.param({"query": {"bool": {"must": [{"knn": {
        "field": "vec", "query_vector": [1.0] * DIMS, "k": 3}}]}},
        "size": 5000}, None, id="body3-dense_collector"),
])
def test_out_of_slice_knn_requests_raise_not_ported(body, feature, planes):
    from elasticsearch_tpu_torch.search import telemetry
    ref, port = index_both("cosine", make_vectors(9, 60), refresh_at=(30,))
    svc = SearchService(port, device="cpu")
    if feature is None:
        run(RefService(ref), svc, [body])
        return
    before = telemetry.TELEMETRY.not_ported.get(feature, 0)
    with pytest.raises(NotPortedError) as info:
        svc.search(body)
    assert info.value.status == 501
    assert info.value.feature == feature
    assert telemetry.TELEMETRY.not_ported[feature] == before + 1


def test_ivf_index_option_raises_not_ported(planes):
    """(The name predates the IVF route, which this test once proved
    refused.) ``index_options.type: ivf`` on small segments is served as
    the JAX package serves it: ids, totals and score bits, with the plane
    resident and without."""
    ref, port = index_both("cosine", make_vectors(10, 60),
                           refresh_at=(30,), index_options={"type": "ivf"})
    for enabled in (True, False):
        REF_PLANES.enabled = PLANES.enabled = enabled
        run(RefService(ref), SearchService(port, device="cpu"),
            [knn_body(v, num_candidates=nc) for v, nc in zip(
                make_vectors(12, 4), (10, 20, 50, 200))])
