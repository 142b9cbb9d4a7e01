"""Filtered kNN in elasticsearch_tpu_torch against the JAX package, on the
CPU, on the same seeded numpy inputs:

- the masked programs' plain PyTorch versions (K5 / K6 / K7 with a
  per-query mask stack) against ``knn_topk_batch_masked``,
  ``knn_coarse_candidates_masked`` and ``knn_rerank_exact_masked``;
- ``KnnExecutor.top_k_batch``'s routing: one shared [N_pad] mask folds
  into ``live`` (one unmasked launch), a [Q, N_pad] stack takes the one
  masked launch, as in the JAX package;
- served ``_search`` responses for ``knn`` with a term, terms, range or
  bool filter over the three similarities, plane and per-segment,
  quantized tier on and off; ``batched_knn_shard`` with shared and
  heterogeneous filters, its filter-mask counters included; and a batch
  mixing filtered and unfiltered members on an IVF-routed field.

Tolerance. The filtered route is exact. With integer-valued vectors every
dot product is exact in any order, so scores, ids and totals must be
equal bit for bit; Gaussian vectors compare scores to rtol 4e-6 (f32
re-association of the dot products, as in tests/test_torch_knn.py) and
ids wherever neighbouring scores are further apart than that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.index import InternalEngine as RefEngine
from elasticsearch_tpu.mapping import MapperService as RefMappers
from elasticsearch_tpu.ops import knn as ref
from elasticsearch_tpu.ops.device_segment import PLANES as REF_PLANES
from elasticsearch_tpu.search import SearchService as RefService
from elasticsearch_tpu.search import batch_executor as ref_batch
from elasticsearch_tpu.search import dsl as ref_dsl

from elasticsearch_tpu_torch.index import InternalEngine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import knn as port
from elasticsearch_tpu_torch.ops.device_segment import PLANES, quantize_rows
from elasticsearch_tpu_torch.search import SearchService, dsl
from elasticsearch_tpu_torch.search import batch_executor as port_batch
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from test_torch_knn_slice import planes  # noqa: F401 (a fixture)
from torch_inputs import close_ids, make_knn_inputs

RTOL = 4e-6
SIMS = ("cosine", "dot_product", "l2_norm")
N_DOCS, N_PAD = 900, 1024
T = torch.as_tensor


def masks_for(seed: int, n_real: int, n_rows: int):
    """Per-query filter rows: ~30 % of the docs, the first row all False,
    the pow2 padding rows past ``n_real`` all False."""
    rng = np.random.default_rng(seed)
    m = rng.random((n_real, N_PAD)) < 0.3
    m[0] = False
    return port.pad_mask_rows_pow2(m, n_rows)


def assert_topk(ps, pd, rs, rd, exact: bool):
    ps, pd, rs, rd = map(np.asarray, (ps, pd, rs, rd))
    np.testing.assert_array_equal(np.isfinite(ps), np.isfinite(rs))
    if exact:
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pd, rd)
    else:
        fin = np.isfinite(rs)
        np.testing.assert_allclose(ps[fin], rs[fin], rtol=RTOL)
        close_ids(rs, rd, pd, RTOL)


CASES = [(kind, n_q, sim) for kind in ("int", "gauss") for n_q in (3, 8)
         for sim in SIMS]
IDS = ["-".join(map(str, c)) for c in CASES]


@pytest.mark.parametrize("kind,n_q,sim", CASES, ids=IDS)
def test_masked_flat_matches_knn_topk_batch_masked(kind, n_q, sim):
    m, norms, exists, live, q = make_knn_inputs(21, 32, n_q, kind, N_DOCS,
                                                N_PAD)
    batch = port.QueryBatch(q, "cpu")
    masks = masks_for(22, n_q, batch.host.shape[0])
    rs, rd = ref.knn_topk_batch_masked(
        jnp.asarray(m), jnp.asarray(norms), jnp.asarray(exists),
        jnp.asarray(live), jnp.asarray(batch.host), jnp.asarray(masks), 24,
        sim)
    ps, pd = port.knn_topk_batch_masked(T(m), T(norms), T(exists), T(live),
                                        batch, T(masks), 24, sim)
    assert_topk(ps, pd, rs, rd, kind == "int")
    assert not np.isfinite(ps.numpy()[0]).any()          # all-False row
    # a masked row has the bits of the unmasked program on allowed & mask
    for r in (1, n_q - 1):
        s1, d1 = port.knn_topk_batch(
            T(m), T(norms), T(exists), T(live & masks[r]),
            port.QueryBatch(q[r: r + 1], "cpu"), 24, sim)
        assert torch.equal(s1[0], ps[r]) and torch.equal(d1[0], pd[r])


@pytest.mark.parametrize("kind,n_q,sim", CASES, ids=IDS)
def test_masked_coarse_and_rerank_match_reference(kind, n_q, sim):
    m, norms, exists, live, q = make_knn_inputs(23, 32, n_q, kind, N_DOCS,
                                                N_PAD)
    q8, scales = quantize_rows(m)
    allowed = live & exists
    batch = port.QueryBatch(q, "cpu")
    masks = masks_for(24, n_q, batch.host.shape[0])
    rcs, rcand = ref.knn_coarse_candidates_masked(
        jnp.asarray(q8), jnp.asarray(scales), jnp.asarray(norms),
        jnp.asarray(allowed), jnp.asarray(batch.host), jnp.asarray(masks),
        64, sim)
    pcs, pcand = port.knn_coarse_candidates_masked(
        T(q8), T(scales), T(norms), T(allowed), batch, T(masks), 64, sim)
    assert_topk(pcs, pcand, rcs, rcand,
                kind == "int" or sim == "dot_product")
    # the re-rank re-applies the masks at the candidates: feed it
    # unmasked candidates, which the coarse pass would have kept out
    cs, cand = port.knn_coarse_candidates(
        T(q8), T(scales), T(norms), T(allowed), batch, 64, sim)
    rts, rtd, reps = ref.knn_rerank_exact_masked(
        jnp.asarray(m), jnp.asarray(norms), jnp.asarray(allowed),
        jnp.asarray(batch.host), jnp.asarray(cand.numpy()),
        jnp.asarray(cs.numpy()), jnp.asarray(masks), 10, sim)
    pts, ptd, peps = port.knn_rerank_exact_masked(
        T(m), T(norms), T(allowed), batch, cand, cs, T(masks), 10, sim)
    assert_topk(pts, ptd, rts, rtd, kind == "int")
    if kind == "int":
        np.testing.assert_array_equal(peps.numpy(), np.asarray(reps))
    kept = ptd.numpy()
    for r in range(kept.shape[0]):
        assert all(masks[r, d] for d in kept[r] if d >= 0)


def test_executor_routes_shared_and_stacked_masks_as_the_reference():
    """A shared [N_pad] mask folds into live (one unmasked knn_flat call); a
    [Q, N_pad] stack takes the one masked call; both answer as the JAX
    package's KnnExecutor."""
    from elasticsearch_tpu.ops.device_segment import DeviceVectors as RefDV
    from elasticsearch_tpu.index.segment import VectorField as RefVF
    from elasticsearch_tpu_torch.ops.device_segment import DeviceVectors
    from elasticsearch_tpu_torch.index.segment import VectorField
    m, norms, exists, live, q = make_knn_inputs(25, 16, 5, "int", N_DOCS,
                                                N_PAD)
    fields = dict(matrix=m[:N_DOCS], exists=exists[:N_DOCS],
                  norms=norms[:N_DOCS], similarity="cosine", dims=16)
    ref_ex = ref.KnnExecutor(RefDV(RefVF(**fields), N_DOCS))
    port_ex = port.KnnExecutor(DeviceVectors(VectorField(**fields), N_DOCS,
                                             "cpu"))
    shared = np.random.default_rng(26).random(N_PAD) < 0.5
    stack = masks_for(27, 5, 5)
    for masks, family in ((shared, "knn_flat"), (stack, "knn_flat_masked")):
        before = {f: DEVICE_PROFILE.family(f).calls
                  for f in ("knn_flat", "knn_flat_masked")}
        rs, rd = ref_ex.top_k_batch(q, jnp.asarray(live), 10,
                                    jnp.asarray(masks) if masks.ndim == 1
                                    else masks)
        ps, pd = port_ex.top_k_batch(q, T(live), 10,
                                     T(masks) if masks.ndim == 1 else masks)
        assert_topk(ps, pd, rs, rd, exact=True)
        after = {f: DEVICE_PROFILE.family(f).calls - before[f]
                 for f in before}
        assert after == {f: int(f == family) for f in before}


# ---------------------------------------------------------------------------
# served: filtered knn against a JAX node
# ---------------------------------------------------------------------------

DIMS = 16


def mapping(sim: str, index_options=None):
    vec = {"type": "dense_vector", "dims": DIMS, "similarity": sim}
    if index_options is not None:
        vec["index_options"] = index_options
    return {"properties": {"vec": vec, "tag": {"type": "keyword"},
                           "n": {"type": "integer"}}}


def index_both(sim, vectors, refresh_at=(), deletes=(), missing=(),
               index_options=None):
    engines = (RefEngine(RefMappers(mapping(sim, index_options)),
                         shard_label="ref"),
               InternalEngine(MapperService(mapping(sim, index_options)),
                              shard_label="port"))
    for i, v in enumerate(vectors):
        body = {"tag": f"t{i % 5}", "n": int(i * 7 % 100)}
        if i not in missing:
            body["vec"] = [float(x) for x in v]
        for e in engines:
            e.index(str(i), body)
        if i in refresh_at:
            for e in engines:
                e.refresh()
    for e in engines:
        e.refresh()
    for i in deletes:
        for e in engines:
            e.delete(str(i))
    for e in engines:
        e.refresh()
    return engines


FILTERS = [
    {"term": {"tag": "t1"}},
    {"terms": {"tag": ["t0", "t3"]}},
    {"range": {"n": {"gte": 20, "lt": 45}}},
    {"bool": {"must": [{"term": {"tag": "t2"}}],
              "must_not": [{"range": {"n": {"gte": 50}}}]}},
    {"bool": {"filter": [{"term": {"tag": "t4"}},
                         {"range": {"n": {"lte": 80}}}]}},
    {"term": {"tag": "none"}},                     # matches nothing
]


def filtered_bodies(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.integers(0, 256, DIMS).astype(float).tolist()
        k, size = ((10, 10), (5, 3), (25, 10))[i % 3]
        knn = {"field": "vec", "query_vector": q, "k": k,
               "num_candidates": 50, "filter": FILTERS[i % len(FILTERS)]}
        if i % 4 == 3:
            knn["boost"] = 2.0
        body = {"query": {"knn": knn}, "size": size}
        if i % 3 == 2:
            body["from"] = 5
        out.append(body)
    return out


def assert_same(ref_svc, port_svc, bodies):
    for body in bodies:
        a, b = ref_svc.search(body), port_svc.search(body)
        ha, hb = a["hits"], b["hits"]
        assert ha["total"] == hb["total"]
        assert [h["_id"] for h in ha["hits"]] == [h["_id"] for h in hb["hits"]]
        assert [h["_score"] for h in ha["hits"]] == \
            [h["_score"] for h in hb["hits"]]
        assert ha["max_score"] == hb["max_score"]


def int_vectors(seed: int, n: int):
    v = np.random.default_rng(seed).integers(0, 256, (n, DIMS)).astype(
        np.float32)
    if n > 300:
        v[7] = v[3]                               # score ties
        v[300] = v[3]
    return v


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("route", ["plane", "per_segment"])
@pytest.mark.parametrize("quantized", [True, False])
def test_filtered_knn_responses_match_reference(sim, route, quantized,
                                                planes):
    ref_e, port_e = index_both(sim, int_vectors(31, 1400),
                               refresh_at=(400, 900),
                               deletes=(5, 401, 1000), missing=(9, 950))
    for p in (REF_PLANES, PLANES):
        p.enabled = route == "plane"
        p.quantized = quantized
        # a shallow first depth makes the margin fail and escalate
        p.rerank_depth, p.rerank_depth_max = 16, 64
    served0 = PLANES.stats["quantized_queries"]
    assert_same(RefService(ref_e), SearchService(port_e, device="cpu"),
                filtered_bodies(32, 12))
    assert (PLANES.stats["quantized_queries"] > served0) == (
        route == "plane" and quantized)


def batch_specs(module, dsl_module, queries, filters, nc=50):
    out = []
    for q, f in zip(queries, filters):
        filt = None if f is None else dsl_module.parse_query(f)
        out.append(module.BatchSpec(
            kind="knn", field="vec", window=10,
            query_vector=[float(x) for x in q], k=10, num_candidates=nc,
            filter=filt, filter_key=None if f is None else repr(f)))
    return out


def key_batch(out):
    return [[(d.segment_idx, d.doc, d.score) for d in c[:10]]
            for c, _t, _r, _m, _p in out]


@pytest.mark.parametrize("route", ["plane", "per_segment"])
def test_batched_filtered_knn_matches_reference(route, planes):
    """batched_knn_shard with one shared filter (one mask for the batch)
    and with distinct filters (one masked launch), against the JAX
    package's batch and the port's own solo answers; the filter-mask
    counters move as the JAX package's do."""
    from elasticsearch_tpu.search.phase import query_shard as ref_query
    from elasticsearch_tpu_torch.search.phase import query_shard
    ref_e, port_e = index_both("cosine", int_vectors(33, 1200),
                               refresh_at=(600,), deletes=(8,))
    for p in (REF_PLANES, PLANES):
        p.enabled = route == "plane"
        p.quantized = False
    ref_reader, port_reader = ref_e.acquire_reader(), port_e.acquire_reader()
    ref_ctxs = ref_batch._build_ctxs(ref_reader, ref_e.mappers, None, None)
    port_ctxs = port_batch._build_ctxs(port_reader, port_e.mappers, None,
                                       None, device="cpu")
    queries = int_vectors(34, 6)
    mixes = ([FILTERS[0]] * 6,
             [FILTERS[i % 4] for i in range(6)],
             [None, FILTERS[2], None, FILTERS[3], FILTERS[2], None])
    for filters in mixes:
        for rep in range(2):          # the second drain reuses the masks
            st_r, st_p = {}, {}
            want = ref_batch.batched_knn_shard(
                ref_ctxs, "vec", batch_specs(ref_batch, ref_dsl, queries,
                                             filters), 10, stats=st_r)
            got = port_batch.batched_knn_shard(
                port_ctxs, "vec", batch_specs(port_batch, dsl, queries,
                                              filters), 10, stats=st_p)
            assert key_batch(got) == key_batch(want)
            assert [c[1:4] for c in got] == [c[1:4] for c in want]
            assert st_p == st_r
        for q, f, row in zip(queries, filters, key_batch(got)):
            knn = dict(field="vec", query_vector=[float(x) for x in q],
                       k=10, num_candidates=50)
            solo = query_shard(port_reader, port_e.mappers, dsl.Knn(
                **knn, filter=None if f is None else dsl.parse_query(f)),
                size=10, device="cpu")
            assert [(d.segment_idx, d.doc, d.score)
                    for d in solo.docs] == row
            ref_solo = ref_query(ref_reader, ref_e.mappers, ref_dsl.Knn(
                **knn, filter=None if f is None
                else ref_dsl.parse_query(f)), size=10)
            assert [(d.segment_idx, d.doc, d.score)
                    for d in ref_solo.docs] == row


@pytest.mark.parametrize("route", ["plane", "per_segment"])
def test_mixed_batch_on_an_ivf_routed_field(route, planes):
    """One batch, filtered and unfiltered members, on a field mapped
    index_options.type: ivf: the unfiltered members probe the IVF index
    (grouped by their derived nprobe on the per-segment route), the
    filtered ones take the exact masked launch -- as in the JAX package."""
    from test_torch_ivf import clustered
    corpus = clustered(35, 10, 60, DIMS)
    ref_e, port_e = index_both("l2_norm", corpus, refresh_at=(300,),
                               index_options={"type": "ivf", "nlist": 10})
    for p in (REF_PLANES, PLANES):
        p.enabled = route == "plane"
    ref_ctxs = ref_batch._build_ctxs(ref_e.acquire_reader(), ref_e.mappers,
                                     None, None)
    port_ctxs = port_batch._build_ctxs(port_e.acquire_reader(),
                                       port_e.mappers, None, None,
                                       device="cpu")
    queries = corpus[[1, 50, 120, 200, 333, 420]] + 1.0
    filters = [None, FILTERS[0], None, FILTERS[2], None, FILTERS[1]]
    calls0 = {f: DEVICE_PROFILE.family(f).calls
              for f in ("ivf_search", "knn_flat_masked",
                        "knn_coarse_masked")}
    ncs = (40, 40, 40, 40, 40, 40) if route == "plane" else \
        (10, 40, 200, 40, 10, 40)
    specs_r = batch_specs(ref_batch, ref_dsl, queries, filters)
    specs_p = batch_specs(port_batch, dsl, queries, filters)
    for sr, sp, nc in zip(specs_r, specs_p, ncs):
        sr.num_candidates = sp.num_candidates = nc
    want = ref_batch.batched_knn_shard(ref_ctxs, "vec", specs_r, 10)
    got = port_batch.batched_knn_shard(port_ctxs, "vec", specs_p, 10)
    assert key_batch(got) == key_batch(want)
    calls = {f: DEVICE_PROFILE.family(f).calls - c
             for f, c in calls0.items()}
    # the masked launch: the exact one, or the quantized tier's (plane)
    assert calls["ivf_search"] >= 1
    assert calls["knn_flat_masked"] + calls["knn_coarse_masked"] >= 1
