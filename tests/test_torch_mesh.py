"""The mesh's text path of elasticsearch_tpu_torch against the JAX package.

Three layers, each on the same seeded inputs in both packages:

- the kernels: the plain versions of ``mesh_bm25_flat``,
  ``mesh_bm25_coarse`` and ``mesh_bm25_rerank`` (``parallel/mesh.py``)
  against the JAX package's shard_map programs, which run on the CPU under
  ``tests/conftest.py``'s 8 virtual devices in 1-device, 2-device and
  (flat) 2x2 ``(dp, shard)`` layouts, at 2 and 4 slots, with a slot that
  holds no field data and a slot with fewer segments; and each slot against
  the one-shard plain versions on that shard's own plane;
- ``mesh_wand_topk`` against the reference's on the same shards: tier on
  and off, totals tracked, clipped and disabled, deletes, a shard without
  the field, a DFS avgdl override;
- the served path: a port node's ``_search`` JSON against a reference
  node's on 2 and 4 shards, ``_data_plane`` included, and the port's own
  identities of ``tests/test_mesh_exec.py`` (mesh == fan-out, the drain
  memo, the budget refusal, the miss fallback, can-match, co-location,
  refresh, DFS).

Tolerances (ROADMAP queue 3, item 3): ids, hits, totals and counts exact;
f32 scores to rtol 1e-6, because the reference adds f32 contributions one
by one and the port sums them in 64-bit fixed point and rounds once; ids
whose reference scores lie within that tolerance of each other are
compared as a set. The port's own mesh == fan-out identities are bitwise.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.parallel import mesh as ref_mesh
from elasticsearch_tpu_torch.index.segment import next_pow2
from elasticsearch_tpu_torch.ops import bm25 as port_bm25
from elasticsearch_tpu_torch.parallel import mesh as port_mesh
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
from test_torch_bm25 import REL_BF16, assert_topk_match
from torch_inputs import FLAT_ORDER, N_SEGS, mesh_inputs, row0 as _row0

K = 10


# ---------------------------------------------------------------------------
# kernels: seeded stacked planes (torch_inputs.mesh_inputs)
# ---------------------------------------------------------------------------

def jx(inp, names, bf16=()):
    out = []
    for n in names:
        a = jnp.asarray(inp[n])
        out.append(a.astype(jnp.bfloat16) if n in bf16 else a)
    return out


def tx(inp, names, bf16=()):
    out = []
    for n in names:
        t = torch.as_tensor(inp[n])
        out.append(t.to(torch.bfloat16) if n in bf16 else t)
    return out


def ref_layout(n_slots: int, dp: int, devices: int):
    mesh, n_slots_got, _ = ref_mesh.mesh_layout(n_slots, dp=dp,
                                                max_devices=devices)
    assert n_slots_got == n_slots
    return mesh


LAYOUTS = [(1, 1), (1, 2), (2, 4)]      # (dp, devices)
SLOTS = [(2, -1, -1), (4, 2, 1)]        # (S, empty slot, one-segment slot)


@pytest.mark.parametrize("n_slots,empty,one_seg", SLOTS,
                         ids=["s2", "s4_empty_slot_one_segment_slot"])
@pytest.mark.parametrize("dp,devices", LAYOUTS,
                         ids=["1dev", "2dev", "dp2x2dev"])
def test_mesh_bm25_flat_matches_reference(n_slots, empty, one_seg, dp,
                                          devices):
    n_q = 4
    inp = mesh_inputs(31 + n_slots + 7 * dp, n_slots, dp, n_q, empty=empty,
                      one_seg=one_seg)
    fn = ref_mesh.mesh_bm25_flat(ref_layout(n_slots, dp, devices),
                                 inp["n_pad"], n_q, K, N_SEGS,
                                 port_bm25.DEFAULT_K1, port_bm25.DEFAULT_B)
    s_r, d_r, h_r = fn(*jx(inp, FLAT_ORDER))
    s, d, h = port_mesh.mesh_bm25_flat(*tx(inp, FLAT_ORDER), inp["n_pad"],
                                       n_q, K, N_SEGS)
    assert s.shape == d.shape == (n_slots, dp, n_q, K)
    assert h.shape == (n_slots, dp, n_q, N_SEGS)
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_r))
    for si in range(n_slots):
        for r in range(dp):
            assert_topk_match(np.asarray(s_r)[si, r], np.asarray(d_r)[si, r],
                              s[si, r], d[si, r])
    if empty >= 0:
        assert not torch.isfinite(s[empty]).any()
        assert int(h[empty].sum()) == 0


@pytest.mark.parametrize("n_slots,empty,one_seg", SLOTS,
                         ids=["s2", "s4_empty_slot_one_segment_slot"])
@pytest.mark.parametrize("devices", [1, 2], ids=["1dev", "2dev"])
def test_mesh_bm25_coarse_and_rerank_match_reference(n_slots, empty, one_seg,
                                                     devices):
    n_q, kprime = 4, 64
    inp = _row0(mesh_inputs(53 + n_slots, n_slots, 1, n_q, empty=empty,
                            one_seg=one_seg))
    mesh = ref_layout(n_slots, 1, devices)
    k1, b = port_bm25.DEFAULT_K1, port_bm25.DEFAULT_B
    c_fn = ref_mesh.mesh_bm25_coarse(mesh, inp["n_pad"], n_q, kprime, N_SEGS,
                                     k1, b)
    cs_r, cand_r, h_r = c_fn(*jx(inp, FLAT_ORDER, bf16=("tfs", "dl")))
    cs, cand, h = port_mesh.mesh_bm25_coarse(
        *tx(inp, FLAT_ORDER, bf16=("tfs", "dl")), inp["n_pad"], n_q, kprime,
        N_SEGS)
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_r))
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_r), rtol=REL_BF16)
    for si in range(n_slots):
        assert_topk_match(np.asarray(cs_r)[si], np.asarray(cand_r)[si],
                          cs[si], cand[si])
    # both tiers re-rank the SAME candidates (the reference's)
    r_fn = ref_mesh.mesh_bm25_rerank(mesh, inp["n_pad"], n_q, kprime, K,
                                     N_SEGS, k1, b)
    rr_order = ("docs", "tfs", "idx", "w", "q", "avg", "dl", "live")
    s_r, d_r, eps_r = r_fn(*jx(inp, rr_order), cand_r, cs_r)
    s, d, eps = port_mesh.mesh_bm25_rerank(
        *tx(inp, rr_order), torch.as_tensor(np.array(cand_r)),
        torch.as_tensor(np.array(cs_r)), inp["n_pad"], n_q, kprime, K)
    assert s.shape == d.shape == (n_slots, n_q, K)
    assert eps.shape == (n_slots, n_q)
    for si in range(n_slots):
        assert_topk_match(np.asarray(s_r)[si], np.asarray(d_r)[si], s[si],
                          d[si])
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_r), rtol=1e-4,
                               atol=1e-5)


def _own_plane(inp, si):
    """Slot ``si``'s plane at its own size (its shard's one-plane
    layout), and its own segment count."""
    n_pad, nb, n_segs = inp["own"][si]
    nb_pad = next_pow2(nb)
    return dict(docs=inp["docs"][si, :nb_pad], tfs=inp["tfs"][si, :nb_pad],
                dl=inp["dl"][si, :n_pad], live=inp["live"][si, :n_pad],
                seg=inp["seg"][si, :n_pad]), n_pad, n_segs


@pytest.mark.parametrize("n_slots,empty,one_seg", SLOTS,
                         ids=["s2", "s4_empty_slot_one_segment_slot"])
def test_each_slot_is_the_one_shard_kernel_on_its_plane(n_slots, empty,
                                                        one_seg):
    """Per slot, the mesh plain versions equal the one-shard plain
    versions (K2/K3/K4's) bitwise, on the slot of the stack and on the
    shard's own unpadded plane; counts past a slot's own segments are 0."""
    n_q, kprime, dp = 4, 64, 2
    inp = mesh_inputs(71 + n_slots, n_slots, dp, n_q, empty=empty,
                      one_seg=one_seg)
    t = dict(zip(FLAT_ORDER, tx(inp, FLAT_ORDER)))
    n_pad = inp["n_pad"]
    s, d, h = port_mesh.mesh_bm25_flat(*tx(inp, FLAT_ORDER), n_pad, n_q, K,
                                       N_SEGS)
    r0 = _row0(inp)
    q16 = tx(r0, FLAT_ORDER, bf16=("tfs", "dl"))
    cs, cand, hc = port_mesh.mesh_bm25_coarse(*q16, n_pad, n_q, kprime,
                                              N_SEGS)
    rr = tx(r0, ("docs", "tfs", "idx", "w", "q", "avg", "dl", "live"))
    ss, dd, eps = port_mesh.mesh_bm25_rerank(*rr, cand, cs, n_pad, n_q,
                                             kprime, K)
    for si in range(n_slots):
        for r in range(dp):
            want = port_bm25.bm25_flat_seg_plain(
                t["docs"][si], t["tfs"][si], t["idx"][si, r], t["w"][si, r],
                t["q"][si, r], t["dl"][si], t["avg"][si, r], t["live"][si],
                t["seg"][si], n_pad, n_q, K, n_segs=N_SEGS)
            for got, ref in zip((s[si, r], d[si, r], h[si, r]), want):
                assert torch.equal(got, ref)
        c16 = [x[si] for x in q16]
        want = port_bm25.bm25_coarse_plain(
            c16[0], c16[1], c16[3], c16[4], c16[5], c16[2], c16[6], c16[7],
            c16[8], n_pad, n_q, N_SEGS, kprime)
        for got, ref in zip((cs[si], cand[si], hc[si]), want):
            assert torch.equal(got, ref)
        rs = [x[si] for x in rr]
        want = port_bm25.bm25_rerank_plain(
            rs[0], rs[1], rs[2], rs[3], rs[4], rs[6], rs[5], rs[7],
            cand[si], cs[si], n_pad, n_q, kprime, K)
        for got, ref in zip((ss[si], dd[si], eps[si]), want):
            assert torch.equal(got, ref)
        # the shard's own plane: the same finite hits, the same counts
        own, own_pad, own_segs = _own_plane(inp, si)
        o = tx(own, ("docs", "tfs", "dl", "live", "seg"))
        want = port_bm25.bm25_flat_seg_plain(
            o[0], o[1], t["idx"][si, 0], t["w"][si, 0], t["q"][si, 0], o[2],
            t["avg"][si, 0], o[3], o[4], own_pad, n_q, K, n_segs=own_segs)
        fin = torch.isfinite(s[si, 0])
        assert torch.equal(fin, torch.isfinite(want[0]))
        assert torch.equal(s[si, 0][fin], want[0][fin])
        assert torch.equal(d[si, 0][fin], want[1][fin])
        assert torch.equal(h[si, 0][:, :own_segs], want[2])
        assert int(h[si, :, :, own_segs:].sum()) == 0


def test_plain_mesh_calls_are_not_launches():
    inp = mesh_inputs(5, 2, 1, 2)
    before = {f: DEVICE_PROFILE.family(f).launches
              for f in ("mesh_bm25_flat", "mesh_bm25_coarse")}
    calls = DEVICE_PROFILE.family("mesh_bm25_flat").calls
    port_mesh.mesh_bm25_flat(*tx(inp, FLAT_ORDER), inp["n_pad"], 2, K,
                             N_SEGS)
    assert DEVICE_PROFILE.family("mesh_bm25_flat").calls == calls + 1
    assert {f: DEVICE_PROFILE.family(f).launches for f in before} == before


def test_mesh_wrappers_refuse_bad_inputs():
    inp = mesh_inputs(6, 2, 1, 2)
    args = tx(inp, FLAT_ORDER)
    bad = list(args)
    bad[3] = bad[3][:1]                     # flat stack of the wrong slots
    with pytest.raises(ValueError):
        port_mesh.mesh_bm25_flat(*bad, inp["n_pad"], 2, K, N_SEGS)
    bad = list(args)
    bad[1] = bad[1].to(torch.bfloat16)      # f32 tier given bf16 tfs
    with pytest.raises(TypeError):
        port_mesh.mesh_bm25_flat(*bad, inp["n_pad"], 2, K, N_SEGS)
    with pytest.raises(TypeError):          # coarse tier given f32 mirrors
        port_mesh.mesh_bm25_coarse(*tx(_row0(inp), FLAT_ORDER),
                                   inp["n_pad"], 2, 16, N_SEGS)


def test_mesh_layout_on_the_cpu_and_the_card_guard(monkeypatch):
    """A CPU node's mesh is ready and lays out a 1x1 grid; a card node's
    mesh is ready only once CUDA is initialized (it never pays first-init
    inside a search); every slot lives on the node's device, so ``dp``
    caps at 1 and S equals the shard count."""
    grid, n_slots, spd = port_mesh.mesh_layout(3, device="cpu")
    assert grid == [[torch.device("cpu")]] and n_slots == spd == 3
    assert port_mesh.mesh_ready("cpu")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert not port_mesh.mesh_ready(None)
    assert not port_mesh.mesh_ready("cuda")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert port_mesh.mesh_ready("cuda")
    grid, n_slots, _ = port_mesh.mesh_layout(4, device="cuda")
    assert grid == [[torch.device("cuda")]] and n_slots == 4


# ---------------------------------------------------------------------------
# mesh_wand_topk: the port's executor against the reference's
# ---------------------------------------------------------------------------

from elasticsearch_tpu.index import InternalEngine as RefEngine  # noqa: E402
from elasticsearch_tpu.mapping import MapperService as RefMappers  # noqa: E402
from elasticsearch_tpu.ops import device_segment as ref_ds  # noqa: E402
from elasticsearch_tpu.search import batch_executor as ref_be  # noqa: E402
from elasticsearch_tpu.search import dsl as ref_dsl  # noqa: E402
from elasticsearch_tpu.search import phase as ref_phase  # noqa: E402
from elasticsearch_tpu.search import plane_exec as ref_pe  # noqa: E402
from elasticsearch_tpu_torch.index import InternalEngine  # noqa: E402
from elasticsearch_tpu_torch.indices.breaker import BREAKERS  # noqa: E402
from elasticsearch_tpu_torch.mapping import MapperService  # noqa: E402
from elasticsearch_tpu_torch.ops import device_segment as ds  # noqa: E402
from elasticsearch_tpu_torch.search import batch_executor as be  # noqa: E402
from elasticsearch_tpu_torch.search import dsl, telemetry  # noqa: E402
from elasticsearch_tpu_torch.search import phase  # noqa: E402
from elasticsearch_tpu_torch.search import plane_exec as pe  # noqa: E402

VOCAB = [f"w{i}" for i in range(30)]
TEXT_MAPPING = {"properties": {"body": {"type": "text"},
                               "tag": {"type": "keyword"}}}
PORT = dict(engine=InternalEngine, mappers=MapperService, ds=ds, be=be,
            dsl=dsl, phase=phase, pe=pe, kw={"device": "cpu"})
REF = dict(engine=RefEngine, mappers=RefMappers, ds=ref_ds, be=ref_be,
           dsl=ref_dsl, phase=ref_phase, pe=ref_pe, kw={})


def _reset(pkg, depth: int = 128, quantized: bool = True) -> None:
    for reg in (pkg["ds"].MESH_PLANES, pkg["ds"].PLANES):
        reg.clear()
    mesh = pkg["ds"].MESH_PLANES
    mesh.enabled, mesh.min_shards, mesh.dp, mesh.hosts = True, 2, 1, None
    if pkg is REF:
        mesh.max_devices = 0
    planes = pkg["ds"].PLANES
    planes.enabled, planes.min_segments = True, 2
    planes.rerank_depth, planes.quantized = depth, quantized


@pytest.fixture(autouse=True)
def _mesh_defaults():
    """Both packages' registries are process-global: every test starts
    and ends on the defaults with nothing resident."""
    for pkg in (PORT, REF):
        _reset(pkg)
    yield
    for pkg in (PORT, REF):
        _reset(pkg)


def _shard_ops(seed: int, n_docs: int = 90, body: bool = True):
    """One shard's writes: docs of 4-13 words over 30 (no ``body`` when
    ``body`` is False), refreshes at 30 and 60 (three segments), every
    13th doc deleted."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_docs):
        src = {"tag": f"t{i % 3}"}
        words = rng.choice(VOCAB, size=int(rng.integers(4, 14)))
        if body:
            src["body"] = " ".join(words)
        ops.append(("index", str(i), src))
        if i in (30, 60):
            ops.append(("refresh",))
    ops += [("delete", str(i)) for i in range(0, n_docs, 13)]
    ops.append(("refresh",))
    return ops


def _engines(pkg, seed: int, n_shards: int, no_body=(), n_docs: int = 90):
    engines = []
    for s in range(n_shards):
        eng = pkg["engine"](pkg["mappers"](TEXT_MAPPING),
                            shard_label=f"tm{seed}_{s}")
        for op in _shard_ops(seed + 100 * s, n_docs, body=s not in no_body):
            if op[0] == "index":
                eng.index(op[1], op[2])
            elif op[0] == "delete":
                eng.delete(op[1])
            else:
                eng.refresh()
        engines.append(eng)
    return engines


def _ctxs(pkg, reader, mappers, query, dfs=None):
    be_mod = pkg["be"]
    if dfs is not None:
        return be_mod._build_ctxs(reader, mappers, dfs["doc_count"],
                                  dfs["df"], field_stats=dfs["fields"],
                                  **pkg["kw"])
    _dc, df = pkg["phase"].shard_term_stats(reader, mappers, query)
    return be_mod._build_ctxs(reader, mappers,
                              sum(s.n_docs for s in reader.segments), df,
                              **pkg["kw"])


def _global_dfs(readers, terms):
    """A coordinator's DFS statistics over every shard: doc count, each
    term's df, and the field's (sum of lengths, docs with the field)."""
    doc_count, df, sum_len, n_with = 0, {}, 0.0, 0
    for r in readers:
        for seg in r.segments:
            doc_count += seg.n_docs
            pf = seg.postings.get("body")
            if pf is None:
                continue
            sum_len += float(pf.sum_doc_len)
            n_with += int((np.asarray(pf.doc_lens) > 0).sum())
            for t in terms:
                tid = pf.terms.get(t)
                df[t] = df.get(t, 0) + (0 if tid is None
                                        else int(pf.doc_freq[tid]))
    return {"doc_count": doc_count, "df": {"body": df},
            "fields": {"body": (sum_len, n_with)}}


def _mesh_rows(pkg, seed, n_shards, clause_lists, want, track,
               no_body=(), dfs_terms=None):
    engines = _engines(pkg, seed, n_shards, no_body)
    readers = [e.acquire_reader() for e in engines]
    mappers = engines[0].mappers
    q = pkg["dsl"].parse_query({"match": {"body": "w1 w3 w7"}})
    dfs = _global_dfs(readers, dfs_terms) if dfs_terms else None
    shard_ctxs = [_ctxs(pkg, r, mappers, q, dfs) for r in readers]
    shard_segments = [(("idx", sid), list(r.segments))
                      for sid, r in enumerate(readers)]
    mpart = pkg["ds"].MESH_PLANES.get(shard_segments, "postings", "body",
                                      **pkg["kw"])
    assert mpart is not None
    counter = []
    got = pkg["pe"].mesh_wand_topk(shard_ctxs, mpart, "body", clause_lists,
                                   want, track, counter=counter)
    return got, counter, mpart


def assert_rows_match(mine, ref, exact_scores=False):
    """(candidates, total, relation, max_score, prune) rows: ids exact
    outside tie groups (reference scores within RTOL), scores to RTOL
    (bitwise when ``exact_scores``), totals, relations and prune counts
    exact."""
    assert mine[1:3] == ref[1:3]
    assert mine[4] == ref[4]
    a = [(c.segment_idx, c.doc) for c in mine[0]]
    b = [(c.segment_idx, c.doc) for c in ref[0]]
    assert len(a) == len(b)
    sa = np.array([c.score for c in mine[0]])
    sb = np.array([c.score for c in ref[0]])
    if exact_scores:
        np.testing.assert_array_equal(sa, sb)
        assert a == b
        return
    np.testing.assert_allclose(sa, sb, rtol=1e-6)
    i = 0
    while i < len(sb):
        j = i + 1
        while j < len(sb) and abs(sb[j] - sb[i]) <= 1e-6 * abs(sb[i]):
            j += 1
        if j < len(sb):
            assert sorted(a[i:j]) == sorted(b[i:j])
        i = j
    if ref[3] is None:
        assert mine[3] is None
    else:
        assert abs(mine[3] - ref[3]) <= 1e-6 * abs(ref[3])


CLAUSES = [[("w1 w3 w7", 1.0)], [("w2 w9", 1.0)], [("zzz", 1.0)],
           [("w4", 2.0), ("w5 w6", 1.0)]]


@pytest.mark.parametrize("track", [10_000, 5, 0],
                         ids=["tracked", "clipped", "disabled"])
@pytest.mark.parametrize("tier", [False, True], ids=["exact", "tier"])
@pytest.mark.parametrize("case", ["plain", "no_body_shard", "dfs"])
def test_mesh_wand_topk_matches_reference(case, tier, track):
    n_shards = 4 if case == "no_body_shard" else 3
    no_body = (2,) if case == "no_body_shard" else ()
    dfs_terms = ["w1", "w2", "w3", "w4", "w5", "w6", "w7", "w9", "zzz"] \
        if case == "dfs" else None
    for pkg in (PORT, REF):
        # a shallow starting depth lets the tier engage on 90-doc shards
        _reset(pkg, depth=8 if tier else 128, quantized=tier)
    stat = "mesh_quantized_queries"
    base = (ds.MESH_PLANES.stats[stat], ref_ds.MESH_PLANES.stats[stat])
    mine, counter, mpart = _mesh_rows(PORT, 11, n_shards, CLAUSES, 10,
                                      track, no_body, dfs_terms)
    ref, ref_counter, _ = _mesh_rows(REF, 11, n_shards, CLAUSES, 10, track,
                                     no_body, dfs_terms)
    assert len(mine) == len(ref) == n_shards
    for si in range(n_shards):
        for qi in range(len(CLAUSES)):
            assert_rows_match(mine[si][qi], ref[si][qi])
    assert len(counter) == len(ref_counter)
    served = ds.MESH_PLANES.stats[stat] - base[0]
    assert served == ref_ds.MESH_PLANES.stats[stat] - base[1]
    assert (served > 0) == tier
    if no_body:
        assert mpart.subs[2] is None
        assert all(row == ([], 0, "eq", None, (0, 0)) for row in mine[2])


@pytest.mark.parametrize("track", [10_000, 5, 0],
                         ids=["tracked", "clipped", "disabled"])
@pytest.mark.parametrize("tier", [False, True], ids=["exact", "tier"])
def test_mesh_equals_the_per_shard_batch_bitwise(tier, track):
    """The port's golden identity (test_mesh_exec.py:195 and :199: the
    port's layout is the one-device one): every shard's mesh row equals
    the shard batcher's own answer for that shard, scores bitwise."""
    _reset(PORT, depth=8 if tier else 128, quantized=tier)
    engines = _engines(PORT, 17, 3)
    readers = [e.acquire_reader() for e in engines]
    mappers = engines[0].mappers
    q = dsl.parse_query({"match": {"body": "w1 w3 w7"}})
    shard_ctxs = [_ctxs(PORT, r, mappers, q) for r in readers]
    mpart = ds.MESH_PLANES.get([(("idx", s), list(r.segments))
                                for s, r in enumerate(readers)],
                               "postings", "body", device="cpu")
    got = pe.mesh_wand_topk(shard_ctxs, mpart, "body", CLAUSES, 10, track)
    for si, r in enumerate(readers):
        want = be.batched_wand_topk_shard(_ctxs(PORT, r, mappers, q),
                                          "body", CLAUSES, 10, track)
        for qi in range(len(CLAUSES)):
            assert_rows_match(got[si][qi], want[qi], exact_scores=True)


def test_refresh_repacks_the_mesh_plane_incrementally():
    """test_mesh_exec.py:318 on the port: an append-only refresh of one
    member re-packs the mesh plane incrementally while the point-in-time
    readers keep their own generation's answers."""
    engines = _engines(PORT, 31, 2)
    mappers = engines[0].mappers
    q = dsl.parse_query({"match": {"body": "w1 w3"}})
    readers = [e.acquire_reader() for e in engines]
    shard_ctxs = [_ctxs(PORT, r, mappers, q) for r in readers]
    mpart = ds.MESH_PLANES.get([(("idx", s), list(r.segments))
                                for s, r in enumerate(readers)],
                               "postings", "body", device="cpu")
    clauses = [[("w1 w3", 1.0)]]
    before = pe.mesh_wand_topk(shard_ctxs, mpart, "body", clauses, 10,
                               10_000)
    for i in range(300, 330):
        engines[0].index(str(i), {"body": "w1 w3 w3", "tag": "t0"})
    engines[0].refresh()
    ds.MESH_PLANES.on_refresh(("idx", 0), engines[0].segments)
    assert ds.MESH_PLANES.stats["mesh_plane_incremental_appends"] >= 1
    again = pe.mesh_wand_topk(shard_ctxs, mpart, "body", clauses, 10,
                              10_000)
    for si in range(2):
        assert_rows_match(again[si][0], before[si][0], exact_scores=True)
    new_readers = [e.acquire_reader() for e in engines]
    mpart2 = ds.MESH_PLANES.get([(("idx", s), list(r.segments))
                                 for s, r in enumerate(new_readers)],
                                "postings", "body", device="cpu")
    assert mpart2 is not None and mpart2 is not mpart
    after = pe.mesh_wand_topk([_ctxs(PORT, r, mappers, q)
                               for r in new_readers], mpart2, "body",
                              clauses, 10, 10_000)
    assert after[0][0][1] > before[0][0][1]


def test_mesh_budget_refusal_counts_and_serves_none():
    """test_mesh_exec.py:497 on the port: an over-budget mesh plane is
    refused before upload, the refusal memoized, and the same key builds
    once the budget is back."""
    engines = _engines(PORT, 13, 2)
    readers = [e.acquire_reader() for e in engines]
    shard_segments = [(("idx", s), list(r.segments))
                      for s, r in enumerate(readers)]
    old = BREAKERS.breaker("device").limit
    try:
        BREAKERS.configure(device=1)
        assert ds.MESH_PLANES.get(shard_segments, "postings", "body",
                                  device="cpu") is None
        misses = ds.MESH_PLANES.stats["mesh_plane_miss_fallbacks"]
        assert misses >= 1
        assert ds.MESH_PLANES.get(shard_segments, "postings", "body",
                                  device="cpu") is None
        assert ds.MESH_PLANES.stats["mesh_plane_miss_fallbacks"] > misses
    finally:
        BREAKERS.configure(device=old)
    assert ds.MESH_PLANES.get(shard_segments, "postings", "body",
                              device="cpu") is not None


@pytest.mark.parametrize("kind", ["vectors", "features"])
def test_unported_mesh_kinds_raise(kind):
    """The vectors kind (the kNN mesh) stacks two shards' vector planes as
    [S, N_pad, D] slots, and the features kind (the sparse mesh) their
    rank_features blocks as [S, NB, 128] slots; neither raises
    NotPortedError any more. The name dates from when they did."""
    engines = []
    for s in range(2):
        eng = InternalEngine(MapperService({"properties": {
            "vec": {"type": "dense_vector", "dims": 4,
                    "similarity": "cosine"},
            "feats": {"type": "rank_features"}}}), shard_label=f"uk{s}")
        for i in range(30 + 10 * s):
            eng.index(str(i), {"vec": [float(i % 5), 1.0, float(s), 2.0],
                               "feats": {"f1": 1.0 + i % 3}})
        eng.refresh()
        engines.append(eng)
    segs = [(("idx", s), list(e.acquire_reader().segments))
            for s, e in enumerate(engines)]
    field = "vec" if kind == "vectors" else "feats"
    part = ds.MESH_PLANES.get(segs, kind, field, device="cpu")
    if kind == "features":
        assert part is not None and part.kind == "features"
        nb = part.block_docs.shape[1]
        assert tuple(part.block_weights.shape) == (2, nb, 128)
        assert [int((part.block_docs[s] >= 0).sum()) for s in range(2)] \
            == [30, 40]
        return
    assert part is not None and part.kind == "vectors"
    assert tuple(part.matrix.shape) == (2, part.n_docs_pad, 4)
    assert [int(part.exists[s].sum()) for s in range(2)] == [30, 40]


# ---------------------------------------------------------------------------
# the served path: a port node against a reference node, and against itself
# ---------------------------------------------------------------------------

from elasticsearch_tpu.rest.controller import RestRequest as RefRequest  # noqa: E402,E501
from elasticsearch_tpu.rest.routes import build_controller as ref_controller  # noqa: E402,E501
from elasticsearch_tpu.testing import InProcessCluster as RefCluster  # noqa: E402,E501
from elasticsearch_tpu_torch.rest.controller import RestRequest  # noqa: E402
from elasticsearch_tpu_torch.rest.routes import build_controller  # noqa: E402
from elasticsearch_tpu_torch.testing import InProcessCluster  # noqa: E402
from test_torch_node import bulk_lines, same  # noqa: E402

NODE_MAPPINGS = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "vec": {"type": "dense_vector", "dims": 8, "similarity": "cosine"},
    "feats": {"type": "rank_features"}}}


def node_docs(seed: int, n: int, base: int = 0):
    rng = np.random.default_rng(seed)
    return [(f"d{base + i}", {
        "body": " ".join(rng.choice(VOCAB, size=int(rng.integers(4, 12)))),
        "tag": f"t{i % 3}",
        "vec": [round(float(x), 4) for x in rng.standard_normal(8)],
        "feats": {f"f{int(j)}": round(float(rng.random() + 0.1), 3)
                  for j in rng.integers(0, 12, 3)}}) for i in range(n)]


TEXT_BODIES = [
    ("match", {"query": {"match": {"body": "w1 w3 w7"}}, "size": 8}),
    ("match_totals_false", {"query": {"match": {"body": "w2 w4"}},
                            "size": 5, "track_total_hits": False}),
    ("match_totals_7", {"query": {"match": {"body": "w2 w4"}}, "size": 5,
                        "track_total_hits": 7}),
    ("match_totals_true", {"query": {"match": {"body": "w5 w9"}},
                           "track_total_hits": True}),
    ("bool_should", {"query": {"bool": {"should": [
        {"match": {"body": "w1 w2"}},
        {"match": {"body": {"query": "w8", "boost": 2.0}}}]}}, "size": 6}),
    ("no_hits", {"query": {"match": {"body": "zzyzx"}}}),
    ("from", {"query": {"match": {"body": "w6 w0"}}, "from": 3, "size": 4}),
]
# the bodies a mesh serves (exact totals take the dense collector, and a
# term no shard holds is skipped by can-match)
MESH_SERVED = ("match", "match_totals_false", "match_totals_7",
               "bool_should", "from")
OTHER_BODIES = [
    ("knn", {"query": {"knn": {"field": "vec", "k": 6, "query_vector":
                               [0.3, -1.2, 0.5, 0.0, 1.1, -0.4, 0.2, 0.9]}},
             "size": 6}),
    ("text_expansion", {"query": {"text_expansion": {"feats": {
        "tokens": {"f1": 1.2, "f4": 0.7}}}}, "size": 7}),
]

class RestCaller:
    """One cluster's REST controller, called request by request."""

    def __init__(self, cluster, controller, request_cls):
        self.cluster = cluster
        self.controller = controller
        self.request_cls = request_cls

    def __call__(self, method, path, body=None, query=None):
        raw = b""
        if isinstance(body, list):
            raw = ("\n".join(json.dumps(x) for x in body) + "\n"
                   ).encode("utf-8")
            body = None
        out = []
        self.controller.dispatch(
            self.request_cls(method=method, path=path,
                             query=dict(query or {}), body=body,
                             raw_body=raw),
            lambda status, resp: out.append((status, resp)))
        self.cluster.run_until(lambda: bool(out), 120.0)
        return out[0]


_PAIRS = {}


def node_pair(shards: int):
    """(reference caller, port caller) with index ``m{shards}`` loaded
    the same way through ``_bulk``: two loads with a refresh between,
    deletes, and a warm-up search (the reference's mesh never pays its
    backend's first-init)."""
    if shards not in _PAIRS:
        ref = RefCluster(n_nodes=1, seed=29)
        port = InProcessCluster(n_nodes=1, seed=29, device="cpu")
        callers = []
        for c, ctl, req in ((ref, ref_controller, RefRequest),
                            (port, build_controller, RestRequest)):
            c.start()
            drive = RestCaller(c, ctl(c.client()), req)
            index = f"m{shards}"
            steps = [
                ("PUT", f"/{index}", {"settings": {
                    "number_of_shards": shards, "number_of_replicas": 0},
                    "mappings": NODE_MAPPINGS}),
                ("POST", "/_bulk", bulk_lines(index, node_docs(1, 140))),
                ("POST", f"/{index}/_refresh", None),
                ("POST", "/_bulk", bulk_lines(
                    index, node_docs(2, 80, base=140),
                    deletes=[f"d{i}" for i in range(0, 220, 17)])),
                ("POST", f"/{index}/_refresh", None),
                ("POST", f"/{index}/_search",
                 {"query": {"match": {"body": "w0"}}, "size": 1})]
            for method, path, body in steps:
                status, resp = drive(method, path, body)
                assert status < 300, (path, status, resp)
            callers.append(drive)
        _PAIRS[shards] = tuple(callers)
    return _PAIRS[shards]


def _both(shards, body, query=None):
    ref, port = node_pair(shards)
    path = f"/m{shards}/_search"
    return (ref("POST", path, copy.deepcopy(body), query),
            port("POST", path, copy.deepcopy(body), query))


@pytest.mark.parametrize("search_type", [None, "dfs_query_then_fetch"],
                         ids=["query_then_fetch", "dfs"])
@pytest.mark.parametrize("name", [n for n, _ in TEXT_BODIES])
@pytest.mark.parametrize("shards", [2, 4], ids=["two_shards", "four_shards"])
def test_text_search_gives_the_reference_json(shards, name, search_type):
    """A text body on 2 and 4 shards: the port's JSON is the reference's,
    ``_data_plane`` (the mesh routing label) included."""
    body = dict(TEXT_BODIES)[name]
    query = {"search_type": search_type} if search_type else None
    (s_r, want), (s_p, got) = _both(shards, body, query)
    assert s_r == s_p == 200, (want, got)
    assert got.get("_data_plane") == want.get("_data_plane"), \
        (got.get("_data_plane"), want.get("_data_plane"))
    if name in MESH_SERVED:
        assert got["_data_plane"] == "mesh_plane"
    same(want, got)


@pytest.mark.parametrize("name", [n for n, _ in OTHER_BODIES])
@pytest.mark.parametrize("shards", [2, 4], ids=["two_shards", "four_shards"])
def test_knn_and_sparse_are_declined_with_the_reference_answers(shards,
                                                                name):
    """The kNN and sparse kinds: both packages' meshes serve them
    (``_data_plane: "mesh_plane"`` on both, nothing counted as not
    ported), with the same answer. The name dates from when the port
    declined them."""
    body = dict(OTHER_BODIES)[name]
    kind = "knn" if name == "knn" else "sparse"
    before = telemetry.TELEMETRY.not_ported.get(f"mesh_{kind}", 0)
    (s_r, want), (s_p, got) = _both(shards, body)
    assert s_r == s_p == 200, (want, got)
    assert got["_data_plane"] == want["_data_plane"] == "mesh_plane"
    assert telemetry.TELEMETRY.not_ported.get(f"mesh_{kind}", 0) == before
    same(want, got)


def test_text_after_deletes_and_a_refresh_gives_the_reference_json():
    """More writes between requests (new docs, deletes, a refresh) on
    both nodes; the mesh plane of the new segment sets answers as the
    reference's does."""
    ref, port = node_pair(4)
    for drive in (ref, port):
        for method, path, body in (
                ("POST", "/_bulk", bulk_lines(
                    "m4", node_docs(3, 30, base=400),
                    deletes=["d141", "d150", "d2"])),
                ("POST", "/m4/_refresh", None)):
            assert drive(method, path, body)[0] < 300
    for _name, body in TEXT_BODIES:
        (s_r, want), (s_p, got) = _both(4, body)
        assert s_r == s_p == 200
        assert got.get("_data_plane") == want.get("_data_plane")
        same(want, got)


def _port_node(shards: int):
    _ref, port = node_pair(shards)
    return port, next(iter(port.cluster.nodes.values()))


def _set_mesh(drive, enabled: bool) -> None:
    status, _ = drive("PUT", "/_cluster/settings", {
        "persistent": {"search.mesh.enabled": enabled}})
    assert status == 200


@pytest.mark.parametrize("case", ["bodies", "dfs", "can_match_skipped"])
def test_port_mesh_equals_its_own_fanout(case):
    """test_mesh_exec.py:422, :827 and :546 on the port: mesh-served JSON
    equals the same node's answers with ``search.mesh.enabled: false``
    (the RPC fan-out through the one-shard kernels), bitwise; a fan-out
    that can-match narrows to two of three shards still takes the mesh."""
    port, node = _port_node(4)
    index = "m4"
    query = None
    bodies = [body for n, body in TEXT_BODIES if n in MESH_SERVED]
    if case == "dfs":
        query = {"search_type": "dfs_query_then_fetch"}
    elif case == "can_match_skipped":
        index = "cm"
        status, _ = port("PUT", "/cm", {"settings": {
            "number_of_shards": 3, "number_of_replicas": 0},
            "mappings": NODE_MAPPINGS})
        assert status == 200
        from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for
        picked, i = {}, 0
        while set(picked) != {0, 1}:
            sid = shard_id_for(f"u{i}", 3)
            if sid in (0, 1) and sid not in picked:
                picked[sid] = f"u{i}"
            i += 1
        docs = [(did, {"body": "zzyzx w1"}) for did in picked.values()]
        docs += [(f"o{j}", {"body": "w1 w2"}) for j in range(12)]
        assert port("POST", "/_bulk", bulk_lines("cm", docs))[0] == 200
        assert port("POST", "/cm/_refresh")[0] == 200
        bodies = [{"query": {"match": {"body": "zzyzx"}}, "size": 5}]
    executor = node.search_transport.mesh_executor
    searches = executor.stats["mesh_searches"]
    meshed = []
    for body in bodies:
        status, resp = port("POST", f"/{index}/_search",
                            copy.deepcopy(body), query)
        assert status == 200 and resp.get("_data_plane") == "mesh_plane", \
            (body, resp)
        meshed.append(resp)
    assert executor.stats["mesh_searches"] == searches + len(bodies)
    if case == "can_match_skipped":
        assert meshed[0]["_shards"]["total"] == 3
        assert meshed[0]["_shards"]["skipped"] == 1
        assert len(meshed[0]["hits"]["hits"]) == 2
    _set_mesh(port, False)
    try:
        for body, m in zip(bodies, meshed):
            status, resp = port("POST", f"/{index}/_search",
                                copy.deepcopy(body), query)
            assert status == 200 and "_data_plane" not in resp
            a = {k: v for k, v in m.items() if k not in ("took",
                                                         "_data_plane")}
            b = {k: v for k, v in resp.items() if k != "took"}
            assert json.dumps(a, sort_keys=True) == \
                json.dumps(b, sort_keys=True), body
    finally:
        _set_mesh(port, True)
    stats = node.local_node_stats()["mesh_plane"]
    assert stats["mesh_plane_builds"] >= 1
    assert stats["device_dispatches"] >= 1


def test_mesh_drain_memo_dedups_identical_members():
    """test_mesh_exec.py:457 on the port: identical members submitted in
    one tick pay one execution; every duplicate gets the same answer as a
    fresh solo mesh search."""
    port, node = _port_node(4)
    ex = node.search_transport.mesh_executor
    client = port.cluster.client()
    body = {"query": {"match": {"body": "w1 w3"}}, "size": 6}
    memo = ex.stats["memo_hits"]
    boxes = []
    for _ in range(4):
        box = []
        client.search("m4", copy.deepcopy(body),
                      lambda resp, err=None, box=box: box.append(
                          (resp, err)))
        boxes.append(box)
    port.cluster.run_until(lambda: all(boxes), 120.0)
    resps = []
    for box in boxes:
        resp, err = box[0]
        assert err is None and resp.get("_data_plane") == "mesh_plane"
        resps.append({k: v for k, v in resp.items() if k != "took"})
    assert ex.stats["memo_hits"] >= memo + 3
    for resp in resps[1:]:
        assert json.dumps(resp, sort_keys=True) == \
            json.dumps(resps[0], sort_keys=True)
    status, solo = port("POST", "/m4/_search", copy.deepcopy(body))
    assert status == 200 and solo["hits"] == resps[0]["hits"]


def test_mesh_miss_falls_back_with_the_same_answer(monkeypatch):
    """test_mesh_exec.py:517 on the port: a drain-time miss (the plane
    refused between submit and drain) serves the per-shard fan-out with
    the same answer, counted in ``mesh_fallbacks``."""
    port, node = _port_node(4)
    body = {"query": {"match": {"body": "w1 w3"}}, "size": 8}
    status, resp = port("POST", "/m4/_search", copy.deepcopy(body))
    assert status == 200 and resp.get("_data_plane") == "mesh_plane"
    fallbacks = node.search_transport.mesh_executor.stats["mesh_fallbacks"]
    monkeypatch.setattr(ds.MESH_PLANES, "get", lambda *a, **kw: None)
    status, resp2 = port("POST", "/m4/_search", copy.deepcopy(body))
    assert status == 200 and "_data_plane" not in resp2
    a = {k: v for k, v in resp.items() if k not in ("took", "_data_plane")}
    b = {k: v for k, v in resp2.items() if k != "took"}
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert node.search_transport.mesh_executor.stats["mesh_fallbacks"] \
        == fallbacks + 1


def test_mesh_requires_an_active_local_copy():
    """test_mesh_exec.py:588 on the port: a target whose active copies
    exclude this node is not mesh-eligible."""
    _port, node = _port_node(4)
    ex = node.search_transport.mesh_executor
    targets = [{"index": "m4", "shard": s, "node": node.node_id,
                "copies": [node.node_id]} for s in range(4)]
    body = {"query": {"match": {"body": "w1"}}, "size": 5}
    assert ex.try_submit("m4", targets, body, 5, None, lambda r: None)
    targets[1]["copies"] = ["other-node"]
    assert not ex.try_submit("m4", targets, body, 5, None, lambda r: None)


def test_warmup_initializes_the_card_once(monkeypatch):
    """``search.mesh.warmup_at_boot`` pays CUDA first-init through
    ``MESH_PLANES.warmup``: counted once on a card node whose CUDA is not
    up yet, a no-op on a CPU node or once CUDA is up."""
    inits = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: bool(inits))
    monkeypatch.setattr(torch.cuda, "init", lambda: inits.append(1))
    warm = ds.MESH_PLANES.stats["mesh_plane_warmups"]
    assert not ds.MESH_PLANES.warmup("cpu")
    assert ds.MESH_PLANES.warmup("cuda")
    assert not ds.MESH_PLANES.warmup("cuda")
    assert inits == [1]
    assert ds.MESH_PLANES.stats["mesh_plane_warmups"] == warm + 1
    assert ds.MESH_PLANES.available(2, "cuda")
    assert not ds.MESH_PLANES.available(1, "cuda")


def test_a_totals_disabled_bound_across_nodes_is_held_to_its_range(
        monkeypatch):
    """ROADMAP queue 3, item 2: two port nodes on one corpus, the text
    tier engaged on one and stood down on the other (as a card node's
    measured-latency rule may stand it down where a CPU node keeps it):
    every ``track_total_hits: false`` answer of ``chip_smoke.py``'s
    mesh-engine mix has the same hits on both, and each lower bound lies
    in [len(hits), the exact count] -- the check ``same_or_bounded``
    that the card's mesh-engine phase makes; bounds that differ inside
    that range pass it, one outside it does not."""
    import chip_smoke as cs
    docs = cs.mesh_engine_docs(np, 3000, cs.SEED + 813, 0)
    nodes = []
    for seed in (5, 6):
        c = InProcessCluster(n_nodes=1, seed=seed, device="cpu")
        c.start()
        node = cs.RestNode(c)
        node.ok("PUT", "/mesh", {"settings": {
            "number_of_shards": 4, "number_of_replicas": 0},
            "mappings": cs.MESH_MAPPINGS})
        node.ok("POST", "/_bulk", raw=cs.bulk_ndjson("mesh", docs))
        node.ok("POST", "/mesh/_refresh")
        nodes.append(node)
    bodies = [b for b in cs.mesh_engine_bodies(np)
              if b[3] == "text" and b[1].get("track_total_hits") is False]
    assert bodies
    coarse = DEVICE_PROFILE.family("mesh_bm25_coarse")
    try:
        for name, body, query, _kind in bodies:
            c0 = coarse.calls
            monkeypatch.setattr(ds.PLANES, "quantized_engaged",
                                lambda cls: True)
            on = nodes[0].ok("POST", "/mesh/_search", body, query)
            c1 = coarse.calls
            monkeypatch.setattr(ds.PLANES, "quantized_engaged",
                                lambda cls: False)
            off = nodes[1].ok("POST", "/mesh/_search", body, query)
            assert c1 > c0 and coarse.calls == c1, name
            assert on["_data_plane"] == off["_data_plane"] == "mesh_plane"
            exact = nodes[0].ok("POST", "/mesh/_count",
                                {"query": body["query"]})["count"]
            assert cs.same_or_bounded(body, on, off, exact) is None, name
            wide = copy.deepcopy(off)
            wide["hits"]["total"]["value"] = exact
            assert cs.same_or_bounded(body, on, wide, exact) is None
            wide["hits"]["total"]["value"] = exact + 1
            assert cs.same_or_bounded(body, on, wide, exact) is not None
            wide["hits"]["total"]["value"] = len(off["hits"]["hits"]) - 1
            assert cs.same_or_bounded(body, on, wide, exact) is not None
    finally:
        for node in nodes:
            node.cluster.stop()
