#!/usr/bin/env python3
"""Drive the PyTorch build (elasticsearch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any failed check:

1. card: the card's name and power limit (nvidia-smi), and the kernels'
   build from ``elasticsearch_tpu_torch/csrc`` (nvcc, one process per
   source, all started together).
2. small: each BM25 kernel family (bm25_flat counted and not,
   bm25_flat_seg, bm25_coarse, bm25_rerank) against its plain PyTorch
   version on the card, on seeded random inputs at a small and a chunked
   shape: ids, counts and scores must be bitwise equal (the fixed-point
   design makes them so).
3. knn-small: the kNN kernels (knn_flat, knn_coarse, knn_rerank) against
   their plain versions on seeded Gaussian inputs: three similarities,
   B in {1, 8, 64}, D in {128, 960}, k' up to 1024, dead docs, missing
   vectors, duplicate rows and a zero query row; bitwise equal.
4. engine: ``InternalEngine`` + ``SearchService`` with one text field,
   10,000 seeded Zipf(1.35) documents over 30,000 words, several
   segments, a few deletes; 32 match bodies at track_total_hits default,
   false and 5 must give the same response on the card as the same
   package on ``device="cpu"`` (ids, totals, relation and max_score equal,
   scores to rtol 1e-6).
5. full: one shard at MS MARCO passage scale (8,841,823 documents in 4
   segments, 16-96 tokens, Zipf(1.35) term ids folded onto a 1,000,000-
   term vocabulary; synthetic and seeded), served through ``query_shard``
   (64 solo queries, quantized tier on) and ``batched_wand_topk_shard``
   (the 64 as one batch on the exact path, with totals counted and with
   totals off). Prints the plane's resident bytes and per-leg latency.
   Launch counts are zeroed before phases 4-5 and read right after: every
   BM25 family must have launched. Then each family is held against its
   plain version and timed (CUDA events) on inputs captured from the
   main path.
6. knn-engine: ``InternalEngine`` + ``SearchService`` on 20,000 seeded
   docs with one 128-dim Gaussian vector each, mapped under the three
   similarities, four segments, a few deletes; 32 knn bodies over planes
   on and off and the quantized tier on and off must give the same
   response on the card as on ``device="cpu"``, score bits included.
7. knn-full: one shard at SIFT1M's shape (1,000,000 docs x 128 dims,
   integers in [0, 255], clustered and seeded; 4 segments of 250,000;
   cosine, ``index_options.type: flat``), 64 held-out queries, k 10,
   num_candidates 100, in four legs: (a) 64 solo ``query_shard`` calls,
   tier on; (b) one ``batched_knn_shard`` of the 64, tier on; (c) the
   same with the tier off (exact plane, knn_flat); (d) the same with no
   plane (per-segment knn_flat). All legs must agree in ids and score
   bits, and recall@10 against a float64 exact oracle must be >= 0.95.
   Launch counts are zeroed before phases 6-7 and read right after: every
   kNN family must have launched (knn_coarse and knn_rerank in leg (a),
   knn_flat in legs (c) and (d)). Then each family is held against its
   plain version and timed at its largest main-path call.
8. dense-small (run with the small phases): the dense collector's
   kernels bm25_scores (K8), knn_scores (K9) and dense_topk (K10) against
   their plain versions on seeded calls (K8 up to 65,536 blocks and QB
   16,384; K9 at D 5/128/960 under the three similarities; K10 at k
   1/10/4096 over rows of 128 to 4,194,304 docs, all -inf rows and
   equal-score rows, which must come back in index order), and
   bm25_topk / knn_topk through K1 / K5 at one query, against their plain
   versions and against K8 / K9 followed by K10; all bitwise.
9. dense-engine: the text and vector engines above (both mappings carry
   a keyword ``tag`` and an integer ``n``) through the dense collector:
   exact totals, bool with filters and must_not, should with
   minimum_should_match, multi_match, the phrase pair, dis_max,
   constant_score, boosting, match_all, field sorts with missing values
   and search_after, min_score, _count, terminate_after, script_score
   with the three vector functions, knn inside bool: every response equal
   on the card and the CPU, score bits included.
10. dense-full: the shards of phases 5 and 7 again, through the dense
   collector: (a) the 64 MS MARCO queries as solo match with
   track_total_hits true -- ids and score bits equal to phase 5's exact
   batch leg, totals equal to a host count; (b) BASELINE #2 in its
   script_score form, 64 solo cosineSimilarity bodies over match_all --
   ids equal to phase 7's exact-plane leg, recall@10 >= 0.95. Each query
   must launch 4 K8 + 4 K10 in (a), 4 K9 + 4 K10 in (b), and nothing of
   K1-K7. Launch counts are zeroed before phases 9-10 and read right
   after; then each dense family is held against its plain version and
   timed (K10 at both shards' row lengths), beside its library yardstick.
11. ivf-small (run with the small phases): the masked K5-K7 against
   their plain versions (shared and per-query masks, an all-False row,
   pow2 padding rows) and, row by row, against the unmasked kernels on
   allowed & mask; K11-K14 against their plain versions (tied rows and
   centroids, dropped and empty clusters, padded lists, nprobe up to
   nlist, clamped k, three similarities); all bitwise.
12. ivf-engine: filtered knn (term, range, bool) on the vector engine and
   knn on IVF-mapped fields (index_options type ivf, nlist 16) of a
   6,000-doc engine, planes on and off, deletes after the build, a
   refresh that warm-starts k-means, batches mixing filtered and
   unfiltered members: every answer equal on the card and the CPU.
13. ivf-full: BASELINE #3's shape, bench.py cfg_ivf's GIST1M envelope
   (1,048,576 x 960 f32, 1,024 Gaussian means, 0.35 noise, made on the
   card from a seed) in 4 segments of 262,144, cosine, no index_options
   (the default IVF route), 128 queries, k 10, num_candidates swept so
   the derived nprobe is 16..256, on the plane (one shard-level IVF,
   nlist 4,096) and per segment (four, nlist 2,048): recall@10 against a
   float64 oracle, solo p50/p99, 64-query batch time, kernel-busy share,
   launches per leg, build time and resident bytes. The IVF must be
   built (not breaker-refused), ivf_search must serve and knn_flat must
   not launch in the sweep, and each route must reach recall@10 0.95 at
   some nprobe (the first is printed; so is the exact K5 answers'
   recall, the ceiling the bf16 arithmetic leaves). Then filtered
   kNN on the knn-full SIFT shard (a keyword tag; 10 % and 1 %
   selectivity; one shared mask and 64 distinct masks; quantized tier on
   and off): every answer equal to a host filtered exact oracle.
   Launch counts are zeroed before phases 12-13 and read right after:
   K11-K14 and the masked K5-K7 must have launched; then each is held
   against its plain version and timed at its largest main-path call.
14. sparse-small (run with the small phases): K15 sparse_flat (the four
   rank_feature functions, counted and not, pow2 padding rows), K19
   sparse_scores (with and without a live mask), K16 sparse_coarse and
   K17 sparse_rerank at 3,000 and 200,000 docs with tied docs, and K18
   text_expansion_forward (the default model's widths at B 1, 13, 64; a
   ragged narrow model) against their plain versions: bitwise for linear,
   saturation, K16 and K17; log and sigmoid within 2^-21 relative and K18
   within 2^-20 absolute (logf / powf / tanhf against torch's), ids exact.
15. sparse-engine: 3,000 seeded texts indexed through ``InternalEngine``
   with the port model's expansions as rank_features (three segments, 20
   deletes): text_expansion with model_text and with tokens, the four
   rank_feature functions, bool with a filter, exact and limited totals,
   planes on and off, the quantized tier on and off, and _count: every
   response equal on the card and the CPU, score bits included.
16. sparse-full: BASELINE #5 at MS MARCO passage scale in bench.py
   cfg_sparse's form: 8,841,823 docs in 4 segments, 16-23 features a doc
   drawn Zipf(1.35) over the default model's 8,192 features, weights
   uniform in [0, 3), from the seed; 64 raw texts of 3-7 words sent as
   text_expansion with model_text, the rewrite running K18 at the
   model's full width. Legs: solo with the tier on (K18 at B 1, K16 +
   K17), a 64-query batch on the exact plane (K18 at B 64, K15) and per
   segment (K15 per segment), solo dense with exact totals (K19 + K10).
   All legs agree in ids and score bits, totals equal a host count, and
   the top-10 equals a float64 host oracle up to near-ties. Launch counts
   are zeroed before phases 15-16 and read right after: K15-K19 must have
   launched; then each is held against its plain version and timed at its
   largest main-path call, and K18 also on cache misses at B 64 and 4,096.
   The earlier phases' shards are freed first.

17. wide-small (run with the small phases): the wide selection (rounds
   of at most 4,096 after a cursor) through K10 at k 4,096 to 12,289,
   row by row, against a stable sort, with equal scores and -inf slots;
   bitwise.
18. aggs-small (run with the small phases): K20-K23 (the aggregation
   kernels) against their plain versions on seeded columns: negative
   values, buckets dropped at both ends, -1 padded and out-of-range
   ordinals, an interval-0 plan, bucket sums past 2^24 (added in row
   order by both); bitwise.
19. wide: windows of 10,000 on the full and knn-full shards, per segment:
   a match (K1 with the rounds), the same match with exact totals (the
   dense collector: K8 + K10 with the rounds) and a knn with k 10,000 (K5
   with the rounds); the first 4,096 hits equal the 4,096 window's, the
   dense window equals K1's, the first 10 the earlier exact answers.
   Launch counts are zeroed before and read after: bm25_flat, knn_flat
   and dense_topk must have launched; then each is held against its plain
   version and timed at its k 10,000 call (its own row in the kernels
   line, with the wide path's launches).
20. aggs-engine: a geonames-shaped InternalEngine (3,000 docs, three
   segments, deletes): 17 agg bodies (terms, the dem histogram with
   min/max/avg, stats, cardinality, percentiles, range, filters,
   country_agg_uncached) and a 13-member plan_drain_aggs: every response
   and preset equal on the card and the CPU.
21. aggs-full: the geonames-shaped shard (Rally's geonames track over the
   GeoNames allCountries dump, 11,396,503 docs, cut to a quarter by
   default to fit the time limit -- ``--geo-docs 11396503`` runs all of
   it -- in
   4 segments, made from the seed): 64 solo SearchService requests with a terms on
   country_code and a histogram on dem with min/max/avg subs (K20 and K21
   per segment), then plan_drain_aggs over the same 64 members (K22 and
   K23 on the columns plane, P 64) feeding ShardAggregator(preset=...);
   country_agg_uncached once. Checks, for every fourth member: counts
   against a host count, dem sums against the row-order oracle on both
   paths; for every member: plane equal to per segment in keys, counts,
   mins and maxs. Launch counts are zeroed before
   phases 20-21 and read after: K20-K23 must have launched; then each is
   held against its plain version and timed at its largest call.

22. node-engine: two port nodes, ``InProcessCluster(n_nodes=1)`` on the
   card and on the CPU (the CPU one in a worker process, loading and
   answering while this process drives the card node), each get 3,000
   seeded docs (text, a 768-dim ``dense_vector``, ``rank_features``)
   through ``POST /_bulk`` and about 40 bodies through their REST
   controllers (``match`` with totals true / false / 7, deletes,
   ``_msearch``, ``_count``, exact and filtered ``knn``,
   ``text_expansion`` with tokens, terms + histogram aggs, ``rank.rrf``
   with 2 and 3 retrievers): every answer equal apart from ``took``,
   floats to rtol 1e-6.
23. hybrid-full: BASELINE #4 (bench.py cfg_hybrid) on the BEIR NQ shape:
   2,681,468 passages (cut to a quarter by default to fit the time limit
   -- ``--nq-docs 2681468`` runs all of them) of 1 + Poisson(77.88)
   Zipf(1.35) words over 1,000,000 terms and 768-dim cosine vectors
   (``index_options: flat``), one shard on a card node: ``PUT /nq``,
   2,500 docs through ``_bulk``, the rest as 4 generated segments
   installed with
   ``restore_segments`` (the snapshot-restore entry); 64 hybrid bodies
   (``match`` of 7-11 words + ``knn`` k 100 + ``rank.rrf`` window 100)
   solo (p50/p99) and as one concurrent wave (wall): each answer equal to
   a host RRF over its two legs' own REST answers, the fuser's batches
   > 0 with an occupancy above 1 in the wave and no host fallback.
   Launch counts are zeroed before phases 22-23 and read after:
   rrf_fuse_batch (K24) must have launched; then K24 (also as rrf_fuse, at
   R 2 over a 4,194,304-doc id space with its unscored tail) and K25
   linear_fuse (R 2, N_pad 4,194,304, k 10 and 10,000), which no request
   calls in either package, are held bitwise against their plain versions
   and timed.

24. mesh-small (run with the small phases): the mesh kernels
   mesh_bm25_flat, mesh_bm25_coarse and mesh_bm25_rerank (rows 31-33)
   against their plain versions, and slot by slot against K2 / K3 / K4
   launched on that slot's plane, at S 2 and 4 (an empty slot, a
   one-segment slot, two dp rows, a chunked plane); bitwise.
25. mesh-engine: a card node and a CPU node (in a worker process) on an
   index of 4 shards, 6,000 seeded docs through ``_bulk``: match at
   totals default / true / false / 7, bool of should-matches and
   dfs_query_then_fetch, a round of writes (new docs, deletes, a
   refresh), the bodies again; also knn bodies and text_expansion bodies
   (tokens with a boost and totals true / false / 100, and model_text).
   Every answer equal on the two nodes (``_data_plane`` included; a
   model_text body only where the card's and the CPU's rewrites agree;
   a totals-disabled bound, which each node's own tier decisions set,
   held to len(hits) <= bound <= the exact count instead); the card
   node's mesh-served answers equal its own with
   ``search.mesh.enabled: false``; ``mesh_searches`` grows, the knn and
   text_expansion bodies are mesh-served and nothing is counted as not
   ported.
26. mesh-full: phase 5's MS MARCO corpus (its four generated segments,
   reused) as the 4 primary shards of one card node, each doc under an
   _id that routes to its shard as ``_bulk`` would route it (the i-th doc
   of segment c gets the i-th integer whose murmur3 route is shard c),
   installed with ``restore_segments``; 64
   solo match bodies with the tier on, the 64 with it off, the 64 as one
   wave, each answer equal to the same node's per-shard fan-out
   (``search.mesh.enabled: false``). The mesh legs must launch all three
   mesh families and no K1-K4, with no budget refusal or mesh fallback.
   Launch counts are zeroed before phases 25-26 and read after; then rows
   31-33 are held against their plain versions and timed.
27. mesh-knn-small (run with the small phases): the mesh kNN kernels
   mesh_knn_topk, mesh_knn_coarse and mesh_knn_rerank (rows 39, 36, 37)
   against their plain versions, and slot by slot against K5 / K6 / K7
   launched on that slot's plane, at S 2 and 4 (an empty slot), masked and
   unmasked, the three similarities, chunked planes, mesh_knn_topk at k 10
   and 5,000; bitwise.
28. mesh-knn-engine: a card node and a CPU node (in a worker process) on
   an index of 4 shards, 3,000 seeded docs (128-dim cosine vectors, a
   keyword tag, words, rank_features) through ``_bulk``: knn at k 10 and
   100, term-filtered knn, two differently filtered knn as one wave (the
   masked launches), hybrid rank.rrf and text_expansion bodies, a round of
   writes (new docs, deletes, a refresh), the bodies again. Every answer
   equal on the two nodes; the card node's mesh-served answers equal its
   own with ``search.mesh.enabled: false``; ``mesh_searches`` grows for the
   knn and text_expansion bodies, and nothing is counted as not ported.
29. mesh-knn-full: BASELINE #2's SIFT1M shape (phase 7's generator and
   seeds, 1,000,000 x 128, cosine, no index_options) as the 4 primary
   shards of one card node, each doc under an _id that routes to its
   shard, each shard 4 segments of 62,500 docs (under the 65,536-doc ANN
   threshold) installed with ``restore_segments``, a 100-value keyword
   ``tag``; through the REST controller 64 solo knn bodies (k 10,
   num_candidates 100) with the tier on, the 64 with it off, the 64 as one
   wave, 64 bodies filtered by one of 8 tag terms, solo and as one wave;
   recall@10 against a float64 oracle; each answer equal to the same
   node's per-shard fan-out (``search.mesh.enabled: false``, K5-K7). The
   mesh legs must launch all three mesh kNN families (the masked form in
   the filtered wave) and no K5-K7, with no IVF-routed fallback, budget
   refusal or mesh fallback. Launch counts are zeroed before phases 28-29
   and read after; then rows 36, 37 and 39 are held against their plain
   versions and timed.
30. mesh-sparse-small (run with the small phases): the mesh sparse
   kernels mesh_sparse_topk, mesh_sparse_coarse and mesh_sparse_rerank
   (rows 38, 34, 35) against their plain versions, and slot by slot
   against K15 / K16 / K17 launched on that slot's plane, at S 2 and 4 (an
   empty slot, two dp rows, chunked planes, tied docs), mesh_sparse_topk
   at k 10 and 5,000 and k' up to 4,096; bitwise.
31. mesh-sparse-full: BASELINE #5's MS MARCO rank_features shape (phase
   16's four segments, reused, or built from the same seeds) as the 4
   primary shards of one card node, each doc under an _id that routes to
   its shard, installed with ``restore_segments``; through the REST
   controller 64 solo text_expansion bodies in tokens form (phase 16's
   texts, expanded once) with the tier on, the 64 with it off, the 64 as
   one wave, and 16 solo model_text bodies; each answer equal to the same
   node's per-shard fan-out (``search.mesh.enabled: false``, K15-K17),
   every top-10 to a float64 oracle up to near-ties, totals to a host
   count. The mesh legs must launch all three mesh sparse families and no
   K15-K17, with no budget refusal, drain error or mesh fallback. Launch
   counts are zeroed before phase 31 and read after; then rows 34, 35 and
   38 are held against their plain versions and timed.

32. sharded-small (run with the small phases): the sharded data plane's
   kernels (rows 40-44: sharded_knn, sharded_bm25, sharded_bm25_batch,
   sharded_sparse, sharded_hybrid) against their plain versions at S 2,
   4 and 8 (the last across two selection chunks): the three
   similarities, Q 1 and 16, counted and not, k 10 and past the whole
   slot space, queries matching nothing, l2 at zero and near-zero
   distances, fused branches whose ids overlap and a branch of -1 ids;
   bitwise.
33. sharded-engine: a card node and a CPU node (in a worker process), both
   ``mesh_data_plane=True``, on a 4-shard index of 2,000 seeded docs:
   match (totals default / false / 3), bool of should-matches, knn under
   the three similarities and text_expansion tokens bodies, a round of
   writes (new docs, deletes, a refresh), the bodies again: every answer
   served by the data plane (``_data_plane: "mesh"``) with the same JSON
   on both nodes, scores bitwise, and the same build and WAND pruning
   counters.
34. sharded-full: the segments of mesh-full (MS MARCO) and
   mesh-sparse-full (BASELINE #5's rank_features) as one index's body and
   ml fields (the two corpora have the same size, so the same routed
   _ids), and mesh-knn-full's (SIFT1M) as another, installed with
   ``restore_segments`` into one card node with
   ``mesh_data_plane=True`` (no new host build), its data plane cutting
   each index into 4 slots (``SHARDED_SLOTS``); per kind the first
   request (the sharded copy's build) and the rest of its 64 bodies
   solo, each served by the data plane, launching its sharded family and
   no K1-K7, K15-K17 or mesh_* family; match answers held to mesh-full's
   node answering the first 8 with ``dfs_query_then_fetch`` (a DFS
   request costs that node 2 s; ids outside near-ties,
   scores to rtol 1e-5, totals equal), knn to a float64 oracle
   (recall@10) and to mesh-knn-full's exact answers, text_expansion to
   mesh-sparse-full's exact answers. Launch counts are zeroed before
   phases 33-34 and read after; then rows 40, 42 and 43 are held against
   their plain versions on the main path's calls and timed, row 41 on an
   MS MARCO query of the sharded copy and row 44 on seeded operands at
   BEIR NQ's width (D 768) -- neither has a served caller.

The two largest host builds (the MS MARCO and BEIR NQ postings) start in
one worker pool when the script starts, at the lowest CPU priority, so
they run while the phases before them use the card and take no core
those phases ask for; mesh-full and mesh-sparse-full reuse the segments
of full and sparse-full, and build them themselves, in a pool of their
own, only when run without those phases. Prints a ``{"kernels": [...]}`` line and, last,
the ``{"ok": true, ...}`` line. Exits non-zero, without the ok line, when there is no CUDA card,
when the package is missing, or on any failure. ``--rehearse`` runs the
same phases on the CPU at a small size (plain versions only) and never
prints the ok line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

SEED = 20261017
MS_MARCO_DOCS = 8_841_823
VOCAB = 1_000_000
SIFT_DOCS = 1_000_000
SIFT_DIMS = 128
FAMILIES = ("bm25_flat", "bm25_flat_seg", "bm25_coarse", "bm25_rerank")
KNN_FAMILIES = ("knn_flat", "knn_coarse", "knn_rerank")
REPLACES = {
    "bm25_flat": "elasticsearch_tpu/ops/bm25.py:261",
    "bm25_flat_seg": "elasticsearch_tpu/ops/bm25.py:299",
    "bm25_coarse": "elasticsearch_tpu/ops/bm25.py:235",
    "bm25_rerank": "elasticsearch_tpu/ops/bm25.py:248",
    "knn_flat": "elasticsearch_tpu/ops/knn.py:101",
    "knn_coarse": "elasticsearch_tpu/ops/knn.py:184",
    "knn_rerank": "elasticsearch_tpu/ops/knn.py:261",
    "bm25_scores": "elasticsearch_tpu/ops/bm25.py:45",
    "knn_scores": "elasticsearch_tpu/ops/knn.py:33",
    "dense_topk": "elasticsearch_tpu/search/phase.py:806",
    "knn_flat_masked": "elasticsearch_tpu/ops/knn.py:113",
    "knn_coarse_masked": "elasticsearch_tpu/ops/knn.py:199",
    "knn_rerank_masked": "elasticsearch_tpu/ops/knn.py:274",
    "ivf_assign": "elasticsearch_tpu/ops/ivf.py:37",
    "ivf_update": "elasticsearch_tpu/ops/ivf.py:74",
    "ivf_init": "elasticsearch_tpu/ops/ivf.py:85",
    "ivf_search": "elasticsearch_tpu/ops/ivf.py:328",
    "sparse_flat": "elasticsearch_tpu/ops/sparse.py:72",
    "sparse_scores": "elasticsearch_tpu/ops/sparse.py:42",
    "sparse_coarse": "elasticsearch_tpu/ops/sparse.py:184",
    "sparse_rerank": "elasticsearch_tpu/ops/sparse.py:193",
    "text_expansion_forward": "elasticsearch_tpu/ml/text_expansion.py:111",
    "aggs_ordinal_counts": "elasticsearch_tpu/ops/aggs.py:30",
    "aggs_histogram": "elasticsearch_tpu/ops/aggs.py:42",
    "aggs_ordinal_counts_plane": "elasticsearch_tpu/ops/aggs.py:90",
    "aggs_histogram_plane": "elasticsearch_tpu/ops/aggs.py:112",
    "mesh_bm25_flat": "elasticsearch_tpu/parallel/mesh.py:245",
    "mesh_bm25_coarse": "elasticsearch_tpu/parallel/mesh.py:297",
    "mesh_bm25_rerank": "elasticsearch_tpu/parallel/mesh.py:335",
    "mesh_knn_topk": "elasticsearch_tpu/parallel/mesh.py:564",
    "mesh_knn_coarse": "elasticsearch_tpu/parallel/mesh.py:433",
    "mesh_knn_rerank": "elasticsearch_tpu/parallel/mesh.py:479",
    "mesh_sparse_topk": "elasticsearch_tpu/parallel/mesh.py:523",
    "mesh_sparse_coarse": "elasticsearch_tpu/parallel/mesh.py:373",
    "mesh_sparse_rerank": "elasticsearch_tpu/parallel/mesh.py:403",
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------

def phase_card(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {os.cpu_count()} host cores, "
        f"torch intra-op threads {torch.get_num_threads()}")
    from elasticsearch_tpu_torch import _build
    t0 = time.monotonic()
    _build.build_all()
    log(f"build: {time.monotonic() - t0:.2f}s "
        f"(built={_build.BUILD_INFO['built']}, dir={_build.BUILD_INFO['dir']})")
    for fam, report in sorted(_build.BUILD_INFO.get("ptxas", {}).items()):
        for line in report.splitlines():
            if "Used" in line or "error" in line or "spill" in line:
                log(f"ptxas {fam}: {line.strip()}")


# ---------------------------------------------------------------------------
# kernel inputs and comparisons
# ---------------------------------------------------------------------------

def random_store(np, rng, n_docs: int, nb: int):
    """A seeded block store: doc ids ascending within blocks, -1 padding,
    tfs 1..6, doc lengths 16..96."""
    docs = np.sort(rng.integers(0, n_docs, (nb, 128)), axis=1).astype(np.int32)
    docs[rng.random((nb, 128)) < 0.1] = -1
    tfs = np.where(docs >= 0, rng.integers(1, 7, (nb, 128)), 0)
    n_pad = 1 << max(7, math.ceil(math.log2(max(n_docs, 2))))
    dl = np.zeros(n_pad, np.float32)
    dl[:n_docs] = rng.integers(16, 97, n_docs)
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) > 0.05
    seg = np.minimum(np.arange(n_pad) * 3 // max(n_docs, 1), 2).astype(np.int32)
    return docs, tfs.astype(np.float32), dl, live, seg, n_pad


def random_flat(np, rng, nb: int, n_real_q: int, per_q: int):
    """Flat (idx, w, qid, avgdl) rows for n_real_q queries of per_q blocks,
    padded the way flatten_plans pads (block 0, weight 0, query 0)."""
    from elasticsearch_tpu_torch.ops.bm25 import qb_bucket
    n = n_real_q * per_q
    fb = qb_bucket(n)
    idx = np.zeros(fb, np.int32)
    w = np.zeros(fb, np.float32)
    q = np.zeros(fb, np.int32)
    avg = np.full(fb, 50.0, np.float32)
    idx[:n] = rng.integers(0, nb, n)
    w[:n] = rng.uniform(0.2, 9.0, n)
    q[:n] = np.repeat(np.arange(n_real_q), per_q)
    avg[:n] = rng.uniform(40.0, 60.0, n)
    return idx, w, q, avg


def compare(torch, name: str, got, want, exact_scores: bool = True,
            rtol: float = 1e-6):
    """Kernel outputs vs plain outputs: ints bitwise, floats bitwise (or
    within ``rtol`` when ``exact_scores`` is False). Returns max |diff| of
    the float outputs (finite entries)."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} output {i}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.dtype.is_floating_point:
            fin = torch.isfinite(w)
            check(torch.equal(torch.isfinite(g), fin),
                  f"{name} output {i}: -inf slots differ")
            if fin.any():
                d = (g[fin].double() - w[fin].double()).abs()
                err = max(err, float(d.max()))
                if exact_scores:
                    check(torch.equal(g[fin], w[fin]),
                          f"{name} output {i}: scores differ (max {err})")
                else:
                    check(bool((d <= rtol * w[fin].double().abs()).all()),
                          f"{name} output {i}: scores beyond rtol {rtol}")
        else:
            check(torch.equal(g, w), f"{name} output {i}: ints differ")
    return err


def run_family(bm, family: str, args, kwargs, plain: bool):
    fn = getattr(bm, family + "_plain" if plain else family)
    return fn(*args, **kwargs)


def phase_small(torch, np, dev) -> None:
    from elasticsearch_tpu_torch.ops import bm25 as bm
    rng = np.random.default_rng(SEED)
    for n_docs, nb, n_q, per_q, kprime in ((3000, 64, 4, 12, 64),
                                           (200_000, 4096, 8, 300, 256)):
        docs, tfs, dl, live, seg, n_pad = random_store(np, rng, n_docs, nb)
        idx, w, q, avg = random_flat(np, rng, nb, n_q, per_q)
        T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        bd, bt, dlt, lv, sg = T(docs), T(tfs), T(dl), T(live), T(seg)
        fi, fw, fq, fa = T(idx), T(w), T(q), T(avg)
        bt16, dl16 = bt.to(torch.bfloat16), dlt.to(torch.bfloat16)
        cases = [
            ("bm25_flat", (bd, bt, fi, fw, fq, dlt, fa, lv, n_pad, n_q, 10),
             {"counted": False}),
            ("bm25_flat", (bd, bt, fi, fw, fq, dlt, fa, lv, n_pad, n_q, 10),
             {"counted": True}),
            ("bm25_flat_seg", (bd, bt, fi, fw, fq, dlt, fa, lv, sg, n_pad,
                               n_q, 10), {"n_segs": 3}),
            ("bm25_coarse", (bd, bt16, fi, fw, fq, dl16, fa, lv, sg, n_pad,
                             n_q, 3, kprime), {}),
        ]
        for family, args, kwargs in cases:
            got = run_family(bm, family, args, kwargs, plain=False)
            want = run_family(bm, family, args, kwargs, plain=True)
            torch.cuda.synchronize()
            compare(torch, family, got, want)
            if family == "bm25_coarse":
                cs, cand = want[0], want[1]
        rr = (bd, bt, fi, fw, fq, dlt, fa, lv, cand, cs, n_pad, n_q, kprime,
              10)
        got = run_family(bm, "bm25_rerank", rr, {}, plain=False)
        want = run_family(bm, "bm25_rerank", rr, {}, plain=True)
        torch.cuda.synchronize()
        compare(torch, "bm25_rerank", got, want)
        # the exact tier re-derives K1's scores for the same docs
        s1, d1, _ = bm.bm25_flat(bd, bt, fi, fw, fq, dlt, fa, lv, n_pad,
                                 n_q, kprime, counted=True)
        s4, d4, _ = got
        for r in range(n_q):
            exact = dict(zip(d1[r].tolist(), s1[r].tolist()))
            for sc, d in zip(s4[r].tolist(), d4[r].tolist()):
                if math.isfinite(sc) and d in exact:
                    check(exact[d] == sc, "bm25_rerank score != bm25_flat")
        log(f"small: n_docs_pad={n_pad} fb={len(idx)} n_q={n_q}: all four "
            f"families bitwise equal to their plain versions")


# ---------------------------------------------------------------------------
# phase 3: engine path
# ---------------------------------------------------------------------------

def zipf_terms(np, rng, n: int, vocab: int):
    return (rng.zipf(1.35, n) - 1) % vocab


def build_text_engine(np, n_docs: int):
    """``InternalEngine`` with ``n_docs`` seeded docs: a text field of
    Zipf(1.35) words over 30,000, a keyword ``tag`` (7 values) and an
    integer ``n`` (missing on every ninth doc); three segments, 25
    deletes. Returns (engine, words, rng)."""
    from elasticsearch_tpu_torch.index import InternalEngine
    from elasticsearch_tpu_torch.mapping import MapperService
    rng = np.random.default_rng(SEED + 3)
    words = np.array([f"w{i}" for i in range(30_000)])
    engine = InternalEngine(MapperService({"properties": {
        "body": {"type": "text"}, "tag": {"type": "keyword"},
        "n": {"type": "integer"}}}), shard_label="smoke")
    t0 = time.monotonic()
    lens = rng.integers(16, 97, n_docs)
    nums = rng.integers(0, 1000, n_docs)
    cuts = {n_docs // 3, 2 * n_docs // 3}
    for i in range(n_docs):
        doc = {"body": " ".join(
            words[zipf_terms(np, rng, int(lens[i]), 30_000)]),
            "tag": f"t{i % 7}"}
        if i % 9:
            doc["n"] = int(nums[i])
        engine.index(str(i), doc)
        if i in cuts:
            engine.refresh()
    engine.refresh()
    for i in rng.choice(n_docs, 25, replace=False):
        engine.delete(str(int(i)))
    engine.refresh()
    reader = engine.acquire_reader()
    log(f"engine: {n_docs} docs in {len(reader.segments)} segments, "
        f"indexed in {time.monotonic() - t0:.1f}s")
    check(len(reader.segments) >= 2, "engine: fewer than 2 segments")
    return engine, words, rng


def phase_engine(torch, np, dev, built) -> None:
    from elasticsearch_tpu_torch.search import SearchService
    engine, words, rng = built
    on_dev = SearchService(engine, index_name="smoke", device=dev)
    on_cpu = SearchService(engine, index_name="smoke", device="cpu")
    bodies = []
    for _ in range(32):
        terms = zipf_terms(np, rng, int(rng.integers(2, 7)), 30_000)
        bodies.append(" ".join(words[terms]))
    n = 0
    t_dev = []
    for text in bodies:
        for track in (None, False, 5):
            body = {"query": {"match": {"body": text}}, "size": 10}
            if track is not None:
                body["track_total_hits"] = track
            t1 = time.monotonic()
            a = on_dev.search(body)
            t_dev.append(time.monotonic() - t1)
            b = on_cpu.search(body)
            ha, hb = a["hits"], b["hits"]
            check([h["_id"] for h in ha["hits"]]
                  == [h["_id"] for h in hb["hits"]],
                  f"engine: ids differ for {body}")
            check(ha["total"] == hb["total"], f"engine: totals differ {body}")
            check(ha["max_score"] == hb["max_score"],
                  f"engine: max_score differs {body}")
            for x, y in zip(ha["hits"], hb["hits"]):
                check(math.isfinite(x["_score"]) and abs(
                    x["_score"] - y["_score"]) <= 1e-6 * abs(y["_score"]),
                    f"engine: scores differ {body}")
            n += 1
    t_dev.sort()
    log(f"engine: {n} responses equal on {dev} and cpu; {dev} latency "
        f"p50 {1e3 * t_dev[len(t_dev) // 2]:.2f} ms "
        f"p99 {1e3 * t_dev[min(len(t_dev) - 1, int(0.99 * len(t_dev)))]:.2f} ms")


# ---------------------------------------------------------------------------
# phase 4: full size
# ---------------------------------------------------------------------------

def segment_tokens(args):
    """One MS MARCO segment's tokens (run in a worker process): each doc's
    own 16..96 tokens drawn Zipf(1.35) and folded onto the vocabulary.
    Returns (lens [n], tokens int32 [sum(lens)]) in doc order: the valid
    entries, row by row, of the token matrix the postings are built from
    (``postings_on_card``)."""
    seed, n = args
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 97, n)
    toks = rng.zipf(1.35, int(lens.sum())) - 1
    return lens, np.where(toks < VOCAB, toks, toks % VOCAB).astype(np.int32)


def postings_on_card(torch, np, lens, toks, dev):
    """``postings_from_token_matrix`` (index/segment.py) of the token
    matrix whose row i holds the next ``lens[i]`` of ``toks`` (all >= 0),
    its sorts and scatters run on ``dev``: the same arrays, bit for bit,
    since every step is integer arithmetic or a count. On the host those
    sorts took the start-up pool minutes and could slow the phases beside
    it (``Prebuilt``)."""
    from elasticsearch_tpu_torch.index.segment import BLOCK, PostingsField
    n_docs = len(lens)
    t = torch.as_tensor(toks, device=dev).to(torch.int64)
    d = torch.repeat_interleave(
        torch.arange(n_docs, device=dev),
        torch.as_tensor(lens, device=dev).to(torch.int64))
    uniq, counts = torch.unique(t * n_docs + d, sorted=True,
                                return_counts=True)
    del d
    n_terms = max(int(t.max()) + 1 if t.numel() else 0, 1)
    del t
    u_term = uniq // n_docs
    u_doc = (uniq % n_docs).to(torch.int32)
    del uniq
    term_ids, per_term = torch.unique_consecutive(u_term,
                                                  return_counts=True)
    doc_freq = torch.zeros(n_terms, dtype=torch.int32, device=dev)
    doc_freq[term_ids] = per_term.to(torch.int32)
    nb = torch.zeros(n_terms, dtype=torch.int64, device=dev)
    nb[term_ids] = (per_term + BLOCK - 1) // BLOCK
    nb.clamp_min_(1)                      # every term >= 1 block
    start = torch.zeros(n_terms, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(nb, 0)[:-1]
    n_blocks = int(nb.sum())
    first = torch.cumsum(per_term, 0) - per_term
    within = torch.arange(len(u_term), device=dev) - torch.repeat_interleave(
        first, per_term)
    flat = start[u_term] * BLOCK + within
    del within, u_term
    block_docs = torch.full((n_blocks * BLOCK,), -1, dtype=torch.int32,
                            device=dev)
    block_tfs = torch.zeros(n_blocks * BLOCK, dtype=torch.float32,
                            device=dev)
    block_docs[flat] = u_doc
    block_tfs[flat] = counts.to(torch.float32)
    block_tfs = block_tfs.view(n_blocks, BLOCK)
    block_term = torch.repeat_interleave(
        torch.arange(n_terms, device=dev, dtype=torch.int32), nb)
    doc_lens = np.asarray(lens).astype(np.float32)
    return PostingsField(
        terms={f"t{i}": i for i in range(n_terms)},
        block_docs=block_docs.view(n_blocks, BLOCK).cpu().numpy(),
        block_tfs=block_tfs.cpu().numpy(),
        block_term=block_term.cpu().numpy(),
        block_max_tf=block_tfs.max(dim=1).values.cpu().numpy(),
        term_block_start=start.to(torch.int32).cpu().numpy(),
        term_block_count=nb.to(torch.int32).cpu().numpy(),
        doc_freq=doc_freq.cpu().numpy(),
        doc_lens=doc_lens,
        sum_doc_len=float(doc_lens.sum()))


def check_postings_on_card(torch, np, dev) -> None:
    """``postings_on_card`` against the host builder on a seeded stream
    (a term in many blocks, terms with no posting below the largest):
    every array bitwise equal."""
    from elasticsearch_tpu_torch.index.segment import (
        postings_from_token_matrix,
    )
    lens, toks = segment_tokens((SEED + 99, 3000))
    toks = toks % 5000
    toks[::7] = 17
    mat = np.full((len(lens), 96), -1, np.int32)
    mat[np.arange(96)[None, :] < lens[:, None]] = toks
    want = postings_from_token_matrix(mat)
    got = postings_on_card(torch, np, lens, toks, dev)
    check(got.terms == want.terms and got.sum_doc_len == want.sum_doc_len,
          "postings_on_card: terms or sum_doc_len differ")
    for name in ("block_docs", "block_tfs", "block_term", "block_max_tf",
                 "term_block_start", "term_block_count", "doc_freq",
                 "doc_lens"):
        a, b = getattr(got, name), getattr(want, name)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"postings_on_card: {name} differs from the host builder")


def four_segments(n_docs: int):
    return [n_docs // 4 + (1 if i < n_docs % 4 else 0) for i in range(4)]


def full_jobs(n_docs: int):
    return [(SEED + 100 + i, n) for i, n in enumerate(four_segments(n_docs))]


def _background_worker() -> None:
    """Pool initializer: the build runs at the lowest CPU priority, so
    that a phase measured beside it keeps the cores it asks for."""
    os.nice(19)


class Prebuilt:
    """The token streams of the two largest shard builds -- the MS MARCO
    and the BEIR NQ corpora, drawn from the seed alone -- started in one
    spawn pool when the script starts (MS MARCO's jobs first), so that
    they run while the phases before them use the card; the postings are
    then built on the card (``postings_on_card``). ``builds`` maps a name
    to (worker function, jobs); ``take`` waits for one build's results
    and logs when they were ready, how long it waited and their size.

    The workers run at the lowest CPU priority (``_background_worker``)
    and only draw tokens. While they also built the postings on the host,
    its sorts slowed the phases beside them on a loaded host (ivf-small
    99.1 s against 5.5 s alone, with 2 workers as with 4) and the drawing
    slowed nothing; on an idle host neither did
    (``tests/measure_build_pool.py``, H100 machines, 8 host cores)."""

    def __init__(self, workers: int, builds):
        import multiprocessing as mp
        self.t0 = time.monotonic()
        self.ready = {}
        self.pool = mp.get_context("spawn").Pool(
            workers, initializer=_background_worker)
        self.pending = {
            name: self.pool.map_async(
                fn, jobs, callback=lambda _r, _n=name: self.ready.setdefault(
                    _n, time.monotonic() - self.t0))
            for name, (fn, jobs) in builds.items()}

    def take(self, name: str):
        pending = self.pending.pop(name, None)
        if pending is None:
            return None
        t = time.monotonic()
        out = pending.get()
        n_bytes = sum(int(a.nbytes) for stream in out for a in stream)
        log(f"prebuilt {name}: ready {self.ready.get(name, 0.0):.1f}s after "
            f"the pool started; waited {time.monotonic() - t:.1f}s; "
            f"{n_bytes} bytes handed back")
        return out

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


def build_full_shard(torch, np, dev, n_docs: int, workers: int,
                     streams=None):
    """The MS MARCO shard's 4 segments: the token streams (from
    ``streams``, the build pool's, or made here) turned into postings on
    ``dev``."""
    import multiprocessing as mp
    from elasticsearch_tpu_torch.index.segment import Segment
    sizes = four_segments(n_docs)
    jobs = full_jobs(n_docs)
    if streams is None and workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            streams = pool.map(segment_tokens, jobs)
    elif streams is None:
        streams = [segment_tokens(j) for j in jobs]
    check_postings_on_card(torch, np, dev)
    segs = []
    for i, ((lens, toks), n) in enumerate(zip(streams, sizes)):
        seg = Segment(f"msmarco{i}", n)
        seg.postings["body"] = postings_on_card(torch, np, lens, toks, dev)
        seg.ids = [str(j) for j in range(n)]
        seg.invalidate_live_count()
        segs.append(seg)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return segs


class Recorder:
    """Keeps the arguments of the main path's kernel calls (recording is
    not a launch) so the families can be held against their plain
    versions on the same inputs afterwards: the first ``keep`` calls of
    each family, and its largest call by ``size(family, args)`` -- one
    per ``group(family, args)`` when a grouping is given (e.g. one per
    row length). ``targets`` maps each family to the (module, function
    name) of its wrapper; ``accept(family, args, kwargs)`` may skip calls
    (the unmasked calls of a wrapper recorded as its masked variant)."""

    def __init__(self, targets, size, keep: int, group=None, accept=None):
        self.targets = targets
        self.families = tuple(targets)
        self.size = size
        self.keep = keep
        self.group = group or (lambda fam, args: None)
        self.accept = accept or (lambda fam, args, kwargs: True)
        self.first = {f: [] for f in self.families}
        self.largest = {}       # (family, group) -> call
        self._orig = {}

    @property
    def calls(self):
        return {f: self.first[f] + self.largest_calls(f)
                for f in self.families}

    def largest_calls(self, fam: str):
        """The largest call of each group, in first-seen order."""
        return [c for (f, _g), c in self.largest.items() if f == fam]

    def _record(self, fam: str, args, kwargs) -> None:
        call = (args, dict(kwargs))
        if len(self.first[fam]) < self.keep:
            self.first[fam].append(call)
        key = (fam, self.group(fam, args))
        big = self.largest.get(key)
        if big is None or self.size(fam, args) > self.size(fam, big[0]):
            self.largest[key] = call

    def __enter__(self):
        for fam, (module, name) in self.targets.items():
            orig = getattr(module, name)
            self._orig[fam] = (module, name, orig)

            def wrapped(*args, _fam=fam, _orig=orig, **kwargs):
                if args[0].is_cuda and self.accept(_fam, args, kwargs):
                    self._record(_fam, args, kwargs)
                return _orig(*args, **kwargs)
            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, orig in self._orig.values():
            setattr(module, name, orig)


def device_ms(families=FAMILIES):
    """Per family, the device milliseconds of every timed launch so far
    (DEVICE_PROFILE.timing brackets each launch with CUDA events)."""
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    return {f: DEVICE_PROFILE.family(f).resolve_events() for f in families}


def pct(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def phase_full(torch, np, dev, n_docs: int, workers: int, n_q: int,
               shared, prebuilt=None):
    from elasticsearch_tpu_torch.index.engine import Reader
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ops import bm25 as bm
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batch_executor import (
        _build_ctxs, batched_wand_topk_shard,
    )
    from elasticsearch_tpu_torch.search.phase import (
        query_shard, shard_term_stats,
    )

    t0 = time.monotonic()
    segs = build_full_shard(torch, np, dev, n_docs, workers,
                            prebuilt.take("full") if prebuilt else None)
    n_blocks = sum(s.postings["body"].block_docs.shape[0] for s in segs)
    log(f"full: {n_docs} docs in {len(segs)} segments, {n_blocks} posting "
        f"blocks, built in {time.monotonic() - t0:.1f}s")
    mappers = MapperService({"properties": {"body": {"type": "text"}}})
    reader = Reader(segs)
    PLANES.clear()
    t1 = time.monotonic()
    part = PLANES.get(segs, "postings", "body", dev)
    check(part is not None, "full: the postings plane was refused")
    mirror = part.quantized_mirror()
    check(mirror is not None, "full: the bf16 mirror was refused")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"full: plane n_docs_pad={part.n_docs_pad} n_blocks_pad="
        f"{part.block_docs.shape[0]} resident bytes {part.nbytes} "
        f"(block_docs+block_tfs+doc_lens, bf16 mirror); "
        f"torch.cuda.memory_allocated="
        f"{torch.cuda.memory_allocated() if dev.type == 'cuda' else 0}; "
        f"built+uploaded in {time.monotonic() - t1:.1f}s")

    rng = np.random.default_rng(SEED + 7)
    queries = []
    for _ in range(n_q):
        ids = np.minimum(rng.zipf(1.35, int(rng.integers(2, 7))) - 1,
                         VOCAB - 1)
        queries.append(" ".join(f"t{i}" for i in ids))
    legs = {}
    # one untimed query first: it pays the per-segment block bound tables
    # (PostingsField.block_max_impact), built once per segment and field
    query_shard(reader, mappers, dsl.Match(field="body", text=queries[0]),
                size=10, device=dev)
    stats0 = dict(PLANES.stats)
    hist0 = dict(PLANES.rerank_depth_hist)
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    DEVICE_PROFILE.timing = dev.type == "cuda"
    dev_ms = {"start": device_ms()}
    solo = []
    for text in queries:
        t = time.monotonic()
        res = query_shard(reader, mappers,
                          dsl.Match(field="body", text=text), size=10,
                          device=dev)
        solo.append((res, time.monotonic() - t))
    legs["solo_quantized"] = [t for _r, t in solo]
    dev_ms["solo_quantized"] = device_ms()
    delta = {k: PLANES.stats[k] - stats0[k]
             for k in ("quantized_queries", "rerank_escalations",
                       "quantized_exact_fallbacks")}
    log(f"full: solo leg: {n_q} queries, quantized tier served "
        f"{delta['quantized_queries']}, rerank escalations "
        f"{delta['rerank_escalations']}, exact fallbacks "
        f"{delta['quantized_exact_fallbacks']}, served depths "
        f"{ {d: n - hist0.get(d, 0) for d, n in PLANES.rerank_depth_hist.items() if n > hist0.get(d, 0)} }")

    # the batch legs: the same 64 queries as ONE batch on the exact path
    doc_count, dfs = shard_term_stats(reader, mappers, dsl.Bool(
        should=[dsl.Match(field="body", text=t) for t in queries]))
    ctxs = _build_ctxs(reader, mappers, doc_count, dfs, device=dev)
    clause_lists = [[(t, 1.0)] for t in queries]
    PLANES.quantized = False
    batch = {}
    try:
        for leg, limit in (("batch_exact", 10_000),
                           ("batch_exact_totals_off", 0)):
            times = []
            for _rep in range(3):
                t = time.monotonic()
                out = batched_wand_topk_shard(ctxs, "body", clause_lists, 10,
                                              limit)
                times.append(time.monotonic() - t)
            batch[leg] = out
            legs[leg] = times
            dev_ms[leg] = device_ms()
    finally:
        PLANES.quantized = True
        DEVICE_PROFILE.timing = False
    # the quantized tier serves the exact path's results
    for qi, (res, _t) in enumerate(solo):
        cands, hits, rel, max_score, _prune = batch["batch_exact"][qi]
        check([(d.segment_idx, d.doc) for d in res.docs]
              == [(d.segment_idx, d.doc) for d in cands[:10]],
              f"full: query {qi}: solo quantized ids != batch exact ids")
        check([d.score for d in res.docs] == [d.score for d in cands[:10]],
              f"full: query {qi}: solo quantized scores != batch exact")
        check(res.total_hits == hits and res.total_relation == rel,
              f"full: query {qi}: totals differ")
        for d in res.docs:
            check(math.isfinite(d.score) and d.score > 0,
                  f"full: query {qi}: bad score {d.score}")
    shared["msmarco"] = (segs, mappers, queries, [
        [(d.segment_idx, d.doc, d.score) for d in c[:10]]
        for c, *_ in batch["batch_exact"]])
    prev = dev_ms["start"]
    for leg, times in legs.items():
        per_q = [t / n_q for t in times] if leg.startswith("batch") else times
        kern = {f: round(dev_ms[leg][f] - prev[f], 3) for f in FAMILIES}
        prev = dev_ms[leg]
        busy = sum(kern.values()) / max(1e3 * sum(times), 1e-9)
        log(f"full: leg {leg}: wall p50 {1e3 * pct(times, 0.5):.3f} ms "
            f"p99 {1e3 * pct(times, 0.99):.3f} ms; per query p50 "
            f"{1e3 * pct(per_q, 0.5):.3f} ms p99 {1e3 * pct(per_q, 0.99):.3f}"
            f" ms over {len(times)} runs; wall total "
            f"{1e3 * sum(times):.1f} ms, kernel device ms {kern}, "
            f"kernel-busy share {busy:.4f}")


def time_call(torch, fn, runs: int) -> float:
    """Median milliseconds of ``runs`` calls after one warm-up, each
    bracketed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    ms.sort()
    return ms[len(ms) // 2]


# positions of n_docs_pad and n_q in each wrapper's arguments
ARG_POS = {"bm25_flat": (8, 9), "bm25_flat_seg": (9, 10),
           "bm25_coarse": (9, 10), "bm25_rerank": (10, 11)}


def n_docs_pad_of(family: str, args) -> int:
    return args[ARG_POS[family][0]]


def n_q_of(family: str, args) -> int:
    return args[ARG_POS[family][1]]


def bm25_size(family: str, args):
    """(queries, gathered blocks) of a BM25 kernel call."""
    return n_q_of(family, args), args[2].numel()


def bound_of(family: str, args, kwargs):
    """(bound_ms, bytes, ops): the least time the card could take — the
    bytes the function must move (gathered blocks, flat rows, the doc
    lengths of gathered postings, the live mask and segment ids, the
    outputs) over the memory rate, or its arithmetic over the peak rate
    for its type, whichever is larger."""
    block_tfs, flat_idx = args[1], args[2]
    n_docs_pad = n_docs_pad_of(family, args)
    fb = flat_idx.numel()
    postings = fb * 128
    tf_bytes = block_tfs.element_size()
    nbytes = postings * (4 + tf_bytes)                 # gathered docs + tfs
    nbytes += fb * 16                                  # idx, w, q, avgdl
    nbytes += min(postings, n_docs_pad) * (2 if family == "bm25_coarse"
                                           else 4)     # doc lengths
    nbytes += n_docs_pad                               # live mask
    if family in ("bm25_flat_seg", "bm25_coarse"):
        nbytes += n_docs_pad * 4                       # seg_ids
    if family == "bm25_rerank":
        n_q, kprime, k = args[11], args[12], args[13]
        nbytes += n_q * kprime * 8 + n_q * k * 8 + n_q * 4
    elif family == "bm25_flat":
        n_q, k = args[9], args[10]
        nbytes += n_q * k * 8 + n_q * 4
    elif family == "bm25_flat_seg":
        n_q, k = args[10], args[11]
        nbytes += n_q * k * 8 + n_q * kwargs.get("n_segs", 1) * 4
    else:
        n_q, n_segs, kp = args[10], args[11], args[12]
        nbytes += n_q * kp * 8 + n_q * n_segs * 4
    ops = postings * 8          # 3 mul, 2 add, 2 div and a compare a posting
    peak = BF16_FLOPS if family == "bm25_coarse" else F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def plain_bytes(family: str, args) -> int:
    """Rough peak device bytes of the plain version's temporaries: about
    48 a gathered posting, and about 40 a cell of its [n_q, n_docs_pad]
    plane (int64 sums, f32 scores, the stable sort's keys, int64 indices
    and scratch)."""
    fb = args[2].numel()
    plane = 0 if family == "bm25_rerank" else n_q_of(family, args) * \
        n_docs_pad_of(family, args) * 40
    return fb * 128 * 48 + plane


def phase_kernels(torch, rec, launches) -> list:
    from elasticsearch_tpu_torch.ops import bm25 as bm
    rows = []
    for fam in FAMILIES:
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        torch.cuda.empty_cache()
        room = 0.85 * torch.cuda.mem_get_info()[0]
        fit = [c for c in calls if plain_bytes(fam, c[0]) < room]
        check(bool(fit), f"kernels: no {fam} call's plain version fits in "
              f"{room / 1e9:.1f} GB")
        # correctness on up to 8 of the main path's calls (for the solo
        # leg's families: 8 queries), timing on the largest
        err = 0.0
        for args, kwargs in fit[:8]:
            got = run_family(bm, fam, args, kwargs, plain=False)
            want = run_family(bm, fam, args, kwargs, plain=True)
            torch.cuda.synchronize()
            err = max(err, compare(torch, fam, got, want))
            del got, want
        args, kwargs = max(fit, key=lambda c: c[0][2].numel())
        ms = time_call(torch, lambda: run_family(bm, fam, args, kwargs,
                                                 False), 20)
        probe = time_call(torch, lambda: run_family(bm, fam, args, kwargs,
                                                    True), 1)
        plain_runs = 20 if probe < 250 else 5
        plain_ms = time_call(torch, lambda: run_family(bm, fam, args, kwargs,
                                                       True), plain_runs)
        bound_ms, bound_by, nbytes = bound_of(fam, args, kwargs)
        shape = (f"fb={args[2].numel()} n_docs_pad={n_docs_pad_of(fam, args)}"
                 f" n_q={n_q_of(fam, args)} kwargs={kwargs}")
        log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain {plain_ms:.4f}"
            f" ms (median of {plain_runs}), bound {bound_ms:.4f} ms "
            f"({nbytes} bytes at 3.35 TB/s), max_abs_err {err} over "
            f"{min(len(fit), 8)} main-path calls, timed at {shape}")
        big_args, big_kwargs = max(
            calls, key=lambda c: (n_q_of(fam, c[0]), c[0][2].numel()))
        if big_args is not args:
            big_ms = time_call(torch, lambda: run_family(
                bm, fam, big_args, big_kwargs, False), 20)
            log(f"kernel {fam}: {big_ms:.4f} ms (median of 20) at the "
                f"largest main-path call, fb={big_args[2].numel()} "
                f"n_q={n_q_of(fam, big_args)}, bound "
                f"{bound_of(fam, big_args, big_kwargs)[0]:.4f} ms "
                f"(plain version not run: too large for the card)")
        rows.append({
            "name": fam, "route": "cuda",
            "source": f"elasticsearch_tpu_torch/csrc/{fam}.cu",
            "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape})
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# kNN: kernels against their plain versions, the engine path, SIFT1M shape
# ---------------------------------------------------------------------------

def knn_inputs(np, rng, n_docs: int, n_pad: int, dims: int, n_q: int):
    """Seeded Gaussian kNN inputs: ~10 % missing vectors and deleted docs,
    three duplicates of row 5 (score ties), an all-zero last query row."""
    m = rng.standard_normal((n_pad, dims), dtype=np.float32)
    q = rng.standard_normal((n_q, dims), dtype=np.float32)
    exists = np.zeros(n_pad, bool)
    exists[:n_docs] = rng.random(n_docs) > 0.1
    m[~exists] = 0.0
    for dup in (11, 17, 40):
        m[dup] = m[5]
        exists[dup] = exists[5] = True
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) > 0.1
    live[[5, 11, 17, 40]] = True
    norms = np.linalg.norm(m, axis=1).astype(np.float32)
    q[-1] = 0.0
    return m, norms, exists, live, q


def phase_knn_small(torch, np, dev) -> None:
    """K5, K6 and K7 against their plain versions on the card: three
    similarities, B in {1, 8, 64}, D in {128, 960}, k' up to 1024, over
    enough docs that the chunked top-k merges (bitwise equal)."""
    from elasticsearch_tpu_torch.ops import knn
    from elasticsearch_tpu_torch.ops.device_segment import quantize_rows
    rng = np.random.default_rng(SEED + 11)
    n = 0
    for dims, n_docs, n_pad in ((128, 200_000, 262_144),
                                (960, 100_000, 131_072)):
        m, norms, exists, live, _q = knn_inputs(np, rng, n_docs, n_pad,
                                                dims, 1)
        q8, scales = quantize_rows(m)
        T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        mt, nt, allowed = T(m), T(norms), T(live & exists)
        q8t, st = T(q8), T(scales)
        del m, q8
        for n_q in (1, 8, 64):
            q = rng.standard_normal((n_q, dims), dtype=np.float32)
            q[-1] = 0.0
            batch = knn.QueryBatch(q, dev)
            qq, qscale = batch.quantized()
            for sim in ("cosine", "dot_product", "l2_norm"):
                args = (mt, nt, allowed, batch.queries, batch.qn, batch.q2)
                got = knn.knn_flat(*args, 100, sim)
                want = knn.knn_flat_plain(*args, 100, sim)
                torch.cuda.synchronize()
                compare(torch, f"knn_flat D={dims} B={n_q} {sim}", got, want)
                kprime = 1024 if n_q == 1 else 256
                cargs = (q8t, st, nt, allowed, qq, qscale, batch.qn,
                         batch.q2)
                got = knn.knn_coarse(*cargs, kprime, sim)
                want = knn.knn_coarse_plain(*cargs, kprime, sim)
                torch.cuda.synchronize()
                compare(torch, f"knn_coarse D={dims} B={n_q} {sim}", got,
                        want)
                cs, cand = want
                got = knn.knn_rerank(*args, cand, cs, 10, sim)
                want = knn.knn_rerank_plain(*args, cand, cs, 10, sim)
                torch.cuda.synchronize()
                compare(torch, f"knn_rerank D={dims} B={n_q} {sim}", got,
                        want)
                n += 3
        del mt, q8t
        torch.cuda.empty_cache()
    log(f"knn-small: {n} kernel calls (knn_flat, knn_coarse, knn_rerank; "
        f"3 similarities, B 1/8/64, D 128/960, k' up to 1024) bitwise equal "
        f"to their plain versions")


KNN_FIELDS = {"cosine": "vec_cos", "dot_product": "vec_dot",
              "l2_norm": "vec_l2"}


def build_vector_engine(np, n_docs: int):
    """``InternalEngine`` with 20,000 seeded docs: one Gaussian 128-dim
    vector mapped under the three similarities, a keyword ``tag`` (5
    values) and an integer ``n`` (missing on every ninth doc); four
    segments, 20 deletes. Returns (engine, rng)."""
    from elasticsearch_tpu_torch.index import InternalEngine
    from elasticsearch_tpu_torch.mapping import MapperService
    rng = np.random.default_rng(SEED + 13)
    props = {f: {"type": "dense_vector", "dims": 128, "similarity": sim}
             for sim, f in KNN_FIELDS.items()}
    props.update({"tag": {"type": "keyword"}, "n": {"type": "integer"}})
    engine = InternalEngine(MapperService({"properties": props}),
                            shard_label="smoke-knn")
    t0 = time.monotonic()
    vecs = rng.standard_normal((n_docs, 128), dtype=np.float32)
    nums = rng.integers(0, 1000, n_docs)
    cuts = {n_docs // 4, n_docs // 2, 3 * n_docs // 4}
    for i in range(n_docs):
        v = vecs[i].tolist()
        doc = {f: v for f in KNN_FIELDS.values()}
        doc["tag"] = f"t{i % 5}"
        if i % 9:
            doc["n"] = int(nums[i])
        engine.index(str(i), doc)
        if i in cuts:
            engine.refresh()
    engine.refresh()
    for i in rng.choice(n_docs, 20, replace=False):
        engine.delete(str(int(i)))
    engine.refresh()
    n_segs = len(engine.acquire_reader().segments)
    log(f"knn-engine: {n_docs} docs in {n_segs} segments, indexed in "
        f"{time.monotonic() - t0:.1f}s")
    check(n_segs >= 2, "knn-engine: fewer than 2 segments")
    return engine, rng


def phase_knn_engine(torch, np, dev, built) -> None:
    """InternalEngine + SearchService with one 128-dim vector per doc,
    mapped under the three similarities; 32 knn bodies over planes on and
    off and the quantized tier on and off must give the same response on
    the card as on the CPU (ids, totals, max_score and score bits)."""
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import SearchService
    engine, rng = built
    on_dev = SearchService(engine, index_name="smoke", device=dev)
    on_cpu = SearchService(engine, index_name="smoke", device="cpu")
    sims = list(KNN_FIELDS)
    keep = (PLANES.enabled, PLANES.quantized)
    served0 = PLANES.stats["quantized_queries"]
    t_dev = []
    try:
        for i in range(32):
            sim = sims[i % 3]
            PLANES.enabled = (i // 3) % 2 == 0
            PLANES.quantized = (i // 6) % 2 == 0
            q = rng.standard_normal(128, dtype=np.float32).tolist()
            k = (10, 25)[i % 2]
            body = {"query": {"knn": {"field": KNN_FIELDS[sim],
                                      "query_vector": q, "k": k,
                                      "num_candidates": 100}},
                    "size": 10, "from": 5 if k == 25 else 0,
                    "_source": False}
            t1 = time.monotonic()
            a = on_dev.search(body)
            t_dev.append(time.monotonic() - t1)
            b = on_cpu.search(body)
            ha, hb = a["hits"], b["hits"]
            check([h["_id"] for h in ha["hits"]]
                  == [h["_id"] for h in hb["hits"]],
                  f"knn-engine: ids differ (body {i}, {sim})")
            check([h["_score"] for h in ha["hits"]]
                  == [h["_score"] for h in hb["hits"]],
                  f"knn-engine: scores differ (body {i}, {sim})")
            check(ha["total"] == hb["total"] and
                  ha["max_score"] == hb["max_score"],
                  f"knn-engine: totals or max_score differ (body {i})")
            check(len(ha["hits"]) == 10, f"knn-engine: body {i} short")
    finally:
        PLANES.enabled, PLANES.quantized = keep
    check(PLANES.stats["quantized_queries"] > served0,
          "knn-engine: the quantized tier never served")
    t_dev.sort()
    log(f"knn-engine: 32 responses equal on {dev} and cpu (3 similarities, "
        f"planes on/off, quantized tier on/off); {dev} latency p50 "
        f"{1e3 * pct(t_dev, 0.5):.2f} ms p99 {1e3 * pct(t_dev, 0.99):.2f} ms")


def sift_shaped(np, seed: int, n: int, centers):
    """n SIFT1M-shaped vectors: integers in [0, 255], clustered around
    ``centers`` with a Gaussian spread that varies per vector (8 to 40)."""
    rng = np.random.default_rng(seed)
    out = centers[rng.integers(0, len(centers), n)]
    spread = rng.uniform(8.0, 40.0, (n, 1)).astype(np.float32)
    out = out + rng.standard_normal(out.shape, dtype=np.float32) * spread
    return np.clip(np.rint(out), 0, 255).astype(np.float32)


def build_sift_shard(np, n_docs: int):
    from elasticsearch_tpu_torch.index.segment import Segment, VectorField
    rng = np.random.default_rng(SEED + 200)
    centers = rng.integers(16, 200, (1000, SIFT_DIMS)).astype(np.float32)
    sizes = [n_docs // 4 + (1 if i < n_docs % 4 else 0) for i in range(4)]
    segs = []
    for i, n in enumerate(sizes):
        m = sift_shaped(np, SEED + 201 + i, n, centers)
        seg = Segment(f"sift{i}", n)
        seg.vectors["vec"] = VectorField(
            matrix=m, exists=np.ones(n, bool),
            norms=np.linalg.norm(m, axis=1).astype(np.float32),
            similarity="cosine", dims=SIFT_DIMS)
        seg.ids = [str(j) for j in range(n)]
        seg.invalidate_live_count()
        segs.append(seg)
    queries = sift_shaped(np, SEED + 299, 64, centers)
    return segs, queries


def recall_at_10(np, segs, queries, answers) -> float:
    """Recall@10 of the served answers against an exact float64 cosine
    top-10 over every doc, on the host."""
    q = queries.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    best = []          # per segment: (scores [64, 10], (seg, doc) ids)
    for si, seg in enumerate(segs):
        m = seg.vectors["vec"].matrix.astype(np.float64)
        m /= np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-300)
        sims = q @ m.T
        top = np.argpartition(-sims, 10, axis=1)[:, :10]
        best.append((np.take_along_axis(sims, top, 1), si, top))
        del m, sims
    hit = 0
    for qi, got in enumerate(answers):
        cand = [(s, si, int(d)) for sc, si, top in best
                for s, d in zip(sc[qi], top[qi])]
        cand.sort(key=lambda c: -c[0])
        truth = {(si, d) for _s, si, d in cand[:10]}
        hit += len(truth & set(got[:10]))
    return hit / (10 * len(answers))


def knn_size(family: str, args):
    """(B, docs, k) of a knn_flat call, (B, docs, k') of a knn_coarse
    call, (B, k', k) of a knn_rerank call."""
    if family == "knn_coarse":
        return args[4].shape[0], args[0].shape[0], args[8]
    if family == "knn_rerank":
        return args[3].shape[0], args[6].shape[1], args[8]
    return args[3].shape[0], args[0].shape[0], args[6]


def phase_knn_full(torch, np, dev, n_docs: int, n_q: int,
                   shared) -> None:
    from elasticsearch_tpu_torch.index.engine import Reader
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batch_executor import (
        BatchSpec, _build_ctxs, batched_knn_shard,
    )
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    from elasticsearch_tpu_torch.search.phase import query_shard

    t0 = time.monotonic()
    segs, queries = build_sift_shard(np, n_docs)
    queries = queries[:n_q]
    log(f"knn-full: {n_docs} docs x {SIFT_DIMS} dims (integers 0..255, "
        f"clustered) in {len(segs)} segments, built in "
        f"{time.monotonic() - t0:.1f}s")
    mappers = MapperService({"properties": {"vec": {
        "type": "dense_vector", "dims": SIFT_DIMS, "similarity": "cosine",
        "index_options": {"type": "flat"}}}})
    reader = Reader(segs)
    PLANES.clear()
    PLANES.enabled, PLANES.quantized = True, True
    t1 = time.monotonic()
    part = PLANES.get(segs, "vectors", "vec", dev)
    check(part is not None, "knn-full: the vector plane was refused")
    exact_bytes = part.nbytes
    check(part.quantized_mirror() is not None,
          "knn-full: the int8 mirror was refused")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"knn-full: plane n_docs_pad={part.n_docs_pad} resident bytes "
        f"{part.nbytes} (matrix+norms+exists {exact_bytes}, int8 mirror + "
        f"scales {part.nbytes - exact_bytes}); torch.cuda.memory_allocated="
        f"{torch.cuda.memory_allocated() if dev.type == 'cuda' else 0}; "
        f"built+uploaded+quantized in {time.monotonic() - t1:.1f}s")

    vecs = [[float(x) for x in q] for q in queries]

    def solo(v):
        return query_shard(reader, mappers, dsl.Knn(
            field="vec", query_vector=v, k=10, num_candidates=100),
            size=10, device=dev)

    specs = [BatchSpec(kind="knn", field="vec", window=10, query_vector=v,
                       k=10, num_candidates=100) for v in vecs]
    ctxs = _build_ctxs(reader, mappers, None, None, device=dev)
    solo(vecs[0])          # untimed: the first query's host set-up
    DEVICE_PROFILE.timing = dev.type == "cuda"
    prev = device_ms(KNN_FAMILIES)
    prev_n = DEVICE_PROFILE.launches()
    legs, answers, stats, launched = {}, {}, {}, {}

    def rebase():
        """Leg baselines after a warm-up: its launches still count on the
        main path, but not in the leg's times."""
        nonlocal prev, prev_n
        prev, prev_n = device_ms(KNN_FAMILIES), DEVICE_PROFILE.launches()
        return dict(PLANES.stats)

    def note(leg, times, got, st0):
        nonlocal prev, prev_n
        now = device_ms(KNN_FAMILIES)
        now_n = DEVICE_PROFILE.launches()
        legs[leg] = (times, {f: round(now[f] - prev[f], 4)
                             for f in KNN_FAMILIES})
        launched[leg] = {f: now_n.get(f, 0) - prev_n.get(f, 0)
                         for f in KNN_FAMILIES}
        prev, prev_n = now, now_n
        answers[leg] = got
        stats[leg] = {k: PLANES.stats[k] - st0[k] for k in (
            "quantized_queries", "rerank_escalations",
            "quantized_exact_fallbacks")}

    try:
        st0 = dict(PLANES.stats)
        times, got = [], []
        for v in vecs:
            t = time.monotonic()
            res = solo(v)
            times.append(time.monotonic() - t)
            got.append([(d.segment_idx, d.doc, d.score) for d in res.docs])
        note("a_solo_tier_on", times, got, st0)
        for leg, enabled, quantized in (("b_batch_tier_on", True, True),
                                        ("c_batch_exact_plane", True, False),
                                        ("d_batch_per_segment", False,
                                         False)):
            PLANES.enabled, PLANES.quantized = enabled, quantized
            batched_knn_shard(ctxs, "vec", specs, 10)   # warm-up
            st0 = rebase()
            times = []
            for _rep in range(3):
                t = time.monotonic()
                out = batched_knn_shard(ctxs, "vec", specs, 10)
                times.append(time.monotonic() - t)
            note(leg, times, [[(d.segment_idx, d.doc, d.score)
                               for d in c[:10]] for c, *_ in out], st0)
    finally:
        PLANES.enabled, PLANES.quantized = True, True
        DEVICE_PROFILE.timing = False
    base = answers["a_solo_tier_on"]
    for leg, got in answers.items():
        check(got == base, f"knn-full: leg {leg} differs from the solo leg "
              f"(ids or score bits)")
    for res in base:
        check(len(res) == 10 and all(math.isfinite(s) and 0 <= s <= 1
                                     for _si, _d, s in res),
              "knn-full: an answer is short or has a bad score")
    check(stats["a_solo_tier_on"]["quantized_queries"] > 0,
          "knn-full: the quantized tier served no solo query")
    if dev.type == "cuda":
        check(launched["a_solo_tier_on"]["knn_coarse"] > 0 and
              launched["a_solo_tier_on"]["knn_rerank"] > 0,
              "knn-full: the solo leg launched no knn_coarse/knn_rerank")
        for leg in ("c_batch_exact_plane", "d_batch_per_segment"):
            check(launched[leg]["knn_flat"] > 0,
                  f"knn-full: leg {leg} launched no knn_flat")
    shared["sift"] = (segs, queries, answers["c_batch_exact_plane"])
    recall = recall_at_10(np, segs, queries,
                          [[(si, d) for si, d, _s in r] for r in base])
    log(f"knn-full: the four legs agree (ids and score bits, {n_q} "
        f"queries); recall@10 against the float64 exact oracle {recall:.4f}")
    check(recall >= 0.95, f"knn-full: recall@10 {recall} < 0.95")
    for leg, (times, kern) in legs.items():
        per_q = times if leg.startswith("a_") else [t / n_q for t in times]
        busy = sum(kern.values()) / max(1e3 * sum(times), 1e-9)
        log(f"knn-full: leg {leg}: wall p50 {1e3 * pct(times, 0.5):.3f} ms "
            f"p99 {1e3 * pct(times, 0.99):.3f} ms; per query p50 "
            f"{1e3 * pct(per_q, 0.5):.3f} ms; wall total "
            f"{1e3 * sum(times):.1f} ms over {len(times)} runs; kernel "
            f"device ms {kern}; launches {launched[leg]}; kernel-busy "
            f"share {busy:.4f}; tier {stats[leg]}")


def knn_bound(family: str, args):
    """(bound_ms, bound_by, bytes): the least time the card could take --
    the bytes the function must move (each input read once, each output
    written once) over the memory rate, or its products at the tensor
    cores' rate for the operand type plus ~8 f32 ops a score for the
    transform, whichever is larger."""
    if family == "knn_coarse":
        q8, qq, kp = args[0], args[4], args[8]
        n, d = q8.shape
        b = qq.shape[0]
        nbytes = n * d + n * 9 + b * d + b * 12 + b * kp * 8
        t_ops = 2 * b * n * d / INT8_OPS + 8 * b * n / F32_FLOPS
    elif family == "knn_rerank":
        matrix, cand, k = args[0], args[6], args[8]
        b, kp = cand.shape
        d = matrix.shape[1]
        nbytes = b * kp * (d * 4 + 5) + b * d * 4 + b * 8 + b * kp * 8 + \
            b * k * 8 + b * 4
        t_ops = 2 * b * kp * d / BF16_FLOPS + 8 * b * kp / F32_FLOPS
    else:
        matrix, queries, k = args[0], args[3], args[6]
        n, d = matrix.shape
        b = queries.shape[0]
        nbytes = n * d * 4 + n * 5 + b * d * 4 + b * 8 + b * k * 8
        t_ops = 2 * b * n * d / BF16_FLOPS + 8 * b * n / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def product_only_ms(torch, family: str, args):
    """The [B, D] x [D, N] product alone through one library call
    (torch.matmul in bf16 for knn_flat, torch._int_mm in int8 for
    knn_coarse): a yardstick for the product, not the fused function.
    ``_int_mm`` takes at least 17 rows, so smaller batches pad to 32."""
    if family == "knn_flat":
        a = args[3].to(torch.bfloat16)
        m = args[0].to(torch.bfloat16).t()
        return time_call(torch, lambda: torch.matmul(a, m), 20), a.shape[0]
    a, m = args[4], args[0].t()
    if a.shape[0] < 17:
        a = torch.cat([a, a.new_zeros(32 - a.shape[0], a.shape[1])])
    return time_call(torch, lambda: torch._int_mm(a, m), 20), a.shape[0]


def phase_knn_kernels(torch, rec, launches) -> list:
    from elasticsearch_tpu_torch.ops import knn
    rows = []
    for fam in KNN_FAMILIES:
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        err = 0.0
        for args, kwargs in calls[:8] + calls[-1:]:
            got = run_family(knn, fam, args, kwargs, plain=False)
            want = run_family(knn, fam, args, kwargs, plain=True)
            torch.cuda.synchronize()
            err = max(err, compare(torch, fam, got, want))
            del got, want
        args, kwargs = calls[-1]           # the largest main-path call
        ms = time_call(torch, lambda: run_family(knn, fam, args, kwargs,
                                                 False), 20)
        plain_ms = time_call(torch, lambda: run_family(knn, fam, args,
                                                       kwargs, True), 20)
        bound_ms, bound_by, nbytes = knn_bound(fam, args)
        shape = f"(B, N or k', k) = {knn_size(fam, args)}"
        row = {"name": fam, "route": "cuda",
               "source": f"elasticsearch_tpu_torch/csrc/{fam}.cu",
               "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "shape": shape}
        extra = ""
        if fam != "knn_rerank":
            prod_ms, rows_used = product_only_ms(torch, fam, args)
            row["product_only_library_ms"] = prod_ms
            extra = (f", product-only library call {prod_ms:.4f} ms "
                     f"({rows_used} query rows)")
        log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain "
            f"{plain_ms:.4f} ms (median of 20), bound {bound_ms:.4f} ms "
            f"({nbytes} bytes at 3.35 TB/s, {bound_by}), max_abs_err {err} "
            f"over {min(len(calls), 8) + 1} main-path calls, timed at the "
            f"largest, {shape}{extra}")
        first, f_kw = calls[0]
        if knn_size(fam, first) != knn_size(fam, args):
            # the solo path's call (the first recorded) beside the largest
            f_ms = time_call(torch, lambda: run_family(knn, fam, first, f_kw,
                                                       False), 20)
            f_plain = time_call(torch, lambda: run_family(knn, fam, first,
                                                          f_kw, True), 20)
            log(f"kernel {fam}: {f_ms:.4f} ms (median of 20), plain "
                f"{f_plain:.4f} ms, bound {knn_bound(fam, first)[0]:.4f} ms "
                f"at the first main-path call, (B, N or k', k) = "
                f"{knn_size(fam, first)}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the dense collector: K8, K9, K10, its engine path, the full-size legs
# ---------------------------------------------------------------------------

def neg_inf_where(torch, keep, row):
    return torch.where(keep, row, torch.full((), -math.inf,
                                             device=row.device))


def phase_dense_small(torch, np, dev) -> None:
    """K8 (bm25_scores), K9 (knn_scores) and K10 (dense_topk) against their
    plain versions on seeded calls, bitwise; and the two single-query
    programs the older kernels serve -- bm25_topk through K1 at n_q = 1 and
    knn_topk through K5 at B = 1 -- against their plain versions and
    against K8 / K9 followed by K10 (the same bits by design)."""
    from elasticsearch_tpu_torch.ops import bm25 as bm
    from elasticsearch_tpu_torch.ops import knn, topk
    rng = np.random.default_rng(SEED + 17)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    n = 0
    for n_docs, nb, qb in ((3000, 64, 8), (200_000, 4096, 1024),
                           (4_000_000, 65_536, 16_384)):
        docs, tfs, dl, live, _seg, n_pad = random_store(np, rng, n_docs, nb)
        n_real = qb - qb // 8      # the rest: gather_query_blocks' padding
        idx = np.zeros(qb, np.int32)
        w = np.zeros(qb, np.float32)
        idx[:n_real] = rng.integers(0, nb, n_real)
        w[:n_real] = rng.uniform(0.2, 9.0, n_real)
        avgdl = float(rng.uniform(40.0, 60.0))
        bd, bt, dlt, lv, fi, fw = T(docs), T(tfs), T(dl), T(live), T(idx), T(w)
        for lmask in (None, lv):
            args = (bd, bt, fi, fw, dlt, avgdl, n_pad, lmask)
            got = bm.bm25_block_scores(*args)
            want = bm.bm25_block_scores_plain(*args)
            torch.cuda.synchronize()
            compare(torch, f"bm25_scores n_docs_pad={n_pad} qb={qb}", [got],
                    [want])
            n += 1
        zq = torch.zeros_like(fi)
        avg = torch.full((qb,), avgdl, dtype=torch.float32, device=dev)
        s8 = bm.bm25_block_scores(bd, bt, fi, fw, dlt, avgdl, n_pad, lv)
        for k in (1, 10, min(4096, n_pad)):
            got = bm.bm25_topk(bd, bt, fi, fw, dlt, avgdl, lv, n_pad, k)
            ps, pd = bm.bm25_flat_plain(bd, bt, fi, fw, zq, dlt, avg, lv,
                                        n_pad, 1, k)
            torch.cuda.synchronize()
            compare(torch, f"bm25_topk (K1 at n_q 1) k={k}", got,
                    (ps[0], pd[0]))
            via = topk.dense_topk(neg_inf_where(torch, s8 > 0, s8), k)
            torch.cuda.synchronize()
            compare(torch, f"bm25_scores + dense_topk vs bm25_topk k={k}",
                    via, got)
            n += 2
        del bd, bt, dlt, s8
    for dims, n_docs, n_pad in ((5, 3000, 4096), (128, 200_000, 262_144),
                                (960, 100_000, 131_072)):
        m, norms, exists, live, _q = knn_inputs(np, rng, n_docs, n_pad, dims,
                                                1)
        mt, nt, et, lt = T(m), T(norms), T(exists), T(live)
        del m
        for sim in ("cosine", "dot_product", "l2_norm"):
            q = rng.standard_normal(dims, dtype=np.float32)
            batch = knn.QueryBatch([q], dev)
            args = (mt, nt, et, batch.queries[0], batch.qn, batch.q2, sim)
            row = knn.vector_scores(*args)
            want = knn.vector_scores_plain(*args)
            torch.cuda.synchronize()
            compare(torch, f"knn_scores D={dims} {sim}", [row], [want])
            for k in (1, 10, 100):
                got = knn.knn_topk(mt, nt, et, lt, q, k, sim)
                ps, pd = knn.knn_flat_plain(mt, nt, lt & et, batch.queries,
                                            batch.qn, batch.q2, k, sim)
                torch.cuda.synchronize()
                compare(torch, f"knn_topk (K5 at B 1) D={dims} {sim}", got,
                        (ps[0], pd[0]))
                via = topk.dense_topk(neg_inf_where(torch, lt & et, row), k)
                torch.cuda.synchronize()
                compare(torch, f"knn_scores + dense_topk vs knn_topk "
                        f"D={dims} {sim}", via, got)
                n += 2
            n += 1
        del mt
        torch.cuda.empty_cache()
    for n_pad in (128, 65_536, 262_144, 4_194_304):
        rand = rng.standard_normal(n_pad).astype(np.float32)
        rand[rng.random(n_pad) < 0.5] = -np.inf
        equal = np.ones(n_pad, np.float32)          # match_all's row
        equal[rng.random(n_pad) < 0.1] = -np.inf
        few = rng.integers(0, 4, n_pad).astype(np.float32)
        few[rng.random(n_pad) < 0.2] = -np.inf
        rows = {"random": rand, "all -inf": np.full(n_pad, -np.inf,
                                                   np.float32),
                "equal": equal, "four values": few}
        for name, row in rows.items():
            rt = T(row)
            for k in (1, 10, 4096):
                if k > n_pad:
                    continue
                got = topk.dense_topk(rt, k)
                want = topk.dense_topk_plain(rt, k)
                torch.cuda.synchronize()
                compare(torch, f"dense_topk n={n_pad} k={k} {name}", got,
                        want)
                if name == "equal":
                    first = np.nonzero(row == 1.0)[0][:k]
                    check(got[1][:len(first)].tolist() == first.tolist(),
                          f"dense_topk n={n_pad} k={k}: equal scores not "
                          f"in index order")
                n += 1
    log(f"dense-small: {n} kernel calls (bm25_scores up to 65,536 blocks "
        f"and QB 16,384; knn_scores at D 5/128/960 x 3 similarities; "
        f"dense_topk at k 1/10/4096 over rows of 128 to 4,194,304 with "
        f"all -inf and equal-score rows; bm25_topk via K1 and knn_topk via "
        f"K5) bitwise equal to their plain versions and to each other")


def same_hits(a, b) -> bool:
    """Two _search responses equal in ids, score bits, sort values,
    totals and max_score."""
    ha, hb = a["hits"], b["hits"]
    return ([(h["_id"], h["_score"], h.get("sort")) for h in ha["hits"]]
            == [(h["_id"], h["_score"], h.get("sort")) for h in hb["hits"]]
            and ha["total"] == hb["total"]
            and ha["max_score"] == hb["max_score"])


def dense_text_bodies(np, rng, words, n_per: int):
    """The dense-engine mix over the text engine: exact totals, bool with
    filters and must_not, should with minimum_should_match, multi_match,
    dis_max, constant_score, boosting, min_score; then the phrase pair,
    match_all, and field sorts with missing values and search_after."""
    out = []
    for _ in range(n_per):
        t = [" ".join(words[zipf_terms(np, rng, int(rng.integers(1, 4)),
                                       300)]) for _ in range(3)]
        tag = f"t{int(rng.integers(0, 7))}"
        lo = int(rng.integers(0, 600))
        out += [
            {"query": {"match": {"body": t[0]}}, "track_total_hits": True},
            {"query": {"bool": {
                "must": [{"match": {"body": t[0]}}],
                "filter": [{"term": {"tag": tag}},
                           {"range": {"n": {"gte": lo, "lt": lo + 400}}}],
                "must_not": [{"match": {"body": t[1]}}]}},
             "track_total_hits": True},
            {"query": {"bool": {"should": [
                {"match": {"body": t[0]}}, {"match": {"body": t[1]}},
                {"term": {"tag": tag}}], "minimum_should_match": 2}}},
            {"query": {"multi_match": {"query": t[2],
                                       "fields": ["body", "tag^2"]}}},
            {"query": {"dis_max": {"queries": [
                {"match": {"body": t[0]}}, {"match": {"body": t[1]}}],
                "tie_breaker": 0.7}}},
            {"query": {"constant_score": {"filter": {"term": {"tag": tag}},
                                          "boost": 1.5}}},
            {"query": {"boosting": {"positive": {"match": {"body": t[0]}},
                                    "negative": {"term": {"tag": tag}},
                                    "negative_boost": 0.25}}},
            {"query": {"match": {"body": t[2]}}, "min_score": 4.0},
        ]
    out += [
        {"query": {"match_phrase": {"body": "w40 w41"}}},
        {"query": {"match_phrase_prefix": {"body": "w150 w4"}}},
        {"query": {"match_all": {}}, "size": 10},
        {"query": {"match": {"body": "w30"}},
         "sort": [{"n": {"order": "asc"}}], "size": 20},
        {"query": {"match": {"body": "w31"}},
         "sort": [{"n": {"order": "desc"}}], "size": 20},
        {"query": {"match": {"body": "w31"}},
         "sort": [{"n": {"order": "desc"}}], "search_after": [500],
         "size": 20},
        {"query": {"match": {"body": "w32"}},
         "sort": [{"n": {"order": "asc", "missing": 7}}], "size": 20},
    ]
    return out


def dense_vector_bodies(rng, n: int):
    """script_score with each of the three vector functions (over
    match_all and over a filter), and knn inside bool."""
    out = []
    for i in range(n):
        qv = [float(x) for x in rng.standard_normal(128)]
        tag = f"t{i % 5}"
        out += [
            {"query": {"script_score": {
                "query": {"match_all": {}},
                "script": {"source": "cosineSimilarity(params.qv, 'vec_cos')"
                           " + 1.0", "params": {"qv": qv}}}}},
            {"query": {"script_score": {
                "query": {"bool": {"filter": [{"term": {"tag": tag}}]}},
                "script": {"source": "dotProduct(params.qv, 'vec_dot')",
                           "params": {"qv": qv}}}}},
            {"query": {"script_score": {
                "query": {"range": {"n": {"lt": 500}}},
                "script": {"source": "l2norm(params.qv, 'vec_l2')",
                           "params": {"qv": qv}}}}, "size": 5},
            {"query": {"bool": {
                "must": [{"knn": {"field": "vec_cos", "query_vector": qv,
                                  "k": 50, "num_candidates": 100}}],
                "filter": [{"term": {"tag": tag}}]}}},
            {"query": {"bool": {"should": [
                {"knn": {"field": "vec_l2", "query_vector": qv, "k": 20}},
                {"term": {"tag": tag}}]}}, "track_total_hits": True},
        ]
    return out


def phase_dense_engine(torch, np, dev, text, vec) -> None:
    """The dense collector through SearchService (and query_shard for
    terminate_after) on the text and the vector engines: every response
    on the card equal to the same package's on the CPU, score bits
    included; plus _count."""
    from elasticsearch_tpu_torch.search import SearchService, dsl
    from elasticsearch_tpu_torch.search.phase import query_shard
    engine, words, rng = text
    vengine, vrng = vec
    n = 0
    t_dev = []
    for eng, bodies in ((engine, dense_text_bodies(np, rng, words, 4)),
                        (vengine, dense_vector_bodies(vrng, 4))):
        on_dev = SearchService(eng, index_name="smoke", device=dev)
        on_cpu = SearchService(eng, index_name="smoke", device="cpu")
        for body in bodies:
            body = {**body, "_source": False}
            t1 = time.monotonic()
            a = on_dev.search(body)
            t_dev.append(time.monotonic() - t1)
            b = on_cpu.search(body)
            check(same_hits(a, b), f"dense-engine: card != cpu for {body}")
            n += 1
        for body in bodies[:6]:
            ca = on_dev.count({"query": body["query"]})
            cb = on_cpu.count({"query": body["query"]})
            check(ca == cb, f"dense-engine: _count differs for {body}")
            n += 1
    reader = engine.acquire_reader()
    for limit in (1, 100, 20_000):
        q = dsl.parse_query({"match": {"body": "w2 w9"}})
        a, b = (query_shard(reader, engine.mappers, q, size=10,
                            terminate_after=limit, device=d)
                for d in (dev, "cpu"))
        check([(d.segment_idx, d.doc, d.score) for d in a.docs]
              == [(d.segment_idx, d.doc, d.score) for d in b.docs]
              and (a.total_hits, a.terminated_early)
              == (b.total_hits, b.terminated_early),
              f"dense-engine: terminate_after {limit} differs")
        n += 1
    log(f"dense-engine: {n} responses equal on {dev} and cpu (score bits "
        f"included); {dev} _search latency p50 "
        f"{1e3 * pct(t_dev, 0.5):.2f} ms p99 {1e3 * pct(t_dev, 0.99):.2f} ms")


DENSE_FAMILIES = ("bm25_scores", "knn_scores", "dense_topk")
OLDER_FAMILIES = FAMILIES + KNN_FAMILIES


def host_total(np, segs, analyzer_terms) -> int:
    """Live docs holding any of the terms, counted on the host from the
    postings."""
    total = 0
    for seg in segs:
        pf = seg.postings["body"]
        hit = np.zeros(seg.n_docs, bool)
        for t in set(analyzer_terms):
            docs, _ = pf.postings_for(t)
            hit[docs] = True
        total += int((hit & seg.live).sum())
    return total


def same_up_to_ties(want, got) -> bool:
    """``got`` [(seg, doc, score)] equals ``want``'s ids in order, except
    that docs whose ``got`` scores are equal may come in either order (a
    score transform can merge neighbouring scores); a tie group at the
    cut only has to be as long."""
    if len(want) != len(got):
        return False
    i = 0
    while i < len(got):
        j = i
        while j + 1 < len(got) and got[j + 1][2] == got[i][2]:
            j += 1
        ids_w = {(s, d) for s, d, _ in want[i:j + 1]}
        ids_g = {(s, d) for s, d, _ in got[i:j + 1]}
        if j + 1 < len(got) and ids_w != ids_g:
            return False
        i = j + 1
    return True


def phase_dense_full(torch, np, dev, shared, n_q: int):
    """The dense collector at full width on the two shards the full and
    knn-full phases built: (a) the MS MARCO-shaped shard's queries as solo
    match with track_total_hits true (K8 + K10 per segment), ids and score
    bits equal to the exact K1 batch leg, totals equal to a host count;
    (b) SIFT1M-shaped shard, BASELINE #2 in its script_score form (K9 +
    K10 per segment), ids equal to the exact-plane knn leg, recall@10
    against the float64 oracle >= 0.95."""
    from elasticsearch_tpu_torch.index.engine import Reader
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    from elasticsearch_tpu_torch.search.phase import query_shard
    from elasticsearch_tpu_torch.analysis import STANDARD
    check("msmarco" in shared and "sift" in shared,
          "dense-full needs the full and knn-full phases in the same run")

    def leg(name, bodies, reader, mappers, per_query):
        query_shard(reader, mappers, dsl.parse_query(bodies[0]["query"]),
                    size=10, track_total_hits=True, device=dev)  # untimed
        DEVICE_PROFILE.timing = dev.type == "cuda"
        ms0 = device_ms(DENSE_FAMILIES)
        n0 = DEVICE_PROFILE.launches()
        times, out = [], []
        try:
            for body in bodies:
                t = time.monotonic()
                res = query_shard(reader, mappers,
                                  dsl.parse_query(body["query"]),
                                  size=body.get("size", 10),
                                  track_total_hits=body.get(
                                      "track_total_hits", 10_000),
                                  device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                times.append(time.monotonic() - t)
                out.append(res)
        finally:
            DEVICE_PROFILE.timing = False
        ms1 = device_ms(DENSE_FAMILIES)
        n1 = DEVICE_PROFILE.launches()
        launched = {f: n1.get(f, 0) - n0.get(f, 0)
                    for f in DENSE_FAMILIES + OLDER_FAMILIES}
        kern = {f: round(ms1[f] - ms0[f], 4) for f in DENSE_FAMILIES}
        if dev.type == "cuda":
            for fam, per in per_query.items():
                check(launched[fam] == per * len(bodies),
                      f"dense-full {name}: {launched[fam]} {fam} launches, "
                      f"expected {per} a query")
            for fam in OLDER_FAMILIES:
                check(launched[fam] == 0,
                      f"dense-full {name}: {fam} launched on the dense leg")
        busy = sum(kern.values()) / max(1e3 * sum(times), 1e-9)
        log(f"dense-full: leg {name}: {len(bodies)} solo queries, wall p50 "
            f"{1e3 * pct(times, 0.5):.3f} ms p99 {1e3 * pct(times, 0.99):.3f}"
            f" ms, wall total {1e3 * sum(times):.1f} ms; kernel device ms "
            f"{kern}; launches { {f: v for f, v in launched.items() if v} }; "
            f"kernel-busy share {busy:.4f}")
        return out

    segs, mappers, queries, k1_hits = shared["msmarco"]
    queries = queries[:n_q]
    reader = Reader(segs)
    n_seg = len(segs)
    bodies = [{"query": {"match": {"body": q}}, "track_total_hits": True}
              for q in queries]
    got = leg("a_msmarco_match_exact_totals", bodies, reader, mappers,
              {"bm25_scores": n_seg, "dense_topk": n_seg})
    for qi, (res, want) in enumerate(zip(got, k1_hits)):
        have = [(d.segment_idx, d.doc, d.score) for d in res.docs]
        check([h[:2] for h in have] == [h[:2] for h in want],
              f"dense-full: query {qi}: ids differ from the K1 batch leg")
        check([h[2] for h in have] == [h[2] for h in want],
              f"dense-full: query {qi}: scores differ from the K1 batch leg")
        total = host_total(np, segs, STANDARD.terms(queries[qi]))
        check(res.total_hits == total and res.total_relation == "eq",
              f"dense-full: query {qi}: total {res.total_hits} != host "
              f"count {total}")
    log(f"dense-full: {len(got)} match queries: ids and score bits equal to "
        f"the exact K1 batch leg, totals equal to the host count "
        f"(largest {max(r.total_hits for r in got)})")

    vsegs, vqueries, knn_hits = shared["sift"]
    vqueries = vqueries[:n_q]
    vmappers = MapperService({"properties": {"vec": {
        "type": "dense_vector", "dims": SIFT_DIMS, "similarity": "cosine",
        "index_options": {"type": "flat"}}}})
    vbodies = [{"query": {"script_score": {
        "query": {"match_all": {}},
        "script": {"source": "cosineSimilarity(params.qv, 'vec') + 1.0",
                   "params": {"qv": [float(x) for x in v]}}}}, "size": 10}
        for v in vqueries]
    got = leg("b_sift_script_score", vbodies, Reader(vsegs), vmappers,
              {"knn_scores": len(vsegs), "dense_topk": len(vsegs)})
    answers = []
    for qi, (res, want) in enumerate(zip(got, knn_hits)):
        have = [(d.segment_idx, d.doc, d.score) for d in res.docs]
        check(same_up_to_ties(want, have),
              f"dense-full: query {qi}: script_score ids differ from the "
              f"exact-plane knn leg")
        check(all(math.isfinite(s) and 1.0 <= s <= 2.0 for *_x, s in have),
              f"dense-full: query {qi}: script score out of [1, 2]")
        answers.append([(si, d) for si, d, _s in have])
    recall = recall_at_10(np, vsegs, vqueries, answers)
    log(f"dense-full: {len(got)} script_score queries: ids equal to the "
        f"exact-plane knn leg; recall@10 against the float64 exact oracle "
        f"{recall:.4f}")
    check(recall >= 0.95, f"dense-full: recall@10 {recall} < 0.95")


def dense_n(family: str, args) -> int:
    """The row length (n_docs_pad) of a K8, K9 or K10 call."""
    if family == "bm25_scores":
        return args[6]
    return args[0].shape[0]


def dense_size(family: str, args):
    return (dense_n(family, args), args[2].numel()
            if family == "bm25_scores" else 0)


def dense_bound(family: str, args):
    """(bound_ms, bound_by, bytes): the least time the card could take --
    the bytes the function must move (each input read once, each output
    written once) over the memory rate, or its arithmetic at the peak for
    its type, whichever is larger."""
    n = dense_n(family, args)
    if family == "bm25_scores":
        qb = args[2].numel()
        postings = qb * 128
        # gathered doc ids, tfs and doc lengths; idx + weight; live; out
        nbytes = postings * 12 + qb * 8 + n + n * 4
        t_ops = postings * 8 / F32_FLOPS
    elif family == "knn_scores":
        d = args[0].shape[1]
        nbytes = n * d * 4 + n * 4 + n + d * 4 + 8 + n * 4
        t_ops = 2 * n * d / BF16_FLOPS + 8 * n / F32_FLOPS
    else:
        k = args[1]
        nbytes = n * 4 + k * 8
        t_ops = n / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def dense_library_ms(torch, family: str, args):
    """One PyTorch call computing the same function, where there is one:
    torch.topk on the same row for K10 (the same top-k, ties in no
    promised order); the bf16 [N, D] x [D] product alone (torch.mv) for
    K9. None for K8."""
    if family == "dense_topk":
        row, k = args[0], args[1]
        return time_call(torch, lambda: torch.topk(row, k), 20)
    if family == "knn_scores":
        m = args[0].to(torch.bfloat16)
        q = args[3].to(torch.bfloat16)
        return time_call(torch, lambda: torch.mv(m, q), 20)
    return None


def phase_dense_kernels(torch, rec, launches) -> list:
    """Each dense family against its plain version on up to 8 main-path
    calls plus its largest per row length; timed (CUDA events) at its
    largest main-path call -- K10 also at the SIFT shard's row length."""
    from elasticsearch_tpu_torch.ops import bm25 as bm
    from elasticsearch_tpu_torch.ops import knn, topk
    mods = {"bm25_scores": (bm, "bm25_block_scores"),
            "knn_scores": (knn, "vector_scores"),
            "dense_topk": (topk, "dense_topk")}
    rows = []
    for fam in DENSE_FAMILIES:
        mod, name = mods[fam]
        kernel = getattr(mod, name)
        plain = getattr(mod, name + "_plain")
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        err = 0.0
        for args, kwargs in calls[:8] + rec.largest_calls(fam):
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            if fam != "dense_topk":
                got, want = [got], [want]
            err = max(err, compare(torch, fam, got, want))
            del got, want
        largest = sorted(rec.largest_calls(fam),
                         key=lambda c: dense_n(fam, c[0]), reverse=True)
        timed = largest[:1]
        if fam == "dense_topk":
            timed += [c for c in largest
                      if dense_n(fam, c[0]) == 262_144][:1]
        for args, kwargs in timed:
            ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
            plain_ms = time_call(torch, lambda: plain(*args, **kwargs), 20)
            bound_ms, bound_by, nbytes = dense_bound(fam, args)
            lib_ms = dense_library_ms(torch, fam, args)
            shape = (f"n_docs_pad={dense_n(fam, args)}" + (
                f" qb={args[2].numel()}" if fam == "bm25_scores" else "") + (
                f" dims={args[0].shape[1]}" if fam == "knn_scores" else "") + (
                f" k={args[1]}" if fam == "dense_topk" else ""))
            log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain "
                f"{plain_ms:.4f} ms (median of 20), bound {bound_ms:.4f} ms "
                f"({nbytes} bytes at 3.35 TB/s, {bound_by}), library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                f"max_abs_err {err} over {len(calls)} main-path calls, "
                f"timed at {shape}")
            rows.append({
                "name": fam, "route": "cuda",
                "source": f"elasticsearch_tpu_torch/csrc/{fam}.cu",
                "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "shape": shape})
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# filtered kNN and the IVF path: the masked K5-K7, K11-K14, the engine
# path, the GIST1M-shaped shard
# ---------------------------------------------------------------------------

IVF_FAMILIES = ("ivf_assign", "ivf_update", "ivf_init", "ivf_search")
MASKED = ("knn_flat_masked", "knn_coarse_masked", "knn_rerank_masked")
SIMS = ("cosine", "dot_product", "l2_norm")
# the position of the mask operand in each masked family's wrapper call
MASK_POS = {"knn_flat_masked": 8, "knn_coarse_masked": 10,
            "knn_rerank_masked": 10}


def per_row_masks(np, rng, n_real: int, n_rows: int, n_pad: int,
                  n_docs: int, density: float):
    """[n_rows, n_pad] filter rows: ``density`` of the real docs, the first
    row all False, rows past ``n_real`` (the pow2 padding) all False."""
    m = np.zeros((n_rows, n_pad), bool)
    m[:n_real, :n_docs] = rng.random((n_real, n_docs)) < density
    m[0] = False
    return m


def check_masked_rows(torch, knn, name, got, row_call, rows):
    """Each listed row of a masked launch must have the bits of the
    unmasked kernel run on allowed & that row's mask (``row_call(row)``)."""
    for row in rows:
        want = row_call(row)
        compare(torch, f"{name} row {row} vs unmasked",
                tuple(g[row: row + 1] for g in got), want)


def phase_ivf_small(torch, np, dev) -> None:
    """The masked K5-K7 and K11-K14 against their plain versions on the
    card, bitwise, on seeded inputs; each masked row also against the
    unmasked kernel run on allowed & that row's mask."""
    from elasticsearch_tpu_torch.convert import ivf_from_reference
    from elasticsearch_tpu_torch.ops import ivf, knn
    from elasticsearch_tpu_torch.ops.device_segment import quantize_rows
    rng = np.random.default_rng(SEED + 400)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    n = 0
    for dims, n_docs, n_pad in ((128, 200_000, 262_144),
                                (960, 50_000, 65_536)):
        m, norms, exists, live, _q = knn_inputs(np, rng, n_docs, n_pad,
                                                dims, 1)
        q8, scales = quantize_rows(m)
        mt, nt, allowed, q8t, st = T(m), T(norms), T(live & exists), \
            T(q8), T(scales)
        del m, q8
        for n_real, density in ((5, 0.1), (64, 0.01)):
            q = rng.standard_normal((n_real, dims), dtype=np.float32)
            batch = knn.QueryBatch(q, dev)
            b = batch.queries.shape[0]
            masks = T(per_row_masks(np, rng, n_real, b, n_pad, n_docs,
                                    density))
            qq, qscale = batch.quantized()
            rows = sorted({0, 1, n_real - 1, b - 1})
            for sim in SIMS:
                args = (mt, nt, allowed, batch.queries, batch.qn, batch.q2)
                got = knn.knn_flat(*args, 100, sim, masks)
                torch.cuda.synchronize()
                compare(torch, f"knn_flat masked D={dims} B={b} {sim}", got,
                        knn.knn_flat_plain(*args, 100, sim, masks))
                check_masked_rows(
                    torch, knn, f"knn_flat D={dims} {sim}", got,
                    lambda r: knn.knn_flat(
                        mt, nt, allowed & masks[r],
                        batch.queries[r: r + 1], batch.qn[r: r + 1],
                        batch.q2[r: r + 1], 100, sim), rows)
                cargs = (q8t, st, nt, allowed, qq, qscale, batch.qn,
                         batch.q2)
                cgot = knn.knn_coarse(*cargs, 256, sim, masks)
                torch.cuda.synchronize()
                compare(torch, f"knn_coarse masked D={dims} B={b} {sim}",
                        cgot, knn.knn_coarse_plain(*cargs, 256, sim, masks))
                check_masked_rows(
                    torch, knn, f"knn_coarse D={dims} {sim}", cgot,
                    lambda r: knn.knn_coarse(
                        q8t, st, nt, allowed & masks[r], qq[r: r + 1],
                        qscale[r: r + 1], batch.qn[r: r + 1],
                        batch.q2[r: r + 1], 256, sim), rows)
                cs, cand = cgot
                rgot = knn.knn_rerank(*args, cand, cs, 10, sim, masks)
                torch.cuda.synchronize()
                compare(torch, f"knn_rerank masked D={dims} B={b} {sim}",
                        rgot, knn.knn_rerank_plain(*args, cand, cs, 10, sim,
                                                   masks))
                check_masked_rows(
                    torch, knn, f"knn_rerank D={dims} {sim}", rgot,
                    lambda r: knn.knn_rerank(
                        mt, nt, allowed & masks[r],
                        batch.queries[r: r + 1], batch.qn[r: r + 1],
                        batch.q2[r: r + 1], cand[r: r + 1], cs[r: r + 1],
                        10, sim), rows)
                n += 3 * (1 + len(rows))
        del mt, q8t
        torch.cuda.empty_cache()
    log(f"ivf-small: {n} masked knn_flat/knn_coarse/knn_rerank calls "
        f"(3 similarities, D 128/960, B 8/64 with pow2-padded and "
        f"all-false rows) bitwise equal to their plain versions and, row "
        f"by row, to the unmasked kernels on allowed & mask")

    n = 0
    for dims, n_rows, nlist in ((16, 3000, 37), (100, 20_000, 300),
                                (960, 20_000, 256)):
        x = rng.standard_normal((n_rows, dims), dtype=np.float32)
        x[7] = x[3]                         # duplicate rows: tied distances
        x[11] = x[3]
        cents = x[rng.choice(n_rows, nlist, replace=False)].copy()
        cents[5] = cents[2]                 # tied centroids: the lower wins
        xt, ct = T(x), T(cents)
        a = ivf.ivf_assign(xt, ct)
        torch.cuda.synchronize()
        compare(torch, f"ivf_assign D={dims} nlist={nlist}", (a,),
                (ivf.ivf_assign_plain(xt, ct),))
        check(not bool((a == 5).any()), "ivf_assign: a tie went to the "
              "higher centroid index")
        a[:3] = -1                          # dropped, as segment_sum does
        a[3] = nlist
        u = ivf.ivf_update(xt, a, ct)
        torch.cuda.synchronize()
        compare(torch, f"ivf_update D={dims} nlist={nlist}", (u,),
                (ivf.ivf_update_plain(xt, a, ct),))
        check(torch.equal(u[5], ct[5]), "ivf_update: an empty cluster "
              "lost its previous centroid")
        f = ivf.ivf_init(xt, 3, nlist)
        torch.cuda.synchronize()
        compare(torch, f"ivf_init D={dims} nlist={nlist}", (f,),
                (ivf.ivf_init_plain(xt, 3, nlist),))
        n += 3
    # K14 on a synthetic index: tied centroids, padded lists, nprobe up to
    # nlist; k above the probe pool is clamped by IVFIndex.search
    nlist, list_len, dims = 48, 40, 64
    cents = rng.standard_normal((nlist, dims), dtype=np.float32)
    cents[5] = cents[2]
    lists = rng.standard_normal((nlist, list_len, dims), dtype=np.float32)
    valid = rng.random((nlist, list_len)) < 0.8
    valid[:, :3] = True
    lists[~valid] = 0.0
    lists[4, 7] = lists[4, 2]               # tied slot scores in one list
    lists[9, 1] = lists[4, 2]               # ... and across two lists
    ids = np.where(valid, rng.permutation(nlist * list_len).reshape(
        nlist, list_len), -1).astype(np.int32)
    norms = np.linalg.norm(lists, axis=2).astype(np.float32)
    for sim in SIMS:
        on_dev = ivf_from_reference(cents, lists, valid, ids, norms, sim,
                                    dev)
        on_cpu = ivf_from_reference(cents, lists, valid, ids, norms, sim,
                                    "cpu")
        q = rng.standard_normal((9, dims), dtype=np.float32)
        q[0] = cents[2]
        q[1] = lists[4, 2]
        batch = knn.QueryBatch(q, dev)
        for nprobe, k in ((1, 10), (3, 10), (7, 10**6), (nlist, 25),
                          (nlist, 4096)):
            args = (batch.queries, batch.qn, batch.q2, on_dev.centroids,
                    on_dev.lists, on_dev.valid, on_dev.ids, on_dev.norms)
            k_eff = min(k, nprobe * list_len)
            got = ivf.ivf_search(*args, k_eff, nprobe, sim)
            torch.cuda.synchronize()
            compare(torch, f"ivf_search {sim} nprobe={nprobe} k={k_eff}",
                    got, ivf.ivf_search_plain(*args, k_eff, nprobe, sim))
            s_dev, i_dev = on_dev.search(q, k, nprobe)
            s_cpu, i_cpu = on_cpu.search(q, k, nprobe)
            check(np.array_equal(i_dev, i_cpu) and
                  np.array_equal(s_dev.view(np.int32), s_cpu.view(np.int32)),
                  f"ivf_search {sim} nprobe={nprobe}: card and CPU differ")
            n += 1
    log(f"ivf-small: {n} ivf_assign/ivf_update/ivf_init/ivf_search calls "
        f"(D 16/64/100/960, tied rows and centroids, dropped and empty "
        f"clusters, padded lists, nprobe 1..nlist, clamped k, 3 "
        f"similarities) bitwise equal to their plain versions")


IVF_FIELDS = {"cosine": "ivf_cos", "dot_product": "ivf_dot",
              "l2_norm": "ivf_l2"}


def build_ivf_engine(np, n_docs: int):
    """``InternalEngine`` with ``n_docs`` seeded docs: one 64-dim vector
    around 40 Gaussian cluster means, mapped under the three similarities
    with ``index_options: {type: ivf, nlist: 16}``, a keyword ``tag`` (5
    values) and an integer ``n``; three segments. Returns (engine, rng,
    vectors)."""
    from elasticsearch_tpu_torch.index import InternalEngine
    from elasticsearch_tpu_torch.mapping import MapperService
    rng = np.random.default_rng(SEED + 500)
    props = {f: {"type": "dense_vector", "dims": 64, "similarity": sim,
                 "index_options": {"type": "ivf", "nlist": 16}}
             for sim, f in IVF_FIELDS.items()}
    props.update({"tag": {"type": "keyword"}, "n": {"type": "integer"}})
    engine = InternalEngine(MapperService({"properties": props}),
                            shard_label="smoke-ivf")
    means = rng.standard_normal((40, 64), dtype=np.float32)
    vecs = means[rng.integers(0, 40, n_docs)] + np.float32(0.3) * \
        rng.standard_normal((n_docs, 64), dtype=np.float32)
    for i in range(n_docs):
        v = vecs[i].tolist()
        doc = {f: v for f in IVF_FIELDS.values()}
        doc.update({"tag": f"t{i % 5}", "n": int(i * 7 % 100)})
        engine.index(str(i), doc)
        if i in (n_docs // 3, 2 * n_docs // 3):
            engine.refresh()
    engine.refresh()
    return engine, rng, vecs


KNN_FILTERS = ({"term": {"tag": "t1"}},
               {"range": {"n": {"gte": 20, "lt": 55}}},
               {"bool": {"must": [{"term": {"tag": "t2"}}],
                         "must_not": [{"range": {"n": {"gte": 60}}}]}})


def batch_keys(out):
    return [[(d.segment_idx, d.doc, d.score) for d in c] for c, *_ in out]


def phase_ivf_engine(torch, np, dev, vec, n_ivf_docs: int) -> None:
    """Filtered knn (term, range, bool filters) on the vector engine and
    knn on IVF-mapped fields (index_options type ivf, nlist 16, on small
    segments) through SearchService, planes on and off, quantized tier on
    and off; deletes after the IVF build; a refresh that warm-starts the
    plane's k-means; batched_knn_shard with heterogeneous filters and with
    filtered and unfiltered members on an IVF-routed field. Every answer
    on the card equal to the same package's on the CPU, score bits
    included."""
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import SearchService, dsl
    from elasticsearch_tpu_torch.search.batch_executor import (
        BatchSpec, _build_ctxs, batched_knn_shard,
    )
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    vengine, vrng = vec
    keep = (PLANES.enabled, PLANES.quantized)
    n, t_dev = 0, []
    try:
        on_dev = SearchService(vengine, index_name="smoke", device=dev)
        on_cpu = SearchService(vengine, index_name="smoke", device="cpu")
        sims = list(KNN_FIELDS)
        for i in range(24):
            PLANES.enabled = (i // 3) % 2 == 0
            PLANES.quantized = (i // 6) % 2 == 0
            q = vrng.standard_normal(128, dtype=np.float32).tolist()
            body = {"query": {"knn": {
                "field": KNN_FIELDS[sims[i % 3]], "query_vector": q,
                "k": (10, 25)[i % 2], "num_candidates": 100,
                "filter": KNN_FILTERS[i % 3]}}, "size": 10,
                "_source": False}
            t1 = time.monotonic()
            a = on_dev.search(body)
            t_dev.append(time.monotonic() - t1)
            check(same_hits(a, on_cpu.search(body)),
                  f"ivf-engine: filtered knn body {i} differs")
            n += 1
        reader = vengine.acquire_reader()
        queries = vrng.standard_normal((16, 128), dtype=np.float32)
        stats = {}
        for filters in ([KNN_FILTERS[0]] * 16,
                        [KNN_FILTERS[i % 3] for i in range(16)],
                        [None if i % 2 else KNN_FILTERS[i % 3]
                         for i in range(16)]):
            for PLANES.enabled in (True, False):
                got = []
                for d in (dev, "cpu"):
                    specs = [BatchSpec(
                        kind="knn", field="vec_cos", window=10,
                        query_vector=q.tolist(), k=10, num_candidates=100,
                        filter=None if f is None else dsl.parse_query(f),
                        filter_key=None if f is None else repr(f))
                        for q, f in zip(queries, filters)]
                    ctxs = _build_ctxs(reader, vengine.mappers, None, None,
                                       device=d)
                    got.append(batch_keys(batched_knn_shard(
                        ctxs, "vec_cos", specs, 10, stats=stats)))
                check(got[0] == got[1], "ivf-engine: batched filtered knn "
                      "differs between card and cpu")
                n += 1
        # IVF-mapped fields: solo bodies, deletes, a warm-started refresh
        PLANES.clear()
        engine, rng, vecs = build_ivf_engine(np, n_ivf_docs)
        on_dev = SearchService(engine, index_name="smoke-ivf", device=dev)
        on_cpu = SearchService(engine, index_name="smoke-ivf", device="cpu")

        def ivf_bodies(m):
            out = []
            for i in range(m):
                q = vecs[rng.integers(0, len(vecs))] + np.float32(0.05) * \
                    rng.standard_normal(64, dtype=np.float32)
                out.append({"query": {"knn": {
                    "field": IVF_FIELDS[sims[i % 3]],
                    "query_vector": q.tolist(), "k": 10,
                    "num_candidates": (20, 200, 1000)[i % 3]}},
                    "size": 10, "_source": False})
            return out

        def run_bodies(bodies, what):
            nonlocal n
            for body in bodies:
                t1 = time.monotonic()
                a = on_dev.search(body)
                t_dev.append(time.monotonic() - t1)
                check(same_hits(a, on_cpu.search(body)),
                      f"ivf-engine: {what} differs between card and cpu")
                check(len(a["hits"]["hits"]) == 10,
                      f"ivf-engine: {what} short")
                n += 1

        launches0 = DEVICE_PROFILE.launches()
        warm0 = PLANES.stats["ivf_warm_starts"]
        for PLANES.enabled in (True, False):
            run_bodies(ivf_bodies(9), "ivf knn")
        for i in rng.choice(n_ivf_docs, 30, replace=False):
            engine.delete(str(int(i)))
        engine.refresh()
        for PLANES.enabled in (True, False):
            run_bodies(ivf_bodies(6), "ivf knn after deletes")
        PLANES.enabled = True
        extra = vecs[:300] + np.float32(0.01)
        for j, v in enumerate(extra):
            engine.index(f"x{j}", {f: v.tolist() for f in IVF_FIELDS.values()}
                         | {"tag": "t9", "n": 1})
        engine.refresh()
        run_bodies(ivf_bodies(6), "ivf knn after a refresh")
        warm = PLANES.stats["ivf_warm_starts"] - warm0
        # one shard IVF a field and device: each refreshed plane warm-starts
        check(warm == len(IVF_FIELDS) * len({str(dev), "cpu"}),
              f"ivf-engine: {warm} refreshed planes warm-started k-means")
        # filtered and unfiltered members in one batch on the IVF fields
        reader = engine.acquire_reader()
        qs = vecs[rng.integers(0, len(vecs), 12)]
        for PLANES.enabled in (True, False):
            got = []
            for d in (dev, "cpu"):
                specs = [BatchSpec(
                    kind="knn", field="ivf_l2", window=10,
                    query_vector=q.tolist(), k=10,
                    num_candidates=200 if PLANES.enabled else
                    (20, 200, 1000)[i % 3],
                    filter=None if i % 3 else dsl.parse_query(
                        KNN_FILTERS[i % 2]),
                    filter_key=None if i % 3 else repr(KNN_FILTERS[i % 2]))
                    for i, q in enumerate(qs)]
                ctxs = _build_ctxs(reader, engine.mappers, None, None,
                                   device=d)
                got.append(batch_keys(batched_knn_shard(ctxs, "ivf_l2",
                                                        specs, 10)))
            check(got[0] == got[1], "ivf-engine: mixed batch differs")
            n += 1
        now = DEVICE_PROFILE.launches()
        launched = {f: now.get(f, 0) - launches0.get(f, 0)
                    for f in IVF_FAMILIES}
        if dev.type == "cuda":
            check(all(v > 0 for v in launched.values()),
                  f"ivf-engine: an IVF kernel never launched: {launched}")
    finally:
        PLANES.enabled, PLANES.quantized = keep
    t_dev.sort()
    log(f"ivf-engine: {n} responses and batches equal on {dev} and cpu "
        f"(filtered knn: term/range/bool, shared and per-member masks; "
        f"IVF fields: 3 similarities, planes on/off, deletes, warm-started "
        f"refresh: {warm} warm starts, mixed batches); filter-mask "
        f"counters {stats}; IVF "
        f"launches {launched}; {dev} latency "
        f"p50 {1e3 * pct(t_dev, 0.5):.2f} ms p99 "
        f"{1e3 * pct(t_dev, 0.99):.2f} ms")


GIST_DOCS = 1 << 20
GIST_DIMS = 960
NPROBES = (16, 32, 64, 128, 256)


def gist_shaped(torch, dev, n: int, n_q: int):
    """bench.py cfg_ivf's GIST1M envelope, made on the device from a
    seed: 1,024 Gaussian cluster means, rows = a mean + 0.35 noise,
    queries = corpus rows + 0.05 noise. Returns (corpus, queries) f32
    tensors on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(SEED + 600)
    means = torch.randn(1024, GIST_DIMS, generator=g, device=dev)
    which = torch.randint(0, 1024, (n,), generator=g, device=dev)
    corpus = means[which]
    corpus.add_(torch.randn(n, GIST_DIMS, generator=g, device=dev), alpha=0.35)
    pick = torch.randint(0, n, (n_q,), generator=g, device=dev)
    queries = corpus[pick] + 0.05 * torch.randn(n_q, GIST_DIMS, generator=g,
                                                device=dev)
    return corpus, queries


def cosine_oracle(torch, corpus, queries, k: int = 10):
    """Exact cosine top-k ids per query, in float64 on the corpus's device,
    a chunk of rows at a time."""
    q = queries.double()
    q = q / q.norm(dim=1, keepdim=True)
    best_s, best_i = None, None
    step = 1 << 17
    for lo in range(0, corpus.shape[0], step):
        c = corpus[lo: lo + step].double()
        c = c / c.norm(dim=1, keepdim=True).clamp_min(1e-300)
        s, i = torch.topk(q @ c.t(), k, dim=1)
        i = i + lo
        if best_s is not None:
            s, j = torch.topk(torch.cat([best_s, s], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, j)
        best_s, best_i = s, i
        del c
    return best_i.cpu().numpy()


def vector_segments(np, name: str, matrix, per_seg: int, extra=None):
    """Segments of ``per_seg`` rows of ``matrix`` (views, no copy), each
    with one vector field ``vec`` (cosine)."""
    from elasticsearch_tpu_torch.index.segment import Segment, VectorField
    segs = []
    for i in range(matrix.shape[0] // per_seg):
        m = matrix[i * per_seg: (i + 1) * per_seg]
        seg = Segment(f"{name}{i}", per_seg)
        seg.vectors["vec"] = VectorField(
            matrix=m, exists=np.ones(per_seg, bool),
            norms=np.linalg.norm(m, axis=1).astype(np.float32),
            similarity="cosine", dims=m.shape[1])
        seg.ids = [str(j) for j in range(per_seg)]
        seg.invalidate_live_count()
        segs.append(seg)
    return segs


def ivf_leg(torch, np, dev, name, reader, mappers, ctxs, queries, oracle,
            exact, doc_base, list_len: int, nprobe: int, n_batch: int):
    """One nprobe of the sweep: solo query_shard for every query (p50/p99
    wall, recall@10 against the float64 oracle and against the exact K5
    answers), then the first ``n_batch`` as one batched_knn_shard (3 timed
    runs); device time, launches and the kernel-busy share around it."""
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batch_executor import (
        BatchSpec, batched_knn_shard,
    )
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    from elasticsearch_tpu_torch.search.phase import query_shard
    nc = nprobe * list_len
    vecs = [q.tolist() for q in queries]
    fams = IVF_FAMILIES + KNN_FAMILIES
    DEVICE_PROFILE.timing = dev.type == "cuda"
    ms0, n0 = device_ms(fams), DEVICE_PROFILE.launches()
    times, hits, hits_k5 = [], 0, 0
    for qi, v in enumerate(vecs):
        t = time.monotonic()
        res = query_shard(reader, mappers, dsl.Knn(
            field="vec", query_vector=v, k=10, num_candidates=nc),
            size=10, device=dev)
        times.append(time.monotonic() - t)
        got = {int(doc_base[d.segment_idx]) + d.doc for d in res.docs}
        hits += len(got & set(oracle[qi].tolist()))
        hits_k5 += len(got & set(exact[qi].tolist()))
    specs = [BatchSpec(kind="knn", field="vec", window=10, query_vector=v,
                       k=10, num_candidates=nc) for v in vecs[:n_batch]]
    batched_knn_shard(ctxs, "vec", specs, 10)             # warm-up
    b_times = []
    for _rep in range(3):
        t = time.monotonic()
        batched_knn_shard(ctxs, "vec", specs, 10)
        b_times.append(time.monotonic() - t)
    DEVICE_PROFILE.timing = False
    ms1, n1 = device_ms(fams), DEVICE_PROFILE.launches()
    kern = {f: round(ms1[f] - ms0[f], 4) for f in fams if ms1[f] > ms0[f]}
    launched = {f: n1.get(f, 0) - n0.get(f, 0) for f in fams}
    busy = sum(kern.values()) / max(1e3 * (sum(times) + sum(b_times)), 1e-9)
    recall = hits / (10 * len(vecs))
    log(f"ivf-full: {name} nprobe={nprobe} (num_candidates {nc}): "
        f"recall@10 {recall:.4f} (against the exact K5 answers "
        f"{hits_k5 / (10 * len(vecs)):.4f}); solo p50 {1e3 * pct(times, 0.5):.3f} ms "
        f"p99 {1e3 * pct(times, 0.99):.3f} ms over {len(times)} queries; "
        f"{n_batch}-query batch p50 {1e3 * pct(b_times, 0.5):.3f} ms "
        f"({1e3 * pct(b_times, 0.5) / n_batch:.4f} ms a query); kernel "
        f"device ms {kern}; launches {launched}; kernel-busy share "
        f"{busy:.4f}")
    return recall, launched


def add_tag_column(np, segs, doc_base, n_tags: int = 100):
    """A keyword ``tag`` on every doc: t(global doc * 7919 mod n_tags)."""
    from elasticsearch_tpu_torch.index.segment import KeywordField
    names = [f"t{i}" for i in range(n_tags)]
    tags = []
    for pos, seg in enumerate(segs):
        glob = np.arange(seg.n_docs, dtype=np.int64) + int(doc_base[pos])
        ords = (glob * 7919 % n_tags).astype(np.int32)
        seg.keywords["tag"] = KeywordField(
            {t: i for i, t in enumerate(names)}, ords,
            np.arange(seg.n_docs + 1, dtype=np.int32),
            np.bincount(ords, minlength=n_tags).astype(np.int32), names)
        tags.append(ords)
    return np.concatenate(tags)


class FilteredOracle:
    """Exact filtered cosine top-16 (ids, float64 scores) of every query
    over the docs whose tag is in a set, computed once per set."""

    def __init__(self, np, unit_rows, tags, q_unit):
        self.np, self.rows, self.tags, self.q = np, unit_rows, tags, q_unit
        self.cache = {}

    def __call__(self, qi: int, wanted):
        np = self.np
        key = tuple(wanted)
        if key not in self.cache:
            docs = np.nonzero(np.isin(self.tags, wanted))[0]
            sims = self.rows[docs] @ self.q.T            # [docs, Q]
            top = np.argsort(-sims, axis=0, kind="stable")[:16]
            self.cache[key] = (docs[top], np.take_along_axis(sims, top, 0))
        ids, sc = self.cache[key]
        return ids[:, qi], sc[:, qi]


def same_as_oracle(got, ids, scores) -> bool:
    """``got`` (global ids, served order) equals the oracle's top-10, but
    for swaps within a near-tie (float64 scores within 1e-6 relative): the
    filtered route is exact, so recall is 1.0 under the same rule."""
    if len(got) != min(10, len(ids)):
        return False
    tol = 1e-6 * max(abs(float(scores[0])), 1e-30) if len(scores) else 0.0
    pos = {int(d): j for j, d in enumerate(ids)}
    for j, g in enumerate(got):
        if g == ids[j]:
            continue
        jj = pos.get(int(g))
        if jj is None or abs(scores[jj] - scores[j]) > tol:
            return False
    return True


def phase_ivf_full(torch, np, dev, shared, n_docs: int, n_q: int) -> None:
    """BASELINE #3's shape: one GIST1M-shaped shard (bench.py cfg_ivf's
    envelope: 1,048,576 x 960 f32, 1,024 Gaussian means, 0.35 noise) in 4
    segments of 262,144, cosine, no index_options -- so the default route
    takes IVF -- 128 queries, k 10, num_candidates swept so the derived
    nprobe covers 16..256: the plane route (one shard-level IVF, nlist
    4,096) and the per-segment route (four IVFs, nlist 2,048). Then
    filtered kNN on the knn-full SIFT shard with a keyword tag: filters at
    10 % and 1 % selectivity, one shared mask and 64 distinct masks,
    against a host filtered exact oracle."""
    from elasticsearch_tpu_torch.index.engine import Reader
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.ops.knn import KnnExecutor
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batch_executor import (
        BatchSpec, _build_ctxs, batched_knn_shard,
    )
    from elasticsearch_tpu_torch.search.execute import (
        ANN_DEFAULT_MIN_DOCS, ann_segment_route,
    )
    from elasticsearch_tpu_torch.search.phase import query_shard
    check("sift" in shared, "ivf-full needs the knn-full phase in the same "
          "run (its filtered leg runs on that shard)")
    import gc
    per_seg = n_docs // 4
    t0 = time.monotonic()
    corpus_dev, queries_dev = gist_shaped(torch, dev, 4 * per_seg, n_q)
    oracle = cosine_oracle(torch, corpus_dev, queries_dev)
    corpus = corpus_dev.cpu().numpy()
    queries = queries_dev.cpu().numpy()
    del corpus_dev, queries_dev
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    segs = vector_segments(np, "gist", corpus, per_seg)
    # full size: no index_options, the default route takes IVF; a
    # rehearsal's small segments are mapped type ivf to take it too
    vec = {"type": "dense_vector", "dims": GIST_DIMS, "similarity": "cosine"}
    if per_seg < ANN_DEFAULT_MIN_DOCS:
        vec["index_options"] = {"type": "ivf"}
    mappers = MapperService({"properties": {"vec": vec}})
    reader = Reader(segs)
    doc_base = np.arange(4, dtype=np.int64) * per_seg
    log(f"ivf-full: {4 * per_seg} docs x {GIST_DIMS} dims (1,024 Gaussian "
        f"means, 0.35 noise) in 4 segments, {n_q} queries, exact oracle "
        f"in float64, made in {time.monotonic() - t0:.1f}s; mapping {vec}")
    routes = {}
    keep = (PLANES.enabled, PLANES.quantized)
    try:
        # the plane route: one shard-level IVF over the plane
        PLANES.clear()
        PLANES.enabled = True
        t1 = time.monotonic()
        part = PLANES.get(segs, "vectors", "vec", dev)
        check(part is not None, "ivf-full: the vector plane was refused")
        plane_bytes = part.nbytes
        t2 = time.monotonic()
        index, _rows = part.ivf_index(None)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build_s = time.monotonic() - t2
        check(index is not None and part.nbytes > plane_bytes,
              "ivf-full: the shard-level IVF index was not built")
        log(f"ivf-full: plane route: plane {plane_bytes} bytes resident in "
            f"{t2 - t1:.1f}s; shard IVF nlist {index.nlist} list_len "
            f"{index.list_len} built in {build_s:.1f}s (k-means + packing), "
            f"{index._charge.n_bytes} bytes resident "
            f"({index._charge.n_bytes / plane_bytes:.3f} x the exact plane)")
        # the exact answers with the served arithmetic (K5: bf16 operands,
        # f32 sums) -- what any probe could reach at best
        _s, d_exact = KnnExecutor(part).top_k_batch(
            queries, part.live_mask(reader.live_masks), 10)
        exact = d_exact.cpu().numpy()
        ceiling = np.mean([len(set(exact[i]) & set(oracle[i])) / 10
                           for i in range(n_q)])
        log(f"ivf-full: the exact K5 answers' recall@10 against the float64 "
            f"oracle (bf16 operands): {ceiling:.4f}")
        ctxs = _build_ctxs(reader, mappers, None, None, device=dev)
        routes["plane"] = [ivf_leg(
            torch, np, dev, "plane", reader, mappers, ctxs, queries, oracle,
            exact, doc_base, index.list_len, nprobe, min(64, n_q))
            for nprobe in NPROBES]
        del index, part, ctxs
        PLANES.clear()
        gc.collect()
        # the per-segment route: one IVF per segment
        PLANES.enabled = False
        ctxs = _build_ctxs(reader, mappers, None, None, device=dev)
        t2 = time.monotonic()
        seg_idx = []
        for ctx in ctxs:
            route = ann_segment_route(ctx, "vec", 10, 100)
            check(route is not None and route[0] is not None,
                  "ivf-full: a segment's IVF index was not built")
            seg_idx.append(route[0])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        log(f"ivf-full: per-segment route: {len(seg_idx)} IVF indexes "
            f"(nlist {seg_idx[0].nlist}, list_len {seg_idx[0].list_len}) "
            f"built in {time.monotonic() - t2:.1f}s, "
            f"{sum(i._charge.n_bytes for i in seg_idx)} bytes resident")
        routes["per_segment"] = [ivf_leg(
            torch, np, dev, "per-segment", reader, mappers, ctxs, queries,
            oracle, exact, doc_base, seg_idx[0].list_len, nprobe,
            min(64, n_q)) for nprobe in NPROBES]
        del seg_idx, ctxs
    finally:
        PLANES.enabled, PLANES.quantized = keep
    for seg in segs:
        seg._device_cache.clear()
    del segs, reader, corpus
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for name, legs in routes.items():
        for (recall, launched), nprobe in zip(legs, NPROBES):
            if dev.type == "cuda":
                check(launched["ivf_search"] > 0,
                      f"ivf-full: {name} nprobe {nprobe}: no ivf_search")
                check(launched["knn_flat"] == 0,
                      f"ivf-full: {name} nprobe {nprobe}: knn_flat launched "
                      f"for unfiltered members of an IVF-routed field")
    for name, legs in routes.items():
        # BASELINE #3's bar, as bench.py sweeps it: the first nprobe whose
        # recall@10 reaches 0.95 (a rehearsal's few docs a cluster are
        # another regime, whose recall is only printed)
        reached = [nprobe for (recall, _l), nprobe in zip(legs, NPROBES)
                   if recall >= 0.95]
        log(f"ivf-full: {name} route: recall@10 >= 0.95 first at nprobe "
            f"{reached[0] if reached else None}")
        if n_docs >= GIST_DOCS:
            check(bool(reached), f"ivf-full: the {name} route never "
                  f"reached recall@10 0.95")

    # filtered kNN on the SIFT1M-shaped shard: exact, so equal to an oracle
    segs, sift_q, _answers = shared["sift"]
    counts = [s.n_docs for s in segs]
    sift_base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tags = add_tag_column(np, segs, sift_base)
    unit = np.concatenate([s.vectors["vec"].matrix for s in segs]).astype(
        np.float64)
    unit /= np.maximum(np.linalg.norm(unit, axis=1, keepdims=True), 1e-300)
    q_unit = sift_q.astype(np.float64)
    q_unit /= np.linalg.norm(q_unit, axis=1, keepdims=True)
    mappers = MapperService({"properties": {"tag": {"type": "keyword"},
                                            "vec": {
        "type": "dense_vector", "dims": SIFT_DIMS, "similarity": "cosine",
        "index_options": {"type": "flat"}}}})
    reader = Reader(segs)
    ctxs = _build_ctxs(reader, mappers, None, None, device=dev)
    oracle_f = FilteredOracle(np, unit, tags, q_unit)
    vecs = [q.tolist() for q in sift_q]
    n_f = len(vecs)

    def filt(sel: str, qi: int, shared_mask: bool):
        i = 0 if shared_mask else qi
        names = [f"t{(i + j) % 100}" for j in range(10 if sel == "10%"
                                                    else 1)]
        body = {"terms": {"tag": names}}
        return body, [int(t[1:]) for t in names]

    PLANES.clear()
    keep = (PLANES.enabled, PLANES.quantized)
    checked = 0
    try:
        PLANES.enabled = True
        for quantized in (True, False):
            PLANES.quantized = quantized
            for sel in ("10%", "1%"):
                for shared_mask in (True, False):
                    bodies = [filt(sel, qi, shared_mask) for qi in range(n_f)]
                    specs = [BatchSpec(
                        kind="knn", field="vec", window=10, query_vector=v,
                        k=10, num_candidates=100,
                        filter=dsl.parse_query(b), filter_key=repr(b))
                        for v, (b, _w) in zip(vecs, bodies)]
                    stats = {}
                    t = time.monotonic()
                    out = batched_knn_shard(ctxs, "vec", specs, 10,
                                            stats=stats)
                    wall = time.monotonic() - t
                    for qi, c in enumerate(out):
                        got = [int(sift_base[d.segment_idx]) + d.doc
                               for d in c[0]]
                        ids, sc = oracle_f(qi, bodies[qi][1])
                        check(same_as_oracle(got, ids, sc),
                              f"ivf-full: filtered {sel} (shared "
                              f"{shared_mask}, quantized {quantized}) query "
                              f"{qi} differs from the filtered oracle")
                        checked += 1
                    log(f"ivf-full: filtered SIFT {sel} selectivity, "
                        f"{'one shared mask' if shared_mask else f'{n_f} distinct masks'}"
                        f", quantized tier {'on' if quantized else 'off'}: "
                        f"{n_f} queries equal to the filtered exact oracle "
                        f"(recall 1.0); batch wall {1e3 * wall:.1f} ms; "
                        f"stats {stats}")
        for qi in range(4):                     # the solo filtered path
            b, w = filt("1%", qi, False)
            res = query_shard(reader, mappers, dsl.Knn(
                field="vec", query_vector=vecs[qi], k=10, num_candidates=100,
                filter=dsl.parse_query(b)), size=10, device=dev)
            ids, sc = oracle_f(qi, w)
            check(same_as_oracle([int(sift_base[d.segment_idx]) + d.doc
                                  for d in res.docs], ids, sc),
                  f"ivf-full: solo filtered query {qi} differs from the "
                  f"oracle")
            checked += 1
    finally:
        PLANES.enabled, PLANES.quantized = keep
        for seg in segs:
            seg.keywords.pop("tag", None)
            seg._filter_cache.clear()
    log(f"ivf-full: {checked} filtered answers equal to the host filtered "
        f"exact oracle")


def ivf_size(family: str, args):
    """The size a recorded call is ranked by: rows x lists for the build
    kernels, queries x probed slots for the probe, (B, N or k', k) for the
    masked kNN kernels."""
    if family == "ivf_assign":
        return args[0].shape[0] * args[1].shape[0]
    if family == "ivf_update":
        return args[0].numel()
    if family == "ivf_init":
        return args[0].shape[0] * args[2]
    if family == "ivf_search":
        return args[0].shape[0] * args[9] * args[4].shape[1]
    return knn_size(family[: -len("_masked")], args)


def ivf_group(family: str, args):
    """The probe's solo calls (one query row) are kept apart from its
    batched ones, so both sizes are timed."""
    return family == "ivf_search" and args[0].shape[0] == 1


def masks_of(family: str, args, kwargs):
    return kwargs.get("masks", args[MASK_POS[family]]
                      if len(args) > MASK_POS[family] else None)


def ivf_bound(torch, family: str, args):
    """(bound_ms, bound_by, bytes) as knn_bound: each input read once, each
    output written once, over 3.35 TB/s; or the operations over the peak
    rate of their type, whichever is larger. The probe counts the lists
    this call's queries actually probe (their centroid pass, run on the
    plain version), each once."""
    if family == "ivf_assign":
        x, c = args[0], args[1]
        n, d = x.shape
        nl = c.shape[0]
        nbytes = n * d * 4 + nl * d * 4 + n * 4
        t_ops = 2 * n * nl * d / BF16_FLOPS
    elif family == "ivf_update":
        x, c = args[0], args[2]
        n, d = x.shape
        nl = c.shape[0]
        nbytes = n * d * 4 + n * 4 + 2 * nl * d * 4
        t_ops = n * d / F32_FLOPS
    elif family == "ivf_init":
        x, nl = args[0], args[2]
        n, d = x.shape
        nbytes = n * d * 4 + nl * d * 4
        t_ops = 3 * (nl - 1) * n * d / F32_FLOPS      # sub, mul, add
    elif family == "ivf_search":
        from elasticsearch_tpu_torch.ops import bm25
        from elasticsearch_tpu_torch.ops.knn import _flat_dots
        q, cents, lists, k, nprobe = args[0], args[3], args[4], args[8], \
            args[9]
        b, d = q.shape
        nl, L = lists.shape[0], lists.shape[1]
        scores = _flat_dots(cents, q)
        probes = bm25.stable_topk(scores, nprobe)[1]
        n_lists = int(torch.unique(probes).numel())
        nbytes = b * d * 4 + b * 8 + nl * d * 4 + n_lists * L * (d * 4 + 9) \
            + b * k * 8
        t_ops = (2 * b * nl * d + 2 * b * nprobe * L * d) / BF16_FLOPS + \
            8 * b * nprobe * L / F32_FLOPS
    else:
        base = family[: -len("_masked")]
        nbytes = knn_bound(base, args)[2]
        if base == "knn_rerank":
            b, kp = args[6].shape
            d = args[0].shape[1]
            nbytes += b * kp                     # the mask at the candidates
            t_ops = 2 * b * kp * d / BF16_FLOPS + 8 * b * kp / F32_FLOPS
        else:
            b, n = args[MASK_POS[family]].shape
            d = args[0].shape[1]
            nbytes += b * n                      # the mask stack
            t_ops = 2 * b * n * d / (INT8_OPS if base == "knn_coarse"
                                     else BF16_FLOPS) + 8 * b * n / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def ivf_library_ms(torch, family: str, args):
    """One PyTorch call computing the same function where there is one:
    torch.matmul in bf16 for ivf_assign's product (the product alone) and
    Tensor.index_add_ for ivf_update's per-cluster sums (the sums alone);
    none for the others."""
    if family == "ivf_assign":
        a = args[0].to(torch.bfloat16)
        c = args[1].to(torch.bfloat16).t()
        return time_call(torch, lambda: torch.matmul(a, c), 5)
    if family == "ivf_update":
        x, idx = args[0], args[1].long()
        out = torch.zeros_like(args[2])
        return time_call(torch, lambda: out.zero_().index_add_(0, idx, x), 5)
    return None


IVF_PATH_FAMILIES = IVF_FAMILIES + MASKED


def phase_ivf_kernels(torch, rec, launches) -> list:
    """Each IVF-path family held against its plain version at the main
    path's largest call (and up to four others), then timed beside its
    bound and, where one exists, its library yardstick."""
    from elasticsearch_tpu_torch.ops import ivf, knn
    rows = []
    for fam in IVF_PATH_FAMILIES:
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        mod = ivf if fam in IVF_FAMILIES else knn
        name = fam if fam in IVF_FAMILIES else fam[: -len("_masked")]
        run = lambda a, kw, plain: getattr(  # noqa: E731
            mod, name + "_plain" if plain else name)(*a, **kw)
        err = 0.0
        largest = max(calls, key=lambda c: ivf_size(fam, c[0]))
        for args, kwargs in calls[:4] + [largest]:
            got = run(args, kwargs, False)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            want = run(args, kwargs, True)
            b.record()
            b.synchronize()
            last_plain_ms = a.elapsed_time(b)
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            err = max(err, compare(torch, fam, got, want))
            del got, want
        args, kwargs = largest
        slow = fam in ("ivf_init", "ivf_assign", "ivf_search")
        ms = time_call(torch, lambda: run(args, kwargs, False),
                       3 if fam == "ivf_init" else 20)
        # a slow plain version is timed once: its run on the largest call
        # above, after the others warmed it
        plain_ms = last_plain_ms if slow else time_call(
            torch, lambda: run(args, kwargs, True), 5)
        bound_ms, bound_by, nbytes = ivf_bound(torch, fam, args)
        lib_ms = ivf_library_ms(torch, fam, args)
        shape = ivf_shape(fam, args)
        row = {"name": fam, "route": "cuda",
               "source": f"elasticsearch_tpu_torch/csrc/{name}.cu",
               "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms, "shape": shape}
        extra = ""
        if fam in ("knn_flat_masked", "knn_coarse_masked"):
            prod_ms, used = product_only_ms(torch, name, args)
            row["product_only_library_ms"] = prod_ms
            extra = f", product-only library call {prod_ms:.4f} ms ({used} rows)"
        log(f"kernel {fam}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, {bound_by}), "
            f"library {lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"max_abs_err {err} over {min(len(calls), 4) + 1} main-path "
            f"calls, timed at the largest, {shape}{extra}")
        solo = [c for c in rec.largest_calls(fam) if ivf_group(fam, c[0])]
        if solo and solo[0] is not largest:
            s_args, s_kw = solo[0]            # the largest solo probe
            s_ms = time_call(torch, lambda: run(s_args, s_kw, False), 20)
            log(f"kernel {fam}: {s_ms:.4f} ms at the largest solo main-path "
                f"call, bound {ivf_bound(torch, fam, s_args)[0]:.4f} ms, "
                f"{ivf_shape(fam, s_args)}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def ivf_shape(family: str, args) -> str:
    if family in ("ivf_assign", "ivf_update"):
        x, c = args[0], args[1 if family == "ivf_assign" else 2]
        return f"n={x.shape[0]} nlist={c.shape[0]} dims={x.shape[1]}"
    if family == "ivf_init":
        return f"n={args[0].shape[0]} nlist={args[2]} dims={args[0].shape[1]}"
    if family == "ivf_search":
        return (f"n_q={args[0].shape[0]} nlist={args[4].shape[0]} "
                f"L={args[4].shape[1]} dims={args[0].shape[1]} "
                f"nprobe={args[9]} k={args[8]}")
    return f"(B, N or k', k) = {knn_size(family[: -len('_masked')], args)}"


# ---------------------------------------------------------------------------
# learned-sparse retrieval: K15-K19 against their plain versions, the
# engine path, the MS MARCO-shaped rank_features shard
# ---------------------------------------------------------------------------

SPARSE_FAMILIES = ("sparse_flat", "sparse_scores", "sparse_coarse",
                   "sparse_rerank", "text_expansion_forward")
SPARSE_FUNCTIONS = {"saturation": (0.7, 1.0), "log": (1.5, 1.0),
                    "sigmoid": (1.2, 0.6), "linear": (1.0, 1.0)}
# log and sigmoid: the kernel calls logf / powf, the plain version torch's
# CUDA log / pow; they may differ by an ulp in a contribution, and a
# fixed-point sum of positive contributions keeps the largest relative
# error of its terms: a score within 4 ulps (2^-21 relative), ids exact
SPARSE_RTOL = 2.0 ** -21
# K18: tanhf against torch's tanh moves a weight (anchors of 2.0 plus a
# normalized activation in [0, 1]) by far less than 4 ulps at [2, 4)
FORWARD_ATOL = 2.0 ** -20
SPARSE_VOCAB = 8192          # the default expansion model's features
SPARSE_WORDS = [f"word{i}" for i in range(400)]


def sparse_inputs(np, rng, n_docs: int, nb: int, n_q: int, per_q: int,
                  q_pad: int):
    """A seeded rank_features block store (doc ids ascending within a
    block, -1 padding, weights in [0.05, 3)) and [q_pad, QB] block lists
    of n_q queries, padded with block 0 / weight 0 slots and weight-0
    rows; block 7 repeats block 3's weights on the next docs and query 1
    lists both at one weight, so docs tie in pairs."""
    docs = np.sort(rng.integers(0, n_docs, (nb, 128)), axis=1).astype(np.int32)
    docs[rng.random((nb, 128)) < 0.1] = -1
    weights = np.where(docs >= 0, rng.uniform(0.05, 3.0, (nb, 128)),
                       0.0).astype(np.float32)
    docs[7] = np.where(docs[3] >= 0, docs[3] + 1, -1)
    weights[7] = weights[3]
    n_pad = 1 << max(7, math.ceil(math.log2(max(n_docs, 2))))
    live = np.zeros(n_pad, bool)
    live[:n_docs] = rng.random(n_docs) > 0.05
    qb = 1 << max(3, math.ceil(math.log2(per_q)))
    idx = np.zeros((q_pad, qb), np.int32)
    qw = np.zeros((q_pad, qb), np.float32)
    for q in range(n_q):
        n = int(rng.integers(per_q // 2, per_q + 1))
        idx[q, :n] = rng.integers(0, nb, n)
        qw[q, :n] = rng.uniform(0.1, 3.0, n)
    idx[1, :2] = (3, 7)
    qw[1, 1] = qw[1, 0]
    return docs, weights, idx, qw, live, n_pad


def sparse_texts(np, rng, n: int):
    """n seeded texts of 3-7 words out of 400 (bench.py cfg_sparse's
    query texts)."""
    return [" ".join(rng.choice(SPARSE_WORDS, size=int(rng.integers(3, 8))))
            for _ in range(n)]


def phase_sparse_small(torch, np, dev) -> None:
    """K15-K19 against their plain versions on the card: sparse_flat
    (K15, the four functions, counted and not, pow2 padding rows),
    sparse_scores (K19, with and without a live mask), sparse_coarse (K16)
    and sparse_rerank (K17) at 3,000 and 200,000 docs (the chunked top-k's
    merge pass), k' 64 and 1,024, tied docs; then K18 over the default
    model's widths at B 1, 13 and 64 and a ragged narrow model. Bitwise for
    linear, saturation, K16 and K17; within SPARSE_RTOL (ids exact) for
    log and sigmoid; K18's ids exact, weights within FORWARD_ATOL."""
    from elasticsearch_tpu_torch.ml import text_expansion as te
    from elasticsearch_tpu_torch.ops import sparse
    rng = np.random.default_rng(SEED + 31)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    n = 0
    errs = {"log": 0.0, "sigmoid": 0.0}
    for n_docs, nb, n_q, per_q, q_pad, kprime in (
            (3000, 96, 3, 20, 4, 64), (200_000, 4096, 5, 300, 8, 1024)):
        docs, weights, idx, qw, live, n_pad = sparse_inputs(
            np, rng, n_docs, nb, n_q, per_q, q_pad)
        bd, bw, bi, bq, lv = T(docs), T(weights), T(idx), T(qw), T(live)
        for function, (pivot, exponent) in SPARSE_FUNCTIONS.items():
            exact = function in ("saturation", "linear")
            for counted in (False, True):
                args = (bd, bw, bi, bq, pivot, exponent, lv, n_pad, 10,
                        function)
                got = sparse.sparse_topk_batch(*args, counted=counted)
                want = sparse.sparse_flat_plain(*args, counted=counted)
                torch.cuda.synchronize()
                err = compare(torch, f"sparse_flat {function} n_docs_pad="
                              f"{n_pad} counted={counted}", got, want, exact,
                              SPARSE_RTOL)
                check(bool(torch.isinf(got[0][n_q:]).all()),
                      "sparse_flat: a padding row matched")
                if function in errs:
                    errs[function] = max(errs[function], err)
                n += 1
            for lmask in (None, lv):
                args = (bd, bw, bi[1], bq[1], pivot, exponent, n_pad,
                        function, lmask)
                err = compare(torch, f"sparse_scores {function} n_docs_pad="
                              f"{n_pad}", [sparse.sparse_scores(*args)],
                              [sparse.sparse_scores_plain(*args)], exact,
                              SPARSE_RTOL)
                if function in errs:
                    errs[function] = max(errs[function], err)
                n += 1
        w16 = bw.to(torch.bfloat16)
        cargs = (bd, w16, bi, bq, lv, n_pad, kprime)
        coarse = sparse.sparse_coarse_kernel(*cargs)
        compare(torch, "sparse_coarse", coarse,
                sparse.sparse_coarse_plain(*cargs))
        cs, cand, _hits = coarse
        rargs = (bd, bw, bi, bq, lv, cand, cs, n_pad, kprime, 10)
        rerank = sparse.sparse_rerank_kernel(*rargs)
        compare(torch, "sparse_rerank", rerank,
                sparse.sparse_rerank_plain(*rargs))
        # the exact tier re-derives K15's linear bits for every candidate
        s15, d15 = sparse.sparse_topk_batch(bd, bw, bi, bq, 1.0, 1.0, lv,
                                            n_pad, kprime, "linear")
        for q in range(n_q):
            exact = dict(zip(d15[q].tolist(), s15[q].tolist()))
            for sc, d in zip(rerank[0][q].tolist(), rerank[1][q].tolist()):
                if math.isfinite(sc):
                    check(exact.get(d) == sc,
                          "sparse_rerank score != sparse_flat's")
        n += 3
        del bd, bw, w16
    fwd_err = 0.0
    gen = np.random.default_rng(SEED + 32)
    texts = sparse_texts(np, gen, 62) + ["fox fox fox dog dog", ""]
    for kw in ({}, dict(vocab_size=1500, hidden=48, n_hash=4096)):
        model = te.TextExpansionModel(model_id=f"smoke-{len(kw)}",
                                      device=dev, **kw)
        for b in (64, 13, 1):
            feats = [model._featurize(t) for t in texts[:b]]
            args = (T(np.stack([f[0] for f in feats])),
                    T(np.stack([f[1] for f in feats])), model._emb,
                    model._w1, model._w2, model.top_m)
            w, f = te.text_expansion_forward(*args)
            pw, pf = te.text_expansion_forward_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(f, pf), f"text_expansion_forward B={b} "
                  f"{kw}: feature ids differ from the plain version")
            err = float((w - pw).abs().max())
            check(err <= FORWARD_ATOL, f"text_expansion_forward B={b}: "
                  f"weights differ by {err} > {FORWARD_ATOL}")
            fwd_err = max(fwd_err, err)
            n += 1
    log(f"sparse-small: {n} kernel calls equal to their plain versions "
        f"(linear, saturation, sparse_coarse, sparse_rerank bitwise; max "
        f"|diff| log {errs['log']}, sigmoid {errs['sigmoid']} within "
        f"rtol 2^-21, ids exact; text_expansion_forward ids exact, max "
        f"weight |diff| {fwd_err} within 2^-20)")


SPARSE_MAPPING = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "ml": {"type": "rank_features"}, "pr": {"type": "rank_feature"}}}


def build_sparse_engine(np, dev, n_docs: int):
    """``InternalEngine`` with n_docs seeded texts; ``ml`` holds the port
    model's expansion of each (one text_expansion_forward launch on
    ``dev`` for all), ``pr`` a rank_feature, ``tag`` a keyword; three
    segments, 20 deletes. Returns (engine, texts, expansions)."""
    from elasticsearch_tpu_torch.index import InternalEngine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ml import get_model
    rng = np.random.default_rng(SEED + 41)
    texts = sparse_texts(np, rng, n_docs)
    t0 = time.monotonic()
    feats = get_model(None, dev).expand_batch(texts)
    engine = InternalEngine(MapperService(SPARSE_MAPPING),
                            shard_label="sparse")
    cuts = {n_docs // 3, 2 * n_docs // 3}
    for i, (text, f) in enumerate(zip(texts, feats)):
        engine.index(str(i), {"body": text, "tag": f"t{i % 5}", "ml": f,
                              "pr": float(1 + (i * 7) % 23)})
        if i in cuts:
            engine.refresh()
    engine.refresh()
    for i in rng.choice(n_docs, 20, replace=False):
        engine.delete(str(int(i)))
    engine.refresh()
    reader = engine.acquire_reader()
    log(f"sparse-engine: {n_docs} docs in {len(reader.segments)} segments, "
        f"expanded and indexed in {time.monotonic() - t0:.1f}s")
    check(len(reader.segments) >= 2, "sparse-engine: fewer than 2 segments")
    return engine, texts, feats


def sparse_engine_bodies(texts, feats):
    """text_expansion with model_text and with tokens (boost, paging,
    exact and limited totals), the four rank_feature functions, and both
    inside bool with a filter, a should and a must_not."""
    def te(**opts):
        return {"text_expansion": {"ml": opts}}
    common = max(feats[0], key=feats[0].get)     # an anchor of doc 0
    out = [{"query": te(model_text=t)} for t in texts[5:9]]
    out += [
        {"query": te(model_text="word3 word17 word9 word150"), "size": 20},
        {"query": te(tokens=feats[42])},
        {"query": te(tokens=feats[7], boost=2.0), "from": 5, "size": 10},
        {"query": te(model_text=texts[11]), "track_total_hits": True},
        {"query": te(tokens=feats[42]), "track_total_hits": 5},
        {"query": {"rank_feature": {"field": f"ml.{common}",
                                    "saturation": {"pivot": 0.5}}}},
        {"query": {"rank_feature": {"field": "pr",
                                    "log": {"scaling_factor": 2.0}}}},
        {"query": {"rank_feature": {"field": "pr", "sigmoid": {
            "pivot": 7.0, "exponent": 0.6}}}},
        {"query": {"rank_feature": {"field": f"ml.{common}", "linear": {},
                                    "boost": 3.0}}},
        {"query": {"bool": {"must": [te(model_text=texts[3])],
                            "filter": [{"term": {"tag": "t2"}}]}},
         "track_total_hits": True},
        {"query": {"bool": {
            "must": [te(tokens=feats[9])],
            "should": [{"rank_feature": {"field": "pr", "saturation": {
                "pivot": 8.0}}}],
            "must_not": [{"term": {"tag": "t4"}}]}}},
    ]
    return out


def phase_sparse_engine(torch, np, dev, built) -> None:
    """The sparse path through SearchService on the card and on the CPU:
    every body with the planes on and off and the quantized tier on and
    off, plus _count. Responses equal in ids, score bits, totals and
    max_score. A model_text body is expanded by each side's model; where
    the two rewrites round a weight to different 4-decimal tokens (K18 and
    the CPU plain version may differ by an ulp before rounding), the count
    of such bodies is printed and the card is held to the CPU's tokens."""
    from elasticsearch_tpu_torch.ml.text_expansion import (
        rewrite_body_expansions,
    )
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import SearchService
    engine, texts, feats = built
    on_dev = SearchService(engine, index_name="smoke", device=dev)
    on_cpu = SearchService(engine, index_name="smoke", device="cpu")
    bodies = sparse_engine_bodies(texts, feats)
    n, rounded_apart = 0, 0
    t_dev = []
    try:
        for enabled, quantized in ((True, True), (True, False),
                                   (False, True), (False, False)):
            PLANES.enabled, PLANES.quantized = enabled, quantized
            PLANES.clear()
            for body in bodies:
                body = {**body, "_source": False}
                cpu_body = rewrite_body_expansions(body, "cpu")
                if rewrite_body_expansions(body, dev) != cpu_body:
                    rounded_apart += 1
                    body = cpu_body
                t1 = time.monotonic()
                a = on_dev.search(body)
                t_dev.append(time.monotonic() - t1)
                b = on_cpu.search(body)
                check(same_hits(a, b), f"sparse-engine: card != cpu for "
                      f"{body} (planes {enabled}, tier {quantized})")
                n += 1
    finally:
        PLANES.enabled, PLANES.quantized = True, True
    for body in bodies[:6] + bodies[-2:]:
        query = {"query": rewrite_body_expansions(body, "cpu")["query"]}
        check(on_dev.count(query) == on_cpu.count(query),
              f"sparse-engine: _count differs for {body}")
        n += 1
    log(f"sparse-engine: {n} responses equal on {dev} and cpu (score bits "
        f"included; {rounded_apart} model_text bodies whose two rewrites "
        f"rounded a weight apart, served from the CPU's tokens); {dev} "
        f"_search latency p50 {1e3 * pct(t_dev, 0.5):.2f} ms p99 "
        f"{1e3 * pct(t_dev, 0.99):.2f} ms")


def build_sparse_segment(args):
    """One segment's rank_features (run in a worker process): bench.py
    cfg_sparse's corpus (``build_zipf_postings(n, 8192, max_len=24)``:
    16..23 tokens a doc, drawn Zipf(1.35) and folded onto the model's
    8,192 features, duplicates merged) with weights uniform in [0, 3)."""
    seed, n = args
    import numpy as np
    from elasticsearch_tpu_torch.index.segment import (
        FeaturesField, postings_from_token_matrix,
    )
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 24, n)
    toks = rng.zipf(1.35, size=(n, 24)) - 1
    toks = np.where(toks < SPARSE_VOCAB, toks,
                    toks % SPARSE_VOCAB).astype(np.int32)
    toks[np.arange(24)[None, :] >= lens[:, None]] = -1
    pf = postings_from_token_matrix(toks)
    del toks
    weights = np.where(pf.block_docs >= 0,
                       rng.random(pf.block_tfs.shape, np.float32) * 3.0,
                       0.0).astype(np.float32)
    return FeaturesField(
        features={f"f{i}": i for i in range(len(pf.doc_freq))},
        block_docs=pf.block_docs, block_weights=weights,
        block_max_weight=weights.max(axis=1).astype(np.float32),
        feat_block_start=pf.term_block_start,
        feat_block_count=pf.term_block_count, doc_freq=pf.doc_freq)


def build_sparse_shard(np, n_docs: int, workers: int):
    import multiprocessing as mp
    from elasticsearch_tpu_torch.index.segment import Segment
    sizes = [n_docs // 4 + (1 if i < n_docs % 4 else 0) for i in range(4)]
    jobs = [(SEED + 200 + i, n) for i, n in enumerate(sizes)]
    if workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            ffs = pool.map(build_sparse_segment, jobs)
    else:
        ffs = [build_sparse_segment(j) for j in jobs]
    segs = []
    for i, (ff, n) in enumerate(zip(ffs, sizes)):
        seg = Segment(f"sparse{i}", n)
        seg.features["ml"] = ff
        seg.ids = [str(j) for j in range(n)]
        seg.invalidate_live_count()
        segs.append(seg)
    return segs


def sparse_oracle(np, segs, tokens, k: int = 10):
    """The float64 host answer of one expansion: each segment's postings
    of the query's features gathered and summed per doc with np.bincount
    (query weights rounded to f32, as the port sends them). Returns
    (top-k [(seg, doc, score)] by score desc, seg, doc; live matches)."""
    cands, total = [], 0
    for si, seg in enumerate(segs):
        ff = seg.features["ml"]
        docs, contrib = [], []
        for name, qw in tokens.items():
            start, count = ff.feature_blocks(name)
            if not count:
                continue
            bd = ff.block_docs[start: start + count].ravel()
            bw = ff.block_weights[start: start + count].ravel()
            m = bd >= 0
            docs.append(bd[m])
            contrib.append(float(np.float32(qw)) * bw[m].astype(np.float64))
        if not docs:
            continue
        acc = np.bincount(np.concatenate(docs), np.concatenate(contrib),
                          minlength=seg.n_docs)
        matched = (acc > 0) & seg.live[: seg.n_docs]
        total += int(matched.sum())
        hit = np.nonzero(matched)[0]
        if len(hit) > k:
            hit = hit[np.argpartition(-acc[hit], k)[:k]]
        cands += [(si, int(d), float(acc[d])) for d in hit]
    cands.sort(key=lambda c: (-c[2], c[0], c[1]))
    return cands[:k], total


def close_to_oracle(want, got, rtol: float = 1e-6) -> bool:
    """``got`` [(seg, doc, f32 score)] against the float64 oracle's top-k:
    scores within rtol, ids equal except inside a near-tie (oracle scores
    within 2 rtol of each other), a tie group at the cut only as long."""
    if len(want) != len(got):
        return False
    for (_s, _d, w), (_t, _e, g) in zip(want, got):
        if abs(g - w) > rtol * abs(w):
            return False
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and \
                abs(want[j][2] - want[i][2]) <= 2 * rtol * abs(want[i][2]):
            j += 1
        if j < len(want) and {c[:2] for c in want[i:j]} != \
                {c[:2] for c in got[i:j]}:
            return False
        i = j
    return True


def phase_sparse_full(torch, np, dev, n_docs: int, workers: int, n_q: int):
    """BASELINE #5 at MS MARCO passage scale in the JAX package's own form
    (bench.py cfg_sparse): 8,841,823 docs in 4 segments, 16-23 features a
    doc drawn Zipf(1.35) over the default model's 8,192, weights in [0, 3);
    n_q raw texts of 3-7 words out of 400 sent as text_expansion with
    model_text. Legs: (a) solo, tier on: the coordinator rewrite (K18 at
    B 1) and query_shard (K16 + K17); (b) the batch: one expand_batch of
    every text (K18 at B n_q, cache cleared) and one batched_sparse_shard
    on the exact plane (K15), x3; (c) the same per segment (K15 per
    segment), x3; (d) solo dense with exact totals (K19 + K10 per
    segment). All legs agree in ids and score bits, totals equal the host
    count, top-10 equals a float64 host oracle up to near-ties."""
    from elasticsearch_tpu_torch.index.engine import Reader
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ml import get_model
    from elasticsearch_tpu_torch.ml.text_expansion import (
        rewrite_body_expansions,
    )
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batch_executor import (
        BatchSpec, _build_ctxs, batched_sparse_shard,
    )
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    from elasticsearch_tpu_torch.search.phase import query_shard
    on_card = dev.type == "cuda"

    t0 = time.monotonic()
    segs = build_sparse_shard(np, n_docs, workers)
    n_post = sum(int((s.features["ml"].block_docs >= 0).sum()) for s in segs)
    n_blocks = sum(s.features["ml"].block_docs.shape[0] for s in segs)
    log(f"sparse-full: {n_docs} docs in {len(segs)} segments, {n_post} "
        f"postings in {n_blocks} blocks, built in "
        f"{time.monotonic() - t0:.1f}s")
    mappers = MapperService({"properties": {"ml": {"type": "rank_features"}}})
    reader = Reader(segs)
    PLANES.clear()
    t1 = time.monotonic()
    part = PLANES.get(segs, "features", "ml", dev)
    check(part is not None, "sparse-full: the features plane was refused")
    check(part.quantized_mirror() is not None,
          "sparse-full: the bf16 mirror was refused")
    if on_card:
        torch.cuda.synchronize()
    log(f"sparse-full: plane n_docs_pad={part.n_docs_pad} n_blocks_pad="
        f"{part.block_docs.shape[0]} resident bytes {part.nbytes} "
        f"(block_docs + block_weights, bf16 mirror); built+uploaded in "
        f"{time.monotonic() - t1:.1f}s")

    texts = sparse_texts(np, np.random.default_rng(SEED + 51), n_q)
    model = get_model(None, dev)
    model._cache.clear()
    ctxs = _build_ctxs(reader, mappers, sum(s.n_docs for s in segs), None,
                       device=dev)
    DEVICE_PROFILE.timing = on_card
    legs, results, kern, launched = {}, {}, {}, {}

    def run_leg(name, fn, reps: int = 1):
        n0 = DEVICE_PROFILE.launches()
        ms0 = device_ms(SPARSE_FAMILIES + ("dense_topk",))
        times = []
        for _rep in range(reps):
            t = time.monotonic()
            out = fn()
            if on_card:
                torch.cuda.synchronize()
            times.append(time.monotonic() - t)
        ms1 = device_ms(SPARSE_FAMILIES + ("dense_topk",))
        n1 = DEVICE_PROFILE.launches()
        legs[name] = times
        kern[name] = {f: round(ms1[f] - ms0[f], 4) for f in ms1
                      if ms1[f] > ms0[f]}
        launched[name] = {f: n1.get(f, 0) - n0.get(f, 0) for f in n1
                          if n1.get(f, 0) > n0.get(f, 0)}
        return out

    solo_times = []

    def solo_tier():
        out, toks = [], []
        for text in texts:
            t = time.monotonic()
            body = rewrite_body_expansions({"query": {"text_expansion": {
                "ml": {"model_text": text}}}}, dev)
            toks.append(body["query"]["text_expansion"]["ml"]["tokens"])
            out.append(query_shard(reader, mappers,
                                   dsl.parse_query(body["query"]), size=10,
                                   device=dev))
            solo_times.append(time.monotonic() - t)
        return out, toks

    def batch():
        model._cache.clear()
        specs = [BatchSpec(kind="sparse", field="ml", window=10, tokens=t)
                 for t in model.expand_batch(texts)]
        return batched_sparse_shard(ctxs, "ml", specs, 10)

    def dense():
        return [query_shard(reader, mappers, dsl.parse_query({
            "text_expansion": {"ml": {"tokens": t}}}), size=10,
            track_total_hits=True, device=dev) for t in tokens]

    try:
        stats0 = dict(PLANES.stats)
        solo, tokens = run_leg("a_solo_tier", solo_tier)
        served = PLANES.stats["quantized_queries"] - stats0[
            "quantized_queries"]
        fallbacks = PLANES.stats["quantized_exact_fallbacks"] - stats0[
            "quantized_exact_fallbacks"]
        PLANES.quantized = False
        results["b_batch_exact_plane"] = run_leg(
            "b_batch_exact_plane", batch, reps=3)
        PLANES.enabled = False
        results["c_batch_per_segment"] = run_leg(
            "c_batch_per_segment", batch, reps=3)
        PLANES.enabled = True
        results["d_dense_exact_totals"] = run_leg("d_dense_exact_totals",
                                                  dense)
    finally:
        PLANES.enabled, PLANES.quantized = True, True
        DEVICE_PROFILE.timing = False
    log(f"sparse-full: solo leg: the tier served {served} of {n_q} "
        f"queries, {fallbacks} exact fallbacks")
    check(model.expand_batch(texts) == tokens,
          "sparse-full: the batch expansion differs from the solo rewrites")
    if on_card:
        want = {"a_solo_tier": {"text_expansion_forward": len(set(texts))},
                "b_batch_exact_plane": {"text_expansion_forward": 3,
                                        "sparse_flat": 3},
                "c_batch_per_segment": {"text_expansion_forward": 3,
                                        "sparse_flat": 3 * len(segs)},
                "d_dense_exact_totals": {"sparse_scores": n_q * len(segs),
                                         "dense_topk": n_q * len(segs)}}
        for leg, per in want.items():
            for fam, count in per.items():
                check(launched[leg].get(fam, 0) == count,
                      f"sparse-full {leg}: {launched[leg].get(fam, 0)} "
                      f"{fam} launches, expected {count}")
        check(launched["a_solo_tier"].get("sparse_coarse", 0) >= served > 0
              and launched["a_solo_tier"].get("sparse_rerank", 0) >= served,
              "sparse-full: the solo leg did not run the coarse tier")
    n_exact_hits = 0
    for qi in range(n_q):
        base = [(d.segment_idx, d.doc, d.score) for d in solo[qi].docs]
        check(bool(base), f"sparse-full: query {qi} matched nothing")
        for leg in ("b_batch_exact_plane", "c_batch_per_segment"):
            cands = results[leg][qi][0]
            check([(c.segment_idx, c.doc, c.score) for c in cands[:10]]
                  == base, f"sparse-full: query {qi}: {leg} differs from "
                  f"the solo tier leg")
        res = results["d_dense_exact_totals"][qi]
        check([(d.segment_idx, d.doc, d.score) for d in res.docs] == base,
              f"sparse-full: query {qi}: the dense leg differs")
        top, host_total = sparse_oracle(np, segs, tokens[qi])
        check(close_to_oracle(top, base),
              f"sparse-full: query {qi}: top-10 differs from the float64 "
              f"oracle")
        totals = {res.total_hits} | {results[leg][qi][1] for leg in (
            "b_batch_exact_plane", "c_batch_per_segment")}
        check(totals == {host_total} and res.total_relation == "eq",
              f"sparse-full: query {qi}: totals {totals} != host count "
              f"{host_total}")
        check(solo[qi].total_hits == min(host_total, 10_000),
              f"sparse-full: query {qi}: solo total {solo[qi].total_hits}")
        n_exact_hits = max(n_exact_hits, host_total)
    log(f"sparse-full: {n_q} queries: the four legs agree in ids and score "
        f"bits, totals equal the host count (largest {n_exact_hits}), "
        f"top-10 equal to the float64 oracle up to near-ties")
    for leg, times in legs.items():
        busy = sum(kern[leg].values()) / max(1e3 * sum(times), 1e-9)
        if leg == "a_solo_tier":
            what = (f"solo p50 {1e3 * pct(solo_times, 0.5):.3f} ms p99 "
                    f"{1e3 * pct(solo_times, 0.99):.3f} ms (rewrite + "
                    f"query_shard)")
        else:
            what = (f"{len(times)} run(s) of {n_q} queries, p50 "
                    f"{1e3 * pct(times, 0.5):.3f} ms a run")
        log(f"sparse-full: leg {leg}: {what}; wall total "
            f"{1e3 * sum(times):.3f} ms; kernel device ms {kern[leg]}; "
            f"launches {launched[leg]}; kernel-busy share {busy:.4f}")
    return segs


def sparse_size(family: str, args):
    """(queries, gathered slots) of a sparse kernel call; B for K18."""
    if family == "text_expansion_forward":
        return args[0].shape[0], 0
    idx = args[2]
    return (idx.shape[0] if idx.dim() == 2 else 1), idx.numel()


def sparse_n_docs_pad(family: str, args) -> int:
    pos = {"sparse_flat": 7, "sparse_scores": 6, "sparse_coarse": 5,
           "sparse_rerank": 7}
    return args[pos[family]] if family in pos else 0


def sparse_real_slots(args) -> int:
    """Gathered slots of a call that carry a query weight (not padding)."""
    return int((args[3] != 0).sum())


def sparse_bound(torch, family: str, args):
    """(bound_ms, bound_by, bytes): each input read once and each output
    written once over the memory rate, or the arithmetic at the f32 peak,
    whichever is larger. Only the gathered blocks of real (weight != 0)
    slots count, and for K18 only the embedding rows of real ids."""
    if family == "text_expansion_forward":
        ids, direct, _emb, w1, w2, top_m = args
        b = ids.shape[0]
        hid, vocab = w1.shape[0], w2.shape[1]
        rows = int((ids != 0).sum())
        nbytes = (ids.numel() + direct.numel()) * 4 + rows * hid * 4 \
            + (w1.numel() + w2.numel()) * 4 + b * top_m * 8
        ops = 2 * b * hid * (hid + vocab) + rows * hid
    else:
        n_q = args[2].shape[0] if args[2].dim() == 2 else 1
        n_pad = sparse_n_docs_pad(family, args)
        postings = sparse_real_slots(args) * 128
        wb = args[1].element_size()
        nbytes = postings * (4 + wb) + args[2].numel() * 8
        flops = {"linear": 1, "saturation": 3, "log": 3, "sigmoid": 5}
        ops = postings * (1 if family in ("sparse_coarse", "sparse_rerank")
                          else flops[args[9] if family == "sparse_flat"
                                     else args[7]])
        if family == "sparse_flat":
            k = args[8]
            nbytes += n_pad + n_q * k * 8 + n_q * 4
        elif family == "sparse_scores":
            nbytes += n_pad * 5
        elif family == "sparse_coarse":
            nbytes += n_pad + n_q * args[6] * 8 + n_q * 4
        else:
            kprime, k = args[8], args[9]
            nbytes += n_q * kprime * (8 + 1) + n_q * k * 8 + n_q * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def sparse_plain_bytes(torch, family: str, args) -> int:
    """Rough peak device bytes of the plain version's temporaries: about
    64 a gathered posting and 64 a cell of its [n_q, n_docs_pad] plane
    (int64 sums and their f64 conversion, f32 scores, the stable sort's
    keys, int64 indices and scratch)."""
    if family == "text_expansion_forward":
        return args[0].shape[0] * args[4].shape[1] * 32
    n_q = args[2].shape[0] if args[2].dim() == 2 else 1
    plane = 0 if family == "sparse_rerank" else \
        n_q * sparse_n_docs_pad(family, args) * 64
    return sparse_real_slots(args) * 128 * 64 + plane


def sparse_library_ms(torch, family: str, args):
    """One PyTorch call computing part of the same function, where there
    is one: index_add_'s f32 sums of the call's real contributions into a
    zeroed [n_q, n_docs_pad] plane for K15 / K19 (the sums only: no
    transform, mask or top-k); torch.matmul of [B, H] rows by W2 and
    torch.topk over the [B, V] product for K18 (no embedding bag, W1,
    gelu, normalization or anchors). None for K16 / K17."""
    if family in ("sparse_coarse", "sparse_rerank"):
        return None
    if family == "text_expansion_forward":
        ids, _direct, _emb, w1, w2, top_m = args
        h = torch.randn(ids.shape[0], w1.shape[0], device=w2.device)
        return time_call(torch, lambda: torch.topk(torch.matmul(h, w2),
                                                   top_m), 20)
    docs, weights, idx, qw = args[:4]
    if idx.dim() == 1:
        idx, qw = idx[None], qw[None]
    n_pad = sparse_n_docs_pad(family, args)
    q_of, slot = torch.nonzero(qw != 0, as_tuple=True)
    blocks = idx[q_of, slot].long()
    d = docs[blocks]
    c = (qw[q_of, slot][:, None] * weights[blocks]).reshape(-1)
    tgt = (q_of[:, None] * n_pad + d.clamp_min(0).long()).reshape(-1)
    keep = d.reshape(-1) >= 0
    tgt, c = tgt[keep], c[keep]
    size = idx.shape[0] * n_pad
    return time_call(torch, lambda: torch.zeros(
        size, device=docs.device).index_add_(0, tgt, c), 20)


def sparse_shape(family: str, args) -> str:
    if family == "text_expansion_forward":
        return (f"B={args[0].shape[0]} L={args[0].shape[1]} "
                f"H={args[3].shape[0]} V={args[4].shape[1]} m={args[5]}")
    n_q, slots = sparse_size(family, args)
    shape = f"n_q={n_q} slots={slots} n_docs_pad={sparse_n_docs_pad(family, args)}"
    if family == "sparse_flat":
        shape += f" k={args[8]} function={args[9]}"
    elif family == "sparse_coarse":
        shape += f" kprime={args[6]}"
    elif family == "sparse_rerank":
        shape += f" kprime={args[8]} k={args[9]}"
    else:
        shape += f" function={args[7]}"
    return shape


def phase_sparse_kernels(torch, np, rec, launches, dev) -> list:
    """Each sparse-path family held against its plain version on up to 8
    main-path calls plus its largest per plane length (where the plain
    version fits), then timed (CUDA events) at its largest main-path call
    beside its bound, the plain version and its library yardstick; K18 is
    also timed on cache misses at B 64 and B 4,096 (distinct texts)."""
    from elasticsearch_tpu_torch.ml import get_model
    from elasticsearch_tpu_torch.ml import text_expansion as te
    from elasticsearch_tpu_torch.ops import sparse
    fns = {"sparse_flat": (sparse.sparse_topk_batch,
                           sparse.sparse_flat_plain),
           "sparse_scores": (sparse.sparse_scores,
                             sparse.sparse_scores_plain),
           "sparse_coarse": (sparse.sparse_coarse_kernel,
                             sparse.sparse_coarse_plain),
           "sparse_rerank": (sparse.sparse_rerank_kernel,
                             sparse.sparse_rerank_plain),
           "text_expansion_forward": (te.text_expansion_forward,
                                      te.text_expansion_forward_plain)}
    rows = []
    for fam in SPARSE_FAMILIES:
        kernel, plain = fns[fam]
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        torch.cuda.empty_cache()
        room = 0.85 * torch.cuda.mem_get_info()[0]
        fit = [c for c in calls if sparse_plain_bytes(torch, fam, c[0]) < room]
        check(bool(fit), f"kernels: no {fam} call's plain version fits")

        def fits(call):
            return any(call is c for c in fit)
        err = 0.0
        for args, kwargs in fit[:8] + [c for c in rec.largest_calls(fam)
                                       if fits(c)]:
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            if fam == "text_expansion_forward":
                check(torch.equal(got[1], want[1]),
                      "kernels: text_expansion_forward ids differ")
                e = float((got[0] - want[0]).abs().max())
                check(e <= FORWARD_ATOL,
                      f"kernels: text_expansion_forward |diff| {e}")
                err = max(err, e)
            else:
                fn = args[9] if fam == "sparse_flat" else (
                    args[7] if fam == "sparse_scores" else "linear")
                err = max(err, compare(
                    torch, fam, got, want, fn in ("linear", "saturation"),
                    SPARSE_RTOL))
            del got, want
        largest = max(calls, key=lambda c: sparse_size(fam, c[0]))
        args, kwargs = largest
        ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
        if fits(largest):
            probe = time_call(torch, lambda: plain(*args, **kwargs), 1)
            plain_ms = time_call(torch, lambda: plain(*args, **kwargs),
                                 5 if probe < 250 else 1)
            plain_note = ""
        else:
            p_args, p_kw = max(fit, key=lambda c: sparse_size(fam, c[0]))
            plain_ms = time_call(torch, lambda: plain(*p_args, **p_kw), 1)
            plain_note = (f" (plain version at {sparse_shape(fam, p_args)}:"
                          f" the largest call's does not fit)")
        bound_ms, bound_by, nbytes = sparse_bound(torch, fam, args)
        lib_ms = sparse_library_ms(torch, fam, args)
        shape = sparse_shape(fam, args)
        log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain {plain_ms:.4f}"
            f" ms{plain_note}, bound {bound_ms:.4f} ms ({nbytes} bytes at "
            f"3.35 TB/s, {bound_by}), library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"max_abs_err {err} over {len(fit[:8])} main-path calls and the"
            f" largest, timed at {shape}")
        for g_args, _g_kw in rec.largest_calls(fam):
            if g_args is not args and fam == "sparse_flat" and \
                    sparse_size(fam, g_args)[0] > 1:
                g_ms = time_call(torch, lambda: kernel(*g_args, **_g_kw), 20)
                log(f"kernel {fam}: {g_ms:.4f} ms at the largest batch of "
                    f"another length, {sparse_shape(fam, g_args)}, bound "
                    f"{sparse_bound(torch, fam, g_args)[0]:.4f} ms")
        rows.append({
            "name": fam, "route": "cuda",
            "source": f"elasticsearch_tpu_torch/csrc/{fam}.cu",
            "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "shape": shape})
        torch.cuda.empty_cache()
    # K18 on cache misses: distinct texts through expand_batch (host
    # featurize + launch + copy back) and the launch alone
    model = get_model(None, dev)
    gen = np.random.default_rng(SEED + 61)
    for b in (64, 4096):
        texts = list(dict.fromkeys(sparse_texts(np, gen, 2 * b)))[:b]
        model._cache.clear()
        t = time.monotonic()
        model.expand_batch(texts)
        wall = time.monotonic() - t
        feats = [model._featurize(x) for x in texts]
        args = (torch.as_tensor(np.stack([f[0] for f in feats]), device=dev),
                torch.as_tensor(np.stack([f[1] for f in feats]), device=dev),
                model._emb, model._w1, model._w2, model.top_m)
        ms = time_call(torch, lambda: te.text_expansion_forward(*args), 20)
        plain_ms = time_call(
            torch, lambda: te.text_expansion_forward_plain(*args), 1)
        log(f"kernel text_expansion_forward: B={len(texts)} cache misses: "
            f"expand_batch wall {1e3 * wall:.3f} ms, kernel {ms:.4f} ms "
            f"(median of 20), plain {plain_ms:.4f} ms, bound "
            f"{sparse_bound(torch, 'text_expansion_forward', args)[0]:.4f} "
            f"ms, library (W2 product + top-k) "
            f"{sparse_library_ms(torch, 'text_expansion_forward', args):.4f}"
            f" ms")
    model._cache.clear()
    return rows


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the wide selection: windows above the kernels' 4,096-entry CTA top-k
# ---------------------------------------------------------------------------

WIDE_K = 10_000
WIDE_FAMILIES = ("bm25_flat", "knn_flat", "dense_topk")


# (rows, cols, k) for the wide selection: a row of one chunk, rounds that
# end mid-chunk, a k of one round over many rows
WIDE_CASES = ((1, 5000, 4097), (3, 300_000, WIDE_K), (2, 200_000, 12_289),
              (64, 70_000, 4096))


def phase_wide_small(torch, np, dev) -> None:
    """The wide selection (the rounds inside K10) against a stable sort on
    the card, row by row, with many equal scores and -inf slots:
    bitwise."""
    from elasticsearch_tpu_torch.ops import topk
    rng = np.random.default_rng(SEED + 600)
    for rows, cols, k in WIDE_CASES:
        x = rng.integers(0, 300, (rows, cols)).astype(np.float32)
        x[x < 30] = -np.inf
        t = torch.as_tensor(x, device=dev)
        for r in range(rows):
            got = topk.dense_topk(t[r], k)
            want = topk.dense_topk_plain(t[r], k)
            torch.cuda.synchronize()
            compare(torch, f"dense_topk {cols} k {k} row {r}", got, want)
    log("wide-small: dense_topk at k 4,096 to 12,289 bitwise equal to a "
        "stable sort")


def phase_wide(torch, np, dev, shared) -> None:
    """Windows of 10,000 on the two shards the full and knn-full phases
    built, per segment (planes off, so every segment's launch selects
    10,000): a match with ``from`` 0 and ``size`` 10,000 (K1 with the
    rounds), the same match with exact totals (the dense collector, K8 +
    K10 with the rounds) and a knn with k 10,000 (K5 with the rounds). The
    first 4,096 hits equal the 4,096 window's, the dense window equals
    K1's, and the first 10 equal the earlier phases' exact answers."""
    from elasticsearch_tpu_torch.index.engine import Reader
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ops.bm25 import KMAX
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.phase import query_shard
    check("msmarco" in shared and "sift" in shared,
          "wide needs the full and knn-full phases in the same run")
    keep = PLANES.enabled
    PLANES.enabled = False
    try:
        segs, mappers, queries, k1_hits = shared["msmarco"]
        reader = Reader(segs)
        q = dsl.parse_query({"match": {"body": queries[0]}})

        def hits(res):
            return [(d.segment_idx, d.doc, d.score) for d in res.docs]

        t0 = time.monotonic()
        wide = query_shard(reader, mappers, q, size=WIDE_K, device=dev)
        t_wide = time.monotonic() - t0
        narrow = query_shard(reader, mappers, q, size=KMAX, device=dev)
        got = hits(wide)
        check(len(got) == min(WIDE_K, wide.total_hits),
              f"wide: msmarco window holds {len(got)} hits")
        check(got[:KMAX] == hits(narrow),
              "wide: msmarco window's first 4,096 differ from the 4,096 "
              "window")
        check(got[:10] == list(k1_hits[0]),
              "wide: msmarco window's first 10 differ from the K1 batch leg")
        log(f"wide: msmarco match window {WIDE_K}: {len(got)} hits "
            f"(total {wide.total_hits}) in {1e3 * t_wide:.3f} ms wall; first "
            f"4,096 equal the 4,096 window, first 10 the K1 batch leg")
        t0 = time.monotonic()
        dense = query_shard(reader, mappers, q, size=WIDE_K,
                            track_total_hits=True, device=dev)
        t_dense = time.monotonic() - t0
        check(hits(dense) == got,
              "wide: msmarco dense-collector window differs from K1's")
        log(f"wide: msmarco match window {WIDE_K} with exact totals (dense "
            f"collector): {len(got)} hits in {1e3 * t_dense:.3f} ms wall; "
            f"ids and score bits equal to K1's window")

        vsegs, vqueries, knn_hits = shared["sift"]
        vmappers = MapperService({"properties": {"vec": {
            "type": "dense_vector", "dims": SIFT_DIMS,
            "similarity": "cosine", "index_options": {"type": "flat"}}}})
        vq = [float(x) for x in vqueries[0]]
        kq = dsl.parse_query({"knn": {"field": "vec", "query_vector": vq,
                                      "k": WIDE_K,
                                      "num_candidates": WIDE_K}})
        t0 = time.monotonic()
        kw = query_shard(Reader(vsegs), vmappers, kq, size=WIDE_K,
                         device=dev)
        t_knn = time.monotonic() - t0
        got = hits(kw)
        check(len(got) == WIDE_K, f"wide: sift window holds {len(got)}")
        check(same_up_to_ties(list(knn_hits[0]), got[:10]),
              "wide: sift window's first 10 differ from the exact-plane leg")
        check(all(got[i][2] >= got[i + 1][2] for i in range(len(got) - 1)),
              "wide: sift window is not in score order")
        log(f"wide: sift knn k {WIDE_K}: {len(got)} hits in "
            f"{1e3 * t_knn:.3f} ms wall; first 10 equal the exact-plane leg")
    finally:
        PLANES.enabled = keep


# the position of k in each wide family's wrapper call
WIDE_K_POS = {"bm25_flat": 10, "knn_flat": 6, "dense_topk": 1}


def wide_k_of(family: str, args) -> int:
    return args[WIDE_K_POS[family]]


def wide_size(family: str, args):
    if family == "bm25_flat":
        return bm25_size(family, args)
    if family == "knn_flat":
        return knn_size(family, args)
    return dense_size(family, args)


def wide_bound(family: str, args):
    if family == "bm25_flat":
        return bound_of(family, args, {})
    if family == "knn_flat":
        return knn_bound(family, args)
    return dense_bound(family, args)


def phase_wide_kernels(torch, rec, launches) -> list:
    """K1, K5 and K10 at k 10,000 held against their plain versions on the
    wide path's calls, and each timed at its largest such call beside its
    plain version (and torch.topk for K10): a row each, with the wide
    path's launches."""
    from elasticsearch_tpu_torch.ops import bm25 as bm
    from elasticsearch_tpu_torch.ops import knn, topk
    mods = {"bm25_flat": bm, "knn_flat": knn, "dense_topk": topk}
    rows = []
    for fam in WIDE_FAMILIES:
        mod = mods[fam]
        kernel, plain = getattr(mod, fam), getattr(mod, fam + "_plain")
        wide = [c for c in rec.calls[fam] if wide_k_of(fam, c[0]) > 4096]
        check(bool(wide), f"kernels: no {fam} call above 4,096 recorded")
        err = 0.0
        for args, kwargs in wide[:4]:
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            err = max(err, compare(torch, f"{fam} k {wide_k_of(fam, args)}",
                                   got, want))
            del got, want
        args, kwargs = max(wide, key=lambda c: (rec.size(fam, c[0]),
                                                wide_k_of(fam, c[0])))
        ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
        plain_ms = time_call(torch, lambda: plain(*args, **kwargs), 5)
        bound_ms, bound_by, nbytes = wide_bound(fam, args)
        lib_ms = (dense_library_ms(torch, fam, args) if fam == "dense_topk"
                  else None)
        if fam == "bm25_flat":
            shape = (f"fb={args[2].numel()} "
                     f"n_docs_pad={n_docs_pad_of(fam, args)} "
                     f"n_q={n_q_of(fam, args)}")
        elif fam == "knn_flat":
            shape = f"(B, N, k) = {knn_size(fam, args)}"
        else:
            shape = f"n_docs_pad={dense_n(fam, args)}"
        shape += f" k={wide_k_of(fam, args)}"
        log(f"kernel {fam} (wide): {ms:.4f} ms (median of 20), plain "
            f"{plain_ms:.4f} ms (median of 5), bound {bound_ms:.4f} ms "
            f"({nbytes} bytes at 3.35 TB/s, {bound_by}), library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"max_abs_err {err} over {min(len(wide), 4)} wide-path calls, "
            f"launches on the wide path {launches.get(fam, 0)}, timed at "
            f"{shape}")
        rows.append({"name": fam, "route": "cuda",
                     "source": f"elasticsearch_tpu_torch/csrc/{fam}.cu",
                     "replaces": REPLACES[fam],
                     "launches": launches.get(fam, 0), "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms,
                     "shape": shape})
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# aggregations: K20-K23, the engine path, the geonames-shaped shard
# ---------------------------------------------------------------------------

GEONAMES_DOCS = 11_396_503
AGGS_FAMILIES = ("aggs_ordinal_counts", "aggs_histogram",
                 "aggs_ordinal_counts_plane", "aggs_histogram_plane")
AGGS_FNS = {"aggs_ordinal_counts": "ordinal_counts",
            "aggs_histogram": "histogram_partials",
            "aggs_ordinal_counts_plane": "ordinal_counts_plane",
            "aggs_histogram_plane": "histogram_partials_plane"}
GEO_CODES = [chr(65 + i // 26) + chr(65 + i % 26) for i in range(250)]
FEATURE_CLASSES = "AHLPRSTUV"
# GeoNames' feature classes, roughly as the allCountries dump shares them
FC_SHARE = (0.03, 0.20, 0.06, 0.18, 0.01, 0.25, 0.15, 0.01, 0.11)
GEO_NAME_VOCAB = 200_000
GEO_MAPPING = {"properties": {
    "name": {"type": "text"}, "country_code": {"type": "keyword"},
    "feature_class": {"type": "keyword"}, "population": {"type": "long"},
    "dem": {"type": "integer"}}}
GEO_AGGS = {
    "country": {"terms": {"field": "country_code", "size": 20}},
    "elevation": {"histogram": {"field": "dem", "interval": 100},
                  "aggs": {"lo": {"min": {"field": "dem"}},
                           "hi": {"max": {"field": "dem"}},
                           "mean": {"avg": {"field": "dem"}}}}}
# Rally geonames' country_agg_uncached: a terms with a sum sub-agg
COUNTRY_AGG = {"country_population": {
    "terms": {"field": "country_code", "size": 250},
    "aggs": {"population": {"sum": {"field": "population"}}}}}


def geonames_columns(np, seed: int, n: int):
    """GeoNames-shaped columns from a seed (no real dump is in the repo):
    country codes Zipf(1.3) folded onto 250, nine feature classes at
    GeoNames-like shares, a population (90 % zero, the rest lognormal,
    some past 2^24), dem in [-9999, 8848] (10 % -9999, GeoNames' no-data
    value; 3 % below sea level; else exponential, mean 400 m) and names
    of 1-3 words drawn Zipf(1.4) over 200,000."""
    rng = np.random.default_rng(seed)
    cc = ((rng.zipf(1.3, n) - 1) % len(GEO_CODES)).astype(np.int32)
    fc = rng.choice(len(FEATURE_CLASSES), n, p=FC_SHARE).astype(np.int32)
    pop = np.zeros(n, np.int64)
    has = rng.random(n) < 0.1
    pop[has] = np.minimum(rng.lognormal(8.0, 2.5, int(has.sum())),
                          4e7).astype(np.int64)
    dem = np.minimum(rng.exponential(400.0, n), 8848).astype(np.int64)
    low = rng.random(n) < 0.03
    dem[low] = -rng.integers(1, 431, int(low.sum()))
    dem[rng.random(n) < 0.1] = -9999
    lens = rng.integers(1, 4, n)
    toks = (rng.zipf(1.4, (n, 3)) - 1) % GEO_NAME_VOCAB
    toks[np.arange(3)[None, :] >= lens[:, None]] = -1
    return {"cc": cc, "fc": fc, "pop": pop, "dem": dem,
            "toks": toks.astype(np.int32)}


def geo_keyword(np, ords, names):
    from elasticsearch_tpu_torch.index.segment import KeywordField
    n = len(ords)
    return KeywordField(
        terms={t: i for i, t in enumerate(names)},
        ord_values=ords.astype(np.int32),
        ord_offsets=np.arange(n + 1, dtype=np.int32),
        doc_freq=np.bincount(ords, minlength=len(names)).astype(np.int32),
        term_list=list(names))


def build_geo_segment(args):
    """One geonames-shaped segment's fields (run in a worker process)."""
    seed, n = args
    import numpy as np
    from elasticsearch_tpu_torch.index.segment import (
        DocValuesField, postings_from_token_matrix,
    )
    cols = geonames_columns(np, seed, n)
    n_terms = int(cols["toks"].max()) + 1
    pf = postings_from_token_matrix(
        cols["toks"], [f"n{i}" for i in range(n_terms)])
    ones = np.ones(n, bool)
    return (pf, {"country_code": geo_keyword(np, cols["cc"], GEO_CODES),
                 "feature_class": geo_keyword(np, cols["fc"],
                                              list(FEATURE_CLASSES))},
            {"population": DocValuesField(cols["pop"], ones),
             "dem": DocValuesField(cols["dem"], ones.copy())}, cols)


def build_geo_shard(np, n_docs: int, workers: int):
    """The geonames-shaped shard: 4 segments, 0.1 % of docs deleted."""
    import multiprocessing as mp
    from elasticsearch_tpu_torch.index.segment import Segment
    sizes = [n_docs // 4 + (1 if i < n_docs % 4 else 0) for i in range(4)]
    jobs = [(SEED + 700 + i, n) for i, n in enumerate(sizes)]
    if workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(build_geo_segment, jobs)
    else:
        parts = [build_geo_segment(j) for j in jobs]
    rng = np.random.default_rng(SEED + 799)
    segs, cols = [], []
    for i, ((pf, kws, dvs, c), n) in enumerate(zip(parts, sizes)):
        seg = Segment(f"geo{i}", n)
        seg.postings["name"] = pf
        seg.keywords.update(kws)
        seg.doc_values.update(dvs)
        seg.ids = [str(j) for j in range(n)]
        seg.live[rng.random(n) < 0.001] = False
        seg.invalidate_live_count()
        segs.append(seg)
        cols.append(c)
    return segs, cols


def geo_queries(np, n_q: int):
    """match_all, the nine feature_class terms, then name matches."""
    rng = np.random.default_rng(SEED + 710)
    out = [{"match_all": {}}]
    out += [{"term": {"feature_class": c}} for c in FEATURE_CLASSES]
    while len(out) < n_q:
        words = (rng.zipf(1.4, int(rng.integers(1, 3))) - 1) % 2000
        out.append({"match": {"name": " ".join(f"n{w}" for w in words)}})
    return out[:n_q]


def geo_host_mask(np, col, live, q):
    """The docs a geo query matches, from the generated columns."""
    if "match_all" in q:
        m = np.ones(len(col["cc"]), bool)
    elif "term" in q:
        m = col["fc"] == FEATURE_CLASSES.index(q["term"]["feature_class"])
    else:
        words = [int(w[1:]) for w in q["match"]["name"].split()]
        m = np.isin(col["toks"], words).any(axis=1)
    return m & live


def geo_oracle(np, cols, lives, q):
    """Host partials of GEO_AGGS for query q: country counts, and per dem
    bucket key [count, min, max, sum] twice -- with the per-segment path's
    sums (one f32 chain a segment, merged as Python floats in segment
    order) and with the plane's (one f32 chain over the whole plane in
    plane order). Each chain adds one value at a time in row order:
    np.add.accumulate is sequential (np.sum is pairwise and would not
    match)."""
    counts = np.zeros(len(GEO_CODES), np.int64)
    per_seg, plane = {}, {}
    for col, live in zip(cols, lives):
        m = geo_host_mask(np, col, live, q)
        counts += np.bincount(col["cc"][m], minlength=len(GEO_CODES))
        dem = col["dem"][m]
        keys = dem // 100
        order = np.argsort(keys, kind="stable")
        k, v = keys[order], dem[order].astype(np.float32)
        if not len(k):
            continue
        starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
        ends = np.r_[starts[1:], len(k)]
        for a, b in zip(starts, ends):
            key, run = int(k[a]), v[a:b]
            c, lo, hi = int(b - a), int(run.min()), int(run.max())
            s = float(np.add.accumulate(run, dtype=np.float32)[-1])
            head = np.array([plane[key][3] if key in plane else 0.0],
                            np.float32)
            chain = float(np.add.accumulate(np.concatenate((head, run)),
                                            dtype=np.float32)[-1])
            for hist, total in ((per_seg, None), (plane, chain)):
                h = hist.get(key)
                if h is None:
                    hist[key] = [c, lo, hi, s if total is None else total]
                else:
                    hist[key] = [h[0] + c, min(h[1], lo), max(h[2], hi),
                                 h[3] + s if total is None else total]
    return counts, per_seg, plane


def check_geo_partial(np, name, partial, counts, hist):
    """A ShardAggregator partial of GEO_AGGS against geo_oracle."""
    got = {b["key"]: b["doc_count"]
           for b in partial["country"]["buckets"].values()}
    want = {GEO_CODES[i]: int(c) for i, c in enumerate(counts) if c}
    check(got == want, f"{name}: country counts differ from the host count")
    buckets = partial["elevation"]["buckets"]
    check(len(buckets) == len(hist),
          f"{name}: {len(buckets)} dem buckets, host {len(hist)}")
    big = 0.0
    for key, (c, lo, hi, s) in hist.items():
        b = buckets.get(repr(float(key * 100)))
        check(b is not None, f"{name}: dem bucket {key * 100} missing")
        subs = b["subs"]
        check(b["doc_count"] == c and subs["lo"]["min"] == lo and
              subs["hi"]["max"] == hi,
              f"{name}: dem bucket {key * 100} count/min/max differ")
        check(subs["mean"]["sum"] == s,
              f"{name}: dem bucket {key * 100} sum {subs['mean']['sum']} "
              f"!= the row-order oracle {s}")
        big = max(big, abs(s))
    return big


def same_aggs_but_sums(a, b, path="$"):
    """Final aggregations equal in keys, counts, mins and maxs; the avg
    sub ("mean") is skipped: the plane adds a bucket in one f32 chain over
    the whole plane, the per-segment path in one chain a segment, and past
    2^24 the two round apart (in the JAX package too)."""
    if isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b), f"{path}: keys")
        for k in a:
            if k != "mean":
                same_aggs_but_sums(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        check(isinstance(b, list) and len(a) == len(b), f"{path}: length")
        for i, (x, y) in enumerate(zip(a, b)):
            same_aggs_but_sums(x, y, f"{path}[{i}]")
    else:
        check(a == b, f"{path}: {a!r} != {b!r}")


def phase_aggs_small(torch, np, dev) -> None:
    """K20-K23 against their plain versions on seeded columns: values with
    many negatives and buckets dropped at both ends, a plan whose buckets
    cover every value (sums past 2^24), an interval-0 plan, -1 padded
    ordinals and ordinals past the buckets; bitwise."""
    from elasticsearch_tpu_torch.ops import aggs
    rng = np.random.default_rng(SEED + 800)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    for n, n_plans, nb in ((3000, 1, 8), (1 << 20, 16, 256),
                           (300_000, 3, 20_000)):
        values = rng.integers(-9999, 1 << 23, n).astype(np.int32)
        exists = rng.random(n) > 0.1
        values[~exists] = 0
        masks = rng.random((n_plans, n)) < rng.uniform(0.05, 1.0,
                                                       (n_plans, 1))
        intervals = rng.integers(1, 5000, n_plans).astype(np.int32)
        intervals[0] = -(-((1 << 23) + 10_000) // (nb - 2))
        if n_plans > 2:
            intervals[1] = 0
        bases = np.array([(-9999 // max(int(i), 1)) + 1 for i in intervals],
                         np.int32)
        cols = (T(values), T(exists), T(masks), T(bases), T(intervals))
        got = aggs.histogram_partials_plane(*cols, nb)
        want = aggs.histogram_partials_plane_plain(*cols, nb)
        torch.cuda.synchronize()
        compare(torch, f"aggs_histogram_plane n={n} p={n_plans}", got, want)
        check(float(want[1][0].abs().max()) > 2 ** 24,
              "aggs-small: no bucket sum passed 2^24")
        one = aggs.histogram_partials(cols[0], cols[1], cols[2][0],
                                      int(bases[0]), int(intervals[0]), nb)
        compare(torch, f"aggs_histogram n={n}", one,
                tuple(t[0] for t in want))
        e = max(8, n // 2)
        owners = np.sort(rng.integers(0, n, e)).astype(np.int32)
        ords = rng.integers(-1, nb + 5, e).astype(np.int32)
        got = aggs.ordinal_counts_plane(T(ords), T(owners), cols[2], nb)
        want = aggs.ordinal_counts_plane_plain(T(ords), T(owners), cols[2],
                                               nb)
        compare(torch, f"aggs_ordinal_counts_plane e={e}", (got,), (want,))
        one = aggs.ordinal_counts(T(ords), T(owners), cols[2][0], nb)
        compare(torch, f"aggs_ordinal_counts e={e}", (one,), (want[0],))
    log("aggs-small: K20-K23 bitwise equal to their plain versions "
        "(negatives, drops, -1 pads, sums past 2^24, an interval-0 plan)")


def geo_engine_docs(np, n: int):
    cols = geonames_columns(np, SEED + 720, n)
    docs = []
    for i in range(n):
        toks = [int(t) for t in cols["toks"][i] if t >= 0]
        docs.append({"name": " ".join(f"n{t}" for t in toks),
                     "country_code": GEO_CODES[int(cols["cc"][i])],
                     "feature_class": FEATURE_CLASSES[int(cols["fc"][i])],
                     "population": int(cols["pop"][i]),
                     "dem": int(cols["dem"][i])})
    return docs


def geo_engine_bodies(np):
    bodies = []
    for q in geo_queries(np, 13):
        bodies.append({"size": 0, "query": q, "aggs": GEO_AGGS,
                       "track_total_hits": True})
    bodies += [
        {"size": 0, "aggs": COUNTRY_AGG},
        {"size": 0, "aggs": {"s": {"stats": {"field": "dem"}},
                             "c": {"cardinality": {"field": "country_code"}},
                             "p": {"percentiles": {"field": "dem",
                                                   "percents": [50, 99]}}}},
        {"size": 0, "aggs": {"r": {"range": {"field": "population",
                                             "ranges": [{"to": 1000},
                                                        {"from": 1000}]}},
                             "f": {"filters": {"filters": {
                                 "p": {"term": {"feature_class": "P"}},
                                 "h": {"term": {"feature_class": "H"}}}}}}},
        {"size": 3, "query": {"match": {"name": "n0 n1"}},
         "aggs": {"fc": {"terms": {"field": "feature_class"}},
                  "h": {"histogram": {"field": "dem", "interval": 1000}}}},
    ]
    return bodies


def phase_aggs_engine(torch, np, dev, n_docs: int) -> None:
    """The geonames shape through InternalEngine + SearchService on a few
    thousand docs: every response of the agg body set, and the drain
    planner's presets, equal on the card and on the CPU."""
    from types import SimpleNamespace
    from elasticsearch_tpu_torch.index import InternalEngine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search import SearchService
    from elasticsearch_tpu_torch.search.plane_aggs import plan_drain_aggs
    engine = InternalEngine(MapperService(GEO_MAPPING), shard_label="geo")
    docs = geo_engine_docs(np, n_docs)
    for i, d in enumerate(docs):
        engine.index(str(i), d)
        if i in (n_docs // 3, 2 * n_docs // 3):
            engine.refresh()
    engine.refresh()
    for i in range(0, n_docs, 97):
        engine.delete(str(i))
    engine.refresh()
    card = SearchService(engine, device=dev)
    cpu = SearchService(engine, device="cpu")
    bodies = geo_engine_bodies(np)
    for bi, body in enumerate(bodies):
        a = card.search(json.loads(json.dumps(body)))
        b = cpu.search(json.loads(json.dumps(body)))
        a.pop("took")
        b.pop("took")
        check(json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True),
              f"aggs-engine: body {bi} differs between the card and the CPU")
    reader = engine.acquire_reader()
    members = [SimpleNamespace(req={"body": b}, trace=None, error=None)
               for b in bodies[:13]]
    shard = SimpleNamespace(engine=engine)
    on_card = plan_drain_aggs(shard, reader, members, device=dev)
    on_cpu = plan_drain_aggs(shard, reader, members, device="cpu")
    check(set(on_card) == set(range(13)), "aggs-engine: presets missing")
    check(json.dumps(on_card, sort_keys=True) ==
          json.dumps(on_cpu, sort_keys=True),
          "aggs-engine: plane presets differ between the card and the CPU")
    log(f"aggs-engine: {len(bodies)} agg bodies on {n_docs} docs (3 "
        f"segments, deletes) and a 13-member drain's presets equal on the "
        f"card and the CPU")


def aggs_size(family: str, args):
    """(plans, table entries or column rows) of an aggregation call."""
    p = args[2].shape[0] if family.endswith("_plane") else 1
    return (p, args[0].numel())


def aggs_buckets(family: str, args) -> int:
    return args[3] if "ordinal_counts" in family else args[5]


def phase_aggs_full(torch, np, dev, n_docs: int, workers: int,
                    n_q: int) -> None:
    """The geonames-shaped shard (Rally's geonames track, 11,396,503 docs
    in 4 segments): n_q solo SearchService requests with GEO_AGGS (K20 and
    K21 per segment), then plan_drain_aggs over the same n_q members (K22
    and K23 over the columns plane at P = n_q) feeding
    ShardAggregator(preset=...). Checks: country counts and dem
    count/min/max against a host count and the dem sums against the
    row-order oracle on both paths (every fourth member), the plane's
    responses equal to the per-segment ones in keys, counts, mins and
    maxs (all members; the avg sub's sums round apart past 2^24), and
    country_agg_uncached's counts against the host."""
    from types import SimpleNamespace
    from elasticsearch_tpu_torch.index.engine import Reader
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ops.device_segment import PLANES
    from elasticsearch_tpu_torch.search import SearchService, dsl
    from elasticsearch_tpu_torch.search.aggregations import (
        ShardAggregator, parse_aggs, reduce_aggs,
    )
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    from elasticsearch_tpu_torch.search.phase import query_shard
    from elasticsearch_tpu_torch.search.plane_aggs import plan_drain_aggs
    t0 = time.monotonic()
    segs, cols = build_geo_shard(np, n_docs, workers)
    log(f"aggs-full: built {n_docs} geonames-shaped docs in {len(segs)} "
        f"segments in {time.monotonic() - t0:.1f}s")
    reader = Reader(segs)
    mappers = MapperService(GEO_MAPPING)
    engine = SimpleNamespace(mappers=mappers, acquire_reader=lambda: reader)
    svc = SearchService(engine, index_name="geonames", device=dev)
    queries = geo_queries(np, n_q)
    bodies = [{"size": 0, "query": q, "aggs": GEO_AGGS,
               "track_total_hits": True} for q in queries]
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    svc.search(json.loads(json.dumps(bodies[0])))        # untimed warm-up
    sync()
    DEVICE_PROFILE.timing = dev.type == "cuda"
    ms0 = device_ms(AGGS_FAMILIES)
    times, solo = [], []
    try:
        for body in bodies:
            t = time.monotonic()
            solo.append(svc.search(json.loads(json.dumps(body))))
            sync()
            times.append(time.monotonic() - t)
    finally:
        DEVICE_PROFILE.timing = False
    ms1 = device_ms(AGGS_FAMILIES)
    kern = {f: round(ms1[f] - ms0[f], 4) for f in AGGS_FAMILIES}
    busy = sum(kern.values()) / max(1e3 * sum(times), 1e-9)
    log(f"aggs-full: {len(bodies)} solo agg requests (per segment), wall "
        f"p50 {1e3 * pct(times, 0.5):.3f} ms p99 "
        f"{1e3 * pct(times, 0.99):.3f} ms, total {1e3 * sum(times):.1f} ms;"
        f" kernel device ms {kern}; kernel-busy share {busy:.4f}")
    for q, resp in zip(queries, solo):
        total = resp["hits"]["total"]["value"]
        a = resp["aggregations"]["country"]
        check(sum(b["doc_count"] for b in a["buckets"]) +
              a["sum_other_doc_count"] == total,
              f"aggs-full: {q}: country counts do not add up to {total}")
        check(sum(b["doc_count"] for b in
                  resp["aggregations"]["elevation"]["buckets"]) == total,
              f"aggs-full: {q}: dem counts do not add up to {total}")

    # the drain: K22 and K23 over the columns plane, one launch each
    PLANES.enabled, PLANES.min_segments = True, 2
    members = [SimpleNamespace(req={"body": b}, trace=None, error=None)
               for b in bodies]
    shard = SimpleNamespace(engine=engine)
    plan_drain_aggs(shard, reader, members[:2], device=dev)   # builds plane
    sync()
    DEVICE_PROFILE.timing = dev.type == "cuda"
    ms0 = device_ms(AGGS_FAMILIES)
    try:
        t = time.monotonic()
        preset = plan_drain_aggs(shard, reader, members, device=dev)
        sync()
        t_plan = time.monotonic() - t
    finally:
        DEVICE_PROFILE.timing = False
    ms1 = device_ms(AGGS_FAMILIES)
    kern = {f: round(ms1[f] - ms0[f], 4) for f in AGGS_FAMILIES}
    check(set(preset) == set(range(len(members))),
          f"aggs-full: the drain preset {len(preset)} of {len(members)}")
    specs = parse_aggs(GEO_AGGS)
    t = time.monotonic()
    for ui, (q, resp) in enumerate(zip(queries, solo)):
        agg = ShardAggregator(specs, preset=preset[ui])
        query_shard(reader, mappers, dsl.parse_query(q), size=0,
                    collectors=[agg], device=dev)
        same_aggs_but_sums(resp["aggregations"],
                           reduce_aggs(specs, [agg.partial()]))
    t_reduce = time.monotonic() - t
    log(f"aggs-full: drain of {len(members)} members over the columns "
        f"plane (P {len(members)}): plan_drain_aggs {1e3 * t_plan:.1f} ms "
        f"wall, kernel device ms {kern}, busy "
        f"{sum(kern.values()) / max(1e3 * t_plan, 1e-9):.4f}; the preset "
        f"ShardAggregator responses equal the per-segment ones (keys, "
        f"counts, mins, maxs) in {1e3 * t_reduce:.1f} ms")

    # host counts and the row-order oracle, on both paths, every fourth
    # member (all 64 took a minute of the script's time limit)
    lives = [m[: s.n_docs] for m, s in zip(reader.live_masks, segs)]
    big = 0.0
    t = time.monotonic()
    held = list(enumerate(queries))[::4]
    for ui, q in held:
        agg = ShardAggregator(specs)
        query_shard(reader, mappers, dsl.parse_query(q), size=0,
                    collectors=[agg], device=dev)
        counts, per_seg, plane = geo_oracle(np, cols, lives, q)
        big = max(big, check_geo_partial(np, f"aggs-full per segment {q}",
                                         agg.partial(), counts, per_seg))
        big = max(big, check_geo_partial(np, f"aggs-full plane {q}",
                                         preset[ui], counts, plane))
    log(f"aggs-full: {len(held)} of the {len(queries)} members' country "
        f"and dem partials equal the host count and the row-order oracle "
        f"on both paths "
        f"(largest bucket sum {big:.1f}, past 2^24: {big > 2 ** 24}) in "
        f"{time.monotonic() - t:.1f}s")
    t = time.monotonic()
    resp = svc.search({"size": 0, "aggs": COUNTRY_AGG})
    t_country = time.monotonic() - t
    want = np.zeros(len(GEO_CODES), np.int64)
    for col, live in zip(cols, lives):
        want += np.bincount(col["cc"][live], minlength=len(GEO_CODES))
    got = {b["key"]: b["doc_count"] for b in
           resp["aggregations"]["country_population"]["buckets"]}
    check(got == {GEO_CODES[i]: int(c) for i, c in enumerate(want) if c},
          "aggs-full: country_agg_uncached counts differ from the host")
    log(f"aggs-full: country_agg_uncached (terms + sum, the host path) in "
        f"{1e3 * t_country:.1f} ms, counts equal the host count")
    PLANES.clear()


def aggs_bound(family: str, args):
    """(bound_ms, bytes): each input read once, each output written once,
    at 3.35 TB/s (the arithmetic is an add a row)."""
    if family in ("aggs_ordinal_counts", "aggs_ordinal_counts_plane"):
        ords, owners, masks, nb = args[0], args[1], args[2], args[3]
        e = ords.numel()
        p = masks.shape[0] if masks.dim() == 2 else 1
        n = masks.shape[-1]
        nbytes = e * 8 + p * min(e, n) + p * nb * 4
    else:
        values, masks = args[0], args[2]
        n = values.numel()
        p = masks.shape[0] if masks.dim() == 2 else 1
        nb = args[5]
        nbytes = n * 5 + p * n + p * 8 + p * nb * 16
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def aggs_library_ms(torch, family: str, args):
    """One PyTorch call a partial computes (never used by the port):
    torch.bincount over the valid ordinals or bucket ids (the counts) and,
    for the histograms, scatter_reduce amin / amax (mins, maxs), on
    inputs masked beforehand. No library call adds in row order."""
    if family in ("aggs_ordinal_counts", "aggs_ordinal_counts_plane"):
        ords, owners, masks, nb = args[0], args[1], args[2], args[3]
        m2 = masks if masks.dim() == 2 else masks[None, :]
        valid = m2[:, owners.long()] & (ords >= 0) & (ords < nb)
        flat = (torch.arange(m2.shape[0], device=ords.device)[:, None] * nb
                + ords.long())[valid]
        n_out = m2.shape[0] * nb
        return time_call(torch, lambda: torch.bincount(flat,
                                                       minlength=n_out), 20)
    values, exists, masks = args[0], args[1], args[2]
    m2 = masks if masks.dim() == 2 else masks[None, :]
    if family == "aggs_histogram":
        bases, ivs = [int(args[3])], [int(args[4])]
    else:
        bases, ivs = args[3].tolist(), args[4].tolist()
    nb = args[5]
    flat, vf = [], []
    for p in range(m2.shape[0]):          # one plan at a time: less memory
        ids = torch.div(values.long(), max(ivs[p], 1),
                        rounding_mode="floor") - bases[p]
        ok = exists & m2[p] & (ids >= 0) & (ids < nb) & (ivs[p] > 0)
        flat.append(ids[ok] + p * nb)
        vf.append(values[ok].float())
    flat, vf = torch.cat(flat), torch.cat(vf)
    n_out = m2.shape[0] * nb

    def lib():
        torch.bincount(flat, minlength=n_out)
        torch.full((n_out,), torch.inf, device=vf.device).scatter_reduce_(
            0, flat, vf, "amin")
        torch.full((n_out,), -torch.inf, device=vf.device).scatter_reduce_(
            0, flat, vf, "amax")
    return time_call(torch, lib, 20)


def phase_aggs_kernels(torch, rec, launches) -> list:
    """K20-K23 held against their plain versions on the main path's calls
    (up to 4 each plus the largest), then timed at the largest beside the
    bound, the plain version and the library yardstick."""
    from elasticsearch_tpu_torch.ops import aggs
    rows = []
    for fam in AGGS_FAMILIES:
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        kernel = getattr(aggs, AGGS_FNS[fam])
        plain = getattr(aggs, AGGS_FNS[fam] + "_plain")
        err = 0.0
        for args, kwargs in calls[:4] + rec.largest_calls(fam):
            got = kernel(*args, **kwargs)
            got = got if isinstance(got, tuple) else (got,)
            want = plain(*args, **kwargs)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(err, compare(torch, fam, got, want))
            del got, want
        args, kwargs = rec.largest_calls(fam)[-1]
        ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
        probe = time_call(torch, lambda: plain(*args, **kwargs), 1)
        plain_runs = 5 if probe < 2000 else 1
        plain_ms = probe if plain_runs == 1 else time_call(
            torch, lambda: plain(*args, **kwargs), plain_runs)
        lib_ms = aggs_library_ms(torch, fam, args)
        bound_ms, nbytes = aggs_bound(fam, args)
        p, n = aggs_size(fam, args)
        shape = f"p={p} n={n} n_buckets={aggs_buckets(fam, args)}"
        log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain {plain_ms:.4f}"
            f" ms (median of {plain_runs}), library {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s), max_abs_err "
            f"{err}, timed at {shape}")
        rows.append({
            "name": fam, "route": "cuda",
            "source": f"elasticsearch_tpu_torch/csrc/{fam}.cu",
            "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "shape": shape})
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the node spine and hybrid RRF (BASELINE #4, the BEIR NQ shape)
# ---------------------------------------------------------------------------

NQ_DOCS = 2_681_468          # BEIR NQ's corpus
NQ_DIMS = 768                # BEIR's BERT-base dense retrievers
NQ_MEAN_WORDS = 78.88
NQ_BULK_DOCS = 2_500
FUSION_FAMILIES = ("rrf_fuse_batch", "rrf_fuse", "linear_fuse")
# fusion families with no served caller in the JAX package either: held
# against their plain versions in the kernels phase, launched nowhere on
# the main path
NO_SERVED_CALLER = ("rrf_fuse", "linear_fuse")
REPLACES.update({
    "rrf_fuse": "elasticsearch_tpu/ops/fusion.py:26",
    "rrf_fuse_batch": "elasticsearch_tpu/ops/fusion.py:46",
    "linear_fuse": "elasticsearch_tpu/ops/fusion.py:67",
})
FUSION_SOURCES = {"rrf_fuse": "elasticsearch_tpu_torch/csrc/rrf_fuse.cu",
                  "rrf_fuse_batch":
                      "elasticsearch_tpu_torch/csrc/rrf_fuse_batch.cu",
                  "linear_fuse":
                      "elasticsearch_tpu_torch/csrc/linear_fuse.cu"}
JSON_RTOL = 1e-6


class RestNode:
    """One port cluster's REST controller, as ``tests/test_yaml_specs.py``
    drives the reference's: ``call`` runs one request to its answer,
    ``submit`` queues one without running the scheduler."""

    def __init__(self, cluster):
        from elasticsearch_tpu_torch.rest.controller import RestRequest
        from elasticsearch_tpu_torch.rest.routes import build_controller
        self.cluster = cluster
        self.controller = build_controller(cluster.client())
        self.request_cls = RestRequest

    def submit(self, method, path, body=None, query=None, raw=b""):
        box = []
        req = self.request_cls(method=method, path=path,
                               query=dict(query or {}), body=body,
                               raw_body=raw)
        self.controller.dispatch(req, lambda s, b: box.append((s, b)))
        return box

    def call(self, method, path, body=None, query=None, raw=b""):
        box = self.submit(method, path, body, query, raw)
        self.cluster.run_until(lambda: bool(box), 600.0)
        check(bool(box), f"node: no answer to {method} {path}")
        return box[0]

    def ok(self, method, path, body=None, query=None, raw=b""):
        status, resp = self.call(method, path, body, query, raw)
        check(status < 300, f"node: {method} {path} -> {status} "
              f"{str(resp)[:400]}")
        return resp

    def node(self):
        return next(iter(self.cluster.nodes.values()))


def ndjson(lines) -> bytes:
    return ("\n".join(json.dumps(x) for x in lines) + "\n").encode("utf-8")


def bulk_ndjson(index: str, docs, deletes=()) -> bytes:
    lines = []
    for doc_id, src in docs:
        lines += [{"index": {"_index": index, "_id": doc_id}}, src]
    for doc_id in deletes:
        lines.append({"delete": {"_index": index, "_id": doc_id}})
    return ndjson(lines)


def same_json(a, b, path="$"):
    """Card response ``b`` against CPU response ``a``: the JSON apart from
    ``took``; integers, strings, ids and totals exact; floats to rtol 1e-6
    (ROADMAP queue 3, item 3); hits whose scores tie within it compared as
    a set. Returns None when equal, else where they differ."""
    if isinstance(a, dict):
        if not isinstance(b, dict):
            return path
        ka, kb = set(a) - {"took"}, set(b) - {"took"}
        if ka != kb:
            return f"{path} keys {sorted(ka ^ kb)}"
        for k in sorted(ka):
            if k == "hits" and isinstance(a[k], list):
                why = same_hits_json(a[k], b[k], f"{path}.hits")
            else:
                why = same_json(a[k], b[k], f"{path}.{k}")
            if why:
                return why
        return None
    if isinstance(a, list):
        if not isinstance(b, list) or len(a) != len(b):
            return f"{path} length"
        for n, (x, y) in enumerate(zip(a, b)):
            why = same_json(x, y, f"{path}[{n}]")
            if why:
                return why
        return None
    if isinstance(a, float) or isinstance(b, float):
        if not isinstance(b, (int, float)) or \
                abs(a - b) > JSON_RTOL * abs(a) + 1e-12:
            return f"{path}: {a} vs {b}"
        return None
    return None if a == b else f"{path}: {a!r} vs {b!r}"


def same_hits_json(a, b, path):
    if len(a) != len(b):
        return f"{path} length {len(a)} vs {len(b)}"
    by_id = {h.get("_id"): h for h in b}
    scores = [h.get("_score") for h in a]
    i = 0
    while i < len(a):
        j = i + 1
        if scores[i] is not None:
            while j < len(a) and scores[j] is not None and abs(
                    scores[j] - scores[i]) <= 2 * JSON_RTOL * abs(scores[i]):
                j += 1
        ids_a = sorted(str(h.get("_id")) for h in a[i:j])
        ids_b = sorted(str(h.get("_id")) for h in b[i:j])
        if j < len(a) and ids_a != ids_b:
            return f"{path}[{i}:{j}] ids {ids_a} vs {ids_b}"
        i = j
    for n, hit in enumerate(a):
        other = by_id.get(hit.get("_id"))
        if other is None:
            continue          # cut inside a tie group
        hit = {k: v for k, v in hit.items() if k != "_rank"}
        other = {k: v for k, v in other.items() if k != "_rank"}
        why = same_json(hit, other, f"{path}[{n}]")
        if why:
            return why
    return None


NODE_MAPPINGS = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "n": {"type": "integer"},
    "v": {"type": "dense_vector", "dims": NQ_DIMS, "similarity": "cosine"},
    "ml": {"type": "rank_features"}}}


def node_engine_docs(np, n_docs: int):
    rng = np.random.default_rng(SEED + 900)
    words = [f"w{i}" for i in range(30_000)]
    lens = rng.integers(8, 64, n_docs)
    vecs = np.round(rng.standard_normal((n_docs, NQ_DIMS),
                                        dtype=np.float32), 5).tolist()
    docs = []
    for i in range(n_docs):
        terms = zipf_terms(np, rng, int(lens[i]), 30_000)
        feats = rng.integers(0, 200, int(rng.integers(2, 6)))
        docs.append((str(i), {
            "body": " ".join(words[int(t)] for t in terms),
            "tag": f"t{i % 7}", "n": int(rng.integers(-100, 1000)),
            "v": vecs[i],
            "ml": {f"f{int(f)}": round(float(rng.uniform(0.1, 3.0)), 3)
                   for f in feats}}))
    return docs, words, rng


def node_engine_bodies(np, rng, words, n_docs: int):
    """About 40 request bodies: (name, method, path, body-or-ndjson)."""
    out = []

    def text(n):
        return " ".join(words[int(t)] for t in zipf_terms(np, rng, n,
                                                           30_000))

    def vec():
        return [round(float(x), 5) for x in
                rng.standard_normal(NQ_DIMS, dtype=np.float32)]
    for q in range(6):
        t = text(int(rng.integers(2, 6)))
        for track in (None, True, False, 7):
            body = {"query": {"match": {"body": t}}, "size": 10}
            if track is not None:
                body["track_total_hits"] = track
            out.append((f"match{q}_{track}", "POST", "/node/_search", body))
    for q in range(3):
        knn = {"field": "v", "query_vector": vec(), "k": 10,
               "num_candidates": 50}
        out.append((f"knn{q}", "POST", "/node/_search",
                    {"query": {"knn": knn}}))
        out.append((f"knn_filtered{q}", "POST", "/node/_search",
                    {"query": {"knn": dict(knn, filter={
                        "term": {"tag": f"t{q}"}})}}))
    for q in range(3):
        feats = rng.integers(0, 200, 4)
        out.append((f"text_expansion{q}", "POST", "/node/_search", {
            "query": {"text_expansion": {"ml": {"tokens": {
                f"f{int(f)}": round(float(rng.uniform(0.2, 2)), 3)
                for f in feats}}}}, "track_total_hits": True}))
    for q in range(2):
        out.append((f"aggs{q}", "POST", "/node/_search", {
            "query": {"match": {"body": text(3)}}, "size": 0,
            "aggs": {"tags": {"terms": {"field": "tag"}},
                     "ns": {"histogram": {"field": "n", "interval": 50},
                            "aggs": {"hi": {"max": {"field": "n"}}}}}}))
    for q in range(2):
        knn = {"field": "v", "query_vector": vec(), "k": 20,
               "num_candidates": 60}
        out.append((f"rrf2_{q}", "POST", "/node/_search", {
            "query": {"match": {"body": text(4)}}, "knn": knn,
            "rank": {"rrf": {"rank_window_size": 50}}, "size": 10}))
        out.append((f"rrf3_{q}", "POST", "/node/_search", {
            "sub_searches": [{"query": {"match": {"body": text(3)}}},
                             {"query": {"match": {"body": text(3)}}}],
            "knn": knn, "rank": {"rrf": {"rank_window_size": 40,
                                         "rank_constant": 30}},
            "size": 10}))
    out.append(("msearch", "POST", "/_msearch", ndjson([
        {"index": "node"}, {"query": {"match": {"body": text(3)}}},
        {"index": "node"}, {"query": {"knn": {
            "field": "v", "query_vector": vec(), "k": 5}}, "size": 5},
        {"index": "node"}, {"query": {"match_all": {}}, "size": 3}])))
    out.append(("count", "POST", "/node/_count",
                {"query": {"term": {"tag": "t3"}}}))
    return out


def node_engine_inputs(np, n_docs: int):
    """(bulk NDJSON chunks, deleted ids, request bodies), from the seed:
    the same in every process that asks."""
    docs, words, rng = node_engine_docs(np, n_docs)
    deletes = [str(int(i)) for i in rng.choice(n_docs, 25, replace=False)]
    chunks = [bulk_ndjson("node", docs[lo: lo + 2000])
              for lo in range(0, n_docs, 2000)]
    del docs
    return chunks, deletes, node_engine_bodies(np, rng, words, n_docs)


def node_engine_node(device, chunks, deletes):
    """A one-node port cluster on ``device`` holding the node-engine
    index: two bulk halves with a refresh between, then 25 deletes."""
    from elasticsearch_tpu_torch.testing import InProcessCluster
    cluster = InProcessCluster(n_nodes=1, seed=SEED, device=device)
    cluster.start()
    node = RestNode(cluster)
    node.ok("PUT", "/node", {"settings": {
        "number_of_shards": 1, "number_of_replicas": 0},
        "mappings": NODE_MAPPINGS})
    for c, raw in enumerate(chunks):
        resp = node.ok("POST", "/_bulk", raw=raw)
        check(not resp["errors"], f"node-engine: bulk errors ({device})")
        if c == len(chunks) // 2:
            node.ok("POST", "/node/_refresh")
    node.ok("POST", "/node/_refresh")
    resp = node.ok("POST", "/_bulk", raw=bulk_ndjson("node", [],
                                                      deletes=deletes))
    check(not resp["errors"], f"node-engine: delete errors ({device})")
    node.ok("POST", "/node/_refresh")
    return node


def node_engine_cpu_answers(n_docs: int):
    """Run in a worker process: the CPU node's answers to the request
    mix, [(status, response)]."""
    import numpy as np
    chunks, deletes, bodies = node_engine_inputs(np, n_docs)
    node = node_engine_node("cpu", chunks, deletes)
    out = []
    for _name, method, path, body in bodies:
        raw = body if isinstance(body, bytes) else b""
        out.append(node.call(method, path, None if raw else body, raw=raw))
    node.cluster.stop()
    return out


def phase_node_engine(torch, np, dev, n_docs: int) -> None:
    """Two port nodes, one on the card and one on the CPU (in a worker
    process, loading and answering while this one drives the card node),
    get the same documents through ``POST /_bulk`` and the same request
    mix through their REST controllers; every answer must be equal."""
    import multiprocessing as mp
    t0 = time.monotonic()
    pool = mp.get_context("spawn").Pool(1)
    try:
        cpu_answers = pool.apply_async(node_engine_cpu_answers, (n_docs,))
        chunks, deletes, bodies = node_engine_inputs(np, n_docs)
        node = node_engine_node(dev, chunks, deletes)
        log(f"node-engine: {n_docs} docs through _bulk into a card node "
            f"({time.monotonic() - t0:.1f}s)")
        lat, got = [], []
        for _name, method, path, body in bodies:
            raw = body if isinstance(body, bytes) else b""
            t1 = time.monotonic()
            got.append(node.call(method, path, None if raw else body,
                                 raw=raw))
            lat.append(time.monotonic() - t1)
        want = cpu_answers.get()
    finally:
        pool.terminate()
        pool.join()
    for (name, *_), g, w in zip(bodies, got, want):
        check(g[0] == w[0] == 200, f"node-engine: {name}: status {g[0]} / "
              f"{w[0]}: {str(g[1])[:300]}")
        why = same_json(w[1], g[1])
        check(why is None, f"node-engine: {name}: card and cpu differ at "
              f"{why}")
    fuser = node.node().search_action.rrf_fuser
    check(fuser.stats["rrf_fuse_batches"] > 0 and
          fuser.stats["rrf_fuse_fallbacks"] == 0,
          f"node-engine: the fuser did not fuse on the card: {fuser.stats}")
    lat.sort()
    log(f"node-engine: {len(bodies)} bodies equal on the card node and the "
        f"cpu node ({time.monotonic() - t0:.1f}s in all); card p50 "
        f"{1e3 * lat[len(lat) // 2]:.3f} ms, p99 {1e3 * pct(lat, 0.99):.3f} "
        f"ms; fuser {fuser.stats}")
    node.cluster.stop()


def nq_segment_tokens(args):
    """One generated NQ segment's tokens (run in a worker process): BEIR
    NQ passage lengths (1 + Poisson(77.88): mean 78.88 words), words
    drawn Zipf(1.35) and folded onto the 1,000,000-term vocabulary.
    Returns (lens, tokens) as ``segment_tokens`` does."""
    seed, n = args
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = 1 + rng.poisson(NQ_MEAN_WORDS - 1.0, n)
    toks = rng.zipf(1.35, int(lens.sum())) - 1
    return lens, np.where(toks < VOCAB, toks, toks % VOCAB).astype(np.int32)


def nq_vectors(torch, dev, n: int, seed: int, means):
    """Rows of the dense corpus: one of the 4,096 seeded means + 0.35
    noise, made on ``dev``, returned as host f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    which = torch.randint(0, means.shape[0], (n,), generator=g, device=dev)
    out = means[which]
    out.add_(torch.randn(n, NQ_DIMS, generator=g, device=dev), alpha=0.35)
    return out.cpu().numpy()


def nq_bulk_docs(n_docs: int) -> int:
    return min(NQ_BULK_DOCS, n_docs // 2)


def nq_jobs(n_docs: int):
    """The generated segments' postings jobs for an NQ corpus of
    ``n_docs`` (the _bulk docs excluded)."""
    return [(SEED + 700 + i, n) for i, n in
            enumerate(four_segments(n_docs - nq_bulk_docs(n_docs)))]


def build_nq_segments(torch, np, dev, n_docs: int, workers: int, means,
                      first_id: int, streams=None):
    import multiprocessing as mp
    from elasticsearch_tpu_torch.index.segment import Segment, VectorField
    sizes = four_segments(n_docs)
    jobs = [(SEED + 700 + i, n) for i, n in enumerate(sizes)]
    pool = mp.get_context("spawn").Pool(min(workers, 4)) \
        if workers > 1 and streams is None else None
    try:
        # the workers draw the tokens while this process makes the
        # vectors on the card
        pending = pool.map_async(nq_segment_tokens, jobs) \
            if pool is not None else None
        mats = [nq_vectors(torch, dev, n, SEED + 710 + i, means)
                for i, n in enumerate(sizes)]
        if pending is not None:
            streams = pending.get()
        elif streams is None:
            streams = [nq_segment_tokens(j) for j in jobs]
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    pfs = [postings_on_card(torch, np, lens, toks, dev)
           for lens, toks in streams]
    segs = []
    base = first_id
    for i, (pf, m, n) in enumerate(zip(pfs, mats, sizes)):
        seg = Segment(f"nq_gen{i}", n)
        seg.postings["body"] = pf
        seg.vectors["v"] = VectorField(
            matrix=m, exists=np.ones(n, bool),
            norms=np.linalg.norm(m, axis=1).astype(np.float32),
            similarity="cosine", dims=NQ_DIMS)
        seg.ids = [str(base + j) for j in range(n)]
        seg.id_to_doc = {doc_id: j for j, doc_id in enumerate(seg.ids)}
        seg.sources = [None] * n
        seg.invalidate_live_count()
        base += n
        segs.append(seg)
    return segs


def host_rrf(legs, size: int, rank_constant: int):
    """The coordinator's fusion on the host: float64 reciprocal-rank sums
    over the legs' hits, ties by _id then first-seen order, rounded as the
    response rounds them."""
    scores, first = {}, {}
    for hits in legs:
        for rank, hit in enumerate(hits, start=1):
            key = hit["_id"]
            if key not in first:
                first[key] = len(first)
                scores[key] = 0.0
            scores[key] += 1.0 / (rank_constant + rank)
    order = sorted(scores, key=lambda d: (-scores[d], str(d), first[d]))
    return [(d, round(scores[d], 6)) for d in order[:size]]


def phase_hybrid_full(torch, np, dev, n_docs: int, workers: int,
                      n_q: int, prebuilt=None) -> None:
    """BASELINE #4 on the BEIR NQ shape through one port node on the card:
    ``PUT /nq``, 2,500 docs through ``_bulk``, the rest of the corpus as 4
    generated segments installed with ``restore_segments`` (the snapshot
    restore entry), then 64 hybrid bodies solo and as one concurrent wave;
    every response equals a host RRF over its two legs' own responses."""
    from elasticsearch_tpu_torch.testing import InProcessCluster
    t0 = time.monotonic()
    rng = np.random.default_rng(SEED + 720)
    g = torch.Generator(device=dev).manual_seed(SEED + 721)
    means = torch.randn(4096, NQ_DIMS, generator=g, device=dev)
    n_bulk = nq_bulk_docs(n_docs)
    gen = build_nq_segments(torch, np, dev, n_docs - n_bulk, workers, means,
                            first_id=n_bulk,
                            streams=prebuilt.take("nq") if prebuilt else None)
    log(f"hybrid-full: {n_docs - n_bulk} generated docs in {len(gen)} "
        f"segments ({sum(s.postings['body'].block_docs.shape[0] for s in gen)}"
        f" posting blocks, {NQ_DIMS}-dim vectors) in "
        f"{time.monotonic() - t0:.1f}s")
    cluster = InProcessCluster(n_nodes=1, seed=SEED + 722, device=dev)
    cluster.start()
    node = RestNode(cluster)
    node.ok("PUT", "/nq", {
        "settings": {"number_of_shards": 1, "number_of_replicas": 0},
        "mappings": {"properties": {
            "body": {"type": "text"},
            "v": {"type": "dense_vector", "dims": NQ_DIMS,
                  "similarity": "cosine", "index_options": {"type": "flat"}}}}})
    t1 = time.monotonic()
    bulk_vecs = nq_vectors(torch, dev, n_bulk, SEED + 723, means)
    bulk_lists = np.round(bulk_vecs, 5).tolist()
    lens = 1 + rng.poisson(NQ_MEAN_WORDS - 1.0, n_bulk)
    for lo in range(0, n_bulk, 1000):
        docs = []
        for i in range(lo, min(lo + 1000, n_bulk)):
            toks = np.minimum(rng.zipf(1.35, int(lens[i])) - 1, VOCAB - 1)
            docs.append((str(i), {
                "body": " ".join(f"t{int(t)}" for t in toks),
                "v": bulk_lists[i]}))
        resp = node.ok("POST", "/_bulk", raw=bulk_ndjson("nq", docs))
        check(not resp["errors"], "hybrid-full: bulk errors")
    node.ok("POST", "/nq/_refresh")
    t_bulk = time.monotonic() - t1
    engine = node.node().indices_service.shard("nq", 0).engine
    t2 = time.monotonic()
    engine.restore_segments(list(engine.segments) + gen)
    count = node.ok("POST", "/nq/_count", {"query": {"match_all": {}}})
    check(count["count"] == n_docs,
          f"hybrid-full: _count {count['count']} != {n_docs}")
    log(f"hybrid-full: {n_bulk} docs through _bulk in {t_bulk:.1f}s, "
        f"{len(gen)} segments restored in {time.monotonic() - t2:.1f}s; "
        f"_count {count['count']}")
    del gen

    pick = rng.integers(0, n_bulk, n_q)
    q_vecs = bulk_vecs[pick] + 0.05 * rng.standard_normal(
        (n_q, NQ_DIMS)).astype(np.float32)
    bodies = []
    for q in range(n_q):
        toks = np.minimum(rng.zipf(1.35, int(rng.integers(7, 12))) - 1,
                          VOCAB - 1)
        bodies.append({
            "query": {"match": {"body": " ".join(f"t{int(t)}"
                                                 for t in toks)}},
            "knn": {"field": "v",
                    "query_vector": [float(x) for x in q_vecs[q]],
                    "k": 100, "num_candidates": 100},
            "rank": {"rrf": {"rank_window_size": 100, "rank_constant": 60}},
            "size": 10, "_source": False})
    # one untimed hybrid request: the planes' first build and upload
    t3 = time.monotonic()
    node.ok("POST", "/nq/_search", bodies[0])
    log(f"hybrid-full: first request (plane builds) "
        f"{time.monotonic() - t3:.1f}s")
    fuser = node.node().search_action.rrf_fuser
    stats0 = dict(fuser.stats)
    solo, answers = [], []
    for body in bodies:
        t = time.monotonic()
        answers.append(node.ok("POST", "/nq/_search", body))
        solo.append(time.monotonic() - t)
    s_sorted = sorted(solo)
    log(f"hybrid-full: {n_q} solo hybrid requests p50 "
        f"{1e3 * s_sorted[len(s_sorted) // 2]:.3f} ms p99 "
        f"{1e3 * pct(s_sorted, 0.99):.3f} ms mean "
        f"{1e3 * sum(solo) / len(solo):.3f} ms")
    solo_batches = fuser.stats["rrf_fuse_batches"] - stats0["rrf_fuse_batches"]
    stats1 = dict(fuser.stats)
    fuser.stats["rrf_fuse_max_occupancy"] = 0
    t4 = time.monotonic()
    boxes = [node.submit("POST", "/nq/_search", body) for body in bodies]
    cluster.run_until(lambda: all(boxes), 3600.0)
    t_wave = time.monotonic() - t4
    check(all(boxes), "hybrid-full: the concurrent wave did not finish")
    occupancy = fuser.stats["rrf_fuse_max_occupancy"]
    wave_batches = fuser.stats["rrf_fuse_batches"] - stats1["rrf_fuse_batches"]
    log(f"hybrid-full: {n_q} concurrent hybrid requests in "
        f"{1e3 * t_wave:.3f} ms wall; fuser batches {wave_batches}, max "
        f"occupancy {occupancy} (solo leg: {solo_batches} batches)")
    check(solo_batches > 0 and wave_batches > 0,
          "hybrid-full: the fuser launched no batch")
    check(occupancy > 1, "hybrid-full: the concurrent wave never batched "
          "two fusions")
    check(fuser.stats["rrf_fuse_fallbacks"] == 0,
          f"hybrid-full: host fusion was taken: {fuser.stats}")
    # each answer against a host RRF over its two legs' own responses
    t5 = time.monotonic()
    for q, body in enumerate(bodies):
        status, wave = boxes[q][0]
        check(status == 200, f"hybrid-full: wave request {q}: {status}")
        match = node.ok("POST", "/nq/_search", {
            "query": body["query"], "size": 100,
            "track_total_hits": False, "_source": False})
        knn = node.ok("POST", "/nq/_search", {
            "query": {"knn": body["knn"]}, "size": 100,
            "track_total_hits": False, "_source": False})
        check(len(knn["hits"]["hits"]) == 100,
              f"hybrid-full: knn leg {q} returned "
              f"{len(knn['hits']['hits'])} hits")
        want = host_rrf([match["hits"]["hits"], knn["hits"]["hits"]], 10, 60)
        for name, resp in (("solo", answers[q]), ("wave", wave)):
            got = [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
            check(got == want, f"hybrid-full: {name} request {q}: {got} "
                  f"vs host RRF {want}")
    log(f"hybrid-full: {2 * n_q} responses equal a host RRF over their "
        f"legs ({time.monotonic() - t5:.1f}s)")
    cluster.stop()


def fusion_bound(family: str, args):
    """(bound_ms, bytes): inputs read once, outputs written once, at
    3.35 TB/s (the arithmetic is a few operations a byte)."""
    if family == "linear_fuse":
        scores, k = args[0], args[3]
        r, n = scores.shape
        nbytes = r * n * 4 + n + r * 4 + k * 8
    else:
        lists, k = args[0], args[2]
        rows = lists.shape[0] if lists.dim() == 3 else 1
        nbytes = lists.numel() * 4 + rows * k * 8
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def fusion_calls(torch, np, rec):
    """The calls each fusion family is held and timed at: rrf_fuse_batch
    at the main path's calls (the largest and a B 1 one), rrf_fuse at
    R 2, K 128 over a 4,194,304-doc id space (its unscored tail), and
    linear_fuse at R 2, N_pad 4,194,304, k 10 and 10,000."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 730)
    calls = {}
    main = rec.calls["rrf_fuse_batch"]
    check(bool(main), "kernels: no rrf_fuse_batch call recorded")
    big = rec.largest_calls("rrf_fuse_batch")[-1]
    b1 = [c for c in main if c[0][0].shape[0] == 1][:1]
    if not b1:
        args, kwargs = big
        b1 = [((args[0][:1].contiguous(),) + tuple(args[1:]), kwargs)]
    calls["rrf_fuse_batch"] = [big] + b1 + main[:4]
    lists = torch.as_tensor(rng.integers(0, 3_000_000, (2, 128)).astype(
        np.int32), device=dev)
    calls["rrf_fuse"] = [((lists, 4_194_304, 300, 60), {})]
    n = 4_194_304
    scores = torch.as_tensor(rng.gamma(2.0, 1.5, (2, n)).astype(np.float32),
                             device=dev)
    scores[:, torch.as_tensor(rng.random(n) < 0.4, device=dev)] = 0.0
    weights = torch.tensor([1.0, 0.7], device=dev)
    live = torch.as_tensor(rng.random(n) > 0.01, device=dev)
    calls["linear_fuse"] = [((scores, weights, live, 10), {"normalize": True}),
                            ((scores, weights, live, 10_000),
                             {"normalize": True})]
    return calls


def phase_fusion_kernels(torch, np, rec, launches) -> list:
    """K24 (rrf_fuse_batch, rrf_fuse) and K25 (linear_fuse) bitwise
    against their plain versions on the card, then timed (CUDA events) at
    up to two calls each beside the bound, the plain version and, for
    K25, ``torch.topk`` over the fused row (its selection alone; K24 has
    no one-call library counterpart)."""
    from elasticsearch_tpu_torch.ops import fusion
    rows = []
    for fam, calls in fusion_calls(torch, np, rec).items():
        kernel = getattr(fusion, fam)
        plain = getattr(fusion, fam + "_plain")
        err = 0.0
        for args, kwargs in calls:
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            err = max(err, compare(torch, fam, got, want))
        for args, kwargs in calls[:2]:
            ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
            plain_ms = time_call(torch, lambda: plain(*args, **kwargs), 5)
            lib_ms = None
            if fam == "linear_fuse":
                fused = fusion.linear_fused_plain(args[0], args[1], args[2],
                                                  kwargs["normalize"])
                lib_ms = time_call(torch, lambda: torch.topk(fused, args[3]),
                                   20)
                shape = (f"r={args[0].shape[0]} n_pad={args[0].shape[1]} "
                         f"k={args[3]}")
            else:
                lst = args[0]
                shape = (f"b={lst.shape[0] if lst.dim() == 3 else 1} "
                         f"r={lst.shape[-2]} k_list={lst.shape[-1]} "
                         f"n_docs_pad={args[1]} k={args[2]}")
            bound_ms, nbytes = fusion_bound(fam, args)
            lib = "-" if lib_ms is None else f"(torch.topk) {lib_ms:.4f} ms"
            log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain "
                f"{plain_ms:.4f} ms (median of 5), library {lib}, bound "
                f"{bound_ms:.6f} ms ({nbytes} bytes at 3.35 TB/s), "
                f"max_abs_err {err}, timed at {shape}")
            rows.append({
                "name": fam, "route": "cuda", "source": FUSION_SOURCES[fam],
                "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": lib_ms, "shape": shape})
    for fam in NO_SERVED_CALLER:
        log(f"kernels: {fam} is exempt from the main-path launch check: "
            f"the JAX package has no served caller for it either; held "
            f"against its plain version and timed here only")
    return rows


def rrf_size(family: str, args):
    return args[0].numel()


# ---------------------------------------------------------------------------
# the mesh's text path: one launch per phase over 2 or more shards' planes
# ---------------------------------------------------------------------------

MESH_FAMILIES = ("mesh_bm25_flat", "mesh_bm25_coarse", "mesh_bm25_rerank")
MESH_SHARDS = 4
MESH_MAPPINGS = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "v": {"type": "dense_vector", "dims": 16, "similarity": "cosine"},
    "ml": {"type": "rank_features"}}}


def mesh_random_stack(np, rng, n_slots: int, dp: int, n_docs: int, nb: int,
                      n_q: int, per_q: int, empty: int, one_seg: int):
    """Seeded stacked planes of ``n_slots`` shards of different sizes
    (random_store per slot; slot ``empty`` holds nothing, slot ``one_seg``
    one segment), padded as MeshPlaneRegistry._stack pads them, and flat
    rows [S, DP, FB] per (slot, dp row)."""
    from elasticsearch_tpu_torch.ops.bm25 import qb_bucket
    stores = []
    for s in range(n_slots):
        n_s = int(rng.integers(n_docs // 3, n_docs))
        nb_s = int(rng.integers(nb // 2, nb))
        stores.append(random_store(np, rng, n_s, nb_s) + (nb_s,))
    n_max = max(st[5] for st in stores)
    nb_max = 1 << max(0, math.ceil(math.log2(max(st[6] for st in stores))))
    bd = np.full((n_slots, nb_max, 128), -1, np.int32)
    bt = np.zeros((n_slots, nb_max, 128), np.float32)
    dl = np.zeros((n_slots, n_max), np.float32)
    lv = np.zeros((n_slots, n_max), bool)
    sg = np.zeros((n_slots, n_max), np.int32)
    fb = qb_bucket(n_q * per_q)
    fi = np.zeros((n_slots, dp, fb), np.int32)
    fw = np.zeros((n_slots, dp, fb), np.float32)
    fq = np.zeros((n_slots, dp, fb), np.int32)
    fa = np.ones((n_slots, dp, fb), np.float32)
    for s, (docs, tfs, dls, live, seg, n_pad, nb_s) in enumerate(stores):
        if s == empty:
            continue
        bd[s, :nb_s], bt[s, :nb_s] = docs, tfs
        dl[s, :n_pad], lv[s, :n_pad] = dls, live
        sg[s, :n_pad] = 0 if s == one_seg else seg
        sg[s, n_pad:] = sg[s, n_pad - 1]
        for r in range(dp):
            i, w, q, a = random_flat(np, rng, nb_s, n_q, per_q)
            fi[s, r], fw[s, r], fq[s, r], fa[s, r] = i, w, q, a
    return (bd, bt, dl, fi, fw, fq, fa, lv, sg), n_max


def phase_mesh_small(torch, np, dev) -> None:
    """The three mesh kernels bitwise against their plain versions, and
    each slot bitwise against K2 / K3 / K4 launched on that slot's plane,
    at S 2 and 4 (an empty slot, a one-segment slot, dp rows, a chunked
    plane)."""
    from elasticsearch_tpu_torch.ops import bm25 as bm
    from elasticsearch_tpu_torch.parallel import mesh
    rng = np.random.default_rng(SEED + 800)
    for n_slots, dp, n_docs, nb, n_q, per_q, kprime, empty, one_seg in (
            (2, 1, 3000, 64, 4, 12, 64, -1, -1),
            (4, 2, 200_000, 2048, 8, 150, 256, 2, 1),
            (4, 1, 100_000, 1024, 1, 200, 128, 3, 0)):
        host, n_pad = mesh_random_stack(np, rng, n_slots, dp, n_docs, nb,
                                        n_q, per_q, empty, one_seg)
        bd, bt, dl, fi, fw, fq, fa, lv, sg = [
            torch.as_tensor(a, device=dev) for a in host]
        got = mesh.mesh_bm25_flat(bd, bt, dl, fi, fw, fq, fa, lv, sg, n_pad,
                                  n_q, 10, 3)
        want = mesh.mesh_bm25_flat_plain(bd, bt, dl, fi, fw, fq, fa, lv, sg,
                                         n_pad, n_q, 10, 3)
        torch.cuda.synchronize()
        compare(torch, "mesh_bm25_flat", got, want)
        for s in range(n_slots):
            for r in range(dp):
                one = bm.bm25_flat_seg(bd[s], bt[s], fi[s, r], fw[s, r],
                                       fq[s, r], dl[s], fa[s, r], lv[s],
                                       sg[s], n_pad, n_q, 10, n_segs=3)
                compare(torch, f"mesh_bm25_flat slot {s} row {r} vs K2",
                        [x[s, r] for x in got], one)
        fi0, fw0, fq0, fa0 = [x[:, 0].contiguous() for x in (fi, fw, fq, fa)]
        bt16, dl16 = bt.to(torch.bfloat16), dl.to(torch.bfloat16)
        cgot = mesh.mesh_bm25_coarse(bd, bt16, dl16, fi0, fw0, fq0, fa0, lv,
                                     sg, n_pad, n_q, kprime, 3)
        cwant = mesh.mesh_bm25_coarse_plain(bd, bt16, dl16, fi0, fw0, fq0,
                                            fa0, lv, sg, n_pad, n_q, kprime,
                                            3)
        torch.cuda.synchronize()
        compare(torch, "mesh_bm25_coarse", cgot, cwant)
        rgot = mesh.mesh_bm25_rerank(bd, bt, fi0, fw0, fq0, fa0, dl, lv,
                                     cgot[1], cgot[0], n_pad, n_q, kprime, 10)
        rwant = mesh.mesh_bm25_rerank_plain(bd, bt, fi0, fw0, fq0, fa0, dl,
                                            lv, cgot[1], cgot[0], n_pad, n_q,
                                            kprime, 10)
        torch.cuda.synchronize()
        compare(torch, "mesh_bm25_rerank", rgot, rwant)
        for s in range(n_slots):
            k3 = bm.bm25_coarse(bd[s], bt16[s], fi0[s], fw0[s], fq0[s],
                                dl16[s], fa0[s], lv[s], sg[s], n_pad, n_q, 3,
                                kprime)
            compare(torch, f"mesh_bm25_coarse slot {s} vs K3",
                    [x[s] for x in cgot], k3)
            k4 = bm.bm25_rerank(bd[s], bt[s], fi0[s], fw0[s], fq0[s], dl[s],
                                fa0[s], lv[s], cgot[1][s].contiguous(),
                                cgot[0][s].contiguous(), n_pad, n_q, kprime,
                                10)
            compare(torch, f"mesh_bm25_rerank slot {s} vs K4",
                    [x[s] for x in rgot], k4)
        torch.cuda.synchronize()
        if empty >= 0:
            check(not torch.isfinite(got[0][empty]).any() and
                  int(got[2][empty].sum()) == 0,
                  "mesh-small: the empty slot scored")
        log(f"mesh-small: S={n_slots} dp={dp} n_docs_pad={n_pad} "
            f"fb={fi.shape[-1]} n_q={n_q}: the three mesh kernels bitwise "
            f"equal to their plain versions and, slot by slot, to K2/K3/K4")


MESH_TE_TEXTS = ("w1 w3 w5", "w2 w9 w17 w40", "w7 w11 w13")


def mesh_te_features():
    """Every feature of the model_text bodies' expansions (the port
    model's on the CPU, so both nodes' docs hold the same maps)."""
    from elasticsearch_tpu_torch.ml import get_model
    model = get_model(None, "cpu")
    return sorted({f for t in MESH_TE_TEXTS for f in model.expand(t)})


def mesh_engine_docs(np, n: int, seed: int, base: int):
    """Seeded docs for the mesh-engine index: Zipf(1.35) words over
    30,000, a keyword tag, a 16-dim vector and 2-5 rank_features out of
    f0..f199, plus 0-2 of ``mesh_te_features`` drawn from a stream of
    their own (so the rest of every doc is what it was without them)."""
    rng = np.random.default_rng(seed)
    extra = np.random.default_rng(seed + 1)
    words = [f"w{i}" for i in range(30_000)]
    names = mesh_te_features()
    lens = rng.integers(8, 64, n)
    vecs = np.round(rng.standard_normal((n, 16)), 4).tolist()
    docs = []
    for i in range(n):
        terms = zipf_terms(np, rng, int(lens[i]), 30_000)
        feats = rng.integers(0, 200, int(rng.integers(2, 6)))
        ml = {f"f{int(f)}": round(float(rng.uniform(0.1, 3.0)), 3)
              for f in feats}
        for f in extra.choice(len(names), int(extra.integers(0, 3)),
                              replace=False):
            ml[names[int(f)]] = round(float(extra.uniform(0.1, 3.0)), 3)
        docs.append((str(base + i), {
            "body": " ".join(words[int(t)] for t in terms),
            "tag": f"t{i % 7}", "v": vecs[i], "ml": ml}))
    return docs


def mesh_engine_bodies(np):
    """(name, body, query params, kind) of the mesh-engine mix: match at
    totals default / true / false / 7, bool of should-matches, DFS
    versions, kNN bodies, and text_expansion bodies in tokens form (a
    boost, totals true / false / 100) and in model_text form (kind
    ``model_text``), all of them mesh-served."""
    rng = np.random.default_rng(SEED + 811)
    words = [f"w{i}" for i in range(30_000)]

    def text(n):
        return " ".join(words[int(t)] for t in zipf_terms(np, rng, n,
                                                           30_000))
    out = []
    for q in range(8):
        t = text(int(rng.integers(2, 7)))
        for track in (None, True, False, 7):
            body = {"query": {"match": {"body": t}}, "size": 10}
            if track is not None:
                body["track_total_hits"] = track
            out.append((f"match{q}_{track}", body, None, "text"))
    for q in range(3):
        body = {"query": {"bool": {"should": [
            {"match": {"body": text(2)}},
            {"match": {"body": {"query": text(3), "boost": 1.5}}}]}},
            "size": 8}
        out.append((f"bool_should{q}", body, None, "text"))
    for q in range(3):
        body = {"query": {"match": {"body": text(3)}}, "size": 10}
        if q == 1:
            body["track_total_hits"] = False
        out.append((f"dfs{q}", body,
                    {"search_type": "dfs_query_then_fetch"}, "text"))
    for q in range(2):
        out.append((f"knn{q}", {"query": {"knn": {
            "field": "v", "k": 10, "num_candidates": 50,
            "query_vector": [round(float(x), 4)
                             for x in rng.standard_normal(16)]}}},
            None, "knn"))

    def te(**opts):
        return {"text_expansion": {"ml": opts}}

    def toks():
        return {f"f{int(f)}": 1.0 + 0.25 * j for j, f in
                enumerate(rng.integers(0, 200, 3))}
    for name, extra in (("sparse0", {}), ("sparse1", {}),
                        ("sparse_totals_true", {"track_total_hits": True}),
                        ("sparse_totals_false", {"track_total_hits": False}),
                        ("sparse_totals_100", {"track_total_hits": 100})):
        out.append((name, {"query": te(tokens=toks()), **extra}, None,
                    "sparse"))
    out.append(("sparse_boost", {"query": te(tokens=toks(), boost=2.5),
                                 "size": 7}, None, "sparse"))
    for q, text in enumerate(MESH_TE_TEXTS):
        body = {"query": te(model_text=text)}
        if q == 1:
            body["query"]["text_expansion"]["ml"]["boost"] = 1.5
        if q == 2:
            body["track_total_hits"] = True
        out.append((f"model_text{q}", body, None, "model_text"))
    return out


def mesh_engine_node(device, n_docs: int):
    """A one-node port cluster on ``device`` holding ``mesh`` (4 shards, 0
    replicas): two bulk halves with a refresh between, then deletes."""
    from elasticsearch_tpu_torch.testing import InProcessCluster
    import numpy as np
    cluster = InProcessCluster(n_nodes=1, seed=SEED + 812, device=device)
    cluster.start()
    node = RestNode(cluster)
    node.ok("PUT", "/mesh", {"settings": {
        "number_of_shards": MESH_SHARDS, "number_of_replicas": 0},
        "mappings": MESH_MAPPINGS})
    docs = mesh_engine_docs(np, n_docs, SEED + 813, 0)
    for lo in range(0, n_docs, 2000):
        resp = node.ok("POST", "/_bulk",
                       raw=bulk_ndjson("mesh", docs[lo: lo + 2000]))
        check(not resp["errors"], f"mesh-engine: bulk errors ({device})")
        if lo == (n_docs // 4000) * 2000:
            node.ok("POST", "/mesh/_refresh")
    node.ok("POST", "/mesh/_refresh")
    deletes = [str(i) for i in range(0, n_docs, 97)]
    node.ok("POST", "/_bulk", raw=bulk_ndjson("mesh", [], deletes=deletes))
    node.ok("POST", "/mesh/_refresh")
    return node


def mesh_engine_refresh(np, node, n_docs: int) -> None:
    """Writes between two request rounds: new docs, deletes, a refresh."""
    more = mesh_engine_docs(np, 500, SEED + 814, n_docs)
    node.ok("POST", "/_bulk", raw=bulk_ndjson(
        "mesh", more, deletes=[str(i) for i in range(5, n_docs, 211)]))
    node.ok("POST", "/mesh/_refresh")


def mesh_engine_round(node, bodies):
    return [node.call("POST", "/mesh/_search", body, query)
            for _n, body, query, _k in bodies]


def mesh_engine_cpu_answers(n_docs: int):
    """Run in a worker process: the CPU node's answers, before and after
    the writes between rounds."""
    import numpy as np
    node = mesh_engine_node("cpu", n_docs)
    bodies = mesh_engine_bodies(np)
    first = mesh_engine_round(node, bodies)
    mesh_engine_refresh(np, node, n_docs)
    second = mesh_engine_round(node, bodies)
    node.cluster.stop()
    return first, second


def without_route(resp):
    return {k: v for k, v in resp.items() if k not in ("took",
                                                        "_data_plane")}


def same_as_fanout(body, meshed, fanned) -> bool:
    """A mesh-served answer against the same node's per-shard fan-out:
    the JSON equal apart from ``took`` and the routing label -- except, for
    a text body with ``track_total_hits: false``, the value of the total,
    a lower bound
    ("gte") on both paths: the mesh's tier falls back to the exact path
    for the whole fan-out where the fan-out falls back shard by shard, and
    the two paths count observed matches differently (the JAX package
    does the same; ROADMAP queue 3, item 15)."""
    a, b = without_route(meshed), without_route(fanned)
    if json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True):
        return True
    if body.get("track_total_hits") is False:
        if not (a["hits"]["total"]["relation"] == "gte" ==
                b["hits"]["total"]["relation"]):
            return False
        a = dict(a, hits={k: v for k, v in a["hits"].items()
                          if k != "total"})
        b = dict(b, hits={k: v for k, v in b["hits"].items()
                          if k != "total"})
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def same_or_bounded(body, a, b, exact: int):
    """Two nodes' answers to one body, as ``same_json`` compares them --
    except, for ``track_total_hits: false``, the total's value: a lower
    bound that each node's own tier decisions may set (ROADMAP queue 3,
    items 2 and 7), so each is held to len(hits) <= bound <= ``exact``
    (the body's exact match count) and the rest compared as it stands.
    Returns None when they agree, else where they differ."""
    why = same_json(a, b)
    if why is None or body.get("track_total_hits") is not False:
        return why
    for name, resp in (("a", a), ("b", b)):
        total, hits = resp["hits"]["total"], resp["hits"]["hits"]
        if not len(hits) <= total["value"] <= exact:
            return (f"$.hits.total of {name}: {total} outside "
                    f"[{len(hits)}, {exact}]")
    strip = [dict(r, hits=dict(r["hits"], total=dict(
        r["hits"]["total"], value=None))) for r in (a, b)]
    return same_json(*strip)


def mesh_engine_exact(node, bodies):
    """Per body with ``track_total_hits: false``, its exact match count
    (``_count``, which no mesh serves); None for the others."""
    return [node.ok("POST", "/mesh/_count", {"query": body["query"]})[
        "count"] if body.get("track_total_hits") is False else None
        for _n, body, _q, _k in bodies]


def phase_mesh_engine(torch, np, dev, n_docs: int) -> None:
    """A card node and a CPU node (in a worker process) on a 4-shard
    index: the same text bodies (totals true / false / 7, bool of
    should-matches, DFS), kNN and text_expansion bodies (tokens with a
    boost and totals true / false / 100, model_text), a round of writes
    and a refresh, the bodies again; every answer equal on the two nodes
    (a model_text body only where the card's and the CPU's rewrites give
    the same tokens: K18 and its plain version may round a weight apart),
    the card node's mesh-served answers equal to its own with
    ``search.mesh.enabled: false``, ``mesh_searches`` growing, the kNN
    and text_expansion bodies mesh-served and nothing counted as not
    ported."""
    import multiprocessing as mp
    from elasticsearch_tpu_torch.ml.text_expansion import (
        rewrite_body_expansions,
    )
    from elasticsearch_tpu_torch.search import telemetry
    t0 = time.monotonic()
    pool = mp.get_context("spawn").Pool(1)
    try:
        cpu = pool.apply_async(mesh_engine_cpu_answers, (n_docs,))
        node = mesh_engine_node(dev, n_docs)
        bodies = mesh_engine_bodies(np)
        executor = node.node().search_transport.mesh_executor
        stats0 = dict(executor.stats)
        np0 = dict(telemetry.TELEMETRY.not_ported)
        lat = []
        rounds, exact = [], []
        for r in range(2):
            if r:
                mesh_engine_refresh(np, node, n_docs)
            got = []
            for _n, body, query, _k in bodies:
                t1 = time.monotonic()
                got.append(node.call("POST", "/mesh/_search", body, query))
                lat.append(time.monotonic() - t1)
            rounds.append(got)
            exact.append(mesh_engine_exact(node, bodies))
        served = executor.stats["mesh_searches"] - stats0["mesh_searches"]
        declined = {k: telemetry.TELEMETRY.not_ported.get(f"mesh_{k}", 0)
                    - np0.get(f"mesh_{k}", 0) for k in ("knn", "sparse")}
        node.ok("PUT", "/_cluster/settings",
                {"persistent": {"search.mesh.enabled": False}})
        off = mesh_engine_round(node, bodies)
        node.ok("PUT", "/_cluster/settings",
                {"persistent": {"search.mesh.enabled": True}})
        want = cpu.get()
    finally:
        pool.terminate()
        pool.join()
    n_mesh, rounded_apart = 0, set()
    for name, body, _q, kind in bodies:
        if kind == "model_text" and rewrite_body_expansions(body, dev) != \
                rewrite_body_expansions(body, "cpu"):
            rounded_apart.add(name)
    for r, (got, cpu_round) in enumerate(zip(rounds, want)):
        for (name, body, _q, kind), g, w, n_exact in zip(bodies, got,
                                                          cpu_round,
                                                          exact[r]):
            check(g[0] == w[0] == 200, f"mesh-engine: {name}: status "
                  f"{g[0]} / {w[0]}: {str(g[1])[:300]}")
            if name not in rounded_apart:
                why = same_or_bounded(body, w[1], g[1], n_exact)
                check(why is None, f"mesh-engine: round {r} {name}: card "
                      f"and cpu differ at {why}")
            if kind != "text":
                check(g[1].get("_data_plane") == "mesh_plane",
                      f"mesh-engine: {name} was not mesh-served")
            if kind in ("sparse", "model_text"):
                check(bool(g[1]["hits"]["hits"]),
                      f"mesh-engine: {name} matched nothing")
            n_mesh += g[1].get("_data_plane") == "mesh_plane"
    for (name, body, _q, _k), g, o in zip(bodies, rounds[1], off):
        check(o[0] == 200 and "_data_plane" not in o[1],
              f"mesh-engine: {name} with the mesh off: {str(o[1])[:300]}")
        check(same_as_fanout(body, g[1], o[1]),
              f"mesh-engine: {name}: mesh and fan-out answers differ")
    check(served == n_mesh and served > 0,
          f"mesh-engine: mesh_searches grew {served}, labels {n_mesh}")
    check(declined == {"knn": 0, "sparse": 0},
          f"mesh-engine: counted as not ported {declined}")
    lat.sort()
    log(f"mesh-engine: {len(bodies)} bodies x 2 rounds equal on the card "
        f"node and the cpu node ({len(rounded_apart)} model_text bodies "
        f"whose two rewrites rounded a weight apart held to the card's own "
        f"fan-out only), {n_mesh} mesh-served (equal to the card's own "
        f"fan-out), not ported {declined}; card p50 "
        f"{1e3 * lat[len(lat) // 2]:.3f} ms p99 {1e3 * pct(lat, 0.99):.3f} "
        f"ms ({time.monotonic() - t0:.1f}s in all); executor "
        f"{executor.stats}")
    node.cluster.stop()
    from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
    MESH_PLANES.clear()


def routing_shards(np, first: int, n: int, n_shards: int):
    """[n] int: the shard ``_bulk`` routes _id ``str(first + j)`` to --
    ``utils/murmur3.shard_id_for`` (MurmurHash3 x86 32 over the id's UTF-8
    bytes, modulo the shard count), vectorized over decimal ids."""
    mask = np.uint64(0xFFFFFFFF)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & mask

    def mix(k):
        k = (k * np.uint64(0xCC9E2D51)) & mask
        return (rotl(k, 15) * np.uint64(0x1B873593)) & mask

    ids = np.arange(first, first + n, dtype=np.int64)
    lens = np.ones(n, np.int64)
    for p in range(1, 19):
        lens += ids >= 10 ** p
    out = np.empty(n, np.int64)
    for width in np.unique(lens):
        sel = lens == width
        v = ids[sel]
        b = [((v // 10 ** (width - 1 - p)) % 10 + 48).astype(np.uint64)
             for p in range(width)]
        h = np.zeros(len(v), np.uint64)
        for blk in range(width // 4):
            k = (b[4 * blk] | (b[4 * blk + 1] << np.uint64(8)) |
                 (b[4 * blk + 2] << np.uint64(16)) |
                 (b[4 * blk + 3] << np.uint64(24)))
            h ^= mix(k)
            h = rotl(h, 13)
            h = (h * np.uint64(5) + np.uint64(0xE6546B64)) & mask
        tail = b[(width // 4) * 4:]
        if tail:
            k = np.zeros(len(v), np.uint64)
            for t, x in enumerate(tail):
                k ^= x << np.uint64(8 * t)
            h ^= mix(k)
        h ^= np.uint64(width)
        h ^= h >> np.uint64(16)
        h = (h * np.uint64(0x85EBCA6B)) & mask
        h ^= h >> np.uint64(13)
        h = (h * np.uint64(0xC2B2AE35)) & mask
        h ^= h >> np.uint64(16)
        out[sel] = (h % np.uint64(n_shards)).astype(np.int64)
    return out


def routed_ids(np, sizes, n_shards: int):
    """[chunk] -> _ids (int64, ascending) for the docs of each chunk of
    the MS MARCO corpus such that chunk ``c``'s docs all route to shard
    ``c`` under ``_bulk``'s murmur3 routing: its i-th doc gets the i-th
    integer whose route is ``c``."""
    m = sum(sizes) + sum(sizes) // 20 + 1024
    while True:
        route = routing_shards(np, 0, m, n_shards)
        picks = [np.flatnonzero(route == c)[:n] for c, n in enumerate(sizes)]
        if all(len(p) == n for p, n in zip(picks, sizes)):
            return picks
        m += m // 10


def routed_segments(np, source, label: str):
    """[shard] -> its one segment: ``source``'s segment ``c`` (its field
    data shared, not copied) as shard ``c``, under _ids that route there
    (``routed_ids``)."""
    from elasticsearch_tpu_torch.index.segment import Segment
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for
    picks = routed_ids(np, [s.n_docs for s in source], MESH_SHARDS)
    segs = []
    for c, (src, ids) in enumerate(zip(source, picks)):
        seg = Segment(f"{label}{c}_gen", src.n_docs)
        seg.postings.update(src.postings)
        seg.features.update(src.features)
        seg.ids = [str(int(k)) for k in ids]
        for j in range(0, len(ids), max(1, len(ids) // 64)):
            check(shard_id_for(seg.ids[j], MESH_SHARDS) == c,
                  f"{label}: _id {seg.ids[j]} does not route to {c}")
        seg.id_to_doc = {d: j for j, d in enumerate(seg.ids)}
        seg.sources = [None] * src.n_docs
        seg.invalidate_live_count()
        segs.append(seg)
    return segs


def rewrap(seg):
    """A new segment over ``seg``'s field data and _ids (shared, not
    copied), for installing one corpus into a second node."""
    from elasticsearch_tpu_torch.index.segment import Segment
    out = Segment(seg.name + "_again", seg.n_docs)
    out.postings.update(seg.postings)
    out.features.update(seg.features)
    out.vectors.update(seg.vectors)
    out.keywords.update(seg.keywords)
    out.doc_values.update(seg.doc_values)
    out.ids = seg.ids
    out.id_to_doc = seg.id_to_doc
    out.sources = [None] * seg.n_docs
    out.invalidate_live_count()
    return out


def mesh_full_segments(torch, np, dev, n_docs: int, workers: int,
                       source=None):
    """The full phase's chunks (the same generator and seeds; its
    segments reused when ``source`` is given) as the 4 shards under
    routed _ids."""
    if source is None:
        source = build_full_shard(torch, np, dev, n_docs, workers)
    return routed_segments(np, source, "msm")


def mesh_full_queries(np, n_q: int):
    """The full phase's queries: 2-7 Zipf(1.35) words."""
    rng = np.random.default_rng(SEED + 7)
    out = []
    for _ in range(n_q):
        ids = np.minimum(rng.zipf(1.35, int(rng.integers(2, 7))) - 1,
                         VOCAB - 1)
        out.append({"query": {"match": {"body": " ".join(
            f"t{i}" for i in ids)}}, "size": 10, "_source": False})
    return out


def phase_mesh_full(torch, np, dev, n_docs: int, workers: int,
                    n_q: int, source=None, kept=None) -> None:
    """The mesh's text path at MS MARCO passage scale on one card node:
    the full phase's 8,841,823 docs on 4 primary shards (0 replicas), each
    doc under an _id that routes to its shard, each shard one generated
    segment installed with ``restore_segments``;
    64 solo ``match`` bodies with the tier on, the same 64 with it off,
    the 64 as one wave; then each answer against the same node's with
    ``search.mesh.enabled: false`` (the per-shard fan-out through K1-K4).
    Mesh-served requests launch no K1-K4."""
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
    from elasticsearch_tpu_torch.search import telemetry
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    from elasticsearch_tpu_torch.testing import InProcessCluster
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for
    t0 = time.monotonic()
    segs = mesh_full_segments(torch, np, dev, n_docs, workers, source)
    log(f"mesh-full: {n_docs} docs on {MESH_SHARDS} shards "
        f"{[s.n_docs for s in segs]} under routed _ids (one segment each, "
        f"{[s.postings['body'].block_docs.shape[0] for s in segs]} posting "
        f"blocks) in {time.monotonic() - t0:.1f}s")
    cluster = InProcessCluster(n_nodes=1, seed=SEED + 820, device=dev)
    cluster.start()
    node = RestNode(cluster)
    node.ok("PUT", "/msm", {"settings": {
        "number_of_shards": MESH_SHARDS, "number_of_replicas": 0},
        "mappings": {"properties": {"body": {"type": "text"}}}})
    cluster.ensure_green("msm")
    t1 = time.monotonic()
    svc = node.node().indices_service
    for s, seg in enumerate(segs):
        engine = svc.shard("msm", s).engine
        engine.restore_segments(list(engine.segments) + [seg])
    count = node.ok("POST", "/msm/_count", {"query": {"match_all": {}}})
    check(count["count"] == n_docs,
          f"mesh-full: _count {count['count']} != {n_docs}")
    for seg in segs:
        for doc_id in (seg.ids[0], seg.ids[-1]):
            sid = shard_id_for(doc_id, MESH_SHARDS)
            check(doc_id in segs[sid].id_to_doc,
                  f"mesh-full: _id {doc_id} is not on shard {sid}, where "
                  f"_bulk routes it")
    log(f"mesh-full: restore_segments into 4 shards in "
        f"{time.monotonic() - t1:.1f}s; _count {count['count']}")
    keep_segs = segs if kept is not None else None
    del segs
    bodies = mesh_full_queries(np, n_q)
    executor = node.node().search_transport.mesh_executor
    req = BREAKERS.breaker("request").limit
    devb = BREAKERS.breaker("device").limit
    t2 = time.monotonic()
    first = node.ok("POST", "/msm/_search", bodies[0])
    check(first.get("_data_plane") == "mesh_plane",
          f"mesh-full: the first request was not mesh-served: "
          f"{executor.stats}")
    parts = [p for p in MESH_PLANES._parts.values()
             if p.shard_keys[0][0] == "msm"]
    check(len(parts) == 1, f"mesh-full: {len(parts)} mesh planes of msm")
    part = parts[0]
    log(f"mesh-full: first request (stacked plane + bf16 mirror built and "
        f"uploaded) {time.monotonic() - t2:.1f}s; plane n_slots="
        f"{part.n_slots} n_docs_pad={part.n_docs_pad} n_blocks_pad="
        f"{part.block_docs.shape[1]} n_segs_max={part.n_segs_max}, "
        f"part.nbytes {part.nbytes}; torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() if dev.type == 'cuda' else 0}; "
        f"breaker limits: device {devb}, request {req}")
    old = ("bm25_flat", "bm25_flat_seg", "bm25_coarse", "bm25_rerank")
    # launches on the card; on the CPU (a rehearsal) the plain versions'
    # calls stand in for them
    what = "launches" if dev.type == "cuda" else "calls"
    before = {f: getattr(DEVICE_PROFILE.family(f), what)
              for f in old + MESH_FAMILIES}
    stats0 = dict(executor.stats)
    mstats0 = dict(MESH_PLANES.stats)
    fb0 = dict(telemetry.TELEMETRY.fallbacks)
    DEVICE_PROFILE.timing = dev.type == "cuda"
    dev0 = device_ms(MESH_FAMILIES)
    legs, answers = {}, {}
    for leg, quantized in (("solo_tier_on", True), ("solo_tier_off", False)):
        node.ok("PUT", "/_cluster/settings", {"persistent": {
            "search.plane.quantized": quantized}})
        times, got = [], []
        for body in bodies:
            t = time.monotonic()
            got.append(node.ok("POST", "/msm/_search", body))
            times.append(time.monotonic() - t)
        legs[leg], answers[leg] = times, got
    node.ok("PUT", "/_cluster/settings", {"persistent": {
        "search.plane.quantized": True}})
    executor.stats["max_occupancy"] = 0
    batches = executor.stats["mesh_batches"]
    t3 = time.monotonic()
    boxes = [node.submit("POST", "/msm/_search", body) for body in bodies]
    cluster.run_until(lambda: all(boxes), 3600.0)
    t_wave = time.monotonic() - t3
    check(all(boxes), "mesh-full: the wave did not finish")
    answers["wave"] = [b[0][1] for b in boxes]
    for b in boxes:
        check(b[0][0] == 200, f"mesh-full: wave request: {b[0][0]}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    DEVICE_PROFILE.timing = False
    kern = {f: round(v - dev0[f], 3)
            for f, v in device_ms(MESH_FAMILIES).items()}
    after = {f: getattr(DEVICE_PROFILE.family(f), what)
             for f in old + MESH_FAMILIES}
    delta = {f: after[f] - before[f] for f in after}
    log(f"mesh-full: {what} in the mesh legs {delta}")
    for f in MESH_FAMILIES:
        check(delta[f] > 0, f"mesh-full: {f} never launched")
    for f in old:
        check(delta[f] == 0, f"mesh-full: {f} launched for a mesh-served "
              f"request ({delta[f]})")
    for leg, got in answers.items():
        for q, resp in enumerate(got):
            check(resp.get("_data_plane") == "mesh_plane",
                  f"mesh-full: {leg} request {q} was not mesh-served")
    refusals = {k: telemetry.TELEMETRY.fallbacks.get(k, 0) - fb0.get(k, 0)
                for k in ("mesh_plane_budget_refused",
                          telemetry.MESH_PLANE_MISSING,
                          telemetry.MESH_DRAIN_ERROR)}
    check(executor.stats["mesh_fallbacks"] == stats0["mesh_fallbacks"] and
          not any(refusals.values()),
          f"mesh-full: mesh fallbacks {executor.stats} {refusals}")
    mdelta = {k: MESH_PLANES.stats[k] - mstats0[k] for k in mstats0}
    for leg, times in legs.items():
        log(f"mesh-full: {leg}: {n_q} solo requests p50 "
            f"{1e3 * pct(times, 0.5):.3f} ms p99 {1e3 * pct(times, 0.99):.3f}"
            f" ms mean {1e3 * sum(times) / len(times):.3f} ms")
    log(f"mesh-full: {n_q} requests as one wave in {1e3 * t_wave:.3f} ms "
        f"wall; mesh drains {executor.stats['mesh_batches'] - batches}, max "
        f"occupancy {executor.stats['max_occupancy']}; kernel device ms "
        f"over the three legs {kern}; mesh plane stats {mdelta}; executor "
        f"{executor.stats}; budget refusals {refusals}")
    # the same node's per-shard fan-out (K1-K4) for every answer
    MESH_PLANES.clear()
    node.ok("PUT", "/_cluster/settings", {"persistent": {
        "search.mesh.enabled": False}})
    t4 = time.monotonic()
    for leg, quantized in (("solo_tier_on", True), ("solo_tier_off", False)):
        node.ok("PUT", "/_cluster/settings", {"persistent": {
            "search.plane.quantized": quantized}})
        for q, body in enumerate(bodies):
            want = node.ok("POST", "/msm/_search", body)
            check("_data_plane" not in want, "mesh-full: fan-out labelled")
            ref = json.dumps(without_route(want), sort_keys=True)
            check(json.dumps(without_route(answers[leg][q]),
                             sort_keys=True) == ref,
                  f"mesh-full: {leg} request {q}: mesh != fan-out")
            if quantized:
                check(json.dumps(without_route(answers["wave"][q]),
                                 sort_keys=True) == ref,
                      f"mesh-full: wave request {q}: mesh != fan-out")
            hits = want["hits"]["hits"]
            check(all(math.isfinite(h["_score"]) and h["_score"] > 0
                      for h in hits), f"mesh-full: request {q}: bad scores")
    log(f"mesh-full: {3 * n_q} mesh answers equal the per-shard fan-out's "
        f"({time.monotonic() - t4:.1f}s)")
    if kept is not None:
        # the sharded data plane's text oracle: this node's answers with
        # global term statistics, taken while the fan-out's per-shard
        # state is warm (a re-enabled mesh would rebuild its stack first)
        t5 = time.monotonic()
        dfs = [node.ok("POST", "/msm/_search", body,
                       {"search_type": "dfs_query_then_fetch"})
               for body in bodies[:SHARDED_DFS_ORACLE]]
        kept["text"] = {"shards": [[rewrap(seg)] for seg in keep_segs],
                        "bodies": bodies, "oracle": dfs}
        log(f"mesh-full: {len(dfs)} dfs_query_then_fetch answers kept as "
            f"the sharded data plane's oracle "
            f"({time.monotonic() - t5:.1f}s)")
    node.ok("PUT", "/_cluster/settings", {"persistent": {
        "search.mesh.enabled": True, "search.plane.quantized": True}})
    cluster.stop()


MESH_POS = {"mesh_bm25_flat": (9, 10), "mesh_bm25_coarse": (9, 10),
            "mesh_bm25_rerank": (10, 11)}
MESH_SOURCES = {f: f"elasticsearch_tpu_torch/csrc/{f}.cu"
                for f in MESH_FAMILIES}


def mesh_flat_arg(family: str, args):
    return args[2] if family == "mesh_bm25_rerank" else args[3]


def mesh_size(family: str, args):
    """(queries, gathered blocks) of a mesh kernel call."""
    return args[MESH_POS[family][1]], mesh_flat_arg(family, args).numel()


def mesh_bound(family: str, args):
    """(bound_ms, bound_by, bytes): K2/K3/K4's bound summed over the
    slots -- the gathered blocks and flat rows of every (slot, row), the
    doc lengths of gathered postings, each slot's live mask (and seg ids
    for the counting tiers), the outputs -- over the memory rate, or the
    arithmetic over the peak rate, whichever is larger."""
    block_tfs = args[1]
    n_slots = block_tfs.shape[0]
    n_docs_pad, n_q = args[MESH_POS[family][0]], args[MESH_POS[family][1]]
    flat = mesh_flat_arg(family, args)
    fb = flat.numel()                     # over every (slot, row)
    groups = fb // flat.shape[-1]
    postings = fb * 128
    nbytes = postings * (4 + block_tfs.element_size()) + fb * 16
    nbytes += min(postings, n_slots * n_docs_pad) * (
        2 if family == "mesh_bm25_coarse" else 4)
    nbytes += n_slots * n_docs_pad                    # live masks
    rows = groups * n_q
    if family == "mesh_bm25_flat":
        k, n_segs = args[11], args[12]
        nbytes += n_slots * n_docs_pad * 4 + rows * (k * 8 + n_segs * 4)
    elif family == "mesh_bm25_coarse":
        kp, n_segs = args[11], args[12]
        nbytes += n_slots * n_docs_pad * 4 + rows * (kp * 8 + n_segs * 4)
    else:
        kp, k = args[12], args[13]
        nbytes += rows * (kp * 8 + k * 8 + 4)
    ops = postings * 8
    peak = BF16_FLOPS if family == "mesh_bm25_coarse" else F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def mesh_plain_bytes(family: str, args) -> int:
    """Rough peak device bytes of the plain version (one slot's one-shard
    plain version at a time, plane_bytes' 48 a posting and 40 a cell)."""
    flat = mesh_flat_arg(family, args)
    n_slots = args[1].shape[0]
    per_slot = flat.numel() // n_slots
    plane = 0 if family == "mesh_bm25_rerank" else \
        args[MESH_POS[family][1]] * args[MESH_POS[family][0]] * 40
    return per_slot * 128 * 48 + plane


def phase_mesh_kernels(torch, rec, launches) -> list:
    """Rows 31-33 bitwise against their plain versions on up to 4 of the
    main path's calls, then timed (CUDA events) at the largest call whose
    plain version fits on the card, and at the largest call of all."""
    from elasticsearch_tpu_torch.parallel import mesh
    rows = []
    for fam in MESH_FAMILIES:
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        kernel, plain = getattr(mesh, fam), getattr(mesh, fam + "_plain")
        torch.cuda.empty_cache()
        room = 0.85 * torch.cuda.mem_get_info()[0]
        fit = [c for c in calls if mesh_plain_bytes(fam, c[0]) < room]
        check(bool(fit), f"kernels: no {fam} call's plain version fits")
        err = 0.0
        for args, kwargs in fit[:4]:
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            err = max(err, compare(torch, fam, got, want))
            del got, want
        args, kwargs = max(fit, key=lambda c: mesh_size(fam, c[0]))
        ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
        plain_ms = time_call(torch, lambda: plain(*args, **kwargs), 5)
        bound_ms, bound_by, nbytes = mesh_bound(fam, args)
        shape = (f"S={args[1].shape[0]} fb={mesh_flat_arg(fam, args).numel()}"
                 f" n_docs_pad={args[MESH_POS[fam][0]]} "
                 f"n_q={args[MESH_POS[fam][1]]}")
        log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain "
            f"{plain_ms:.4f} ms (median of 5), bound {bound_ms:.4f} ms "
            f"({nbytes} bytes at 3.35 TB/s), max_abs_err {err} over "
            f"{min(len(fit), 4)} main-path calls, timed at {shape}")
        rows.append({
            "name": fam, "route": "cuda", "source": MESH_SOURCES[fam],
            "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape})
        big_args, big_kwargs = max(calls, key=lambda c: mesh_size(fam, c[0]))
        if big_args is not args:
            big_ms = time_call(torch, lambda: kernel(*big_args, **big_kwargs),
                               20)
            big_bound = mesh_bound(fam, big_args)[0]
            log(f"kernel {fam}: {big_ms:.4f} ms (median of 20) at the "
                f"largest main-path call, n_q={big_args[MESH_POS[fam][1]]} "
                f"fb={mesh_flat_arg(fam, big_args).numel()}, bound "
                f"{big_bound:.4f} ms (plain version not run: too large)")
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the mesh's kNN path: one launch per phase over 2 or more shards' vectors
# ---------------------------------------------------------------------------

MESH_KNN_FAMILIES = ("mesh_knn_topk", "mesh_knn_coarse", "mesh_knn_rerank")
ONE_SHARD_KNN = ("knn_flat", "knn_coarse", "knn_rerank", "knn_flat_masked",
                 "knn_coarse_masked", "knn_rerank_masked")
MESH_KNN_DIMS = 128
MESH_KNN_MAPPINGS = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "vec": {"type": "dense_vector", "dims": MESH_KNN_DIMS,
            "similarity": "cosine"},
    "ml": {"type": "rank_features"}}}


def mesh_knn_stack(np, rng, n_slots: int, n_docs: int, dims: int, n_q: int,
                   empty: int):
    """Seeded stacked vector planes of ``n_slots`` shards of different
    sizes (knn_inputs per slot; slot ``empty`` holds nothing), padded as
    MeshPlaneRegistry._stack pads them, per-query filter rows [S, Q, N]
    (about half of each slot's docs) and queries [Q, D] (the last all
    zero); returns the host arrays and the slots' own n_docs_pad."""
    sizes = [int(rng.integers(n_docs // 3, n_docs)) for _ in range(n_slots)]
    pads = [1 << max(7, math.ceil(math.log2(n))) for n in sizes]
    n_max = max(pads)
    matrix = np.zeros((n_slots, n_max, dims), np.float32)
    exists = np.zeros((n_slots, n_max), bool)
    live = np.zeros((n_slots, n_max), bool)
    masks = np.zeros((n_slots, n_q, n_max), bool)
    for s, n in enumerate(sizes):
        if s == empty:
            continue
        m, _nr, ex, lv, _q = knn_inputs(np, rng, n, n_max, dims, 1)
        matrix[s], exists[s], live[s] = m, ex, lv
        masks[s, :, :n] = rng.random((n_q, n)) < 0.5
    norms = np.linalg.norm(matrix, axis=2).astype(np.float32)
    queries = rng.standard_normal((n_q, dims), dtype=np.float32)
    queries[-1] = 0.0
    return (matrix, norms, live & exists, masks, queries), pads


def phase_mesh_knn_small(torch, np, dev) -> None:
    """The three mesh kNN kernels bitwise against their plain versions,
    and each slot bitwise against K5 / K6 / K7 launched on that slot's
    plane, at S 2 and 4 (an empty slot), masked and unmasked, the three
    similarities, over chunked planes; mesh_knn_topk at k 10 and 5,000."""
    from elasticsearch_tpu_torch.ops import knn
    from elasticsearch_tpu_torch.ops.device_segment import quantize_rows
    from elasticsearch_tpu_torch.parallel import mesh
    rng = np.random.default_rng(SEED + 900)
    n = 0
    for n_slots, n_docs, n_q, empty in ((2, 150_000, 8, -1),
                                        (4, 70_000, 16, 2)):
        host, pads = mesh_knn_stack(np, rng, n_slots, n_docs,
                                    MESH_KNN_DIMS, n_q, empty)
        matrix = host[0]
        s_, n_pad, dims = matrix.shape
        q8, scales = quantize_rows(matrix.reshape(s_ * n_pad, dims))
        T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        m, nr, al, mks, qs = (T(a) for a in host)
        q8 = T(q8.reshape(s_, n_pad, dims))
        scales = T(scales.reshape(s_, n_pad))
        batch = knn.QueryBatch(host[4], dev)
        qq, qscale = batch.quantized()
        qn, q2 = batch.qn, batch.q2
        for sim in ("cosine", "dot_product", "l2_norm"):
            for mk in (None, mks):
                tag = (f"S={n_slots} n_docs_pad={n_pad} Q={n_q} {sim} "
                       f"{'masked' if mk is not None else 'unmasked'}")
                ks = (10, 5000) if n_slots == 2 and sim != "dot_product" \
                    else (10,)
                for k in ks:
                    got = mesh.mesh_knn_topk(m, nr, al, qs, qn, q2, k, sim,
                                             mk)
                    want = mesh.mesh_knn_topk_plain(m, nr, al, qs, qn, q2,
                                                    k, sim, mk)
                    torch.cuda.synchronize()
                    compare(torch, f"mesh_knn_topk {tag} k={k}", got, want)
                    for si in range(n_slots):
                        one = knn.knn_flat(m[si], nr[si], al[si], qs, qn, q2,
                                           k, sim,
                                           None if mk is None else mk[si])
                        compare(torch, f"mesh_knn_topk {tag} k={k} slot {si}"
                                f" vs K5", [x[si] for x in got], one)
                    n += 1
                    del got, want
                cgot = mesh.mesh_knn_coarse(q8, scales, nr, al, qq, qscale,
                                            qn, q2, 256, sim, mk)
                cwant = mesh.mesh_knn_coarse_plain(q8, scales, nr, al, qq,
                                                   qscale, qn, q2, 256, sim,
                                                   mk)
                torch.cuda.synchronize()
                compare(torch, f"mesh_knn_coarse {tag}", cgot, cwant)
                rgot = mesh.mesh_knn_rerank(m, nr, al, qs, qn, q2, cgot[1],
                                            cgot[0], 10, sim, mk)
                rwant = mesh.mesh_knn_rerank_plain(m, nr, al, qs, qn, q2,
                                                   cgot[1], cgot[0], 10, sim,
                                                   mk)
                torch.cuda.synchronize()
                compare(torch, f"mesh_knn_rerank {tag}", rgot, rwant)
                for si in range(n_slots):
                    mks_i = None if mk is None else mk[si]
                    k6 = knn.knn_coarse(q8[si], scales[si], nr[si], al[si],
                                        qq, qscale, qn, q2, 256, sim, mks_i)
                    compare(torch, f"mesh_knn_coarse {tag} slot {si} vs K6",
                            [x[si] for x in cgot], k6)
                    k7 = knn.knn_rerank(m[si], nr[si], al[si], qs, qn, q2,
                                        cgot[1][si].contiguous(),
                                        cgot[0][si].contiguous(), 10, sim,
                                        mks_i)
                    compare(torch, f"mesh_knn_rerank {tag} slot {si} vs K7",
                            [x[si] for x in rgot], k7)
                torch.cuda.synchronize()
                if empty >= 0:
                    check(not torch.isfinite(cgot[0][empty]).any() and
                          bool((rgot[1][empty] == -1).all()),
                          f"mesh-knn-small: the empty slot scored ({tag})")
                n += 2
        log(f"mesh-knn-small: S={n_slots} n_docs_pad={n_pad} (slots "
            f"{pads}) Q={n_q}: the three mesh kNN kernels bitwise equal to "
            f"their plain versions and, slot by slot, to K5/K6/K7")
        del m, q8, mks
        torch.cuda.empty_cache()
    log(f"mesh-knn-small: {n} mesh kNN kernel calls checked (3 "
        f"similarities, masked and unmasked, k 10 and 5,000)")


def mesh_knn_engine_docs(np, n: int, seed: int, base: int):
    """Seeded docs for the mesh-knn-engine index: a 128-dim Gaussian
    vector (every 25th doc without one), a keyword tag of 7 values, a few
    words and rank_features."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(2_000)]
    vecs = np.round(rng.standard_normal((n, MESH_KNN_DIMS)), 4).tolist()
    docs = []
    for i in range(n):
        src = {"body": " ".join(words[int(t)] for t in
                                zipf_terms(np, rng, 6, 2_000)),
               "tag": f"t{(base + i) % 7}",
               "ml": {f"f{int(f)}": round(float(rng.uniform(0.1, 3.0)), 3)
                      for f in rng.integers(0, 50, 3)}}
        if (base + i) % 25:
            src["vec"] = vecs[i]
        docs.append((str(base + i), src))
    return docs


def mesh_knn_engine_bodies(np):
    """(name, body, kind) of the mesh-knn-engine mix: knn at k 10 and 100,
    term-filtered knn, hybrid rank.rrf, and text_expansion (mesh-served
    too)."""
    rng = np.random.default_rng(SEED + 911)

    def vec():
        return [round(float(x), 4) for x in
                rng.standard_normal(MESH_KNN_DIMS)]
    out = []
    for q in range(6):
        k = 10 if q % 2 == 0 else 100
        out.append((f"knn{q}_k{k}", {"query": {"knn": {
            "field": "vec", "k": k, "num_candidates": max(2 * k, 50),
            "query_vector": vec()}}, "size": 10}, "knn"))
    for q in range(3):
        out.append((f"knn_filtered{q}", {"query": {"knn": {
            "field": "vec", "k": 10, "query_vector": vec(),
            "filter": {"term": {"tag": f"t{q}"}}}}, "size": 10}, "knn"))
    for q in range(2):
        out.append((f"rrf{q}", {
            "query": {"match": {"body": "w1 w3 w7"}},
            "knn": {"field": "vec", "k": 20, "num_candidates": 40,
                    "query_vector": vec()},
            "rank": {"rrf": {"rank_window_size": 30}}, "size": 10},
            "hybrid"))
        out.append((f"sparse{q}", {"query": {"text_expansion": {"ml": {
            "tokens": {f"f{int(f)}": 1.0 + 0.5 * j for j, f in
                       enumerate(rng.integers(0, 50, 3))}}}}},
            "sparse"))
    wave = [(f"wave_t{t}", {"query": {"knn": {
        "field": "vec", "k": 10, "query_vector": vec(),
        "filter": {"term": {"tag": f"t{t}"}}}}, "size": 10}, "knn")
        for t in (3, 5)]
    return out, wave


def mesh_knn_engine_node(device, n_docs: int):
    """A one-node port cluster on ``device`` holding ``knnm`` (4 shards, 0
    replicas): two bulk halves with a refresh between, then deletes."""
    from elasticsearch_tpu_torch.testing import InProcessCluster
    import numpy as np
    cluster = InProcessCluster(n_nodes=1, seed=SEED + 912, device=device)
    cluster.start()
    node = RestNode(cluster)
    node.ok("PUT", "/knnm", {"settings": {
        "number_of_shards": MESH_SHARDS, "number_of_replicas": 0},
        "mappings": MESH_KNN_MAPPINGS})
    docs = mesh_knn_engine_docs(np, n_docs, SEED + 913, 0)
    half = n_docs // 2
    for lo, hi in ((0, half), (half, n_docs)):
        resp = node.ok("POST", "/_bulk",
                       raw=bulk_ndjson("knnm", docs[lo: hi]))
        check(not resp["errors"], f"mesh-knn-engine: bulk errors ({device})")
        node.ok("POST", "/knnm/_refresh")
    deletes = [str(i) for i in range(0, n_docs, 89)]
    node.ok("POST", "/_bulk", raw=bulk_ndjson("knnm", [], deletes=deletes))
    node.ok("POST", "/knnm/_refresh")
    return node


def mesh_knn_engine_refresh(np, node, n_docs: int) -> None:
    """Writes between two request rounds: new docs, deletes, a refresh."""
    more = mesh_knn_engine_docs(np, 400, SEED + 914, n_docs)
    node.ok("POST", "/_bulk", raw=bulk_ndjson(
        "knnm", more, deletes=[str(i) for i in range(7, n_docs, 173)]))
    node.ok("POST", "/knnm/_refresh")


def mesh_knn_engine_round(node, bodies, wave):
    """The bodies one by one, then the wave's bodies submitted together
    (one mesh drain, differently filtered: the masked launches)."""
    out = [node.call("POST", "/knnm/_search", body)
           for _n, body, _k in bodies]
    boxes = [node.submit("POST", "/knnm/_search", body)
             for _n, body, _k in wave]
    node.cluster.run_until(lambda: all(boxes), 600.0)
    check(all(boxes), "mesh-knn-engine: the wave did not finish")
    return out + [b[0] for b in boxes]


def mesh_knn_engine_cpu_answers(n_docs: int):
    """Run in a worker process: the CPU node's answers, before and after
    the writes between rounds."""
    import numpy as np
    node = mesh_knn_engine_node("cpu", n_docs)
    bodies, wave = mesh_knn_engine_bodies(np)
    first = mesh_knn_engine_round(node, bodies, wave)
    mesh_knn_engine_refresh(np, node, n_docs)
    second = mesh_knn_engine_round(node, bodies, wave)
    node.cluster.stop()
    return first, second


def masked_calls(families) -> int:
    """Calls whose shape label marks a per-query mask stack."""
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    return sum(n for f in families
               for label, n in DEVICE_PROFILE.family(f).shapes.items()
               if label.endswith("/masked"))


def phase_mesh_knn_engine(torch, np, dev, n_docs: int) -> None:
    """A card node and a CPU node (in a worker process) on a 4-shard index
    of 128-dim vectors: knn at k 10 and 100, term-filtered knn, two
    differently filtered knn as one wave (the masked launches), hybrid
    rank.rrf and text_expansion bodies, a round of writes and a refresh,
    the bodies again; every answer equal on the two nodes, the card
    node's mesh-served answers equal to its own with
    ``search.mesh.enabled: false``, ``mesh_searches`` growing for the knn
    and text_expansion bodies, and nothing counted as not ported."""
    import multiprocessing as mp
    from elasticsearch_tpu_torch.search import telemetry
    t0 = time.monotonic()
    pool = mp.get_context("spawn").Pool(1)
    try:
        cpu = pool.apply_async(mesh_knn_engine_cpu_answers, (n_docs,))
        node = mesh_knn_engine_node(dev, n_docs)
        # the card's first mesh search would otherwise take the RPC detour
        # while CUDA initializes (mesh_ready never pays first-init)
        node.ok("POST", "/knnm/_search", {"query": {"knn": {
            "field": "vec", "k": 1, "query_vector": [1.0] * MESH_KNN_DIMS}},
            "size": 1})
        bodies, wave = mesh_knn_engine_bodies(np)
        executor = node.node().search_transport.mesh_executor
        stats0 = dict(executor.stats)
        np0 = dict(telemetry.TELEMETRY.not_ported)
        masked0 = masked_calls(MESH_KNN_FAMILIES)
        lat, rounds = [], []
        for r in range(2):
            if r:
                mesh_knn_engine_refresh(np, node, n_docs)
            t1 = time.monotonic()
            rounds.append(mesh_knn_engine_round(node, bodies, wave))
            lat.append(time.monotonic() - t1)
        served = executor.stats["mesh_searches"] - stats0["mesh_searches"]
        declined = telemetry.TELEMETRY.not_ported.get("mesh_sparse", 0) - \
            np0.get("mesh_sparse", 0)
        masked = masked_calls(MESH_KNN_FAMILIES) - masked0
        node.ok("PUT", "/_cluster/settings",
                {"persistent": {"search.mesh.enabled": False}})
        off = [node.call("POST", "/knnm/_search", body)
               for _n, body, _k in bodies + wave]
        node.ok("PUT", "/_cluster/settings",
                {"persistent": {"search.mesh.enabled": True}})
        want = cpu.get()
    finally:
        pool.terminate()
        pool.join()
    n_mesh = 0
    every = bodies + wave
    for r, (got, cpu_round) in enumerate(zip(rounds, want)):
        for (name, _b, kind), g, w in zip(every, got, cpu_round):
            check(g[0] == w[0] == 200, f"mesh-knn-engine: {name}: status "
                  f"{g[0]} / {w[0]}: {str(g[1])[:300]}")
            why = same_json(w[1], g[1])
            check(why is None, f"mesh-knn-engine: round {r} {name}: card "
                  f"and cpu differ at {why}")
            if kind in ("knn", "sparse"):
                check(g[1].get("_data_plane") == "mesh_plane",
                      f"mesh-knn-engine: {name} was not mesh-served")
            n_mesh += g[1].get("_data_plane") == "mesh_plane"
    for (name, body, _k), g, o in zip(every, rounds[1], off):
        check(o[0] == 200 and "_data_plane" not in o[1],
              f"mesh-knn-engine: {name} with the mesh off: "
              f"{str(o[1])[:300]}")
        check(same_as_fanout(body, g[1], o[1]),
              f"mesh-knn-engine: {name}: mesh and fan-out answers differ")
    n_knn = sum(2 for *_x, kind in every if kind in ("knn", "sparse"))
    check(served >= n_mesh >= n_knn,
          f"mesh-knn-engine: mesh_searches grew {served}, labels {n_mesh}, "
          f"knn and text_expansion bodies {n_knn}")
    check(declined == 0,
          f"mesh-knn-engine: {declined} sparse fan-outs counted as not "
          f"ported")
    check(masked > 0, "mesh-knn-engine: the differently filtered wave "
          "launched no masked mesh kNN kernel")
    log(f"mesh-knn-engine: {len(every)} bodies x 2 rounds equal on the card "
        f"node and the cpu node, {n_mesh} mesh-served (equal to the card's "
        f"own fan-out), {masked} masked mesh kNN calls, not ported "
        f"{declined}; rounds {[round(1e3 * x, 1) for x in lat]} ms "
        f"({time.monotonic() - t0:.1f}s in all); executor "
        f"{executor.stats}")
    node.cluster.stop()
    from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
    MESH_PLANES.clear()


MESH_KNN_SEGS = 4           # segments a shard: 62,500 docs, under 65,536
MESH_KNN_TAGS = 8           # distinct tag filters in the filtered legs


def mesh_knn_full_segments(np, n_docs: int):
    """[shard] -> its segments, and the 1,000,000 SIFT1M-shaped rows:
    build_sift_shard's generator and seeds (its four chunks become the
    four shards), each chunk under _ids that route to its shard
    (``routed_ids``), cut into MESH_KNN_SEGS segments of about 62,500 docs
    (under the 65,536-doc ANN threshold), with a 100-value ``tag``
    keyword (``add_tag_column``)."""
    from elasticsearch_tpu_torch.index.segment import Segment, VectorField
    rng = np.random.default_rng(SEED + 200)
    centers = rng.integers(16, 200, (1000, SIFT_DIMS)).astype(np.float32)
    sizes = [n_docs // 4 + (1 if i < n_docs % 4 else 0) for i in range(4)]
    chunks = [sift_shaped(np, SEED + 201 + i, n, centers)
              for i, n in enumerate(sizes)]
    queries = sift_shaped(np, SEED + 299, 64, centers)
    picks = routed_ids(np, sizes, MESH_SHARDS)
    shards, tags = [], []
    for c, (m, ids) in enumerate(zip(chunks, picks)):
        per = -(-len(ids) // MESH_KNN_SEGS)
        segs = []
        for j in range(MESH_KNN_SEGS):
            lo, hi = j * per, min(len(ids), (j + 1) * per)
            seg = Segment(f"sknn{c}_{j}", hi - lo)
            rows = m[lo:hi]
            seg.vectors["vec"] = VectorField(
                matrix=rows, exists=np.ones(hi - lo, bool),
                norms=np.linalg.norm(rows, axis=1).astype(np.float32),
                similarity="cosine", dims=SIFT_DIMS)
            seg.ids = [str(int(k)) for k in ids[lo:hi]]
            seg.id_to_doc = {d: i for i, d in enumerate(seg.ids)}
            seg.sources = [None] * (hi - lo)
            segs.append(seg)
        base = sum(sizes[:c]) + np.arange(MESH_KNN_SEGS) * per
        tags.append(add_tag_column(np, segs, base))
        for seg in segs:
            seg.invalidate_live_count()
        shards.append(segs)
    return shards, np.concatenate(chunks), np.concatenate(tags), \
        np.concatenate(picks), queries


def phase_mesh_knn_full(torch, np, dev, n_docs: int, n_q: int,
                        kept=None) -> dict:
    """BASELINE #2's SIFT1M shape on 4 primary shards of one card node,
    each doc under an _id that routes to its shard, each shard 4 segments
    of about 62,500 docs installed with ``restore_segments``; through the
    REST controller: n_q solo ``knn`` bodies (k 10, num_candidates 100)
    with the tier on, the same with it off, the n_q as one wave, then n_q
    bodies filtered by one of 8 tag terms, solo and as one wave; each
    answer against the same node's with ``search.mesh.enabled: false``
    (the per-shard fan-out through K5-K7). Mesh-served requests launch no
    K5-K7. Returns each mesh kNN family's mean device ms a launch over the
    legs."""
    from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
    from elasticsearch_tpu_torch.search import telemetry
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    from elasticsearch_tpu_torch.testing import InProcessCluster
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for
    t0 = time.monotonic()
    shards, corpus, tags, ids, queries = mesh_knn_full_segments(np, n_docs)
    queries = queries[:n_q]
    sizes = [[s.n_docs for s in segs] for segs in shards]
    log(f"mesh-knn-full: {n_docs} x {SIFT_DIMS} SIFT1M-shaped docs on "
        f"{MESH_SHARDS} shards {[sum(x) for x in sizes]} of {MESH_KNN_SEGS} "
        f"segments ({max(map(max, sizes))} docs at most) under routed _ids, "
        f"in {time.monotonic() - t0:.1f}s")
    cluster = InProcessCluster(n_nodes=1, seed=SEED + 920, device=dev)
    cluster.start()
    node = RestNode(cluster)
    node.ok("PUT", "/sknn", {"settings": {
        "number_of_shards": MESH_SHARDS, "number_of_replicas": 0},
        "mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": SIFT_DIMS,
                    "similarity": "cosine"},
            "tag": {"type": "keyword"}}}})
    cluster.ensure_green("sknn")
    t1 = time.monotonic()
    svc = node.node().indices_service
    for s, segs in enumerate(shards):
        engine = svc.shard("sknn", s).engine
        engine.restore_segments(list(engine.segments) + segs)
        for seg in segs[:: MESH_KNN_SEGS - 1]:
            check(shard_id_for(seg.ids[-1], MESH_SHARDS) == s,
                  f"mesh-knn-full: _id {seg.ids[-1]} does not route to {s}")
    count = node.ok("POST", "/sknn/_count", {"query": {"match_all": {}}})
    check(count["count"] == n_docs,
          f"mesh-knn-full: _count {count['count']} != {n_docs}")
    log(f"mesh-knn-full: restore_segments into 4 shards in "
        f"{time.monotonic() - t1:.1f}s; _count {count['count']}")
    keep_shards = shards if kept is not None else None
    del shards
    rng = np.random.default_rng(SEED + 921)
    tag_of = [int(x) for x in rng.choice(100, MESH_KNN_TAGS, replace=False)]

    def body(qi, filtered):
        knn = {"field": "vec", "k": 10, "num_candidates": 100,
               "query_vector": [float(x) for x in queries[qi]]}
        if filtered:
            knn["filter"] = {"term": {"tag": f"t{tag_of[qi % len(tag_of)]}"}}
        return {"query": {"knn": knn}, "size": 10, "_source": False}
    plain = [body(q, False) for q in range(n_q)]
    filtered = [body(q, True) for q in range(n_q)]
    executor = node.node().search_transport.mesh_executor
    t2 = time.monotonic()
    first = node.ok("POST", "/sknn/_search", plain[0])
    check(first.get("_data_plane") == "mesh_plane",
          f"mesh-knn-full: the first request was not mesh-served: "
          f"{executor.stats} {dict(telemetry.TELEMETRY.fallbacks)}")
    parts = [p for p in MESH_PLANES._parts.values()
             if p.shard_keys[0][0] == "sknn"]
    check(len(parts) == 1, f"mesh-knn-full: {len(parts)} mesh planes")
    part = parts[0]
    exact_bytes = sum(t.numel() * t.element_size()
                      for t in (part.matrix, part.norms, part.exists))
    log(f"mesh-knn-full: first request (stacked plane + int8 mirror built "
        f"and uploaded) {time.monotonic() - t2:.1f}s; plane n_slots="
        f"{part.n_slots} n_docs_pad={part.n_docs_pad} dims={part.dims}; "
        f"stacked bytes {exact_bytes}, with the mirror part.nbytes "
        f"{part.nbytes} (mirror + scales {part.nbytes - exact_bytes}); "
        f"torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() if dev.type == 'cuda' else 0}")
    what = "launches" if dev.type == "cuda" else "calls"
    fams = ONE_SHARD_KNN + MESH_KNN_FAMILIES
    before = {f: getattr(DEVICE_PROFILE.family(f), what) for f in fams}
    stats0, mstats0 = dict(executor.stats), dict(MESH_PLANES.stats)
    fb0 = dict(telemetry.TELEMETRY.fallbacks)
    DEVICE_PROFILE.timing = dev.type == "cuda"
    dev0 = device_ms(MESH_KNN_FAMILIES)
    legs, answers, walls = {}, {}, {}

    def solo(leg, bodies):
        times, got = [], []
        for b in bodies:
            t = time.monotonic()
            got.append(node.ok("POST", "/sknn/_search", b))
            times.append(time.monotonic() - t)
        legs[leg], answers[leg] = times, got

    def wave(leg, bodies):
        executor.stats["max_occupancy"] = 0
        drains = executor.stats["mesh_batches"]
        m0 = masked_calls(MESH_KNN_FAMILIES)
        t = time.monotonic()
        boxes = [node.submit("POST", "/sknn/_search", b) for b in bodies]
        cluster.run_until(lambda: all(boxes), 3600.0)
        walls[leg] = (time.monotonic() - t,
                      executor.stats["mesh_batches"] - drains,
                      executor.stats["max_occupancy"],
                      masked_calls(MESH_KNN_FAMILIES) - m0)
        check(all(boxes), f"mesh-knn-full: {leg} did not finish")
        for b in boxes:
            check(b[0][0] == 200, f"mesh-knn-full: {leg}: {b[0][0]}")
        answers[leg] = [b[0][1] for b in boxes]

    quant = {"persistent": {"search.plane.quantized": True}}
    solo("solo_tier_on", plain)
    node.ok("PUT", "/_cluster/settings",
            {"persistent": {"search.plane.quantized": False}})
    solo("solo_tier_off", plain)
    node.ok("PUT", "/_cluster/settings", quant)
    wave("wave", plain)
    solo("filtered_solo", filtered)
    wave("filtered_wave", filtered)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    DEVICE_PROFILE.timing = False
    kern = {f: round(v - dev0[f], 3)
            for f, v in device_ms(MESH_KNN_FAMILIES).items()}
    after = {f: getattr(DEVICE_PROFILE.family(f), what) for f in fams}
    delta = {f: after[f] - before[f] for f in fams}
    log(f"mesh-knn-full: {what} in the mesh legs {delta}")
    for f in MESH_KNN_FAMILIES:
        check(delta[f] > 0, f"mesh-knn-full: {f} never launched")
    for f in ONE_SHARD_KNN:
        check(delta[f] == 0, f"mesh-knn-full: {f} launched for a "
              f"mesh-served request ({delta[f]})")
    check(walls["filtered_wave"][3] > 0, "mesh-knn-full: the filtered wave "
          "launched no masked mesh kNN kernel")
    for leg, got in answers.items():
        for q, resp in enumerate(got):
            check(resp.get("_data_plane") == "mesh_plane",
                  f"mesh-knn-full: {leg} request {q} was not mesh-served")
    refusals = {k: telemetry.TELEMETRY.fallbacks.get(k, 0) - fb0.get(k, 0)
                for k in (telemetry.MESH_PLANE_BUDGET_REFUSED,
                          telemetry.MESH_PLANE_MISSING,
                          telemetry.MESH_IVF_ROUTED,
                          telemetry.MESH_DRAIN_ERROR)}
    check(executor.stats["mesh_fallbacks"] == stats0["mesh_fallbacks"] and
          not any(refusals.values()),
          f"mesh-knn-full: mesh fallbacks {executor.stats} {refusals}")
    mdelta = {k: MESH_PLANES.stats[k] - mstats0[k] for k in mstats0}
    check(mdelta["mesh_quantized_queries"] > 0,
          f"mesh-knn-full: the tier served nothing: {mdelta}")
    # recall@10 against the float64 exact oracle (global row ids)
    order = np.argsort(ids)
    corpus_dev = torch.as_tensor(corpus, device=dev)
    oracle = cosine_oracle(torch, corpus_dev,
                           torch.as_tensor(queries, device=dev))

    def rows_of(resp):
        got = np.asarray([int(h["_id"]) for h in resp["hits"]["hits"]],
                         np.int64)
        return order[np.searchsorted(ids, got, sorter=order)]
    recall = sum(len(set(rows_of(r)[:10]) & set(oracle[q]))
                 for q, r in enumerate(answers["solo_tier_on"])) / (10 * n_q)
    f_hit = 0
    for q, r in enumerate(answers["filtered_solo"]):
        t = tag_of[q % len(tag_of)]
        docs = np.flatnonzero(tags == t)
        o = cosine_oracle(torch, corpus_dev[torch.as_tensor(docs,
                                                            device=dev)],
                          torch.as_tensor(queries[q: q + 1], device=dev))
        f_hit += len(set(rows_of(r)[:10]) & set(docs[o[0]]))
    f_recall = f_hit / (10 * n_q)
    del corpus_dev
    for leg, times in legs.items():
        log(f"mesh-knn-full: {leg}: {n_q} solo requests p50 "
            f"{1e3 * pct(times, 0.5):.3f} ms p99 {1e3 * pct(times, 0.99):.3f}"
            f" ms mean {1e3 * sum(times) / len(times):.3f} ms")
    for leg, (wall, drains, occ, masked) in walls.items():
        log(f"mesh-knn-full: {leg}: {n_q} requests as one wave in "
            f"{1e3 * wall:.3f} ms wall; mesh drains {drains}, max occupancy "
            f"{occ}, masked mesh kNN calls {masked}")
    log(f"mesh-knn-full: recall@10 against the float64 oracle {recall:.4f} "
        f"(filtered legs {f_recall:.4f}); kernel device ms over the legs "
        f"{kern}; mesh plane stats {mdelta}; executor {executor.stats}; "
        f"refusals {refusals}; torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() if dev.type == 'cuda' else 0}")
    check(recall >= 0.95, f"mesh-knn-full: recall@10 {recall} < 0.95")
    # the same node's per-shard fan-out (K5-K7) for every answer
    MESH_PLANES.clear()
    node.ok("PUT", "/_cluster/settings", {"persistent": {
        "search.mesh.enabled": False}})
    t4 = time.monotonic()
    n_cmp = 0
    exact_answers = []
    for legs_of, quantized, bodies in (
            (("solo_tier_on", "wave"), True, plain),
            (("solo_tier_off",), False, plain),
            (("filtered_solo", "filtered_wave"), True, filtered)):
        node.ok("PUT", "/_cluster/settings", {"persistent": {
            "search.plane.quantized": quantized}})
        for q, b in enumerate(bodies):
            want = node.ok("POST", "/sknn/_search", b)
            if not quantized:
                exact_answers.append(want)
            check("_data_plane" not in want,
                  "mesh-knn-full: fan-out labelled")
            ref = json.dumps(without_route(want), sort_keys=True)
            for leg in legs_of:
                check(json.dumps(without_route(answers[leg][q]),
                                 sort_keys=True) == ref,
                      f"mesh-knn-full: {leg} request {q}: mesh != fan-out")
                n_cmp += 1
            hits = want["hits"]["hits"]
            check(len(hits) == 10 and all(
                math.isfinite(h["_score"]) and 0 < h["_score"] <= 1
                for h in hits), f"mesh-knn-full: request {q}: bad hits")
    node.ok("PUT", "/_cluster/settings", {"persistent": {
        "search.mesh.enabled": True, "search.plane.quantized": True}})
    log(f"mesh-knn-full: {n_cmp} mesh answers equal the per-shard fan-out's "
        f"({time.monotonic() - t4:.1f}s)")
    if kept is not None:
        # the sharded data plane's kNN oracles: the per-shard exact answers
        # and the float64 top-10 as _ids
        kept["knn"] = {"shards": [[rewrap(seg) for seg in segs]
                                  for segs in keep_shards],
                       "bodies": plain, "oracle": exact_answers,
                       "exact_ids": [[str(int(ids[r])) for r in oracle[q]]
                                     for q in range(n_q)]}
    cluster.stop()
    return {f: kern[f] / max(delta[f], 1) for f in MESH_KNN_FAMILIES}


MESH_KNN_SOURCES = {f: f"elasticsearch_tpu_torch/csrc/{f}.cu"
                    for f in MESH_KNN_FAMILIES}


def mesh_knn_dims(family: str, args):
    """(S, N_pad, D, Q, k or k') of a mesh kNN call."""
    s, n, d = args[0].shape
    if family == "mesh_knn_coarse":
        return s, n, d, args[4].shape[0], args[8]
    if family == "mesh_knn_rerank":
        return s, n, d, args[3].shape[0], args[6].shape[2]
    return s, n, d, args[3].shape[0], args[6]


def mesh_knn_size(family: str, args):
    s, n, _d, q, k = mesh_knn_dims(family, args)
    return q, s * n, k


MESH_KNN_MASK_POS = {"mesh_knn_topk": 8, "mesh_knn_coarse": 10,
                     "mesh_knn_rerank": 10}


def mesh_knn_masks(family: str, args, kwargs):
    """The per-query mask stack of a recorded call, or None."""
    pos = MESH_KNN_MASK_POS[family]
    return args[pos] if len(args) > pos else kwargs.get("masks")


def mesh_knn_bound(family: str, args, kwargs):
    """(bound_ms, bound_by, bytes): K5 / K6 / K7's bound (knn_bound)
    summed over the slots -- each input read once (the stack, norms,
    allowed masks, the per-query mask stack when given, the queries),
    each output written once, or the products at the tensor cores' rate
    for the operand type plus ~8 f32 ops a score, whichever is larger."""
    s, n, d, b, k = mesh_knn_dims(family, args)
    masks = mesh_knn_masks(family, args, kwargs)
    if family == "mesh_knn_coarse":
        nbytes = s * n * d + s * n * 9 + b * d + b * 12 + s * b * k * 8
        t_ops = 2 * s * b * n * d / INT8_OPS + 8 * s * b * n / F32_FLOPS
    elif family == "mesh_knn_rerank":
        kp = k
        kk = args[8]
        nbytes = s * b * kp * (d * 4 + 5) + b * d * 4 + b * 8 + \
            s * b * kp * 8 + s * b * kk * 8 + s * b * 4
        t_ops = 2 * s * b * kp * d / BF16_FLOPS + 8 * s * b * kp / F32_FLOPS
        masks = None if masks is None else s * b * kp  # gathered flags
    else:
        nbytes = s * n * d * 4 + s * n * 5 + b * d * 4 + b * 8 + \
            s * b * k * 8
        t_ops = 2 * s * b * n * d / BF16_FLOPS + 8 * s * b * n / F32_FLOPS
    if masks is not None:
        nbytes += masks if isinstance(masks, int) else s * b * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def mesh_knn_library_ms(torch, family: str, args):
    """The bare product and selection over the same stack through library
    calls (torch.matmul in bf16 + torch.topk for mesh_knn_topk,
    torch._int_mm in int8 + torch.topk for mesh_knn_coarse): a yardstick
    for part of the function, not the fused function; None for the
    re-rank, as for K7."""
    s, n, d, b, k = mesh_knn_dims(family, args)
    if family == "mesh_knn_topk":
        a = args[3].to(torch.bfloat16)
        m = args[0].reshape(s * n, d).to(torch.bfloat16)
        return time_call(torch, lambda: torch.topk(
            torch.matmul(a, m.t()).view(b, s, n), k, dim=2), 20)
    if family == "mesh_knn_coarse":
        a = args[4]
        if a.shape[0] < 17:
            a = torch.cat([a, a.new_zeros(32 - a.shape[0], d)])
        m = args[0].reshape(s * n, d).t()
        rows = a.shape[0]
        return time_call(torch, lambda: torch.topk(
            torch._int_mm(a, m).view(rows, s, n).float(), k, dim=2), 20)
    return None


def phase_mesh_knn_kernels(torch, rec, launches, per_launch) -> list:
    """Rows 36, 37 and 39 bitwise against their plain versions on up to 4
    of the main path's calls and the largest, then timed (CUDA events) at
    the largest; ``per_launch`` is each family's mean device ms a launch
    over the mesh-knn-full legs."""
    from elasticsearch_tpu_torch.parallel import mesh
    rows = []
    for fam in MESH_KNN_FAMILIES:
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        kernel, plain = getattr(mesh, fam), getattr(mesh, fam + "_plain")
        err = 0.0
        for args, kwargs in calls[:4] + calls[-1:]:
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            err = max(err, compare(torch, fam, got, want))
            del got, want
        args, kwargs = max(calls, key=lambda c: mesh_knn_size(fam, c[0]))
        ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
        plain_ms = time_call(torch, lambda: plain(*args, **kwargs), 5)
        bound_ms, bound_by, nbytes = mesh_knn_bound(fam, args, kwargs)
        lib = mesh_knn_library_ms(torch, fam, args)
        s, n, d, b, k = mesh_knn_dims(fam, args)
        masked = mesh_knn_masks(fam, args, kwargs) is not None
        shape = (f"S={s} n_docs_pad={n} D={d} Q={b} "
                 f"{'kprime' if fam != 'mesh_knn_topk' else 'k'}={k}"
                 f"{' masked' if masked else ''}")
        log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain "
            f"{plain_ms:.4f} ms (median of 5), bound {bound_ms:.4f} ms "
            f"({nbytes} bytes at 3.35 TB/s, {bound_by}), library "
            f"(product + topk only) {lib}, max_abs_err {err} over "
            f"{min(len(calls), 4) + 1} main-path calls, timed at the "
            f"largest, {shape}; mean a launch over the mesh-knn-full legs "
            f"{per_launch.get(fam)} ms")
        rows.append({
            "name": fam, "route": "cuda", "source": MESH_KNN_SOURCES[fam],
            "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "library_is_partial": lib is not None,
            "ms_per_launch_on_the_legs": per_launch.get(fam),
            "shape": shape})
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the mesh's sparse path: one launch per phase over 2 or more shards'
# rank_features planes
# ---------------------------------------------------------------------------

MESH_SPARSE_FAMILIES = ("mesh_sparse_topk", "mesh_sparse_coarse",
                        "mesh_sparse_rerank")
ONE_SHARD_SPARSE = ("sparse_flat", "sparse_coarse", "sparse_rerank")
MESH_SPARSE_SOURCES = {f: f"elasticsearch_tpu_torch/csrc/{f}.cu"
                       for f in MESH_SPARSE_FAMILIES}


def mesh_sparse_stack(np, rng, n_slots: int, dp: int, n_docs: int, nb: int,
                      n_q: int, per_q: int, empty: int):
    """Seeded stacked rank_features planes of ``n_slots`` shards of
    different sizes (sparse_inputs per slot, tied docs included; slot
    ``empty`` holds nothing), padded as MeshPlaneRegistry._stack pads
    them, and block lists [S, DP, n_q, QB] per (slot, dp row)."""
    stores = []
    for s in range(n_slots):
        n_s = int(rng.integers(n_docs // 3, n_docs))
        nb_s = int(rng.integers(max(8, nb // 2), nb))
        rows = [sparse_inputs(np, rng, n_s, nb_s, n_q, per_q, n_q)
                for _ in range(dp)]
        stores.append((rows, nb_s))
    n_max = max(r[0][5] for r, _nb in stores)
    nb_max = 1 << max(0, math.ceil(math.log2(max(nb for _r, nb in stores))))
    qb = max(r[0][2].shape[1] for r, _nb in stores)
    bd = np.full((n_slots, nb_max, 128), -1, np.int32)
    bw = np.zeros((n_slots, nb_max, 128), np.float32)
    lv = np.zeros((n_slots, n_max), bool)
    idx = np.zeros((n_slots, dp, n_q, qb), np.int32)
    qw = np.zeros((n_slots, dp, n_q, qb), np.float32)
    for s, (rows, nb_s) in enumerate(stores):
        if s == empty:
            continue
        docs, weights, _i, _w, live, n_pad = rows[0]
        bd[s, :nb_s], bw[s, :nb_s], lv[s, :n_pad] = docs, weights, live
        for r, (_d, _wt, i, w, _l, _n) in enumerate(rows):
            idx[s, r, :, : i.shape[1]] = i
            qw[s, r, :, : w.shape[1]] = w
    return bd, bw, idx, qw, lv, n_max


def phase_mesh_sparse_small(torch, np, dev) -> None:
    """The three mesh sparse kernels bitwise against their plain versions,
    and slot by slot against K15 / K16 / K17 launched on that slot's
    plane, at S 2 and 4 (an empty slot, dp rows, chunked planes), k 10 and
    5,000 (the selection's rounds) and k' up to 4,096."""
    from elasticsearch_tpu_torch.ops import sparse
    from elasticsearch_tpu_torch.parallel import mesh
    rng = np.random.default_rng(SEED + 1000)
    n = 0
    for n_slots, dp, n_docs, nb, n_q, per_q, k, kprime, empty in (
            (2, 1, 3000, 64, 4, 12, 10, 64, -1),
            (4, 1, 200_000, 2048, 16, 150, 10, 4096, 2),
            (4, 2, 100_000, 1024, 4, 200, 5000, 256, 3),
            (2, 1, 12_000, 256, 2, 60, 5000, 1024, -1)):
        host = mesh_sparse_stack(np, rng, n_slots, dp, n_docs, nb, n_q,
                                 per_q, empty)
        bd, bw, i4, w4, lv = [torch.as_tensor(a, device=dev)
                              for a in host[:5]]
        n_pad = host[5]
        k = min(k, n_pad)
        got = mesh.mesh_sparse_topk(bd, bw, i4, w4, lv, n_pad, k)
        want = mesh.mesh_sparse_topk_plain(bd, bw, i4, w4, lv, n_pad, k)
        torch.cuda.synchronize()
        compare(torch, "mesh_sparse_topk", got, want)
        for s in range(n_slots):
            for r in range(dp):
                one = sparse.sparse_topk_batch(
                    bd[s], bw[s], i4[s, r].contiguous(),
                    w4[s, r].contiguous(), 1.0, 1.0, lv[s], n_pad, k,
                    "linear", counted=True)
                compare(torch, f"mesh_sparse_topk slot {s} row {r} vs K15",
                        [x[s, r] for x in got], one)
        idx, qw = i4[:, 0].contiguous(), w4[:, 0].contiguous()
        bw16 = bw.to(torch.bfloat16)
        kp = min(kprime, n_pad)
        cgot = mesh.mesh_sparse_coarse(bd, bw16, idx, qw, lv, n_pad, kp)
        cwant = mesh.mesh_sparse_coarse_plain(bd, bw16, idx, qw, lv, n_pad,
                                              kp)
        torch.cuda.synchronize()
        compare(torch, "mesh_sparse_coarse", cgot, cwant)
        rgot = mesh.mesh_sparse_rerank(bd, bw, idx, qw, lv, cgot[1], cgot[0],
                                       n_pad, kp, 10)
        rwant = mesh.mesh_sparse_rerank_plain(bd, bw, idx, qw, lv, cgot[1],
                                              cgot[0], n_pad, kp, 10)
        torch.cuda.synchronize()
        compare(torch, "mesh_sparse_rerank", rgot, rwant)
        for s in range(n_slots):
            k16 = sparse.sparse_coarse_kernel(bd[s], bw16[s], idx[s], qw[s],
                                              lv[s], n_pad, kp)
            compare(torch, f"mesh_sparse_coarse slot {s} vs K16",
                    [x[s] for x in cgot], k16)
            k17 = sparse.sparse_rerank_kernel(
                bd[s], bw[s], idx[s], qw[s], lv[s], cgot[1][s].contiguous(),
                cgot[0][s].contiguous(), n_pad, kp, 10)
            compare(torch, f"mesh_sparse_rerank slot {s} vs K17",
                    [x[s] for x in rgot], k17)
        torch.cuda.synchronize()
        if empty >= 0:
            check(not torch.isfinite(got[0][empty]).any() and
                  int(got[2][empty].sum()) == 0 and
                  int(cgot[2][empty].sum()) == 0,
                  "mesh-sparse-small: the empty slot scored")
        n += 3
        log(f"mesh-sparse-small: S={n_slots} dp={dp} n_docs_pad={n_pad} "
            f"QB={i4.shape[-1]} Q={n_q} k={k} k'={kp}: the three mesh "
            f"sparse kernels bitwise equal to their plain versions and, "
            f"slot by slot, to K15/K16/K17")
    log(f"mesh-sparse-small: {n} mesh sparse kernel calls checked")


MESH_SPARSE_POS = {"mesh_sparse_topk": 5, "mesh_sparse_coarse": 5,
                   "mesh_sparse_rerank": 7}


def mesh_sparse_dims(family: str, args):
    """(S, n_docs_pad, query rows over every slot, gathered positions
    with a weight, k or k') of a mesh sparse call."""
    s = args[0].shape[0]
    n_pad = args[MESH_SPARSE_POS[family]]
    idx, qw = args[2], args[3]
    rows = idx.numel() // idx.shape[-1]
    real = int((qw != 0).sum())
    k = args[6] if family != "mesh_sparse_rerank" else args[8]
    return s, n_pad, rows, real, k


def mesh_sparse_size(family: str, args):
    s, n_pad, rows, real, _k = mesh_sparse_dims(family, args)
    return rows, real, s * n_pad


def mesh_sparse_bound(family: str, args):
    """(bound_ms, bound_by, bytes): K15 / K16 / K17's bound (sparse_bound)
    summed over the slots -- each gathered posting of a weighted position
    read once (doc id and weight), the block lists, each slot's live
    mask, the outputs written once -- over the memory rate, or one op a
    posting at the f32 peak, whichever is larger."""
    s, n_pad, rows, real, k = mesh_sparse_dims(family, args)
    postings = real * 128
    nbytes = postings * (4 + args[1].element_size()) + args[2].numel() * 8
    if family == "mesh_sparse_rerank":
        kk = args[9]
        nbytes += rows * k * (8 + 1) + rows * kk * 8 + rows * 4
    else:
        nbytes += s * n_pad + rows * k * 8 + rows * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = postings / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def mesh_sparse_library_ms(torch, family: str, args):
    """Row 38's yardstick, as K15's (sparse_library_ms): index_add_'s f32
    sums of the call's real contributions into a zeroed [rows, n_docs_pad]
    plane, each row's postings read from its own slot's store (the sums
    only: no mask or top-k). None for the coarse and re-rank tiers, as for
    K16 / K17."""
    if family != "mesh_sparse_topk":
        return None
    docs, weights, idx, qw = args[:4]
    s, nb = docs.shape[:2]
    n_pad = args[5]
    rows = idx.numel() // idx.shape[-1]
    per_slot = rows // s
    idx, qw = idx.reshape(rows, -1), qw.reshape(rows, -1)
    r_of, pos = torch.nonzero(qw != 0, as_tuple=True)
    blocks = (r_of // per_slot) * nb + idx[r_of, pos].long()
    d = docs.reshape(s * nb, 128)[blocks]
    c = (qw[r_of, pos][:, None] * weights.reshape(s * nb, 128)[blocks]
         ).reshape(-1)
    tgt = (r_of[:, None] * n_pad + d.clamp_min(0).long()).reshape(-1)
    keep = d.reshape(-1) >= 0
    tgt, c = tgt[keep], c[keep]
    return time_call(torch, lambda: torch.zeros(
        rows * n_pad, device=docs.device).index_add_(0, tgt, c), 20)


def mesh_sparse_full_segments(np, n_docs: int, workers: int, source=None):
    """sparse-full's segments (the same generator and seeds; reused when
    ``source`` is given) as the 4 shards under routed _ids."""
    if source is None:
        source = build_sparse_shard(np, n_docs, workers)
    return routed_segments(np, source, "msp")


def phase_mesh_sparse_full(torch, np, dev, n_docs: int, workers: int,
                           n_q: int, source=None, kept=None) -> dict:
    """The mesh's sparse path at MS MARCO passage scale on one card node:
    sparse-full's 8,841,823 docs (bench.py cfg_sparse: 16-23 features of
    8,192 a doc, weights uniform in [0, 3)) on 4 primary shards (0
    replicas), each doc under an _id that routes to its shard, each shard
    one generated segment installed with ``restore_segments``; through the
    REST controller n_q solo ``text_expansion`` bodies in tokens form
    (sparse-full's texts, expanded once) with the tier on, the same with it
    off, the n_q as one wave, and 16 solo ``model_text`` bodies; each
    answer equal to the same node's per-shard fan-out
    (``search.mesh.enabled: false``, K15-K17), bitwise, and every top-10
    to a float64 oracle up to near-ties. The mesh legs must launch every
    mesh sparse family and no K15-K17, with no budget refusal, drain error
    or mesh fallback. Returns each family's mean device ms a launch over
    the legs."""
    from elasticsearch_tpu_torch.indices.breaker import BREAKERS
    from elasticsearch_tpu_torch.ml import get_model
    from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
    from elasticsearch_tpu_torch.search import telemetry
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    from elasticsearch_tpu_torch.testing import InProcessCluster
    on_card = dev.type == "cuda"
    t0 = time.monotonic()
    segs = mesh_sparse_full_segments(np, n_docs, workers, source)
    log(f"mesh-sparse-full: {n_docs} docs on {MESH_SHARDS} shards "
        f"{[s.n_docs for s in segs]} under routed _ids (one segment each, "
        f"{[s.features['ml'].block_docs.shape[0] for s in segs]} feature "
        f"blocks) in {time.monotonic() - t0:.1f}s")
    cluster = InProcessCluster(n_nodes=1, seed=SEED + 1020, device=dev)
    cluster.start()
    node = RestNode(cluster)
    node.ok("PUT", "/msp", {"settings": {
        "number_of_shards": MESH_SHARDS, "number_of_replicas": 0},
        "mappings": {"properties": {"ml": {"type": "rank_features"}}}})
    cluster.ensure_green("msp")
    t1 = time.monotonic()
    svc = node.node().indices_service
    for s, seg in enumerate(segs):
        engine = svc.shard("msp", s).engine
        engine.restore_segments(list(engine.segments) + [seg])
    count = node.ok("POST", "/msp/_count", {"query": {"match_all": {}}})
    check(count["count"] == n_docs,
          f"mesh-sparse-full: _count {count['count']} != {n_docs}")
    log(f"mesh-sparse-full: restore_segments into 4 shards in "
        f"{time.monotonic() - t1:.1f}s; _count {count['count']}")
    texts = sparse_texts(np, np.random.default_rng(SEED + 51), n_q)
    tokens = get_model(None, dev).expand_batch(texts)
    bodies = [{"query": {"text_expansion": {"ml": {"tokens": t}}},
               "size": 10, "_source": False} for t in tokens]
    mt_texts = sparse_texts(np, np.random.default_rng(SEED + 1021), 16)
    mt_bodies = [{"query": {"text_expansion": {"ml": {"model_text": t}}},
                  "size": 10, "_source": False} for t in mt_texts]
    executor = node.node().search_transport.mesh_executor
    req = BREAKERS.breaker("request").limit
    devb = BREAKERS.breaker("device").limit
    t2 = time.monotonic()
    first = node.ok("POST", "/msp/_search", bodies[0])
    t_first = time.monotonic() - t2
    check(first.get("_data_plane") == "mesh_plane",
          f"mesh-sparse-full: the first request was not mesh-served: "
          f"{executor.stats}")
    parts = [p for p in MESH_PLANES._parts.values()
             if p.shard_keys[0][0] == "msp"]
    check(len(parts) == 1, f"mesh-sparse-full: {len(parts)} mesh planes")
    part = parts[0]
    log(f"mesh-sparse-full: first request (stacked plane + bf16 mirror "
        f"built and uploaded) {t_first:.1f}s; plane n_slots={part.n_slots} "
        f"n_docs_pad={part.n_docs_pad} n_blocks_pad="
        f"{part.block_docs.shape[1]}, part.nbytes {part.nbytes} "
        f"(block_docs + block_weights {part.block_docs.numel() * 8}, bf16 "
        f"mirror {2 * part.block_weights.numel()}); "
        f"torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() if on_card else 0}; breaker "
        f"limits: device {devb}, request {req}")
    what = "launches" if on_card else "calls"
    watched = ONE_SHARD_SPARSE + MESH_SPARSE_FAMILIES
    before = {f: getattr(DEVICE_PROFILE.family(f), what) for f in watched}
    stats0 = dict(executor.stats)
    mstats0 = dict(MESH_PLANES.stats)
    fb0 = dict(telemetry.TELEMETRY.fallbacks)
    DEVICE_PROFILE.timing = on_card
    dev0 = device_ms(MESH_SPARSE_FAMILIES)
    legs, answers = {}, {}
    for leg, quantized, leg_bodies in (
            ("solo_tier_on", True, bodies), ("solo_tier_off", False, bodies),
            ("model_text_solo", True, mt_bodies)):
        node.ok("PUT", "/_cluster/settings", {"persistent": {
            "search.plane.quantized": quantized}})
        times, got = [], []
        for body in leg_bodies:
            t = time.monotonic()
            got.append(node.ok("POST", "/msp/_search", body))
            times.append(time.monotonic() - t)
        legs[leg], answers[leg] = times, got
    node.ok("PUT", "/_cluster/settings", {"persistent": {
        "search.plane.quantized": True}})
    executor.stats["max_occupancy"] = 0
    batches = executor.stats["mesh_batches"]
    t3 = time.monotonic()
    boxes = [node.submit("POST", "/msp/_search", body) for body in bodies]
    cluster.run_until(lambda: all(boxes), 3600.0)
    t_wave = time.monotonic() - t3
    check(all(boxes), "mesh-sparse-full: the wave did not finish")
    for b in boxes:
        check(b[0][0] == 200, f"mesh-sparse-full: wave request: {b[0][0]}")
    answers["wave"] = [b[0][1] for b in boxes]
    if on_card:
        torch.cuda.synchronize()
    DEVICE_PROFILE.timing = False
    kern = {f: v - dev0[f]
            for f, v in device_ms(MESH_SPARSE_FAMILIES).items()}
    after = {f: getattr(DEVICE_PROFILE.family(f), what) for f in watched}
    delta = {f: after[f] - before[f] for f in watched}
    per_launch = {f: kern[f] / delta[f] for f in MESH_SPARSE_FAMILIES
                  if delta[f] and on_card}
    log(f"mesh-sparse-full: {what} in the mesh legs {delta}")
    for f in MESH_SPARSE_FAMILIES:
        check(delta[f] > 0, f"mesh-sparse-full: {f} never launched")
    for f in ONE_SHARD_SPARSE:
        check(delta[f] == 0, f"mesh-sparse-full: {f} launched for a "
              f"mesh-served request ({delta[f]})")
    for leg, got in answers.items():
        for q, resp in enumerate(got):
            check(resp.get("_data_plane") == "mesh_plane",
                  f"mesh-sparse-full: {leg} request {q} was not mesh-served")
    refusals = {k: telemetry.TELEMETRY.fallbacks.get(k, 0) - fb0.get(k, 0)
                for k in ("mesh_plane_budget_refused",
                          telemetry.MESH_PLANE_MISSING,
                          telemetry.MESH_DRAIN_ERROR)}
    check(executor.stats["mesh_fallbacks"] == stats0["mesh_fallbacks"] and
          not any(refusals.values()),
          f"mesh-sparse-full: mesh fallbacks {executor.stats} {refusals}")
    mdelta = {k: MESH_PLANES.stats[k] - mstats0[k] for k in mstats0}
    for leg, times in legs.items():
        log(f"mesh-sparse-full: {leg}: {len(times)} solo requests p50 "
            f"{1e3 * pct(times, 0.5):.3f} ms p99 {1e3 * pct(times, 0.99):.3f}"
            f" ms mean {1e3 * sum(times) / len(times):.3f} ms")
    busy = sum(kern.values()) / max(
        1e3 * (sum(sum(x) for x in legs.values()) + t_wave), 1e-9)
    log(f"mesh-sparse-full: {n_q} requests as one wave in "
        f"{1e3 * t_wave:.3f} ms wall; mesh drains "
        f"{executor.stats['mesh_batches'] - batches}, max occupancy "
        f"{executor.stats['max_occupancy']}; kernel device ms over the "
        f"legs { {f: round(v, 3) for f, v in kern.items()} } (kernel-busy "
        f"share {busy:.4f}), mean a launch {per_launch}; mesh plane stats "
        f"{mdelta}; executor {executor.stats}; budget refusals {refusals}")
    # the float64 oracle on the tokens bodies (solo, tier on)
    for q in range(n_q):
        hits = answers["solo_tier_on"][q]["hits"]["hits"]
        got = []
        for h in hits:
            c = shard_of_hit(h)
            got.append((c, segs[c].id_to_doc[h["_id"]], h["_score"]))
        top, host_total = sparse_oracle(np, segs, tokens[q])
        check(close_to_oracle(top, got), f"mesh-sparse-full: query {q}: "
              f"top-10 differs from the float64 oracle")
        total = answers["solo_tier_on"][q]["hits"]["total"]
        check(total["value"] == min(host_total, 10_000),
              f"mesh-sparse-full: query {q}: total {total} != host count "
              f"{host_total}")
    log(f"mesh-sparse-full: {n_q} top-10s equal the float64 oracle up to "
        f"near-ties, totals the host count")
    # the same node's per-shard fan-out (K15-K17) for every answer
    MESH_PLANES.clear()
    node.ok("PUT", "/_cluster/settings", {"persistent": {
        "search.mesh.enabled": False}})
    t4 = time.monotonic()
    n_cmp = 0
    exact_answers = []
    for leg, quantized, leg_bodies in (
            ("solo_tier_on", True, bodies), ("solo_tier_off", False, bodies),
            ("model_text_solo", True, mt_bodies)):
        node.ok("PUT", "/_cluster/settings", {"persistent": {
            "search.plane.quantized": quantized}})
        for q, body in enumerate(leg_bodies):
            want = node.ok("POST", "/msp/_search", body)
            if leg == "solo_tier_off":
                exact_answers.append(want)
            check("_data_plane" not in want,
                  "mesh-sparse-full: fan-out labelled")
            ref = json.dumps(without_route(want), sort_keys=True)
            check(json.dumps(without_route(answers[leg][q]),
                             sort_keys=True) == ref,
                  f"mesh-sparse-full: {leg} request {q}: mesh != fan-out")
            n_cmp += 1
            if leg == "solo_tier_on":
                check(json.dumps(without_route(answers["wave"][q]),
                                 sort_keys=True) == ref,
                      f"mesh-sparse-full: wave request {q}: mesh != fan-out")
                n_cmp += 1
            hits = want["hits"]["hits"]
            check(bool(hits) and all(math.isfinite(h["_score"]) and
                                     h["_score"] > 0 for h in hits),
                  f"mesh-sparse-full: request {q}: bad or no hits")
    node.ok("PUT", "/_cluster/settings", {"persistent": {
        "search.mesh.enabled": True, "search.plane.quantized": True}})
    log(f"mesh-sparse-full: {n_cmp} mesh answers equal the per-shard "
        f"fan-out's ({time.monotonic() - t4:.1f}s)")
    if kept is not None:
        # the sharded data plane's sparse oracle: the per-shard exact answers
        kept["sparse"] = {"shards": [[rewrap(seg)] for seg in segs],
                          "bodies": bodies, "oracle": exact_answers}
    cluster.stop()
    return per_launch


def shard_of_hit(hit) -> int:
    """The shard a hit's _id routes to (where its doc lives)."""
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id_for
    return shard_id_for(hit["_id"], MESH_SHARDS)


def phase_mesh_sparse_kernels(torch, rec, launches, per_launch) -> list:
    """Rows 34, 35 and 38 bitwise against their plain versions on up to 4
    of the main path's calls and the largest, then timed (CUDA events) at
    the largest; ``per_launch`` is each family's mean device ms a launch
    over the mesh-sparse-full legs."""
    from elasticsearch_tpu_torch.parallel import mesh
    rows = []
    for fam in MESH_SPARSE_FAMILIES:
        calls = rec.calls[fam]
        check(bool(calls), f"kernels: no {fam} call recorded")
        kernel, plain = getattr(mesh, fam), getattr(mesh, fam + "_plain")
        err = 0.0
        for args, kwargs in calls[:4] + calls[-1:]:
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            err = max(err, compare(torch, fam, got, want))
            del got, want
        args, kwargs = max(calls, key=lambda c: mesh_sparse_size(fam, c[0]))
        ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
        plain_ms = time_call(torch, lambda: plain(*args, **kwargs), 5)
        bound_ms, bound_by, nbytes = mesh_sparse_bound(fam, args)
        lib = mesh_sparse_library_ms(torch, fam, args)
        s, n_pad, q_rows, real, k = mesh_sparse_dims(fam, args)
        shape = (f"S={s} n_docs_pad={n_pad} rows={q_rows} "
                 f"weighted_positions={real} "
                 f"{'k' if fam == 'mesh_sparse_topk' else 'kprime'}={k}")
        log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain "
            f"{plain_ms:.4f} ms (median of 5), bound {bound_ms:.4f} ms "
            f"({nbytes} bytes at 3.35 TB/s, {bound_by}), library "
            f"(index_add_ sums only) {lib}, max_abs_err {err} over "
            f"{min(len(calls), 4) + 1} main-path calls, timed at the "
            f"largest, {shape}; mean a launch over the mesh-sparse-full "
            f"legs {per_launch.get(fam)} ms")
        rows.append({
            "name": fam, "route": "cuda", "source": MESH_SPARSE_SOURCES[fam],
            "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "library_is_partial": lib is not None,
            "ms_per_launch_on_the_legs": per_launch.get(fam),
            "shape": shape})
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the sharded data plane: a mesh_data_plane=True node, one launch a request
# over the index cut round-robin into S slots (rows 40-44)
# ---------------------------------------------------------------------------

SHARDED_FAMILIES = ("sharded_knn", "sharded_bm25", "sharded_bm25_batch",
                    "sharded_sparse", "sharded_hybrid")
# the families a mesh_data_plane node's requests launch (rows 41 and 44
# have no served caller in either package)
SHARDED_SERVED = ("sharded_knn", "sharded_bm25_batch", "sharded_sparse")
SHARDED_SOURCES = {f: f"elasticsearch_tpu_torch/csrc/{f}.cu"
                   for f in SHARDED_FAMILIES}
REPLACES.update({
    "sharded_knn": "elasticsearch_tpu/parallel/sharded_search.py:151",
    "sharded_bm25": "elasticsearch_tpu/parallel/sharded_search.py:240",
    "sharded_bm25_batch": "elasticsearch_tpu/parallel/sharded_search.py:265",
    "sharded_sparse": "elasticsearch_tpu/parallel/sharded_search.py:634",
    "sharded_hybrid": "elasticsearch_tpu/parallel/sharded_search.py:777",
})
# what a served request must not launch: the one-shard scoring kernels and
# the mesh executor's
NOT_ON_THE_DATA_PLANE = ("bm25_flat", "bm25_flat_seg", "bm25_coarse",
                         "bm25_rerank", "knn_flat", "knn_coarse",
                         "knn_rerank", "sparse_flat", "sparse_coarse",
                         "sparse_rerank") + MESH_FAMILIES + \
    MESH_KNN_FAMILIES + MESH_SPARSE_FAMILIES
SIMILARITIES = ("cosine", "dot_product", "l2_norm")
# the slots the full cell's data plane cuts each index into (a default
# node takes 8, which the CPU parity tests hold against the JAX package's
# node); at 4 the MS MARCO copy is 2,097,152 blocks a slot, 8.66 GB on the
# card and as much on the host
SHARDED_SLOTS = 4
# the text bodies the data plane's answers are held to a DFS oracle for,
# the first 8 of the 64: each DFS request costs mesh-full's node about 2 s
# (NVIDIA H100 80GB HBM3, 700 W), its block-max bounds recomputed for
# every request
SHARDED_DFS_ORACLE = 8


def sharded_operands(torch, np, dev, rng, n_slots: int, n_docs: int,
                     dims: int, n_q: int):
    """Seeded operands of rows 40-44 on one layout, on ``dev``: Zipf docs
    (every 9th a copy of an earlier one: score ties) packed by
    ``ShardedTextIndex`` on ``dev``, their Gaussian vectors on the same N
    (every 7th a copy), n_q queries: the first few copies of doc vectors
    and copies nudged by 1e-3 (l2 at near-zero distances), each query's
    BM25 block lists [S, n_q, QB], rank_features weights on the text
    blocks and one query's lists [S, 16] with padding entries."""
    from elasticsearch_tpu_torch.ops.knn import query_norms
    from elasticsearch_tpu_torch.parallel import (
        ShardedTextIndex, ShardedVectorIndex, make_mesh,
    )
    docs = []
    for i in range(n_docs):
        if i % 9 == 8:
            docs.append(docs[int(rng.integers(0, i))])
            continue
        docs.append([f"t{min(int(rng.zipf(1.3)) - 1, 499)}"
                     for _ in range(int(rng.integers(2, 13)))])
    mesh = make_mesh(n_slots, device=dev)
    text = ShardedTextIndex(mesh, docs)
    vectors = rng.standard_normal((n_docs, dims)).astype(np.float32)
    vectors[6::7] = vectors[: len(vectors[6::7])]
    vec = ShardedVectorIndex(mesh, vectors, n_per_shard=text.n_per_shard)
    queries = rng.standard_normal((n_q, dims)).astype(np.float32)
    queries[:3] = vectors[[5, 12, 40]]
    queries[3:6] = vectors[[5, 13, 41]] + np.float32(1e-3)
    qn, q2 = query_norms(queries)
    lists = [text.prep_query([f"t{int(t)}" for t in
                              rng.integers(0, 60, int(rng.integers(1, 4)))])
             for _ in range(n_q)]
    qb = max(x[0].shape[1] for x in lists)
    idx = np.zeros((n_slots, n_q, qb), np.int32)
    w = np.zeros((n_slots, n_q, qb), np.float32)
    for q, (i_, w_) in enumerate(lists):
        idx[:, q, : i_.shape[1]] = i_
        w[:, q, : w_.shape[1]] = w_
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa
    nb = text.block_docs.shape[1]
    weights = torch.where(text.block_docs >= 0, text.block_tfs * T(
        rng.uniform(0.1, 3.0, tuple(text.block_docs.shape)).astype(
            np.float32)), torch.zeros((), device=dev))
    s_idx = rng.integers(0, nb, (n_slots, 16)).astype(np.int32)
    s_w = rng.uniform(0.2, 2.0, (n_slots, 16)).astype(np.float32)
    s_idx[:, -3:], s_w[:, -3:] = 0, 0.0
    return dict(text=text, vec=vec, queries=T(queries), qn=T(qn), q2=T(q2),
                idx=T(idx), w=T(w), weights=weights.contiguous(),
                s_idx=T(s_idx), s_w=T(s_w))


def phase_sharded_small(torch, np, dev) -> None:
    """Rows 40-44 against their plain versions on the card, bitwise: S 2,
    4 and 8 (the last across two selection chunks), the three
    similarities, Q 1 and 16, counted and not, k 10 and k past the whole
    slot space (the (-inf, -1) padding), queries matching nothing (every
    slot -inf), l2 at zero and near-zero distances, fused branches whose
    ids overlap and a BM25 branch of -1 ids."""
    from elasticsearch_tpu_torch.parallel import sharded_search as sh
    rng = np.random.default_rng(SEED + 1101)
    n = 0
    for n_slots, n_docs in ((2, 3000), (4, 3000), (8, 70_000)):
        op = sharded_operands(torch, np, dev, rng, n_slots, n_docs, 16, 16)
        text, vec = op["text"], op["vec"]
        per = text.n_per_shard
        nb = text.block_docs.shape[1]
        td = (text.block_docs, text.block_tfs, text.doc_lens, text.avgdl)

        def same(name, fn, *args, **kw):
            compare(torch, f"{name} S={n_slots}", fn(*args, **kw),
                    getattr(sh, fn.__name__ + "_plain")(*args, **kw))
        for k in (10, n_slots * per + 3):
            for sim in SIMILARITIES:
                for b in (1, 16):
                    same("sharded_knn", sh.sharded_knn, vec.matrix,
                         vec.norms, vec.valid, op["queries"][:b],
                         op["qn"][:b], op["q2"][:b], k, sim)
                    n += 1
            for q in (0, 1):
                same("sharded_bm25", sh.sharded_bm25, *td,
                     op["idx"][:, q].contiguous(),
                     op["w"][:, q].contiguous(), k)
            same("sharded_bm25 (no match)", sh.sharded_bm25, *td,
                 op["idx"][:, 0].contiguous(),
                 torch.zeros_like(op["w"][:, 0]), k)
            for b in (1, 16):
                for counted in (False, True):
                    same("sharded_bm25_batch", sh.sharded_bm25_batch, *td,
                         op["idx"][:, :b].contiguous(),
                         op["w"][:, :b].contiguous(), k, counted=counted)
            for w in (op["s_w"], torch.zeros_like(op["s_w"])):
                same("sharded_sparse", sh.sharded_sparse, text.block_docs,
                     op["weights"], op["s_idx"], w, per, k)
            n += 8
        # row 44: overlapping branches (the query vector of the BM25
        # branch's best doc), and a BM25 branch of a few matches (-1 ids)
        idx0 = op["idx"][:, 0].contiguous()
        w0 = op["w"][:, 0].contiguous()
        best = int(sh.sharded_bm25(*td, idx0, w0, 1)[1][0])
        fill = (text.block_docs >= 0).sum(dim=2)
        fill[fill == 0] = 1 << 30
        flat = int(torch.argmin(fill))
        few_idx = torch.zeros_like(idx0)
        few_w = torch.zeros_like(w0)
        few_idx[flat // nb, 0], few_w[flat // nb, 0] = flat % nb, 1.5
        qvec = vec.matrix.reshape(-1, vec.matrix.shape[2])[best]
        from elasticsearch_tpu_torch.ops.knn import query_norms
        qn, q2 = (torch.as_tensor(x, device=dev)
                  for x in query_norms(qvec[None].cpu().numpy()))
        for bi, bw in ((idx0, w0), (few_idx, few_w)):
            for sim in SIMILARITIES:
                same("sharded_hybrid", sh.sharded_hybrid, *td, bi, bw,
                     vec.matrix, vec.norms, vec.valid, qvec.contiguous(),
                     qn, q2, 10, similarity=sim)
                n += 1
        got = sh.sharded_hybrid(*td, few_idx, few_w, vec.matrix, vec.norms,
                                vec.valid, qvec.contiguous(), qn, q2, 10)
        check(bool((sh.sharded_bm25(*td, few_idx, few_w, 10)[1] < 0).any())
              and int(got[1][0]) >= 0,
              f"sharded-small: S={n_slots}: the few-match case has no -1")
        torch.cuda.synchronize()
    log(f"sharded-small: {n} calls of rows 40-44 bitwise equal to their "
        f"plain versions on the card (S 2, 4, 8)")


SHARDED_MAPPINGS = {"properties": {
    "body": {"type": "text"},
    **{f"v_{s}": {"type": "dense_vector", "dims": 16, "similarity": s}
       for s in SIMILARITIES},
    "ml": {"type": "rank_features"}}}


def sharded_engine_docs(np, n: int, seed: int, base: int):
    """Seeded docs for the sharded-engine index: 3-24 Zipf(1.35) words
    over 5,000, a 16-dim vector a similarity (unit length for
    dot_product), 2-5 of 64 rank_features; every 11th doc repeats an
    earlier one's fields (ties)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        if i % 11 == 10 and docs:
            docs.append((str(base + i),
                         dict(docs[int(rng.integers(0, len(docs)))][1])))
            continue
        v = rng.standard_normal(16)
        terms = zipf_terms(np, rng, int(rng.integers(3, 25)), 5_000)
        docs.append((str(base + i), {
            "body": " ".join(f"w{int(t)}" for t in terms),
            "v_cosine": [round(float(x), 4) for x in v],
            "v_dot_product": [round(float(x), 6)
                              for x in v / np.linalg.norm(v)],
            "v_l2_norm": [round(float(x), 4) for x in 3.0 * v],
            "ml": {f"f{int(f)}": round(float(rng.uniform(0.1, 3.0)), 3)
                   for f in rng.integers(0, 64, int(rng.integers(2, 6)))}}))
    return docs


def sharded_engine_bodies(np):
    """(name, body) of the sharded-engine mix, every one served by the data
    plane: match at totals default / false / 3, bool of should-matches,
    knn under the three similarities, text_expansion tokens (a boost,
    totals false / 100)."""
    rng = np.random.default_rng(SEED + 1111)

    def text(n):
        return " ".join(f"w{int(t)}" for t in zipf_terms(np, rng, n, 5_000))
    out = []
    for q in range(6):
        t = text(int(rng.integers(2, 6)))
        for track in (None, False, 3):
            body = {"query": {"match": {"body": t}}, "size": 10}
            if track is not None:
                body["track_total_hits"] = track
            out.append((f"match{q}_{track}", body))
    for q in range(2):
        out.append((f"bool_should{q}", {"query": {"bool": {"should": [
            {"match": {"body": text(2)}},
            {"match": {"body": {"query": text(3), "boost": 1.5}}}]}},
            "size": 8}))
    for s in SIMILARITIES:
        for q in range(2):
            v = rng.standard_normal(16)
            if s == "dot_product":
                v = v / np.linalg.norm(v)
            out.append((f"knn_{s}{q}", {"query": {"knn": {
                "field": f"v_{s}", "k": 10, "num_candidates": 50,
                "query_vector": [round(float(x), 6) for x in v]}},
                "size": 10}))
    for name, extra in (("tokens", {}), ("tokens_boost", None),
                        ("tokens_totals_false", {"track_total_hits": False}),
                        ("tokens_totals_100", {"track_total_hits": 100})):
        te = {"tokens": {f"f{int(f)}": 1.0 + 0.25 * j for j, f in
                         enumerate(rng.integers(0, 64, 3))}}
        if extra is None:
            te["boost"] = 2.5
            extra = {}
        out.append((name, {"query": {"text_expansion": {"ml": te}},
                           "size": 7, **extra}))
    return out


def sharded_engine_node(device, n_docs: int):
    """A one-node port cluster with ``mesh_data_plane=True`` on ``device``
    holding ``sh`` (4 shards, 0 replicas): two bulk halves with a refresh
    between, then deletes."""
    from elasticsearch_tpu_torch.testing import InProcessCluster
    import numpy as np
    cluster = InProcessCluster(n_nodes=1, seed=SEED + 1112, device=device,
                               mesh_data_plane=True)
    cluster.start()
    node = RestNode(cluster)
    node.ok("PUT", "/sh", {"settings": {
        "number_of_shards": MESH_SHARDS, "number_of_replicas": 0},
        "mappings": SHARDED_MAPPINGS})
    docs = sharded_engine_docs(np, n_docs, SEED + 1113, 0)
    half = n_docs // 2
    for part in (docs[:half], docs[half:]):
        resp = node.ok("POST", "/_bulk", raw=bulk_ndjson("sh", part))
        check(not resp["errors"], f"sharded-engine: bulk errors ({device})")
        node.ok("POST", "/sh/_refresh")
    node.ok("POST", "/_bulk", raw=bulk_ndjson(
        "sh", [], deletes=[str(i) for i in range(0, n_docs, 53)]))
    node.ok("POST", "/sh/_refresh")
    return node


def sharded_engine_refresh(np, node, n_docs: int) -> None:
    """Writes between two request rounds: new docs, deletes, a refresh."""
    more = sharded_engine_docs(np, 400, SEED + 1114, n_docs)
    node.ok("POST", "/_bulk", raw=bulk_ndjson(
        "sh", more, deletes=[str(i) for i in range(7, n_docs, 101)]))
    node.ok("POST", "/sh/_refresh")


def sharded_engine_rounds(node, bodies, n_docs: int, lat=None):
    """Every body, a round of writes, every body again."""
    import numpy as np
    rounds = []
    for r in range(2):
        if r:
            sharded_engine_refresh(np, node, n_docs)
        got = []
        for _n, body in bodies:
            t1 = time.monotonic()
            got.append(node.call("POST", "/sh/_search", body))
            if lat is not None:
                lat.append(time.monotonic() - t1)
        rounds.append(got)
    return rounds


def sharded_engine_cpu_answers(n_docs: int):
    """Run in a worker process: the CPU node's answers and build stats."""
    import numpy as np
    node = sharded_engine_node("cpu", n_docs)
    rounds = sharded_engine_rounds(node, sharded_engine_bodies(np), n_docs)
    stats = dict(node.node().mesh_plane.stats)
    node.cluster.stop()
    return rounds, stats


def phase_sharded_engine(torch, np, dev, n_docs: int) -> None:
    """A card node and a CPU node (in a worker process), both
    ``mesh_data_plane=True``, on a 4-shard index of ``n_docs`` seeded
    docs: text, bool-should, knn (three similarities) and text_expansion
    bodies, a round of writes (new docs, deletes, a refresh), the bodies
    again: every answer mesh-served (``_data_plane: "mesh"``) and the same
    JSON on both nodes, scores bitwise (each kernel is bitwise its plain
    version); the builds counted alike."""
    import multiprocessing as mp
    t0 = time.monotonic()
    pool = mp.get_context("spawn").Pool(1)
    try:
        cpu = pool.apply_async(sharded_engine_cpu_answers, (n_docs,))
        node = sharded_engine_node(dev, n_docs)
        bodies = sharded_engine_bodies(np)
        plane = node.node().mesh_plane
        q0 = plane.stats["mesh_queries"]
        lat = []
        rounds = sharded_engine_rounds(node, bodies, n_docs, lat)
        want, cpu_stats = cpu.get()
    finally:
        pool.terminate()
        pool.join()
    for r, (got, cpu_round) in enumerate(zip(rounds, want)):
        for (name, _b), g, w in zip(bodies, got, cpu_round):
            check(g[0] == w[0] == 200, f"sharded-engine: {name}: status "
                  f"{g[0]} / {w[0]}: {str(g[1])[:300]}")
            check(g[1].get("_data_plane") == "mesh",
                  f"sharded-engine: round {r} {name} was not served by the "
                  f"data plane: {g[1].get('_data_plane')}")
            check(json.dumps(without_took(g[1]), sort_keys=True) ==
                  json.dumps(without_took(w[1]), sort_keys=True),
                  f"sharded-engine: round {r} {name}: card and cpu differ "
                  f"({same_json(w[1], g[1])})")
    served = plane.stats["mesh_queries"] - q0
    check(served == 2 * len(bodies),
          f"sharded-engine: {served} data-plane queries for "
          f"{2 * len(bodies)} bodies")
    for key in ("mesh_builds", "last_build_docs", "mesh_fallbacks",
                "wand_blocks_total", "wand_blocks_scored"):
        check(plane.stats[key] == cpu_stats[key],
              f"sharded-engine: {key} {plane.stats[key]} on the card, "
              f"{cpu_stats[key]} on the cpu")
    lat.sort()
    log(f"sharded-engine: {len(bodies)} bodies x 2 rounds served by the "
        f"data plane, JSON equal on the card node and the cpu node, scores "
        f"bitwise; card p50 {1e3 * lat[len(lat) // 2]:.3f} ms p99 "
        f"{1e3 * pct(lat, 0.99):.3f} ms ({time.monotonic() - t0:.1f}s in "
        f"all); data plane stats {plane.stats}")
    node.cluster.stop()


def without_took(resp):
    return {k: v for k, v in resp.items() if k != "took"}


def close_hits(a_hits, b_hits, rtol: float):
    """Two hit lists: ids equal outside ties within ``rtol``, scores to
    ``rtol``; None when they agree, else where they differ."""
    if len(a_hits) != len(b_hits):
        return f"hits: {len(a_hits)} vs {len(b_hits)}"
    sa = [h["_score"] for h in a_hits]
    sb = [h["_score"] for h in b_hits]
    for x, y in zip(sa, sb):
        if abs(x - y) > rtol * abs(x) + 1e-12:
            return f"scores {x} vs {y}"
    i = 0
    while i < len(sa):
        j = i + 1
        while j < len(sa) and abs(sa[j] - sa[i]) <= 2 * rtol * abs(sa[i]):
            j += 1
        ids_a = {h["_id"] for h in a_hits[i:j]}
        ids_b = {h["_id"] for h in b_hits[i:j]}
        if j < len(sa) and ids_a != ids_b:
            return f"hits[{i}:{j}] ids {sorted(ids_a)} vs {sorted(ids_b)}"
        i = j
    return None


def sharded_node(dev, n_slots: int):
    """A card node booted with ``mesh_data_plane=True`` and
    ``mesh_slots=n_slots``: its data plane cuts an index into that many
    slots."""
    from elasticsearch_tpu_torch.testing import InProcessCluster
    cluster = InProcessCluster(n_nodes=1, seed=SEED + 1120, device=dev,
                               mesh_data_plane=True, mesh_slots=n_slots)
    cluster.start()
    n = next(iter(cluster.nodes.values()))
    check(n.mesh_plane.mesh.n_slots == n_slots,
          f"sharded-full: the node's data plane has "
          f"{n.mesh_plane.mesh.n_slots} slots, not {n_slots}")
    return cluster, RestNode(cluster)


def l2_segments(shards):
    """mesh-knn-full's SIFT1M segments again (their vectors shared, not
    copied), the field's similarity l2_norm: SIFT1M's own metric."""
    import dataclasses
    out = []
    for segs in shards:
        row = []
        for seg in segs:
            again = rewrap(seg)
            again.vectors["vec"] = dataclasses.replace(
                seg.vectors["vec"], similarity="l2_norm")
            row.append(again)
        out.append(row)
    return out


def l2_oracle(torch, np, dev, shards, bodies):
    """The float64 l2_norm top-10 of each kNN body over the SIFT1M
    segments, as hits (``_id``, ``_score`` = 1 / (1 + distance)): the
    vectors are integers, so every float64 distance is exact."""
    rows, ids = [], []
    for segs in shards:
        for seg in segs:
            rows.append(seg.vectors["vec"].matrix)
            ids.extend(seg.ids)
    x = torch.as_tensor(np.concatenate(rows), device=dev).double()
    x2 = (x * x).sum(1)
    out = []
    for body in bodies:
        q = torch.tensor(body["query"]["knn"]["query_vector"],
                         dtype=torch.float64, device=dev)
        d2 = torch.clamp_min(x2 - 2.0 * (x @ q) + (q * q).sum(), 0.0)
        best = torch.topk(d2, 10, largest=False)
        out.append({"hits": {"hits": [
            {"_id": ids[int(r)], "_score": 1.0 / (1.0 + math.sqrt(float(d)))}
            for d, r in zip(best.values.tolist(), best.indices.tolist())]}})
    del x, x2
    return out


def plain_replay(torch, node, index: str, bodies, answers) -> None:
    """Every text body again with row 42's plain version in the kernel's
    place, on the same sharded copy: the JSON must be the served one,
    byte for byte (the kernel is bitwise its plain version)."""
    from elasticsearch_tpu_torch.parallel import sharded_search as sh
    served = sh.sharded_bm25_batch
    sh.sharded_bm25_batch = sh.sharded_bm25_batch_plain
    try:
        for q, (body, got) in enumerate(zip(bodies, answers)):
            want = node.ok("POST", f"/{index}/_search", body)
            check(json.dumps(without_took(want), sort_keys=True) ==
                  json.dumps(without_took(got), sort_keys=True),
                  f"sharded-full: text request {q}: the kernel's answer "
                  f"and the plain version's differ ({same_json(want, got)})")
    finally:
        sh.sharded_bm25_batch = served


def sharded_leg(torch, node, index: str, bodies, kind: str, family: str):
    """n solo requests of one kind through the data plane: the first one
    (it builds the sharded copy) apart, every one checked mesh-served and
    to have launched its own family and none of NOT_ON_THE_DATA_PLANE.
    Returns (answers, solo seconds, first-request seconds, launches)."""
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    what = "launches" if torch.cuda.is_available() else "calls"
    watched = (family,) + NOT_ON_THE_DATA_PLANE
    count = lambda: {f: getattr(DEVICE_PROFILE.family(f), what)  # noqa
                     for f in watched}
    answers, times, first = [], [], None
    launched = 0
    for q, body in enumerate(bodies):
        before = count()
        t = time.monotonic()
        resp = node.ok("POST", f"/{index}/_search", body)
        took = time.monotonic() - t
        after = count()
        check(resp.get("_data_plane") == "mesh",
              f"sharded-full: {kind} request {q} was not served by the data "
              f"plane ({resp.get('_data_plane')})")
        check(after[family] > before[family],
              f"sharded-full: {kind} request {q} launched no {family}")
        other = {f: after[f] - before[f] for f in NOT_ON_THE_DATA_PLANE
                 if after[f] != before[f]}
        check(not other, f"sharded-full: {kind} request {q} launched {other}")
        launched += after[family] - before[family]
        answers.append(resp)
        if q == 0:
            first = took
        else:
            times.append(took)
    return answers, times, first, launched


def merged_segments(text_shards, sparse_shards):
    """[shard] -> segments holding both corpora's fields: the MS MARCO
    and the rank_features cells are the same size, so their routed _ids
    (``routed_ids``) are the same, doc for doc; one ``restore_segments``
    then serves both."""
    out = []
    for tsegs, ssegs in zip(text_shards, sparse_shards):
        segs = []
        for t, f in zip(tsegs, ssegs):
            check(t.n_docs == f.n_docs and t.ids == f.ids,
                  "sharded-full: the text and rank_features shards differ "
                  "in their _ids")
            t.features.update(f.features)
            segs.append(t)
        out.append(segs)
    return out


def phase_sharded_full(torch, np, dev, kept, n_slots: int, shared) -> None:
    """The sharded data plane at full width on one card node with
    ``mesh_data_plane=True``: mesh-full's MS MARCO segments and
    mesh-sparse-full's rank_features segments as the body and ml fields of
    one 4-shard index, and mesh-knn-full's SIFT1M segments (4 shards of 4)
    as two more, one cosine and one l2_norm, installed with
    ``restore_segments`` (no new host build); per kind its first request
    (the sharded copy's build), then the rest of its bodies solo, each
    served by the data plane with its own family and no K1-K7, K15-K17 or
    mesh_* launch. Oracles: match against mesh-full's node answering the
    first 8 bodies with ``dfs_query_then_fetch`` (global term statistics:
    ids outside near-ties, scores to rtol 1e-5, totals equal), and all 64
    against row 42's plain version on the same sharded copy (the JSON byte
    for byte); cosine knn against a float64 exact oracle (recall@10) and
    mesh-knn-full's exact answers (ids outside near-ties, scores to rtol
    1e-6); l2_norm knn against the float64 exact l2 top-10 (ids outside
    near-ties, scores to rtol 1e-4: the f32 norm * norm + q2 - 2 dot
    rounds a norm of about 1,200 to a few 1e-5 of a neighbour's
    distance); text_expansion against mesh-sparse-full's exact answers
    (ids outside near-ties, scores to rtol 1e-6). Keeps the sharded text
    index in ``shared`` for the kernels."""
    from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE
    cluster, node = sharded_node(dev, n_slots)
    svc = node.node().indices_service
    plane = node.node().mesh_plane
    DEVICE_PROFILE.timing = dev.type == "cuda"
    dev0 = device_ms(SHARDED_SERVED)
    text, sparse, knn = kept.get("text"), kept.get("sparse"), kept.get("knn")
    installs = []
    if text and sparse:
        installs.append(("msm", {"body": {"type": "text"},
                                 "ml": {"type": "rank_features"}},
                         merged_segments(text["shards"], sparse["shards"]),
                         ("text", "sparse")))
    elif text or sparse:
        kind = "text" if text else "sparse"
        field = {"text": {"body": {"type": "text"}},
                 "sparse": {"ml": {"type": "rank_features"}}}[kind]
        installs.append(("msm", field, kept[kind]["shards"], (kind,)))
    if knn:
        kept["knn_l2"] = {"shards": l2_segments(knn["shards"]),
                          "bodies": knn["bodies"],
                          "oracle": l2_oracle(torch, np, dev, knn["shards"],
                                              knn["bodies"])}
        kept["knn_l2"]["exact_ids"] = [[h["_id"] for h in o["hits"]["hits"]]
                                       for o in kept["knn_l2"]["oracle"]]
        for index, sim, kind in (("sknn", "cosine", "knn"),
                                 ("sknn_l2", "l2_norm", "knn_l2")):
            installs.append((index, {"vec": {"type": "dense_vector",
                                             "dims": SIFT_DIMS,
                                             "similarity": sim},
                                     "tag": {"type": "keyword"}},
                             kept[kind]["shards"], (kind,)))
    families = {"text": "sharded_bm25_batch", "knn": "sharded_knn",
                "knn_l2": "sharded_knn", "sparse": "sharded_sparse"}
    rtols = {"text": 1e-5, "knn": 1e-6, "knn_l2": 1e-4, "sparse": 1e-6}
    for index, mapping, shards, kinds in installs:
        blocks = {f: sum(st.block_docs.shape[0] for segs in shards
                         for seg in segs
                         for st in (getattr(seg, attr).get(f),) if st)
                  for f, attr in (("body", "postings"), ("ml", "features"))
                  if f in mapping}
        log(f"sharded-full: {index}: S={n_slots} slots; the source "
            f"segments hold {blocks} blocks (each slot's copy packs its "
            f"share of their postings, one block or more per term present, "
            f"padded to a power of two)")
        t0 = time.monotonic()
        node.ok("PUT", f"/{index}", {"settings": {
            "number_of_shards": MESH_SHARDS, "number_of_replicas": 0},
            "mappings": {"properties": mapping}})
        cluster.ensure_green(index)
        n_docs = 0
        for s, segs in enumerate(shards):
            engine = svc.shard(index, s).engine
            engine.restore_segments(list(engine.segments) + segs)
            n_docs += sum(seg.n_docs for seg in segs)
        del shards
        for kind in kinds:
            kept[kind]["shards"] = None
        t_restore = time.monotonic() - t0
        log(f"sharded-full: {index} ({'+'.join(kinds)}): {n_docs} docs "
            f"restored into {MESH_SHARDS} shards in {t_restore:.1f}s")
        for kind in kinds:
            data, family = kept[kind], families[kind]
            answers, times, first, launched = sharded_leg(
                torch, node, index, data["bodies"], kind, family)
            stats = dict(plane.stats)
            store = {"text": plane._text, "knn": plane._vec,
                     "knn_l2": plane._vec, "sparse": plane._feat}[kind]
            built = next(iter(store.values()))[1]
            host_bytes = 0
            if kind == "text" and dev.type == "cuda":
                host_bytes = built._impacts.nbytes + sum(
                    c.block_docs.nbytes + c.block_tfs.nbytes
                    for c in built._cell_indexes)
            if kind == "text":
                shared["sharded_text"] = built
            log(f"sharded-full: {kind}: S={n_slots} slots of "
                f"{built.n_per_shard}; first request {first:.2f}s (the "
                f"sharded copy's build {stats['last_build_seconds']:.2f}s); "
                f"device bytes {built.nbytes}, host bytes {host_bytes}"
                + (f", nb_max {built.nb_max}" if kind in ("text", "sparse")
                   else "")
                + f"; {len(times)} solo p50 {1e3 * pct(times, 0.5):.3f} ms "
                f"p99 {1e3 * pct(times, 0.99):.3f} ms; {family} launches "
                f"{launched} for {len(answers)} requests")
            if kind == "text":
                t_replay = time.monotonic()
                plain_replay(torch, node, index, data["bodies"], answers)
                log(f"sharded-full: text: {len(answers)} of {len(answers)} "
                    f"answers equal row 42's plain version's on the same "
                    f"sharded copy, byte for byte "
                    f"({time.monotonic() - t_replay:.1f}s)")
            hits = 0
            for q, (got, want) in enumerate(zip(answers, data["oracle"])):
                why = close_hits(want["hits"]["hits"], got["hits"]["hits"],
                                 rtols[kind])
                check(why is None, f"sharded-full: {kind} request {q}: {why}")
                if kind == "text":
                    check(got["hits"]["total"] == want["hits"]["total"],
                          f"sharded-full: text request {q}: total "
                          f"{got['hits']['total']} vs dfs "
                          f"{want['hits']['total']}")
                if kind in ("knn", "knn_l2"):
                    hits += len({h["_id"] for h in got["hits"]["hits"]} &
                                set(data["exact_ids"][q]))
            if kind in ("knn", "knn_l2"):
                recall = hits / (10 * len(answers))
                check(recall >= 0.95,
                      f"sharded-full: {kind} recall@10 {recall}")
                log(f"sharded-full: {kind} recall@10 against the float64 "
                    f"oracle {recall:.4f}")
            n_cmp = min(len(answers), len(data["oracle"]))
            log(f"sharded-full: {kind}: {n_cmp} of {len(answers)} answers "
                f"equal the oracle (" + {
                    "text": "dfs_query_then_fetch on mesh-full's node",
                    "knn": "mesh-knn-full's exact answers",
                    "knn_l2": "the float64 exact l2 top-10",
                    "sparse": "mesh-sparse-full's exact answers"}[kind] + ")")
        node.ok("DELETE", f"/{index}")
        plane._text.clear(), plane._vec.clear(), plane._feat.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    DEVICE_PROFILE.timing = False
    kern = {f: round(v - dev0[f], 3)
            for f, v in device_ms(SHARDED_SERVED).items()}
    log(f"sharded-full: kernel device ms over the legs {kern}; data plane "
        f"stats {plane.stats}")
    cluster.stop()

def sharded_group(family: str, args):
    """One largest call per kNN similarity (the cosine and the l2_norm
    SIFT1M legs), one per family otherwise."""
    if family == "sharded_knn" and len(args) > 7:
        return args[7]
    return None


def sharded_size(family: str, args) -> int:
    """The work of a sharded call: query x slot rows scored (kNN), list
    entries gathered (BM25, sparse)."""
    if family == "sharded_knn":
        return args[3].shape[0] * args[0].shape[0] * args[0].shape[1]
    return args[2 if family == "sharded_sparse" else 4].numel()


def gathered_postings(torch, block_docs, block_idx, weights) -> int:
    """Postings the listed blocks hold (entries of weight 0 are padding)."""
    n = 0
    for s in range(block_docs.shape[0]):
        docs = block_docs[s][block_idx[s].long()]
        n += int(((docs >= 0) & (weights[s] != 0)[..., None]).sum())
    return n


def sharded_bound(torch, family: str, args, kwargs):
    """(bound_ms, bound_by, bytes): each input read once, each output
    written once -- the real slot rows of the vector plane, the postings
    the listed blocks hold (8 bytes, BM25 a doc length more), the lists,
    the answers -- over the memory rate, or the arithmetic over the peak
    rate of its type (bf16 dots for cosine and dot_product, f32 for l2 and
    the scatters), whichever is larger."""
    nbytes, ops, peak = 0, 0, F32_FLOPS

    def knn_part(matrix, valid, queries, k, sim):
        n_real = int(valid.sum())
        dims = matrix.shape[2]
        b = queries.shape[0]
        return (n_real * (dims * 4 + 5) + b * (dims * 4 + 8) + b * k * 8,
                2 * b * n_real * dims,
                F32_FLOPS if sim == "l2_norm" else BF16_FLOPS)
    if family == "sharded_knn":
        sim = args[7] if len(args) > 7 else kwargs.get("similarity",
                                                       "cosine")
        nbytes, ops, peak = knn_part(args[0], args[2], args[3], args[6], sim)
    elif family in ("sharded_bm25", "sharded_bm25_batch", "sharded_hybrid"):
        bd, idx, w, k = args[0], args[4], args[5], args[6]
        if family == "sharded_hybrid":
            k = args[12]
        p = gathered_postings(torch, bd, idx, w)
        rows = idx.numel() // idx.shape[-1] // bd.shape[0]
        nbytes = p * 12 + idx.numel() * 8 + rows * (k * 8 + 4)
        ops = p * 8
        if family == "sharded_hybrid":
            sim = kwargs.get("similarity", "cosine")
            kb, ko, peak = knn_part(args[6], args[8], args[9][None], k, sim)
            nbytes, ops = nbytes + kb, ops + ko
    else:
        bd, idx, w, k = args[0], args[2], args[3], args[5]
        p = gathered_postings(torch, bd, idx, w)
        nbytes = p * 8 + idx.numel() * 8 + k * 8
        ops = p * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def sharded_library_ms(torch, family: str, args, kwargs):
    """One PyTorch call's worth of the same function, bracketed (partial):
    rows 40 and 44 ``torch.matmul`` of the queries with the whole vector
    plane and ``torch.topk``; rows 41-43 ``index_add_`` of the gathered
    contributions (prepared outside the timing) and ``torch.topk``."""
    if family in ("sharded_knn", "sharded_hybrid"):
        if family == "sharded_knn":
            matrix, queries, k = args[0], args[3], args[6]
        else:
            matrix, queries, k = args[6], args[9][None], args[12]
        flat = matrix.reshape(-1, matrix.shape[2])
        return time_call(torch, lambda: torch.topk(
            torch.matmul(queries, flat.t()), k, dim=1), 10)
    bd, vals = args[0], args[1]
    if family == "sharded_sparse":
        idx, w, n, k = args[2], args[3], args[4], args[5]
        idx, w = idx[:, None], w[:, None]
    else:
        idx, w, n, k = args[4], args[5], args[2].shape[1], args[6]
        if idx.dim() == 2:
            idx, w = idx[:, None], w[:, None]
    s_n, n_q = idx.shape[0], idx.shape[1]
    tgt, con = [], []
    for s in range(s_n):
        docs = bd[s][idx[s].long()]                       # [Q, QB, 128]
        ok = (docs >= 0) & (w[s] != 0)[..., None]
        q = torch.arange(n_q, device=bd.device)[:, None, None].expand_as(
            docs)
        tgt.append(((s * n_q + q) * n + docs.long())[ok])
        con.append((vals[s][idx[s].long()] * w[s][..., None])[ok])
    tgt, con = torch.cat(tgt), torch.cat(con)
    acc = torch.zeros(s_n * n_q * n, device=bd.device)

    def run():
        acc.zero_()
        acc.index_add_(0, tgt, con)
        return torch.topk(acc.view(s_n, n_q, n).permute(1, 0, 2).reshape(
            n_q, -1), k, dim=1)
    return time_call(torch, run, 10)


def hybrid_operands(torch, dev, n_slots: int, n_per_shard: int, dims: int):
    """Seeded row-44 operands at BEIR NQ's width (D 768): a block store of
    4,096 blocks a slot (sorted docs, -1 padding, tfs 1..6), doc lengths
    16..96, one query's 64 blocks a slot, and a Gaussian vector plane."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1130)
    nb = 4096
    docs = torch.sort(torch.randint(0, n_per_shard, (n_slots, nb, 128),
                                    generator=g, device=dev,
                                    dtype=torch.int32), dim=2).values
    cut = torch.randint(96, 129, (n_slots, nb, 1), generator=g, device=dev)
    docs = torch.where(torch.arange(128, device=dev) < cut, docs,
                       torch.full_like(docs, -1))
    tfs = torch.where(docs >= 0, torch.randint(
        1, 7, docs.shape, generator=g, device=dev).float(),
        torch.zeros((), device=dev)).contiguous()
    dl = torch.randint(16, 97, (n_slots, n_per_shard), generator=g,
                       device=dev).float()
    idx = torch.randint(0, nb, (n_slots, 64), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand(n_slots, 64, generator=g, device=dev) * 8.0 + 0.5
    matrix = torch.randn(n_slots, n_per_shard, dims, generator=g,
                         device=dev)
    norms = torch.linalg.vector_norm(matrix, dim=2)
    valid = torch.ones(n_slots, n_per_shard, dtype=torch.bool, device=dev)
    return (docs.contiguous(), tfs, dl, 50.0, idx, w.contiguous(), matrix,
            norms, valid)


def phase_sharded_kernels(torch, np, rec, launches, shared, dev) -> list:
    """Rows 40-44 on the kernels line: the served three (40, 42, 43)
    bitwise against their plain versions on the first 3 calls recorded
    (sharded-engine's) and the main path's largest, which is also the one
    timed, so ``max_abs_err`` covers the full-width call; row 41 on one MS MARCO query of the
    sharded text index sharded-full built, row 44 on seeded operands at
    BEIR NQ's width (D 768, S 4, 262,144 docs a slot) -- neither has a
    served caller (0 launches on the main path)."""
    from elasticsearch_tpu_torch.ops.knn import query_norms
    from elasticsearch_tpu_torch.parallel import sharded_search as sh
    calls = {f: rec.calls[f] for f in SHARDED_SERVED}
    text = shared.pop("sharded_text", None)
    check(text is not None, "kernels: no sharded text index kept")
    idx, w = text.prep_query([f"t{t}" for t in (0, 17, 230, 4051)])
    calls["sharded_bm25"] = [((text.block_docs, text.block_tfs,
                               text.doc_lens, text.avgdl,
                               torch.as_tensor(idx, device=dev),
                               torch.as_tensor(w, device=dev), 10), {})]
    hyb = hybrid_operands(torch, dev, 4, 262_144, 768)
    qvec = hyb[6][1, 77].contiguous()
    qn, q2 = (torch.as_tensor(x, device=dev)
              for x in query_norms(qvec[None].cpu().numpy()))
    calls["sharded_hybrid"] = [(hyb + (qvec, qn, q2, 10), {})]
    rows = []
    for fam in SHARDED_FAMILIES:
        check(bool(calls[fam]), f"kernels: no {fam} call recorded")
        kernel, plain = getattr(sh, fam), getattr(sh, fam + "_plain")
        torch.cuda.empty_cache()
        err = 0.0
        for args, kwargs in calls[fam]:
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            err = max(err, compare(torch, fam, got, want))
            del got, want
        args, kwargs = max(calls[fam], key=lambda c: sharded_size(fam, c[0]))
        ms = time_call(torch, lambda: kernel(*args, **kwargs), 20)
        plain_ms = time_call(torch, lambda: plain(*args, **kwargs), 5)
        lib = sharded_library_ms(torch, fam, args, kwargs)
        bound_ms, bound_by, nbytes = sharded_bound(torch, fam, args, kwargs)
        if fam in ("sharded_knn", "sharded_hybrid"):
            m = args[0] if fam == "sharded_knn" else args[6]
            shape = (f"S={m.shape[0]} N={m.shape[1]} D={m.shape[2]} "
                     f"B={args[3].shape[0] if fam == 'sharded_knn' else 1}")
        else:
            shape = (f"S={args[0].shape[0]} NB={args[0].shape[1]} "
                     f"lists={tuple(args[4 if fam != 'sharded_sparse' else 2].shape)}")
        log(f"kernel {fam}: {ms:.4f} ms (median of 20), plain "
            f"{plain_ms:.4f} ms (median of 5), bound {bound_ms:.4f} ms "
            f"({nbytes} bytes at 3.35 TB/s, {bound_by}), library "
            f"(bracketed) {lib:.4f} ms, max_abs_err {err}, timed at {shape}")
        rows.append({
            "name": fam, "route": "cuda", "source": SHARDED_SOURCES[fam],
            "replaces": REPLACES[fam], "launches": launches.get(fam, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "library_is_partial": True, "shape": shape})
        torch.cuda.empty_cache()
    del text, hyb
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="card,small,knn-small,dense-small,"
                    "ivf-small,sparse-small,wide-small,aggs-small,engine,"
                    "full,kernels,knn-engine,knn-full,dense-engine,"
                    "dense-full,wide,ivf-engine,ivf-full,sparse-engine,"
                    "sparse-full,aggs-engine,aggs-full,node-engine,"
                    "hybrid-full,mesh-small,mesh-engine,mesh-full,"
                    "mesh-knn-small,mesh-knn-engine,mesh-knn-full,"
                    "mesh-sparse-small,mesh-sparse-full,sharded-small,"
                    "sharded-engine,sharded-full")
    ap.add_argument("--full-docs", type=int, default=MS_MARCO_DOCS)
    ap.add_argument("--engine-docs", type=int, default=10_000)
    ap.add_argument("--knn-docs", type=int, default=SIFT_DOCS)
    ap.add_argument("--knn-engine-docs", type=int, default=20_000)
    ap.add_argument("--ivf-engine-docs", type=int, default=6_000)
    ap.add_argument("--gist-docs", type=int, default=GIST_DOCS)
    ap.add_argument("--gist-queries", type=int, default=128)
    ap.add_argument("--sparse-docs", type=int, default=MS_MARCO_DOCS)
    ap.add_argument("--sparse-engine-docs", type=int, default=3_000)
    # the geonames and BEIR NQ cells run at a quarter of their corpora by
    # default, so that every path fits the script's time limit
    ap.add_argument("--geo-docs", type=int, default=GEONAMES_DOCS // 4)
    ap.add_argument("--geo-engine-docs", type=int, default=3_000)
    ap.add_argument("--node-docs", type=int, default=3_000)
    ap.add_argument("--nq-docs", type=int, default=NQ_DOCS // 4)
    ap.add_argument("--mesh-docs", type=int, default=MS_MARCO_DOCS)
    ap.add_argument("--mesh-engine-docs", type=int, default=6_000)
    ap.add_argument("--mesh-knn-docs", type=int, default=SIFT_DOCS)
    ap.add_argument("--mesh-knn-engine-docs", type=int, default=3_000)
    ap.add_argument("--sharded-engine-docs", type=int, default=2_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at a small size; never prints ok")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    phases = set(args.phases.split(","))
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        import elasticsearch_tpu_torch  # noqa: F401
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS, GB
        from elasticsearch_tpu_torch.search.device_profile import (
            DEVICE_PROFILE,
        )
    except ImportError as e:
        print(f"chip_smoke: the package is missing: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if args.rehearse else "cuda")
    on_card = not args.rehearse
    # the breakers' defaults budget a 16 GB device; this card has 80 GB
    BREAKERS.configure(device=48 * GB, request=24 * GB, total=72 * GB)
    builds = {}
    if args.workers > 1 and "full" in phases:
        builds["full"] = (segment_tokens, full_jobs(args.full_docs))
    if args.workers > 1 and "hybrid-full" in phases:
        builds["nq"] = (nq_segment_tokens, nq_jobs(args.nq_docs))
    prebuilt = Prebuilt(args.workers, builds) if builds else None

    def t():
        return f"[{time.monotonic() - t_start:.1f}s]"

    try:
        if args.rehearse:
            log("rehearsal on the CPU: plain versions only")
        if "card" in phases and on_card:
            phase_card(torch)
        if "small" in phases and on_card:
            phase_small(torch, np, dev)
            log(t(), "small done")
        if "knn-small" in phases and on_card:
            phase_knn_small(torch, np, dev)
            log(t(), "knn-small done")
        if "dense-small" in phases and on_card:
            phase_dense_small(torch, np, dev)
            log(t(), "dense-small done")
        if "ivf-small" in phases and on_card:
            phase_ivf_small(torch, np, dev)
            log(t(), "ivf-small done")
        if "sparse-small" in phases and on_card:
            phase_sparse_small(torch, np, dev)
            log(t(), "sparse-small done")
        if "wide-small" in phases and on_card:
            phase_wide_small(torch, np, dev)
            log(t(), "wide-small done")
        if "aggs-small" in phases and on_card:
            phase_aggs_small(torch, np, dev)
            log(t(), "aggs-small done")
        if "mesh-small" in phases and on_card:
            phase_mesh_small(torch, np, dev)
            log(t(), "mesh-small done")
        if "mesh-knn-small" in phases and on_card:
            phase_mesh_knn_small(torch, np, dev)
            log(t(), "mesh-knn-small done")
        if "mesh-sparse-small" in phases and on_card:
            phase_mesh_sparse_small(torch, np, dev)
            log(t(), "mesh-sparse-small done")
        if "sharded-small" in phases and on_card:
            phase_sharded_small(torch, np, dev)
            log(t(), "sharded-small done")
        from elasticsearch_tpu_torch.ops import bm25 as bm
        from elasticsearch_tpu_torch.ops import ivf, knn, topk
        rows = []
        shared = {}
        engines = {}
        # the full cells' segments (and oracles) that sharded-full serves
        # again through the data plane
        kept = {} if "sharded-full" in phases else None
        if phases & {"engine", "dense-engine"}:
            engines["text"] = build_text_engine(np, args.engine_docs)
        if phases & {"knn-engine", "dense-engine", "ivf-engine"}:
            engines["vector"] = build_vector_engine(np, args.knn_engine_docs)
        # the BM25 main path: launch counts from zero, read right after
        DEVICE_PROFILE.reset_launches()
        if "engine" in phases:
            phase_engine(torch, np, dev, engines["text"])
            log(t(), "engine done")
        with Recorder({f: (bm, f) for f in FAMILIES}, bm25_size,
                      keep=24) as rec:
            if "full" in phases:
                phase_full(torch, np, dev, args.full_docs, args.workers,
                           args.queries, shared, prebuilt)
                log(t(), "full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the BM25 main path: " + json.dumps(
            {f: launches.get(f, 0) for f in FAMILIES}))
        if on_card and "full" in phases:
            for fam in FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_kernels(torch, rec, launches)
                log(t(), "kernels done")
        del rec
        from elasticsearch_tpu_torch.ops.device_segment import PLANES
        PLANES.clear()
        # the kNN main path: launch counts from zero, read right after
        DEVICE_PROFILE.reset_launches()
        if "knn-engine" in phases:
            phase_knn_engine(torch, np, dev, engines["vector"])
            log(t(), "knn-engine done")
        with Recorder({f: (knn, f) for f in KNN_FAMILIES}, knn_size,
                      keep=8) as krec:
            if "knn-full" in phases:
                phase_knn_full(torch, np, dev, args.knn_docs, args.queries,
                               shared)
                log(t(), "knn-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the kNN main path: " + json.dumps(
            {f: launches.get(f, 0) for f in KNN_FAMILIES}))
        if on_card and "knn-full" in phases:
            for fam in KNN_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_knn_kernels(torch, krec, launches)
                log(t(), "knn kernels done")
        del krec
        PLANES.clear()
        # the dense main path: launch counts from zero, read right after
        DEVICE_PROFILE.reset_launches()
        dense = {"bm25_scores": (bm, "bm25_block_scores"),
                 "knn_scores": (knn, "vector_scores"),
                 "dense_topk": (topk, "dense_topk")}
        with Recorder(dense, dense_size, keep=8, group=dense_n) as drec:
            if "dense-engine" in phases:
                phase_dense_engine(torch, np, dev, engines["text"],
                                   engines["vector"])
                log(t(), "dense-engine done")
            if "dense-full" in phases:
                phase_dense_full(torch, np, dev, shared, args.queries)
                log(t(), "dense-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the dense main path: " + json.dumps(
            {f: launches.get(f, 0) for f in DENSE_FAMILIES}))
        if on_card and "dense-full" in phases:
            for fam in DENSE_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_dense_kernels(torch, drec, launches)
                log(t(), "dense kernels done")
        del drec
        PLANES.clear()
        # the wide selection's path (windows of 10,000 on the MS MARCO and
        # SIFT shards): launch counts from zero, read right after
        DEVICE_PROFILE.reset_launches()
        with Recorder({"bm25_flat": (bm, "bm25_flat"),
                       "knn_flat": (knn, "knn_flat"),
                       "dense_topk": (topk, "dense_topk")}, wide_size,
                      keep=8) as wrec:
            if "wide" in phases:
                phase_wide(torch, np, dev, shared)
                log(t(), "wide done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the wide-selection path: " + json.dumps(
            {f: launches.get(f, 0) for f in WIDE_FAMILIES}))
        if on_card and "wide" in phases:
            for fam in WIDE_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the wide path")
            if "kernels" in phases:
                rows += phase_wide_kernels(torch, wrec, launches)
                log(t(), "wide kernels done")
        del wrec
        PLANES.clear()
        # the IVF path (filtered kNN and the IVF route): launch counts from
        # zero, read right after
        DEVICE_PROFILE.reset_launches()
        targets = {f: (ivf, f) for f in IVF_FAMILIES}
        targets.update({f: (knn, f[: -len("_masked")]) for f in MASKED})
        with Recorder(targets, ivf_size, keep=4, group=ivf_group,
                      accept=lambda f, a, kw: (
                          f not in MASKED or masks_of(f, a, kw) is not None)
                      ) as irec:
            if "ivf-engine" in phases:
                phase_ivf_engine(torch, np, dev, engines["vector"],
                                 args.ivf_engine_docs)
                log(t(), "ivf-engine done")
            if "ivf-full" in phases:
                phase_ivf_full(torch, np, dev, shared, args.gist_docs,
                               args.gist_queries)
                log(t(), "ivf-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the IVF main path: " + json.dumps(
            {f: launches.get(f, 0) for f in IVF_PATH_FAMILIES}))
        if on_card and "ivf-full" in phases:
            for fam in IVF_PATH_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_ivf_kernels(torch, irec, launches)
                log(t(), "ivf kernels done")
        del irec
        PLANES.clear()
        # the earlier phases' shards (host arrays) are not needed past
        # here, but for the MS MARCO segments mesh-full serves again
        msmarco = shared.get("msmarco", (None,))[0]
        shared.clear()
        if on_card:
            torch.cuda.empty_cache()
        # the sparse main path: launch counts from zero, read right after
        from elasticsearch_tpu_torch.ml import text_expansion as te
        from elasticsearch_tpu_torch.ops import sparse
        sparse_segs = None
        if "sparse-engine" in phases:
            engines["sparse"] = build_sparse_engine(np, dev,
                                                    args.sparse_engine_docs)
        DEVICE_PROFILE.reset_launches()
        targets = {"sparse_flat": (sparse, "sparse_topk_batch"),
                   "sparse_scores": (sparse, "sparse_scores"),
                   "sparse_coarse": (sparse, "sparse_coarse_kernel"),
                   "sparse_rerank": (sparse, "sparse_rerank_kernel"),
                   "text_expansion_forward": (te, "text_expansion_forward")}
        # one largest call per plane length (the plane, a segment)
        with Recorder(targets, sparse_size, keep=8,
                      group=sparse_n_docs_pad) as srec:
            if "sparse-engine" in phases:
                phase_sparse_engine(torch, np, dev, engines["sparse"])
                log(t(), "sparse-engine done")
            if "sparse-full" in phases:
                sparse_segs = phase_sparse_full(torch, np, dev,
                                                args.sparse_docs,
                                                args.workers, args.queries)
                log(t(), "sparse-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the sparse main path: " + json.dumps(
            {f: launches.get(f, 0) for f in SPARSE_FAMILIES}))
        if on_card and "sparse-full" in phases:
            for fam in SPARSE_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_sparse_kernels(torch, np, srec, launches, dev)
                log(t(), "sparse kernels done")
        del srec
        PLANES.clear()
        if on_card:
            torch.cuda.empty_cache()
        # the aggregation path (the engine, then the geonames-shaped shard
        # per segment and on the columns plane): launch counts from zero,
        # read right after
        from elasticsearch_tpu_torch.ops import aggs as aggs_ops
        DEVICE_PROFILE.reset_launches()
        with Recorder({f: (aggs_ops, AGGS_FNS[f]) for f in AGGS_FAMILIES},
                      aggs_size, keep=4) as arec:
            if "aggs-engine" in phases:
                phase_aggs_engine(torch, np, dev, args.geo_engine_docs)
                log(t(), "aggs-engine done")
            if "aggs-full" in phases:
                phase_aggs_full(torch, np, dev, args.geo_docs, args.workers,
                                args.queries)
                log(t(), "aggs-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the aggregation main path: " + json.dumps(
            {f: launches.get(f, 0) for f in AGGS_FAMILIES}))
        if on_card and "aggs-full" in phases:
            for fam in AGGS_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_aggs_kernels(torch, arec, launches)
                log(t(), "aggs kernels done")
        del arec
        PLANES.clear()
        if on_card:
            torch.cuda.empty_cache()
        # the hybrid path (port nodes serving _bulk / _search through the
        # coordinator, RRF fused by K24): launch counts from zero, read
        # right after
        from elasticsearch_tpu_torch.ops import fusion as fusion_ops
        DEVICE_PROFILE.reset_launches()
        with Recorder({"rrf_fuse_batch": (fusion_ops, "rrf_fuse_batch")},
                      rrf_size, keep=4) as hrec:
            if "node-engine" in phases:
                phase_node_engine(torch, np, dev, args.node_docs)
                log(t(), "node-engine done")
            if "hybrid-full" in phases:
                phase_hybrid_full(torch, np, dev, args.nq_docs, args.workers,
                                  args.queries, prebuilt)
                log(t(), "hybrid-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the hybrid main path: " + json.dumps(
            {f: n for f, n in launches.items() if n}))
        if on_card and "hybrid-full" in phases:
            check(launches.get("rrf_fuse_batch", 0) > 0,
                  "rrf_fuse_batch was never launched on the main path")
            if "kernels" in phases:
                rows += phase_fusion_kernels(torch, np, hrec, launches)
                log(t(), "fusion kernels done")
        del hrec
        PLANES.clear()
        if on_card:
            torch.cuda.empty_cache()
        # the mesh's text path (a card node serving match on 4 shards, one
        # mesh_bm25_* launch per phase for all of them): launch counts
        # from zero, read right after
        from elasticsearch_tpu_torch.ops.device_segment import MESH_PLANES
        from elasticsearch_tpu_torch.parallel import mesh as mesh_ops
        DEVICE_PROFILE.reset_launches()
        with Recorder({f: (mesh_ops, f) for f in MESH_FAMILIES}, mesh_size,
                      keep=4) as mrec:
            if "mesh-engine" in phases:
                phase_mesh_engine(torch, np, dev, args.mesh_engine_docs)
                log(t(), "mesh-engine done")
            if "mesh-full" in phases:
                phase_mesh_full(
                    torch, np, dev, args.mesh_docs, args.workers,
                    args.queries,
                    msmarco if args.mesh_docs == args.full_docs else None,
                    kept)
                msmarco = None
                log(t(), "mesh-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the mesh main path: " + json.dumps(
            {f: launches.get(f, 0) for f in MESH_FAMILIES}))
        if on_card and "mesh-full" in phases:
            for fam in MESH_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_mesh_kernels(torch, mrec, launches)
                log(t(), "mesh kernels done")
        del mrec
        MESH_PLANES.clear()
        PLANES.clear()
        if on_card:
            torch.cuda.empty_cache()
        # the mesh's kNN path (a card node serving knn on 4 shards, one
        # mesh_knn_* launch per phase for all of them): launch counts from
        # zero, read right after
        DEVICE_PROFILE.reset_launches()
        per_launch = {}
        with Recorder({f: (mesh_ops, f) for f in MESH_KNN_FAMILIES},
                      mesh_knn_size, keep=4) as krec:
            if "mesh-knn-engine" in phases:
                phase_mesh_knn_engine(torch, np, dev,
                                      args.mesh_knn_engine_docs)
                log(t(), "mesh-knn-engine done")
            if "mesh-knn-full" in phases:
                per_launch = phase_mesh_knn_full(torch, np, dev,
                                                 args.mesh_knn_docs,
                                                 args.queries, kept)
                log(t(), "mesh-knn-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the mesh kNN main path: " + json.dumps(
            {f: launches.get(f, 0) for f in MESH_KNN_FAMILIES +
             ONE_SHARD_KNN}))
        if on_card and "mesh-knn-full" in phases:
            for fam in MESH_KNN_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_mesh_knn_kernels(torch, krec, launches,
                                               per_launch)
                log(t(), "mesh knn kernels done")
        del krec
        MESH_PLANES.clear()
        PLANES.clear()
        if on_card:
            torch.cuda.empty_cache()
        # the mesh's sparse path (a card node serving text_expansion on 4
        # shards, one mesh_sparse_* launch per phase for all of them):
        # launch counts from zero, read right after
        DEVICE_PROFILE.reset_launches()
        per_launch = {}
        with Recorder({f: (mesh_ops, f) for f in MESH_SPARSE_FAMILIES},
                      mesh_sparse_size, keep=4) as sprec:
            if "mesh-sparse-full" in phases:
                per_launch = phase_mesh_sparse_full(
                    torch, np, dev, args.sparse_docs, args.workers,
                    args.queries, sparse_segs, kept)
                sparse_segs = None
                log(t(), "mesh-sparse-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the mesh sparse main path: " + json.dumps(
            {f: launches.get(f, 0) for f in MESH_SPARSE_FAMILIES +
             ONE_SHARD_SPARSE}))
        if on_card and "mesh-sparse-full" in phases:
            for fam in MESH_SPARSE_FAMILIES:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_mesh_sparse_kernels(torch, sprec, launches,
                                                  per_launch)
                log(t(), "mesh sparse kernels done")
        del sprec
        MESH_PLANES.clear()
        PLANES.clear()
        if on_card:
            torch.cuda.empty_cache()
        # the sharded data plane (mesh_data_plane=True nodes, one sharded
        # launch a request): launch counts from zero, read right after
        from elasticsearch_tpu_torch.parallel import sharded_search as sh_ops
        DEVICE_PROFILE.reset_launches()
        with Recorder({f: (sh_ops, f) for f in SHARDED_SERVED},
                      sharded_size, keep=3, group=sharded_group) as shrec:
            if "sharded-engine" in phases:
                phase_sharded_engine(torch, np, dev,
                                     args.sharded_engine_docs)
                log(t(), "sharded-engine done")
            # the main path's counts are sharded-full's alone; the
            # Recorder keeps sharded-engine's first calls to compare
            DEVICE_PROFILE.reset_launches()
            if "sharded-full" in phases:
                phase_sharded_full(torch, np, dev, kept, SHARDED_SLOTS,
                                   shared)
                kept = None
                log(t(), "sharded-full done")
        launches = DEVICE_PROFILE.launches()
        log("launches on the sharded data plane's path: " + json.dumps(
            {f: launches.get(f, 0) for f in SHARDED_FAMILIES}))
        if on_card and "sharded-full" in phases:
            for fam in SHARDED_SERVED:
                check(launches.get(fam, 0) > 0,
                      f"{fam} was never launched on the main path")
            if "kernels" in phases:
                rows += phase_sharded_kernels(torch, np, shrec, launches,
                                              shared, dev)
                log(t(), "sharded kernels done")
        del shrec
        shared.clear()
        if on_card and {"full", "knn-full", "dense-full", "ivf-full",
                        "sparse-full", "wide", "aggs-full", "hybrid-full",
                        "mesh-full", "mesh-knn-full", "mesh-sparse-full",
                        "sharded-full", "kernels"} <= phases:
            from elasticsearch_tpu_torch.search.device_profile import (
                KERNEL_FAMILIES, MASKED_VARIANTS,
            )
            check({r["name"] for r in rows} ==
                  set(KERNEL_FAMILIES) | set(MASKED_VARIANTS),
                  "kernels: the line does not list every kernel family")
        log(json.dumps({"kernels": rows}))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if prebuilt is not None:
            prebuilt.close()
    log(f"elapsed: {time.monotonic() - t_start:.1f}s")
    if args.rehearse:
        log("rehearsal passed (not a chip result)")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
