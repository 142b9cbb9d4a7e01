"""Device mirrors of segment postings, vectors and rank_features, and the
packed multi-segment plane.

The postings, vectors and features parts of the JAX package's
``ops/device_segment.py``, with the same layout and the same residency
rules; only the upload differs: arrays go to the card as ``torch`` tensors
on an explicit device. ``gather_query_blocks`` (the host block list of one
query) is copied as it is.

Each searchable segment gets lazily-built, cached device arrays with
power-of-two padded shapes. The host Segment stays the source of truth;
device mirrors are pure caches, keyed by device.

The second half is the **shard plane**: a shard's live segments
concatenated along the docs axis into ONE device-resident padded plane
per (kind, field) -- postings blocks, dense-vector rows and rank_features
blocks -- with per-segment base offsets, so a whole shard's BM25, kNN or
sparse phase is one kernel launch regardless of segment count. The per-segment
boundary survives only as a host-side offset translation
(``PlanePart.demux``). Planes rebuild incrementally on refresh (per-segment
rebased arrays are cached by segment uid) and charge the ``device``
breaker before upload; the registry LRU-evicts cold planes, so a shard
whose plane cannot fit degrades to the per-segment path.

The vector plane also carries the shard-level IVF index (``ops/ivf.py``),
built on first use per plane generation and warm-started from the previous
generation's centroids. The columns plane (``PlaneColumns``) packs a
field's aggregation columns (the numeric doc values and the keyword
ordinal table, remapped to global ordinals) for ``search/plane_aggs.py``.
The mesh-sharded plane (``MeshPlanePart``, ``MESH_PLANES``) stacks the
postings, vector or rank_features planes of a fan-out's co-located shards
as ``[S, ...]`` slots for the mesh text, kNN and sparse kernels
(``parallel/mesh.py``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.segment import (
    BLOCK, FeaturesField, PostingsField, Segment, VectorField, next_pow2,
)
from elasticsearch_tpu_torch.utils.errors import (
    CircuitBreakingError, NotPortedError,
)


class DevicePostings:
    """Device-resident postings for one text field of one segment."""

    def __init__(self, pf: PostingsField, n_docs: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.n_docs_pad = next_pow2(max(n_docs, 1), minimum=BLOCK)
        n_blocks = pf.block_docs.shape[0]
        self.n_blocks_pad = next_pow2(n_blocks)
        # pad blocks with an empty sentinel block (all -1 docs)
        pad = self.n_blocks_pad - n_blocks
        block_docs = np.pad(pf.block_docs, ((0, pad), (0, 0)), constant_values=-1)
        block_tfs = np.pad(pf.block_tfs, ((0, pad), (0, 0)))
        doc_lens = np.zeros(self.n_docs_pad, np.float32)
        doc_lens[: len(pf.doc_lens)] = pf.doc_lens
        block_max_tf = np.pad(pf.block_max_tf, (0, pad))
        # budget check BEFORE the upload (breaker must gate, not observe)
        from elasticsearch_tpu_torch.indices.breaker import account_device_arrays
        account_device_arrays(
            self, (block_docs, block_tfs, doc_lens, block_max_tf),
            "postings")
        dev = self.device
        self.block_docs = torch.as_tensor(block_docs, device=dev)
        self.block_tfs = torch.as_tensor(block_tfs, device=dev)
        self.doc_lens = torch.as_tensor(doc_lens, device=dev)
        self.avgdl = float(pf.sum_doc_len / max(1, (pf.doc_lens > 0).sum()))
        self.block_max_tf = torch.as_tensor(block_max_tf, device=dev)

    @staticmethod
    def for_segment(seg: Segment, field_name: str,
                    device: DeviceLike = None) -> Optional["DevicePostings"]:
        pf = seg.postings.get(field_name)
        if pf is None:
            return None
        dev = resolve_device(device)
        return seg.device(("postings", field_name, str(dev)),
                          lambda: DevicePostings(pf, seg.n_docs, dev))


class DeviceVectors:
    """Device-resident dense-vector matrix for one field of one segment."""

    def __init__(self, vf: VectorField, n_docs: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.n_docs_pad = next_pow2(max(n_docs, 1), minimum=BLOCK)
        self.dims = vf.dims
        pad = self.n_docs_pad - vf.matrix.shape[0]
        matrix = np.pad(vf.matrix, ((0, pad), (0, 0)))
        norms = np.pad(vf.norms, (0, pad))
        exists = np.zeros(self.n_docs_pad, bool)
        exists[: len(vf.exists)] = vf.exists
        from elasticsearch_tpu_torch.indices.breaker import account_device_arrays
        account_device_arrays(self, (matrix, norms, exists), "vectors")
        dev = self.device
        self.matrix = torch.as_tensor(matrix, device=dev)
        self.norms = torch.as_tensor(norms, device=dev)
        self.exists = torch.as_tensor(exists, device=dev)
        self.similarity = vf.similarity

    @staticmethod
    def for_segment(seg: Segment, field_name: str,
                    device: DeviceLike = None) -> Optional["DeviceVectors"]:
        vf = seg.vectors.get(field_name)
        if vf is None:
            return None
        dev = resolve_device(device)
        return seg.device(("vectors", field_name, str(dev)),
                          lambda: DeviceVectors(vf, seg.n_docs, dev))


class DeviceFeatures:
    """Device-resident rank_features blocks for one field of one segment."""

    def __init__(self, ff: FeaturesField, n_docs: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.n_docs_pad = next_pow2(max(n_docs, 1), minimum=BLOCK)
        n_blocks = ff.block_docs.shape[0]
        self.n_blocks_pad = next_pow2(n_blocks)
        pad = self.n_blocks_pad - n_blocks
        block_docs = np.pad(ff.block_docs, ((0, pad), (0, 0)),
                            constant_values=-1)
        block_weights = np.pad(ff.block_weights, ((0, pad), (0, 0)))
        from elasticsearch_tpu_torch.indices.breaker import account_device_arrays
        account_device_arrays(self, (block_docs, block_weights), "features")
        self.block_docs = torch.as_tensor(block_docs, device=self.device)
        self.block_weights = torch.as_tensor(block_weights,
                                             device=self.device)

    @staticmethod
    def for_segment(seg: Segment, field_name: str,
                    device: DeviceLike = None) -> Optional["DeviceFeatures"]:
        ff = seg.features.get(field_name)
        if ff is None:
            return None
        dev = resolve_device(device)
        return seg.device(("features", field_name, str(dev)),
                          lambda: DeviceFeatures(ff, seg.n_docs, dev))


def device_live_mask(seg: Segment, device: DeviceLike = None) -> torch.Tensor:
    """Live mask padded to the doc bucket (True = scoreable)."""
    n_pad = next_pow2(max(seg.n_docs, 1), minimum=BLOCK)
    dev = resolve_device(device)
    # one entry per device under the "live" key, which Segment.delete_doc
    # drops: a delete invalidates every device's mirror at once
    mirrors = seg.device("live", dict)
    got = mirrors.get(str(dev))
    if got is None:
        m = np.zeros(n_pad, bool)
        m[: seg.n_docs] = seg.live
        got = mirrors[str(dev)] = torch.as_tensor(m, device=dev)
    return got


def gather_query_blocks(pf: PostingsField, terms_with_weights,
                        n_blocks_bucket_min: int = 8
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side prep for a query: list every posting block of every query
    term, with its per-block weight (e.g. idf). Returns (block_indices int32
    [QB_pad], block_weights float32 [QB_pad]) padded to a pow2 bucket so the
    device gather has a bucketed static shape. Padding uses block 0 with
    weight 0 (contributes nothing). Per-term block lists come from the
    field's immutable cache (PostingsField.term_block_idx), so repeat terms
    across the query stream pay the list construction once per refresh."""
    idx_parts: list = []
    w_parts: list = []
    for term, weight in terms_with_weights:
        t_idx = pf.term_block_idx(term)
        if not len(t_idx):
            continue
        idx_parts.append(t_idx)
        w_parts.append(np.full(len(t_idx), weight, np.float32))
    n = sum(len(p) for p in idx_parts)
    qb_pad = next_pow2(max(n, 1), minimum=n_blocks_bucket_min)
    out_idx = np.zeros(qb_pad, np.int32)
    out_w = np.zeros(qb_pad, np.float32)
    if idx_parts:
        out_idx[:n] = np.concatenate(idx_parts)
        out_w[:n] = np.concatenate(w_parts)
    return out_idx, out_w


# ---------------------------------------------------------------------------
# packed multi-segment device plane
# ---------------------------------------------------------------------------

class PlaneUnavailable(Exception):
    """The field has no data in any of the shard's segments — there is
    nothing to plane; callers take the per-segment path."""


class PlanePart:
    """Base of one (kind, field) plane over one ordered segment set.

    ``doc_base[i]`` is the plane doc offset of segment i (reader order,
    ALL segments, field-less ones included), so plane doc ids map 1:1
    onto (segment_idx, local_doc)."""

    kind = "?"

    def __init__(self, field: str, segments: List[Segment],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.field = field
        self.segments = list(segments)
        self.uids = tuple(s.uid for s in segments)
        counts = np.asarray([s.n_docs for s in segments], np.int64)
        self.doc_base = np.zeros(max(len(segments), 1), np.int64)
        if len(counts) > 1:
            self.doc_base[1: len(counts)] = np.cumsum(counts)[:-1]
        self.n_docs_total = int(counts.sum()) if len(counts) else 0
        self.n_docs_pad = next_pow2(max(self.n_docs_total, 1), minimum=BLOCK)
        # per-segment rebased host arrays keyed by uid: the incremental
        # refresh path copies matching entries from the previous
        # generation and recomputes only appended segments
        self._seg_cache: Dict[int, Any] = {}
        self.nbytes = 0
        # DeviceCharge handles for everything this part pinned on device;
        # eviction releases them ahead of GC so the breaker-pressure
        # retry can actually free budget
        self._charges: List[Any] = []

    def release(self) -> None:
        for charge in self._charges:
            charge.release()

    def demux(self, plane_docs: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """plane doc ids -> (segment positions, local doc ids)."""
        docs = np.asarray(plane_docs, np.int64)
        si = np.searchsorted(self.doc_base[: len(self.segments)], docs,
                             side="right") - 1
        si = np.maximum(si, 0)
        return si, docs - self.doc_base[si]

    def live_mask(self, live_masks) -> torch.Tensor:
        """Reader-snapshot live masks stacked into plane doc space (padding
        False). Built per query, like the per-segment snapshot uploads —
        deletes therefore never invalidate the plane itself."""
        out = np.zeros(self.n_docs_pad, bool)
        off = 0
        for m in live_masks:
            out[off: off + len(m)] = m
            off += len(m)
        return torch.as_tensor(out, device=self.device)

    # subclasses: build(prev) -> host arrays tuple (breaker-checked by the
    # registry BEFORE upload), then upload(host) pins them on device.


def _seg_ids_host(doc_base, n_segs: int, length: int) -> np.ndarray:
    """[length] int32: owning segment POSITION per plane doc (searchsorted
    right - 1 over the first n_segs doc bases, clamped at 0). Docs past
    the packed corpus clamp to the last segment — they are padding, never
    live."""
    ids = np.searchsorted(np.asarray(doc_base[:n_segs]),
                          np.arange(length, dtype=np.int64),
                          side="right") - 1
    return np.maximum(ids, 0).astype(np.int32)


class PlanePostings(PlanePart):
    """All segments' posting blocks for one text field, doc ids rebased.

    ``block_avgdl`` (host) carries each block's OWNING SEGMENT avgdl, so
    the flat BM25 kernel computes the exact per-segment length norm the
    solo path uses — plane scores match per-segment scores, not a blended
    shard-wide normalization."""

    kind = "postings"

    def build(self, prev: Optional["PlanePostings"]):
        refs = []           # (seg_pos, PostingsField, block_base, avgdl)
        blocks_docs, blocks_tfs, block_avg = [], [], []
        doc_lens_parts = []
        nb = 0
        for pos, seg in enumerate(self.segments):
            pf = seg.postings.get(self.field)
            n = seg.n_docs
            if pf is None:
                doc_lens_parts.append(np.zeros(n, np.float32))
                continue
            cached = prev._seg_cache.get(seg.uid) if prev is not None \
                else None
            if cached is None:
                base = int(self.doc_base[pos])
                r_docs = np.where(pf.block_docs >= 0,
                                  pf.block_docs + base, -1).astype(np.int32)
                avgdl = float(pf.sum_doc_len
                              / max(1, (pf.doc_lens > 0).sum()))
                dl = np.zeros(n, np.float32)
                dl[: min(n, len(pf.doc_lens))] = pf.doc_lens[:n]
                cached = (r_docs, pf.block_tfs, dl, avgdl)
            self._seg_cache[seg.uid] = cached
            r_docs, r_tfs, dl, avgdl = cached
            refs.append((pos, pf, nb, avgdl))
            blocks_docs.append(r_docs)
            blocks_tfs.append(r_tfs)
            block_avg.append(np.full(r_docs.shape[0], avgdl, np.float32))
            doc_lens_parts.append(dl)
            nb += r_docs.shape[0]
        if not refs:
            raise PlaneUnavailable(self.field)
        self.refs = refs
        self.n_blocks = nb
        nb_pad = next_pow2(max(nb, 1))
        bd = np.full((nb_pad, BLOCK), -1, np.int32)
        bt = np.zeros((nb_pad, BLOCK), np.float32)
        ba = np.ones(nb_pad, np.float32)
        bd[:nb] = np.concatenate(blocks_docs)
        bt[:nb] = np.concatenate(blocks_tfs)
        ba[:nb] = np.concatenate(block_avg)
        dl_all = np.zeros(self.n_docs_pad, np.float32)
        off = 0
        for p in doc_lens_parts:
            dl_all[off: off + len(p)] = p
            off += len(p)
        # block_avgdl stays HOST-side: the flat dispatch gathers it per
        # plan into the [FB] kernel argument
        self.block_avgdl = ba
        self._q_dev: Optional[Tuple] = None
        self._q_failed = False
        return (bd, bt, dl_all)

    def upload(self, host) -> None:
        bd, bt, dl = host
        self.block_docs = torch.as_tensor(bd, device=self.device)
        self.block_tfs = torch.as_tensor(bt, device=self.device)
        self.doc_lens = torch.as_tensor(dl, device=self.device)

    def quantized_mirror(self) -> Optional[Tuple]:
        """(block_tfs bf16 [NB, BLOCK], doc_lens bf16 [N_pad]) on the
        plane's device — the coarse tier's reduced-precision gather
        operands: built lazily on the FIRST coarse query (converted on the
        device itself), cached per plane generation, separately
        breaker-charged, and a budget refusal is remembered so a starved
        node never re-quantizes per query. Doc ids stay int32 (they are
        gather indices, shared with the exact arrays)."""
        if self._q_dev is not None:
            return self._q_dev
        if self._q_failed:
            return None
        n_bytes = 2 * (self.block_tfs.numel() + self.doc_lens.numel())
        from elasticsearch_tpu_torch.indices.breaker import charge_device
        try:
            charge = charge_device(
                self, n_bytes, f"plane_postings_q:{self.field}",
                return_charge=True)
        except CircuitBreakingError:
            self._q_failed = True
            return None
        self._charges.append(charge)
        self.nbytes += charge.n_bytes
        self._q_dev = (self.block_tfs.to(torch.bfloat16),
                       self.doc_lens.to(torch.bfloat16))
        return self._q_dev

    def seg_ids(self) -> torch.Tensor:
        """[n_docs_pad] int32: each plane doc's owning segment POSITION
        (reader order) — the per-segment counting channel of the
        totals-disabled plane path. Padding docs never match (live is
        False there), so their attribution is irrelevant; they clamp to
        the last segment."""
        cached = getattr(self, "_seg_ids_dev", None)
        if cached is None:
            cached = torch.as_tensor(_seg_ids_host(
                self.doc_base, len(self.segments), self.n_docs_pad),
                device=self.device)
            self._seg_ids_dev = cached
        return cached


def quantize_rows(matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(q8 [N, D] int8, scales [N] f32): symmetric per-row int8
    quantization, the JAX package's numpy code, so the bytes are its."""
    amax = np.abs(matrix).max(axis=1)
    scales = np.maximum(amax / 127.0, 1e-30).astype(np.float32)
    q8 = np.clip(np.round(matrix / scales[:, None]),
                 -127, 127).astype(np.int8)
    return q8, scales


class PlaneVectors(PlanePart):
    """All segments' dense-vector rows for one field, stacked [N_pad, D],
    plus an int8 symmetric-quantized mirror (built host-side, uploaded on
    the first quantized query) for the coarse scoring pass."""

    kind = "vectors"

    def build(self, prev: Optional["PlaneVectors"]):
        dims, similarity = None, "cosine"
        for seg in self.segments:
            vf = seg.vectors.get(self.field)
            if vf is not None:
                dims, similarity = vf.dims, vf.similarity
                break
        if dims is None:
            raise PlaneUnavailable(self.field)
        self.dims, self.similarity = dims, similarity
        matrix = np.zeros((self.n_docs_pad, dims), np.float32)
        norms = np.zeros(self.n_docs_pad, np.float32)
        exists = np.zeros(self.n_docs_pad, bool)
        for pos, seg in enumerate(self.segments):
            vf = seg.vectors.get(self.field)
            if vf is None:
                continue
            cached = prev._seg_cache.get(seg.uid) if prev is not None \
                else None
            if cached is None:
                n = seg.n_docs
                ex = np.zeros(n, bool)
                ex[: min(n, len(vf.exists))] = vf.exists[:n]
                cached = (vf.matrix, vf.norms, ex)
            self._seg_cache[seg.uid] = cached
            m, nr, ex = cached
            base = int(self.doc_base[pos])
            matrix[base: base + len(ex)] = m[: len(ex)]
            norms[base: base + len(ex)] = nr[: len(ex)]
            exists[base: base + len(ex)] = ex
        self._q_dev: Optional[Tuple] = None
        self._q_failed = False
        self._ivf = None
        self._ivf_failed = False
        # warm-start seed for this generation's k-means: the previous
        # generation's trained centroids (an append-only refresh barely
        # moves them, so Lloyd's converges in a fraction of the cold
        # iterations instead of retraining from scratch)
        self._ivf_seed = None
        if prev is not None:
            prev_ivf = getattr(prev, "_ivf", None)
            if prev_ivf is not None and prev_ivf[0] is not None:
                self._ivf_seed = prev_ivf[0].centroids.cpu().numpy()
        self.rows = np.nonzero(exists[: self.n_docs_total])[0] \
            .astype(np.int64)
        return (matrix, norms, exists)

    def upload(self, host) -> None:
        matrix, norms, exists = host
        self.matrix = torch.as_tensor(matrix, device=self.device)
        self.norms = torch.as_tensor(norms, device=self.device)
        self.exists = torch.as_tensor(exists, device=self.device)

    def quantized_mirror(self) -> Optional[Tuple]:
        """(q8 [N_pad, D] int8, scales [N_pad] f32) on the plane's device --
        int8 symmetric per-row quantization, built on the host with the JAX
        package's numpy code (so its bytes are identical), on the FIRST
        quantized query (planes served exact never pay the quantization or
        its residency), and cached per plane generation. None when the
        upload would trip the device breaker: the exact plane path still
        serves, and the refusal is remembered so a budget-starved node
        doesn't re-quantize per query."""
        if self._q_dev is not None:
            return self._q_dev
        if self._q_failed:
            return None
        # one D2H per plane generation
        q8, scales = quantize_rows(self.matrix.cpu().numpy())
        from elasticsearch_tpu_torch.indices.breaker import account_device_arrays
        try:
            charge = account_device_arrays(
                self, (q8, scales), f"plane_vectors_q:{self.field}",
                return_charge=True)
        except CircuitBreakingError:
            self._q_failed = True
            return None
        self._charges.append(charge)
        self.nbytes += charge.n_bytes   # residency stats see the mirror
        self._q_dev = (torch.as_tensor(q8, device=self.device),
                       torch.as_tensor(scales, device=self.device))
        return self._q_dev

    def ivf_index(self, nlist: Optional[int]):
        """(index, rows): the shard-level IVF over the plane's vectors
        (rows = plane doc ids holding a vector), built once per plane
        generation and shared by the solo rewrite and the batched executor
        so their ANN results cannot diverge; index None when no doc holds
        a vector. A breaker-refused build is memoized for the plane's
        lifetime (a new generation retries): re-running the full k-means
        per query just to trip the breaker again would be the worst
        possible degradation."""
        if self._ivf is None:
            if self._ivf_failed:
                raise CircuitBreakingError(
                    f"[device] ivf index for [{self.field}] was refused "
                    f"by the device memory budget")
            if not len(self.rows):
                self._ivf = (None, self.rows)
            else:
                from elasticsearch_tpu_torch.ops.ivf import IVFIndex
                host = self.matrix.cpu().numpy()[self.rows]
                try:
                    index = IVFIndex.build(
                        host, nlist=nlist, similarity=self.similarity,
                        init_centroids=self._ivf_seed, device=self.device)
                except CircuitBreakingError:
                    self._ivf_failed = True
                    raise
                if index.warm_started:
                    PLANES.stats["ivf_warm_starts"] += 1
                # the index's device memory is part of this plane's
                # residency: eviction must release its charge early too,
                # and stats must count it
                self._charges.append(index._charge)
                self.nbytes += index._charge.n_bytes
                self._ivf = (index, self.rows)
        return self._ivf


class PlaneFeatures(PlanePart):
    """All segments' rank_features blocks for one field, doc ids rebased."""

    kind = "features"

    def build(self, prev: Optional["PlaneFeatures"]):
        refs = []           # (seg_pos, FeaturesField, block_base)
        blocks_docs, blocks_w = [], []
        nb = 0
        for pos, seg in enumerate(self.segments):
            ff = seg.features.get(self.field)
            if ff is None:
                continue
            cached = prev._seg_cache.get(seg.uid) if prev is not None \
                else None
            if cached is None:
                base = int(self.doc_base[pos])
                r_docs = np.where(ff.block_docs >= 0,
                                  ff.block_docs + base, -1).astype(np.int32)
                cached = (r_docs, ff.block_weights)
            self._seg_cache[seg.uid] = cached
            r_docs, r_w = cached
            refs.append((pos, ff, nb))
            blocks_docs.append(r_docs)
            blocks_w.append(r_w)
            nb += r_docs.shape[0]
        if not refs:
            raise PlaneUnavailable(self.field)
        self.refs = refs
        self.n_blocks = nb
        nb_pad = next_pow2(max(nb, 1))
        bd = np.full((nb_pad, BLOCK), -1, np.int32)
        bw = np.zeros((nb_pad, BLOCK), np.float32)
        bd[:nb] = np.concatenate(blocks_docs)
        bw[:nb] = np.concatenate(blocks_w)
        self._q_dev: Optional[torch.Tensor] = None
        self._q_failed = False
        return (bd, bw)

    def upload(self, host) -> None:
        bd, bw = host
        self.block_docs = torch.as_tensor(bd, device=self.device)
        self.block_weights = torch.as_tensor(bw, device=self.device)

    def quantized_mirror(self) -> Optional[torch.Tensor]:
        """block_weights bf16 [NB, BLOCK] on the plane's device -- the
        sparse coarse tier's reduced-precision gather operand (converted
        on the device, round to nearest even as the JAX package's numpy
        cast); same lazy-build / per-generation cache / refusal-memo
        contract as the postings and vector mirrors."""
        if self._q_dev is not None:
            return self._q_dev
        if self._q_failed:
            return None
        from elasticsearch_tpu_torch.indices.breaker import charge_device
        try:
            charge = charge_device(
                self, 2 * self.block_weights.numel(),
                f"plane_features_q:{self.field}", return_charge=True)
        except CircuitBreakingError:
            self._q_failed = True
            return None
        self._charges.append(charge)
        self.nbytes += charge.n_bytes
        self._q_dev = self.block_weights.to(torch.bfloat16)
        return self._q_dev


class PlaneColumns(PlanePart):
    """All segments' aggregation columns for one field, concatenated into
    plane doc space: the numeric/date doc-values column (int32 + exists)
    and/or the keyword ordinal occurrence table with ordinals remapped to
    GLOBAL (plane-wide, sorted term union) space at pack time. One field
    commonly has only one side; the other uploads as zero-length arrays
    and costs nothing.

    The numeric side keeps the per-segment device collector's exactness
    gates (single-valued, integral dtype, |v| < 2^24 so the fused f32
    sum/min/max stay exact) — a segment that fails them poisons only the
    numeric side, with the TYPED reason kept on the part so the agg
    planner can record why it fell back to the host collector while the
    keyword side keeps serving."""

    kind = "columns"

    def _pack_segment(self, seg: Segment):
        """(numeric_entry, keyword_entry) host cache for one segment,
        keyed by uid so incremental append reuses it verbatim. Keyword
        ordinals stay LOCAL here — the global remap depends on the whole
        segment set and is recomputed per pack (cheap host work)."""
        num = None
        dv = seg.doc_values.get(self.field)
        if dv is not None:
            if dv.multi:
                num = ("ineligible", "multi_valued")
            elif dv.values.dtype.kind != "i":
                num = ("ineligible", "non_integer")
            else:
                docs = np.nonzero(dv.exists)[0]
                vmin = int(dv.values[docs].min()) if len(docs) else None
                vmax = int(dv.values[docs].max()) if len(docs) else None
                if vmax is not None and \
                        max(abs(vmin), abs(vmax)) >= 2 ** 24:
                    # same gate as the per-segment device histogram:
                    # int32-safe AND f32-exact (epoch-millis dates land
                    # here and keep the host path)
                    num = ("ineligible", "magnitude")
                else:
                    n = seg.n_docs
                    ex = np.zeros(n, bool)
                    ex[: min(n, len(dv.exists))] = dv.exists[:n]
                    vals = np.zeros(n, np.int32)
                    m = min(n, len(dv.values))
                    vals[:m] = np.where(ex[:m], dv.values[:m],
                                        0).astype(np.int32)
                    num = ("ok", vals, ex, vmin, vmax)
        kw = None
        kf = seg.keywords.get(self.field) if \
            hasattr(seg, "keywords") else None
        if kf is not None:
            counts = np.diff(kf.ord_offsets)
            owners = np.repeat(np.arange(len(counts), dtype=np.int32),
                               counts)
            ords = kf.ord_values.astype(np.int32)
            if len(owners):
                # dedup (doc, ord) at pack time — same rule as the
                # per-segment occurrence table (_dedup_doc_ord): a doc
                # counts once per term even when the stored array
                # repeats a value
                pair = owners.astype(np.int64) \
                    * max(len(kf.term_list), 1) + ords
                _, first = np.unique(pair, return_index=True)
                owners, ords = owners[first], ords[first]
            kw = (owners, ords, list(kf.term_list))
        return (num, kw)

    def build(self, prev: Optional["PlaneColumns"]):
        values = np.zeros(self.n_docs_pad, np.int32)
        exists = np.zeros(self.n_docs_pad, bool)
        have_num, num_reason = False, None
        vmin, vmax = None, None
        kw_parts = []     # (base, owners_local, ords_local, term_list)
        for pos, seg in enumerate(self.segments):
            cached = prev._seg_cache.get(seg.uid) if prev is not None \
                else None
            if cached is None:
                cached = self._pack_segment(seg)
            self._seg_cache[seg.uid] = cached
            num, kw = cached
            base = int(self.doc_base[pos])
            if num is not None:
                have_num = True
                if num[0] == "ineligible":
                    num_reason = num_reason or num[1]
                else:
                    _, vals, ex, s_min, s_max = num
                    values[base: base + len(ex)] = vals[: len(ex)]
                    exists[base: base + len(ex)] = ex
                    if s_min is not None:
                        vmin = s_min if vmin is None else min(vmin, s_min)
                        vmax = s_max if vmax is None else max(vmax, s_max)
            if kw is not None:
                kw_parts.append((base,) + kw)
        if not have_num and not kw_parts:
            raise PlaneUnavailable(self.field)
        self.has_numeric = have_num and num_reason is None
        self.num_reason = num_reason
        self.vmin, self.vmax = vmin, vmax
        # global-ordinal remap: plane term space is the SORTED union of
        # the segment term lists, so bucket keys come straight off the
        # global ordinal and per-segment ords never leak upward
        term_list: List = sorted({t for p in kw_parts for t in p[3]})
        gid = {t: i for i, t in enumerate(term_list)}
        self.has_keyword = bool(kw_parts)
        self.term_list = term_list
        self.n_terms = len(term_list)
        own_parts, ord_parts = [], []
        for base, owners, ords, terms in kw_parts:
            if not len(owners):
                continue
            lookup = np.asarray([gid[t] for t in terms], np.int32) \
                if terms else np.empty(0, np.int32)
            own_parts.append(owners.astype(np.int64) + base)
            ord_parts.append(lookup[ords])
        n_occ = sum(len(p) for p in own_parts)
        self.n_occurrences = n_occ
        if kw_parts:
            e_pad = next_pow2(max(n_occ, 1), minimum=8)
            kw_owners = np.zeros(e_pad, np.int32)
            kw_ords = np.full(e_pad, -1, np.int32)
            if n_occ:
                kw_owners[:n_occ] = np.concatenate(own_parts)
                kw_ords[:n_occ] = np.concatenate(ord_parts)
        else:
            kw_owners = np.empty(0, np.int32)
            kw_ords = np.empty(0, np.int32)
        if not self.has_numeric:
            values = np.empty(0, np.int32)
            exists = np.empty(0, bool)
        return (values, exists, kw_owners, kw_ords)

    def upload(self, host) -> None:
        values, exists, kw_owners, kw_ords = host
        dev = self.device
        self.values = torch.as_tensor(values, device=dev)
        self.exists = torch.as_tensor(exists, device=dev)
        self.kw_owners = torch.as_tensor(kw_owners, device=dev)
        self.kw_ords = torch.as_tensor(kw_ords, device=dev)


_PART_CLASSES = {"postings": PlanePostings, "vectors": PlaneVectors,
                 "features": PlaneFeatures, "columns": PlaneColumns}


def _count_reason(reason: str) -> None:
    """Typed data-plane routing record (search/telemetry.py taxonomy);
    lazy import: ops must not import the search package at load time."""
    from elasticsearch_tpu_torch.search.telemetry import TELEMETRY
    TELEMETRY.count_fallback(reason)


class PlaneRegistry:
    """Process-global plane residency manager: build-on-demand keyed by
    (kind, field, segment uid tuple), incremental append across refresh
    generations, LRU + breaker-aware eviction. ``get`` returning None
    means "serve this query per-segment" — the plane is an optimization,
    never a correctness gate."""

    MAX_PARTS = 64
    MAX_REFUSALS = 128

    def __init__(self):
        self._parts: "OrderedDict[Tuple, PlanePart]" = OrderedDict()
        # keys refused by the budget, with the budget "token" they were
        # refused under: an over-budget shard must fast-miss (no per-query
        # host re-pack, no shedding every other shard's hot planes) until
        # either a refresh changes its key or the budget itself changes
        self._refused: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        # dynamic config (search.plane.* cluster settings; applied via
        # configure_from_state on nodes, directly in unit tests/bench)
        self.enabled = True
        self.min_segments = 2
        self.rerank_depth = 128
        self.rerank_depth_max = 1024
        self.quantized = True
        self.max_bytes = 0          # 0 = breaker-only budgeting
        self.stats: Dict[str, int] = {
            "plane_builds": 0,
            "plane_full_rebuilds": 0,
            "plane_incremental_appends": 0,
            "plane_evictions": 0,
            "plane_miss_fallbacks": 0,
            "quantized_queries": 0,
            "rerank_escalations": 0,
            "quantized_exact_fallbacks": 0,
            "quantized_disengaged_slow": 0,
            "ivf_warm_starts": 0,
            "plane_aggs_queries": 0,
            "plane_aggs_fallbacks": 0,
        }
        # measured-latency engage rule for the quantized coarse tier:
        # per-(query class, tier) EWMAs of observed per-query serve
        # latency. On backends where bf16 is emulated (the CPU-fallback
        # box) the coarse pass can measure SLOWER than exact — the
        # corpus-size gate alone cannot see that, so the registry
        # compares what it actually measured and disengages the tier,
        # still probing occasionally so a backend change can re-engage.
        self._lat_ewma: Dict[Tuple[str, str], float] = {}
        self._lat_n: Dict[Tuple[str, str], int] = {}
        self._probe_counter: Dict[str, int] = {}
        # adaptive re-rank depth histogram: served depth -> query count
        # (the k' each query's margin actually settled at — the coarse
        # tier's observability surface, next to quantized_queries)
        self.rerank_depth_hist: Dict[int, int] = {}
        # device-observatory residency record: monotonically stamped
        # generations, the resident-bytes high-water mark, and WHY each
        # plane left HBM (the "device_profile" stats section)
        self._gen = 0
        self.hbm_high_water = 0
        self.evictions_by_cause: Dict[str, int] = {}

    # -- config ---------------------------------------------------------

    def configure_from_state(self, state) -> None:
        """Refresh config from committed cluster settings. Re-parsing per
        query would tax the very hot path this module shrinks, so the
        parse is memoized on the state version (settings only change
        through a committed state)."""
        version = getattr(state, "version", None)
        if version is not None and \
                version == getattr(self, "_cfg_version", None):
            return
        self._cfg_version = version
        from elasticsearch_tpu_torch.utils.settings import (
            SEARCH_PLANE_ENABLED, SEARCH_PLANE_MAX_BYTES,
            SEARCH_PLANE_MIN_SEGMENTS, SEARCH_PLANE_QUANTIZED,
            SEARCH_PLANE_RERANK_DEPTH, SEARCH_PLANE_RERANK_DEPTH_MAX,
            setting_from_state,
        )
        self.enabled = setting_from_state(state, SEARCH_PLANE_ENABLED)
        self.min_segments = setting_from_state(state,
                                               SEARCH_PLANE_MIN_SEGMENTS)
        self.rerank_depth = setting_from_state(state,
                                               SEARCH_PLANE_RERANK_DEPTH)
        self.rerank_depth_max = setting_from_state(
            state, SEARCH_PLANE_RERANK_DEPTH_MAX)
        self.quantized = setting_from_state(state, SEARCH_PLANE_QUANTIZED)
        self.max_bytes = setting_from_state(state, SEARCH_PLANE_MAX_BYTES)

    def note_quantized(self, depth: int, n_queries: int,
                       mesh: bool = False) -> None:
        """A coarse+re-rank pass SERVED ``n_queries`` at re-rank depth
        ``depth`` (post-escalation). The adaptive-depth histogram covers
        every coarse tier; ``quantized_queries`` counts only the
        single-shard plane's serves — mesh serves have their own
        ``mesh_quantized_queries`` in the mesh section, and one query
        must not appear under both."""
        if not mesh:
            self.stats["quantized_queries"] += int(n_queries)
        self.rerank_depth_hist[int(depth)] = \
            self.rerank_depth_hist.get(int(depth), 0) + int(n_queries)

    # -- measured-latency engage rule (quantized coarse tier) -----------

    LAT_ALPHA = 0.3          # EWMA smoothing
    LAT_MIN_SAMPLES = 5      # per tier before the comparison may fire
    LAT_SLOW_MARGIN = 1.25   # coarse must be this much slower to lose
    LAT_PROBE_EVERY = 32     # disengaged tier still probes occasionally

    def note_tier_latency(self, cls: str, tier: str,
                          seconds: float) -> None:
        """Record one observed per-query serve latency for a (query
        class, tier) pair; tier is "coarse" or "exact"."""
        key = (cls, tier)
        prev = self._lat_ewma.get(key)
        self._lat_ewma[key] = float(seconds) if prev is None else \
            prev + self.LAT_ALPHA * (float(seconds) - prev)
        self._lat_n[key] = self._lat_n.get(key, 0) + 1

    def quantized_slow(self, cls: str) -> bool:
        """True when the measured coarse EWMA for this class is decisively
        slower than the exact EWMA (both with enough samples)."""
        if self._lat_n.get((cls, "coarse"), 0) < self.LAT_MIN_SAMPLES or \
                self._lat_n.get((cls, "exact"), 0) < self.LAT_MIN_SAMPLES:
            return False
        return self._lat_ewma[(cls, "coarse")] > \
            self._lat_ewma[(cls, "exact")] * self.LAT_SLOW_MARGIN

    def quantized_engaged(self, cls: str) -> bool:
        """Should this query attempt the coarse tier? The corpus-size
        gate still applies downstream; this adds the observed-latency
        comparison. A disengaged class lets every LAT_PROBE_EVERY-th
        query through so the coarse EWMA keeps tracking the backend —
        without the probe a one-time slow measurement would disengage
        the tier forever."""
        if not self.quantized_slow(cls):
            return True
        n = self._probe_counter.get(cls, 0) + 1
        self._probe_counter[cls] = n
        if n % self.LAT_PROBE_EVERY == 0:
            return True
        self.stats["quantized_disengaged_slow"] += 1
        return False

    # -- lookup / build -------------------------------------------------

    def _budget_token(self) -> Tuple:
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS
        return (int(self.max_bytes), int(BREAKERS.breaker("device").limit))

    def _refuse(self, key: Tuple) -> None:
        self.stats["plane_miss_fallbacks"] += 1
        _count_reason("plane_budget_refused")
        self._refused[key] = self._budget_token()
        while len(self._refused) > self.MAX_REFUSALS:
            self._refused.popitem(last=False)

    def get(self, segments, kind: str, field: str,
            device: DeviceLike = None) -> Optional[PlanePart]:
        if kind not in _PART_CLASSES:
            raise NotPortedError(f"plane_{kind}")
        dev = resolve_device(device)
        if not self.enabled:
            _count_reason("plane_disabled")
            return None
        segments = list(segments)
        if len(segments) < max(1, self.min_segments):
            _count_reason("plane_too_few_segments")
            return None
        key = (kind, field, str(dev)) + tuple(s.uid for s in segments)
        part = self._parts.get(key)
        if part is not None:
            self._parts.move_to_end(key)
            return part
        refused_under = self._refused.get(key)
        if refused_under is not None:
            if refused_under == self._budget_token():
                self.stats["plane_miss_fallbacks"] += 1
                _count_reason("plane_budget_refused")
                return None
            self._refused.pop(key, None)   # budget changed: try again
        return self._build(segments, kind, field, key, dev)

    def _build(self, segments, kind: str, field: str, key: Tuple,
               dev: torch.device) -> Optional[PlanePart]:
        uids = tuple(s.uid for s in segments)
        prev = None
        for k2, p2 in reversed(self._parts.items()):
            if k2[:3] == key[:3] and \
                    len(p2.uids) < len(uids) and \
                    uids[: len(p2.uids)] == p2.uids:
                prev = p2
                break
        part = _PART_CLASSES[kind](field, segments, dev)
        try:
            host = part.build(prev)
        except PlaneUnavailable:
            _count_reason("plane_field_absent")
            return None
        part.nbytes = sum(int(a.nbytes) for a in host)
        if self.max_bytes and part.nbytes > int(self.max_bytes):
            self._refuse(key)
            return None
        from elasticsearch_tpu_torch.indices.breaker import (
            BREAKERS, account_device_arrays,
        )
        label = f"plane_{kind}:{field}"
        charge = None
        try:
            charge = account_device_arrays(part, host, label,
                                           return_charge=True)
        except CircuitBreakingError:
            device_limit = BREAKERS.breaker("device").limit
            if 0 < device_limit < part.nbytes:
                # can NEVER fit: don't shed anyone's planes for it
                self._refuse(key)
                return None
            # evict in LRU order, ONE plane at a time, releasing each
            # charge immediately (not at GC) and retrying — so a budget
            # that fits both hot shards after dropping one cold plane
            # keeps the other hot plane resident instead of ping-ponging
            while self._parts:
                self._drop(next(iter(self._parts)),
                           cause="breaker_pressure")
                try:
                    charge = account_device_arrays(part, host, label,
                                                   return_charge=True)
                    break
                except CircuitBreakingError:
                    continue
            if charge is None:
                self._refuse(key)
                return None
        part._charges.append(charge)
        part.upload(host)
        self.stats["plane_builds"] += 1
        part.generation = self._gen
        part.built_at = time.monotonic()
        self._gen += 1
        if prev is not None:
            self.stats["plane_incremental_appends"] += 1
            # the superseded generation is NOT dropped eagerly: a
            # point-in-time reader (scroll) acquired before the refresh
            # still queries the old segment set, and dropping it here
            # would force a full re-pack on its next query. It ages out
            # via LRU, merge invalidation, or the breaker-pressure shed.
        else:
            self.stats["plane_full_rebuilds"] += 1
        self._parts[key] = part
        self.hbm_high_water = max(
            self.hbm_high_water,
            sum(p.nbytes for p in self._parts.values()))
        while len(self._parts) > self.MAX_PARTS:
            self._drop(next(iter(self._parts)), cause="lru")
        return part

    # -- eviction / lifecycle -------------------------------------------

    def _drop(self, key: Tuple, count_eviction: bool = True,
              cause: str = "lru") -> None:
        part = self._parts.pop(key, None)
        if part is None:
            return
        part.release()      # budget back NOW; GC finalizers then no-op
        self.evictions_by_cause[cause] = \
            self.evictions_by_cause.get(cause, 0) + 1
        if count_eviction:
            self.stats["plane_evictions"] += 1

    def evict_cold(self) -> int:
        """Drop every resident plane (LRU pressure valve for a breaker
        trip), releasing their breaker charges immediately. In-flight
        queries keep their part's ARRAYS alive through their own
        references until they finish — the transient undercount is the
        eviction working as intended."""
        n = len(self._parts)
        for key in list(self._parts):
            self._drop(key, cause="breaker_pressure")
        return n

    def drop_segments(self, uids) -> None:
        """Invalidate every plane touching any of these segment uids —
        the merge path: merged-away segments are dead weight on device
        and their planes can never be requested again (a merge changes
        the uid tuple), so free them eagerly instead of waiting for LRU."""
        uids = set(uids)
        for key in [k for k, p in self._parts.items()
                    if uids.intersection(p.uids)]:
            self._drop(key, count_eviction=False,
                       cause="merge_invalidated")

    def clear(self) -> None:
        for key in list(self._parts):
            self._drop(key, count_eviction=False, cause="clear")
        self._refused.clear()
        self._lat_ewma.clear()
        self._lat_n.clear()
        self._probe_counter.clear()

    def on_refresh(self, segments) -> None:
        """Refresh publication: eagerly re-pack any resident plane whose
        segment set is a strict prefix of the new set (the append-only
        refresh case), so the refresh pays the upload instead of the next
        query. Merges (prefix broken) rebuild lazily on demand."""
        if not self.enabled:
            return
        uids = tuple(s.uid for s in segments)
        todo = set()
        for key, part in list(self._parts.items()):
            if part.uids != uids and len(part.uids) < len(uids) and \
                    uids[: len(part.uids)] == part.uids:
                todo.add((key[0], key[1], part.device))
        for kind, field, dev in todo:
            self.get(segments, kind, field, dev)

    def stats_snapshot(self) -> Dict[str, Any]:
        by_kind = {"postings": 0, "vectors": 0, "features": 0,
                   "columns": 0}
        for p in self._parts.values():
            by_kind[p.kind] = by_kind.get(p.kind, 0) + p.nbytes
        return {**self.stats,
                "planes_resident": len(self._parts),
                "resident_bytes": by_kind,
                "rerank_depth": int(self.rerank_depth),
                "rerank_depth_max": int(self.rerank_depth_max),
                "rerank_depth_histogram": {
                    str(d): n for d, n
                    in sorted(self.rerank_depth_hist.items())},
                "quantized": bool(self.quantized)}

    def residency_snapshot(self) -> Dict[str, Any]:
        """The device observatory's HBM residency timeline: every
        resident plane with its bytes, generation stamp and age, plus
        the high-water mark and the eviction-cause breakdown — WHERE the
        HBM went and WHY it left, from the stats surface alone."""
        now = time.monotonic()
        total = 0
        planes = []
        for p in self._parts.values():
            total += p.nbytes
            planes.append({
                "kind": p.kind, "field": p.field,
                "bytes": int(p.nbytes),
                "generation": int(getattr(p, "generation", 0)),
                "age_s": round(now - getattr(p, "built_at", now), 3),
            })
        planes.sort(key=lambda e: -e["age_s"])
        self.hbm_high_water = max(self.hbm_high_water, total)
        return {
            "resident_bytes_total": total,
            "high_water_bytes": int(self.hbm_high_water),
            "generations_built": int(self._gen),
            "planes": planes,
            "evictions_by_cause": dict(
                sorted(self.evictions_by_cause.items())),
        }


# one card per process -> one plane residency manager per process
# (the same reasoning as indices/breaker.py's BREAKERS)
PLANES = PlaneRegistry()


# ---------------------------------------------------------------------------
# mesh-sharded device plane: co-located shards stacked on the node's device
# ---------------------------------------------------------------------------

class MeshPlanePart:
    """One (kind, field) plane over a SET of co-located shards, laid out
    for one launch per phase: each shard's packed plane occupies one slot
    of a ``[S, ...]`` stack on the node's device (``parallel/mesh.py``
    ``mesh_layout``: the JAX package's ``shard`` mesh axis is the
    kernels' leading slot axis), so one ``mesh_bm25_*``, ``mesh_knn_*``
    or ``mesh_sparse_*`` launch scores every (shard, query) pair and the
    per-shard RPC fan-out collapses to ONE launch per phase.

    ``subs[i]`` is shard i's host-level PlanePart (refs / doc_base /
    block_avgdl / demux — the same per-shard planning surfaces the
    single-shard plane executors use), or None when the field has no
    data in that shard (its slot scores nothing and the executors emit
    the per-segment path's empty result for it)."""

    # dp rows of the flat stacks: every slot lives on one device
    dp = 1

    def __init__(self, kind: str, field: str, shard_keys: Tuple,
                 subs: List[Optional[PlanePart]], segments_by_shard,
                 device: torch.device, n_slots: int):
        self.kind = kind
        self.field = field
        self.shard_keys = shard_keys          # ordered (index, shard_id)
        self.subs = subs
        self.segments_by_shard = segments_by_shard
        self.device = device
        self.n_slots = n_slots
        self.n_shards = len(shard_keys)
        self.nbytes = 0
        self.per_device_bytes = 0
        self._charges: List[Any] = []
        # filled by the registry's stacking pass
        self.n_docs_pad = BLOCK
        self.n_segs_max = 1
        # the lazily-built stacked quantized mirror (the PlanePostings /
        # PlaneVectors precedent): built on the first quantized mesh
        # query, cached for the part's lifetime, refusal memoized
        self._q_dev: Optional[Tuple] = None
        self._q_failed = False

    def release(self) -> None:
        for charge in self._charges:
            charge.release()

    def uids_of(self, shard_key) -> Tuple:
        i = self.shard_keys.index(shard_key)
        return tuple(s.uid for s in self.segments_by_shard[i])

    def quantized_mirror(self) -> Optional[Tuple]:
        """The stacked coarse-tier operands, each slot's rows exactly that
        shard's single-plane mirror:

        - postings: (block_tfs bf16 [S, NB, B], doc_lens bf16 [S, N]),
          converted on the device itself;
        - vectors: (q8 int8 [S, N, D], scales f32 [S, N]), ``quantize_rows``
          over the [S * N, D] rows on the host (per-row symmetric, so each
          row quantizes exactly as in that shard's ``PlaneVectors``
          mirror);
        - features: (block_weights bf16 [S, NB, B],), converted on the
          device itself (round to nearest even, each slot's rows that
          shard's ``PlaneFeatures`` mirror).

        Breaker-charged like the exact stacks; a refused upload is
        memoized so a starved node serves the exact mesh path without
        re-quantizing per fan-out. None = serve exact."""
        if self._q_dev is not None:
            return self._q_dev
        if self._q_failed:
            return None
        if self.kind == "postings":
            n_bytes = 2 * (self.block_tfs.numel() + self.doc_lens.numel())
        elif self.kind == "vectors":
            s, n, d = self.matrix.shape
            q8, scales = quantize_rows(
                self.matrix.cpu().numpy().reshape(s * n, d))
            host = (q8.reshape(s, n, d), scales.reshape(s, n))
            n_bytes = int(q8.nbytes + scales.nbytes)
        else:
            n_bytes = 2 * self.block_weights.numel()
        from elasticsearch_tpu_torch.indices.breaker import charge_device
        try:
            charge = charge_device(
                self, n_bytes, f"mesh_plane_{self.kind}_q:{self.field}",
                return_charge=True)
        except CircuitBreakingError:
            self._q_failed = True
            return None
        self._charges.append(charge)
        self.nbytes += n_bytes
        self.per_device_bytes += n_bytes
        if self.kind == "postings":
            self._q_dev = (self.block_tfs.to(torch.bfloat16),
                           self.doc_lens.to(torch.bfloat16))
        elif self.kind == "vectors":
            self._q_dev = tuple(torch.as_tensor(a, device=self.device)
                                for a in host)
        else:
            self._q_dev = (self.block_weights.to(torch.bfloat16),)
        MESH_PLANES.stats["mesh_quantized_mirror_builds"] += 1
        return self._q_dev


class MeshPlaneRegistry:
    """Process-global residency manager for mesh-sharded planes, keyed by
    (kind, field, device, ((index, shard), segment-uid tuple) ...). Same
    contract as PlaneRegistry: ``get`` returning None means "serve this
    fan-out per shard" — the mesh is an optimization, never a
    correctness gate. Planes charge the ``device`` breaker PER DEVICE,
    LRU-evict under pressure, and re-pack incrementally when a member
    shard's refresh appends segments. The postings, vectors and features
    kinds are stacked."""

    MAX_PARTS = 16
    MAX_REFUSALS = 64

    def __init__(self):
        self._parts: "OrderedDict[Tuple, MeshPlanePart]" = OrderedDict()
        self._refused: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        # dynamic config (search.mesh.* cluster settings); ``dp`` is
        # reported, and the layout caps it at the one device
        self.enabled = True
        self.min_shards = 2
        self.dp = 1
        # multi-host fleet topology (search.mesh.hosts, parsed to a
        # parallel.mesh.HostTopology); None = single-host
        self.hosts = None
        self.stats: Dict[str, int] = {
            "mesh_plane_builds": 0,
            "mesh_plane_full_rebuilds": 0,
            "mesh_plane_incremental_appends": 0,
            "mesh_plane_evictions": 0,
            "mesh_plane_miss_fallbacks": 0,
            "mesh_plane_warmups": 0,
            "mesh_quantized_queries": 0,
            "mesh_quantized_mirror_builds": 0,
            "mesh_quantized_fallbacks": 0,
        }
        # device-observatory residency record (the PlaneRegistry shape)
        self._gen = 0
        self.hbm_high_water = 0
        self.evictions_by_cause: Dict[str, int] = {}

    # -- config ---------------------------------------------------------

    def configure_from_state(self, state) -> None:
        version = getattr(state, "version", None)
        if version is not None and \
                version == getattr(self, "_cfg_version", None):
            return
        self._cfg_version = version
        from elasticsearch_tpu_torch.utils.settings import (
            SEARCH_MESH_DP, SEARCH_MESH_ENABLED, SEARCH_MESH_HOSTS,
            SEARCH_MESH_MIN_SHARDS, setting_from_state,
        )
        self.enabled = setting_from_state(state, SEARCH_MESH_ENABLED)
        self.min_shards = setting_from_state(state,
                                             SEARCH_MESH_MIN_SHARDS)
        self.dp = setting_from_state(state, SEARCH_MESH_DP)
        spec = setting_from_state(state, SEARCH_MESH_HOSTS)
        try:
            from elasticsearch_tpu_torch.parallel.mesh import (
                mesh_ready, parse_host_topology,
            )
            # never pay device first-init here (the topology parse needs
            # the device count): an uninitialized card keeps the prior
            # (None) topology until the mesh is warm
            self.hosts = (parse_host_topology(spec)
                          if spec and mesh_ready() else None)
        except Exception:     # noqa: BLE001 — a bad spec disables the
            self.hosts = None  # hosts layer, never serving

    def available(self, n_shards: int, device: DeviceLike = None) -> bool:
        if not self.enabled or n_shards < max(1, self.min_shards):
            return False
        from elasticsearch_tpu_torch.parallel.mesh import mesh_ready
        return mesh_ready(device)

    def warmup(self, device: DeviceLike = None) -> bool:
        """Pay device first-init NOW (the ``search.mesh.warmup_at_boot``
        setting): ``mesh_ready`` refuses to pay first-init inside a
        search, so without this the FIRST eligible search per process on
        a card node always takes the RPC detour. True (and counted) when
        this call actually initialized the card; False when it was
        already up, or the node runs on the CPU, or no card exists."""
        from elasticsearch_tpu_torch.parallel.mesh import mesh_ready
        if torch.device("cuda" if device is None else device).type \
                != "cuda" or mesh_ready(device):
            return False
        try:
            torch.cuda.init()
        except Exception:  # noqa: BLE001 — no card: stay on RPC
            return False
        self.stats["mesh_plane_warmups"] += 1
        return True

    # -- lookup / build -------------------------------------------------

    def _budget_token(self) -> Tuple:
        from elasticsearch_tpu_torch.indices.breaker import BREAKERS
        return (int(BREAKERS.breaker("device").limit), self.dp,
                self.hosts)

    def _refuse(self, key: Tuple) -> None:
        self.stats["mesh_plane_miss_fallbacks"] += 1
        _count_reason("mesh_plane_budget_refused")
        self._refused[key] = self._budget_token()
        while len(self._refused) > self.MAX_REFUSALS:
            self._refused.popitem(last=False)

    @staticmethod
    def _key(shard_segments, kind: str, field: str,
             dev: torch.device) -> Tuple:
        return (kind, field, str(dev)) + tuple(
            (skey, tuple(s.uid for s in segments))
            for skey, segments in shard_segments)

    def get(self, shard_segments, kind: str, field: str,
            device: DeviceLike = None) -> Optional[MeshPlanePart]:
        """``shard_segments``: ordered [((index, shard_id), [segments])]
        — one entry per co-located target shard, reader order inside."""
        if not self.available(len(shard_segments), device):
            return None
        dev = resolve_device(device)
        shard_segments = sorted(
            ((skey, list(segments)) for skey, segments in shard_segments),
            key=lambda e: e[0])
        key = self._key(shard_segments, kind, field, dev)
        part = self._parts.get(key)
        if part is not None:
            self._parts.move_to_end(key)
            return part
        refused_under = self._refused.get(key)
        if refused_under is not None:
            if refused_under == self._budget_token():
                self.stats["mesh_plane_miss_fallbacks"] += 1
                _count_reason("mesh_plane_budget_refused")
                return None
            self._refused.pop(key, None)
        return self._build(shard_segments, kind, field, key, dev)

    def _find_prev(self, shard_segments, kind, field, dev
                   ) -> Optional[MeshPlanePart]:
        """Most recent resident part over the SAME shard set whose every
        shard's segment-uid tuple is a prefix of (or equal to) the new
        one — the append-only refresh case; its subs' per-segment caches
        seed the incremental rebuild."""
        keys = tuple(skey for skey, _ in shard_segments)
        for _k, part in reversed(self._parts.items()):
            if part.kind != kind or part.field != field or \
                    part.shard_keys != keys or part.device != dev:
                continue
            ok = True
            for i, (_skey, segments) in enumerate(shard_segments):
                uids = tuple(s.uid for s in segments)
                prev_uids = tuple(
                    s.uid for s in part.segments_by_shard[i])
                if uids[: len(prev_uids)] != prev_uids:
                    ok = False
                    break
            if ok:
                return part
        return None

    def _build(self, shard_segments, kind: str, field: str,
               key: Tuple, dev: torch.device) -> Optional[MeshPlanePart]:
        from elasticsearch_tpu_torch.parallel.mesh import mesh_layout
        _grid, n_slots, _spd = mesh_layout(len(shard_segments), device=dev)
        prev = self._find_prev(shard_segments, kind, field, dev)
        subs: List[Optional[PlanePart]] = []
        hosts: List[Optional[Tuple]] = []
        for i, (skey, segments) in enumerate(shard_segments):
            sub = _PART_CLASSES[kind](field, segments, dev)
            prev_sub = prev.subs[i] if prev is not None else None
            try:
                hosts.append(sub.build(prev_sub))
                subs.append(sub)
            except PlaneUnavailable:
                hosts.append(None)
                subs.append(None)
        if all(s is None for s in subs):
            return None
        part = MeshPlanePart(
            kind, field, tuple(skey for skey, _ in shard_segments),
            subs, [segments for _skey, segments in shard_segments],
            dev, n_slots)
        stacked = self._stack(part, hosts)
        part.nbytes = sum(int(a.nbytes) for a in stacked.values())
        part.per_device_bytes = part.nbytes
        from elasticsearch_tpu_torch.indices.breaker import (
            BREAKERS, charge_device,
        )
        label = f"mesh_plane_{kind}:{field}"
        charge = None
        try:
            charge = charge_device(part, part.per_device_bytes, label,
                                   return_charge=True)
        except CircuitBreakingError:
            device_limit = BREAKERS.breaker("device").limit
            if 0 < device_limit < part.per_device_bytes:
                self._refuse(key)
                return None
            while self._parts:
                self._drop(next(iter(self._parts)),
                           cause="breaker_pressure")
                try:
                    charge = charge_device(part, part.per_device_bytes,
                                           label, return_charge=True)
                    break
                except CircuitBreakingError:
                    continue
            if charge is None:
                self._refuse(key)
                return None
        part._charges.append(charge)
        self._upload(part, stacked)
        self.stats["mesh_plane_builds"] += 1
        part.generation = self._gen
        part.built_at = time.monotonic()
        self._gen += 1
        if prev is not None:
            self.stats["mesh_plane_incremental_appends"] += 1
        else:
            self.stats["mesh_plane_full_rebuilds"] += 1
        self._parts[key] = part
        self.hbm_high_water = max(
            self.hbm_high_water,
            sum(p.nbytes for p in self._parts.values()))
        while len(self._parts) > self.MAX_PARTS:
            self._drop(next(iter(self._parts)), cause="lru")
        return part

    # -- stacking -------------------------------------------------------

    def _stack(self, part: MeshPlanePart, hosts) -> Dict[str, np.ndarray]:
        """Stack per-shard host planes into common-shaped [n_slots, ...]
        arrays (empty/padding slots score nothing: -1 block docs, zero
        lengths and weights, live False; zero vector rows, exists False).
        Vector planes of mixed dims or similarity raise
        PlaneUnavailable."""
        subs = part.subs
        n_slots = part.n_slots
        n_max = max((s.n_docs_pad for s in subs if s is not None),
                    default=BLOCK)
        part.n_docs_pad = n_max
        part.n_segs_max = max(
            (len(s.segments) for s in subs if s is not None), default=1)
        part.n_segs_max = max(part.n_segs_max, 1)
        if part.kind == "vectors":
            dims = {s.dims for s in subs if s is not None}
            sims = {s.similarity for s in subs if s is not None}
            if len(dims) != 1 or len(sims) != 1:
                raise PlaneUnavailable(part.field)
            part.dims = dims.pop()
            part.similarity = sims.pop()
            matrix = np.zeros((n_slots, n_max, part.dims), np.float32)
            norms = np.zeros((n_slots, n_max), np.float32)
            exists = np.zeros((n_slots, n_max), bool)
            for i, h in enumerate(hosts):
                if h is None:
                    continue
                hm, hn, he = h
                matrix[i, : hm.shape[0]] = hm
                norms[i, : len(hn)] = hn
                exists[i, : len(he)] = he
            return {"matrix": matrix, "norms": norms, "exists": exists}
        nb_max = max(h[0].shape[0] for h in hosts if h is not None)
        nb_max = next_pow2(max(nb_max, 1))
        if part.kind == "features":
            bd = np.full((n_slots, nb_max, BLOCK), -1, np.int32)
            bw = np.zeros((n_slots, nb_max, BLOCK), np.float32)
            for i, h in enumerate(hosts):
                if h is None:
                    continue
                hbd, hbw = h
                bd[i, : hbd.shape[0]] = hbd
                bw[i, : hbw.shape[0]] = hbw
            return {"block_docs": bd, "block_weights": bw}
        bd = np.full((n_slots, nb_max, BLOCK), -1, np.int32)
        bt = np.zeros((n_slots, nb_max, BLOCK), np.float32)
        dl = np.zeros((n_slots, n_max), np.float32)
        si = np.zeros((n_slots, n_max), np.int32)
        for i, h in enumerate(hosts):
            if h is None:
                continue
            hbd, hbt, hdl = h
            bd[i, : hbd.shape[0]] = hbd
            bt[i, : hbt.shape[0]] = hbt
            dl[i, : len(hdl)] = hdl
            sub = subs[i]
            si[i] = _seg_ids_host(sub.doc_base, len(sub.segments), n_max)
        return {"block_docs": bd, "block_tfs": bt, "doc_lens": dl,
                "seg_ids": si}

    def _upload(self, part: MeshPlanePart, stacked) -> None:
        for name, arr in stacked.items():
            setattr(part, name, torch.as_tensor(arr, device=part.device))

    # -- eviction / lifecycle -------------------------------------------

    def _drop(self, key: Tuple, count_eviction: bool = True,
              cause: str = "lru") -> None:
        part = self._parts.pop(key, None)
        if part is None:
            return
        part.release()
        self.evictions_by_cause[cause] = \
            self.evictions_by_cause.get(cause, 0) + 1
        if count_eviction:
            self.stats["mesh_plane_evictions"] += 1

    def drop_segments(self, uids) -> None:
        """Merge invalidation: any mesh plane touching a merged-away
        segment can never be requested again (the uid tuple changed)."""
        uids = set(uids)
        for key in [k for k, p in self._parts.items()
                    if any(uids.intersection(
                        s.uid for s in segs)
                        for segs in p.segments_by_shard)]:
            self._drop(key, count_eviction=False,
                       cause="merge_invalidated")

    def clear(self) -> None:
        for key in list(self._parts):
            self._drop(key, count_eviction=False, cause="clear")
        self._refused.clear()
        self._cfg_version = object()   # force a settings re-read

    def on_refresh(self, shard_key, segments) -> None:
        """Refresh publication for one member shard: eagerly re-pack any
        resident mesh plane containing it whose recorded uid tuple for
        that shard is a strict prefix of the new one (the append-only
        case), so the refresh pays the upload instead of the next
        fan-out. Other member shards keep their last-published sets —
        their own refreshes publish independently."""
        if not self.enabled:
            return
        uids = tuple(s.uid for s in segments)
        todo = []
        for part in list(self._parts.values()):
            if shard_key not in part.shard_keys:
                continue
            prev_uids = part.uids_of(shard_key)
            if prev_uids != uids and \
                    uids[: len(prev_uids)] == prev_uids:
                todo.append(part)
        for part in todo:
            shard_segments = []
            for i, skey in enumerate(part.shard_keys):
                segs = list(segments) if skey == shard_key \
                    else list(part.segments_by_shard[i])
                shard_segments.append((skey, segs))
            self.get(shard_segments, part.kind, part.field, part.device)

    def stats_snapshot(self) -> Dict[str, Any]:
        by_kind = {"postings": 0, "vectors": 0, "features": 0,
                   "columns": 0}
        per_device = 0
        for p in self._parts.values():
            by_kind[p.kind] = by_kind.get(p.kind, 0) + p.nbytes
            per_device += p.per_device_bytes
        out = {**self.stats,
               "mesh_planes_resident": len(self._parts),
               "resident_bytes": by_kind,
               "resident_bytes_per_device": per_device,
               "dp": int(self.dp)}
        if self.hosts is not None:
            out["hosts"] = {"n_hosts": int(self.hosts.n_hosts),
                            "devices_per_host":
                                int(self.hosts.devices_per_host),
                            "spec": self.hosts.spec}
        if torch.cuda.is_initialized():
            out["n_devices"] = torch.cuda.device_count()
        return out

    def residency_snapshot(self) -> Dict[str, Any]:
        """PlaneRegistry.residency_snapshot's mesh counterpart; entries
        carry the slot count and per-device share too."""
        now = time.monotonic()
        total = 0
        planes = []
        for p in self._parts.values():
            total += p.nbytes
            planes.append({
                "kind": p.kind, "field": p.field,
                "bytes": int(p.nbytes),
                "bytes_per_device": int(p.per_device_bytes),
                "n_shards": int(p.n_shards),
                "generation": int(getattr(p, "generation", 0)),
                "age_s": round(now - getattr(p, "built_at", now), 3),
            })
        planes.sort(key=lambda e: -e["age_s"])
        self.hbm_high_water = max(self.hbm_high_water, total)
        return {
            "resident_bytes_total": total,
            "high_water_bytes": int(self.hbm_high_water),
            "generations_built": int(self._gen),
            "planes": planes,
            "evictions_by_cause": dict(
                sorted(self.evictions_by_cause.items())),
        }


# the mesh plane shares the process-global residency reasoning of PLANES
MESH_PLANES = MeshPlaneRegistry()
