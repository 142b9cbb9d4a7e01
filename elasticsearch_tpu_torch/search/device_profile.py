"""Launch accounting for the kernel wrappers.

Every kernel wrapper under ``ops/`` and ``parallel/`` reports each call
here, by family (``KERNEL_FAMILIES``: ``bm25_flat``, ``bm25_flat_seg``,
``bm25_coarse``, ``bm25_rerank``, ``bm25_scores`` in ``ops/bm25.py``; ``knn_flat``,
``knn_coarse``, ``knn_rerank``, ``knn_scores`` in ``ops/knn.py``;
``dense_topk`` in ``ops/topk.py``; ``ivf_assign``, ``ivf_update``,
``ivf_init``, ``ivf_search`` in ``ops/ivf.py``; ``sparse_flat``,
``sparse_scores``, ``sparse_coarse``, ``sparse_rerank`` in
``ops/sparse.py``; ``text_expansion_forward`` in
``ml/text_expansion.py``; ``aggs_ordinal_counts``, ``aggs_histogram``,
``aggs_ordinal_counts_plane``, ``aggs_histogram_plane`` in
``ops/aggs.py``; ``rrf_fuse``, ``rrf_fuse_batch`` and ``linear_fuse`` in
``ops/fusion.py``; ``mesh_bm25_flat``, ``mesh_bm25_coarse``,
``mesh_bm25_rerank``, ``mesh_knn_topk``, ``mesh_knn_coarse``,
``mesh_knn_rerank``, ``mesh_sparse_topk``, ``mesh_sparse_coarse`` and
``mesh_sparse_rerank`` in ``parallel/mesh.py``; ``sharded_knn``,
``sharded_bm25``, ``sharded_bm25_batch``, ``sharded_sparse`` and
``sharded_hybrid`` in ``parallel/sharded_search.py`` -- 40 families -- the mesh
kNN families
counting masked and unmasked launches together, as the JAX package
does, with ``/masked`` ending a masked call's shape label), and the
launches of K5-K7 with a per-query mask stack apart from the others, as
``MASKED_VARIANTS``:

- ``launches``: how many times the wrapper launched its CUDA kernel. A
  call on CPU tensors runs the plain PyTorch version and is not a launch.
  ``chip_smoke.py`` zeroes the counts, drives the main path and requires
  every family of the path to have launched.
- ``calls``: every wrapper call, on either device; each is one device
  program of the request and is reported to the active request's trace
  through ``telemetry.record_dispatch``.
- shape buckets: the call shapes seen, with their counts.
- optional CUDA-event times (``DEVICE_PROFILE.timing = True``): a pair of
  events around each launch, resolved to milliseconds when read. Off by
  default, because reading an event pair waits for the card.

Eager PyTorch compiles nothing, so unlike the JAX package's profiled-jit
wrapper there is no compile tracking here.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, Tuple

from elasticsearch_tpu_torch.search import telemetry

# every kernel family, one per csrc/<family>.cu
KERNEL_FAMILIES = ("bm25_flat", "bm25_flat_seg", "bm25_coarse", "bm25_rerank",
                   "knn_flat", "knn_coarse", "knn_rerank", "bm25_scores",
                   "knn_scores", "dense_topk", "ivf_assign", "ivf_update",
                   "ivf_init", "ivf_search", "sparse_flat", "sparse_scores",
                   "sparse_coarse", "sparse_rerank", "text_expansion_forward",
                   "aggs_ordinal_counts", "aggs_histogram",
                   "aggs_ordinal_counts_plane", "aggs_histogram_plane",
                   "rrf_fuse", "rrf_fuse_batch", "linear_fuse",
                   "mesh_bm25_flat", "mesh_bm25_coarse", "mesh_bm25_rerank",
                   "mesh_knn_topk", "mesh_knn_coarse", "mesh_knn_rerank",
                   "mesh_sparse_topk", "mesh_sparse_coarse",
                   "mesh_sparse_rerank", "sharded_knn", "sharded_bm25",
                   "sharded_bm25_batch", "sharded_sparse", "sharded_hybrid")
# the masked launches of knn_flat / knn_coarse / knn_rerank (the same
# kernels with a [B, N_pad] filter-mask operand), counted under these names
MASKED_VARIANTS = ("knn_flat_masked", "knn_coarse_masked",
                   "knn_rerank_masked")
# per-family bound on the shape-bucket map (labels derive from shapes)
MAX_BUCKETS_PER_FAMILY = 256
# per-family bound on unresolved CUDA-event pairs
MAX_PENDING_EVENTS = 4096


class FamilyProfile:
    """One kernel family's record."""

    __slots__ = ("name", "launches", "calls", "shapes", "_pending",
                 "event_ms", "event_count")

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.calls = 0
        self.shapes: Dict[str, int] = {}
        self._pending: List[Tuple[Any, Any]] = []
        self.event_ms = 0.0         # summed over the timed launches
        self.event_count = 0

    def resolve_events(self) -> float:
        """Device milliseconds summed over every timed launch so far
        (waits for the recorded events to complete)."""
        for start, end in self._pending:
            end.synchronize()
            self.event_ms += float(start.elapsed_time(end))
            self.event_count += 1
        self._pending.clear()
        return self.event_ms


class DeviceProfile:
    """Process-global launch registry (one card per process)."""

    def __init__(self):
        self._families: Dict[str, FamilyProfile] = {}
        self.timing = False

    def configure_from_state(self, state) -> None:
        """The JAX package reads its recompile-storm and slow-compile
        knobs (``search.device_profile.*``) here. Eager PyTorch compiles
        nothing, so there is nothing for them to watch; the node's
        settings refresh calls this all the same."""

    def family(self, name: str) -> FamilyProfile:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = FamilyProfile(name)
        return fam

    @contextmanager
    def call(self, family: str, label: str, launch: bool):
        """Wrap one wrapper call: ``launch`` is True when it launches the
        CUDA kernel (False for the plain version on CPU tensors)."""
        fam = self.family(family)
        fam.calls += 1
        fam.shapes[label] = fam.shapes.get(label, 0) + 1
        while len(fam.shapes) > MAX_BUCKETS_PER_FAMILY:
            fam.shapes.pop(next(iter(fam.shapes)))
        telemetry.record_dispatch()
        if not (launch and self.timing):
            yield
            if launch:
                fam.launches += 1
            return
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        fam.launches += 1
        fam._pending.append((start, end))
        if len(fam._pending) > MAX_PENDING_EVENTS:
            fam.resolve_events()

    def launches(self) -> Dict[str, int]:
        return {name: fam.launches
                for name, fam in sorted(self._families.items())}

    def reset_launches(self) -> None:
        for fam in self._families.values():
            fam.launches = 0

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, fam in sorted(self._families.items()):
            entry: Dict[str, Any] = {
                "launches": fam.launches, "calls": fam.calls,
                "shape_buckets": len(fam.shapes)}
            if fam.resolve_events():
                entry["event_ms_total"] = round(fam.event_ms, 4)
                entry["event_ms_count"] = fam.event_count
            out[name] = entry
        return {"families": out}

    def reset(self) -> None:
        self._families.clear()


DEVICE_PROFILE = DeviceProfile()
