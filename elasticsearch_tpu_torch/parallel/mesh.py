"""The JAX package's ``parallel/mesh.py``: the mesh layout and the
mesh-sharded plane's kernels.

The host half: the multi-host topology (``search.mesh.hosts``), the
process's host backend registry, the readiness probe and the device
layout of the mesh-sharded plane -- the pieces the node spine calls
(``action/search_action.py``, ``search/mesh_executor.py``,
``testing.py``).

The device half is the text, kNN and sparse kinds' nine programs, each
the single-shard body of an already-ported kernel run for every slot (one
shard of a co-located fan-out) in ONE launch over the stacked planes
(``ops/device_segment.py`` ``MeshPlanePart``):

- ``mesh_bm25_flat`` (``csrc/mesh_bm25_flat.cu``): K2 per (slot, dp row);
- ``mesh_bm25_coarse`` (``csrc/mesh_bm25_coarse.cu``): K3 per slot;
- ``mesh_bm25_rerank`` (``csrc/mesh_bm25_rerank.cu``): K4 per slot;
- ``mesh_knn_topk`` (``csrc/mesh_knn_topk.cu``): K5 per slot;
- ``mesh_knn_coarse`` (``csrc/mesh_knn_coarse.cu``): K6 per slot;
- ``mesh_knn_rerank`` (``csrc/mesh_knn_rerank.cu``): K7 per slot;
- ``mesh_sparse_topk`` (``csrc/mesh_sparse_topk.cu``): K15 per (slot, dp
  row);
- ``mesh_sparse_coarse`` (``csrc/mesh_sparse_coarse.cu``): K16 per slot;
- ``mesh_sparse_rerank`` (``csrc/mesh_sparse_rerank.cu``): K17 per slot;

the kNN three with or without a per-query filter-mask stack (one family
each, as in the JAX package; a masked call's shape label ends in
``/masked``).

Each has a plain PyTorch version beside it, which runs the one-shard plain
version slot by slot; a wrapper takes it only for CPU tensors, and on a
CUDA tensor launches its kernel or raises. The 64-bit fixed-point sums of
the text and sparse kinds, and the kNN kind's per-pair sums in dimension
order (exact int32 sums in the coarse pass), make every slot's output
bitwise the one-shard kernel's on that slot's plane.

The port lays the whole mesh on the node's own device -- a grid of one:
the JAX package's ``shard`` axis becomes the kernels' leading slot axis,
and its ``dp`` axis caps at that one device (``make_mesh`` builds the
slot layout as an object for the sharded data plane,
``parallel/sharded_search.py``). A mesh across several cards is not
ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from elasticsearch_tpu_torch.device import DeviceLike
from elasticsearch_tpu_torch.ops.bm25 import (
    BLOCK_WIDTH, COUNT_SEGS, DEFAULT_B, DEFAULT_K1, KMAX, MAX_SEGS, _check,
    _consts, _on_cuda, _ptr, _stream, bm25_coarse_plain, bm25_flat_seg_plain,
    bm25_rerank_plain, launch_kernel, probe_tiles, tiles_launch,
)
from elasticsearch_tpu_torch.ops.knn import (
    MAX_DIMS, _check_query_terms, _opt_ptr, _sim_code, full_counter,
    knn_coarse_plain, knn_flat_plain, knn_rerank_plain, scratch_bytes,
    split_buffer, split_of,
)
from elasticsearch_tpu_torch.ops.sparse import (
    MAX_QUERIES, features_launch, sparse_coarse_plain, sparse_flat_plain,
    sparse_rerank_plain,
)
from elasticsearch_tpu_torch.search.device_profile import DEVICE_PROFILE


class HostTopology:
    """N hosts x M devices per host — the ``num_nodes`` /
    ``gpus_per_node`` shape multi-process SPMD deployments pin
    explicitly. Hosts partition the device axis CONTIGUOUSLY (device d
    lives on host d // devices_per_host), the standard process-major
    device order of multi-process SPMD runtimes, so a ``(dp, shard)`` mesh over
    the first ``dp*d_used`` devices spans hosts 0..ceil(dp*d_used/M)-1
    and each plane slot has a well-defined serving host."""

    __slots__ = ("n_hosts", "devices_per_host", "spec")

    def __init__(self, n_hosts: int, devices_per_host: int,
                 spec: str = ""):
        self.n_hosts = int(n_hosts)
        self.devices_per_host = int(devices_per_host)
        self.spec = spec or f"{n_hosts}x{devices_per_host}"

    @property
    def n_devices(self) -> int:
        return self.n_hosts * self.devices_per_host

    def host_of_device(self, device_index: int) -> int:
        return min(device_index // self.devices_per_host,
                   self.n_hosts - 1)

    def __eq__(self, other) -> bool:
        return (isinstance(other, HostTopology)
                and self.n_hosts == other.n_hosts
                and self.devices_per_host == other.devices_per_host)

    def __hash__(self) -> int:
        return hash((self.n_hosts, self.devices_per_host))

    def __repr__(self) -> str:
        return (f"HostTopology({self.n_hosts}x{self.devices_per_host},"
                f" spec={self.spec!r})")


def parse_host_topology(spec: str, total: Optional[int] = None
                        ) -> Optional[HostTopology]:
    """``search.mesh.hosts`` -> HostTopology. "" = single-host (None);
    "N" = N equal hosts over the visible devices; "NxM" = N hosts x M
    devices per host. Raises ValueError when the spec asks for more
    devices than the backend exposes — a misdeclared fleet must fail
    loudly at configure time, not mis-shard at dispatch time."""
    spec = (spec or "").strip()
    if not spec:
        return None
    if total is None:
        total = torch.cuda.device_count()
    if "x" in spec:
        hosts_s, _, per_s = spec.partition("x")
        n_hosts, per = int(hosts_s), int(per_s)
    else:
        n_hosts, per = int(spec), 0
    if n_hosts < 1:
        raise ValueError(
            f"search.mesh.hosts [{spec}]: host count must be >= 1")
    if per == 0:
        if n_hosts > total:
            raise ValueError(
                f"search.mesh.hosts [{spec}]: {n_hosts} hosts over "
                f"{total} visible devices")
        per = total // n_hosts
    if per < 1 or n_hosts * per > total:
        raise ValueError(
            f"search.mesh.hosts [{spec}]: {n_hosts}x{per} devices "
            f"exceed the {total} visible")
    return HostTopology(n_hosts, per, spec)


def mesh_member_hosts(topo: HostTopology, dp: int, d_used: int
                      ) -> Tuple[int, ...]:
    """Hosts whose devices participate in a (dp, d_used) mesh — the
    membership the executor's liveness checks (and the typed
    ``mesh_host_lost`` fallback) are defined over."""
    return tuple(sorted({topo.host_of_device(d)
                         for d in range(dp * d_used)}))


def slot_host(topo: HostTopology, slot: int, slots_per_device: int,
              ) -> int:
    """Primary host serving a plane slot: slots partition contiguously
    over the shard-axis device columns, and dp row 0 of column j is
    global device j."""
    return topo.host_of_device(slot // max(1, slots_per_device))


# The process's host-partition backend: maps cluster nodes onto virtual
# (or real) mesh hosts and answers liveness. Duck-typed protocol —
# ``topology`` (HostTopology), ``host_of_node(node_id)``,
# ``host_alive(host)``, ``nodes_on_host(host)``, ``indices_of(node_id)``
# (the member's IndicesService, for the single-process stand-in where
# one process holds every host's devices), ``pressure_snapshot(node_id)``.
# testing.VirtualHostBackend registers here; a real multi-process
# runtime would install its own.
_HOST_BACKEND = None


def set_host_backend(backend) -> None:
    global _HOST_BACKEND
    _HOST_BACKEND = backend


def host_backend():
    return _HOST_BACKEND


def _mesh_device(device: DeviceLike) -> torch.device:
    """The device a mesh runs on, without initializing anything."""
    return torch.device("cuda" if device is None else device)


def mesh_ready(device: DeviceLike = None) -> bool:
    """True when the mesh on ``device`` can serve without paying device
    first-init inside a search: always for the CPU (its backend has
    nothing to initialize), and on the card only when CUDA is ALREADY
    initialized in this process (the same never-pay guard as
    ``monitor.device_stats``)."""
    if _mesh_device(device).type == "cpu":
        return True
    return bool(torch.cuda.is_initialized())


class Mesh:
    """The sharded data plane's layout: S slots on one device, the JAX
    package's ``jax.sharding.Mesh`` as a host object. ``n_slots`` is the
    kernels' leading slot axis and ``device`` holds every slot, so the
    all-gather over ``shard`` is a reshape of the ``[S, ...]`` winners.
    The JAX package's ``dp`` axis only copies the index to split a query
    batch over devices; one device gains nothing from that, so the layout
    has no such axis (the answers do not depend on it)."""

    def __init__(self, n_slots: int, device: DeviceLike = None):
        if int(n_slots) < 1:
            raise ValueError(f"a mesh needs at least one slot, not {n_slots}")
        self.n_slots = int(n_slots)
        self.device = _mesh_device(device)

    def __repr__(self) -> str:
        return f"Mesh(n_slots={self.n_slots}, device={self.device})"


def make_mesh(n_slots: int, device: DeviceLike = None) -> Mesh:
    """S = ``n_slots`` slots on ``device`` (None: the card)."""
    return Mesh(n_slots, device)


def mesh_layout(n_shards: int, device: DeviceLike = None
                ) -> Tuple[List[List[torch.device]], int, int]:
    """(device grid, n_slots, slots_per_device) for ``n_shards``
    mesh-served shards.

    One shard = one slot of the stacked plane. The JAX package maps slots
    onto a ``(dp, shard)`` mesh over a device subset sized to the shard
    count, padding the slot count up to a multiple of the used devices.
    The port runs every slot on the node's own device, so the subset is
    that one device: the grid is ``[[device]]`` (``search.mesh.dp`` caps
    at 1) and ``n_slots`` equals ``n_shards``."""
    return [[_mesh_device(device)]], n_shards, n_shards


# ---------------------------------------------------------------------------
# mesh-sharded plane kernels (one slot = one shard's packed plane)
# ---------------------------------------------------------------------------

_SIG = {
    "mesh_bm25_rerank": ["p"] * 10 + ["i", "ll", "i", "ll", "i", "i", "i"]
    + ["f"] * 4 + ["p"] * 7,
    "mesh_knn_topk": ["p"] * 7 + ["i", "i", "i", "ll", "i", "i"]
    + ["p"] * 7,
    "mesh_knn_coarse": ["p"] * 9 + ["i", "i", "i", "ll", "i", "i"]
    + ["p"] * 6,
    "mesh_knn_rerank": ["p"] * 9 + ["i", "i", "ll", "i", "i", "i", "i"]
    + ["p"] * 4,
    "mesh_sparse_rerank": ["p"] * 7 + ["i", "ll", "i", "ll", "i", "i", "i"]
    + ["p"] * 7,
}


def _check_stack(block_docs, block_tfs, doc_lens, live, seg_ids,
                 n_docs_pad: int, tf_dtype, dl_dtype) -> Tuple[int, int]:
    """(n_slots, nb) of a stacked postings plane, checked."""
    if block_docs.dim() != 3 or block_docs.shape[2] != BLOCK_WIDTH:
        raise ValueError(f"[block_docs] must be [S, NB, {BLOCK_WIDTH}]")
    s, nb = int(block_docs.shape[0]), int(block_docs.shape[1])
    _check("block_docs", block_docs, torch.int32, (s, nb, BLOCK_WIDTH))
    _check("block_tfs", block_tfs, tf_dtype, (s, nb, BLOCK_WIDTH))
    _check("doc_lens", doc_lens, dl_dtype, (s, n_docs_pad))
    _check("live", live, torch.bool, (s, n_docs_pad))
    if seg_ids is not None:
        _check("seg_ids", seg_ids, torch.int32, (s, n_docs_pad))
    return s, nb


def _check_flats(lead, flat_idx, flat_w, flat_q, flat_avgdl) -> int:
    """FB of flat operands shaped ``lead + (FB,)``, checked."""
    fb = int(flat_idx.shape[-1])
    shape = tuple(lead) + (fb,)
    _check("flat_idx", flat_idx, torch.int32, shape)
    _check("flat_w", flat_w, torch.float32, shape)
    _check("flat_q", flat_q, torch.int32, shape)
    _check("flat_avgdl", flat_avgdl, torch.float32, shape)
    return fb


def _label(s: int, fb: int, n_docs_pad: int, n_q: int, k: int) -> str:
    return f"s={s}/fb={fb}/n_docs_pad={n_docs_pad}/n_q={n_q}/k={k}"


def mesh_bm25_flat_plain(block_docs, block_tfs, doc_lens, flat_idx, flat_w,
                         flat_q, flat_avgdl, live, seg_ids, n_docs_pad: int,
                         n_q: int, k: int, n_segs: int,
                         k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    """``bm25_flat_seg_plain`` for every (slot, dp row), stacked."""
    s_all, d_all, h_all = [], [], []
    for si in range(block_docs.shape[0]):
        rows = [bm25_flat_seg_plain(
            block_docs[si], block_tfs[si], flat_idx[si, r], flat_w[si, r],
            flat_q[si, r], doc_lens[si], flat_avgdl[si, r], live[si],
            seg_ids[si], n_docs_pad, n_q, k, k1=k1, b=b, n_segs=n_segs)
            for r in range(flat_idx.shape[1])]
        s_all.append(torch.stack([x[0] for x in rows]))
        d_all.append(torch.stack([x[1] for x in rows]))
        h_all.append(torch.stack([x[2] for x in rows]))
    return torch.stack(s_all), torch.stack(d_all), torch.stack(h_all)


def mesh_bm25_coarse_plain(block_docs, block_tfs_q, doc_lens_q, flat_idx,
                           flat_w, flat_q, flat_avgdl, live, seg_ids,
                           n_docs_pad: int, n_q: int, kprime: int,
                           n_segs: int, k1: float = DEFAULT_K1,
                           b: float = DEFAULT_B):
    """``bm25_coarse_plain`` for every slot, stacked."""
    outs = [bm25_coarse_plain(
        block_docs[si], block_tfs_q[si], flat_idx[si], flat_w[si],
        flat_q[si], doc_lens_q[si], flat_avgdl[si], live[si], seg_ids[si],
        n_docs_pad, n_q, n_segs, kprime, k1=k1, b=b)
        for si in range(block_docs.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def mesh_bm25_rerank_plain(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                           flat_avgdl, doc_lens, live, cand, coarse_s,
                           n_docs_pad: int, n_q: int, kprime: int, k: int,
                           k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    """``bm25_rerank_plain`` for every slot, stacked."""
    outs = [bm25_rerank_plain(
        block_docs[si], block_tfs[si], flat_idx[si], flat_w[si],
        flat_q[si], doc_lens[si], flat_avgdl[si], live[si], cand[si],
        coarse_s[si], n_docs_pad, n_q, kprime, k, k1=k1, b=b)
        for si in range(block_docs.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def mesh_bm25_flat(block_docs, block_tfs, doc_lens, flat_idx, flat_w,
                   flat_q, flat_avgdl, live, seg_ids, n_docs_pad: int,
                   n_q: int, k: int, n_segs: int, k1: float = DEFAULT_K1,
                   b: float = DEFAULT_B):
    """Row 31. The exact flat BM25 top-k of every (slot, dp row) of the
    stacked postings planes in one launch: block_docs / block_tfs
    [S, NB, 128], doc_lens / live / seg_ids [S, N], flat operands
    [S, DP, FB] (each dp row's query ids local to its ``n_q`` queries).
    Returns (scores [S, DP, n_q, k] f32, plane docs [S, DP, n_q, k] int32,
    hits [S, DP, n_q, n_segs] int32); each (slot, row) is ``bm25_flat_seg``
    on that slot's plane."""
    cuda = _on_cuda(block_docs, block_tfs, doc_lens, flat_idx, flat_w,
                    flat_q, flat_avgdl, live, seg_ids)
    s, _nb = _check_stack(block_docs, block_tfs, doc_lens, live, seg_ids,
                          n_docs_pad, torch.float32, torch.float32)
    if flat_idx.dim() != 3 or flat_idx.shape[0] != s:
        raise ValueError(f"[flat_idx] must be [{s}, DP, FB]")
    dp = int(flat_idx.shape[1])
    fb = _check_flats((s, dp), flat_idx, flat_w, flat_q, flat_avgdl)
    with DEVICE_PROFILE.call("mesh_bm25_flat",
                             _label(s, fb, n_docs_pad, n_q, k), cuda):
        if not cuda:
            return mesh_bm25_flat_plain(
                block_docs, block_tfs, doc_lens, flat_idx, flat_w, flat_q,
                flat_avgdl, live, seg_ids, n_docs_pad, n_q, k, n_segs,
                k1=k1, b=b)
        return _mesh_bm25_flat_cuda(block_docs, block_tfs, doc_lens,
                                    flat_idx, flat_w, flat_q, flat_avgdl,
                                    live, seg_ids, n_docs_pad, n_q, k,
                                    n_segs, k1, b)


def _mesh_bm25_flat_cuda(block_docs, block_tfs, doc_lens, flat_idx, flat_w,
                         flat_q, flat_avgdl, live, seg_ids, n_docs_pad, n_q,
                         k, n_segs, k1, b, probe=None):
    if not 1 <= k <= n_docs_pad:
        raise ValueError(f"k={k} outside [1, {n_docs_pad}]")
    if not 1 <= n_segs <= MAX_SEGS:
        raise ValueError(f"n_segs={n_segs} outside [1, {MAX_SEGS}]")
    s, dp = int(flat_idx.shape[0]), int(flat_idx.shape[1])
    dev = block_docs.device
    out_s = torch.empty(s, dp, n_q, k, dtype=torch.float32, device=dev)
    out_d = torch.empty(s, dp, n_q, k, dtype=torch.int32, device=dev)
    hits = torch.empty(s, dp, n_q, n_segs, dtype=torch.int32, device=dev)
    tiles_launch("mesh_bm25_flat", block_docs, block_tfs, doc_lens,
                 flat_idx, flat_w, flat_q, flat_avgdl, live, seg_ids,
                 groups=s * dp, groups_per_slot=dp, n_docs_pad=n_docs_pad,
                 n_q=n_q, k=k, mode=COUNT_SEGS, n_segs=n_segs,
                 consts=_consts(k1, b), out_s=out_s, out_d=out_d,
                 hits=hits, probe=probe)
    return out_s, out_d, hits


def mesh_bm25_coarse(block_docs, block_tfs_q, doc_lens_q, flat_idx, flat_w,
                     flat_q, flat_avgdl, live, seg_ids, n_docs_pad: int,
                     n_q: int, kprime: int, n_segs: int,
                     k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    """Row 32. The quantized coarse tier of every slot in one launch:
    block_tfs_q [S, NB, 128] and doc_lens_q [S, N] bf16, flat operands
    [S, FB]. Returns (coarse scores [S, n_q, k'] f32, candidates
    [S, n_q, k'] int32, exact per-segment counts [S, n_q, n_segs] int32);
    each slot is ``bm25_coarse`` on that slot's mirrors."""
    cuda = _on_cuda(block_docs, block_tfs_q, doc_lens_q, flat_idx, flat_w,
                    flat_q, flat_avgdl, live, seg_ids)
    s, _nb = _check_stack(block_docs, block_tfs_q, doc_lens_q, live,
                          seg_ids, n_docs_pad, torch.bfloat16,
                          torch.bfloat16)
    fb = _check_flats((s,), flat_idx, flat_w, flat_q, flat_avgdl)
    with DEVICE_PROFILE.call("mesh_bm25_coarse",
                             _label(s, fb, n_docs_pad, n_q, kprime), cuda):
        if not cuda:
            return mesh_bm25_coarse_plain(
                block_docs, block_tfs_q, doc_lens_q, flat_idx, flat_w,
                flat_q, flat_avgdl, live, seg_ids, n_docs_pad, n_q, kprime,
                n_segs, k1=k1, b=b)
        return _mesh_bm25_coarse_cuda(block_docs, block_tfs_q, doc_lens_q,
                                      flat_idx, flat_w, flat_q, flat_avgdl,
                                      live, seg_ids, n_docs_pad, n_q, kprime,
                                      n_segs, k1, b)


def _mesh_bm25_coarse_cuda(block_docs, block_tfs_q, doc_lens_q, flat_idx,
                           flat_w, flat_q, flat_avgdl, live, seg_ids,
                           n_docs_pad, n_q, kprime, n_segs, k1, b,
                           probe=None):
    if not 1 <= kprime <= min(KMAX, n_docs_pad):
        raise ValueError(
            f"kprime={kprime} outside [1, {min(KMAX, n_docs_pad)}]")
    if not 1 <= n_segs <= MAX_SEGS:
        raise ValueError(f"n_segs={n_segs} outside [1, {MAX_SEGS}]")
    s = int(flat_idx.shape[0])
    dev = block_docs.device
    cs = torch.empty(s, n_q, kprime, dtype=torch.float32, device=dev)
    cand = torch.empty(s, n_q, kprime, dtype=torch.int32, device=dev)
    hits = torch.empty(s, n_q, n_segs, dtype=torch.int32, device=dev)
    tiles_launch("mesh_bm25_coarse", block_docs, block_tfs_q, doc_lens_q,
                 flat_idx, flat_w, flat_q, flat_avgdl, live, seg_ids,
                 groups=s, groups_per_slot=1, n_docs_pad=n_docs_pad,
                 n_q=n_q, k=kprime, mode=COUNT_SEGS, n_segs=n_segs,
                 consts=_consts(k1, b, bf16=True), out_s=cs, out_d=cand,
                 hits=hits, probe=probe)
    return cs, cand, hits


def mesh_bm25_probe(family: str, *args, **kwargs) -> dict:
    """``ops/bm25.py`` ``probe_tiles`` for row 31 or row 32 by family
    name."""
    body = {"mesh_bm25_flat": _mesh_bm25_flat_cuda,
            "mesh_bm25_coarse": _mesh_bm25_coarse_cuda}[family]
    return probe_tiles(globals()[family], body, *args, **kwargs)


def mesh_bm25_rerank(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                     flat_avgdl, doc_lens, live, cand, coarse_s,
                     n_docs_pad: int, n_q: int, kprime: int, k: int,
                     k1: float = DEFAULT_K1, b: float = DEFAULT_B):
    """Row 33. The exact tier of every slot in one launch: f32 planes,
    flat operands [S, FB], candidates and coarse scores [S, n_q, k'].
    Returns (scores [S, n_q, k] f32, plane docs [S, n_q, k] int32,
    eps [S, n_q] f32); each slot is ``bm25_rerank`` on that slot's plane."""
    cuda = _on_cuda(block_docs, block_tfs, flat_idx, flat_w, flat_q,
                    flat_avgdl, doc_lens, live, cand, coarse_s)
    s, nb = _check_stack(block_docs, block_tfs, doc_lens, live, None,
                         n_docs_pad, torch.float32, torch.float32)
    fb = _check_flats((s,), flat_idx, flat_w, flat_q, flat_avgdl)
    _check("cand", cand, torch.int32, (s, n_q, kprime))
    _check("coarse_s", coarse_s, torch.float32, (s, n_q, kprime))
    with DEVICE_PROFILE.call("mesh_bm25_rerank",
                             _label(s, fb, n_docs_pad, n_q, kprime), cuda):
        if not cuda:
            return mesh_bm25_rerank_plain(
                block_docs, block_tfs, flat_idx, flat_w, flat_q, flat_avgdl,
                doc_lens, live, cand, coarse_s, n_docs_pad, n_q, kprime, k,
                k1=k1, b=b)
        if not 1 <= kprime <= KMAX or not 1 <= k <= kprime:
            raise ValueError(f"need 1 <= k={k} <= kprime={kprime} <= {KMAX}")
        dev = block_docs.device
        cand_s = torch.empty(s, n_q, kprime, dtype=torch.int32, device=dev)
        cs_s = torch.empty(s, n_q, kprime, dtype=torch.float32, device=dev)
        acc = torch.empty(s, n_q, kprime, dtype=torch.int64, device=dev)
        out_s = torch.empty(s, n_q, k, dtype=torch.float32, device=dev)
        out_d = torch.empty(s, n_q, k, dtype=torch.int32, device=dev)
        eps = torch.empty(s, n_q, dtype=torch.float32, device=dev)
        launch_kernel(
            "mesh_bm25_rerank", _SIG["mesh_bm25_rerank"], _ptr(block_docs),
            _ptr(block_tfs), _ptr(flat_idx), _ptr(flat_w), _ptr(flat_q),
            _ptr(flat_avgdl), _ptr(doc_lens), _ptr(live), _ptr(cand),
            _ptr(coarse_s), s, nb, fb, n_docs_pad, n_q, kprime, k,
            *_consts(k1, b), _ptr(cand_s), _ptr(cs_s), _ptr(acc),
            _ptr(out_s), _ptr(out_d), _ptr(eps), _stream())
        return out_s, out_d, eps


# ---------------------------------------------------------------------------
# the kNN kind: K5 / K6 / K7 per slot over the stacked vector planes
# ---------------------------------------------------------------------------

def _check_vector_stack(name: str, stack, dtype, norms, allowed
                        ) -> Tuple[int, int, int]:
    """(n_slots, n_docs_pad, dims) of a stacked vector plane, checked."""
    if stack.dim() != 3:
        raise ValueError(f"[{name}] must be [S, N_pad, D], got "
                         f"{tuple(stack.shape)}")
    s, n_pad, dims = (int(x) for x in stack.shape)
    _check(name, stack, dtype, (s, n_pad, dims))
    if not 1 <= dims <= MAX_DIMS:
        raise ValueError(f"[{name}] dims {dims} outside [1, {MAX_DIMS}]")
    if stack.data_ptr() % 4:    # the coarse pass reads int8 rows by words
        raise ValueError(f"[{name}] must be 4-byte aligned")
    _check("norms", norms, torch.float32, (s, n_pad))
    _check("allowed", allowed, torch.bool, (s, n_pad))
    return s, n_pad, dims


def _check_knn_queries(name: str, queries, dtype, dims: int) -> int:
    if queries.dim() != 2 or queries.shape[1] != dims:
        raise ValueError(f"[{name}] must be [Q, {dims}], got "
                         f"{tuple(queries.shape)}")
    _check(name, queries, dtype, tuple(queries.shape))
    return int(queries.shape[0])


def _check_mask_stack(masks, s: int, n_q: int, n_pad: int) -> None:
    if masks is not None:
        _check("masks", masks, torch.bool, (s, n_q, n_pad))


def _knn_label(s: int, n_pad: int, dims: int, n_q: int, k: int,
               masks) -> str:
    return (f"s={s}/n_docs_pad={n_pad}/dims={dims}/n_q={n_q}/k={k}"
            + ("" if masks is None else "/masked"))


def _slot(t, si: int):
    return None if t is None else t[si]


def mesh_knn_topk_plain(matrix, norms, allowed, queries, qn, q2, k: int,
                        similarity: str = "cosine", masks=None):
    """``knn_flat_plain`` for every slot, stacked."""
    outs = [knn_flat_plain(matrix[si], norms[si], allowed[si], queries, qn,
                           q2, k, similarity, _slot(masks, si))
            for si in range(matrix.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(2))


def mesh_knn_coarse_plain(q8, scales, norms, allowed, qq, qscale, qn, q2,
                          kprime: int, similarity: str = "cosine",
                          masks=None):
    """``knn_coarse_plain`` for every slot, stacked."""
    outs = [knn_coarse_plain(q8[si], scales[si], norms[si], allowed[si], qq,
                             qscale, qn, q2, kprime, similarity,
                             _slot(masks, si))
            for si in range(q8.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(2))


def mesh_knn_rerank_plain(matrix, norms, allowed, queries, qn, q2, cand,
                          coarse_s, k: int, similarity: str = "cosine",
                          masks=None):
    """``knn_rerank_plain`` for every slot, stacked."""
    outs = [knn_rerank_plain(matrix[si], norms[si], allowed[si], queries, qn,
                             q2, cand[si], coarse_s[si], k, similarity,
                             _slot(masks, si))
            for si in range(matrix.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def _mesh_flat_shape(matrix, norms, allowed, queries, qn, q2, k,
                     similarity, masks):
    _sim_code(similarity)
    cuda = _on_cuda(matrix, norms, allowed, queries, qn, q2,
                    *([] if masks is None else [masks]))
    s, n_pad, dims = _check_vector_stack("matrix", matrix, torch.float32,
                                         norms, allowed)
    n_q = _check_knn_queries("queries", queries, torch.float32, dims)
    _check_query_terms(qn, q2, n_q)
    _check_mask_stack(masks, s, n_q, n_pad)
    if not 1 <= k <= n_pad:
        raise ValueError(f"k={k} outside [1, {n_pad}]")
    return cuda, s, n_pad, dims, n_q


def _mesh_flat_launch(matrix, norms, allowed, queries, qn, q2, k,
                      similarity, masks, s, n_pad, dims, n_q, full,
                      probe=None, split_addr=0):
    dev = matrix.device
    scratch = torch.empty(
        scratch_bytes("mesh_knn_topk", s, n_q, dims, n_pad, k),
        dtype=torch.uint8, device=dev)
    out_s = torch.empty(s, n_q, k, dtype=torch.float32, device=dev)
    out_d = torch.empty(s, n_q, k, dtype=torch.int32, device=dev)
    launch_kernel(
        "mesh_knn_topk", _SIG["mesh_knn_topk"], _ptr(matrix), _ptr(norms),
        _ptr(allowed), _opt_ptr(masks), _ptr(queries), _ptr(qn), _ptr(q2),
        s, n_q, dims, n_pad, k, _sim_code(similarity), _ptr(scratch),
        _ptr(full), _ptr(out_s), _ptr(out_d), _opt_ptr(probe), split_addr,
        _stream())
    return out_s, out_d


def mesh_knn_topk(matrix, norms, allowed, queries, qn, q2, k: int,
                  similarity: str = "cosine", masks=None):
    """Row 39. The exact kNN top-k of every slot of the stacked vector
    planes in one launch: matrix [S, N_pad, D] f32, norms / allowed
    [S, N_pad], queries [Q, D] f32 with their ``qn`` / ``q2`` [Q], and,
    when given, per-query filter rows ``masks`` [S, Q, N_pad] bool. Returns
    (scores [S, Q, k] f32, plane docs [S, Q, k] int32); each slot is
    ``knn_flat`` (K5) on that slot's plane. Any 1 <= k <= N_pad."""
    cuda, s, n_pad, dims, n_q = _mesh_flat_shape(matrix, norms, allowed,
                                                 queries, qn, q2, k,
                                                 similarity, masks)
    with DEVICE_PROFILE.call("mesh_knn_topk",
                             _knn_label(s, n_pad, dims, n_q, k, masks),
                             cuda):
        if not cuda:
            return mesh_knn_topk_plain(matrix, norms, allowed, queries, qn,
                                       q2, k, similarity, masks)
        return _mesh_flat_launch(
            matrix, norms, allowed, queries, qn, q2, k, similarity, masks, s,
            n_pad, dims, n_q, full_counter("mesh_knn_topk", matrix.device))


def mesh_knn_topk_probe(matrix, norms, allowed, queries, qn, q2, k: int,
                        similarity: str = "cosine", masks=None,
                        dots: bool = False) -> dict:
    """Row 39 on the card, uncounted and synchronised, as
    ``ops/knn.py`` ``knn_flat_probe``: its output, stage times, exact
    branch rows and (``dots``) the raw tensor-core dots [S, Q, N_pad]."""
    cuda, s, n_pad, dims, n_q = _mesh_flat_shape(matrix, norms, allowed,
                                                 queries, qn, q2, k,
                                                 similarity, masks)
    if not cuda:
        raise ValueError("mesh_knn_topk_probe runs on the card")
    dev = matrix.device
    full = torch.zeros(1, dtype=torch.int32, device=dev)
    probe = (torch.full((s, n_q, n_pad), torch.nan, device=dev) if dots
             else None)
    arr, addr = split_buffer(True)
    out = _mesh_flat_launch(matrix, norms, allowed, queries, qn, q2, k,
                            similarity, masks, s, n_pad, dims, n_q, full,
                            probe, addr)
    return {"out": out, "split_ms": split_of(arr),
            "full_rows": int(full.item()), "dots": probe}


def _mesh_coarse_shape(q8, scales, norms, allowed, qq, qscale, qn, q2,
                       kprime, similarity, masks):
    _sim_code(similarity)
    cuda = _on_cuda(q8, scales, norms, allowed, qq, qscale, qn, q2,
                    *([] if masks is None else [masks]))
    s, n_pad, dims = _check_vector_stack("q8", q8, torch.int8, norms,
                                         allowed)
    _check("scales", scales, torch.float32, (s, n_pad))
    n_q = _check_knn_queries("qq", qq, torch.int8, dims)
    if qq.data_ptr() % 4:
        raise ValueError("[qq] must be 4-byte aligned")
    _check("qscale", qscale, torch.float32, (n_q,))
    _check_query_terms(qn, q2, n_q)
    _check_mask_stack(masks, s, n_q, n_pad)
    if not 1 <= kprime <= min(KMAX, n_pad):
        raise ValueError(f"kprime={kprime} outside [1, {min(KMAX, n_pad)}]")
    return cuda, s, n_pad, dims, n_q


def _mesh_coarse_launch(q8, scales, norms, allowed, qq, qscale, qn, q2,
                        kprime, similarity, masks, s, n_pad, dims, n_q, full,
                        split_addr=0):
    dev = q8.device
    scratch = torch.empty(
        scratch_bytes("mesh_knn_coarse", s, n_q, dims, n_pad, kprime),
        dtype=torch.uint8, device=dev)
    cs = torch.empty(s, n_q, kprime, dtype=torch.float32, device=dev)
    cand = torch.empty(s, n_q, kprime, dtype=torch.int32, device=dev)
    launch_kernel(
        "mesh_knn_coarse", _SIG["mesh_knn_coarse"], _ptr(q8), _ptr(scales),
        _ptr(norms), _ptr(allowed), _opt_ptr(masks), _ptr(qq), _ptr(qscale),
        _ptr(qn), _ptr(q2), s, n_q, dims, n_pad, kprime,
        _sim_code(similarity), _ptr(scratch), _ptr(full), _ptr(cs),
        _ptr(cand), split_addr, _stream())
    return cs, cand


def mesh_knn_coarse(q8, scales, norms, allowed, qq, qscale, qn, q2,
                    kprime: int, similarity: str = "cosine", masks=None):
    """Row 36. The int8 coarse pass of every slot in one launch: the
    stacked mirror q8 [S, N_pad, D] int8 with ``scales`` [S, N_pad], norms
    / allowed [S, N_pad], the queries quantized once on the host for all
    slots (qq [Q, D] int8, qscale [Q]) with the f32 queries' ``qn`` /
    ``q2``, and optional ``masks`` [S, Q, N_pad]. Returns (coarse scores
    [S, Q, k'] f32, candidates [S, Q, k'] int32); each slot is
    ``knn_coarse`` (K6) on that slot's mirror."""
    cuda, s, n_pad, dims, n_q = _mesh_coarse_shape(
        q8, scales, norms, allowed, qq, qscale, qn, q2, kprime, similarity,
        masks)
    with DEVICE_PROFILE.call("mesh_knn_coarse",
                             _knn_label(s, n_pad, dims, n_q, kprime, masks),
                             cuda):
        if not cuda:
            return mesh_knn_coarse_plain(q8, scales, norms, allowed, qq,
                                         qscale, qn, q2, kprime, similarity,
                                         masks)
        return _mesh_coarse_launch(
            q8, scales, norms, allowed, qq, qscale, qn, q2, kprime,
            similarity, masks, s, n_pad, dims, n_q,
            full_counter("mesh_knn_coarse", q8.device))


def mesh_knn_coarse_probe(q8, scales, norms, allowed, qq, qscale, qn, q2,
                          kprime: int, similarity: str = "cosine",
                          masks=None) -> dict:
    """Row 36 on the card, uncounted and synchronised, as ``ops/knn.py``
    ``knn_coarse_probe``."""
    cuda, s, n_pad, dims, n_q = _mesh_coarse_shape(
        q8, scales, norms, allowed, qq, qscale, qn, q2, kprime, similarity,
        masks)
    if not cuda:
        raise ValueError("mesh_knn_coarse_probe runs on the card")
    full = torch.zeros(1, dtype=torch.int32, device=q8.device)
    arr, addr = split_buffer(True)
    out = _mesh_coarse_launch(q8, scales, norms, allowed, qq, qscale, qn, q2,
                              kprime, similarity, masks, s, n_pad, dims, n_q,
                              full, addr)
    return {"out": out, "split_ms": split_of(arr),
            "full_rows": int(full.item())}


def mesh_knn_rerank(matrix, norms, allowed, queries, qn, q2, cand, coarse_s,
                    k: int, similarity: str = "cosine", masks=None):
    """Row 37. The exact re-rank of every slot's coarse candidates in one
    launch: the f32 stack [S, N_pad, D], norms / allowed [S, N_pad], the
    queries [Q, D], candidates and coarse scores [S, Q, k'], optional
    ``masks`` [S, Q, N_pad]. Returns (scores [S, Q, k] f32, plane docs
    [S, Q, k] int32 with -1 where the score is -inf, eps [S, Q] f32);
    each slot is ``knn_rerank`` (K7) on that slot's plane."""
    cuda = _on_cuda(matrix, norms, allowed, queries, qn, q2, cand, coarse_s,
                    *([] if masks is None else [masks]))
    s, n_pad, dims = _check_vector_stack("matrix", matrix, torch.float32,
                                         norms, allowed)
    n_q = _check_knn_queries("queries", queries, torch.float32, dims)
    _check_query_terms(qn, q2, n_q)
    _check_mask_stack(masks, s, n_q, n_pad)
    if cand.dim() != 3 or tuple(cand.shape[:2]) != (s, n_q):
        raise ValueError(f"[cand] must be [{s}, {n_q}, k'], got "
                         f"{tuple(cand.shape)}")
    kprime = int(cand.shape[2])
    _check("cand", cand, torch.int32, (s, n_q, kprime))
    _check("coarse_s", coarse_s, torch.float32, (s, n_q, kprime))
    if not 1 <= k <= kprime <= KMAX:
        raise ValueError(f"need 1 <= k={k} <= kprime={kprime} <= {KMAX}")
    code = _sim_code(similarity)
    with DEVICE_PROFILE.call("mesh_knn_rerank",
                             _knn_label(s, n_pad, dims, n_q, kprime, masks),
                             cuda):
        if not cuda:
            return mesh_knn_rerank_plain(matrix, norms, allowed, queries, qn,
                                         q2, cand, coarse_s, k, similarity,
                                         masks)
        dev = matrix.device
        out_s = torch.empty(s, n_q, k, dtype=torch.float32, device=dev)
        out_d = torch.empty(s, n_q, k, dtype=torch.int32, device=dev)
        eps = torch.empty(s, n_q, dtype=torch.float32, device=dev)
        launch_kernel(
            "mesh_knn_rerank", _SIG["mesh_knn_rerank"], _ptr(matrix),
            _ptr(norms), _ptr(allowed), _opt_ptr(masks), _ptr(queries),
            _ptr(qn), _ptr(q2), _ptr(cand), _ptr(coarse_s), s, n_q, n_pad,
            dims, kprime, k, code, _ptr(out_s), _ptr(out_d), _ptr(eps),
            _stream())
        return out_s, out_d, eps


# ---------------------------------------------------------------------------
# the sparse kind: K15 / K16 / K17 per slot over the stacked rank_features
# planes
# ---------------------------------------------------------------------------

def _check_features_stack(block_docs, block_weights, live, n_docs_pad: int,
                          weight_dtype) -> Tuple[int, int]:
    """(n_slots, nb) of a stacked rank_features plane, checked."""
    if block_docs.dim() != 3 or block_docs.shape[2] != BLOCK_WIDTH:
        raise ValueError(f"[block_docs] must be [S, NB, {BLOCK_WIDTH}]")
    s, nb = int(block_docs.shape[0]), int(block_docs.shape[1])
    _check("block_docs", block_docs, torch.int32, (s, nb, BLOCK_WIDTH))
    _check("block_weights", block_weights, weight_dtype,
           (s, nb, BLOCK_WIDTH))
    _check("live", live, torch.bool, (s, n_docs_pad))
    return s, nb


def _check_lists(block_idx, query_weight, lead) -> Tuple[int, int]:
    """(Q, QB) of block lists and weights shaped ``lead + (Q, QB)``,
    checked, with the kernels' row bound over every leading axis."""
    nd = len(lead) + 2
    if block_idx.dim() != nd or tuple(block_idx.shape[:len(lead)]) != lead:
        raise ValueError(f"[block_idx] must be {list(lead) + ['Q', 'QB']}, "
                         f"got {tuple(block_idx.shape)}")
    n_q, qb = (int(x) for x in block_idx.shape[len(lead):])
    shape = tuple(lead) + (n_q, qb)
    _check("block_idx", block_idx, torch.int32, shape)
    _check("query_weight", query_weight, torch.float32, shape)
    rows = n_q
    for x in lead:
        rows *= x
    if not 1 <= rows <= MAX_QUERIES:
        raise ValueError(f"{rows} query rows outside [1, {MAX_QUERIES}]")
    return n_q, qb


def _sparse_label(s: int, qb: int, n_docs_pad: int, n_q: int,
                  k: int) -> str:
    return f"s={s}/qb={qb}/n_docs_pad={n_docs_pad}/n_q={n_q}/k={k}"


def mesh_sparse_topk_plain(block_docs, block_weights, block_idx,
                           query_weight, live, n_docs_pad: int, k: int):
    """``sparse_flat_plain`` (linear, counted) for every (slot, dp row),
    stacked."""
    s_all, d_all, h_all = [], [], []
    for si in range(block_docs.shape[0]):
        rows = [sparse_flat_plain(
            block_docs[si], block_weights[si], block_idx[si, r],
            query_weight[si, r], 1.0, 1.0, live[si], n_docs_pad, k,
            "linear", counted=True)
            for r in range(block_idx.shape[1])]
        s_all.append(torch.stack([x[0] for x in rows]))
        d_all.append(torch.stack([x[1] for x in rows]))
        h_all.append(torch.stack([x[2] for x in rows]))
    return torch.stack(s_all), torch.stack(d_all), torch.stack(h_all)


def mesh_sparse_coarse_plain(block_docs, block_weights_q, block_idx,
                             query_weight, live, n_docs_pad: int,
                             kprime: int):
    """``sparse_coarse_plain`` for every slot, stacked."""
    outs = [sparse_coarse_plain(block_docs[si], block_weights_q[si],
                                block_idx[si], query_weight[si], live[si],
                                n_docs_pad, kprime)
            for si in range(block_docs.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def mesh_sparse_rerank_plain(block_docs, block_weights, block_idx,
                             query_weight, live, cand, coarse_s,
                             n_docs_pad: int, kprime: int, k: int):
    """``sparse_rerank_plain`` for every slot, stacked."""
    outs = [sparse_rerank_plain(block_docs[si], block_weights[si],
                                block_idx[si], query_weight[si], live[si],
                                cand[si], coarse_s[si], n_docs_pad, kprime,
                                k)
            for si in range(block_docs.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def mesh_sparse_topk(block_docs, block_weights, block_idx, query_weight,
                     live, n_docs_pad: int, k: int):
    """Row 38. The exact rank_features top-k of every (slot, dp row) of
    the stacked planes in one launch: block_docs / block_weights
    [S, NB, 128] (int32 / f32), live [S, N], block lists and query weights
    [S, DP, Q, QB] (block ids local to the slot's store; block 0 / weight
    0 as padding). Returns (scores [S, DP, Q, k] f32, plane docs
    [S, DP, Q, k] int32, hits [S, DP, Q] int32); each (slot, row) is
    ``sparse_topk_batch`` (K15, linear, counted) on that slot's plane.
    Any 1 <= k <= N (one selection for any k)."""
    cuda = _on_cuda(block_docs, block_weights, block_idx, query_weight, live)
    s, _nb = _check_features_stack(block_docs, block_weights, live,
                                   n_docs_pad, torch.float32)
    if block_idx.dim() != 4:
        raise ValueError(f"[block_idx] must be [{s}, DP, Q, QB]")
    dp = int(block_idx.shape[1])
    n_q, qb = _check_lists(block_idx, query_weight, (s, dp))
    if not 1 <= k <= n_docs_pad:
        raise ValueError(f"k={k} outside [1, {n_docs_pad}]")
    with DEVICE_PROFILE.call("mesh_sparse_topk",
                             _sparse_label(s, qb, n_docs_pad, n_q, k), cuda):
        if not cuda:
            return mesh_sparse_topk_plain(block_docs, block_weights,
                                          block_idx, query_weight, live,
                                          n_docs_pad, k)
        return _mesh_sparse_topk_cuda(block_docs, block_weights, block_idx,
                                      query_weight, live, n_docs_pad, k)


def _mesh_sparse_topk_cuda(block_docs, block_weights, block_idx,
                           query_weight, live, n_docs_pad, k, probe=None):
    s, dp, n_q = (int(x) for x in block_idx.shape[:3])
    dev = block_docs.device
    out_s = torch.empty(s, dp, n_q, k, dtype=torch.float32, device=dev)
    out_d = torch.empty(s, dp, n_q, k, dtype=torch.int32, device=dev)
    hits = torch.empty(s, dp, n_q, dtype=torch.int32, device=dev)
    features_launch("mesh_sparse_topk", block_docs, block_weights,
                    block_idx, query_weight, live, groups=s * dp,
                    groups_per_slot=dp, n_docs_pad=n_docs_pad, n_q=n_q, k=k,
                    counted=True, function="linear", pivot=1.0,
                    exponent=1.0, out_s=out_s, out_d=out_d, hits=hits,
                    probe=probe)
    return out_s, out_d, hits


def mesh_sparse_coarse(block_docs, block_weights_q, block_idx, query_weight,
                       live, n_docs_pad: int, kprime: int):
    """Row 34. The bf16 coarse tier of every slot in one launch:
    block_weights_q [S, NB, 128] bf16 (each slot that shard's
    ``PlaneFeatures`` mirror), block lists and weights [S, Q, QB]. Returns
    (coarse scores [S, Q, k'] f32, candidates [S, Q, k'] int32, exact
    match counts [S, Q] int32); each slot is ``sparse_coarse_kernel``
    (K16) on that slot's mirror."""
    cuda = _on_cuda(block_docs, block_weights_q, block_idx, query_weight,
                    live)
    s, _nb = _check_features_stack(block_docs, block_weights_q, live,
                                   n_docs_pad, torch.bfloat16)
    n_q, qb = _check_lists(block_idx, query_weight, (s,))
    if not 1 <= kprime <= min(KMAX, n_docs_pad):
        raise ValueError(
            f"kprime={kprime} outside [1, {min(KMAX, n_docs_pad)}]")
    with DEVICE_PROFILE.call("mesh_sparse_coarse",
                             _sparse_label(s, qb, n_docs_pad, n_q, kprime),
                             cuda):
        if not cuda:
            return mesh_sparse_coarse_plain(block_docs, block_weights_q,
                                            block_idx, query_weight, live,
                                            n_docs_pad, kprime)
        return _mesh_sparse_coarse_cuda(block_docs, block_weights_q,
                                        block_idx, query_weight, live,
                                        n_docs_pad, kprime)


def _mesh_sparse_coarse_cuda(block_docs, block_weights_q, block_idx,
                             query_weight, live, n_docs_pad, kprime,
                             probe=None):
    s, n_q = int(block_idx.shape[0]), int(block_idx.shape[1])
    dev = block_docs.device
    cs = torch.empty(s, n_q, kprime, dtype=torch.float32, device=dev)
    cand = torch.empty(s, n_q, kprime, dtype=torch.int32, device=dev)
    hits = torch.empty(s, n_q, dtype=torch.int32, device=dev)
    features_launch("mesh_sparse_coarse", block_docs, block_weights_q,
                    block_idx, query_weight, live, groups=s,
                    groups_per_slot=1, n_docs_pad=n_docs_pad, n_q=n_q,
                    k=kprime, counted=True, function="linear", pivot=1.0,
                    exponent=1.0, out_s=cs, out_d=cand, hits=hits,
                    probe=probe)
    return cs, cand, hits


def mesh_sparse_probe(family: str, *args, **kwargs) -> dict:
    """``ops/bm25.py`` ``probe_tiles`` for row 38 or row 34 by family
    name."""
    body = {"mesh_sparse_topk": _mesh_sparse_topk_cuda,
            "mesh_sparse_coarse": _mesh_sparse_coarse_cuda}[family]
    return probe_tiles(globals()[family], body, *args, **kwargs)


def mesh_sparse_rerank(block_docs, block_weights, block_idx, query_weight,
                       live, cand, coarse_s, n_docs_pad: int, kprime: int,
                       k: int):
    """Row 35. The exact re-score of every slot's coarse candidates in one
    launch: the f32 stack, block lists and weights [S, Q, QB], candidates
    and coarse scores [S, Q, k']. Returns (scores [S, Q, k] f32, plane docs
    [S, Q, k] int32, eps [S, Q] f32); each slot is
    ``sparse_rerank_kernel`` (K17) on that slot's plane."""
    cuda = _on_cuda(block_docs, block_weights, block_idx, query_weight, live,
                    cand, coarse_s)
    s, nb = _check_features_stack(block_docs, block_weights, live,
                                  n_docs_pad, torch.float32)
    n_q, qb = _check_lists(block_idx, query_weight, (s,))
    _check("cand", cand, torch.int32, (s, n_q, kprime))
    _check("coarse_s", coarse_s, torch.float32, (s, n_q, kprime))
    if not 1 <= k <= kprime <= KMAX:
        raise ValueError(f"need 1 <= k={k} <= kprime={kprime} <= {KMAX}")
    with DEVICE_PROFILE.call("mesh_sparse_rerank",
                             _sparse_label(s, qb, n_docs_pad, n_q, kprime),
                             cuda):
        if not cuda:
            return mesh_sparse_rerank_plain(block_docs, block_weights,
                                            block_idx, query_weight, live,
                                            cand, coarse_s, n_docs_pad,
                                            kprime, k)
        dev = block_docs.device
        cand_s = torch.empty(s, n_q, kprime, dtype=torch.int32, device=dev)
        cs_s = torch.empty(s, n_q, kprime, dtype=torch.float32, device=dev)
        acc = torch.empty(s, n_q, kprime, dtype=torch.int64, device=dev)
        out_s = torch.empty(s, n_q, k, dtype=torch.float32, device=dev)
        out_d = torch.empty(s, n_q, k, dtype=torch.int32, device=dev)
        eps = torch.empty(s, n_q, dtype=torch.float32, device=dev)
        launch_kernel(
            "mesh_sparse_rerank", _SIG["mesh_sparse_rerank"],
            _ptr(block_docs), _ptr(block_weights), _ptr(block_idx),
            _ptr(query_weight), _ptr(live), _ptr(cand), _ptr(coarse_s), s,
            nb, qb, n_docs_pad, n_q, kprime, k, _ptr(cand_s), _ptr(cs_s),
            _ptr(acc), _ptr(out_s), _ptr(out_d), _ptr(eps), _stream())
        return out_s, out_d, eps
