"""The JAX package's ``parallel/mesh.py``: the mesh layout and the
mesh-sharded plane's kernels.

The host half: the multi-host topology (``search.mesh.hosts``), the
process's host backend registry, the readiness probe and the device
layout of the mesh-sharded plane -- the pieces the node spine calls
(``action/search_action.py``, ``search/mesh_executor.py``,
``testing.py``).

The device half is the text kind's three programs, each the single-shard
body of an already-ported kernel run for every slot (one shard of a
co-located fan-out) in ONE launch over the stacked postings planes
(``ops/device_segment.py`` ``MeshPlanePart``):

- ``mesh_bm25_flat`` (``csrc/mesh_bm25_flat.cu``): K2 per (slot, dp row);
- ``mesh_bm25_coarse`` (``csrc/mesh_bm25_coarse.cu``): K3 per slot;
- ``mesh_bm25_rerank`` (``csrc/mesh_bm25_rerank.cu``): K4 per slot.

Each has a plain PyTorch version beside it, which runs the one-shard plain
version slot by slot; a wrapper takes it only for CPU tensors, and on a
CUDA tensor launches its kernel or raises. The 64-bit fixed-point sums
make every slot's output bitwise the one-shard kernel's on that slot's
plane, whatever order the atomics land in.

The port lays the whole mesh on the node's own device -- a grid of one:
the JAX package's ``shard`` axis becomes the kernels' leading slot axis,
and its ``dp`` axis caps at that one device. The kNN and sparse mesh
programs, and a mesh across several cards, are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from elasticsearch_tpu_torch.device import DeviceLike
from elasticsearch_tpu_torch.ops.bm25 import (
    BLOCK_WIDTH, DEFAULT_B, DEFAULT_K1, KMAX, MAX_SEGS, _check, _consts,
    _on_cuda, _ptr, _stream, bm25_coarse_plain, bm25_flat_seg_plain,
    bm25_rerank_plain, chunk_entries, launch_kernel,
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
    "mesh_bm25_flat": ["p"] * 9 + ["i", "i", "ll", "i", "ll", "i", "i", "i"]
    + ["f"] * 4 + ["p"] * 7,
    "mesh_bm25_coarse": ["p"] * 9 + ["i", "ll", "i", "ll", "i", "i", "i"]
    + ["f"] * 4 + ["p"] * 7,
    "mesh_bm25_rerank": ["p"] * 10 + ["i", "ll", "i", "ll", "i", "i", "i"]
    + ["f"] * 4 + ["p"] * 7,
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
    s, nb = _check_stack(block_docs, block_tfs, doc_lens, live, seg_ids,
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
        if not 1 <= k <= n_docs_pad:
            raise ValueError(f"k={k} outside [1, {n_docs_pad}]")
        if not 1 <= n_segs <= MAX_SEGS:
            raise ValueError(f"n_segs={n_segs} outside [1, {MAX_SEGS}]")
        dev = block_docs.device
        rows = s * dp * n_q
        acc = torch.empty(rows * n_docs_pad, dtype=torch.int64, device=dev)
        ck = chunk_entries(rows, n_docs_pad, k)
        chunk_s = torch.empty(ck, dtype=torch.float32, device=dev)
        chunk_i = torch.empty(ck, dtype=torch.int32, device=dev)
        out_s = torch.empty(s, dp, n_q, k, dtype=torch.float32, device=dev)
        out_d = torch.empty(s, dp, n_q, k, dtype=torch.int32, device=dev)
        hits = torch.empty(s, dp, n_q, n_segs, dtype=torch.int32,
                           device=dev)
        launch_kernel(
            "mesh_bm25_flat", _SIG["mesh_bm25_flat"], _ptr(block_docs),
            _ptr(block_tfs), _ptr(doc_lens), _ptr(flat_idx), _ptr(flat_w),
            _ptr(flat_q), _ptr(flat_avgdl), _ptr(live), _ptr(seg_ids), s,
            dp, nb, fb, n_docs_pad, n_q, k, n_segs, *_consts(k1, b),
            _ptr(acc), _ptr(chunk_s), _ptr(chunk_i), _ptr(out_s),
            _ptr(out_d), _ptr(hits), _stream())
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
    s, nb = _check_stack(block_docs, block_tfs_q, doc_lens_q, live, seg_ids,
                         n_docs_pad, torch.bfloat16, torch.bfloat16)
    fb = _check_flats((s,), flat_idx, flat_w, flat_q, flat_avgdl)
    with DEVICE_PROFILE.call("mesh_bm25_coarse",
                             _label(s, fb, n_docs_pad, n_q, kprime), cuda):
        if not cuda:
            return mesh_bm25_coarse_plain(
                block_docs, block_tfs_q, doc_lens_q, flat_idx, flat_w,
                flat_q, flat_avgdl, live, seg_ids, n_docs_pad, n_q, kprime,
                n_segs, k1=k1, b=b)
        if not 1 <= kprime <= min(KMAX, n_docs_pad):
            raise ValueError(
                f"kprime={kprime} outside [1, {min(KMAX, n_docs_pad)}]")
        if not 1 <= n_segs <= MAX_SEGS:
            raise ValueError(f"n_segs={n_segs} outside [1, {MAX_SEGS}]")
        dev = block_docs.device
        rows = s * n_q
        acc = torch.empty(rows * n_docs_pad, dtype=torch.int64, device=dev)
        ck = chunk_entries(rows, n_docs_pad, kprime)
        chunk_s = torch.empty(ck, dtype=torch.float32, device=dev)
        chunk_i = torch.empty(ck, dtype=torch.int32, device=dev)
        cs = torch.empty(s, n_q, kprime, dtype=torch.float32, device=dev)
        cand = torch.empty(s, n_q, kprime, dtype=torch.int32, device=dev)
        hits = torch.empty(s, n_q, n_segs, dtype=torch.int32, device=dev)
        launch_kernel(
            "mesh_bm25_coarse", _SIG["mesh_bm25_coarse"], _ptr(block_docs),
            _ptr(block_tfs_q), _ptr(doc_lens_q), _ptr(flat_idx),
            _ptr(flat_w), _ptr(flat_q), _ptr(flat_avgdl), _ptr(live),
            _ptr(seg_ids), s, nb, fb, n_docs_pad, n_q, n_segs, kprime,
            *_consts(k1, b, bf16=True), _ptr(acc), _ptr(chunk_s),
            _ptr(chunk_i), _ptr(cs), _ptr(cand), _ptr(hits), _stream())
        return cs, cand, hits


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
