"""The host half of the JAX package's ``parallel/mesh.py``.

The multi-host topology (``search.mesh.hosts``), the process's host
backend registry, the readiness probe and the ``(dp, shard)`` device
layout of the mesh-sharded plane. These are the pieces the node spine
calls (``action/search_action.py``, ``search/mesh_executor.py``,
``testing.py``). The mesh programs themselves -- the JAX package's
``mesh_bm25_flat`` ... ``mesh_knn_topk``, K1, K3--K7 and K15--K17 with a
leading slot axis -- are not ported yet, so ``ops/device_segment.py``
``MESH_PLANES`` never reports the mesh available.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


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


def mesh_ready() -> bool:
    """True when CUDA is ALREADY initialized in this process -- mesh
    layout must observe devices, never pay first-init inside a search
    (the same never-pay guard as ``monitor.device_stats``)."""
    return bool(torch.cuda.is_initialized())


def mesh_layout(n_shards: int, dp: int = 1, max_devices: int = 0,
                hosts: Optional[HostTopology] = None
                ) -> Tuple[List[List[torch.device]], int, int]:
    """(device grid, n_slots, slots_per_device) for ``n_shards``
    mesh-served shards over the visible cards.

    One shard = one slot of the stacked plane; slots map onto a
    ``[dp][d_used]`` grid over a device SUBSET sized to the shard count,
    padding the slot count up to a multiple of the used devices when
    shards outnumber cards. ``max_devices`` (0 = all) bounds the subset;
    ``hosts`` (search.mesh.hosts) caps it at the declared fleet."""
    total = torch.cuda.device_count()
    if hosts is not None:
        total = min(total, hosts.n_devices)
    if max_devices > 0:
        total = min(total, max_devices)
    total = max(total, 1)
    dp = max(1, min(int(dp), total))
    d_used = max(1, min(total // dp, n_shards))
    n_slots = -(-n_shards // d_used) * d_used
    grid = [[torch.device("cuda", r * d_used + c) for c in range(d_used)]
            for r in range(dp)]
    return grid, n_slots, n_slots // d_used
