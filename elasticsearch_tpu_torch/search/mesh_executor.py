"""The mesh fan-out executor, before the mesh programs are ported.

The JAX package's ``search/mesh_executor.py`` collapses a fan-out to two
or more co-located shards into one sharded program per phase, whenever
its mesh backend is up. The mesh programs (the JAX package's
``parallel/mesh.py`` forms of K1, K3--K7 and K15--K17) are not ported
yet, so in this package the backend is never ready: ``try_submit`` runs
the same routing checks in the same order and then declines every
eligible fan-out with the typed reason ``mesh_backend_not_ready`` --
the route the JAX package takes whenever its own mesh is not up -- and
counts it in ``stats["mesh_fallbacks"]`` and in the telemetry's
``not_ported["mesh"]``. The per-shard RPC fan-out then serves the
request, through the shard batcher and the ported kernels.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.search import telemetry
from elasticsearch_tpu_torch.search.telemetry import TELEMETRY
from elasticsearch_tpu_torch.utils.settings import SEARCH_MESH_ENABLED


class MeshSearchExecutor:
    """Per-node mesh fan-out executor; owned by SearchTransportService
    (which also owns the shard-level micro-batcher)."""

    def __init__(self, sts):
        self.sts = sts
        self.stats: Dict[str, float] = {
            "mesh_searches": 0,        # searches served from the mesh
            "mesh_batches": 0,         # mesh drains dispatched
            "mesh_fallbacks": 0,       # members handed back to the RPC path
            "mesh_shard_results": 0,   # per-shard responses synthesized
            "device_dispatches": 0,    # mesh programs launched
            "max_occupancy": 0,
            "memo_hits": 0,
        }
        # per-HOST serving counters (multi-host meshes); empty until the
        # mesh programs serve
        self.per_host_stats: Dict[str, Dict[str, int]] = {}

    def try_submit(self, index: str, targets: List[Dict[str, Any]],
                   body: Dict[str, Any], window: int, task,
                   on_results: Callable[[Optional[List[Dict[str, Any]]]],
                                        None],
                   deadline: Optional[float] = None,
                   dfs_overrides: Optional[Dict[str, Any]] = None) -> bool:
        """False = not served by the mesh; the caller proceeds with the
        RPC fan-out. Never raises. Every False carries a typed
        routing-decision reason in the telemetry fallback taxonomy."""
        try:
            from elasticsearch_tpu_torch.ops.device_segment import (
                MESH_PLANES,
            )
            from elasticsearch_tpu_torch.utils.settings import (
                setting_from_state,
            )
            state = self.sts.state() if self.sts.state is not None else None
            if not setting_from_state(state, SEARCH_MESH_ENABLED):
                TELEMETRY.count_fallback(telemetry.MESH_DISABLED)
                return False
            if self.sts.batcher.at_member_bound():
                TELEMETRY.count_fallback(telemetry.MESH_NODE_BUSY)
                return False
            MESH_PLANES.configure_from_state(state)
            if len(targets) < max(1, MESH_PLANES.min_shards):
                TELEMETRY.count_fallback(telemetry.MESH_TOO_FEW_SHARDS)
                return False
        except Exception:  # noqa: BLE001 — eligibility must never fail
            TELEMETRY.count_fallback(telemetry.MESH_ELIGIBILITY_ERROR)
            return False
        # the mesh programs are not ported: the backend is never ready
        TELEMETRY.count_fallback(telemetry.MESH_BACKEND_NOT_READY)
        TELEMETRY.count_not_ported("mesh")
        self.stats["mesh_fallbacks"] += 1
        return False
