"""Monitoring: periodic collection of node/cluster stats into a
monitoring index.

Reference: x-pack/plugin/monitoring — Collector subclasses snapshot
cluster/node/index stats on an interval and an Exporter bulk-writes them
to ``.monitoring-es-*`` (LocalExporter). This build keeps the local
exporter shape: every collection interval the elected master writes one
``cluster_stats``-type doc and one ``node_stats`` doc per node into the
monitoring index, queryable through the ordinary search path.
"""

from __future__ import annotations

import itertools
import logging
from typing import Any, Dict

logger = logging.getLogger(__name__)

MONITORING_INDEX = ".monitoring-es"
INTERVAL = 5.0


class MonitoringService:
    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        self._seq = itertools.count()
        self.collections = 0
        # the reference gates collection on the dynamic cluster setting
        # xpack.monitoring.collection.enabled; read it live each tick
        self.enabled = False

    def start(self) -> None:
        self._running = True
        self._schedule()

    def stop(self) -> None:
        self._running = False
        if self._timer is not None:
            self._timer.cancel()

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def _schedule(self) -> None:
        if not self._running:
            return
        self._timer = self.node.scheduler.schedule(INTERVAL, self._tick)

    def _collection_enabled(self) -> bool:
        if self.enabled:
            return True
        try:
            settings = self.node._applied_state() \
                .metadata.persistent_settings
            return bool(settings.get(
                "xpack.monitoring.collection.enabled"))
        except Exception:  # noqa: BLE001
            return False

    def _tick(self) -> None:
        if not self._running:
            return
        try:
            if self._collection_enabled() and \
                    self.node.coordinator.mode == "LEADER":
                self.collect_now()
        except Exception:  # noqa: BLE001
            logger.exception("monitoring collection failed")
        self._schedule()

    def collect_now(self) -> None:
        """One collection: cluster doc + per-node docs (Collector +
        LocalExporter, collapsed)."""
        state = self.node._applied_state()
        ts = self.node.scheduler.now()
        seq = next(self._seq)
        items = [{
            "action": "index", "index": MONITORING_INDEX,
            "id": f"cluster-{seq}",
            "source": {
                "type": "cluster_stats", "timestamp": ts,
                "cluster_uuid": getattr(state, "cluster_uuid", "local"),
                "version": state.version,
                "nodes": len(state.nodes),
                "indices": len(state.metadata.indices),
                "status": self._health(state),
            }}]
        self.collections += 1

        def with_stats(resp, _err=None):
            for nid, stats in sorted(
                    ((resp or {}).get("nodes") or {}).items()):
                items.append({
                    "action": "index", "index": MONITORING_INDEX,
                    "id": f"node-{nid}-{seq}",
                    "source": {"type": "node_stats", "timestamp": ts,
                               "node_id": nid,
                               "node_stats": _shallow(stats)}})
            self.node.bulk_action.execute(items, lambda _r=None: None)
        # one node_stats doc PER CLUSTER NODE via the transport fan-out
        self.node.client.nodes_stats_all(with_stats)

    def _health(self, state) -> str:
        try:
            from elasticsearch_tpu_torch.action.admin import cluster_health
            return cluster_health(state)["status"]
        except Exception:  # noqa: BLE001
            return "unknown"

    def stats(self) -> Dict[str, Any]:
        return {"enabled": self.enabled,
                "collections": self.collections,
                "interval_s": INTERVAL}


def _shallow(stats: Dict[str, Any]) -> Dict[str, Any]:
    """Keep the doc bounded: top-level scalars + one nesting level."""
    out: Dict[str, Any] = {}
    for k, v in (stats or {}).items():
        if isinstance(v, (int, float, str, bool)):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = {k2: v2 for k2, v2 in v.items()
                      if isinstance(v2, (int, float, str, bool))}
    return out
