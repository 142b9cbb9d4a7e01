"""Adaptive replica selection: rank shard copies by observed performance.

Reference: node/ResponseCollectorService.java:179 + the C3 ranking used by
OperationRouting.searchShards, after Suresh et al., *C3: Cutting Tail
Latency in Cloud Data Stores via Adaptive Replica Selection* (NSDI '15) —
the coordinator keeps EWMAs of each data node's response time, its
SELF-REPORTED service time and search-queue depth (piggybacked on every
shard query response by the shard batcher), and prefers the copy expected
to respond fastest instead of blind round-robin.

The rank is the full C3 formula (ComputedNodeStats.rank):

    rank(node) = R - 1/mu + (q_hat ** 3) / mu

where R is the response-time EWMA (what a request will experience), mu
the node's service RATE — so 1/mu is the piggybacked service-time EWMA
s, and the formula computes as R - s + (q_hat ** 3) * s — and q_hat =
1 + outstanding * n_clients + queue_EWMA the estimated queue the
request would join. The cubed queue term SCALES WITH the service time
(q queued requests cost q * s to drain), which is what makes the
ranking back off a SATURATED node long before its response times fully
degrade — the queue signal arrives one response earlier than the
latency it predicts, and a slow drainer is penalized more per queued
request, not less.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

ALPHA = 0.3          # EWMA smoothing (ResponseCollectorService.ALPHA)
QUEUE_ADJUSTMENT_EXP = 3.0   # C3's cubic queue penalty


class NodeStatistics:
    __slots__ = ("ewma_ms", "service_ewma_ms", "queue_ewma",
                 "outstanding", "observations", "write_ewma")

    def __init__(self) -> None:
        self.ewma_ms: Optional[float] = None          # response time
        self.service_ewma_ms: Optional[float] = None  # node-reported
        self.queue_ewma: Optional[float] = None       # node-reported
        self.outstanding = 0
        self.observations = 0
        # indexing-pressure utilization (in-flight write bytes / limit),
        # piggybacked on bulk/replication responses and on shard query
        # responses. OBSERVABLE ONLY: not folded into the C3 rank — the
        # write plane sheds through its own 429s; this lets operators
        # (and the stats surface) see the ingest-hot node the search
        # queue signal will shortly reflect
        self.write_ewma: Optional[float] = None


class ResponseCollectorService:
    def __init__(self) -> None:
        self._nodes: Dict[str, NodeStatistics] = {}
        self._lock = threading.Lock()
        # C3's `clients` term: the DATA-NODE count from cluster state
        # (the reference reads it off ClusterState), fed by the
        # coordinator per search. 0 = no state seen yet — fall back to
        # the tracked-node count, which undercounts early (only nodes
        # this coordinator has already contacted are tracked, so the
        # concurrency compensation starts too weak on a fresh node).
        self._data_node_count = 0

    def set_data_node_count(self, n: int) -> None:
        self._data_node_count = max(int(n), 0)

    def _clients_locked(self) -> int:
        return self._data_node_count or len(self._nodes)

    def _stats(self, node_id: str) -> NodeStatistics:
        stats = self._nodes.get(node_id)
        if stats is None:
            stats = self._nodes[node_id] = NodeStatistics()
        return stats

    # -- observation ------------------------------------------------------

    def on_send(self, node_id: str) -> None:
        with self._lock:
            self._stats(node_id).outstanding += 1

    def on_response(self, node_id: str, took_s: float,
                    failed: bool = False,
                    service_ms: Optional[float] = None,
                    queue_depth: Optional[float] = None) -> None:
        """One shard query round trip: ``took_s`` is the coordinator-side
        response time; ``service_ms`` / ``queue_depth`` are the node's
        self-reported service-time EWMA and search-queue depth piggybacked
        on the response (absent on failures and from pre-upgrade nodes)."""
        with self._lock:
            stats = self._stats(node_id)
            stats.outstanding = max(0, stats.outstanding - 1)
            if failed:
                # a failure reads as a slow response so the ranking backs
                # off the node without a separate penalty channel
                took_s = max(took_s, 1.0) * 2
            ms = took_s * 1000.0
            stats.ewma_ms = ms if stats.ewma_ms is None else \
                ALPHA * ms + (1 - ALPHA) * stats.ewma_ms
            if service_ms is not None:
                s = float(service_ms)
                stats.service_ewma_ms = s \
                    if stats.service_ewma_ms is None else \
                    ALPHA * s + (1 - ALPHA) * stats.service_ewma_ms
            if queue_depth is not None:
                # seeded with the first report like the sibling EWMAs —
                # a phantom-zero seed would understate the cubed queue
                # penalty ~37x on the first response from a node already
                # 50 deep, wasting the signal's one-response head start
                q = float(queue_depth)
                stats.queue_ewma = q if stats.queue_ewma is None else \
                    ALPHA * q + (1 - ALPHA) * stats.queue_ewma
            stats.observations += 1

    def on_rejection(self, node_id: str,
                     queue_depth: Optional[float] = None,
                     retry_after_s: Optional[int] = None) -> None:
        """A shard_busy shed: the node answered FAST (the rejection cost
        no drain), so feeding it through on_response would IMPROVE its
        response-time EWMA while it is refusing work. Instead the
        reported member backlog lands straight on the queue EWMA — the
        cubed C3 queue term then sinks the node's rank immediately, one
        shed ahead of any latency signal — and the round trip is not
        counted as a response time at all. The rejection's Retry-After
        is the node's own (backlog+1)/drain_rate estimate, so
        retry_after/(backlog+1) recovers a per-member service-time seed
        — a node whose FIRST contact is a shed still ranks WORSE than
        its healthy siblings, never as an optimistic unknown."""
        with self._lock:
            stats = self._stats(node_id)
            stats.outstanding = max(0, stats.outstanding - 1)
            if queue_depth is not None:
                q = float(queue_depth)
                # jump up instantly (a busy node must stop winning NOW),
                # decay back through the normal EWMA/decay machinery
                stats.queue_ewma = q if stats.queue_ewma is None \
                    else max(q, ALPHA * q + (1 - ALPHA) * stats.queue_ewma)
            if retry_after_s and queue_depth:
                s = retry_after_s * 1000.0 / (float(queue_depth) + 1.0)
                stats.service_ewma_ms = s \
                    if stats.service_ewma_ms is None else \
                    ALPHA * s + (1 - ALPHA) * stats.service_ewma_ms
            stats.observations += 1

    def on_write_pressure(self, node_id: str, current_bytes: int,
                          limit_bytes: int) -> None:
        """A peer's write-pressure snapshot (piggybacked on a bulk or
        replication response): EWMA its utilization. Does NOT touch
        outstanding/response EWMAs — write traffic is not a search round
        trip — and does not affect the C3 rank (see NodeStatistics)."""
        if limit_bytes is None or limit_bytes <= 0:
            return
        u = max(0.0, float(current_bytes) / float(limit_bytes))
        with self._lock:
            stats = self._stats(node_id)
            stats.write_ewma = u if stats.write_ewma is None else \
                ALPHA * u + (1 - ALPHA) * stats.write_ewma

    def response_ewma_s(self, node_id: str) -> Optional[float]:
        """The node's response-time EWMA in SECONDS, or None before any
        round trip has been observed — the adaptive per-copy shard-query
        transport timeout runs off this (TransportSearchAction)."""
        with self._lock:
            stats = self._nodes.get(node_id)
            if stats is None or stats.ewma_ms is None:
                return None
            return stats.ewma_ms / 1000.0

    # -- ranking ----------------------------------------------------------

    def rank(self, node_id: str) -> float:
        """Lower is better. Unknown nodes rank best (0) so new/idle nodes
        get probed, like the reference's optimistic default — but a node
        whose only history is shed rejections (queue_ewma set, no
        response EWMA yet) is NOT unknown: it ranks by its reported
        backlog."""
        with self._lock:
            stats = self._nodes.get(node_id)
            if stats is None or (stats.ewma_ms is None and
                                 stats.queue_ewma is None):
                return 0.0
            return self._rank_locked(stats, self._clients_locked())

    @staticmethod
    def _rank_locked(stats: NodeStatistics, n_clients: int) -> float:
        r = stats.ewma_ms if stats.ewma_ms is not None else 0.0
        # the piggybacked service-time EWMA s (= 1/mu, mu the service
        # rate); no report yet (failure-only history, or a pre-upgrade
        # node): the response time is the best service proxy. `is not
        # None`: a reported 0.0 (sub-µs drains round to it) is a REAL
        # fast-service signal, not an absent one
        s = stats.service_ewma_ms \
            if stats.service_ewma_ms is not None else r
        s = max(s, 1e-3)
        # concurrency compensation: this coordinator's outstanding
        # requests scaled by the number of competing clients
        q_hat = 1.0 + stats.outstanding * max(n_clients, 1) \
            + (stats.queue_ewma or 0.0)
        # R - 1/mu + q_hat^3/mu with mu = 1/s: the queue penalty grows
        # with the node's service time (q queued requests cost q*s)
        return r - s + (q_hat ** QUEUE_ADJUSTMENT_EXP) * s

    # per-SEARCH decay applied to unselected nodes' stats (the
    # reference's unselected-stats adjustment): without it a node whose
    # EWMAs froze at saturated values would never be sent traffic again
    # after it healed — observations only come from being selected
    UNSELECTED_DECAY = 0.1

    def order_copies(self, copies: list) -> list:
        """Stable sort of candidate nodes, best expected first. Pure —
        the coordinator calls this once per SHARD; the recovery decay
        is a separate once-per-search step (decay_unselected) so a
        50-shard fan-out doesn't erase a saturated node's history in
        one tick."""
        return sorted(copies, key=self.rank)

    def decay_unselected(self, winners, losers) -> None:
        """Called ONCE per coordinated search after replica selection:
        the losers' response-time and queue EWMAs decay toward the best
        selected node's, so a once-saturated node's frozen stats
        converge back into contention and it gets re-probed (a real
        observation then re-inflates them if it is STILL slow). The
        self-reported service EWMA is left alone — it is the node's own
        last report, refreshed on next contact. When no winner has
        observations yet (fresh nodes rank 0 and get probed anyway) the
        response floor is unknown: only the queue estimate decays."""
        with self._lock:
            known = [self._nodes[w].ewma_ms for w in winners
                     if w in self._nodes
                     and self._nodes[w].ewma_ms is not None]
            floor = min(known) if known else None
            d = self.UNSELECTED_DECAY
            for nid in losers:
                stats = self._nodes.get(nid)
                if stats is None:
                    continue
                if stats.ewma_ms is not None and floor is not None \
                        and stats.ewma_ms > floor:
                    stats.ewma_ms = stats.ewma_ms * (1 - d) + floor * d
                # rejection-only nodes decay too: a once-busy node whose
                # every contact was a shed must drift back into
                # contention once the backlog report ages
                if stats.queue_ewma:
                    stats.queue_ewma *= (1 - d)

    def stats(self) -> Dict[str, Dict[str, float]]:
        """The rank inputs per node — what ``_nodes/stats`` shows under
        ``adaptive_selection`` (and ``search_admission.ars``) so a
        routing decision is explainable from the stats surface alone."""
        with self._lock:
            n_clients = self._clients_locked()
            out: Dict[str, Dict[str, float]] = {}
            for nid, stats in self._nodes.items():
                entry = {"ewma_ms": round(stats.ewma_ms or 0.0, 3),
                         "outstanding": stats.outstanding,
                         "observations": stats.observations,
                         "queue_ewma": round(stats.queue_ewma or 0.0, 3),
                         "rank": (round(self._rank_locked(
                             stats, n_clients), 3)
                             if stats.ewma_ms is not None or
                             stats.queue_ewma is not None else 0.0)}
                if stats.service_ewma_ms is not None:
                    entry["service_ewma_ms"] = \
                        round(stats.service_ewma_ms, 3)
                if stats.write_ewma is not None:
                    entry["write_pressure_ewma"] = \
                        round(stats.write_ewma, 4)
                out[nid] = entry
            return out
