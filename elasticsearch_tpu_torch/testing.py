"""In-process multi-node test cluster over the deterministic scheduler.

Reference analog: test/framework's InternalTestCluster.java:175 (N real
Node objects in one JVM with mock transports) fused with
AbstractCoordinatorTestCase.java:143 (virtual-time determinism). Every test
run is seed-reproducible; partitions/drops come from InMemoryTransport's
disruption rules (NetworkDisruption analog).
"""

from __future__ import annotations

import errno
import os
import random as _random
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.cluster.coordination import CoordinatorSettings, Mode
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.index.disk_io import FOOTER_SIZE, DiskIO
from elasticsearch_tpu_torch.node.node import Node, NodeClient
from elasticsearch_tpu_torch.transport.scheduler import DeterministicScheduler
from elasticsearch_tpu_torch.transport.transport import InMemoryTransport


class FaultyDiskIO(DiskIO):
    """The disk fault injector: a DiskIO whose operations can be armed to
    fail or corrupt, plus at-rest corruption helpers for files already on
    disk. All randomness draws from the injected (seeded) RNG, so every
    fault interleaving is reproducible (MockDirectoryWrapper +
    CorruptionUtils analog of the reference test framework).

    Write-path faults (``arm``): 'eio' / 'enospc' raise OSError; 'bit_flip'
    flips one random bit of the payload; 'truncate' drops a random tail;
    'slow' charges ``delay_s`` of virtual time per matched operation (a
    degraded disk: the op still succeeds, it just takes forever — the
    brownout that backpressure exists for, not the crash that recovery
    exists for). Rules filter by path substring and operation
    (write/append/read), and can be limited to a fault count.
    """

    def __init__(self, rng: Optional[_random.Random] = None):
        self.random = rng or _random.Random(0)
        self.rules: List[Dict[str, Any]] = []
        self.stats = {"bit_flips": 0, "truncations": 0, "io_errors": 0,
                      "slow_ops": 0}
        # virtual-clock seam for 'slow' rules: InProcessCluster wires
        # this to advance the deterministic scheduler's clock, so disk
        # latency is charged INSIDE synchronous write handlers (there is
        # no real sleeping under virtual time)
        self.clock_advance: Optional[Callable[[float], None]] = None

    # -- armed (in-flight) faults ---------------------------------------

    def arm(self, kind: str, match: str = "", op: str = "*",
            count: Optional[int] = None,
            delay_s: float = 0.05) -> Dict[str, Any]:
        """Arm a fault rule; returns it (pass to disarm, or mutate
        ``rule['remaining']``). kind: eio|enospc|bit_flip|truncate|slow;
        ``delay_s`` is the per-operation latency charge for 'slow'."""
        assert kind in ("eio", "enospc", "bit_flip", "truncate",
                        "slow"), kind
        rule = {"kind": kind, "match": match, "op": op, "remaining": count,
                "delay_s": delay_s}
        self.rules.append(rule)
        return rule

    def disarm(self, rule: Optional[Dict[str, Any]] = None) -> None:
        if rule is None:
            self.rules.clear()
        elif rule in self.rules:
            self.rules.remove(rule)

    def _fault(self, op: str, path: Path, data: bytes) -> bytes:
        for rule in list(self.rules):
            if rule["remaining"] is not None and rule["remaining"] <= 0:
                continue
            if rule["op"] not in ("*", op):
                continue
            if rule["match"] and rule["match"] not in str(path):
                continue
            if rule["remaining"] is not None:
                rule["remaining"] -= 1
            kind = rule["kind"]
            if kind == "eio":
                self.stats["io_errors"] += 1
                raise OSError(errno.EIO,
                              f"injected I/O error on [{path.name}]")
            if kind == "enospc":
                self.stats["io_errors"] += 1
                raise OSError(errno.ENOSPC,
                              f"injected disk-full on [{path.name}]")
            if kind == "slow":
                self.stats["slow_ops"] += 1
                if self.clock_advance is not None:
                    self.clock_advance(rule["delay_s"])
            elif kind == "bit_flip" and data:
                data = self._flip_one_bit(data)
                self.stats["bit_flips"] += 1
            elif kind == "truncate" and data:
                data = data[: self.random.randrange(0, len(data))]
                self.stats["truncations"] += 1
        return data

    def _flip_one_bit(self, data: bytes) -> bytes:
        buf = bytearray(data)
        i = self.random.randrange(len(buf))
        buf[i] ^= 1 << self.random.randrange(8)
        return bytes(buf)

    # -- at-rest corruption ---------------------------------------------

    def corrupt_file(self, path: str | Path, skip_footer: bool = False
                     ) -> int:
        """Flip one random bit of a file in place (a cosmic ray / rotting
        sector). ``skip_footer=True`` keeps the flip inside the payload
        region so the test exercises payload CRC, not footer damage.
        Returns the flipped byte offset."""
        path = Path(path)
        data = bytearray(path.read_bytes())
        limit = len(data) - (FOOTER_SIZE if skip_footer else 0)
        i = self.random.randrange(limit)
        data[i] ^= 1 << self.random.randrange(8)
        path.write_bytes(bytes(data))
        return i

    def truncate_file(self, path: str | Path,
                      drop_bytes: Optional[int] = None) -> int:
        """Cut a random (or given) number of tail bytes off a file — a
        torn write that never completed. Returns bytes dropped."""
        path = Path(path)
        size = path.stat().st_size
        if drop_bytes is None:
            drop_bytes = self.random.randrange(1, max(size, 2))
        drop_bytes = min(drop_bytes, size)
        with open(path, "r+b") as f:
            f.truncate(size - drop_bytes)
        return drop_bytes


class VirtualHostBackend:
    """Host-partitioned stand-in for real multi-process JAX: the test
    process's devices split into virtual HOSTS (parallel/mesh.py
    ``HostTopology``), cluster nodes map onto those hosts round-robin,
    and the mesh executor reaches a member host's shards through this
    backend exactly where a real multi-host SPMD program's participant
    would address its own. Liveness is derived, not declared: a node is
    alive while it is in ``cluster.nodes`` and on the wire, and a
    virtual host is alive while EVERY node mapped to it is — so
    ``crash_node``/``kill_node`` take the victim's host down and
    ``restart_node``/``reboot_node`` bring it back, with no extra
    bookkeeping for tests to forget."""

    def __init__(self, cluster: "InProcessCluster", topology):
        self.cluster = cluster
        self.topology = topology
        self._hosts: Dict[str, int] = {
            nid: i % topology.n_hosts
            for i, nid in enumerate(cluster._node_ids)}

    def _node_alive(self, node_id: str) -> bool:
        return node_id in self.cluster.nodes and \
            node_id not in self.cluster.transport._crashed

    def host_of_node(self, node_id: str) -> Optional[int]:
        return self._hosts.get(node_id)

    def host_alive(self, host: int) -> bool:
        nodes = [nid for nid, h in self._hosts.items() if h == host]
        return bool(nodes) and all(self._node_alive(n) for n in nodes)

    def nodes_on_host(self, host: int) -> List[str]:
        return [nid for nid, h in self._hosts.items() if h == host]

    def indices_of(self, node_id: str):
        if not self._node_alive(node_id):
            return None
        return self.cluster.nodes[node_id].indices_service

    def pressure_snapshot(self, node_id: str):
        if not self._node_alive(node_id):
            return None
        batcher = self.cluster.nodes[node_id].search_transport.batcher
        return batcher.node_pressure.snapshot(batcher.queue_depth())


class InProcessCluster:
    def __init__(self, n_nodes: int = 3, seed: int = 0,
                 data_path: Optional[str] = None,
                 mesh_data_plane: bool = False,
                 mesh_hosts: Optional[str] = None,
                 device=None,
                 mesh_slots: Optional[int] = None):
        self.scheduler = DeterministicScheduler(seed=seed)
        # every node's device (None = the CUDA card; tests pass "cpu")
        self.device = device
        self.transport = InMemoryTransport(self.scheduler)
        self.data_path = data_path
        # every shard Store/Translog on every node writes through this
        # seeded injector; quiescent (no armed rules) it is a plain DiskIO
        self.disk_io = FaultyDiskIO(_random.Random(seed ^ 0x5EED))

        def _advance(d: float) -> None:
            # safe mid-task: run_one resumes from max(self._time, t), so
            # a synchronous advance just means everything already queued
            # before now+d fires "immediately" after the slow op returns
            self.scheduler._time += d
        self.disk_io.clock_advance = _advance
        node_ids = [f"node{i}" for i in range(n_nodes)]
        self._node_ids = node_ids
        self._mesh_data_plane = mesh_data_plane
        # the data plane's slot count S on every node (None: its default)
        self._mesh_slots = mesh_slots
        # bootstrap: the initial voting configuration is the full seed set
        # (ClusterBootstrapService analog)
        initial = ClusterState(voting_config=frozenset(node_ids))
        self._initial_state = initial
        self.nodes: Dict[str, Node] = {}
        for nid in node_ids:
            self.nodes[nid] = self._build_node(nid)
        # virtual multi-host mesh: partition this process's devices into
        # ``mesh_hosts`` hosts ("N" or "NxM") and register the backend
        # the mesh executor routes cross-host fan-outs through
        self.host_backend: Optional[VirtualHostBackend] = None
        if mesh_hosts:
            from elasticsearch_tpu_torch.parallel.mesh import (
                parse_host_topology, set_host_backend,
            )
            topo = parse_host_topology(mesh_hosts)
            if topo is not None:
                self.host_backend = VirtualHostBackend(self, topo)
                set_host_backend(self.host_backend)

    def _build_node(self, nid: str) -> Node:
        return Node(
            nid, self.transport, self.scheduler,
            seed_peers=self._node_ids,
            data_path=(f"{self.data_path}/{nid}" if self.data_path
                       else None),
            initial_state=self._initial_state,
            coordinator_settings=CoordinatorSettings(),
            mesh_data_plane=self._mesh_data_plane,
            mesh_slots=self._mesh_slots,
            disk_io=self.disk_io, device=self.device)

    # ------------------------------------------------------------------

    def start(self, run_for: float = 60.0) -> None:
        for node in self.nodes.values():
            node.start()

        def formed() -> bool:
            master = self.master()
            return (master is not None and
                    len(master.coordinator.applied_state.nodes)
                    == len(self.nodes))
        self.run_until(formed, run_for)

    def stop(self) -> None:
        for node in self.nodes.values():
            node.stop()
        if self.host_backend is not None:
            from elasticsearch_tpu_torch.parallel.mesh import (
                host_backend, set_host_backend,
            )
            if host_backend() is self.host_backend:
                set_host_backend(None)
            self.host_backend = None

    def master(self) -> Optional[Node]:
        leaders = [n for n in self.nodes.values()
                   if n.coordinator.mode == Mode.LEADER]
        return leaders[0] if len(leaders) == 1 else None

    def client(self, node_id: Optional[str] = None) -> NodeClient:
        if node_id is not None:
            return self.nodes[node_id].client
        return next(iter(self.nodes.values())).client

    # ------------------------------------------------------------------
    # deterministic drivers
    # ------------------------------------------------------------------

    def run_until(self, predicate: Callable[[], bool],
                  max_time: float = 60.0) -> None:
        deadline = self.scheduler.now() + max_time
        while not predicate():
            if self.scheduler.now() > deadline or \
                    not self.scheduler.run_one():
                if predicate():
                    return
                raise TimeoutError(
                    f"condition not reached after {max_time}s virtual time")

    def call(self, fn: Callable[[Callable], None], max_time: float = 60.0
             ) -> Tuple[Optional[Dict[str, Any]], Optional[Exception]]:
        """Drive an async client call to completion: fn(on_done) -> (resp, err)."""
        box: List[Tuple[Any, Any]] = []
        fn(lambda resp, err=None: box.append((resp, err)))
        self.run_until(lambda: bool(box), max_time)
        return box[0]

    def ensure_green(self, index: Optional[str] = None,
                     max_time: float = 120.0) -> None:
        self._ensure_status(("green",), index, max_time)

    def ensure_yellow(self, index: Optional[str] = None,
                      max_time: float = 120.0) -> None:
        self._ensure_status(("yellow", "green"), index, max_time)

    def _ensure_status(self, ok, index, max_time) -> None:
        def ready() -> bool:
            master = self.master()
            if master is None:
                return False
            if master.client.cluster_health(index)["status"] not in ok:
                return False
            # every node still in the master's view must have APPLIED the
            # state it's judged by — clients read their local node's applied
            # state. Nodes the master has dropped (or that are partitioned
            # away, hence absent from its membership) can never catch up and
            # must not hold green/yellow hostage.
            version = master.coordinator.applied_state.version
            members = master.coordinator.applied_state.nodes
            return all(n.coordinator.applied_state.version >= version
                       for n in self.nodes.values()
                       if n.node_id in members)
        self.run_until(ready, max_time)

    def await_node_count(self, n: int, max_time: float = 300.0) -> None:
        """Wait until the master's committed membership has exactly n nodes
        (failure detection takes a few heartbeat rounds of virtual time)."""
        def counted() -> bool:
            master = self.master()
            return (master is not None and
                    len(master.coordinator.applied_state.nodes) == n)
        self.run_until(counted, max_time)

    # ------------------------------------------------------------------
    # disruption helpers
    # ------------------------------------------------------------------

    def kill_node(self, node_id: str) -> None:
        """Hard-stop a node (die-with-dignity analog: it just vanishes)."""
        node = self.nodes.pop(node_id)
        node.stop()

    def crash_node(self, node_id: str) -> None:
        """Crash without cleanup: the node drops off the wire (senders get
        connection-refused) but keeps its in-memory state for
        restart_node() — a process crash/restart or a long GC-style pause."""
        self.transport.crash(node_id)

    def restart_node(self, node_id: str) -> None:
        self.transport.restore(node_id)

    def reboot_node(self, node_id: str) -> None:
        """Full process restart: stop the node (in-memory state lost) and
        boot a fresh Node over the same data path — cluster metadata comes
        back through the gateway, shard data through store/translog
        recovery (where integrity checks run)."""
        node = self.nodes.pop(node_id)
        node.stop()
        fresh = self._build_node(node_id)
        self.nodes[node_id] = fresh
        fresh.start()

    def full_restart(self, run_for: float = 60.0) -> None:
        """Stop EVERY node, then boot fresh processes over the same data
        paths — the full-cluster-restart scenario the gateway allocator
        exists for: metadata returns through each node's persisted state,
        routing is re-derived by the shard-state fetch, and every copy
        with fresh local data recovers in place."""
        for node in self.nodes.values():
            node.stop()
        self.nodes.clear()
        for nid in self._node_ids:
            self.nodes[nid] = self._build_node(nid)
        self.start(run_for=run_for)

    def shard_store_path(self, node_id: str, index: str, shard: int
                         ) -> Optional[str]:
        """This node's on-disk store directory for one shard copy (the
        chaos suite corrupts files under it)."""
        if self.data_path is None:
            return None
        node = self.nodes[node_id]
        service = node.indices_service.indices.get(index)
        if service is None:
            return None
        return os.path.join(f"{self.data_path}/{node_id}",
                            service.metadata.uuid, str(shard))

    def partition(self, side_a: List[str], side_b: List[str],
                  style: str = "blackhole") -> None:
        self.transport.partition(side_a, side_b, style=style)

    def partition_one_way(self, from_side: List[str], to_side: List[str],
                          style: str = "blackhole") -> None:
        """Asymmetric partition: from_side -> to_side traffic disrupted,
        reverse direction intact."""
        self.transport.partition_one_way(from_side, to_side, style=style)

    def add_latency(self, sender: str, receiver: str, delay: float,
                    jitter: float = 0.0) -> None:
        """Inject fixed + jittered latency on one directed link (jitter
        draws from the seeded scheduler RNG: reproducible chaos)."""
        self.transport.add_rule(sender, receiver, delay=delay,
                                jitter=jitter)

    def slow_node_drains(self, node_id: str, delay_s: float) -> None:
        """Overload chaos seam: every shard-query drain on ``node_id``
        delivers ``delay_s`` later in virtual time AND reports the delay
        in its self-reported service time — a saturated/slow data node
        (GC pauses, noisy neighbor, thermal throttling) that a wire-level
        latency rule cannot model, because the node itself knows it is
        slow and says so in its pressure piggyback. 0 heals."""
        batcher = self.nodes[node_id].search_transport.batcher
        batcher.fault_drain_delay_s = float(delay_s)

    def constrain_search_admission(self, size: int, queue: int) -> None:
        """Shrink every node's search admission pool (slots + a FIXED
        queue bound) so overload scenarios reach saturation at test
        scale. Direct pool mutation — the dynamic search.admission.*
        settings are deliberately not written, so the admission
        refresh leaves these values alone."""
        for node in self.nodes.values():
            pool = node.thread_pool.pool("search")
            pool.size = int(size)
            pool.queue_size = int(queue)
            pool.min_queue = int(queue)
            pool.max_queue = int(queue)

    def heal(self) -> None:
        self.transport.heal()


# ---------------------------------------------------------------------------
# fleet-scale overload traffic harness (ROADMAP item 6)
# ---------------------------------------------------------------------------

def _p99(lats: List[float]) -> float:
    """Nearest-rank p99 — the one percentile formula the harness summary
    and the scenario's unloaded baseline share."""
    if not lats:
        return 0.0
    data = sorted(lats)
    return data[int(0.99 * (len(data) - 1))]


class FleetTrafficHarness:
    """Multi-coordinator, multi-tenant traffic over an InProcessCluster —
    the closest thing to "millions of users" a test process can express,
    in fully deterministic virtual time:

    - **diurnal load curve**: arrivals follow a seeded nonhomogeneous
      Poisson process (Lewis-Shedler thinning) whose rate traces
      ``0.35 + 0.65·sin²(π·t/period)`` — two troughs, two peaks per run;
    - **zipfian tenants**: each arrival picks its tenant (index) with
      1/rank weights, so a hot head and a long tail coexist — and a
      configured hot tenant gets a 10:1 flood multiplier inside the peak
      window (the overload plane's canonical adversary);
    - **multi-coordinator**: each arrival enters through a seeded choice
      of coordinator node, so every coordinator's admission pool, ARS
      view, and busy-failover loop is exercised against the SAME data
      nodes — the N-coordinators × M-tenants fan-in no single
      coordinator-side bound can see;
    - **chaos events**: arbitrary ``(t, fn)`` callbacks scheduled into
      the run (rolling restarts via crash/restart, slow nodes via
      ``slow_node_drains``, bounds via settings, ...).

    Every request is recorded (tenant, coordinator, latency, outcome);
    ``summary()`` reduces the record stream to the fleet invariants the
    chaos suite and bench assert: bounded admitted p99, clean 429s with
    honest Retry-After, zero starved tenants, shed/failover accounting.
    """

    def __init__(self, cluster: InProcessCluster,
                 tenants: List[str], coordinators: List[str],
                 seed: int = 0):
        self.c = cluster
        self.tenants = list(tenants)
        self.coordinators = list(coordinators)
        self.random = _random.Random(seed ^ 0xF1EE7)
        self.records: List[Dict[str, Any]] = []
        self._expected = {"n": 0}

    # -- traffic ---------------------------------------------------------

    def _arrivals(self, duration_s: float, total: int,
                  hot_tenant: Optional[str], hot_window: Tuple[float, float],
                  hot_factor: float) -> List[Tuple[float, str, str]]:
        """The seeded arrival plan: (t, tenant, coordinator) tuples.
        Lewis-Shedler thinning against the diurnal shape; zipfian tenant
        choice with the hot multiplier inside the window; plus a floor
        of three scheduled arrivals per tenant so starvation is always
        measurable (a tenant that never arrived cannot be starved)."""
        import math
        period = duration_s / 2.0

        def shape(t: float) -> float:
            return 0.35 + 0.65 * math.sin(math.pi * t / period) ** 2

        # mean of shape over the run is 0.675: pick λ_max to land near
        # `total` accepted arrivals
        lam_max = total / (0.675 * duration_s)
        weights = [1.0 / (rank + 1) for rank in range(len(self.tenants))]
        plan: List[Tuple[float, str, str]] = []
        t = 0.0
        while len(plan) < total:
            t += self.random.expovariate(lam_max)
            if t >= duration_s:
                break
            if self.random.random() > shape(t):
                continue
            w = list(weights)
            if hot_tenant in self.tenants and \
                    hot_window[0] <= t <= hot_window[1]:
                w[self.tenants.index(hot_tenant)] *= hot_factor
            tenant = self.random.choices(self.tenants, weights=w)[0]
            coord = self.random.choice(self.coordinators)
            plan.append((t, tenant, coord))
        # starvation floor: every tenant arrives at least 3 times, spread
        # through the run (outside nothing — they compete like anyone)
        for tenant in self.tenants:
            for frac in (0.2, 0.55, 0.85):
                coord = self.random.choice(self.coordinators)
                plan.append((duration_s * frac, tenant, coord))
        plan.sort(key=lambda e: e[0])
        return plan

    def submit_one(self, tenant: str, coord: str, body: Dict[str, Any]
                   ) -> None:
        sched = self.c.scheduler
        record = {"tenant": tenant, "coord": coord, "t0": sched.now(),
                  "t1": None, "err": None}
        self.records.append(record)

        def done(resp, err=None):
            record["t1"] = sched.now()
            record["err"] = err
            record["resp"] = resp
        self.c.nodes[coord].client.search(tenant, body, done)

    def run(self, duration_s: float, total: int, *,
            hot_tenant: Optional[str] = None,
            hot_window: Optional[Tuple[float, float]] = None,
            hot_factor: float = 10.0,
            events: Optional[List[Tuple[float, Callable[[], None]]]] = None,
            body_fn: Optional[Callable[[str], Dict[str, Any]]] = None,
            max_time: float = 3600.0) -> None:
        """Schedule the whole plan plus chaos events, then drive virtual
        time until every submitted search has resolved."""
        sched = self.c.scheduler
        hot_window = hot_window or (0.45 * duration_s, 0.7 * duration_s)
        plan = self._arrivals(duration_s, total, hot_tenant, hot_window,
                              hot_factor)
        self._expected["n"] += len(plan)

        def make_body(tenant: str) -> Dict[str, Any]:
            if body_fn is not None:
                return body_fn(tenant)
            return {"query": {"match": {
                "body": f"common w{self.random.randrange(8)}"}},
                "size": 5}

        for t, tenant, coord in plan:
            sched.schedule(t, lambda tn=tenant, co=coord:
                           self.submit_one(tn, co, make_body(tn)))
        for t, fn in (events or []):
            sched.schedule(t, fn)
        self.c.run_until(
            lambda: len(self.records) >= self._expected["n"] and
            all(r["t1"] is not None for r in self.records), max_time)

    # -- reduction -------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        from elasticsearch_tpu_torch.utils.errors import shard_busy_info

        admitted = [r for r in self.records if r["err"] is None]
        rejected = [r for r in self.records if r["err"] is not None]
        clean = []
        busy_failures = 0
        for r in rejected:
            err = r["err"]
            status = getattr(err, "status", 500)
            meta = getattr(err, "metadata", None) or {}
            if status == 429 and int(meta.get("retry_after", 0)) >= 1:
                clean.append(r)
            if shard_busy_info(err) is not None or \
                    "shard_busy" in str(err):
                busy_failures += 1
        goodput: Dict[str, int] = {t: 0 for t in self.tenants}
        for r in admitted:
            goodput[r["tenant"]] = goodput.get(r["tenant"], 0) + 1
        partial = sum(
            1 for r in admitted
            if (r.get("resp") or {}).get("_shards", {}).get("failed", 0))
        return {
            "offered": len(self.records),
            "admitted": len(admitted),
            "admitted_p99_s": _p99([r["t1"] - r["t0"]
                                    for r in admitted]),
            "rejected": len(rejected),
            "rejected_clean_429": len(clean),
            "unclean_rejections": len(rejected) - len(clean),
            "request_busy_failures": busy_failures,
            "partial_responses": partial,
            "goodput_by_tenant": goodput,
            "starved_tenants": [t for t, n in goodput.items() if n == 0],
        }


def _fleet_cache_hits(c: "InProcessCluster") -> int:
    """Fleet-wide request-cache hit total across every tier (shard
    request cache, batcher intake, coordinator fused cache)."""
    hits = 0
    for node in c.nodes.values():
        hits += node.search_transport.request_cache.stats["hits"]
        hits += node.search_transport.batcher.stats.get(
            "request_cache_intake_hits", 0)
        fused = getattr(node.search_action, "fused_cache", None)
        if fused is not None:
            hits += fused.stats.get("hits", 0)
    return hits


def fleet_overload_scenario(seed: int, *, n_tenants: int = 4,
                            n_nodes: int = 6, docs: int = 10,
                            total_searches: int = 260,
                            duration_s: float = 1.2,
                            shard_bound: int = 2,
                            slow_delay_s: float = 0.08,
                            admission: Tuple[int, int] = (3, 10),
                            dup_head_fraction: float = 0.0
                            ) -> Dict[str, Any]:
    """THE million-user chaos scenario (ROADMAP item 6), one seed: a
    10:1 hot-tenant flood across 3 coordinators and ``n_tenants``
    zipfian tenants on a diurnal curve, with one slow data node from
    before the flood and a rolling restart mid-peak — against the full
    two-sided overload plane (coordinator admission + per-tenant fair
    shedding, shard-side ``search.shard.max_queued_members`` shed point,
    typed shard_busy failover, C3 ARS fed by pressure piggybacks AND
    busy rejections).

    Returns the measured invariants; the chaos suite asserts them green
    on every seed, bench.py emits them as the ``fleet`` config line."""
    from elasticsearch_tpu_torch.search.telemetry import TELEMETRY

    c = InProcessCluster(n_nodes=n_nodes, seed=seed)
    c.start()
    try:
        import numpy as np
        tenants = [f"t{i}" for i in range(n_tenants)]
        coordinators = [f"node{i}" for i in range(min(3, n_nodes))]
        client = c.client()
        rng = np.random.default_rng(seed)
        box: List[Any] = []

        def wait(n: int) -> None:
            c.run_until(lambda: len(box) >= n, 300.0)

        expected: Dict[str, int] = {}
        for tenant in tenants:
            n0 = len(box)
            client.create_index(tenant, {
                "settings": {"number_of_shards": 1,
                             "number_of_replicas": 1},
                "mappings": {"properties": {"body": {"type": "text"}}}},
                lambda r, e=None: box.append(1))
            wait(n0 + 1)
            c.ensure_green(tenant)
            for i in range(docs):
                n0 = len(box)
                client.index_doc(
                    tenant, f"d{i}",
                    {"body": "common " + " ".join(
                        f"w{int(x)}" for x in rng.integers(0, 8, 4))},
                    lambda r, e=None: box.append(1))
                wait(n0 + 1)
            n0 = len(box)
            client.refresh(tenant, lambda r, e=None: box.append(1))
            wait(n0 + 1)
            expected[tenant] = docs     # every doc carries "common"

        # the two-sided overload plane: coordinator admission pinned
        # tiny (saturation at test scale) + the shard-side member bound
        c.constrain_search_admission(*admission)
        n0 = len(box)
        client.cluster_update_settings(
            {"persistent":
             {"search.shard.max_queued_members": shard_bound}},
            lambda r, e=None: box.append(1))
        wait(n0 + 1)

        # victim: a holder of the HOT tenant's shard copies — slow for
        # the whole run (the ARS routing-around story). Its sibling
        # copy-holder gets slowed too for the first half of the hot
        # window (a noisy-neighbor wave): with BOTH copies slow under a
        # 10:1 flood, the shard-side member bound genuinely engages and
        # the shed -> failover -> backoff-retry loop is exercised, not
        # just reachable. Slowing drains is data-plane only, so master
        # or coordinator victims are fine; CRASH targets must be
        # non-master (membership stays stable) and non-coordinator (a
        # crashed coordinator strands its own in-flight responses on the
        # 60s transport timeout — a different scenario's problem).
        master_id = c.master().node_id
        state = c.nodes[coordinators[0]].coordinator.applied_state
        holders = [sr.node_id for sr in
                   state.routing_table.index(tenants[0]).shard_group(0)
                   if sr.node_id is not None]
        victim = holders[-1]
        hot_sibling = next((h for h in holders if h != victim), None)
        restartable = [nid for nid in c.nodes
                       if nid != master_id and nid != victim and
                       nid not in coordinators][:2]
        c.slow_node_drains(victim, slow_delay_s)

        harness = FleetTrafficHarness(c, tenants, coordinators, seed)

        # unloaded p99: sequential traffic against the SAME cluster,
        # slow node already slow — the bound the flood is judged by
        for k in range(3 * n_tenants):
            harness.submit_one(tenants[k % n_tenants],
                               coordinators[k % len(coordinators)],
                               {"query": {"match": {"body": "common"}},
                                "size": 5})
            c.run_until(
                lambda: all(r["t1"] is not None for r in harness.records),
                300.0)
        unloaded_p99 = _p99([r["t1"] - r["t0"] for r in harness.records
                             if r["err"] is None])
        harness.records.clear()
        harness._expected["n"] = 0

        # zipf-head duplicate flood (dup_head_fraction > 0): that share
        # of the HOT tenant's arrivals repeat one exact cached body —
        # primed through every coordinator ahead of the storm, so the
        # head rides the request-cache tiers (fused / intake / shard)
        # and never reaches the shard shed point, while the distinct
        # tail still overflows the same constrained admission plane
        body_fn = None
        head_flags: List[bool] = []
        cache_hits_before = 0
        if dup_head_fraction > 0:
            n0 = len(box)
            client.cluster_update_settings(
                {"persistent": {"search.request_cache.topk": True}},
                lambda r, e=None: box.append(1))
            wait(n0 + 1)
            hot_body = {"query": {"match": {"body": "common"}},
                        "size": 5, "request_cache": True,
                        "track_total_hits": True}
            for coord in coordinators:
                primed: List[Any] = []
                c.nodes[coord].client.search(
                    tenants[0], dict(hot_body),
                    lambda r, e=None: primed.append(1))
                c.run_until(lambda: bool(primed), 300.0)
            dup_rng = _random.Random(seed ^ 0xD0B)

            marker = {"n": 0}

            def body_fn(tenant: str) -> Dict[str, Any]:
                if tenant == tenants[0] and \
                        dup_rng.random() < dup_head_fraction:
                    head_flags.append(True)
                    return dict(hot_body)
                head_flags.append(False)
                # the tail is CACHE-PROOF (a unique marker term defeats
                # every cache tier): with topk caching on fleet-wide,
                # repeated tail bodies would otherwise be absorbed too
                # and the shed point would never be reached
                marker["n"] += 1
                return {"query": {"match": {
                    "body": f"common u{marker['n']}x{seed}"}},
                    "size": 5}
            cache_hits_before = _fleet_cache_hits(c)

        # per-(node, shard-copy) query counts before the flood: the ARS
        # routing-verdict baseline
        def copy_hits() -> Dict[Tuple[str, str], int]:
            out: Dict[Tuple[str, str], int] = {}
            for nid, node in c.nodes.items():
                for tenant in tenants:
                    if node.indices_service.has_shard(tenant, 0):
                        out[(nid, tenant)] = node.indices_service.shard(
                            tenant, 0).search_stats["query_total"]
            return out

        hits_before = copy_hits()
        fallbacks_before = dict(TELEMETRY.fallbacks)

        # rolling restart mid-peak: each restartable node vanishes from
        # the wire for a slice of the hot window, one after another —
        # and the hot tenant's SIBLING copy is slow for the window's
        # first half, so the flood meets two saturated copies at once
        # the hot window sits ON the second diurnal peak (shape() peaks
        # at 3·duration/4): the 10:1 flood, the rolling restart and the
        # noisy-neighbor wave all land where traffic is already densest
        events: List[Tuple[float, Callable[[], None]]] = []
        win0, win1 = 0.62 * duration_s, 0.9 * duration_s
        if hot_sibling is not None:
            events.append((win0, lambda: c.slow_node_drains(
                hot_sibling, slow_delay_s * 0.6)))
            events.append((win0 + 0.5 * (win1 - win0),
                           lambda: c.slow_node_drains(hot_sibling, 0.0)))
        slot = (win1 - win0) / max(len(restartable), 1) / 2.0
        for k, nid in enumerate(restartable):
            t_down = win0 + (2 * k) * slot
            t_up = t_down + slot
            events.append((t_down, lambda n=nid: c.crash_node(n)))
            events.append((t_up, lambda n=nid: c.restart_node(n)))

        harness.run(duration_s, total_searches, hot_tenant=tenants[0],
                    hot_window=(win0, win1), hot_factor=10.0,
                    events=events, body_fn=body_fn)
        summary = harness.summary()
        if dup_head_fraction > 0:
            # submit order == body_fn call order under the deterministic
            # scheduler, so head_flags aligns with harness.records
            from elasticsearch_tpu_torch.utils.errors import shard_busy_info
            head = [r for i, r in enumerate(harness.records)
                    if i < len(head_flags) and head_flags[i]]
            summary["dup_head"] = {
                "fraction": dup_head_fraction,
                "requests": len(head),
                "admitted": sum(1 for r in head if r["err"] is None),
                "shard_busy_failures": sum(
                    1 for r in head if r["err"] is not None and
                    (shard_busy_info(r["err"]) is not None or
                     "shard_busy" in str(r["err"]))),
                "cache_hits": _fleet_cache_hits(c) - cache_hits_before,
            }
        c.heal()
        c.slow_node_drains(victim, 0.0)

        # correctness probes (zero wrong hits): after the storm, every
        # tenant still answers the known-answer query exactly
        wrong_hits = 0
        for tenant in tenants:
            probe: List[Any] = []
            client.search(tenant, {
                "query": {"match": {"body": "common"}},
                "size": docs, "track_total_hits": True},
                lambda r, e=None: probe.append((r, e)))
            c.run_until(lambda: bool(probe), 300.0)
            resp, err = probe[0]
            if err is not None:
                wrong_hits += 1
                continue
            got = {h["_id"] for h in resp["hits"]["hits"]}
            want = {f"d{i}" for i in range(docs)}
            if got != want or \
                    resp["hits"]["total"]["value"] != expected[tenant]:
                wrong_hits += 1

        # shed / failover / routing accounting across the fleet
        hits_after = copy_hits()
        victim_hits = sum(n - hits_before.get(k, 0)
                          for k, n in hits_after.items()
                          if k[0] == victim)
        sibling_hits = sum(n - hits_before.get(k, 0)
                           for k, n in hits_after.items()
                           if k[0] != victim and
                           (victim, k[1]) in hits_after)
        sheds = sum(n.search_transport.batcher.stats["shard_busy_sheds"]
                    for n in c.nodes.values())
        hwm_over_bound = [
            (nid, n.search_transport.batcher.stats["queued_members_hwm"])
            for nid, n in c.nodes.items()
            if n.search_transport.batcher.stats["queued_members_hwm"]
            > shard_bound]
        failover = {k: sum(n.search_action.shard_busy_stats[k]
                           for n in c.nodes.values())
                    for k in ("sheds_seen", "failovers", "retry_rounds",
                              "all_copies_shed")}
        fallbacks_after = dict(TELEMETRY.fallbacks)
        fallback_deltas = {
            k: fallbacks_after.get(k, 0) - fallbacks_before.get(k, 0)
            for k in set(fallbacks_after) | set(fallbacks_before)
            if fallbacks_after.get(k, 0) != fallbacks_before.get(k, 0)}

        summary.update({
            "seed": seed,
            "tenants": n_tenants,
            "coordinators": len(coordinators),
            "victim": victim,
            "shard_bound": shard_bound,
            "unloaded_p99_s": unloaded_p99,
            "p99_factor_vs_unloaded": round(
                summary["admitted_p99_s"] / max(unloaded_p99, 1e-9), 2),
            "wrong_hits": wrong_hits,
            "shard_busy_sheds": sheds,
            "queued_hwm_over_bound": hwm_over_bound,
            "failover": failover,
            "victim_copy_hits": victim_hits,
            "sibling_copy_hits": sibling_hits,
            "fallback_deltas": fallback_deltas,
            "unknown_fallbacks": fallbacks_after.get("unknown", 0)
            - fallbacks_before.get("unknown", 0),
        })
        return summary
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# recovery-under-load chaos scenarios (ROADMAP: ops-based catch-up)
# ---------------------------------------------------------------------------

def _merged_recovery_stats(c: "InProcessCluster") -> Dict[str, Any]:
    """Fleet view of the reconcilers' recovery accounting — the same
    merge the ``_cluster/stats`` recovery section performs, fed straight
    from the node objects (no REST round-trip in a chaos assert path)."""
    from elasticsearch_tpu_torch import monitor
    from elasticsearch_tpu_torch.indices.cluster_state_service import (
        merge_recovery_sections)
    sections = []
    for node in c.nodes.values():
        try:
            sections.append(monitor.recovery_stats(
                node.reconciler, node.indices_service))
        except Exception:
            continue
    return merge_recovery_sections(sections)


def rolling_restart_recovery_scenario(seed: int, data_path: str, *,
                                      n_tenants: int = 3,
                                      n_nodes: int = 5, docs: int = 6,
                                      writes: int = 18,
                                      total_searches: int = 120,
                                      duration_s: float = 1.2
                                      ) -> Dict[str, Any]:
    """THE recovery tentpole scenario, one seed: a rolling restart of
    replica-holding nodes under live search + write traffic. Every
    restarted copy comes back with a fresh commit, a retained node-keyed
    retention lease on its primary, and complete op history from its
    local checkpoint — so every one of them must recover **ops-based**
    (replay the missed tail) or by segment reuse, never wipe-and-copy.

    Asserts per seed: zero ``peer`` (wipe) recoveries on restarted
    nodes, at least one ``ops_based`` catch-up, the typed file-fallback
    ``unknown`` bucket pinned at zero, no acked write lost, and the
    known-answer query exact after the storm. Returns the measured
    invariants; bench.py emits them as the ``recovery`` config line."""
    c = InProcessCluster(n_nodes=n_nodes, seed=seed, data_path=data_path)
    c.start()
    try:
        import numpy as np
        tenants = [f"t{i}" for i in range(n_tenants)]
        client = c.client()
        rng = np.random.default_rng(seed)
        box: List[Any] = []

        def wait(n: int) -> None:
            c.run_until(lambda: len(box) >= n, 300.0)

        for tenant in tenants:
            n0 = len(box)
            client.create_index(tenant, {
                "settings": {"number_of_shards": 1,
                             "number_of_replicas": 1},
                "mappings": {"properties": {"body": {"type": "text"}}}},
                lambda r, e=None: box.append(1))
            wait(n0 + 1)
            c.ensure_green(tenant)
            for i in range(docs):
                n0 = len(box)
                client.index_doc(
                    tenant, f"d{i}",
                    {"body": "common " + " ".join(
                        f"w{int(x)}" for x in rng.integers(0, 8, 4))},
                    lambda r, e=None: box.append(1))
                wait(n0 + 1)
            n0 = len(box)
            client.refresh(tenant, lambda r, e=None: box.append(1))
            wait(n0 + 1)
        # flush everywhere: every copy gets a hole-free commit carrying
        # the primary's retention leases — the restart's starting point
        n0 = len(box)
        client.flush("t*", lambda r, e=None: box.append(1))
        wait(n0 + 1)

        # reboot targets: nodes holding ONLY replica copies. Rebooting a
        # primary holder forces a term bump, and a copy committed under
        # the old term is *correctly* refused ops-based catch-up
        # (term_mismatch) — a different scenario. Master stays up so
        # membership churn doesn't stack on top of recovery.
        master_id = c.master().node_id
        state = c.master().coordinator.applied_state
        primary_nodes, copy_nodes = set(), set()
        for tenant in tenants:
            for sr in state.routing_table.index(tenant).shard_group(0):
                if sr.node_id is None:
                    continue
                copy_nodes.add(sr.node_id)
                if sr.primary:
                    primary_nodes.add(sr.node_id)
        reboot_targets = [nid for nid in c._node_ids
                          if nid in copy_nodes and
                          nid not in primary_nodes and
                          nid != master_id][:2]
        coordinators = [nid for nid in c._node_ids
                        if nid not in reboot_targets][:3]

        harness = FleetTrafficHarness(c, tenants, coordinators, seed)

        # live writes across the whole window: each reboot's downtime
        # overlaps acked writes, so returning replicas are genuinely
        # behind and must replay the tail (not just reuse segments)
        acked: Dict[str, set] = {t: set() for t in tenants}
        attempted: Dict[str, set] = {t: set() for t in tenants}
        writes_done = {"n": 0}
        writer = c.nodes[coordinators[0]].client

        def submit_write(k: int) -> None:
            tenant = tenants[k % n_tenants]
            doc_id = f"w{k}"
            attempted[tenant].add(doc_id)

            def on_write(r, e=None, t=tenant, d=doc_id) -> None:
                writes_done["n"] += 1
                if e is None:
                    acked[t].add(d)
            writer.index_doc(tenant, doc_id,
                             {"body": f"common live{k}"}, on_write)

        events: List[Tuple[float, Callable[[], None]]] = []
        for k in range(writes):
            events.append((duration_s * (0.05 + 0.9 * k / max(writes, 1)),
                           lambda kk=k: submit_write(kk)))
        # the rolling restart itself: full process reboots (in-memory
        # state gone, same data path), one node after another
        win0, win1 = 0.3 * duration_s, 0.85 * duration_s
        slot = (win1 - win0) / max(len(reboot_targets), 1)
        for k, nid in enumerate(reboot_targets):
            events.append((win0 + k * slot,
                           lambda n=nid: c.reboot_node(n)))

        harness.run(duration_s, total_searches, events=events)
        summary = harness.summary()
        restart_p99 = summary["admitted_p99_s"]

        # every write must RESOLVE before the post-run refresh, or the
        # last acks race the refresh broadcast and an acked-but-not-yet-
        # segmented doc reads as a false loss
        c.run_until(lambda: writes_done["n"] >= writes, 300.0)

        # let every recovery land, then judge. Routing-green is not
        # enough: after a fast reboot the master can still route a copy
        # STARTED at a node that hasn't rebuilt it locally (the
        # re-asserted shard-failed -> reassign -> recover cycle takes
        # failure-detection rounds of virtual time) — wait until every
        # STARTED copy really exists where it is routed.
        from elasticsearch_tpu_torch.cluster.routing import ShardState

        def settled() -> bool:
            master = c.master()
            if master is None:
                return False
            st = master.coordinator.applied_state
            for tenant in tenants:
                for sr in st.routing_table.index(tenant).shard_group(0):
                    if sr.state != ShardState.STARTED or \
                            sr.node_id not in c.nodes:
                        return False
                    if not c.nodes[sr.node_id].indices_service.has_shard(
                            tenant, 0):
                        return False
            return True
        c.run_until(settled, 900.0)
        for tenant in tenants:
            c.ensure_green(tenant, max_time=600.0)
        n0 = len(box)
        client.refresh("t*", lambda r, e=None: box.append(1))
        wait(n0 + 1)

        # per-restarted-node recovery kinds, from the fresh reconcilers
        restarted_kinds: Dict[str, List[str]] = {}
        wipe_recoveries = 0
        ops_based = 0
        ops_replayed = 0
        for nid in reboot_targets:
            log = c.nodes[nid].reconciler.recovery_log()
            kinds = [e["kind"] for e in log if e["index"] in tenants]
            restarted_kinds[nid] = kinds
            wipe_recoveries += sum(1 for k in kinds if k == "peer")
            ops_based += sum(1 for k in kinds if k == "ops_based")
            ops_replayed += sum(e.get("ops_replayed", 0) for e in log
                                if e["index"] in tenants)

        # zero lost acked docs + known-answer exactness per tenant
        lost_acked = 0
        wrong_hits = 0
        for tenant in tenants:
            probe: List[Any] = []
            client.search(tenant, {
                "query": {"match": {"body": "common"}},
                "size": docs + writes + 8, "track_total_hits": True},
                lambda r, e=None: probe.append((r, e)))
            c.run_until(lambda: bool(probe), 300.0)
            resp, err = probe[0]
            if err is not None:
                wrong_hits += 1
                continue
            got = {h["_id"] for h in resp["hits"]["hits"]}
            must = {f"d{i}" for i in range(docs)} | acked[tenant]
            may = must | attempted[tenant]
            lost_acked += len(must - got)
            if not got <= may:
                wrong_hits += 1

        fleet = _merged_recovery_stats(c)
        master_node = c.master()
        lease_covered = (master_node.gateway_allocator.stats.get(
            "lease_covered_allocations", 0) if master_node else 0)

        summary.update({
            "seed": seed,
            "rebooted": reboot_targets,
            "restarted_replica_kinds": restarted_kinds,
            "wipe_recoveries_on_restarted": wipe_recoveries,
            "ops_based_recoveries": ops_based,
            "ops_replayed_on_restarted": ops_replayed,
            "acked_writes": sum(len(s) for s in acked.values()),
            "lost_acked_docs": lost_acked,
            "wrong_hits": wrong_hits,
            "restart_p99_s": restart_p99,
            "fleet_recovery": fleet,
            "unknown_fallbacks": (fleet.get("file_fallback_reasons") or
                                  {}).get("unknown", 0),
            "lease_covered_allocations": lease_covered,
        })
        return summary
    finally:
        c.stop()


def failover_under_live_writes_scenario(seed: int, data_path: str, *,
                                        n_tenants: int = 3,
                                        n_nodes: int = 3, docs: int = 6,
                                        writes: int = 24,
                                        total_searches: int = 100,
                                        duration_s: float = 1.4
                                        ) -> Dict[str, Any]:
    """THE failover tentpole scenario, one seed: kill the node holding
    primaries mid-flood, with 2 replicas per shard so every node holds
    every copy. The master detects the death, promotes a surviving
    replica (term bump + tracker seeding + post-promotion resync), the
    other survivor rolls its deposed-term tail back to the global
    checkpoint and replays the new primacy's history, and the DEPOSED
    primary later reboots into a cross-term commit whose tail the new
    primary reconciles by rollback+replay — the ops path, not a wipe.

    Asserts per seed: zero lost acked docs, zero wrong hits, at least
    one resync ran (started or noop), the deposed copy rejoined without
    a ``peer`` wipe, and the typed fallback ``unknown`` bucket stays
    pinned at zero. Returns the measured invariants; bench.py emits
    them as the ``recovery`` config's failover line."""
    c = InProcessCluster(n_nodes=n_nodes, seed=seed, data_path=data_path)
    c.start()
    try:
        import numpy as np
        tenants = [f"t{i}" for i in range(n_tenants)]
        client = c.client()
        rng = np.random.default_rng(seed)
        box: List[Any] = []

        def wait(n: int) -> None:
            c.run_until(lambda: len(box) >= n, 300.0)

        for tenant in tenants:
            n0 = len(box)
            client.create_index(tenant, {
                "settings": {"number_of_shards": 1,
                             "number_of_replicas": n_nodes - 1},
                "mappings": {"properties": {"body": {"type": "text"}}}},
                lambda r, e=None: box.append(1))
            wait(n0 + 1)
            c.ensure_green(tenant)
            for i in range(docs):
                n0 = len(box)
                client.index_doc(
                    tenant, f"d{i}",
                    {"body": "common " + " ".join(
                        f"w{int(x)}" for x in rng.integers(0, 8, 4))},
                    lambda r, e=None: box.append(1))
                wait(n0 + 1)
            n0 = len(box)
            client.refresh(tenant, lambda r, e=None: box.append(1))
            wait(n0 + 1)
        # flush everywhere so every copy — including the one about to be
        # deposed — holds a commit with its learned global checkpoint:
        # the cross-term recovery gate keys on that persisted value
        n0 = len(box)
        client.flush("t*", lambda r, e=None: box.append(1))
        wait(n0 + 1)

        # the victim: a PRIMARY-holding node (prefer a non-master one so
        # the failover is a clean promotion, not promotion + election)
        master_id = c.master().node_id
        state = c.master().coordinator.applied_state
        primaries_on: Dict[str, int] = {}
        for tenant in tenants:
            for sr in state.routing_table.index(tenant).shard_group(0):
                if sr.primary and sr.node_id is not None:
                    primaries_on[sr.node_id] = \
                        primaries_on.get(sr.node_id, 0) + 1
        candidates = sorted(
            primaries_on, key=lambda n: (n == master_id,
                                         -primaries_on[n], n))
        victim = candidates[0]
        affected = [t for t in tenants
                    if state.routing_table.index(t).primary(0).node_id
                    == victim]

        coordinators = [nid for nid in c._node_ids if nid != victim][:2]
        harness = FleetTrafficHarness(c, tenants, coordinators, seed)

        # live writes across the whole window: some land before the
        # kill (and may sit unacked on the doomed primary), some hit
        # the promotion gap, some land on the new primacy
        acked: Dict[str, set] = {t: set() for t in tenants}
        attempted: Dict[str, set] = {t: set() for t in tenants}
        writes_done = {"n": 0}
        writer = c.nodes[coordinators[0]].client

        def submit_write(k: int) -> None:
            tenant = tenants[k % n_tenants]
            doc_id = f"w{k}"
            attempted[tenant].add(doc_id)

            def on_write(r, e=None, t=tenant, d=doc_id) -> None:
                writes_done["n"] += 1
                if e is None:
                    acked[t].add(d)
            writer.index_doc(tenant, doc_id,
                             {"body": f"common live{k}"}, on_write)

        events: List[Tuple[float, Callable[[], None]]] = []
        for k in range(writes):
            events.append((duration_s * (0.05 + 0.9 * k / max(writes, 1)),
                           lambda kk=k: submit_write(kk)))
        events.append((0.35 * duration_s, lambda: c.kill_node(victim)))

        harness.run(duration_s, total_searches, events=events)
        summary = harness.summary()

        c.run_until(lambda: writes_done["n"] >= writes, 300.0)

        # wait for the failover to actually land: every affected tenant
        # must have a STARTED primary on a SURVIVING node (the master's
        # failure detection + promotion takes fault-detection rounds of
        # virtual time — the victim stays down until this is proven)
        def promoted() -> bool:
            master = c.master()
            if master is None:
                return False
            st = master.coordinator.applied_state
            for tenant in affected:
                sr = st.routing_table.index(tenant).primary(0)
                sr_ok = sr.node_id is not None and sr.node_id != victim \
                    and sr.node_id in c.nodes and \
                    sr.state == ShardState.STARTED
                if not sr_ok:
                    return False
            return True
        from elasticsearch_tpu_torch.cluster.routing import ShardState
        c.run_until(promoted, 900.0)

        # writes into the NEW primacy: the deposed copy's commit is now
        # genuinely behind a different term's history, so its rejoin
        # must take the cross-term rollback+replay path, not reuse
        post_writes = max(4, writes // 4)
        for k in range(post_writes):
            submit_write(writes + k)
        c.run_until(lambda: writes_done["n"] >= writes + post_writes,
                    300.0)

        # the deposed primary reboots over its old data path
        fresh = c._build_node(victim)
        c.nodes[victim] = fresh
        fresh.start()

        # settle: every STARTED copy must really exist where routed —
        # including the deposed primary's rebuilt replica copy
        from elasticsearch_tpu_torch.cluster.routing import ShardState

        def settled() -> bool:
            master = c.master()
            if master is None:
                return False
            st = master.coordinator.applied_state
            for tenant in tenants:
                for sr in st.routing_table.index(tenant).shard_group(0):
                    if sr.state != ShardState.STARTED or \
                            sr.node_id not in c.nodes:
                        return False
                    if not c.nodes[sr.node_id].indices_service.has_shard(
                            tenant, 0):
                        return False
            return True
        c.run_until(settled, 900.0)
        for tenant in tenants:
            c.ensure_green(tenant, max_time=600.0)
        n0 = len(box)
        client.refresh("t*", lambda r, e=None: box.append(1))
        wait(n0 + 1)

        # how the deposed primary's copies came back (its fresh
        # reconciler's log): the cross-term gate must have reconciled
        # them ops-based (rollback+replay) or reused them — never wiped
        deposed_log = c.nodes[victim].reconciler.recovery_log()
        deposed_kinds = [e["kind"] for e in deposed_log
                         if e["index"] in tenants]
        deposed_wipes = sum(1 for k in deposed_kinds if k == "peer")
        deposed_ops_based = sum(1 for k in deposed_kinds
                                if k == "ops_based")

        # fleet resync + rollback accounting (riding _nodes/stats paths)
        resync = {"resyncs_started": 0, "resyncs_completed": 0,
                  "resyncs_noop": 0, "resync_failures": 0,
                  "resync_ops_sent": 0, "resync_ops_applied": 0,
                  "resync_targets": 0}
        for node in c.nodes.values():
            for key, n in node.reconciler.resyncer.stats.items():
                resync[key] = resync.get(key, 0) + n

        # zero lost acked docs + known-answer exactness per tenant
        lost_acked = 0
        wrong_hits = 0
        for tenant in tenants:
            probe: List[Any] = []
            client.search(tenant, {
                "query": {"match": {"body": "common"}},
                "size": docs + writes + 8, "track_total_hits": True},
                lambda r, e=None: probe.append((r, e)))
            c.run_until(lambda: bool(probe), 300.0)
            resp, err = probe[0]
            if err is not None:
                wrong_hits += 1
                continue
            got = {h["_id"] for h in resp["hits"]["hits"]}
            must = {f"d{i}" for i in range(docs)} | acked[tenant]
            may = must | attempted[tenant]
            lost_acked += len(must - got)
            if not got <= may:
                wrong_hits += 1

        fleet = _merged_recovery_stats(c)
        summary.update({
            "seed": seed,
            "victim": victim,
            "victim_was_master": victim == master_id,
            "affected_tenants": affected,
            "deposed_recovery_kinds": deposed_kinds,
            "deposed_wipe_recoveries": deposed_wipes,
            "deposed_ops_based": deposed_ops_based,
            "resync": resync,
            "rollbacks": fleet.get("rollbacks", 0),
            "ops_rolled_back": fleet.get("ops_rolled_back", 0),
            "acked_writes": sum(len(s) for s in acked.values()),
            "lost_acked_docs": lost_acked,
            "wrong_hits": wrong_hits,
            "fleet_recovery": fleet,
            "unknown_fallbacks": (fleet.get("file_fallback_reasons") or
                                  {}).get("unknown", 0),
        })
        return summary
    finally:
        c.stop()


def duplicate_flood_cache_shed_scenario(seed: int, *, n_tenants: int = 3,
                                        n_nodes: int = 5, docs: int = 8,
                                        hot_searches: int = 90,
                                        distinct_searches: int = 240,
                                        duration_s: float = 1.0,
                                        shard_bound: int = 2,
                                        slow_delay_s: float = 0.08,
                                        admission: Tuple[int, int] = (3, 10)
                                        ) -> Dict[str, Any]:
    """Shed plane × request cache composition, one seed: a zipf-style
    duplicate flood (one EXACT body repeated from every coordinator)
    must be absorbed by the two-tier request cache — hot head served
    from cache with ZERO sheds — while a second flood of all-distinct
    bodies (cache-proof) overflows the same constrained admission plane
    and is shed CLEANLY (429 + Retry-After, typed busy failover, no
    unclean rejection). The two planes must compose: caching absorbs
    duplicates without disabling shedding for the traffic it cannot
    absorb."""
    c = InProcessCluster(n_nodes=n_nodes, seed=seed)
    c.start()
    try:
        import numpy as np
        tenants = [f"t{i}" for i in range(n_tenants)]
        coordinators = [f"node{i}" for i in range(min(3, n_nodes))]
        client = c.client()
        rng = np.random.default_rng(seed)
        box: List[Any] = []

        def wait(n: int) -> None:
            c.run_until(lambda: len(box) >= n, 300.0)

        for tenant in tenants:
            n0 = len(box)
            client.create_index(tenant, {
                "settings": {"number_of_shards": 1,
                             "number_of_replicas": 1},
                "mappings": {"properties": {"body": {"type": "text"}}}},
                lambda r, e=None: box.append(1))
            wait(n0 + 1)
            c.ensure_green(tenant)
            for i in range(docs):
                n0 = len(box)
                client.index_doc(
                    tenant, f"d{i}",
                    {"body": "common " + " ".join(
                        f"w{int(x)}" for x in rng.integers(0, 8, 4))},
                    lambda r, e=None: box.append(1))
                wait(n0 + 1)
            n0 = len(box)
            client.refresh(tenant, lambda r, e=None: box.append(1))
            wait(n0 + 1)

        c.constrain_search_admission(*admission)
        n0 = len(box)
        client.cluster_update_settings(
            {"persistent":
             {"search.shard.max_queued_members": shard_bound,
              "search.request_cache.topk": True}},
            lambda r, e=None: box.append(1))
        wait(n0 + 1)

        # a slow holder of the hot tenant's shard, slow for BOTH phases:
        # the same saturated plane absorbs the duplicate flood through
        # the cache (zero sheds) and sheds the distinct flood cleanly —
        # the composition claim, not two unrelated configurations
        state = c.nodes[coordinators[0]].coordinator.applied_state
        holders = [sr.node_id for sr in
                   state.routing_table.index(tenants[0]).shard_group(0)
                   if sr.node_id is not None]
        victim = holders[-1]
        c.slow_node_drains(victim, slow_delay_s)

        def cache_counters() -> Dict[str, int]:
            shard_hits = intake_hits = fused_hits = sheds = 0
            for node in c.nodes.values():
                shard_hits += node.search_transport.request_cache.stats[
                    "hits"]
                intake_hits += node.search_transport.batcher.stats.get(
                    "request_cache_intake_hits", 0)
                fused = getattr(node.search_action, "fused_cache", None)
                if fused is not None:
                    fused_hits += fused.stats.get("hits", 0)
                sheds += node.search_transport.batcher.stats[
                    "shard_busy_sheds"]
            return {"shard_hits": shard_hits, "intake_hits": intake_hits,
                    "fused_hits": fused_hits, "sheds": sheds}

        hot_body = {"query": {"match": {"body": "common"}}, "size": 5,
                    "request_cache": True, "track_total_hits": True}

        # phase A — the duplicate flood: the same body, hammered from
        # every coordinator at a rate the constrained admission plane
        # could not possibly serve uncached
        before_a = cache_counters()
        harness = FleetTrafficHarness(c, tenants, coordinators, seed)
        harness.run(duration_s, hot_searches, hot_tenant=tenants[0],
                    hot_window=(0.2 * duration_s, 0.9 * duration_s),
                    hot_factor=10.0, body_fn=lambda t: dict(hot_body))
        summary_a = harness.summary()
        after_a = cache_counters()

        # phase B — the cache-proof flood: every body distinct (a unique
        # marker term defeats both cache tiers), same admission plane
        marker = {"n": 0}

        def distinct_body(tenant: str) -> Dict[str, Any]:
            marker["n"] += 1
            return {"query": {"match": {
                "body": f"common u{marker['n']}x{seed}"}},
                "size": 5, "request_cache": True}

        failover_before = {
            k: sum(n.search_action.shard_busy_stats[k]
                   for n in c.nodes.values())
            for k in ("sheds_seen", "failovers", "all_copies_shed")}
        harness_b = FleetTrafficHarness(c, tenants, coordinators,
                                        seed + 1)
        harness_b.run(duration_s, distinct_searches,
                      hot_tenant=tenants[0],
                      hot_window=(0.2 * duration_s, 0.9 * duration_s),
                      hot_factor=10.0, body_fn=distinct_body)
        summary_b = harness_b.summary()
        after_b = cache_counters()
        failover = {
            k: sum(n.search_action.shard_busy_stats[k]
                   for n in c.nodes.values()) - failover_before[k]
            for k in failover_before}
        c.slow_node_drains(victim, 0.0)

        # post-storm exactness
        wrong_hits = 0
        for tenant in tenants:
            probe: List[Any] = []
            client.search(tenant, {
                "query": {"match": {"body": "common"}},
                "size": docs, "track_total_hits": True},
                lambda r, e=None: probe.append((r, e)))
            c.run_until(lambda: bool(probe), 300.0)
            resp, err = probe[0]
            if err is not None or \
                    {h["_id"] for h in resp["hits"]["hits"]} != \
                    {f"d{i}" for i in range(docs)}:
                wrong_hits += 1

        return {
            "seed": seed,
            "victim": victim,
            "hot": summary_a,
            "distinct": summary_b,
            "distinct_failover": failover,
            "hot_cache_hits": (after_a["shard_hits"]
                               - before_a["shard_hits"]
                               + after_a["intake_hits"]
                               - before_a["intake_hits"]
                               + after_a["fused_hits"]
                               - before_a["fused_hits"]),
            "hot_sheds": after_a["sheds"] - before_a["sheds"],
            "distinct_sheds": after_b["sheds"] - after_a["sheds"],
            "distinct_clean_429": summary_b["rejected_clean_429"],
            "distinct_unclean": summary_b["unclean_rejections"],
            "wrong_hits": wrong_hits,
        }
    finally:
        c.stop()


def disk_full_mid_flush_scenario(seed: int, data_path: str, *,
                                 n_nodes: int = 5, docs: int = 8,
                                 total_searches: int = 100,
                                 duration_s: float = 1.0
                                 ) -> Dict[str, Any]:
    """Disk-full mid-flush under live traffic, one seed: ENOSPC is armed
    on the primary holder's data path in the middle of the run, then a
    flush lands on it — the commit write faults, the engine fails
    tragically with a typed reason, the shard is failed to the master,
    and the surviving replica is promoted and keeps serving. Asserts:
    the failure reason is typed (flush + disk-full), at least one
    injected I/O error actually fired, searches stay exact (zero wrong
    hits), and the cluster returns to green once the disk 'recovers'
    (fault disarmed)."""
    c = InProcessCluster(n_nodes=n_nodes, seed=seed, data_path=data_path)
    c.start()
    try:
        import numpy as np
        tenant = "t0"
        client = c.client()
        rng = np.random.default_rng(seed)
        box: List[Any] = []

        def wait(n: int) -> None:
            c.run_until(lambda: len(box) >= n, 300.0)

        n0 = len(box)
        client.create_index(tenant, {
            "settings": {"number_of_shards": 1,
                         "number_of_replicas": 1},
            "mappings": {"properties": {"body": {"type": "text"}}}},
            lambda r, e=None: box.append(1))
        wait(n0 + 1)
        c.ensure_green(tenant)
        for i in range(docs):
            n0 = len(box)
            client.index_doc(
                tenant, f"d{i}",
                {"body": "common " + " ".join(
                    f"w{int(x)}" for x in rng.integers(0, 8, 4))},
                lambda r, e=None: box.append(1))
            wait(n0 + 1)
        n0 = len(box)
        client.refresh(tenant, lambda r, e=None: box.append(1))
        wait(n0 + 1)

        master_id = c.master().node_id
        state = c.master().coordinator.applied_state
        group = state.routing_table.index(tenant).shard_group(0)
        victim = next(sr.node_id for sr in group if sr.primary)
        survivor = next(sr.node_id for sr in group
                        if not sr.primary and sr.node_id is not None)
        coordinators = [nid for nid in c._node_ids
                        if nid not in (victim,)][:3]
        victim_shard = c.nodes[victim].indices_service.shard(tenant, 0)
        victim_engine = victim_shard.engine

        io_before = c.disk_io.stats["io_errors"]
        captured: Dict[str, Any] = {"reason": None, "rule": None}

        def arm_and_flush() -> None:
            # the disk fills exactly as the commit write starts: armed
            # write-path ENOSPC on the victim's data path only (translog
            # appends keep succeeding — acks don't fault, the commit does)
            captured["rule"] = c.disk_io.arm(
                "enospc", match=f"/{victim}/", op="write")
            client.flush(tenant, lambda r, e=None: None)

        def capture_and_heal() -> None:
            captured["reason"] = victim_engine.failure_reason
            c.disk_io.disarm(captured["rule"])

        events: List[Tuple[float, Callable[[], None]]] = [
            (0.4 * duration_s, arm_and_flush),
            (0.85 * duration_s, capture_and_heal),
        ]

        harness = FleetTrafficHarness(c, [tenant], coordinators, seed)
        harness.run(duration_s, total_searches, events=events)
        summary = harness.summary()
        if captured["reason"] is None:     # flush landed after the probe
            captured["reason"] = victim_engine.failure_reason
        c.disk_io.disarm()

        # the failed primary's copy is gone from the group; the survivor
        # must now hold the primary and the answer must be exact
        c.ensure_yellow(tenant, max_time=600.0)
        probe: List[Any] = []
        client.search(tenant, {
            "query": {"match": {"body": "common"}},
            "size": docs, "track_total_hits": True},
            lambda r, e=None: probe.append((r, e)))
        c.run_until(lambda: bool(probe), 300.0)
        resp, err = probe[0]
        wrong_hits = 0
        if err is not None or \
                {h["_id"] for h in resp["hits"]["hits"]} != \
                {f"d{i}" for i in range(docs)} or \
                resp["hits"]["total"]["value"] != docs:
            wrong_hits += 1

        # disk 'replaced': the copy comes back and the index goes green
        c.ensure_green(tenant, max_time=600.0)
        promoted = next(
            sr.node_id for sr in c.master().coordinator.applied_state
            .routing_table.index(tenant).shard_group(0) if sr.primary)

        summary.update({
            "seed": seed,
            "victim": victim,
            "survivor": survivor,
            "master": master_id,
            "promoted_primary": promoted,
            "failure_reason": captured["reason"],
            "typed_failure": bool(
                captured["reason"] and
                "flush failed" in captured["reason"] and
                "disk-full" in captured["reason"]),
            "injected_io_errors": c.disk_io.stats["io_errors"]
            - io_before,
            "wrong_hits": wrong_hits,
        })
        return summary
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# mixed read/write workload under chaos (write-path pressure plane)
# ---------------------------------------------------------------------------

def _merged_indexing_pressure(c: "InProcessCluster") -> Dict[str, Any]:
    """Fleet view of the three-stage write-pressure accounting — the
    same merge the ``_cluster/stats`` indexing_pressure section performs,
    fed straight from the node objects (no REST round-trip in a chaos
    assert path)."""
    from elasticsearch_tpu_torch.utils.threadpool import (
        merge_indexing_pressure_sections)
    return merge_indexing_pressure_sections(
        [n.thread_pool.indexing_pressure.stats()
         for n in c.nodes.values()])


def mixed_read_write_scenario(seed: int, data_path: str, *,
                              n_tenants: int = 3, n_nodes: int = 5,
                              docs: int = 6,
                              write_bursts: int = 8,
                              bulks_per_burst: int = 10,
                              items_per_bulk: int = 3,
                              pressure_limit: int = 700,
                              total_searches: int = 100,
                              duration_s: float = 1.4,
                              slow_delay_s: float = 0.004
                              ) -> Dict[str, Any]:
    """THE write-path pressure tentpole scenario, one seed: a live bulk
    flood offered ~10:1 over the shrunken ``indexing_pressure.memory.
    limit`` (each burst's bytes are ~10x what admission can hold in
    flight), concurrent multi-coordinator search traffic, a slow-disk
    victim whose translog appends charge real virtual-time latency
    (FaultyDiskIO 'slow'), and a rolling restart of a replica-holding
    node mid-ingest.

    Asserts per seed (the chaos suite and bench judge these): zero
    acked docs lost, zero wrong hits, every write shed a CLEAN typed
    ``es_rejected_execution_exception`` 429 with a computed Retry-After,
    the per-stage rejection ``unknown`` bucket pinned at zero, admitted
    search p99 bounded vs the unloaded baseline, and ingest goodput
    preserved (accepted bulks keep landing through the whole storm).
    Returns the measured invariants; bench.py emits them as the
    ``mixed_rw`` config line."""
    c = InProcessCluster(n_nodes=n_nodes, seed=seed, data_path=data_path)
    c.start()
    try:
        import numpy as np
        tenants = [f"t{i}" for i in range(n_tenants)]
        client = c.client()
        rng = np.random.default_rng(seed)
        box: List[Any] = []

        def wait(n: int) -> None:
            c.run_until(lambda: len(box) >= n, 300.0)

        for tenant in tenants:
            n0 = len(box)
            client.create_index(tenant, {
                "settings": {"number_of_shards": 1,
                             "number_of_replicas": 1},
                "mappings": {"properties": {"body": {"type": "text"}}}},
                lambda r, e=None: box.append(1))
            wait(n0 + 1)
            c.ensure_green(tenant)
            for i in range(docs):
                n0 = len(box)
                client.index_doc(
                    tenant, f"d{i}",
                    {"body": "common " + " ".join(
                        f"w{int(x)}" for x in rng.integers(0, 8, 4))},
                    lambda r, e=None: box.append(1))
                wait(n0 + 1)
            n0 = len(box)
            client.refresh(tenant, lambda r, e=None: box.append(1))
            wait(n0 + 1)

        # chaos cast: the slow-disk victim holds a replica (so fan-out
        # crosses its degraded translog); the reboot target is another
        # replica-only holder; master and both stay out of the
        # coordinator set so in-flight searches aren't stranded
        master_id = c.master().node_id
        state = c.master().coordinator.applied_state
        primary_nodes, copy_nodes = set(), set()
        for tenant in tenants:
            for sr in state.routing_table.index(tenant).shard_group(0):
                if sr.node_id is None:
                    continue
                copy_nodes.add(sr.node_id)
                if sr.primary:
                    primary_nodes.add(sr.node_id)
        replica_only = [nid for nid in c._node_ids
                        if nid in copy_nodes and
                        nid not in primary_nodes and nid != master_id]
        slow_victim = replica_only[0] if replica_only else None
        reboot_target = replica_only[1] if len(replica_only) > 1 else None
        coordinators = [nid for nid in c._node_ids
                        if nid != reboot_target][:3]
        writer = c.nodes[coordinators[0]].client

        # slow disk armed for the WHOLE run, baseline included — the
        # bound the flood is judged by already contains the brownout
        # (the fleet_overload_scenario precedent)
        slow_rule = None
        if slow_victim is not None:
            slow_rule = c.disk_io.arm("slow", match=f"/{slow_victim}/",
                                      op="append", delay_s=slow_delay_s)
        slow_before = c.disk_io.stats["slow_ops"]

        # the write-pressure plane shrunk to test scale through the
        # DYNAMIC setting (the satellite under test): one burst offers
        # bulks_per_burst x ~bulk_bytes against this in-flight budget
        n0 = len(box)
        client.cluster_update_settings(
            {"persistent":
             {"indexing_pressure.memory.limit": str(pressure_limit)}},
            lambda r, e=None: box.append(1))
        wait(n0 + 1)

        harness = FleetTrafficHarness(c, tenants, coordinators, seed)

        # unloaded p99: sequential searches against the same (already
        # slow-disked) cluster, each alongside one small live write so
        # the baseline absorbs representative disk-latency charges
        for k in range(3 * n_tenants):
            writer.bulk([{"action": "index",
                          "index": tenants[k % n_tenants],
                          "id": f"base{k}",
                          "source": {"body": f"common base{k}"}}],
                        lambda r, e=None: None)
            harness.submit_one(tenants[k % n_tenants],
                               coordinators[k % len(coordinators)],
                               {"query": {"match": {"body": "common"}},
                                "size": 5})
            c.run_until(
                lambda: all(r["t1"] is not None for r in harness.records),
                300.0)
        unloaded_p99 = _p99([r["t1"] - r["t0"] for r in harness.records
                             if r["err"] is None])
        harness.records.clear()
        harness._expected["n"] = 0

        # the live bulk flood: each burst submits its bulks back-to-back
        # (their coordinating charges overlap by construction), offered
        # bytes per burst ~= bulks_per_burst x bulk_bytes >> limit
        acked: Dict[str, set] = {t: set() for t in tenants}
        attempted: Dict[str, set] = {t: set() for t in tenants}
        writes_done = {"n": 0}
        shed_records: List[Dict[str, Any]] = []
        total_bulks = write_bursts * bulks_per_burst

        def classify(resp: Dict[str, Any], tenant: str) -> None:
            writes_done["n"] += 1
            for wrapped in resp.get("items", []):
                result = next(iter(wrapped.values()))
                doc_id = result.get("id") or result.get("_id")
                if "error" not in result:
                    if doc_id is not None:
                        acked[tenant].add(doc_id)
                    continue
                if result.get("status") == 429:
                    err = result["error"]
                    shed_records.append({
                        "type": err.get("type"),
                        "retry_after": err.get("retry_after"),
                        "clean": bool(
                            err.get("type") ==
                            "es_rejected_execution_exception" and
                            int(err.get("retry_after") or 0) >= 1)})

        def submit_bulk(burst: int, b: int) -> None:
            tenant = tenants[(burst * bulks_per_burst + b) % n_tenants]
            items = []
            for i in range(items_per_bulk):
                doc_id = f"w{burst}_{b}_{i}"
                attempted[tenant].add(doc_id)
                items.append({"action": "index", "index": tenant,
                              "id": doc_id,
                              "source": {"body": f"common live{burst}"}})
            writer.bulk(items,
                        lambda r, e=None, t=tenant: classify(r or {}, t))

        events: List[Tuple[float, Callable[[], None]]] = []
        for burst in range(write_bursts):
            t = duration_s * (0.15 + 0.75 * burst / max(write_bursts, 1))
            events.append((t, lambda bb=burst: [
                submit_bulk(bb, b) for b in range(bulks_per_burst)]))
        # rolling restart mid-ingest: a replica holder reboots while
        # acked writes are still landing — returning copies must catch
        # up (and replica-stage pressure retries must never turn a
        # transient reject into a lost ack)
        if reboot_target is not None:
            events.append((0.55 * duration_s,
                           lambda: c.reboot_node(reboot_target)))

        harness.run(duration_s, total_searches, hot_tenant=tenants[0],
                    hot_window=(0.3 * duration_s, 0.8 * duration_s),
                    hot_factor=4.0, events=events)
        summary = harness.summary()

        # every bulk must resolve (replica-pressure retries can run past
        # the traffic window) before the flood is judged
        c.run_until(lambda: writes_done["n"] >= total_bulks, 900.0)
        if slow_rule is not None:
            c.disk_io.disarm(slow_rule)

        # let the rebooted copy land where it is routed, then refresh
        from elasticsearch_tpu_torch.cluster.routing import ShardState

        def settled() -> bool:
            master = c.master()
            if master is None:
                return False
            st = master.coordinator.applied_state
            for tenant in tenants:
                for sr in st.routing_table.index(tenant).shard_group(0):
                    if sr.state != ShardState.STARTED or \
                            sr.node_id not in c.nodes:
                        return False
                    if not c.nodes[sr.node_id].indices_service.has_shard(
                            tenant, 0):
                        return False
            return True
        c.run_until(settled, 900.0)
        for tenant in tenants:
            c.ensure_green(tenant, max_time=600.0)
        n0 = len(box)
        client.refresh("t*", lambda r, e=None: box.append(1))
        wait(n0 + 1)

        # zero lost acked docs + zero wrong hits, per tenant: everything
        # acked (plus the seed docs and baseline writes) must be found,
        # nothing outside attempted∪acked may appear
        lost_acked = 0
        wrong_hits = 0
        size = docs + 3 * n_tenants + \
            write_bursts * bulks_per_burst * items_per_bulk + 8
        for tenant in tenants:
            probe: List[Any] = []
            client.search(tenant, {
                "query": {"match": {"body": "common"}},
                "size": size, "track_total_hits": True},
                lambda r, e=None: probe.append((r, e)))
            c.run_until(lambda: bool(probe), 300.0)
            resp, err = probe[0]
            if err is not None:
                wrong_hits += 1
                continue
            got = {h["_id"] for h in resp["hits"]["hits"]}
            must = {f"d{i}" for i in range(docs)} | acked[tenant]
            may = must | attempted[tenant] | \
                {f"base{k}" for k in range(3 * n_tenants)}
            lost_acked += len(must - got)
            if not got <= may:
                wrong_hits += 1

        ip = _merged_indexing_pressure(c)
        replica_retries = {
            k: sum(n.shard_bulk.write_pressure_stats.get(k, 0)
                   for n in c.nodes.values())
            for k in ("replica_pressure_rejections",
                      "replica_pressure_recoveries",
                      "replica_pressure_exhausted")}
        acked_docs = sum(len(s) for s in acked.values())
        attempted_docs = sum(len(s) for s in attempted.values())

        summary.update({
            "seed": seed,
            "slow_victim": slow_victim,
            "reboot_target": reboot_target,
            "pressure_limit": pressure_limit,
            "unloaded_p99_s": unloaded_p99,
            "p99_factor_vs_unloaded": round(
                summary["admitted_p99_s"] / max(unloaded_p99, 1e-9), 2),
            "wrong_hits": wrong_hits,
            "lost_acked_docs": lost_acked,
            "acked_docs": acked_docs,
            "attempted_docs": attempted_docs,
            "write_goodput_fraction": round(
                acked_docs / max(attempted_docs, 1), 3),
            "write_sheds": len(shed_records),
            "clean_write_sheds": sum(
                1 for s in shed_records if s["clean"]),
            "unclean_write_sheds": sum(
                1 for s in shed_records if not s["clean"]),
            "slow_ops": c.disk_io.stats["slow_ops"] - slow_before,
            "indexing_pressure": ip,
            "unknown_stage_rejections":
                (ip.get("rejections") or {}).get("unknown", 0),
            "replica_retries": replica_retries,
        })
        return summary
    finally:
        c.stop()
