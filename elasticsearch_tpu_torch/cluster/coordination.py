"""Raft-like cluster coordination: elections + 2-phase state publication.

Reference: cluster/coordination/Coordinator.java:95 (modes CANDIDATE/LEADER/
FOLLOWER), CoordinationState.java:38 (the TLA+-modeled safety core),
PublicationTransportHandler.java:89 (diff-or-full publication),
FollowersChecker.java:64 / LeaderChecker.java:62 (failure detection),
ElectionSchedulerFactory.java:47 (randomized backoff).

Split mirrors the reference: ``CoordinationState`` holds the pure safety
rules (term bumps, join votes with freshness checks, accept/commit quorums)
and owns all persistent state; ``Coordinator`` drives it over the transport
with timers. Safety argument (Raft's): election and publish quorums are
both majorities of the voting config, so they intersect; a joiner with
fresher accepted state than the candidate refuses to vote, hence any winner
has every committed state.

The whole module is scheduler-driven, so the deterministic simulation in
tests/test_coordination.py runs real Coordinators through partitions with
virtual time (AbstractCoordinatorTestCase.java:143 analog).
"""

from __future__ import annotations

import logging
import random as random_mod
import uuid as uuid_mod
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from elasticsearch_tpu_torch.cluster.state import ClusterState, DiscoveryNode
from elasticsearch_tpu_torch.cluster.state import IncompatibleClusterStateError
from elasticsearch_tpu_torch.transport.scheduler import Cancellable, Scheduler
from elasticsearch_tpu_torch.transport.transport import TransportService
from elasticsearch_tpu_torch.utils.errors import NotMasterError

logger = logging.getLogger(__name__)


# transport action names (reference registers these in Coordinator's ctor)
PRE_VOTE = "coordination/pre_vote"
START_JOIN = "coordination/start_join"
PUBLISH = "coordination/publish"
COMMIT = "coordination/commit"
FOLLOWER_CHECK = "coordination/follower_check"
NODE_JOIN = "coordination/node_join"


class Mode:
    CANDIDATE = "CANDIDATE"
    LEADER = "LEADER"
    FOLLOWER = "FOLLOWER"


def is_quorum(votes: Set[str], voting_config: Set[str]) -> bool:
    return len(votes & voting_config) * 2 > len(voting_config)


@dataclass
class PersistedState:
    """What must survive restart (gateway/GatewayMetaState.java:79 analog;
    disk persistence is wired in via the gateway module)."""
    current_term: int = 0
    accepted_state: ClusterState = field(default_factory=ClusterState)
    # (term, version) of the newest accepted state; accepted_state.term is
    # the MASTER term the state was published in — identical here.


class CoordinationState:
    """Pure consensus rules. No I/O, no timers — every method is a
    transition that either mutates persistent state and returns a message
    to send, or raises. (CoordinationState.java:38 analog.)"""

    def __init__(self, node_id: str, persisted: PersistedState):
        self.node_id = node_id
        self.persisted = persisted
        # volatile (reset on restart)
        self.join_votes: Set[str] = set()
        self.election_won = False
        self.publish_votes: Set[str] = set()
        self.last_published: Optional[Tuple[int, int]] = None  # (term, version)

    # -- accessors -----------------------------------------------------------

    @property
    def current_term(self) -> int:
        return self.persisted.current_term

    @property
    def accepted(self) -> ClusterState:
        return self.persisted.accepted_state

    def is_fresher_or_equal(self, term: int, version: int) -> bool:
        """Is OUR accepted state at least as fresh as (term, version)?"""
        ours = (self.accepted.term, self.accepted.version)
        return ours >= (term, version)

    # -- term bumps + votes ---------------------------------------------------

    def handle_start_join(self, candidate_id: str, new_term: int
                          ) -> Dict[str, Any]:
        """A candidate asks us to move to new_term and vote for it. One vote
        per term (Raft): moving to the term IS casting the vote."""
        if new_term <= self.current_term:
            raise CoordinationError(
                f"start_join term {new_term} <= current {self.current_term}")
        self.persisted.current_term = new_term
        self.join_votes = set()
        self.election_won = False
        self.publish_votes = set()
        return {"term": new_term, "voter": self.node_id,
                "last_accepted_term": self.accepted.term,
                "last_accepted_version": self.accepted.version}

    def handle_join(self, join: Dict[str, Any]) -> bool:
        """Count a vote. Returns True if this join wins the election.
        Rejects votes from nodes with FRESHER state than ours — the
        freshness half of the safety argument."""
        if join["term"] != self.current_term:
            raise CoordinationError(
                f"join term {join['term']} != current {self.current_term}")
        if (join["last_accepted_term"], join["last_accepted_version"]) > \
                (self.accepted.term, self.accepted.version):
            raise CoordinationError(
                "joiner has fresher accepted state than candidate")
        self.join_votes.add(join["voter"])
        won_now = (not self.election_won and
                   is_quorum(self.join_votes, set(self.accepted.voting_config)))
        if won_now:
            self.election_won = True
        return won_now

    # -- publication ----------------------------------------------------------

    def handle_client_value(self, state: ClusterState) -> Dict[str, Any]:
        """Leader: stamp a new state for publication in our term."""
        if not self.election_won:
            raise NotMasterError("not elected")
        if state.version <= self.accepted.version:
            raise CoordinationError(
                f"new version {state.version} <= accepted "
                f"{self.accepted.version}")
        from dataclasses import replace
        state = replace(state, term=self.current_term)
        self.publish_votes = set()
        self.last_published = (state.term, state.version)
        return {"term": self.current_term, "state": state}

    def handle_publish_request(self, term: int, state: ClusterState
                               ) -> Dict[str, Any]:
        """Accept iff it's for our current term and strictly newer than our
        accepted state. Persists before acking (the 'accepted' phase)."""
        if term != self.current_term:
            raise CoordinationError(
                f"publish term {term} != current {self.current_term}")
        incoming = (state.term, state.version)
        ours = (self.accepted.term, self.accepted.version)
        if incoming <= ours:
            raise CoordinationError(
                f"publish {incoming} not newer than accepted {ours}")
        self.persisted.accepted_state = state
        return {"term": term, "version": state.version,
                "voter": self.node_id}

    def handle_publish_response(self, resp: Dict[str, Any]) -> bool:
        """Leader: count an ack; True when the quorum commits (term,version)."""
        if (resp["term"], resp["version"]) != self.last_published:
            return False
        self.publish_votes.add(resp["voter"])
        return is_quorum(self.publish_votes,
                         set(self.accepted.voting_config))

    def handle_commit(self, term: int, version: int) -> ClusterState:
        """Mark the accepted state committed; returns it for applying."""
        if term != self.current_term or \
                (self.accepted.term, self.accepted.version) != (term, version):
            raise CoordinationError(
                f"commit ({term},{version}) does not match accepted "
                f"({self.accepted.term},{self.accepted.version})")
        return self.accepted


class CoordinationError(Exception):
    pass


@dataclass
class CoordinatorSettings:
    election_initial_timeout: float = 0.1     # first election randomized in (0, t]
    election_backoff: float = 0.1             # added per failed attempt
    election_max_timeout: float = 10.0
    heartbeat_interval: float = 1.0           # leader -> follower checks
    follower_timeout: float = 3.0             # follower: no check => candidate
    publish_timeout: float = 30.0


class Coordinator:
    """Drives CoordinationState over the transport with timers.

    Lifecycle: start() as CANDIDATE -> randomized election -> LEADER (wins)
    or FOLLOWER (someone else's publish arrives). The elected leader also
    runs the MasterService role: submit_state_update() queues single-file
    batched updates executed + published one at a time
    (cluster/service/MasterService.java:73 analog).
    """

    def __init__(self, node: DiscoveryNode, transport_service: TransportService,
                 scheduler: Scheduler, initial_state: ClusterState,
                 settings: Optional[CoordinatorSettings] = None,
                 rng: Optional[random_mod.Random] = None,
                 on_committed: Optional[Callable[[ClusterState], None]] = None,
                 seed_peers: Optional[List[str]] = None,
                 persisted_state: Optional[PersistedState] = None):
        self.node = node
        self.ts = transport_service
        self.scheduler = scheduler
        self.settings = settings or CoordinatorSettings()
        # stable across processes: hash() of str is randomized per process
        # (PYTHONHASHSEED), which silently destroyed cross-run determinism
        self.rng = rng or random_mod.Random(
            zlib.crc32(node.node_id.encode()) & 0xFFFF)
        persisted = persisted_state if persisted_state is not None \
            else PersistedState(accepted_state=initial_state)
        self.state = CoordinationState(node.node_id, persisted)
        self.mode = Mode.CANDIDATE
        self.leader_id: Optional[str] = None
        self.applied_state: ClusterState = persisted.accepted_state
        self.on_committed = on_committed
        self._election_attempts = 0
        self._election_timer: Optional[Cancellable] = None
        self._heartbeat_timer: Optional[Cancellable] = None
        self._follower_timer: Optional[Cancellable] = None
        self._publishing = False
        self._update_queue: List[Tuple[str, Callable[[ClusterState], ClusterState],
                                       Callable[[Optional[Exception]], None]]] = []
        self._started = False
        # seed peers: always-probeable addresses (discovery/PeerFinder.java:55
        # probes seed hosts precisely so a node whose accepted membership
        # view is stale/shrunken can still find the quorum)
        self.seed_peers = list(seed_peers or [])
        self._join_nodes: Dict[str, Dict[str, Any]] = {}
        self._inflight_update: Optional[
            Tuple[int, Callable[[Optional[Exception]], None], str]] = None

        for action, handler in [
            (PRE_VOTE, self._on_pre_vote),
            (START_JOIN, self._on_start_join),
            (PUBLISH, self._on_publish),
            (COMMIT, self._on_commit),
            (FOLLOWER_CHECK, self._on_follower_check),
            (NODE_JOIN, self._on_node_join),
        ]:
            self.ts.register_handler(action, handler)
        self._missed_checks: Dict[str, int] = {}

    # -- helpers --------------------------------------------------------------

    def _peers(self) -> List[str]:
        """Master-eligible peers: last accepted membership UNION seed peers
        (the accepted view alone can be shrunken after partitions)."""
        peers = set(self.state.accepted.master_eligible_nodes())
        peers.update(self.seed_peers)
        peers.discard(self.node.node_id)
        return sorted(peers)

    def _voting_config(self) -> Set[str]:
        return set(self.state.accepted.voting_config)

    def _cancel(self, *timers: str) -> None:
        for name in timers:
            t = getattr(self, name)
            if t is not None:
                t.cancel()
                setattr(self, name, None)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._started = True
        self._become_candidate("started")

    def stop(self) -> None:
        self._started = False
        self._cancel("_election_timer", "_heartbeat_timer", "_follower_timer")

    def _become_candidate(self, reason: str) -> None:
        self.mode = Mode.CANDIDATE
        self.leader_id = None
        self._publishing = False
        self._cancel("_heartbeat_timer", "_follower_timer")
        self._fail_queued_updates(NotMasterError(f"stepped down: {reason}"))
        self._schedule_election()

    def _become_leader(self) -> None:
        self.mode = Mode.LEADER
        self.leader_id = self.node.node_id
        self._cancel("_election_timer", "_follower_timer")
        self._election_attempts = 0
        self._start_heartbeats()
        # republish the accepted state under our new term so it commits
        # (Zen2: the winner's first publication carries its freshest state),
        # folding every voter back into membership — joins ARE node-joins
        # (JoinTaskExecutor analog); a prior partition may have shrunk the
        # accepted membership view
        base = self.state.accepted
        nodes = dict(base.nodes)
        nodes[self.node.node_id] = self.node
        for voter in self.state.join_votes:
            if voter not in nodes:
                info = self._join_nodes.get(voter)
                if info:
                    nodes[voter] = DiscoveryNode.from_dict(info)
        new_state = base.with_nodes(nodes, self.node.node_id)
        self._publish(new_state)

    def _become_follower(self, leader_id: str) -> None:
        if self.mode != Mode.FOLLOWER or self.leader_id != leader_id:
            self.mode = Mode.FOLLOWER
            self.leader_id = leader_id
            self._cancel("_election_timer", "_heartbeat_timer")
            self._fail_queued_updates(NotMasterError("following " + leader_id))
            self._election_attempts = 0
        self._reset_follower_timer()

    # -- elections ------------------------------------------------------------

    def _schedule_election(self) -> None:
        if not self._started:
            return
        self._cancel("_election_timer")
        upper = min(self.settings.election_initial_timeout +
                    self._election_attempts * self.settings.election_backoff,
                    self.settings.election_max_timeout)
        delay = self.rng.uniform(0, upper) if upper > 0 else 0.0
        self._election_timer = self.scheduler.schedule(delay, self._run_election)

    def _run_election(self) -> None:
        if self.mode != Mode.CANDIDATE or not self._started:
            return
        self._election_attempts += 1
        self._schedule_election()          # retry backoff if this one stalls
        # pre-vote round: don't bump terms unless a quorum would follow us
        # (PreVoteCollector analog — avoids term inflation from isolated nodes)
        votes: Set[str] = set()
        responded = {"done": False}
        req = {"term": self.state.current_term,
               "last_accepted_term": self.state.accepted.term,
               "last_accepted_version": self.state.accepted.version}

        def on_pre_vote(from_id: str, resp, err) -> None:
            if responded["done"] or err is not None or resp is None:
                return
            if not resp.get("grant"):
                # peer follows a live leader — (re)join through it instead of
                # fighting the election (PeerFinder-discovers-master analog).
                # Idempotent if we're already a member: the leader's add()
                # no-ops. Our own membership view may be stale, so don't
                # consult it.
                leader = resp.get("leader")
                if leader and leader != self.node.node_id and \
                        self.mode == Mode.CANDIDATE:
                    self._request_node_join(leader)
                return
            votes.add(from_id)
            if is_quorum(votes, self._voting_config()):
                responded["done"] = True
                self._start_real_election()

        self._on_pre_vote_local(votes)
        if is_quorum(votes, self._voting_config()):
            self._start_real_election()
            return
        for peer in self._peers():
            self.ts.send_request(
                peer, PRE_VOTE, req,
                lambda r, e, p=peer: on_pre_vote(p, r, e), timeout=1.0)

    def _on_pre_vote_local(self, votes: Set[str]) -> None:
        votes.add(self.node.node_id)

    def _start_real_election(self) -> None:
        if self.mode != Mode.CANDIDATE:
            return
        new_term = self.state.current_term + 1
        for peer in [self.node.node_id] + self._peers():
            self.ts.send_request(
                peer, START_JOIN,
                {"candidate": self.node.node_id, "term": new_term},
                self._on_join_response, timeout=1.0)

    def _on_join_response(self, resp, err) -> None:
        # start_join returns the voter's join directly as its response
        if err is not None or resp is None:
            return
        self._count_join(resp)

    def _count_join(self, join: Dict[str, Any]) -> None:
        if self.mode != Mode.CANDIDATE:
            return
        try:
            won = self.state.handle_join(join)
        except CoordinationError:
            return
        if join.get("node"):
            self._join_nodes[join["voter"]] = join["node"]
        if won:
            self._become_leader()

    # -- handlers -------------------------------------------------------------

    def _on_pre_vote(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        # grant if we have no live leader and the candidate is as fresh as us
        fresh = not self.state.is_fresher_or_equal(
            req["last_accepted_term"], req["last_accepted_version"] + 1)
        # fresh == candidate's accepted >= ours
        grant = (self.mode != Mode.LEADER and self.leader_id is None and fresh)
        return {"grant": bool(grant), "leader": self.leader_id}

    def _on_start_join(self, req: Dict[str, Any], sender: str
                       ) -> Dict[str, Any]:
        join = self.state.handle_start_join(req["candidate"], req["term"])
        join["node"] = self.node.to_dict()   # joins double as node-joins
        # moving to a higher term deposes us/stops following
        if self.mode != Mode.CANDIDATE:
            self._become_candidate(f"higher term {req['term']}")
        return join

    def _on_publish(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        term = req["term"]
        if term > self.state.current_term:
            # implicit start_join: adopt the term, then accept
            self.state.handle_start_join(sender, term)
        if "diff" in req:
            try:
                state = self.applied_state.apply_diff(req["diff"])
            except IncompatibleClusterStateError:
                return {"need_full": True}
        else:
            state = ClusterState.from_dict(req["state"])
        ack = self.state.handle_publish_request(term, state)
        if sender != self.node.node_id:
            self._become_follower(sender)
        return ack

    def _on_commit(self, req: Dict[str, Any], sender: str) -> Dict[str, Any]:
        state = self.state.handle_commit(req["term"], req["version"])
        self._apply(state)
        return {}

    def _on_follower_check(self, req: Dict[str, Any], sender: str
                           ) -> Dict[str, Any]:
        if req["term"] < self.state.current_term:
            raise CoordinationError("check from stale leader")
        if req["term"] > self.state.current_term:
            self.state.handle_start_join(sender, req["term"])
        self._become_follower(sender)
        # the responder's identity rides along so the leader's failure
        # detector doubles as a REBOOT detector: a restarted process
        # answers checks with the SAME applied (term, version) — its
        # gateway persisted them — but different content (routing reset),
        # so version comparison alone can never notice it. The ephemeral
        # id can (DiscoveryNode per-boot identity).
        return {"ok": True, "applied_term": self.applied_state.term,
                "applied_version": self.applied_state.version,
                "node": self.node.to_dict()}

    # -- publication ----------------------------------------------------------

    def _publish(self, new_state: ClusterState) -> None:
        self._publishing = True
        try:
            pub = self.state.handle_client_value(new_state)
        except (NotMasterError, CoordinationError):
            self._publishing = False
            self._become_candidate("publication rejected locally")
            return
        state: ClusterState = pub["state"]
        term = pub["term"]
        targets = list(state.nodes) or [self.node.node_id]
        if self.node.node_id not in targets:
            targets.append(self.node.node_id)
        committed = {"done": False}
        timeout_handle = self.scheduler.schedule(
            self.settings.publish_timeout,
            lambda: self._publication_failed(term, state.version, committed))

        def on_ack(resp, err, target: str) -> None:
            if isinstance(resp, dict) and resp.get("need_full"):
                # retry that node with the full state
                self.ts.send_request(
                    target, PUBLISH,
                    {"term": term, "state": state.to_dict()},
                    lambda r, e, t=target: on_ack(r, e, t),
                    timeout=self.settings.publish_timeout)
                return
            if err is not None or resp is None:
                return
            if committed["done"]:
                # late ack after the quorum commit fan-out already went
                # out — typical for a rebooted follower whose diff came
                # back need_full and whose full-state retry cost an
                # extra round-trip. Without a commit of its own, that
                # follower is left accepted-but-never-applied, and
                # catch-up can't heal it (its re-publish of the same
                # version is rejected as not-newer-than-accepted).
                self.ts.send_request(target, COMMIT,
                                     {"term": term,
                                      "version": state.version},
                                     lambda r, e: None, timeout=30.0)
                return
            if self.state.handle_publish_response(resp):
                committed["done"] = True
                timeout_handle.cancel()
                self._send_commits(term, state.version, targets)

        base = self.applied_state
        diff_payload = ({"term": term, "diff": state.diff_from(base)}
                        if base.state_uuid != "_na_" else None)
        full_payload = {"term": term, "state": state.to_dict()}
        for target in targets:
            use_diff = (diff_payload is not None and
                        target != self.node.node_id and target in base.nodes)
            self.ts.send_request(
                target, PUBLISH, diff_payload if use_diff else full_payload,
                lambda r, e, t=target: on_ack(r, e, t),
                timeout=self.settings.publish_timeout)

    def _send_commits(self, term: int, version: int, targets: List[str]) -> None:
        for target in targets:
            self.ts.send_request(target, COMMIT,
                                 {"term": term, "version": version},
                                 lambda r, e: None, timeout=30.0)
        self._publishing = False
        # the next queued update drains only after OUR commit applies
        # (_on_applied_for_updates) so the in-flight slot is free again

    def _publication_failed(self, term: int, version: int,
                            committed: Dict[str, bool]) -> None:
        if committed["done"]:
            return
        committed["done"] = True
        self._become_candidate(f"publication ({term},{version}) timed out")

    def _apply(self, state: ClusterState) -> None:
        if state.version <= self.applied_state.version and \
                state.state_uuid == self.applied_state.state_uuid:
            return
        self.applied_state = state
        if self.on_committed is not None:
            # An applier failure must never wedge the master-service queue:
            # the state IS committed cluster-wide regardless of what one
            # node's appliers do with it (ClusterApplierService.java:74
            # catches applier exceptions the same way). The local index
            # error surfaces through shard-level failure, not here.
            try:
                self.on_committed(state)
            except Exception:  # noqa: BLE001
                logger.exception("cluster state applier failed on %s v%s",
                                 self.node.node_id, state.version)
        self._on_applied_for_updates(state)

    # -- MasterService role ---------------------------------------------------

    def submit_state_update(
            self, description: str,
            update_fn: Callable[[ClusterState], ClusterState],
            on_done: Callable[[Optional[Exception]], None] = lambda e: None
    ) -> None:
        """Queue a cluster-state mutation; executed single-file on the
        elected master, published, committed, then on_done(None). Any
        failure (not master, no quorum) => on_done(error)."""
        if self.mode != Mode.LEADER:
            on_done(NotMasterError(
                f"node [{self.node.node_id}] is not the master"))
            return
        self._update_queue.append((description, update_fn, on_done))
        if not self._publishing:
            self._drain_update_queue()

    def _drain_update_queue(self) -> None:
        if self.mode != Mode.LEADER or self._publishing or \
                self._inflight_update is not None or not self._update_queue:
            return
        description, update_fn, on_done = self._update_queue.pop(0)
        base = self.state.accepted
        try:
            new_state = update_fn(base)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            on_done(e)
            self._drain_update_queue()
            return
        if new_state is base or new_state is None:
            on_done(None)
            self._drain_update_queue()
            return
        # completion fires on the commit of exactly this version — or on
        # failure via _fail_queued_updates when we step down
        version = new_state.version
        self._inflight_update = (version, on_done, description)
        self._publish(new_state)

    def _on_applied_for_updates(self, state: ClusterState) -> None:
        inflight = self._inflight_update
        if inflight is not None and state.version >= inflight[0]:
            self._inflight_update = None
            inflight[1](None)
            self._drain_update_queue()

    def _fail_queued_updates(self, error: Exception) -> None:
        inflight = self._inflight_update
        if inflight is not None:
            self._inflight_update = None
            inflight[1](error)
        queue, self._update_queue = self._update_queue, []
        for _desc, _fn, on_done in queue:
            on_done(error)

    # -- failure detection ----------------------------------------------------

    def _start_heartbeats(self) -> None:
        self._cancel("_heartbeat_timer")

        def beat() -> None:
            if self.mode != Mode.LEADER:
                return
            missed = self._missed_checks
            for peer in [nid for nid in self.state.accepted.nodes
                         if nid != self.node.node_id]:
                def on_resp(r, e, p=peer) -> None:
                    if e is None:
                        missed[p] = 0
                        if r and (r.get("applied_term", 0),
                                  r.get("applied_version", 0)) < \
                                (self.applied_state.term,
                                 self.applied_state.version):
                            self._catch_up(p)
                        elif r and r.get("node"):
                            # same version but a NEW ephemeral id: the
                            # process rebooted into gateway-reset state
                            # that our version checks can't distinguish.
                            # Re-admit it like a join — the entry replace
                            # bumps the version, and the uuid mismatch
                            # forces a full-state redelivery, which the
                            # rebooted node's reconciler turns into
                            # in-place store recovery.
                            responder = DiscoveryNode.from_dict(r["node"])
                            known = self.applied_state.nodes.get(p)
                            if known is not None and \
                                    responder.ephemeral_id and \
                                    known.ephemeral_id != \
                                    responder.ephemeral_id:
                                self._readmit_rebooted(responder)
                    else:
                        missed[p] = missed.get(p, 0) + 1
                        if missed[p] >= 3:
                            self._on_follower_failed(p)
                self.ts.send_request(peer, FOLLOWER_CHECK,
                                     {"term": self.state.current_term,
                                      "leader": self.node.node_id},
                                     on_resp,
                                     timeout=self.settings.heartbeat_interval)
            self._heartbeat_timer = self.scheduler.schedule(
                self.settings.heartbeat_interval, beat)

        self._heartbeat_timer = self.scheduler.schedule(
            self.settings.heartbeat_interval, beat)

    def _readmit_rebooted(self, joining: DiscoveryNode) -> None:
        """Replace a member entry whose process restarted behind it (seen
        via the heartbeat's ephemeral id). Same update as a NODE_JOIN from
        a restarted process; idempotent — once the entry carries the new
        ephemeral id the guard no-ops."""
        if self.mode != Mode.LEADER:
            return

        def update(state: ClusterState) -> ClusterState:
            existing = state.nodes.get(joining.node_id)
            if existing is None or \
                    existing.ephemeral_id == joining.ephemeral_id:
                return state
            return state.with_nodes(
                {**state.nodes, joining.node_id: joining},
                state.master_node_id)
        self.submit_state_update(
            f"node-rebooted [{joining.node_id}]", update)

    def _catch_up(self, peer: str) -> None:
        """Re-send the COMMITTED state to a lagging follower (a healed
        partition leaves followers with stale applied state until the next
        publication; the reference relies on every publication being full
        per-node + LagDetector — here the leader pushes directly).

        Must use applied_state, never state.accepted: accepted may be an
        in-flight publication that hasn't reached quorum, and committing it
        on one follower could surface a state the cluster later loses."""
        if self.mode != Mode.LEADER:
            return
        state = self.applied_state
        if state.term != self.state.current_term:
            return  # our first publication hasn't committed yet

        def on_ack(r, e) -> None:
            if e is None and r is not None and r.get("need_full"):
                return
            # send the commit even when the publish was REJECTED: a
            # follower that already ACCEPTED this exact (term, version)
            # but missed only the commit round (reboot raced a
            # diff->need_full->full retry against the commit fan-out)
            # rejects the re-publish as not-newer-than-accepted — the
            # commit is precisely what it is missing. handle_commit
            # validates the (term, version) match, so an unconditional
            # send is safe; a genuine mismatch just errors out remotely.
            self.ts.send_request(peer, COMMIT,
                                 {"term": state.term,
                                  "version": state.version},
                                 lambda r2, e2: None, timeout=30.0)
        self.ts.send_request(peer, PUBLISH,
                             {"term": self.state.current_term,
                              "state": state.to_dict()},
                             on_ack, timeout=30.0)

    def _on_follower_failed(self, node_id: str) -> None:
        """Leader noticed a dead follower (FollowersChecker analog). Remove
        it from the cluster state via a normal state update."""
        if self.mode != Mode.LEADER:
            return
        self._missed_checks.pop(node_id, None)

        def remove(state: ClusterState) -> ClusterState:
            if node_id not in state.nodes:
                return state
            nodes = {nid: n for nid, n in state.nodes.items() if nid != node_id}
            return state.with_nodes(nodes, self.node.node_id)
        self.submit_state_update(f"node-left [{node_id}]", remove)

    # -- membership (re)join --------------------------------------------------

    def _request_node_join(self, leader_id: str) -> None:
        self.ts.send_request(leader_id, NODE_JOIN,
                             {"node": self.node.to_dict()},
                             lambda r, e: None, timeout=5.0)

    def _on_node_join(self, req: Dict[str, Any], sender: str
                      ) -> Dict[str, Any]:
        """A node (re)joins through the elected leader: added to the cluster
        state, which the next publication delivers to it
        (JoinHelper/JoinTaskExecutor analog)."""
        if self.mode != Mode.LEADER:
            raise NotMasterError("not the master")
        joining = DiscoveryNode.from_dict(req["node"])

        def add(state: ClusterState) -> ClusterState:
            existing = state.nodes.get(joining.node_id)
            if existing is not None:
                if existing.ephemeral_id == joining.ephemeral_id:
                    # the same running process re-sent its join (e.g. a
                    # one-way partition keeps triggering its pre-vote →
                    # rejoin path): a pure duplicate, and it must stay a
                    # NO-OP or one flapping node drives unbounded
                    # publication churn
                    return state
                # a NEW ephemeral id = the process restarted: its
                # in-memory state is whatever the gateway persisted (with
                # routing reset). Replace the entry — the version bump
                # makes the next publication re-deliver the full
                # committed state; otherwise nothing publishes and the
                # rebooted node serves stale state forever (the
                # reference's JoinTaskExecutor + ephemeral-id semantics)
                return state.with_nodes(
                    {**state.nodes, joining.node_id: joining},
                    state.master_node_id)
            state = state.with_nodes(
                {**state.nodes, joining.node_id: joining},
                self.node.node_id)
            # re-enfranchisement: ONLY a joiner whose exclusion was
            # cleared while it was away (recorded as voting_pending)
            # re-enters the voting configuration. Unconditional growth
            # would let a transient joiner leave behind an even-sized
            # config whose quorum a later departure can never reach.
            pending = state.metadata.custom.get("voting_pending", {})
            if joining.is_master_eligible and \
                    joining.node_id in pending and \
                    joining.node_id not in state.voting_config:
                from dataclasses import replace
                state = replace(state, voting_config=frozenset(
                    set(state.voting_config) | {joining.node_id}))
                state = state.next_version(
                    metadata=state.metadata.with_custom_entry(
                        "voting_pending", joining.node_id, None))
            return state
        self.submit_state_update(f"node-join [{joining.node_id}]", add)
        return {}

    def _reset_follower_timer(self) -> None:
        self._cancel("_follower_timer")
        self._follower_timer = self.scheduler.schedule(
            self.settings.follower_timeout,
            lambda: self._become_candidate("leader check timeout"))
