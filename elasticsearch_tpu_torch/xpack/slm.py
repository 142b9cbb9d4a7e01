"""Snapshot lifecycle management (SLM).

Reference: x-pack/plugin/ilm/.../slm/SnapshotLifecycleService.java:43 +
SnapshotRetentionTask.java — scheduled snapshots per policy with
retention pruning. Policies live in cluster-state metadata
(custom["slm"]) so they replicate and survive master failover; the
scheduler only acts on the elected master.

Policy shape (PUT /_slm/policy/{id}):
  {"schedule": {"interval": "30m"},      # interval-based (the reference
                                         # uses cron; interval covers the
                                         # periodic-backup use case)
   "name": "nightly-snap",               # snapshot name prefix
   "repository": "backups",
   "config": {"indices": "logs-*"},
   "retention": {"expire_after": "7d", "min_count": 3, "max_count": 50}}
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
from elasticsearch_tpu_torch.utils.retry import retry_transient
from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds

logger = logging.getLogger(__name__)

SECTION = "slm"
DEFAULT_POLL = 5.0


class SnapshotLifecycleService:
    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        self.stats = {"runs": 0, "snapshots_taken": 0,
                      "snapshots_deleted": 0, "failures": 0}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._schedule()

    def stop(self) -> None:
        self._running = False
        if self._timer is not None:
            self._timer.cancel()

    def _schedule(self) -> None:
        if not self._running:
            return
        self._timer = self.node.scheduler.schedule(DEFAULT_POLL, self._tick)

    def _tick(self) -> None:
        if not self._running:
            return
        try:
            if self.node.coordinator.mode == "LEADER":
                self.run_once()
        except Exception:  # noqa: BLE001 — the loop must survive anything
            logger.exception("slm tick failed")
        self._schedule()

    # -- policy CRUD -----------------------------------------------------

    @staticmethod
    def validate(policy: Dict[str, Any]) -> None:
        for field in ("name", "repository", "schedule"):
            if not policy.get(field):
                raise IllegalArgumentError(f"slm policy requires [{field}]")
        interval = (policy.get("schedule") or {}).get("interval")
        if not interval:
            raise IllegalArgumentError(
                "slm schedule requires [interval] (e.g. \"30m\")")
        parse_time_to_seconds(interval)   # raises on malformed
        retention = policy.get("retention") or {}
        if "expire_after" in retention:
            parse_time_to_seconds(retention["expire_after"])

    def policies(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(SECTION, {}))

    def get(self, policy_id: Optional[str] = None) -> Dict[str, Any]:
        got = self.policies()
        if policy_id is not None:
            if policy_id not in got:
                raise IllegalArgumentError(
                    f"no such slm policy [{policy_id}]")
            got = {policy_id: got[policy_id]}
        return {pid: {"policy": {k: v for k, v in p.items()
                                 if not k.startswith("_")},
                      "last_success": p.get("_last_success"),
                      "next_execution_millis": int(
                          (p.get("_last_run_ms", 0) or 0) +
                          parse_time_to_seconds(
                              (p.get("schedule") or {})
                              .get("interval", "1h")) * 1000)}
                for pid, p in got.items()}

    # -- scheduling ------------------------------------------------------

    def run_once(self) -> None:
        now_ms = self.node.scheduler.wall_now() * 1000
        self.stats["runs"] += 1
        for pid, policy in self.policies().items():
            interval_s = parse_time_to_seconds(
                (policy.get("schedule") or {}).get("interval", "1h"))
            last = policy.get("_last_run_ms")
            # a never-run policy fires immediately (first scheduled point)
            if last is None or now_ms - last >= interval_s * 1000:
                self.execute(pid)

    def execute(self, policy_id: str,
                on_done: Optional[Callable] = None) -> None:
        """Take one snapshot for the policy now (POST
        /_slm/policy/{id}/_execute) and prune per retention."""
        policy = self.policies().get(policy_id)
        if policy is None:
            if on_done is not None:
                on_done(None, IllegalArgumentError(
                    f"no such slm policy [{policy_id}]"))
            return
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        counter = int(policy.get("_counter", 0)) + 1
        snap_name = f"{policy['name']}-{counter:06d}"
        now_ms = int(self.node.scheduler.wall_now() * 1000)
        config = dict(policy.get("config") or {})

        def taken(resp, err) -> None:
            if err is not None and "already exists" in str(err):
                # a previous attempt's ack was lost: the snapshot IS in
                # the repo under this counter's name — record success so
                # the counter advances instead of colliding forever
                err = None
            if err is not None:
                self.stats["failures"] += 1
                logger.warning("slm snapshot failed for [%s]: %s",
                               policy_id, err)
                if on_done is not None:
                    on_done(None, err)
                return
            self.stats["snapshots_taken"] += 1
            self.node.master_client.execute(PUT_CUSTOM, {
                "section": SECTION, "name": policy_id,
                "body": {**policy, "_counter": counter,
                         "_last_run_ms": now_ms,
                         "_last_success": snap_name}},
                lambda _r, _e: None)
            self._apply_retention(policy)
            if on_done is not None:
                on_done({"snapshot_name": snap_name}, None)

        # stamp last_run FIRST so a slow snapshot isn't retriggered by
        # the next tick (the reference's in-flight registry)
        self.node.master_client.execute(PUT_CUSTOM, {
            "section": SECTION, "name": policy_id,
            "body": {**policy, "_last_run_ms": now_ms}},
            lambda _r, _e: None)
        # the snapshot step retries through transient control-plane
        # failures (mid-election, unreachable node) with jittered backoff
        # instead of burning the whole schedule interval on one blip
        retry_transient(
            self.node.scheduler,
            lambda cb: self.node.client.create_snapshot(
                policy["repository"], snap_name, config, cb),
            taken)

    # -- retention -------------------------------------------------------

    def _apply_retention(self, policy: Dict[str, Any]) -> None:
        retention = policy.get("retention") or {}
        if not retention:
            return
        repo = policy["repository"]
        prefix = policy["name"] + "-"
        try:
            listing = self.node.client.get_snapshots(repo)
        except Exception:  # noqa: BLE001 — retention must not fail the run
            return
        mine = sorted(
            (s for s in listing.get("snapshots", [])
             if str(s.get("snapshot", "")).startswith(prefix)),
            key=lambda s: s.get("start_time_in_millis") or 0)
        now_ms = self.node.scheduler.wall_now() * 1000
        min_count = int(retention.get("min_count", 0))
        max_count = retention.get("max_count")
        expire_s = None
        if "expire_after" in retention:
            expire_s = parse_time_to_seconds(retention["expire_after"])
        doomed = []
        if expire_s is not None:
            cutoff = now_ms - expire_s * 1000
            expired = [s for s in mine
                       if (s.get("start_time_in_millis") or 0) < cutoff]
            keep_floor = max(min_count, 0)
            droppable = len(mine) - keep_floor
            doomed.extend(expired[: max(droppable, 0)])
        if max_count is not None:
            remaining = [s for s in mine if s not in doomed]
            excess = len(remaining) - int(max_count)
            if excess > 0:
                doomed.extend(remaining[:excess])   # oldest first
        for snap in doomed:
            try:
                self.node.client.delete_snapshot(repo, snap["snapshot"])
                self.stats["snapshots_deleted"] += 1
            except Exception:  # noqa: BLE001
                logger.warning("slm retention delete failed for [%s]",
                               snap.get("snapshot"))
