"""Index lifecycle management: hot -> warm -> cold -> delete.

Reference: x-pack/plugin/ilm/.../IndexLifecycleService.java:53 — a
master-side periodic service that walks indices carrying an
``index.lifecycle.name`` setting and advances them through their policy's
phases. Phases and actions implemented:

  hot:    {actions: {rollover: {max_age, max_docs}}} — roll the write
          alias (``index.lifecycle.rollover_alias``) or the data stream
          the index backs; rollover applies matching templates so the
          series keeps its mappings.
  warm:   {min_age, actions: {readonly: {}, forcemerge:
          {max_num_segments}, shrink: {number_of_shards}}} — write-block,
          merge segments, and optionally shrink to fewer shards (the
          shrunken index REPLACES the original in its aliases/data
          stream, then the original is deleted — ShrinkStep +
          ShrinkSetAliasStep semantics).
  cold:   {min_age, actions: {searchable_snapshot:
          {snapshot_repository}}} — snapshot the index into the repo,
          mount it back as a repo-backed searchable index replacing the
          original (MountSnapshotStep).
  delete: {min_age} — delete the index (and drop it from its stream).

The age origin is the rollover date when the index has been rolled (or
creation date for policies without a rollover action) — an index that is
still its series' write target is never advanced past hot. Steps are
idempotent and marked in index settings ("index.lifecycle.*"), so a
master failover resumes mid-phase work from the replicated state. The
loop only acts while this node is the elected master, and every action
goes through the normal master APIs — ILM is policy over the existing
primitives, not a second control plane.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.utils.retry import retry_transient
from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds

logger = logging.getLogger(__name__)

POLL_INTERVAL_SETTING = "indices.lifecycle.poll_interval"
DEFAULT_POLL_INTERVAL = 10.0

PHASE_ORDER = ("hot", "warm", "cold", "delete")


def compute_phase(settings, phases: Dict[str, Any],
                  now_ms: float) -> Dict[str, Any]:
    """{phase, age_ms, rolled_over} — ONE implementation of the age-origin
    and phase-gate rules, shared by the advance loop and the explain API
    so what explain reports is exactly what the machine will do."""
    hot = (phases.get("hot") or {}).get("actions") or {}
    rollover = hot.get("rollover")
    rolled_ms = settings.get("index.rollover_date")
    origin_ms: Optional[float] = None
    if rolled_ms is not None:
        origin_ms = int(rolled_ms)
    elif rollover is None:
        origin_ms = int(settings.get("index.creation_date", 0) or 0) or None
    age_ms = max(now_ms - origin_ms, 0) if origin_ms is not None else 0
    phase = "hot"
    if origin_ms is not None:
        for candidate in ("delete", "cold", "warm"):
            spec = phases.get(candidate)
            if spec is None:
                continue
            min_age_s = parse_time_to_seconds(spec.get("min_age", 0))
            if age_ms >= min_age_s * 1000:
                phase = candidate
                break
    return {"phase": phase, "age_ms": age_ms,
            "rolled_over": rolled_ms is not None}


class IndexLifecycleService:
    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        # step keys with an in-flight retry loop: the poll tick must not
        # stack a second loop for the same index/step while one is still
        # backing off (non-idempotent steps like rollover would execute
        # once per stacked loop when the control plane recovers)
        self._inflight: set = set()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._schedule()

    def stop(self) -> None:
        self._running = False
        if self._timer is not None:
            self._timer.cancel()

    def _poll_interval(self) -> float:
        state = self.node._applied_state()
        raw = state.metadata.persistent_settings.get(
            POLL_INTERVAL_SETTING, DEFAULT_POLL_INTERVAL)
        try:
            return max(0.5, parse_time_to_seconds(raw))
        except (TypeError, ValueError):
            return DEFAULT_POLL_INTERVAL

    def _schedule(self) -> None:
        if not self._running:
            return
        self._timer = self.node.scheduler.schedule(
            self._poll_interval(), self._tick)

    # -- the loop --------------------------------------------------------

    def _tick(self) -> None:
        if not self._running:
            return
        try:
            if self.node.coordinator.mode == "LEADER":
                self.run_once()
        except Exception:  # noqa: BLE001 — the loop must survive anything
            logger.exception("ilm tick failed")
        self._schedule()

    def run_once(self) -> None:
        """One pass over managed indices (triggerPolicies analog). Public
        so tests and an explicit API can step the lifecycle without
        waiting for the poll timer. Each pass advances each index by at
        most one step — repeated passes converge."""
        state = self.node._applied_state()
        now_ms = self.node.scheduler.wall_now() * 1000
        # backing index -> (stream name, is_write_index)
        stream_of: Dict[str, tuple] = {}
        for ds_name, ds in state.metadata.data_streams.items():
            indices = ds.get("indices", [])
            for i, backing in enumerate(indices):
                stream_of[backing] = (ds_name, i == len(indices) - 1)
        for meta in list(state.metadata.indices.values()):
            policy_name = meta.settings.get("index.lifecycle.name")
            if not policy_name:
                continue
            policy = state.metadata.ilm_policies.get(policy_name)
            if not policy:
                continue
            phases = policy.get("phases") or {}
            try:
                self._advance(meta, phases, now_ms,
                              stream_of.get(meta.name))
            except Exception:  # noqa: BLE001 — one index must not stall ILM
                logger.exception("ilm advance failed for [%s]", meta.name)

    # -- per-index step machine ------------------------------------------

    def _step(self, key: str, attempt, on_done=None) -> None:
        """Run one lifecycle action through the unified RetryableAction:
        transient control-plane failures (no master mid-election,
        unreachable node) retry with jittered backoff inside the tick
        instead of silently waiting out a whole poll interval
        (IndexLifecycleRunner's step-retry discipline). ``attempt(cb)``
        fires the async client call; non-transient errors surface to
        ``on_done`` (default: logged). ``key`` (index:step) dedupes:
        while one loop is still backing off, later poll ticks skip the
        step rather than stacking a second loop that would re-execute a
        non-idempotent action on recovery."""
        if key in self._inflight:
            return
        self._inflight.add(key)
        inner = on_done or _log_err

        def finished(resp, err) -> None:
            self._inflight.discard(key)
            inner(resp, err)

        retry_transient(self.node.scheduler, attempt, finished)

    def _advance(self, meta, phases: Dict[str, Any], now_ms: float,
                 stream: Optional[tuple]) -> None:
        hot = (phases.get("hot") or {}).get("actions") or {}
        rollover = hot.get("rollover")

        # age origin + phase gates: ONE shared rule set (compute_phase) —
        # an index still its series' write target (rollover pending) is
        # never advanced out from under the writers
        computed = compute_phase(meta.settings, phases, now_ms)
        phase_name = computed["phase"]
        if phase_name != "hot":
            getattr(self, f"_run_{phase_name}")(
                meta, (phases.get(phase_name) or {}).get("actions") or {},
                stream)
            return

        # hot: rollover the alias or data stream this index writes for
        alias = meta.settings.get("index.lifecycle.rollover_alias")
        if rollover is not None and alias and alias in meta.aliases:
            self._step(f"{meta.name}:rollover",
                       lambda cb: self.node.client.rollover(
                           alias, {"conditions": dict(rollover)}, cb))
        elif rollover is not None and stream is not None and stream[1]:
            self._step(f"{meta.name}:rollover",
                       lambda cb: self.node.client.rollover(
                           stream[0], {"conditions": dict(rollover)},
                           cb))

    def _run_delete(self, meta, _actions, _stream) -> None:
        logger.info("ilm: deleting [%s] (delete phase)", meta.name)
        self._step(f"{meta.name}:delete",
                   lambda cb: self.node.client.delete_index(meta.name,
                                                            cb))

    def _run_warm(self, meta, actions: Dict[str, Any], stream) -> None:
        """One warm step per pass: readonly -> forcemerge -> shrink."""
        client = self.node.client
        if "readonly" in actions and \
                not meta.settings.get("index.blocks.write"):
            self._step(f"{meta.name}:readonly",
                       lambda cb: client.update_settings(
                           meta.name, {"index.blocks.write": True}, cb))
            return
        if "forcemerge" in actions and \
                not meta.settings.get("index.lifecycle.forcemerged"):
            segs = int((actions.get("forcemerge") or {})
                       .get("max_num_segments", 1))

            def mark(_r, err):
                if err is None:
                    self._step(f"{meta.name}:forcemerged-mark",
                               lambda cb: client.update_settings(
                                   meta.name,
                                   {"index.lifecycle.forcemerged": True},
                                   cb))
                else:
                    _log_err(None, err)
            self._step(f"{meta.name}:forcemerge",
                       lambda cb: client.force_merge(
                           meta.name, cb, max_num_segments=segs),
                       on_done=mark)
            return
        if "shrink" in actions and \
                not meta.settings.get("index.lifecycle.shrink_source"):
            target = f"shrink-{meta.name}"
            state = self.node._applied_state()
            if not meta.settings.get("index.blocks.write"):
                # shrink requires the write block even without readonly
                self._step(f"{meta.name}:shrink-block",
                           lambda cb: client.update_settings(
                               meta.name, {"index.blocks.write": True},
                               cb))
                return
            if state.metadata.has_index(target):
                if self._copy_done(state, target,
                                   "index.resize.copy_complete"):
                    self._swap_references(meta, target, stream)
                return
            n = int((actions.get("shrink") or {})
                    .get("number_of_shards", 1))
            self.node.resize_actions.resize(
                "shrink", meta.name, target,
                {"settings": {
                    "index.number_of_shards": n,
                    # the target inherits the policy at the WARM phase
                    # with shrink already done (marker below)
                    "index.lifecycle.name":
                        meta.settings.get("index.lifecycle.name"),
                    "index.lifecycle.shrink_source": meta.name,
                    "index.rollover_date":
                        meta.settings.get("index.rollover_date"),
                    "index.lifecycle.forcemerged": True,
                }}, _log_err)
            return

    def _run_cold(self, meta, actions: Dict[str, Any], stream) -> None:
        """Cold: snapshot + mount back as a searchable-snapshot index
        replacing the original."""
        spec = actions.get("searchable_snapshot")
        if spec is None:
            # cold without searchable_snapshot: just ensure read-only
            if not meta.settings.get("index.blocks.write"):
                self._step(f"{meta.name}:cold-readonly",
                           lambda cb: self.node.client.update_settings(
                               meta.name, {"index.blocks.write": True},
                               cb))
            return
        if meta.settings.get("index.store.snapshot.repository_name"):
            return   # already mounted (this IS the restored index)
        repo = spec.get("snapshot_repository")
        if not repo:
            return
        client = self.node.client
        snap = f"ilm-{meta.name}"
        target = f"restored-{meta.name}"
        state = self.node._applied_state()
        if state.metadata.has_index(target):
            if self._copy_done(
                    state, target,
                    "index.store.snapshot.repository_name"):
                self._swap_references(meta, target, stream)
            return
        if not meta.settings.get("index.lifecycle.snapshot_started"):
            def started(_r, err):
                # "already exists" means a previous attempt succeeded but
                # its ack was lost (e.g. a timed-out round-trip): the
                # deterministic name makes the step idempotent, so adopt
                # the existing snapshot instead of wedging the phase
                if err is None or "already exists" in str(err):
                    self._step(f"{meta.name}:snapshot-mark",
                               lambda cb: client.update_settings(
                                   meta.name,
                                   {"index.lifecycle.snapshot_started":
                                    snap}, cb))
                else:
                    _log_err(None, err)
            self._step(f"{meta.name}:snapshot",
                       lambda cb: client.create_snapshot(
                           repo, snap, {"indices": meta.name}, cb),
                       on_done=started)
            return
        # snapshot taken: mount it back under the restored name, keeping
        # the policy so the delete phase still applies to the mount
        self.node.searchable_snapshots.mount(repo, snap, {
            "index": meta.name, "renamed_index": target,
            "index_settings": {
                "index.lifecycle.name":
                    meta.settings.get("index.lifecycle.name"),
                "index.rollover_date":
                    meta.settings.get("index.rollover_date"),
            }}, _log_err)

    @staticmethod
    def _copy_done(state, target: str, marker: str) -> bool:
        """has_index(target) only proves the async shrink/mount STARTED
        (create-then-copy): swapping references and deleting the source
        before the copy finishes loses data permanently. The marker
        settings key is written by the resize/mount completion callback,
        and every target primary must be active — the
        ShrunkenIndexCheckStep 'target is green' gate, re-expressed.

        A marker-less target parks the policy rather than swapping: a
        target persisted by pre-marker code is indistinguishable from a
        mid-copy one, and a wrong swap deletes the source (operators
        delete the stale target to let ILM re-run the resize)."""
        try:
            tmeta = state.metadata.index(target)
        except Exception:  # noqa: BLE001 — racing a delete: not ready
            return False
        if not tmeta.settings.get(marker):
            return False
        try:
            irt = state.routing_table.index(target)
            return all(irt.primary(s).active
                       for s in range(tmeta.number_of_shards))
        except Exception:  # noqa: BLE001 — no routing yet: not ready
            return False

    def _swap_references(self, old_meta, target: str, stream) -> None:
        """The transformed index replaces the original in its data stream
        or aliases, then the original is deleted (ShrinkSetAliasStep /
        SwapAliasesAndDeleteSourceIndexStep)."""
        client = self.node.client
        if stream is not None:
            ds_name = stream[0]
            state = self.node._applied_state()
            ds = state.metadata.data_streams.get(ds_name)
            if ds is not None:
                from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
                indices = [target if n == old_meta.name else n
                           for n in ds.get("indices", [])]

                def then_delete(_r, err):
                    if err is None:
                        client.delete_index(old_meta.name, _log_err)
                    else:
                        _log_err(None, err)
                self.node.master_client.execute(PUT_CUSTOM, {
                    "section": "data_streams", "name": ds_name,
                    "body": {**ds, "indices": indices}}, then_delete)
                return
        aliases = list(old_meta.aliases)
        if aliases:
            actions = [{"add": {"index": target, "alias": a}}
                       for a in aliases]

            def then_delete(_r, err):
                if err is None:
                    client.delete_index(old_meta.name, _log_err)
                else:
                    _log_err(None, err)
            client.update_aliases(actions, then_delete)
            return
        client.delete_index(old_meta.name, _log_err)


def _log_err(_resp: Optional[Dict[str, Any]], err: Optional[Exception]
             ) -> None:
    if err is not None:
        logger.warning("ilm action failed: %s", err)
