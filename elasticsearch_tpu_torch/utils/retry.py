"""Unified retry: exponential backoff with equal jitter and a deadline cap.

Reference analog: action/support/RetryableAction.java:43 — one retry
discipline for every transient-failure loop (reroute-on-stale-routing,
peer recovery, CCR follow), replacing per-call-site fixed-delay spinners.
Backoff is *equal jitter*: the nth retry waits ``base/2 + U(0, base/2)``
where ``base = initial * 2**n`` (capped at ``max_delay``) — delays are
strictly increasing until the cap, and jitter decorrelates retry storms
across concurrent actions.

Driven entirely by the Scheduler seam, so the SAME code backs off in
wall-clock production and in seeded virtual-time simulation (where the
DeterministicScheduler's ``random`` makes the jitter reproducible).
"""

from __future__ import annotations

import random as _random
from typing import Any, Callable, List, Optional

# the scheduler seam's type lives in the transport layer, which this
# package does not carry yet: any object with its now/schedule surface
Scheduler = Any

__all__ = ["RetryableAction", "retry_transient", "transient_cluster_error"]

AttemptFn = Callable[[Callable[[Optional[dict], Optional[Exception]], None]],
                     None]
DoneFn = Callable[[Optional[dict], Optional[Exception]], None]


class RetryableAction:
    """Run ``attempt(cb)`` until it succeeds, fails non-retryably, or the
    deadline passes; then call ``on_done(resp, err)`` exactly once.

    ``attempt`` is callback-style (fire an async op, call ``cb(resp, err)``
    once) so replication/recovery code adopts it without restructuring.
    ``is_retryable(err) -> bool`` classifies failures; None retries every
    error. Each backoff delay is appended to ``self.delays`` — observable
    telemetry, and what the chaos suite asserts strict increase on.
    """

    def __init__(self, scheduler: Scheduler, attempt: AttemptFn,
                 on_done: DoneFn, *,
                 initial_delay: float = 0.25,
                 max_delay: float = 30.0,
                 timeout: float = 60.0,
                 is_retryable: Optional[Callable[[Any], bool]] = None):
        if initial_delay <= 0:
            raise ValueError("initial_delay must be positive")
        self.scheduler = scheduler
        self.attempt = attempt
        self.on_done = on_done
        self.initial_delay = initial_delay
        self.max_delay = max_delay
        self.deadline = scheduler.now() + timeout
        self.is_retryable = is_retryable
        # seeded under the deterministic scheduler, wall-random in prod
        self.random = getattr(scheduler, "random", None) or _random
        self.delays: List[float] = []
        self._n = 0
        self._done = False

    # ------------------------------------------------------------------

    def run(self) -> None:
        self._attempt_once()

    def _finish(self, resp: Optional[dict], err: Optional[Exception]) -> None:
        if self._done:
            return
        self._done = True
        self.on_done(resp, err)

    def _next_delay(self) -> float:
        base = min(self.initial_delay * (2 ** self._n), self.max_delay)
        return base / 2.0 + self.random.uniform(0.0, base / 2.0)

    def _attempt_once(self) -> None:
        fired = {"flag": False}

        def cb(resp: Optional[dict], err: Optional[Exception] = None) -> None:
            if fired["flag"] or self._done:
                return
            fired["flag"] = True
            if err is None:
                self._finish(resp, None)
                return
            if self.is_retryable is not None and not self.is_retryable(err):
                self._finish(None, err)
                return
            delay = self._next_delay()
            if self.scheduler.now() + delay > self.deadline:
                # out of budget: surface the LAST error, like the
                # reference's onFinalFailure
                self._finish(None, err)
                return
            self._n += 1
            self.delays.append(delay)
            self.scheduler.schedule(delay, self._attempt_once)

        try:
            self.attempt(cb)
        except Exception as e:  # noqa: BLE001 — sync throw = failed attempt
            cb(None, e)


def transient_cluster_error(err: Any, retry_timeouts: bool = False) -> bool:
    """THE transient-failure classifier for control-plane retries (master
    round-trips, ILM/SLM steps, shard-state reports): no elected master
    mid-election, an unreachable node, or a cluster block that a later
    state may lift. Remote errors arrive as RemoteTransportError whose
    message names the cause type, hence the string checks.

    ``retry_timeouts`` gates ReceiveTimeoutError: a timed-out request has
    an AMBIGUOUS outcome (the server may have executed it), so only
    callers whose action is idempotent on the receiver (e.g. shard-failed
    reports, recovery-start) may pass True. Non-idempotent mutations like
    create_snapshot must leave it False — an automatic resend would trade
    a lost ack for a spurious already-exists failure; their periodic
    services re-drive on the next tick where actual state is observable."""
    from elasticsearch_tpu_torch.utils.errors import (
        ClusterBlockError, NotMasterError, ReceiveTimeoutError,
    )
    if retry_timeouts and isinstance(err, ReceiveTimeoutError):
        return True
    if isinstance(err, (NotMasterError, ClusterBlockError)):
        return True
    text = str(err)
    return ("NotMasterError" in text or "ClusterBlockError" in text
            or "not connected" in text)


def retry_transient(scheduler: Scheduler, attempt: AttemptFn,
                    on_done: DoneFn, *,
                    initial_delay: float = 0.5,
                    max_delay: float = 5.0,
                    timeout: float = 30.0) -> RetryableAction:
    """A RetryableAction preconfigured for transient control-plane
    failures; returns the (already running) action."""
    action = RetryableAction(scheduler, attempt, on_done,
                             initial_delay=initial_delay,
                             max_delay=max_delay, timeout=timeout,
                             is_retryable=transient_cluster_error)
    action.run()
    return action
