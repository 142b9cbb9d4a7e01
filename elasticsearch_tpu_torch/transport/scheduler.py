"""Time + deferred execution, swappable for deterministic simulation.

The reference achieves deterministic multi-node testing by running whole
clusters on a single-threaded virtual-time scheduler
(test/framework/.../AbstractCoordinatorTestCase.java:143 —
DeterministicTaskQueue). Making the scheduler a first-class seam here means
the SAME coordination/replication code runs in production (threaded) and in
simulation (virtual time), instead of a test-only re-implementation.
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from typing import Callable, List, Optional, Tuple


class Cancellable:
    """Handle for a scheduled task."""

    def __init__(self) -> None:
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled


class Scheduler:
    """now() + schedule(delay, fn). Implementations define time's meaning."""

    def now(self) -> float:
        raise NotImplementedError

    def wall_now(self) -> float:
        """Epoch seconds for PERSISTED timestamps (index creation/rollover
        dates). now() is monotonic in production and resets per process —
        anything written into durable cluster state must use this instead.
        The deterministic scheduler's virtual time doubles as its epoch."""
        return self.now()

    def schedule(self, delay: float, fn: Callable[[], None]) -> Cancellable:
        raise NotImplementedError

    def submit(self, fn: Callable[[], None]) -> Cancellable:
        return self.schedule(0.0, fn)


class DeterministicScheduler(Scheduler):
    """Single-threaded virtual-time scheduler.

    Tasks run only inside run_* calls, in (time, insertion-order) order with
    optional seeded tie-shuffling so tests explore interleavings
    reproducibly. Time advances instantly to the next task — a simulated
    hour costs microseconds.
    """

    def __init__(self, seed: int = 0) -> None:
        self._time = 0.0
        self._counter = itertools.count()
        self._queue: List[Tuple[float, int, Cancellable, Callable]] = []
        self.random = random.Random(seed)

    def now(self) -> float:
        return self._time

    def schedule(self, delay: float, fn: Callable[[], None]) -> Cancellable:
        handle = Cancellable()
        heapq.heappush(self._queue,
                       (self._time + max(0.0, delay), next(self._counter),
                        handle, fn))
        return handle

    # -- simulation drivers --------------------------------------------------

    def run_one(self) -> bool:
        """Run the next pending task, advancing virtual time. False if idle."""
        while self._queue:
            t, _, handle, fn = heapq.heappop(self._queue)
            if handle.cancelled:
                continue
            self._time = max(self._time, t)
            fn()
            return True
        return False

    def run_until(self, deadline: float) -> None:
        """Run every task scheduled at or before `deadline` (virtual)."""
        while self._queue:
            # drop cancelled heads BEFORE the deadline check, or a cancelled
            # early task would let run_one execute a task past the deadline
            while self._queue and self._queue[0][2].cancelled:
                heapq.heappop(self._queue)
            if not self._queue or self._queue[0][0] > deadline:
                break
            self.run_one()
        self._time = max(self._time, deadline)

    def run_for(self, duration: float) -> None:
        self.run_until(self._time + duration)

    def run_until_idle(self, max_tasks: int = 100_000) -> int:
        n = 0
        while self.run_one():
            n += 1
            if n >= max_tasks:
                raise RuntimeError("scheduler did not go idle "
                                   f"(>{max_tasks} tasks) — livelock?")
        return n

    @property
    def pending(self) -> int:
        return sum(1 for (_, _, h, _) in self._queue if not h.cancelled)


class ThreadedScheduler(Scheduler):
    """Wall-clock scheduler on a single dispatch thread (production mode).

    Single-threaded dispatch gives the same ordering discipline the
    deterministic scheduler enforces — handlers never race each other,
    like the reference's single applier/master threads
    (cluster/service/MasterService.java:73).
    """

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._queue: List[Tuple[float, int, Cancellable, Callable]] = []
        self._counter = itertools.count()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="scheduler-dispatch")
        self._thread.start()

    def now(self) -> float:
        return time.monotonic()

    def wall_now(self) -> float:
        return time.time()

    def schedule(self, delay: float, fn: Callable[[], None]) -> Cancellable:
        handle = Cancellable()
        with self._cv:
            heapq.heappush(self._queue,
                           (self.now() + max(0.0, delay),
                            next(self._counter), handle, fn))
            self._cv.notify()
        return handle

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and (
                        not self._queue or self._queue[0][0] > self.now()):
                    timeout = (self._queue[0][0] - self.now()
                               if self._queue else None)
                    self._cv.wait(timeout=timeout)
                if self._closed:
                    return
                _, _, handle, fn = heapq.heappop(self._queue)
            if not handle.cancelled:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — dispatch thread must survive
                    import traceback
                    traceback.print_exc()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=5)
