"""Resource watcher: poll files for changes and notify listeners.

Reference: watcher/ResourceWatcherService.java — a scheduler-driven
polling service (no inotify dependency) that security's file realm and
other file-backed configs register with for hot reload.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

DEFAULT_INTERVAL = 5.0


class ResourceWatcherService:
    def __init__(self, scheduler, interval: float = DEFAULT_INTERVAL):
        self.scheduler = scheduler
        self.interval = interval
        # path -> (last (mtime, size) or None, callback)
        self._watched: Dict[str, Tuple[Optional[tuple], Callable]] = {}
        self._running = False
        self._timer = None

    def watch(self, path: str, on_change: Callable[[str], None]) -> None:
        """Register ``on_change(path)``, fired when the file's mtime/size
        changes, the file appears, or it disappears."""
        self._watched[path] = (self._stat(path), on_change)

    @staticmethod
    def _stat(path: str) -> Optional[tuple]:
        try:
            st = os.stat(path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

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
        self._timer = self.scheduler.schedule(self.interval, self._tick)

    def _tick(self) -> None:
        if not self._running:
            return
        try:
            self.check_now()
        except Exception:  # noqa: BLE001 — the poll must survive anything
            logger.exception("resource watcher tick failed")
        self._schedule()

    def check_now(self) -> None:
        """One poll pass (public: tests and lazy callers step it)."""
        for path, (last, cb) in list(self._watched.items()):
            current = self._stat(path)
            if current != last:
                self._watched[path] = (current, cb)
                try:
                    cb(path)
                except Exception:  # noqa: BLE001
                    logger.exception("watch callback failed for %s", path)
