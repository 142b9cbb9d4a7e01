"""Hierarchical circuit breakers with device (HBM) memory accounting.

Reference: common/breaker/ChildMemoryCircuitBreaker.java +
indices/breaker/HierarchyCircuitBreakerService.java:64 — a parent breaker
over child breakers (request, fielddata, ...) that refuses work with 429
before the JVM heap dies. The TPU-native re-design adds the budget the
reference never had to manage: **HBM**. Device-resident segment arrays
(postings/vector/feature blocks) and per-query transients (dense score
vectors, block gathers) are estimated against a ``device`` child breaker,
so an over-budget query degrades to a 429 instead of an XLA OOM that
kills every query on the chip.

The service is process-global because the accelerator is process-global
(one HBM pool per process, shared by every in-process node — the same
reason jax exposes one device runtime). Nodes surface its stats under
``_nodes/stats.breakers``.

Residency is released by GC: device-array owners register a weakref
finalizer, so accounting follows the true lifetime of the HBM allocation
without manual bookkeeping at every drop site.
"""

from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import CircuitBreakingError

__all__ = ["ChildBreaker", "DeviceCharge", "HierarchyCircuitBreakerService",
           "BREAKERS", "account_device_arrays", "charge_device"]

GB = 1 << 30


class ChildBreaker:
    """One named budget; estimates are added pessimistically and released
    when the work (or the resident object) goes away."""

    def __init__(self, name: str, limit: int, overhead: float = 1.0,
                 parent: Optional["HierarchyCircuitBreakerService"] = None):
        self.name = name
        self.limit = int(limit)
        self.overhead = overhead
        self.used = 0
        self.trip_count = 0
        self._parent = parent
        self._lock = threading.Lock()
        # observe() scopes currently watching this breaker's high-water
        # mark (normally empty — one list check on the charge path)
        self._observers: list = []

    def add_estimate(self, n_bytes: int, label: str = "<unknown>") -> None:
        n_bytes = int(n_bytes)
        with self._lock:
            new_used = self.used + n_bytes
            if new_used * self.overhead > self.limit > 0:
                self.trip_count += 1
                raise CircuitBreakingError(
                    f"[{self.name}] data for [{label}] would be "
                    f"[{new_used}/{_h(new_used)}] which is larger than the "
                    f"limit of [{self.limit}/{_h(self.limit)}]")
            self.used = new_used
            for obs in self._observers:
                if new_used > obs.peak:
                    obs.peak = new_used
        if self._parent is not None:
            try:
                self._parent.check_parent(n_bytes, label)
            except CircuitBreakingError:
                with self._lock:
                    self.used -= n_bytes
                raise

    def release(self, n_bytes: int) -> None:
        with self._lock:
            self.used = max(0, self.used - int(n_bytes))

    @contextmanager
    def limit_scope(self, n_bytes: int, label: str = "<transient>"):
        """Transient accounting for the duration of one operation."""
        self.add_estimate(n_bytes, label)
        try:
            yield
        finally:
            self.release(n_bytes)

    @contextmanager
    def observe(self):
        """Watch the breaker's high-water mark for the duration of one
        operation: ``obs.peak - obs.base`` after the scope is the charge
        the operation actually added (outer transients plus everything
        charged inside them). Pure observation — never refuses work —
        so callers can feed MEASURED costs back into their own
        admission estimates (the shard batcher's per-key cap)."""
        obs = _ChargeObservation(self.used)
        with self._lock:
            self._observers.append(obs)
        try:
            yield obs
        finally:
            with self._lock:
                self._observers.remove(obs)

    def stats(self) -> Dict[str, Any]:
        return {"limit_size_in_bytes": self.limit,
                "estimated_size_in_bytes": self.used,
                "overhead": self.overhead,
                "tripped": self.trip_count}


class _ChargeObservation:
    """One observe() scope's view: ``base`` at entry, ``peak`` high-water."""

    __slots__ = ("base", "peak")

    def __init__(self, base: int):
        self.base = base
        self.peak = base


def _h(n: int) -> str:
    for unit in ("b", "kb", "mb", "gb", "tb"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}" if unit != "b" else f"{n}{unit}"
        n /= 1024
    return f"{n:.1f}pb"


class HierarchyCircuitBreakerService:
    """Parent limit over {request, fielddata, device} children."""

    def __init__(self, total_limit: int = 12 * GB,
                 request_limit: int = 6 * GB,
                 fielddata_limit: int = 4 * GB,
                 device_limit: int = 12 * GB,
                 request_cache_limit: int = 1 * GB):
        self.parent_limit = int(total_limit)
        self.parent_trip_count = 0
        self._lock = threading.Lock()
        self.breakers: Dict[str, ChildBreaker] = {
            "request": ChildBreaker("request", request_limit, parent=self),
            "fielddata": ChildBreaker("fielddata", fielddata_limit,
                                      parent=self),
            "device": ChildBreaker("device", device_limit, parent=self),
            # resident request-cache entries (indices/request_cache.py):
            # the cache's own max_bytes LRU budget evicts cold entries
            # first; this child is the hard backstop that makes cache
            # memory visible to the parent and lets a starved node
            # refuse NEW entries (typed) while serving uncached
            "request_cache": ChildBreaker("request_cache",
                                          request_cache_limit,
                                          parent=self),
        }

    def breaker(self, name: str) -> ChildBreaker:
        return self.breakers[name]

    def check_parent(self, added: int, label: str) -> None:
        total = sum(b.used for b in self.breakers.values())
        if total > self.parent_limit > 0:
            with self._lock:
                self.parent_trip_count += 1
            raise CircuitBreakingError(
                f"[parent] data for [{label}] would be "
                f"[{total}/{_h(total)}] which is larger than the limit of "
                f"[{self.parent_limit}/{_h(self.parent_limit)}]")

    def configure(self, **limits: int) -> None:
        """configure(device=..., request=..., total=...) — tests and the
        dynamic-settings path resize budgets in place."""
        for name, limit in limits.items():
            if name in ("total", "parent"):
                self.parent_limit = int(limit)
            else:
                self.breakers[name].limit = int(limit)

    def reset(self) -> None:
        for b in self.breakers.values():
            b.used = 0
            b.trip_count = 0
        self.parent_trip_count = 0

    def stats(self) -> Dict[str, Any]:
        out = {name: b.stats() for name, b in self.breakers.items()}
        out["parent"] = {
            "limit_size_in_bytes": self.parent_limit,
            "estimated_size_in_bytes": sum(
                b.used for b in self.breakers.values()),
            "tripped": self.parent_trip_count}
        return out


# one pool of HBM per process -> one breaker service per process
BREAKERS = HierarchyCircuitBreakerService()


class DeviceCharge:
    """One accounted device allocation with an idempotent early release.

    GC-driven release (the weakref finalizer charge_device installs)
    remains the backstop, but an evicting cache (the plane registry's
    breaker-pressure path) must be able to hand the budget back BEFORE
    the last in-flight query drops its reference — otherwise the
    evict-and-retry loop can never free enough to admit the new resident.
    The transient undercount while an evicted-but-referenced array drains
    is the point of eviction, not a leak: the finalizer then no-ops."""

    __slots__ = ("_breaker", "n_bytes", "_released")

    def __init__(self, breaker: ChildBreaker, n_bytes: int):
        self._breaker = breaker
        self.n_bytes = int(n_bytes)
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._breaker.release(self.n_bytes)


def charge_device(owner: Any, n_bytes: int, label: str,
                  service: Optional[HierarchyCircuitBreakerService]
                  = None, return_charge: bool = False):
    """Charge the ``device`` breaker for ``n_bytes`` about to go resident
    on device, tying the release to ``owner``'s lifetime via a weakref
    finalizer. Call BEFORE the upload (sizes are computable from the host
    arrays) — charging after the jnp.asarray would let the very allocation
    that trips the breaker OOM the chip first. ``return_charge=True``
    returns the DeviceCharge handle for callers (eviction-driven caches)
    that need to release ahead of GC."""
    svc = service or BREAKERS
    breaker = svc.breaker("device")
    breaker.add_estimate(int(n_bytes), label)
    charge = DeviceCharge(breaker, n_bytes)
    weakref.finalize(owner, charge.release)
    return charge if return_charge else int(n_bytes)


def account_device_arrays(owner: Any, arrays, label: str,
                          service: Optional[HierarchyCircuitBreakerService]
                          = None, return_charge: bool = False):
    """charge_device() with the byte count summed from host-side arrays
    (numpy ``nbytes``). Pass the HOST arrays before converting."""
    n_bytes = 0
    for a in arrays:
        nb = getattr(a, "nbytes", None)
        if nb is None and hasattr(a, "size") and hasattr(a, "dtype"):
            nb = a.size * a.dtype.itemsize
        n_bytes += int(nb or 0)
    return charge_device(owner, n_bytes, label, service,
                         return_charge=return_charge)
