"""Anomaly detection jobs: bucketed metrics scored against an online
baseline, results queryable as records.

Reference: x-pack/plugin/ml — anomaly detection jobs run in external C++
autodetect processes fed by datafeeds (NativeAutodetectProcessFactory,
DatafeedJob), modeling per-bucket metric distributions and emitting
record/bucket anomaly scores. SURVEY singles this native boundary out
for a TPU-native re-design: here the datafeed is the node's own
date_histogram aggregation (device partial-aggs), and the model is an
exponentially-decayed Gaussian baseline per (detector, by-field value)
scored in one vectorized pass — the autodetect process collapsed into
the data plane. Supported detector functions: count, mean, sum, min,
max, high_count, low_count, high_mean, low_mean.

Results land in ``.ml-anomalies-<job>`` as record docs
(record_score 0..100, actual, typical, timestamp), the reference's
results-index shape.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, ResourceNotFoundError,
)

logger = logging.getLogger(__name__)

SECTION = "ml_jobs"
TICK = 2.0
# decay of the baseline toward new data (one-sided EWMA; the reference
# decays model memory similarly per bucket)
ALPHA = 0.3
MIN_BUCKETS_TO_SCORE = 3


class _Baseline:
    """Online Gaussian with exponential decay (Welford + EWMA hybrid)."""

    __slots__ = ("n", "mean", "var")

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def score(self, x: float, sided: str = "both") -> float:
        """Anomaly score 0..100 BEFORE updating with x."""
        if self.n < MIN_BUCKETS_TO_SCORE:
            return 0.0
        # variance floor: 0.1% of the mean, RELATIVE only. This keeps
        # float jitter on large gauges quiet (jitter scales with the
        # mean) while sub-unit-scale metrics (rates in 0..1) keep full
        # sensitivity — an absolute floor blinded them entirely. A
        # perfectly constant stream that suddenly steps DOES score
        # maximally; that is deliberate: deviation from a zero-variance
        # baseline is the strongest possible anomaly signal (the
        # reference's autodetect flags it the same way).
        floor_std = max(0.001 * abs(self.mean), 1e-9)
        std = math.sqrt(max(self.var, floor_std * floor_std))
        z = (x - self.mean) / std if std > 0 else 0.0
        if sided == "high":
            z = max(z, 0.0)
        elif sided == "low":
            z = max(-z, 0.0)
        else:
            z = abs(z)
        # squash |z| to 0..100: z=3 ~ 39, z=6 ~ 78, z>=10 ~ 97
        return 100.0 * (1.0 - math.exp(-max(z - 2.0, 0.0) / 3.0))

    def update(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
            self.var = 0.0
        else:
            delta = x - self.mean
            self.mean += ALPHA * delta
            self.var = (1 - ALPHA) * (self.var + ALPHA * delta * delta)
        self.n += 1


_FUNCTIONS = {"count", "sum", "mean", "avg", "min", "max",
              "high_count", "low_count", "high_mean", "low_mean"}


def _sidedness(fn: str) -> str:
    if fn.startswith("high_"):
        return "high"
    if fn.startswith("low_"):
        return "low"
    return "both"


def _base_fn(fn: str) -> str:
    for prefix in ("high_", "low_"):
        if fn.startswith(prefix):
            fn = fn[len(prefix):]
    return {"mean": "avg"}.get(fn, fn)


class MlJobService:
    """Job registry + the master-side bucket processor (DatafeedJob +
    autodetect collapsed)."""

    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        # job -> {"baselines": {(det_idx, by_value): _Baseline},
        #         "ckpt": last processed bucket ts, "busy": bool,
        #         "records": int, "buckets": int}
        self._state: Dict[str, Dict[str, Any]] = {}

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
        self._timer = self.node.scheduler.schedule(TICK, self._tick)

    def _tick(self) -> None:
        if not self._running:
            return
        try:
            if self.node.coordinator.mode == "LEADER":
                defs = self._defs()
                # prune runtime state of deleted jobs — the DELETE may
                # have landed on another node, and a recreated job with
                # the same id must not inherit dead baselines/ckpt
                for stale in [j for j in self._state if j not in defs]:
                    self._state.pop(stale, None)
                for job_id, d in defs.items():
                    st = self._state.setdefault(job_id, {})
                    if d.get("opened") and not st.get("busy"):
                        self._process(job_id, d)
        except Exception:  # noqa: BLE001
            logger.exception("ml tick failed")
        self._schedule()

    def _defs(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(SECTION, {}))

    # -- API --------------------------------------------------------------

    def put_job(self, job_id: str, body: Dict[str, Any],
                on_done: Callable) -> None:
        if job_id in self._defs():
            err = IllegalArgumentError(
                f"The job cannot be created with the Id '{job_id}'. "
                f"The Id is already used (resource_already_exists)")
            err.status = 409
            on_done(None, err)
            return
        body = dict(body or {})
        analysis = body.get("analysis_config") or {}
        detectors = analysis.get("detectors") or []
        if not detectors:
            on_done(None, IllegalArgumentError(
                "ml job requires [analysis_config.detectors]"))
            return
        for det in detectors:
            fn = det.get("function")
            if fn not in _FUNCTIONS:
                on_done(None, IllegalArgumentError(
                    f"unsupported detector function [{fn}]; supported: "
                    f"{sorted(_FUNCTIONS)}"))
                return
            if _base_fn(fn) != "count" and not det.get("field_name"):
                on_done(None, IllegalArgumentError(
                    f"detector function [{fn}] requires [field_name]"))
                return
        datafeed = body.get("datafeed_config") or {}
        if not datafeed.get("indices"):
            on_done(None, IllegalArgumentError(
                "ml job requires [datafeed_config.indices]"))
            return
        body.setdefault("opened", False)
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": SECTION, "name": job_id, "body": body},
            lambda r, e: on_done(
                {"job_id": job_id, "acknowledged": True}
                if e is None else None, e))

    def delete_job(self, job_id: str, on_done: Callable) -> None:
        if job_id not in self._defs():
            on_done(None, ResourceNotFoundError(
                f"ml job [{job_id}] not found"))
            return
        self._state.pop(job_id, None)
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": SECTION, "name": job_id},
            lambda r, e: on_done({"acknowledged": True}
                                 if e is None else None, e))

    def set_opened(self, job_id: str, opened: bool,
                   on_done: Callable) -> None:
        defs = self._defs()
        if job_id not in defs:
            on_done(None, ResourceNotFoundError(
                f"ml job [{job_id}] not found"))
            return
        cfg = dict(defs[job_id])
        cfg["opened"] = opened
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": SECTION, "name": job_id, "body": cfg},
            lambda r, e: on_done({"opened" if opened else "closed": True}
                                 if e is None else None, e))

    def jobs(self, job_id: Optional[str] = None) -> Dict[str, Any]:
        out = []
        for jid, d in sorted(self._defs().items()):
            if job_id is not None and jid != job_id:
                continue
            st = self._state.get(jid, {})
            out.append({
                "job_id": jid,
                "state": "opened" if d.get("opened") else "closed",
                "analysis_config": d.get("analysis_config", {}),
                "data_counts": {
                    "processed_bucket_count": st.get("buckets", 0),
                    "record_count": st.get("records", 0)}})
        if job_id is not None and not out:
            raise ResourceNotFoundError(f"ml job [{job_id}] not found")
        return {"count": len(out), "jobs": out}

    def records(self, job_id: str, on_done: Callable,
                min_score: float = 0.0, from_: int = 0,
                size: int = 100, desc: bool = False) -> None:
        def cb(resp, err):
            if err is not None:
                from elasticsearch_tpu_torch.utils.errors import (
                    IndexNotFoundError,
                )
                if isinstance(err, IndexNotFoundError):
                    # no anomalies recorded yet: empty result set
                    on_done({"count": 0, "records": []}, None)
                else:
                    # overload/outage must NOT read as "no anomalies"
                    on_done(None, err)
                return
            records = [h["_source"] for h in resp["hits"]["hits"]]
            on_done({"count": resp["hits"]["total"]["value"],
                     "records": records}, None)
        self.node.search_action.execute(
            f".ml-anomalies-{job_id}",
            {"query": {"range": {"record_score": {"gte": min_score}}},
             "from": int(from_), "size": min(int(size), 1000),
             "track_total_hits": True,
             "sort": [{"timestamp": "desc" if desc else "asc"}]}, cb)

    # -- bucket processing -------------------------------------------------

    def _process(self, job_id: str, d: Dict[str, Any]) -> None:
        st = self._state.setdefault(job_id, {})
        st["busy"] = True
        analysis = d.get("analysis_config") or {}
        datafeed = d.get("datafeed_config") or {}
        span = str(analysis.get("bucket_span", "5m"))
        time_field = (d.get("data_description") or {}).get(
            "time_field", "@timestamp")
        detectors = analysis.get("detectors") or []
        indices = datafeed["indices"]
        index = ",".join(indices) if isinstance(indices, list) else indices

        aggs: Dict[str, Any] = {}
        for i, det in enumerate(detectors):
            fn = _base_fn(det.get("function", "count"))
            by = det.get("by_field_name")
            metric = ({"value_count": {"field": time_field}}
                      if fn == "count" and not det.get("field_name")
                      else {fn if fn != "count" else "value_count":
                            {"field": det.get("field_name", time_field)}})
            node: Dict[str, Any] = {f"m{i}": metric}
            if by:
                aggs[f"d{i}"] = {"terms": {"field": by, "size": 100},
                                 "aggs": node}
            else:
                aggs[f"d{i}"] = {"filter": {"match_all": {}},
                                 "aggs": node}
        body: Dict[str, Any] = {
            "size": 0,
            "query": datafeed.get("query", {"match_all": {}}),
            "aggs": {"buckets": {
                "date_histogram": {"field": time_field,
                                   "fixed_interval": span},
                "aggs": aggs}}}
        ckpt = st.get("ckpt")
        if ckpt is not None:
            # ckpt is the START of the first UNPROCESSED bucket (the one
            # held back as still-filling), so gte re-forms exactly it and
            # later data — never a bucket whose baseline update already
            # happened (baseline updates are not idempotent)
            body["query"] = {"bool": {"filter": [
                body["query"],
                {"range": {time_field: {"gte": ckpt}}}]}}

        def cb(resp, err):
            if err is not None:
                logger.warning("ml job [%s] datafeed failed: %s",
                               job_id, err)
                st["busy"] = False
                return
            all_buckets = ((resp.get("aggregations") or {})
                           .get("buckets") or {}).get("buckets", [])
            # the LAST bucket may still be filling: hold it back; its
            # start key becomes the next run's resume point
            buckets = all_buckets[:-1]
            records = self._score_buckets(job_id, d, st, detectors,
                                          buckets)
            if buckets:
                st["ckpt"] = all_buckets[-1]["key"]
                st["buckets"] = st.get("buckets", 0) + len(buckets)

            def written(_r=None):
                st["records"] = st.get("records", 0) + len(records)
                st["busy"] = False
            if records:
                self.node.bulk_action.execute(records, written)
            else:
                written()
        try:
            self.node.search_action.execute(index, body, cb)
        except Exception as e:  # noqa: BLE001
            logger.warning("ml job [%s] failed: %s", job_id, e)
            st["busy"] = False

    def _score_buckets(self, job_id, d, st, detectors, buckets
                       ) -> List[Dict[str, Any]]:
        baselines = st.setdefault("baselines", {})
        records: List[Dict[str, Any]] = []
        for b in buckets:
            ts = b["key"]
            for i, det in enumerate(detectors):
                fn = det.get("function", "count")
                sided = _sidedness(fn)
                node = b.get(f"d{i}") or {}
                if "buckets" in node:        # by-field split
                    entries = [(e["key"],
                                self._metric_value(e, i, det, e))
                               for e in node["buckets"]]
                else:
                    entries = [(None, self._metric_value(node, i, det, b))]
                for by_value, actual in entries:
                    if actual is None:
                        continue
                    key = (i, by_value)
                    base = baselines.get(key)
                    if base is None:
                        base = baselines[key] = _Baseline()
                    score = base.score(actual, sided)
                    typical = base.mean
                    base.update(actual)
                    if score >= float(
                            d.get("min_record_score", 30.0)):
                        rec = {
                            "job_id": job_id, "result_type": "record",
                            "timestamp": ts, "detector_index": i,
                            "function": fn,
                            "field_name": det.get("field_name"),
                            "record_score": round(score, 2),
                            "actual": actual,
                            "typical": round(typical, 4),
                        }
                        if by_value is not None:
                            rec["by_field_value"] = by_value
                        records.append({
                            "action": "index",
                            "index": f".ml-anomalies-{job_id}",
                            "id": f"{job_id}-{ts}-{i}-{by_value}",
                            "source": rec})
        return records

    def _metric_value(self, node, i, det, bucket) -> Optional[float]:
        fn = _base_fn(det.get("function", "count"))
        if fn == "count" and not det.get("field_name"):
            v = bucket.get("doc_count")
            return float(v) if v is not None else None
        m = node.get(f"m{i}") or {}
        v = m.get("value")
        return float(v) if v is not None else None
