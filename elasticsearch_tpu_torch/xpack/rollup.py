"""Rollup: downsampling jobs that pre-aggregate an index into a compact
rollup index, plus _rollup_search over the rolled documents.

Reference: x-pack/plugin/rollup — RollupJobTask pages the source index
with a composite aggregation (date_histogram + terms groups), writing one
summary doc per group bucket (RollupIndexer), and
TransportRollupSearchAction rewrites searches against the rolled fields.
This build keeps the same document shape (``<field>.date_histogram.
timestamp``, ``<field>.terms.value``, ``<metric>.<op>`` columns) and runs
the indexer through the node's own composite agg + bulk path, scheduled
like the reference's cron via the transform-style timer loop.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, ResourceNotFoundError,
)

logger = logging.getLogger(__name__)

SECTION = "rollup_jobs"
TICK = 2.0
PAGE = 500


class RollupService:
    """Job registry in cluster-state custom metadata; the elected master
    runs due jobs (RollupJobTask analog on persistent tasks)."""

    def __init__(self, node) -> None:
        self.node = node
        self._running = False
        self._timer = None
        self._state: Dict[str, Dict[str, Any]] = {}   # job -> runtime

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
                for job_id, d in self._defs().items():
                    st = self._state.setdefault(job_id, {})
                    if d.get("started") and not st.get("busy"):
                        self._run_job(job_id, d)
        except Exception:  # noqa: BLE001
            logger.exception("rollup tick failed")
        self._schedule()

    def _defs(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(SECTION, {}))

    # -- API --------------------------------------------------------------

    def put_job(self, job_id: str, body: Dict[str, Any],
                on_done: Callable) -> None:
        config = dict(body or {})
        groups = config.get("groups") or {}
        if "index_pattern" not in config or "rollup_index" not in config:
            on_done(None, IllegalArgumentError(
                "rollup job requires [index_pattern] and [rollup_index]"))
            return
        if "date_histogram" not in groups:
            on_done(None, IllegalArgumentError(
                "rollup job requires a [groups.date_histogram]"))
            return
        config.setdefault("started", False)
        from elasticsearch_tpu_torch.action.admin import CREATE_INDEX, PUT_CUSTOM

        def stored(_r, e):
            on_done({"acknowledged": True} if e is None else None, e)

        def create_rollup_index(_r, e):
            if e is not None:
                on_done(None, e)
                return
            # the rolled columns need explicit types (terms values must be
            # keyword, not dynamically-mapped text) — the reference
            # creates the rollup index with its own mappings the same way
            dh = groups["date_histogram"]
            props: Dict[str, Any] = {
                f"{dh['field']}.date_histogram.timestamp":
                    {"type": "date"},
                "_rollup.id": {"type": "keyword"},
                "_rollup.doc_count": {"type": "long"},
            }
            for f in (groups.get("terms") or {}).get("fields", []):
                props[f"{f}.terms.value"] = {"type": "keyword"}
            for m in config.get("metrics", []):
                for op in m.get("metrics", []):
                    props[f"{m['field']}.{op}.value"] = {"type": "double"}
            self.node.master_client.execute(
                CREATE_INDEX, {"index": config["rollup_index"],
                               "ignore_existing": True,
                               "settings": {"number_of_replicas": 0},
                               "mappings": {"properties": props}}, stored)
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": SECTION, "name": job_id,
                         "body": config}, create_rollup_index)

    def delete_job(self, job_id: str, on_done: Callable) -> None:
        if job_id not in self._defs():
            on_done(None, ResourceNotFoundError(
                f"rollup job [{job_id}] not found"))
            return
        self._state.pop(job_id, None)
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": SECTION, "name": job_id},
            lambda r, e: on_done({"acknowledged": True}
                                 if e is None else None, e))

    def set_started(self, job_id: str, started: bool,
                    on_done: Callable) -> None:
        defs = self._defs()
        if job_id not in defs:
            on_done(None, ResourceNotFoundError(
                f"rollup job [{job_id}] not found"))
            return
        cfg = dict(defs[job_id])
        cfg["started"] = started
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": SECTION, "name": job_id, "body": cfg},
            lambda r, e: on_done({"started" if started else "stopped": True}
                                 if e is None else None, e))

    def jobs(self) -> Dict[str, Any]:
        out = []
        for job_id, d in sorted(self._defs().items()):
            st = self._state.get(job_id, {})
            out.append({"config": {**d, "id": job_id},
                        "status": {"job_state":
                                   "started" if d.get("started")
                                   else "stopped"},
                        "stats": {"documents_processed":
                                  st.get("docs", 0),
                                  "pages_processed": st.get("pages", 0)}})
        return {"jobs": out}

    # -- indexer ----------------------------------------------------------

    def _composite_body(self, d: Dict[str, Any],
                        after: Optional[Dict[str, Any]],
                        min_ts: Optional[float] = None) -> Dict[str, Any]:
        groups = d["groups"]
        dh = groups["date_histogram"]
        sources: List[Dict[str, Any]] = [{
            "ts": {"date_histogram": {
                "field": dh["field"],
                "fixed_interval": dh.get("fixed_interval",
                                         dh.get("calendar_interval",
                                                "1h"))}}}]
        for f in (groups.get("terms") or {}).get("fields", []):
            sources.append({f"t_{f}": {"terms": {"field": f}}})
        comp: Dict[str, Any] = {"sources": sources, "size": PAGE}
        if after:
            comp["after"] = after
        aggs: Dict[str, Any] = {}
        for m in d.get("metrics", []):
            for op in m.get("metrics", []):
                aggs[f"{m['field']}__{op}"] = {op: {"field": m["field"]}}
        body: Dict[str, Any] = {"size": 0, "aggs": {
            "r": {"composite": comp, **({"aggs": aggs} if aggs else {})}}}
        if min_ts is not None:
            # incremental runs re-roll only from the checkpoint bucket on
            # (the indexer's persisted-position analog; re-rolling the
            # open bucket keeps late arrivals correct since rollup doc
            # ids are deterministic per group)
            body["query"] = {"range": {dh["field"]: {"gte": min_ts}}}
        return body

    def _run_job(self, job_id: str, d: Dict[str, Any]) -> None:
        st = self._state.setdefault(job_id, {})
        st["busy"] = True
        min_ts = st.get("ckpt")   # re-roll from the open bucket onward

        def page(after):
            def cb(resp, err):
                if err is not None:
                    logger.warning("rollup [%s] failed: %s", job_id, err)
                    st["busy"] = False
                    return
                comp = (resp.get("aggregations") or {}).get("r") or {}
                buckets = comp.get("buckets", [])
                page_max_ts = None
                for b in buckets:
                    ts = b["key"].get("ts")
                    if ts is not None:
                        page_max_ts = ts if page_max_ts is None \
                            else max(page_max_ts, ts)
                items = []
                dh = d["groups"]["date_histogram"]
                for b in buckets:
                    key = b["key"]
                    # id carries key NAMES: value-only ids collide when
                    # two group fields swap values ({user:a, host:b} vs
                    # {user:b, host:a})
                    doc_id = f"{job_id}$" + "_".join(
                        f"{k}={key[k]}" for k in sorted(key))
                    src: Dict[str, Any] = {
                        "_rollup.id": job_id,
                        f"{dh['field']}.date_histogram.timestamp":
                            key.get("ts"),
                        f"{dh['field']}.date_histogram.interval":
                            dh.get("fixed_interval", "1h"),
                        "_rollup.doc_count": b["doc_count"],
                    }
                    for name, v in key.items():
                        if name.startswith("t_"):
                            src[f"{name[2:]}.terms.value"] = v
                    for agg_name, node_val in b.items():
                        if "__" in str(agg_name) and \
                                isinstance(node_val, dict):
                            f, op = agg_name.rsplit("__", 1)
                            src[f"{f}.{op}.value"] = node_val.get("value")
                    items.append({"action": "index",
                                  "index": d["rollup_index"],
                                  "id": doc_id, "source": src})
                def bulked(bulk_resp=None):
                    # counters AND the checkpoint advance only after the
                    # bulk APPLIED cleanly — a failed write must be
                    # re-rolled on the next incremental run, not skipped
                    st["pages"] = st.get("pages", 0) + 1
                    ok = not (bulk_resp or {}).get("errors")
                    if ok:
                        st["docs"] = st.get("docs", 0) + len(items)
                        if page_max_ts is not None:
                            st["ckpt"] = max(st.get("ckpt") or page_max_ts,
                                             page_max_ts)
                    after_key = comp.get("after_key")
                    if ok and after_key and len(buckets) >= PAGE:
                        page(after_key)
                    else:
                        st["busy"] = False
                if items:
                    self.node.bulk_action.execute(items, bulked)
                else:
                    bulked()
            try:
                self.node.search_action.execute(
                    d["index_pattern"],
                    self._composite_body(d, after, min_ts=min_ts), cb)
            except Exception as e:  # noqa: BLE001
                logger.warning("rollup [%s] failed: %s", job_id, e)
                st["busy"] = False
        page(None)

    # -- rollup_search -----------------------------------------------------

    def rollup_search(self, index: str, body: Dict[str, Any],
                      on_done: Callable) -> None:
        """Search over rolled docs: date_histogram / terms / metric aggs
        rewrite onto the rolled column names, with doc_count weighting
        (RollupResponseTranslator analog — the high-traffic subset)."""
        body = dict(body or {})
        aggs = body.get("aggs") or body.get("aggregations") or {}
        rewritten, post = self._rewrite_aggs(aggs)
        query = self._rewrite_query(
            index, body.get("query", {"match_all": {}}))
        req = {"size": 0, "query": query, "aggs": rewritten}

        def cb(resp, err):
            if err is not None:
                on_done(None, err)
                return
            out = resp.get("aggregations") or {}
            on_done({"took": resp.get("took", 0), "timed_out": False,
                     "hits": {"total": {"value": 0, "relation": "eq"},
                              "hits": []},
                     "aggregations": post(out)}, None)
        self.node.search_action.execute(index, req, cb)

    def _rewrite_query(self, index: str, query: Any) -> Any:
        """Field names in the user's query refer to SOURCE fields; rolled
        docs store them under .date_histogram.timestamp / .terms.value,
        so leaves rewrite against the rollup index's actual mappings
        (RollupRequestTranslator's query rewrite)."""
        try:
            props = dict(self.node._applied_state().metadata
                         .index(index).mappings
                         .get("properties", {}))
        except Exception:  # noqa: BLE001 — unknown index: pass through
            props = {}

        def rolled_name(f: str) -> str:
            for suffix in (".date_histogram.timestamp", ".terms.value"):
                if f"{f}{suffix}" in props:
                    return f"{f}{suffix}"
            return f

        def walk(q: Any) -> Any:
            if not isinstance(q, dict) or len(q) != 1:
                return q
            (kind, spec), = q.items()
            if kind == "bool":
                return {"bool": {
                    occur: ([walk(c) for c in clauses]
                            if isinstance(clauses, list) else walk(clauses))
                    if occur in ("must", "should", "must_not", "filter")
                    else clauses
                    for occur, clauses in spec.items()}}
            if kind in ("term", "terms", "range", "match") and \
                    isinstance(spec, dict) and len(spec) >= 1:
                out = {}
                for f, v in spec.items():
                    out[rolled_name(f) if isinstance(f, str) else f] = v
                return {kind: out}
            return q
        return walk(query)

    def _rewrite_aggs(self, aggs: Dict[str, Any]):
        rewritten: Dict[str, Any] = {}
        transforms: List[Callable[[Dict[str, Any]], None]] = []
        for name, entry in aggs.items():
            entry = dict(entry)
            sub = entry.pop("aggs", entry.pop("aggregations", None))
            (kind, params), = entry.items()
            params = dict(params)
            f = params.get("field")
            bucket_kind = kind in ("date_histogram", "terms")
            if kind == "date_histogram":
                params["field"] = f"{f}.date_histogram.timestamp"
                node: Dict[str, Any] = {kind: params}
            elif kind == "terms":
                params["field"] = f"{f}.terms.value"
                node = {kind: params}
            elif kind in ("sum", "min", "max", "avg", "value_count"):
                # avg over rolled docs would average the partial sums;
                # translate onto the stored column (sum/min/max survive,
                # avg re-derives from sum+value_count)
                if kind == "avg":
                    node = {"sum": {"field": f"{f}.sum.value"}}
                    rewritten[f"__{name}_count"] = {
                        "sum": {"field": f"{f}.value_count.value"}}

                    def fix_avg(out, name=name):
                        total = (out.pop(f"__{name}_count", {})
                                 or {}).get("value") or 0.0
                        s = (out.get(name) or {}).get("value")
                        out[name] = {"value": (s / total)
                                     if s is not None and total else None}
                    transforms.append(fix_avg)
                else:
                    col = "value_count" if kind == "value_count" else kind
                    agg_op = "sum" if kind in ("sum", "value_count") \
                        else kind
                    node = {agg_op: {"field": f"{f}.{col}.value"}}
            else:
                raise IllegalArgumentError(
                    f"rollup_search does not support agg [{kind}]")
            if sub:
                sub_rw, sub_post = self._rewrite_aggs(sub)
                node["aggs"] = sub_rw

                def fix_sub(out, name=name, sub_post=sub_post):
                    node_out = out.get(name) or {}
                    for b in node_out.get("buckets", []):
                        sub_post(b)
                transforms.append(fix_sub)
            if bucket_kind:
                # a bucket's doc_count must weight by the SOURCE doc
                # count each rollup row summarizes, not count rollup rows
                # (RollupResponseTranslator doc-count weighting)
                node.setdefault("aggs", {})["__rollup_dc"] = {
                    "sum": {"field": "_rollup.doc_count"}}

                def fix_dc(out, name=name):
                    node_out = out.get(name) or {}
                    for b in node_out.get("buckets", []):
                        dc = b.pop("__rollup_dc", None)
                        if dc and dc.get("value") is not None:
                            b["doc_count"] = int(dc["value"])
                transforms.append(fix_dc)
            rewritten[name] = node

        def post(out: Dict[str, Any]) -> Dict[str, Any]:
            for t in transforms:
                t(out)
            return out
        return rewritten, post
