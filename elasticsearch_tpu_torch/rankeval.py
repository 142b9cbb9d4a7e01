"""Ranking evaluation: IR quality metrics over rated documents.

Reference analog: modules/rank-eval/ — precision@k (PrecisionAtK),
recall@k (RecallAtK.java), MRR (MeanReciprocalRank.java), (N)DCG
(DiscountedCumulativeGain.java), ERR (ExpectedReciprocalRank.java).
The harness SURVEY.md flags as the quality-measurement substrate.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

DoneFn = Callable[[Optional[Dict[str, Any]], Optional[Exception]], None]


def _metric_value(metric_name: str, metric_params: Dict[str, Any],
                  hit_ids: List[str],
                  ratings: Dict[str, int]) -> float:
    k = int(metric_params.get("k", 10))
    threshold = int(metric_params.get("relevant_rating_threshold", 1))
    relevant = {d for d, r in ratings.items() if r >= threshold}
    top = hit_ids[:k]

    if metric_name == "precision":
        if not top:
            return 0.0
        return len([d for d in top if d in relevant]) / len(top)
    if metric_name == "recall":
        if not relevant:
            return 0.0
        return len([d for d in top if d in relevant]) / len(relevant)
    if metric_name == "mean_reciprocal_rank":
        for rank, d in enumerate(top, start=1):
            if d in relevant:
                return 1.0 / rank
        return 0.0
    if metric_name == "dcg":
        normalize = bool(metric_params.get("normalize", False))
        dcg = sum((2 ** ratings.get(d, 0) - 1) / math.log2(i + 2)
                  for i, d in enumerate(top))
        if not normalize:
            return dcg
        ideal = sorted(ratings.values(), reverse=True)[:k]
        idcg = sum((2 ** r - 1) / math.log2(i + 2)
                   for i, r in enumerate(ideal))
        return dcg / idcg if idcg else 0.0
    if metric_name == "expected_reciprocal_rank":
        max_r = int(metric_params.get("maximum_relevance",
                                      max(ratings.values(), default=1)))
        p_left = 1.0
        err = 0.0
        for rank, d in enumerate(top, start=1):
            ri = (2 ** ratings.get(d, 0) - 1) / (2 ** max_r)
            err += p_left * ri / rank
            p_left *= (1 - ri)
        return err
    raise IllegalArgumentError(f"unknown rank-eval metric "
                               f"[{metric_name}]")


class RankEvalAction:
    def __init__(self, node):
        self.node = node

    def execute(self, index: str, body: Dict[str, Any],
                on_done: DoneFn) -> None:
        requests = (body or {}).get("requests")
        metric_spec = (body or {}).get("metric")
        if not requests or not metric_spec:
            on_done(None, IllegalArgumentError(
                "_rank_eval requires [requests] and [metric]"))
            return
        if not isinstance(metric_spec, dict) or len(metric_spec) != 1:
            on_done(None, IllegalArgumentError(
                "_rank_eval requires exactly one metric"))
            return
        (metric_name, metric_params), = metric_spec.items()
        metric_params = metric_params or {}
        if metric_name not in ("precision", "recall",
                               "mean_reciprocal_rank", "dcg",
                               "expected_reciprocal_rank"):
            # validated BEFORE the fan-out: raising inside a transport
            # callback would orphan in-flight searches
            on_done(None, IllegalArgumentError(
                f"unknown rank-eval metric [{metric_name}]"))
            return
        k = int(metric_params.get("k", 10))

        details: Dict[str, Any] = {}
        scores: List[float] = []
        pending = {"n": len(requests)}
        failures: Dict[str, Any] = {}

        def one(spec: Dict[str, Any]) -> None:
            rid = spec.get("id")
            ratings = {r["_id"]: int(r.get("rating", 0))
                       for r in spec.get("ratings", [])}

            def cb(resp, err=None):
                if err is not None:
                    failures[rid] = {"type": type(err).__name__,
                                     "reason": str(err)}
                else:
                    hit_ids = [h["_id"] for h in resp["hits"]["hits"]]
                    value = _metric_value(metric_name, metric_params,
                                          hit_ids, ratings)
                    scores.append(value)
                    details[rid] = {
                        "metric_score": round(value, 6),
                        "unrated_docs": [
                            {"_index": h["_index"], "_id": h["_id"]}
                            for h in resp["hits"]["hits"][:k]
                            if h["_id"] not in ratings],
                        "hits": [{"hit": {"_index": h["_index"],
                                          "_id": h["_id"],
                                          "_score": h.get("_score")},
                                  "rating": ratings.get(h["_id"])}
                                 for h in resp["hits"]["hits"][:k]],
                    }
                pending["n"] -= 1
                if pending["n"] == 0:
                    on_done({
                        "metric_score": round(
                            sum(scores) / len(scores), 6) if scores
                        else 0.0,
                        "details": details,
                        "failures": failures,
                    }, None)

            # a bad template must become a per-request failure, not a
            # synchronous raise that orphans the other fan-out legs
            try:
                search_body = dict(spec.get("request") or {})
                if spec.get("template_id") is not None:
                    from elasticsearch_tpu_torch.script.mustache import (
                        render_search_body,
                    )
                    search_body = render_search_body(
                        {"id": spec["template_id"],
                         "params": spec.get("params")},
                        self.node.client.get_stored_script)
                search_body.setdefault("size", max(k, 10))
            except Exception as e:  # noqa: BLE001 — per-request failure
                cb(None, e)
                return
            self.node.client.search(
                spec.get("index", index), search_body, cb)
        for spec in requests:
            one(spec)
