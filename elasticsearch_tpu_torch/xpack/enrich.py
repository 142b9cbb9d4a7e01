"""Enrich: lookup policies + the enrich ingest processor.

Reference: x-pack/plugin/enrich — a policy names a source index, a
match_field, and enrich_fields; executing the policy builds a compact
system index (EnrichPolicyRunner), and the ``enrich`` ingest processor
joins documents against it at ingest time via an in-memory lookup
(MatchProcessor backed by a searcher over the enrich index). This build
executes a policy into an in-cluster-state lookup table (bounded), which
both makes the table replicate to every ingest node for free and keeps
the processor a pure dict lookup — the reference's per-node enrich index
reader collapsed to its essential form.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, ResourceNotFoundError,
)

logger = logging.getLogger(__name__)

POLICY_SECTION = "enrich_policies"
TABLE_SECTION = "enrich_tables"
MAX_TABLE_ENTRIES = 10_000


class EnrichService:
    def __init__(self, node) -> None:
        self.node = node
        # (state version, name) -> table: read-only lookups must not copy
        # a 10k-entry dict once per ingested document
        self._table_cache: Dict[str, Any] = {}

    def _policies(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.custom.get(POLICY_SECTION, {}))

    def table(self, policy_name: str) -> Dict[str, Any]:
        state = self.node._applied_state()
        cached = self._table_cache.get(policy_name)
        if cached is not None and cached[0] == state.version:
            return cached[1]
        table = state.metadata.custom.get(TABLE_SECTION, {}) \
            .get(policy_name, {})
        self._table_cache[policy_name] = (state.version, table)
        return table

    # -- API --------------------------------------------------------------

    def put_policy(self, name: str, body: Dict[str, Any],
                   on_done: Callable) -> None:
        body = body or {}
        match = body.get("match") or body.get("range")
        if not match:
            on_done(None, IllegalArgumentError(
                "enrich policy requires [match]"))
            return
        for req in ("indices", "match_field", "enrich_fields"):
            if req not in match:
                on_done(None, IllegalArgumentError(
                    f"enrich policy requires [match.{req}]"))
                return
        from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
        self.node.master_client.execute(
            PUT_CUSTOM, {"section": POLICY_SECTION, "name": name,
                         "body": body},
            lambda r, e: on_done({"acknowledged": True}
                                 if e is None else None, e))

    def delete_policy(self, name: str, on_done: Callable) -> None:
        if name not in self._policies():
            on_done(None, ResourceNotFoundError(
                f"enrich policy [{name}] not found"))
            return
        from elasticsearch_tpu_torch.action.admin import DELETE_CUSTOM

        def table_deleted(_r, _e):
            self.node.master_client.execute(
                DELETE_CUSTOM, {"section": POLICY_SECTION, "name": name},
                lambda r, e: on_done({"acknowledged": True}
                                     if e is None else None, e))
        self.node.master_client.execute(
            DELETE_CUSTOM, {"section": TABLE_SECTION, "name": name},
            table_deleted)

    def execute_policy(self, name: str, on_done: Callable) -> None:
        """Scan the source indices and publish the match_field -> fields
        lookup table (EnrichPolicyRunner's index rebuild)."""
        policy = self._policies().get(name)
        if policy is None:
            on_done(None, ResourceNotFoundError(
                f"enrich policy [{name}] not found"))
            return
        match = policy.get("match") or policy.get("range")
        indices = match["indices"]
        # ALL source indices feed the table (the expression layer takes
        # comma-joined lists)
        index = ",".join(indices) if isinstance(indices, list) else indices
        match_field = match["match_field"]
        enrich_fields = list(match["enrich_fields"])

        def cb(resp, err):
            if err is not None:
                on_done(None, err)
                return
            table: Dict[str, Any] = {}
            for h in resp["hits"]["hits"]:
                src = h.get("_source", {})
                key = src.get(match_field)
                if key is None:
                    continue
                table[str(key)] = {f: src.get(f) for f in enrich_fields
                                   if f in src}
                if len(table) >= MAX_TABLE_ENTRIES:
                    break
            from elasticsearch_tpu_torch.action.admin import PUT_CUSTOM
            self.node.master_client.execute(
                PUT_CUSTOM, {"section": TABLE_SECTION, "name": name,
                             "body": table},
                lambda r, e: on_done(
                    {"status": {"phase": "COMPLETE"},
                     "entries": len(table)} if e is None else None, e))
        self.node.search_action.execute(index, {
            "query": {"match_all": {}}, "size": MAX_TABLE_ENTRIES}, cb)

    def policies(self) -> Dict[str, Any]:
        return {"policies": [
            {"config": {("match" if "match" in p else "range"): {
                **(p.get("match") or p.get("range") or {}), "name": name}}}
            for name, p in sorted(self._policies().items())]}


def validate_enrich_config(config: Dict[str, Any]) -> None:
    if not config.get("policy_name") or not config.get("field") or \
            not config.get("target_field"):
        raise IllegalArgumentError(
            "enrich processor requires [policy_name], [field], "
            "[target_field]")


def make_enrich_processor(node, config: Dict[str, Any]):
    """The ``enrich`` ingest processor (MatchProcessor analog): joins the
    document's field value against the executed policy table."""
    validate_enrich_config(config)
    policy_name = config["policy_name"]
    field = config["field"]
    target = config["target_field"]
    max_matches = int(config.get("max_matches", 1))
    override = bool(config.get("override", True))

    def process(doc: Dict[str, Any]) -> Dict[str, Any]:
        """Receives the full ingest document (with _source), like every
        other processor; field paths are dotted."""
        from elasticsearch_tpu_torch.ingest import get_field, set_field
        table = node.enrich_service.table(policy_name)
        value = get_field(doc, field)
        if value is None:
            return doc
        values = value if isinstance(value, list) else [value]
        matches = [table[str(v)] for v in values if str(v) in table]
        if not matches:
            return doc
        if not override and get_field(doc, target) is not None:
            return doc
        set_field(doc, target,
                  matches[0] if max_matches == 1 else matches[:max_matches])
        return doc
    return process
