"""Deprecation info API: scan cluster + index config for discouraged
patterns.

Reference: x-pack/plugin/deprecation — DeprecationInfoAction runs a
registry of cluster/node/index checks and buckets findings by level
(warning/critical). The checks here cover this build's own discouraged
surface; the registry shape (predicate -> issue dict) matches the
reference's DeprecationChecks so new rules are one-liners.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


def _issue(level: str, message: str, details: str) -> Dict[str, Any]:
    return {"level": level, "message": message, "details": details,
            "url": "https://ela.st/deprecations"}


# -- cluster-level checks ----------------------------------------------------

def _check_awareness_without_attrs(state) -> Optional[Dict]:
    settings = state.metadata.persistent_settings
    attrs = settings.get("cluster.routing.allocation.awareness.attributes")
    if not attrs:
        return None
    used = {k for n in state.nodes.values() for k, _v in n.attrs}
    missing = [a.strip() for a in str(attrs).split(",")
               if a.strip() and a.strip() not in used]
    if missing:
        return _issue(
            "warning",
            "awareness attributes configured but absent from every node",
            f"attributes {missing} appear in "
            f"cluster.routing.allocation.awareness.attributes but no "
            f"node carries them; allocation awareness is a no-op")
    return None


CLUSTER_CHECKS: List[Callable] = [
    _check_awareness_without_attrs,
]


# -- index-level checks ------------------------------------------------------

def _check_zero_replicas_multinode(meta, state) -> Optional[Dict]:
    if meta.number_of_replicas == 0 and len(state.data_nodes()) > 1:
        return _issue(
            "warning",
            "index has no replicas on a multi-node cluster",
            f"[{meta.name}] has number_of_replicas=0; a single node "
            f"loss makes it red")
    return None


def _check_excess_replicas(meta, state) -> Optional[Dict]:
    n_data = max(len(state.data_nodes()), 1)
    if meta.number_of_replicas > n_data - 1:
        return _issue(
            "warning",
            "more replicas than can ever be assigned",
            f"[{meta.name}] wants {meta.number_of_replicas} replicas "
            f"but only {n_data} data nodes exist; the index stays "
            f"yellow permanently")
    return None


def _check_async_durability(meta, state) -> Optional[Dict]:
    if str(meta.settings.get("index.translog.durability", "")
           ).lower() == "async":
        return _issue(
            "warning",
            "async translog durability risks acknowledged-write loss",
            f"[{meta.name}] sets index.translog.durability=async; "
            f"acknowledged writes since the last sync are lost on crash")
    return None


def _check_frozen(meta, state) -> Optional[Dict]:
    if meta.settings.get("index.frozen"):
        return _issue(
            "warning",
            "frozen indices are deprecated in favor of searchable "
            "snapshots",
            f"[{meta.name}] is frozen; mount it from a snapshot instead")
    return None


INDEX_CHECKS: List[Callable] = [
    _check_zero_replicas_multinode,
    _check_excess_replicas,
    _check_async_durability,
    _check_frozen,
]


def deprecations(state) -> Dict[str, Any]:
    """GET /_migration/deprecations response body."""
    cluster_issues = [i for i in (c(state) for c in CLUSTER_CHECKS)
                      if i is not None]
    index_issues: Dict[str, List[Dict[str, Any]]] = {}
    for meta in state.metadata.indices.values():
        found = [i for i in (c(meta, state) for c in INDEX_CHECKS)
                 if i is not None]
        if found:
            index_issues[meta.name] = found
    return {"cluster_settings": cluster_issues,
            "node_settings": [],
            "index_settings": index_issues,
            "ml_settings": []}
