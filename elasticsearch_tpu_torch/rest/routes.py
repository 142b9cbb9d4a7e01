"""The REST API surface: route registrations mapping URLs to NodeClient.

Reference analog: the ~180 Rest*Action handlers under rest/action/ plus the
rest-api-spec JSON endpoint specs (143 files). Routes and parameter names
follow the reference's specs so existing clients' muscle memory works:
document CRUD, _bulk NDJSON, _search/_count, index admin, _cluster/*,
_cat/* human tables, _nodes, _aliases.
"""

from __future__ import annotations

import json
import re
import uuid as uuid_mod
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.action.bulk import parse_bulk_body
from elasticsearch_tpu_torch.cluster.routing import ShardState
from elasticsearch_tpu_torch.node.node import NodeClient
from elasticsearch_tpu_torch.rest.controller import (
    RestController, RestRequest, respond_error, wrap_client_cb,
)
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
from elasticsearch_tpu_torch.version import __version__

DoneFn = Callable[[int, Any], None]


def _thread_search_params(query: Dict[str, Any], body: Dict[str, Any],
                          keys=("allow_partial_search_results", "timeout"),
                          override: bool = False) -> Dict[str, Any]:
    """Request-level search params thread into the body; values pass
    through raw — the action layer validates and 400s. Shared by
    _search, _msearch (per line), and async-search submit so the three
    surfaces can't drift. ``override=True`` makes the query param beat an
    explicit body value (_search's long-standing precedence); the default
    only fills in missing keys (msearch/async defaulting, where the more
    specific per-line/body value wins)."""
    for key in keys:
        if key in query and (override or key not in body):
            body[key] = query[key]
    return body


def build_controller(client: NodeClient) -> RestController:
    rc = RestController()
    r = rc.register

    # -- root ------------------------------------------------------------
    def root(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        done(200, {
            "name": client.node.node_id,
            "cluster_name": state.cluster_name,
            "version": {"number": __version__,
                        "build_flavor": "tpu-native"},
            "tagline": "You Know, for Search",
        })
    r("GET", "/", root)

    # -- document CRUD ----------------------------------------------------

    def doc_index(req: RestRequest, done: DoneFn) -> None:
        doc_id = req.params.get("id") or uuid_mod.uuid4().hex[:20]
        op_type = req.param("op_type", "index")
        refresh = req.query.get("refresh")

        def cb(resp, err=None):
            if err is not None:
                respond_error(done, err)
                return
            result = dict(resp)
            status = result.pop("status", 200)
            if refresh in ("true", "wait_for", ""):
                client.refresh(req.params["index"],
                               lambda _r, _e=None: done(status, result))
            else:
                done(status, result)
        client.index_doc(req.params["index"], doc_id, req.body or {}, cb,
                         routing=req.query.get("routing"),
                         op_type=op_type,
                         if_seq_no=_int_param(req, "if_seq_no", None),
                         if_primary_term=_int_param(
                             req, "if_primary_term", None),
                         pipeline=req.query.get("pipeline"))

    def doc_create(req: RestRequest, done: DoneFn) -> None:
        req.query["op_type"] = "create"
        doc_index(req, done)

    r("PUT", "/{index}/_doc/{id}", doc_index)
    r("POST", "/{index}/_doc/{id}", doc_index)
    r("POST", "/{index}/_doc", doc_index)
    r("PUT", "/{index}/_create/{id}", doc_create)
    r("POST", "/{index}/_create/{id}", doc_create)

    def doc_get(req: RestRequest, done: DoneFn) -> None:
        def cb(resp, err=None):
            if err is not None:
                respond_error(done, err)
            elif not resp.get("found"):
                done(404, resp)
            else:
                done(200, resp)
        client.get(req.params["index"], req.params["id"], cb,
                   routing=req.query.get("routing"),
                   realtime=req.flag("realtime", True))
    r("GET", "/{index}/_doc/{id}", doc_get)

    def doc_source(req: RestRequest, done: DoneFn) -> None:
        def cb(resp, err=None):
            if err is not None:
                respond_error(done, err)
            elif not resp.get("found"):
                done(404, {})
            else:
                done(200, resp["_source"])
        client.get(req.params["index"], req.params["id"], cb)
    r("GET", "/{index}/_source/{id}", doc_source)

    def doc_delete(req: RestRequest, done: DoneFn) -> None:
        def cb(resp, err=None):
            if err is not None:
                respond_error(done, err)
                return
            status = 200 if resp.get("result") == "deleted" else 404
            resp.pop("status", None)
            done(status, resp)
        client.delete_doc(req.params["index"], req.params["id"], cb,
                          routing=req.query.get("routing"))
    r("DELETE", "/{index}/_doc/{id}", doc_delete)

    def doc_update(req: RestRequest, done: DoneFn) -> None:
        def cb(resp, err=None):
            if err is not None:
                respond_error(done, err)
            else:
                resp = dict(resp)
                resp.pop("status", None)
                done(200, resp)
        client.update(req.params["index"], req.params["id"], req.body or {},
                      cb, routing=req.query.get("routing"),
                      retry_on_conflict=_int_param(
                          req, "retry_on_conflict", 3))
    r("POST", "/{index}/_update/{id}", doc_update)

    # -- bulk -------------------------------------------------------------

    def bulk(req: RestRequest, done: DoneFn) -> None:
        default_index = req.params.get("index")
        lines = []
        for line in req.raw_body.decode("utf-8").splitlines():
            line = line.strip()
            if line:
                lines.append(json.loads(line))
        items = parse_bulk_body(lines)
        default_pipeline = req.query.get("pipeline")
        for item in items:
            if item["index"] is None:
                item["index"] = default_index
            if default_pipeline and "pipeline" not in item:
                item["pipeline"] = default_pipeline
            if item["index"] is None:
                raise IllegalArgumentError(
                    "explicit index in bulk is required")

        def cb(resp, err=None):
            if err is not None:
                respond_error(done, err)
                return
            if resp.get("rejected"):
                # indexing-pressure rejection surfaces as HTTP 429 so
                # client backoff logic keyed on status codes engages
                done(429, resp)
                return
            if req.query.get("refresh") in ("true", "wait_for", ""):
                indices = ",".join({i["index"] for i in items})
                client.refresh(indices,
                               lambda _r, _e=None: done(200, resp))
            else:
                done(200, resp)
        # charge the RAW NDJSON length at the coordinating stage — the
        # wire payload is already in hand, so admission costs zero
        # re-serialization (IndexingPressure charges request bytes)
        client.bulk(items, cb, payload_bytes=len(req.raw_body))
    r("POST", "/_bulk", bulk)
    r("PUT", "/_bulk", bulk)
    r("POST", "/{index}/_bulk", bulk)

    # -- search -----------------------------------------------------------

    def search(req: RestRequest, done: DoneFn) -> None:
        index = req.params.get("index", "_all")
        body = dict(req.body or {})
        if "size" in req.query:
            body["size"] = _int_param(req, "size")
        if "from" in req.query:
            body["from"] = _int_param(req, "from")
        q = req.query.get("q")
        if q:
            body["query"] = _uri_query(q)
        if "sort" in req.query:
            body["sort"] = [
                ({part.split(":")[0]: part.split(":")[1]}
                 if ":" in part else part)
                for part in req.query["sort"].split(",")]
        if "ignore_throttled" in req.query:
            req.deprecate(
                "[ignore_throttled] parameter is deprecated because "
                "frozen indices have been deprecated. Consider cold or "
                "frozen tiers in place of frozen indices.")
            body["ignore_throttled"] = \
                req.query["ignore_throttled"] not in ("false", "0")
        if "max_concurrent_shard_requests" in req.query:
            # passed through raw; the action layer validates and 400s
            body["max_concurrent_shard_requests"] = \
                req.query["max_concurrent_shard_requests"]
        _thread_search_params(req.query, body, override=True)
        search_type = req.query.get("search_type", "query_then_fetch")
        client.search(index, body, wrap_client_cb(done),
                      search_type=search_type)
    r("GET", "/_search", search)
    r("POST", "/_search", search)
    r("GET", "/{index}/_search", search)
    r("POST", "/{index}/_search", search)

    def count(req: RestRequest, done: DoneFn) -> None:
        index = req.params.get("index", "_all")
        body = dict(req.body or {})
        q = req.query.get("q")
        if q:
            body["query"] = _uri_query(q)
        client.count(index, body, wrap_client_cb(done))
    r("GET", "/_count", count)
    r("POST", "/_count", count)
    r("GET", "/{index}/_count", count)
    r("POST", "/{index}/_count", count)

    def msearch(req: RestRequest, done: DoneFn) -> None:
        lines = [json.loads(ln) for ln in
                 req.raw_body.decode("utf-8").splitlines() if ln.strip()]
        pairs = []
        i = 0
        while i + 1 <= len(lines) - 1:
            header, body = lines[i], lines[i + 1]
            # request-level allow_partial_search_results threads into each
            # line's body; a per-line header value overrides the query
            # param, and an explicit per-line body value wins over both
            merged = {**req.query,
                      **{k: v for k, v in header.items() if k != "index"}}
            body = _thread_search_params(
                merged, dict(body), keys=("allow_partial_search_results",))
            pairs.append((header.get("index",
                                     req.params.get("index", "_all")), body))
            i += 2
        responses: List[Optional[Dict[str, Any]]] = [None] * len(pairs)
        if not pairs:
            done(200, {"responses": []})
            return
        pending = {"n": len(pairs)}

        def one(pos: int, index: str, body: Dict[str, Any]) -> None:
            def cb(resp, err=None):
                if err is None:
                    responses[pos] = resp
                else:
                    # same wire shape (type rehydration incl.) as the
                    # top-level error path
                    respond_error(
                        lambda _s, ebody: responses.__setitem__(pos, ebody),
                        err)
                pending["n"] -= 1
                if pending["n"] == 0:
                    done(200, {"responses": responses})
            client.search(index, body, cb)
        for pos, (index, body) in enumerate(pairs):
            one(pos, index, body)
    r("POST", "/_msearch", msearch)
    r("GET", "/_msearch", msearch)
    r("POST", "/{index}/_msearch", msearch)

    # -- index admin ------------------------------------------------------

    def index_create(req: RestRequest, done: DoneFn) -> None:
        def cb(resp, err=None):
            if err is not None:
                respond_error(done, err)
            else:
                done(200, {"acknowledged": True,
                           "shards_acknowledged": True,
                           "index": req.params["index"]})
        client.create_index(req.params["index"], req.body or {}, cb)
    r("PUT", "/{index}", index_create)

    def index_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_index(req.params["index"], wrap_client_cb(done))
    r("DELETE", "/{index}", index_delete)

    def index_get(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        meta = state.metadata.index(req.params["index"])
        done(200, {meta.name: {
            "aliases": {a: dict(meta.alias_configs.get(a, {}))
                        for a in meta.aliases},
            "mappings": dict(meta.mappings),
            "settings": {"index": {
                "number_of_shards": str(meta.number_of_shards),
                "number_of_replicas": str(meta.number_of_replicas),
                "uuid": meta.uuid, **dict(meta.settings)}},
        }})
    r("GET", "/{index}", index_get)

    def mapping_put(req: RestRequest, done: DoneFn) -> None:
        client.put_mapping(req.params["index"], req.body or {},
                           wrap_client_cb(done))
    r("PUT", "/{index}/_mapping", mapping_put)
    r("POST", "/{index}/_mapping", mapping_put)

    def mapping_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.get_mapping(req.params["index"]))
    r("GET", "/{index}/_mapping", mapping_get)

    def settings_put(req: RestRequest, done: DoneFn) -> None:
        body = req.body or {}
        settings = body.get("index", body.get("settings", body))
        client.update_settings(req.params["index"], settings,
                               wrap_client_cb(done))
    r("PUT", "/{index}/_settings", settings_put)

    def settings_get(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        meta = state.metadata.index(req.params["index"])
        done(200, {meta.name: {"settings": {"index": {
            "number_of_shards": str(meta.number_of_shards),
            "number_of_replicas": str(meta.number_of_replicas),
            "uuid": meta.uuid, **dict(meta.settings)}}}})
    r("GET", "/{index}/_settings", settings_get)

    def aliases_post(req: RestRequest, done: DoneFn) -> None:
        client.update_aliases((req.body or {}).get("actions", []),
                              wrap_client_cb(done))
    r("POST", "/_aliases", aliases_post)

    # -- index templates / ILM / rollover --------------------------------

    def template_put(req: RestRequest, done: DoneFn) -> None:
        client.put_index_template(req.params["name"], req.body or {},
                                  wrap_client_cb(done))
    r("PUT", "/_index_template/{name}", template_put)
    r("POST", "/_index_template/{name}", template_put)

    def template_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_index_template(req.params["name"],
                                     wrap_client_cb(done))
    r("DELETE", "/_index_template/{name}", template_delete)

    def template_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.get_index_templates(req.params.get("name")))
    r("GET", "/_index_template", template_get)
    r("GET", "/_index_template/{name}", template_get)

    def slm_put(req: RestRequest, done: DoneFn) -> None:
        client.put_slm_policy(req.params["name"], req.body or {},
                              wrap_client_cb(done))
    r("PUT", "/_slm/policy/{name}", slm_put)

    def slm_get(req: RestRequest, done: DoneFn) -> None:
        try:
            done(200, client.node.slm_service.get(req.params.get("name")))
        except Exception as e:  # noqa: BLE001 — unknown policy: 404
            done(404, {"error": {"type": "resource_not_found_exception",
                                 "reason": str(e)}, "status": 404})
    r("GET", "/_slm/policy", slm_get)
    r("GET", "/_slm/policy/{name}", slm_get)

    def slm_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_slm_policy(req.params["name"], wrap_client_cb(done))
    r("DELETE", "/_slm/policy/{name}", slm_delete)

    def slm_execute(req: RestRequest, done: DoneFn) -> None:
        client.node.slm_service.execute(req.params["name"],
                                        wrap_client_cb(done))
    r("POST", "/_slm/policy/{name}/_execute", slm_execute)

    def slm_stats(req: RestRequest, done: DoneFn) -> None:
        done(200, dict(client.node.slm_service.stats))
    r("GET", "/_slm/stats", slm_stats)

    def data_stream_put(req: RestRequest, done: DoneFn) -> None:
        client.create_data_stream(req.params["name"], wrap_client_cb(done))
    r("PUT", "/_data_stream/{name}", data_stream_put)

    def data_stream_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_data_stream(req.params["name"], wrap_client_cb(done))
    r("DELETE", "/_data_stream/{name}", data_stream_delete)

    def data_stream_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.get_data_streams(req.params.get("name")))
    r("GET", "/_data_stream", data_stream_get)
    r("GET", "/_data_stream/{name}", data_stream_get)

    def ilm_put(req: RestRequest, done: DoneFn) -> None:
        client.put_ilm_policy(req.params["name"], req.body or {},
                              wrap_client_cb(done))
    r("PUT", "/_ilm/policy/{name}", ilm_put)

    def ilm_explain(req: RestRequest, done: DoneFn) -> None:
        """GET /{index}/_ilm/explain (ExplainLifecycleAction): per-index
        managed flag, policy, computed current phase, age, and the step
        markers the phase machine left in settings."""
        from elasticsearch_tpu_torch.cluster.metadata import (
            resolve_index_expression,
        )
        from elasticsearch_tpu_torch.ilm import compute_phase
        node = client.node
        state = node._applied_state()
        try:
            names = resolve_index_expression(req.params.get("index"),
                                             state.metadata)
        except Exception as e:  # noqa: BLE001 — unknown index: 404
            done(404, {"error": {"type": "index_not_found_exception",
                                 "reason": str(e)}, "status": 404})
            return
        now_ms = node.scheduler.wall_now() * 1000
        out: Dict[str, Any] = {}
        for name in names:
            meta = state.metadata.indices[name]
            policy_name = meta.settings.get("index.lifecycle.name")
            if not policy_name:
                out[name] = {"index": name, "managed": False}
                continue
            policy = state.metadata.ilm_policies.get(policy_name)
            if policy is None:
                # the advance loop skips such indices; report the stall
                # instead of inventing a phase it will never enter
                out[name] = {"index": name, "managed": True,
                             "policy": policy_name, "phase": None,
                             "step_info": "policy not found"}
                continue
            computed = compute_phase(meta.settings,
                                     policy.get("phases") or {}, now_ms)
            entry = {
                "index": name, "managed": True,
                "policy": policy_name, "phase": computed["phase"],
                "age": f"{int(computed['age_ms'] // 1000)}s",
                "rolled_over": computed["rolled_over"],
            }
            for marker in ("forcemerged", "shrink_source",
                           "snapshot_started"):
                value = meta.settings.get(f"index.lifecycle.{marker}")
                if value is not None:
                    entry[marker] = value
            out[name] = entry
        done(200, {"indices": out})
    r("GET", "/{index}/_ilm/explain", ilm_explain)

    def ilm_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_ilm_policy(req.params["name"], wrap_client_cb(done))
    r("DELETE", "/_ilm/policy/{name}", ilm_delete)

    def ilm_get(req: RestRequest, done: DoneFn) -> None:
        policies = client.get_ilm_policies()
        name = req.params.get("name")
        if name is not None:
            if name not in policies:
                from elasticsearch_tpu_torch.utils.errors import (
                    ResourceNotFoundError,
                )
                raise ResourceNotFoundError(f"policy [{name}] not found")
            policies = {k: v for k, v in policies.items() if k == name}
        done(200, policies)
    r("GET", "/_ilm/policy", ilm_get)
    r("GET", "/_ilm/policy/{name}", ilm_get)

    def rollover_post(req: RestRequest, done: DoneFn) -> None:
        client.rollover(req.params["index"], req.body or {},
                        wrap_client_cb(done))
    r("POST", "/{index}/_rollover", rollover_post)

    # -- security (x-pack/plugin/security REST surface) -------------------

    def user_put(req: RestRequest, done: DoneFn) -> None:
        client.put_security_user(req.params["name"], req.body or {},
                                 wrap_client_cb(done))
    r("PUT", "/_security/user/{name}", user_put)
    r("POST", "/_security/user/{name}", user_put)

    def role_put(req: RestRequest, done: DoneFn) -> None:
        client.put_security_role(req.params["name"], req.body or {},
                                 wrap_client_cb(done))
    r("PUT", "/_security/role/{name}", role_put)
    r("POST", "/_security/role/{name}", role_put)

    def user_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_security_entity("users", req.params["name"],
                                      wrap_client_cb(done))
    r("DELETE", "/_security/user/{name}", user_delete)

    def role_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_security_entity("roles", req.params["name"],
                                      wrap_client_cb(done))
    r("DELETE", "/_security/role/{name}", role_delete)

    def user_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.get_security_entities(
            "users", req.params.get("name")))
    r("GET", "/_security/user", user_get)
    r("GET", "/_security/user/{name}", user_get)

    def role_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.get_security_entities(
            "roles", req.params.get("name")))
    r("GET", "/_security/role", role_get)
    r("GET", "/_security/role/{name}", role_get)

    def _caller(req: RestRequest):
        """The authenticated principal record the security filter stashed
        (api-key endpoints are owner-scoped, not path-privileged)."""
        got = req.params.get("_authenticated_record")
        if got is None:
            # security disabled: act as the anonymous superuser
            got = {"username": "_anonymous", "roles": ["superuser"]}
        return got

    def api_key_create(req: RestRequest, done: DoneFn) -> None:
        client.node.security.create_api_key(
            _caller(req), req.body or {}, wrap_client_cb(done))
    r("POST", "/_security/api_key", api_key_create)
    r("PUT", "/_security/api_key", api_key_create)

    def api_key_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.security.get_api_keys(
            _caller(req), (req.query or {}).get("id")))
    r("GET", "/_security/api_key", api_key_get)

    def api_key_invalidate(req: RestRequest, done: DoneFn) -> None:
        client.node.security.invalidate_api_keys(
            _caller(req), req.body or {}, wrap_client_cb(done))
    r("DELETE", "/_security/api_key", api_key_invalidate)

    # -- transforms (x-pack/plugin/transform REST surface) ----------------

    def transform_put(req: RestRequest, done: DoneFn) -> None:
        client.node.transform_service.put(
            req.params["id"], req.body or {}, wrap_client_cb(done))
    r("PUT", "/_transform/{id}", transform_put)

    def transform_delete(req: RestRequest, done: DoneFn) -> None:
        client.node.transform_service.delete(req.params["id"],
                                             wrap_client_cb(done))
    r("DELETE", "/_transform/{id}", transform_delete)

    def transform_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.transform_service.get(req.params.get("id")))
    r("GET", "/_transform", transform_get)
    r("GET", "/_transform/{id}", transform_get)

    def transform_start(req: RestRequest, done: DoneFn) -> None:
        client.node.transform_service.set_started(
            req.params["id"], True, wrap_client_cb(done))
    r("POST", "/_transform/{id}/_start", transform_start)

    def transform_stop(req: RestRequest, done: DoneFn) -> None:
        client.node.transform_service.set_started(
            req.params["id"], False, wrap_client_cb(done))
    r("POST", "/_transform/{id}/_stop", transform_stop)

    # -- watcher (x-pack/plugin/watcher REST surface) ---------------------

    def watch_put(req: RestRequest, done: DoneFn) -> None:
        client.node.watcher_service.put(req.params["id"], req.body or {},
                                        wrap_client_cb(done))
    r("PUT", "/_watcher/watch/{id}", watch_put)

    def watch_delete(req: RestRequest, done: DoneFn) -> None:
        client.node.watcher_service.delete(req.params["id"],
                                           wrap_client_cb(done))
    r("DELETE", "/_watcher/watch/{id}", watch_delete)

    def watch_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.watcher_service.get(req.params["id"]))
    r("GET", "/_watcher/watch/{id}", watch_get)

    # -- CCR (x-pack/plugin/ccr REST surface) -----------------------------

    def ccr_follow(req: RestRequest, done: DoneFn) -> None:
        client.node.ccr_service.follow(req.params["index"], req.body or {},
                                       wrap_client_cb(done))
    r("PUT", "/{index}/_ccr/follow", ccr_follow)

    def ccr_unfollow(req: RestRequest, done: DoneFn) -> None:
        client.node.ccr_service.unfollow(req.params["index"],
                                         wrap_client_cb(done))
    r("POST", "/{index}/_ccr/unfollow", ccr_unfollow)

    def ccr_stats(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.ccr_service.stats(req.params.get("index")))
    r("GET", "/_ccr/stats", ccr_stats)
    r("GET", "/{index}/_ccr/stats", ccr_stats)

    def ccr_auto_follow_put(req: RestRequest, done: DoneFn) -> None:
        client.node.ccr_service.put_auto_follow(
            req.params["name"], req.body or {}, wrap_client_cb(done))
    r("PUT", "/_ccr/auto_follow/{name}", ccr_auto_follow_put)

    def ccr_auto_follow_delete(req: RestRequest, done: DoneFn) -> None:
        client.node.ccr_service.delete_auto_follow(
            req.params["name"], wrap_client_cb(done))
    r("DELETE", "/_ccr/auto_follow/{name}", ccr_auto_follow_delete)

    def ccr_auto_follow_get(req: RestRequest, done: DoneFn) -> None:
        try:
            done(200, client.node.ccr_service.get_auto_follow(
                req.params.get("name")))
        except Exception as e:  # noqa: BLE001 — unknown pattern: 404
            done(404, {"error": {"type": "resource_not_found_exception",
                                 "reason": str(e)}, "status": 404})
    r("GET", "/_ccr/auto_follow", ccr_auto_follow_get)
    r("GET", "/_ccr/auto_follow/{name}", ccr_auto_follow_get)

    # -- observability: hot threads + explicit reroute --------------------

    def hot_threads(req: RestRequest, done: DoneFn) -> None:
        import sys
        import threading
        import traceback
        lines = [f"::: {client.node.node_id}"]
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            lines.append(f"\n   {names.get(tid, '?')} (tid={tid}):")
            lines.extend("     " + ln for entry in
                         traceback.format_stack(frame)
                         for ln in entry.rstrip().splitlines())
        done(200, "\n".join(lines) + "\n")
    r("GET", "/_nodes/hot_threads", hot_threads)

    def hot_spans(req: RestRequest, done: DoneFn) -> None:
        """The hot-threads analog over the data planes: the top in-flight
        search spans with their phase, data plane, drain occupancy and
        elapsed time, plus the shard batcher's queued members."""
        from elasticsearch_tpu_torch import monitor
        try:
            limit = int(req.query.get("size", 16) or 16)
        except (TypeError, ValueError):
            limit = 16
        done(200, {client.node.node_id:
                   monitor.hot_spans_report(client.node, limit=limit)})
    r("GET", "/_nodes/hot_spans", hot_spans)

    def reroute_post(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch.action.admin import REROUTE
        client.node.master_client.execute(
            REROUTE, {"commands": (req.body or {}).get("commands", []),
                      "retry_failed": req.flag("retry_failed")},
            wrap_client_cb(done))
    r("POST", "/_cluster/reroute", reroute_post)

    # -- async search (x-pack/plugin/async-search REST surface) -----------

    def async_submit(req: RestRequest, done: DoneFn) -> None:
        # submit params mirror _search: allow_partial_search_results (and
        # the [timeout] budget) thread into the underlying search body
        body = _thread_search_params(req.query, dict(req.body or {}))
        client.node.async_search.submit(
            req.params["index"], body, wrap_client_cb(done),
            wait_for_completion=req.query.get(
                "wait_for_completion_timeout"),
            keep_alive=req.query.get("keep_alive"),
            owner=req.params.get("_authenticated_user"))
    r("POST", "/{index}/_async_search", async_submit)

    def async_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.async_search.get(
            req.params["id"], owner=req.params.get("_authenticated_user")))
    r("GET", "/_async_search/{id}", async_get)

    def async_delete(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.async_search.delete(
            req.params["id"], owner=req.params.get("_authenticated_user")))
    r("DELETE", "/_async_search/{id}", async_delete)

    # -- SQL (x-pack/plugin/sql REST surface) -----------------------------

    def sql_query(req: RestRequest, done: DoneFn) -> None:
        client.node.sql.query((req.body or {}).get("query", ""),
                              wrap_client_cb(done))
    r("POST", "/_sql", sql_query)
    r("GET", "/_sql", sql_query)

    def sql_translate(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch.xpack.sql import parse_sql, translate
        done(200, translate(parse_sql((req.body or {}).get("query", ""))))
    r("POST", "/_sql/translate", sql_translate)

    # -- EQL (x-pack/plugin/eql REST surface) -----------------------------

    def eql_search(req: RestRequest, done: DoneFn) -> None:
        client.node.eql.search(req.params["index"], req.body or {},
                               wrap_client_cb(done))
    r("POST", "/{index}/_eql/search", eql_search)
    r("GET", "/{index}/_eql/search", eql_search)

    # -- rollup (x-pack/plugin/rollup REST surface) -----------------------

    def rollup_put(req: RestRequest, done: DoneFn) -> None:
        client.node.rollup_service.put_job(
            req.params["id"], req.body or {}, wrap_client_cb(done))
    r("PUT", "/_rollup/job/{id}", rollup_put)

    def rollup_delete(req: RestRequest, done: DoneFn) -> None:
        client.node.rollup_service.delete_job(
            req.params["id"], wrap_client_cb(done))
    r("DELETE", "/_rollup/job/{id}", rollup_delete)

    def rollup_start(req: RestRequest, done: DoneFn) -> None:
        client.node.rollup_service.set_started(
            req.params["id"], True, wrap_client_cb(done))
    r("POST", "/_rollup/job/{id}/_start", rollup_start)

    def rollup_stop(req: RestRequest, done: DoneFn) -> None:
        client.node.rollup_service.set_started(
            req.params["id"], False, wrap_client_cb(done))
    r("POST", "/_rollup/job/{id}/_stop", rollup_stop)

    def rollup_jobs(req: RestRequest, done: DoneFn) -> None:
        out = client.node.rollup_service.jobs()
        job_id = req.params.get("id")
        if job_id is not None:
            out = {"jobs": [j for j in out["jobs"]
                            if j["config"]["id"] == job_id]}
            if not out["jobs"]:
                done(404, {"error": {
                    "type": "resource_not_found_exception",
                    "reason": f"rollup job [{job_id}] not found"}})
                return
        done(200, out)
    r("GET", "/_rollup/job", rollup_jobs)
    r("GET", "/_rollup/job/{id}", rollup_jobs)

    def rollup_search(req: RestRequest, done: DoneFn) -> None:
        client.node.rollup_service.rollup_search(
            req.params["index"], req.body or {}, wrap_client_cb(done))
    r("POST", "/{index}/_rollup_search", rollup_search)
    r("GET", "/{index}/_rollup_search", rollup_search)

    # -- enrich (x-pack/plugin/enrich REST surface) -----------------------

    def enrich_put(req: RestRequest, done: DoneFn) -> None:
        client.node.enrich_service.put_policy(
            req.params["name"], req.body or {}, wrap_client_cb(done))
    r("PUT", "/_enrich/policy/{name}", enrich_put)

    def enrich_delete(req: RestRequest, done: DoneFn) -> None:
        client.node.enrich_service.delete_policy(
            req.params["name"], wrap_client_cb(done))
    r("DELETE", "/_enrich/policy/{name}", enrich_delete)

    def enrich_execute(req: RestRequest, done: DoneFn) -> None:
        client.node.enrich_service.execute_policy(
            req.params["name"], wrap_client_cb(done))
    r("PUT", "/_enrich/policy/{name}/_execute", enrich_execute)
    r("POST", "/_enrich/policy/{name}/_execute", enrich_execute)

    def enrich_list(req: RestRequest, done: DoneFn) -> None:
        out = client.node.enrich_service.policies()
        name = req.params.get("name")
        if name is not None:
            out = {"policies": [
                p for p in out["policies"]
                if any(cfg.get("name") == name
                       for cfg in p["config"].values())]}
            if not out["policies"]:
                done(404, {"error": {
                    "type": "resource_not_found_exception",
                    "reason": f"enrich policy [{name}] not found"}})
                return
        done(200, out)
    r("GET", "/_enrich/policy", enrich_list)
    r("GET", "/_enrich/policy/{name}", enrich_list)

    # -- graph (x-pack/plugin/graph REST surface) -------------------------

    def graph_explore(req: RestRequest, done: DoneFn) -> None:
        client.node.graph_service.explore(
            req.params["index"], req.body or {}, wrap_client_cb(done))
    r("POST", "/{index}/_graph/explore", graph_explore)
    r("GET", "/{index}/_graph/explore", graph_explore)

    def validate_query(req: RestRequest, done: DoneFn) -> None:
        """_validate/query (ValidateQueryAction analog): parse without
        executing; ?explain adds the parsed representation."""
        from elasticsearch_tpu_torch.search import dsl as _dsl
        body = req.body or {}
        index = req.params.get("index", "_all")
        # an unknown index is a 404, not a vacuous "valid"
        from elasticsearch_tpu_torch.cluster.metadata import (
            resolve_index_expression,
        )
        try:
            resolve_index_expression(
                index, client.node._applied_state().metadata)
        except Exception as e:  # noqa: BLE001
            done(404, {"error": {"type": "index_not_found_exception",
                                 "reason": str(e)}})
            return
        try:
            parsed = _dsl.parse_query(body.get("query"))
            out: Dict[str, Any] = {"valid": True,
                                   "_shards": {"total": 1,
                                               "successful": 1,
                                               "failed": 0}}
            if req.flag("explain"):
                out["explanations"] = [{
                    "index": index, "valid": True,
                    "explanation": repr(parsed)}]
            done(200, out)
        except Exception as e:  # noqa: BLE001 — invalid is a RESULT
            out = {"valid": False,
                   "_shards": {"total": 1, "successful": 1, "failed": 0}}
            if req.flag("explain"):
                out["error"] = str(e)
            done(200, out)
    r("GET", "/_validate/query", validate_query)
    r("POST", "/_validate/query", validate_query)
    r("GET", "/{index}/_validate/query", validate_query)
    r("POST", "/{index}/_validate/query", validate_query)

    def search_shards(req: RestRequest, done: DoneFn) -> None:
        """_search_shards (ClusterSearchShardsAction analog): which shard
        copies a search would fan out to."""
        from elasticsearch_tpu_torch.cluster.metadata import (
            resolve_index_expression,
        )
        state = client.node._applied_state()
        try:
            names = resolve_index_expression(
                req.params.get("index", "_all"), state.metadata)
        except Exception as e:  # noqa: BLE001 — unknown index: 404
            done(404, {"error": {"type": "index_not_found_exception",
                                 "reason": str(e)}})
            return
        shards = []
        for name in names:
            if not state.routing_table.has_index(name):
                continue
            irt = state.routing_table.index(name)
            for sid in sorted(irt.shards):
                # ACTIVE copies only — the coordinator never fans out to
                # an INITIALIZING copy, so neither should this preview
                group = [sr.to_dict() for sr in irt.shard_group(sid)
                         if sr.active]
                if group:
                    shards.append(group)
        done(200, {"nodes": {nid: {"name": n.name or nid}
                             for nid, n in state.nodes.items()},
                   "indices": {name: {} for name in names},
                   "shards": shards})
    r("GET", "/_search_shards", search_shards)
    r("POST", "/_search_shards", search_shards)
    r("GET", "/{index}/_search_shards", search_shards)
    r("POST", "/{index}/_search_shards", search_shards)

    def field_mapping(req: RestRequest, done: DoneFn) -> None:
        """GET /{index}/_mapping/field/{field} — per-field mapping lookup
        with wildcard support (TransportGetFieldMappingsAction analog)."""
        import fnmatch as _fn
        state = client.node._applied_state()
        from elasticsearch_tpu_torch.cluster.metadata import (
            resolve_index_expression,
        )
        try:
            names = resolve_index_expression(
                req.params.get("index", "_all"), state.metadata)
        except Exception as e:  # noqa: BLE001
            done(404, {"error": {"type": "index_not_found_exception",
                                 "reason": str(e)}})
            return
        patterns = req.params["field"].split(",")
        out: Dict[str, Any] = {}
        for name in names:
            meta = state.metadata.indices[name]
            from elasticsearch_tpu_torch.mapping import MapperService
            service = MapperService(dict(meta.mappings))
            fields = {}
            for fname in service.field_names():
                if "#" in fname:
                    continue
                if any(_fn.fnmatch(fname, p) for p in patterns):
                    mapper = service.mapper(fname)
                    leaf = fname.rsplit(".", 1)[-1]
                    fields[fname] = {
                        "full_name": fname,
                        "mapping": {leaf: mapper.to_mapping()}}
            out[name] = {"mappings": fields}
        done(200, out)
    r("GET", "/{index}/_mapping/field/{field}", field_mapping)
    r("GET", "/_mapping/field/{field}", field_mapping)

    def open_index(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch.action.admin import OPEN_INDEX
        client.node.master_client.execute(
            OPEN_INDEX, {"index": req.params["index"]},
            wrap_client_cb(done))
    r("POST", "/{index}/_open", open_index)

    def close_index(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch.action.admin import CLOSE_INDEX
        client.node.master_client.execute(
            CLOSE_INDEX, {"index": req.params["index"]},
            wrap_client_cb(done))
    r("POST", "/{index}/_close", close_index)

    # -- resize family (action/admin/indices/shrink) ----------------------

    def _resize(kind):
        def handler(req: RestRequest, done: DoneFn) -> None:
            client.node.resize_actions.resize(
                kind, req.params["index"], req.params["target"],
                req.body or {}, wrap_client_cb(done))
        return handler
    r("PUT", "/{index}/_shrink/{target}", _resize("shrink"))
    r("POST", "/{index}/_shrink/{target}", _resize("shrink"))
    r("PUT", "/{index}/_split/{target}", _resize("split"))
    r("POST", "/{index}/_split/{target}", _resize("split"))
    r("PUT", "/{index}/_clone/{target}", _resize("clone"))
    r("POST", "/{index}/_clone/{target}", _resize("clone"))

    # -- deprecation info (x-pack/plugin/deprecation) ---------------------

    def migration_deprecations(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch.xpack.deprecation import deprecations
        done(200, deprecations(client.node._applied_state()))
    r("GET", "/_migration/deprecations", migration_deprecations)

    # -- autoscaling (x-pack/plugin/autoscaling) --------------------------

    def autoscaling_put(req: RestRequest, done: DoneFn) -> None:
        client.node.autoscaling.put_policy(
            req.params["name"], req.body or {}, wrap_client_cb(done))
    r("PUT", "/_autoscaling/policy/{name}", autoscaling_put)

    def autoscaling_delete(req: RestRequest, done: DoneFn) -> None:
        client.node.autoscaling.delete_policy(
            req.params["name"], wrap_client_cb(done))
    r("DELETE", "/_autoscaling/policy/{name}", autoscaling_delete)

    def autoscaling_capacity(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.autoscaling.capacity())
    r("GET", "/_autoscaling/capacity", autoscaling_capacity)

    # -- ML anomaly detection (x-pack/plugin/ml REST surface) -------------

    def ml_put_job(req: RestRequest, done: DoneFn) -> None:
        client.node.ml_jobs.put_job(req.params["id"], req.body or {},
                                    wrap_client_cb(done))
    r("PUT", "/_ml/anomaly_detectors/{id}", ml_put_job)

    def ml_delete_job(req: RestRequest, done: DoneFn) -> None:
        client.node.ml_jobs.delete_job(req.params["id"],
                                       wrap_client_cb(done))
    r("DELETE", "/_ml/anomaly_detectors/{id}", ml_delete_job)

    def ml_open(req: RestRequest, done: DoneFn) -> None:
        client.node.ml_jobs.set_opened(req.params["id"], True,
                                       wrap_client_cb(done))
    r("POST", "/_ml/anomaly_detectors/{id}/_open", ml_open)

    def ml_close(req: RestRequest, done: DoneFn) -> None:
        client.node.ml_jobs.set_opened(req.params["id"], False,
                                       wrap_client_cb(done))
    r("POST", "/_ml/anomaly_detectors/{id}/_close", ml_close)

    def ml_get_jobs(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.ml_jobs.jobs(req.params.get("id")))
    r("GET", "/_ml/anomaly_detectors", ml_get_jobs)
    r("GET", "/_ml/anomaly_detectors/{id}", ml_get_jobs)

    def ml_records(req: RestRequest, done: DoneFn) -> None:
        def fparam(name, default):
            raw = req.query.get(name)
            if raw is None:
                return default
            try:
                return float(raw)
            except ValueError:
                raise IllegalArgumentError(
                    f"[{name}] must be a number, got [{raw}]")
        client.node.ml_jobs.records(
            req.params["id"], wrap_client_cb(done),
            min_score=fparam("record_score", 0.0),
            from_=int(fparam("from", 0)),
            size=int(fparam("size", 100)),
            desc=req.flag("desc"))
    r("GET", "/_ml/anomaly_detectors/{id}/results/records", ml_records)

    # -- searchable snapshots + frozen indices ----------------------------

    def mount_snapshot(req: RestRequest, done: DoneFn) -> None:
        client.node.searchable_snapshots.mount(
            req.params["repo"], req.params["snap"], req.body or {},
            wrap_client_cb(done))
    r("POST", "/_snapshot/{repo}/{snap}/_mount", mount_snapshot)

    def freeze_index(req: RestRequest, done: DoneFn) -> None:
        req.deprecate(
            "frozen indices are deprecated because they provide no "
            "benefit given improvements in heap memory utilization. "
            "They will be removed in a future release.")
        client.node.searchable_snapshots.set_frozen(
            req.params["index"], True, wrap_client_cb(done))
    r("POST", "/{index}/_freeze", freeze_index)

    def unfreeze_index(req: RestRequest, done: DoneFn) -> None:
        client.node.searchable_snapshots.set_frozen(
            req.params["index"], False, wrap_client_cb(done))
    r("POST", "/{index}/_unfreeze", unfreeze_index)

    # -- monitoring (x-pack/plugin/monitoring, local-exporter shape) ------

    def monitoring_stats(req: RestRequest, done: DoneFn) -> None:
        done(200, client.node.monitoring_service.stats())
    r("GET", "/_monitoring/stats", monitoring_stats)

    def monitoring_collect(req: RestRequest, done: DoneFn) -> None:
        client.node.monitoring_service.collect_now()
        done(200, {"acknowledged": True})
    r("POST", "/_monitoring/_collect", monitoring_collect)

    def authenticate(req: RestRequest, done: DoneFn) -> None:
        user = client.node.security.authenticate(req.headers or {})
        if user is None:
            done(401, {"error": {"type": "security_exception",
                                 "reason": "missing or invalid credentials"},
                       "status": 401})
            return
        done(200, {"username": user["username"], "roles": user["roles"]})
    r("GET", "/_security/_authenticate", authenticate)

    def alias_get(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        out: Dict[str, Any] = {}
        for meta in state.metadata.indices.values():
            if meta.aliases:
                out[meta.name] = {"aliases": {
                    a: dict(meta.alias_configs.get(a, {}))
                    for a in meta.aliases}}
        done(200, out)
    r("GET", "/_alias", alias_get)

    def refresh(req: RestRequest, done: DoneFn) -> None:
        client.refresh(req.params.get("index", "_all"),
                       wrap_client_cb(done))
    r("POST", "/_refresh", refresh)
    r("POST", "/{index}/_refresh", refresh)
    r("GET", "/{index}/_refresh", refresh)

    def flush(req: RestRequest, done: DoneFn) -> None:
        client.flush(req.params.get("index", "_all"), wrap_client_cb(done))
    r("POST", "/_flush", flush)
    r("POST", "/{index}/_flush", flush)

    def forcemerge(req: RestRequest, done: DoneFn) -> None:
        client.force_merge(
            req.params.get("index", "_all"), wrap_client_cb(done),
            max_num_segments=_int_param(req, "max_num_segments", 1))
    r("POST", "/_forcemerge", forcemerge)
    r("POST", "/{index}/_forcemerge", forcemerge)

    def index_stats(req: RestRequest, done: DoneFn) -> None:
        client.index_stats(req.params.get("index", "_all"),
                           wrap_client_cb(done))
    r("GET", "/{index}/_stats", index_stats)
    r("GET", "/_stats", index_stats)

    # -- misc read APIs ---------------------------------------------------

    def mget(req: RestRequest, done: DoneFn) -> None:
        client.mget(req.body or {}, wrap_client_cb(done),
                    index=req.params.get("index"))
    r("POST", "/_mget", mget)
    r("GET", "/_mget", mget)
    r("POST", "/{index}/_mget", mget)
    r("GET", "/{index}/_mget", mget)

    def termvectors(req: RestRequest, done: DoneFn) -> None:
        fields = req.query.get("fields")
        client.termvectors(
            req.params["index"], req.params["id"], wrap_client_cb(done),
            fields=fields.split(",") if fields else
            (req.body or {}).get("fields"),
            routing=req.query.get("routing"))
    r("GET", "/{index}/_termvectors/{id}", termvectors)
    r("POST", "/{index}/_termvectors/{id}", termvectors)

    def explain(req: RestRequest, done: DoneFn) -> None:
        body = dict(req.body or {})
        q = req.query.get("q")
        if q:
            body["query"] = _uri_query(q)
        client.explain(req.params["index"], req.params["id"], body,
                       wrap_client_cb(done),
                       routing=req.query.get("routing"))
    r("GET", "/{index}/_explain/{id}", explain)
    r("POST", "/{index}/_explain/{id}", explain)

    def field_caps(req: RestRequest, done: DoneFn) -> None:
        done(200, client.field_caps(req.params.get("index", "_all"),
                                    req.query.get("fields")))
    r("GET", "/_field_caps", field_caps)
    r("POST", "/_field_caps", field_caps)
    r("GET", "/{index}/_field_caps", field_caps)
    r("POST", "/{index}/_field_caps", field_caps)

    def analyze(req: RestRequest, done: DoneFn) -> None:
        body = dict(req.body or {})
        for key in ("text", "analyzer", "field"):
            if key in req.query and key not in body:
                body[key] = req.query[key]
        done(200, client.analyze(body, index=req.params.get("index")))
    r("GET", "/_analyze", analyze)
    r("POST", "/_analyze", analyze)
    r("GET", "/{index}/_analyze", analyze)
    r("POST", "/{index}/_analyze", analyze)

    def rank_eval(req: RestRequest, done: DoneFn) -> None:
        client.rank_eval(req.params.get("index", "_all"),
                         req.body or {}, wrap_client_cb(done))
    r("GET", "/{index}/_rank_eval", rank_eval)
    r("POST", "/{index}/_rank_eval", rank_eval)
    r("GET", "/_rank_eval", rank_eval)
    r("POST", "/_rank_eval", rank_eval)

    # -- stored scripts / templates ---------------------------------------

    def script_put(req: RestRequest, done: DoneFn) -> None:
        client.put_stored_script(req.params["id"], req.body or {},
                                 wrap_client_cb(done))
    r("PUT", "/_scripts/{id}", script_put)
    r("POST", "/_scripts/{id}", script_put)

    def script_get(req: RestRequest, done: DoneFn) -> None:
        script = client.get_stored_script(req.params["id"])
        if script is None:
            done(404, {"_id": req.params["id"], "found": False})
        else:
            done(200, {"_id": req.params["id"], "found": True,
                       "script": script})
    r("GET", "/_scripts/{id}", script_get)

    def script_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_stored_script(req.params["id"],
                                    wrap_client_cb(done))
    r("DELETE", "/_scripts/{id}", script_delete)

    def search_template(req: RestRequest, done: DoneFn) -> None:
        client.search_template(req.params.get("index", "_all"),
                               req.body or {}, wrap_client_cb(done))
    r("GET", "/_search/template", search_template)
    r("POST", "/_search/template", search_template)
    r("GET", "/{index}/_search/template", search_template)
    r("POST", "/{index}/_search/template", search_template)

    def render_template(req: RestRequest, done: DoneFn) -> None:
        body = dict(req.body or {})
        if req.params.get("id") and "id" not in body:
            body["id"] = req.params["id"]
        done(200, client.render_template(body))
    r("GET", "/_render/template", render_template)
    r("POST", "/_render/template", render_template)
    r("GET", "/_render/template/{id}", render_template)
    r("POST", "/_render/template/{id}", render_template)

    # -- reindex family ---------------------------------------------------

    def reindex(req: RestRequest, done: DoneFn) -> None:
        client.reindex(req.body or {}, wrap_client_cb(done),
                       wait_for_completion=req.flag(
                           "wait_for_completion", True))
    r("POST", "/_reindex", reindex)

    def update_by_query(req: RestRequest, done: DoneFn) -> None:
        client.update_by_query(
            req.params["index"], req.body or {}, wrap_client_cb(done),
            wait_for_completion=req.flag("wait_for_completion", True))
    r("POST", "/{index}/_update_by_query", update_by_query)

    def delete_by_query(req: RestRequest, done: DoneFn) -> None:
        client.delete_by_query(
            req.params["index"], req.body or {}, wrap_client_cb(done),
            wait_for_completion=req.flag("wait_for_completion", True))
    r("POST", "/{index}/_delete_by_query", delete_by_query)

    # -- tasks ------------------------------------------------------------

    def tasks_list(req: RestRequest, done: DoneFn) -> None:
        client.list_tasks(wrap_client_cb(done),
                          actions=req.query.get("actions"))
    r("GET", "/_tasks", tasks_list)

    def task_get(req: RestRequest, done: DoneFn) -> None:
        client.get_task(req.params["task_id"], wrap_client_cb(done))
    r("GET", "/_tasks/{task_id}", task_get)

    def tasks_cancel(req: RestRequest, done: DoneFn) -> None:
        client.cancel_tasks(wrap_client_cb(done),
                            task_id=req.params.get("task_id"),
                            actions=req.query.get("actions"))
    r("POST", "/_tasks/_cancel", tasks_cancel)
    r("POST", "/_tasks/{task_id}/_cancel", tasks_cancel)

    # -- ingest pipelines -------------------------------------------------

    def pipeline_put(req: RestRequest, done: DoneFn) -> None:
        client.put_pipeline(req.params["id"], req.body or {},
                            wrap_client_cb(done))
    r("PUT", "/_ingest/pipeline/{id}", pipeline_put)

    def pipeline_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.get_pipeline(req.params.get("id")))
    r("GET", "/_ingest/pipeline", pipeline_get)
    r("GET", "/_ingest/pipeline/{id}", pipeline_get)

    def pipeline_delete(req: RestRequest, done: DoneFn) -> None:
        client.delete_pipeline(req.params["id"], wrap_client_cb(done))
    r("DELETE", "/_ingest/pipeline/{id}", pipeline_delete)

    def pipeline_simulate(req: RestRequest, done: DoneFn) -> None:
        done(200, client.simulate_pipeline(req.body or {},
                                           req.params.get("id")))
    r("POST", "/_ingest/pipeline/_simulate", pipeline_simulate)
    r("GET", "/_ingest/pipeline/_simulate", pipeline_simulate)
    r("POST", "/_ingest/pipeline/{id}/_simulate", pipeline_simulate)

    # -- snapshots --------------------------------------------------------

    def repo_put(req: RestRequest, done: DoneFn) -> None:
        client.put_repository(req.params["repo"], req.body or {},
                              wrap_client_cb(done))
    r("PUT", "/_snapshot/{repo}", repo_put)
    r("POST", "/_snapshot/{repo}", repo_put)

    def repo_get(req: RestRequest, done: DoneFn) -> None:
        repos = client.get_repositories()
        name = req.params.get("repo")
        if name and name not in ("_all", "*"):
            if name not in repos:
                from elasticsearch_tpu_torch.repositories import (
                    SnapshotMissingError,
                )
                raise SnapshotMissingError(
                    f"repository [{name}] is missing")
            repos = {name: repos[name]}
        done(200, repos)
    r("GET", "/_snapshot", repo_get)
    r("GET", "/_snapshot/{repo}", repo_get)

    def snapshot_put(req: RestRequest, done: DoneFn) -> None:
        client.create_snapshot(req.params["repo"], req.params["snap"],
                               req.body, wrap_client_cb(done))
    r("PUT", "/_snapshot/{repo}/{snap}", snapshot_put)
    r("POST", "/_snapshot/{repo}/{snap}", snapshot_put)

    def snapshot_get(req: RestRequest, done: DoneFn) -> None:
        done(200, client.get_snapshots(req.params["repo"],
                                       req.params.get("snap", "_all")))
    r("GET", "/_snapshot/{repo}/{snap}", snapshot_get)

    def snapshot_delete(req: RestRequest, done: DoneFn) -> None:
        done(200, client.delete_snapshot(req.params["repo"],
                                         req.params["snap"]))
    r("DELETE", "/_snapshot/{repo}/{snap}", snapshot_delete)

    def snapshot_restore(req: RestRequest, done: DoneFn) -> None:
        client.restore_snapshot(req.params["repo"], req.params["snap"],
                                req.body, wrap_client_cb(done))
    r("POST", "/_snapshot/{repo}/{snap}/_restore", snapshot_restore)

    # -- cluster ----------------------------------------------------------

    def health(req: RestRequest, done: DoneFn) -> None:
        """?wait_for_status=yellow|green polls until the status is at
        least that good or the timeout lapses, reporting timed_out like
        the reference (ClusterHealthRequest.waitForStatus). Health is
        computed on the ELECTED MASTER (cluster_health_async routes
        there), so the unverified-STARTED gate holds on every node."""
        index = req.params.get("index")
        want = req.query.get("wait_for_status")
        if want not in ("yellow", "green"):
            client.cluster_health_async(
                index, lambda h, _err: done(200, h))
            return
        rank = {"red": 0, "yellow": 1, "green": 2}

        def duration_s(raw: str) -> float:
            """ES duration expression -> seconds (30s, 1m, 500ms, 2h)."""
            m = re.match(r"^(\d+(?:\.\d+)?)(ms|s|m|h)?$", str(raw))
            if not m:
                raise IllegalArgumentError(
                    f"failed to parse timeout [{raw}]")
            n = float(m.group(1))
            return n * {"ms": 0.001, "s": 1.0, "m": 60.0,
                        "h": 3600.0}.get(m.group(2) or "s", 1.0)

        deadline = client.node.scheduler.now() + duration_s(
            req.query.get("timeout", "30s"))

        def poll() -> None:
            def on_health(h, _err) -> None:
                if rank.get(h["status"], 0) >= rank[want]:
                    done(200, {**h, "timed_out": False})
                elif client.node.scheduler.now() >= deadline:
                    done(200, {**h, "timed_out": True})
                else:
                    client.node.scheduler.schedule(0.1, poll)
            client.cluster_health_async(index, on_health)
        poll()
    r("GET", "/_cluster/health", health)
    r("GET", "/_cluster/health/{index}", health)

    def voting_exclusions_add(req: RestRequest, done: DoneFn) -> None:
        names = (req.query or {}).get("node_names", "")
        from elasticsearch_tpu_torch.action.admin import VOTING_EXCLUSIONS
        client.node.master_client.execute(VOTING_EXCLUSIONS, {
            "action": "add",
            "node_names": [n for n in names.split(",") if n]},
            wrap_client_cb(done))
    r("POST", "/_cluster/voting_config_exclusions", voting_exclusions_add)

    def voting_exclusions_clear(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch.action.admin import VOTING_EXCLUSIONS
        client.node.master_client.execute(VOTING_EXCLUSIONS,
                                          {"action": "clear"},
                                          wrap_client_cb(done))
    r("DELETE", "/_cluster/voting_config_exclusions",
      voting_exclusions_clear)

    def remote_info(req: RestRequest, done: DoneFn) -> None:
        """Configured remote clusters (RestRemoteClusterInfoAction)."""
        svc = getattr(client.node, "remote_clusters", None)
        done(200, svc.info() if svc is not None else {})

    r("GET", "/_remote/info", remote_info)

    def cluster_state(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch.xpack.security import redact_state
        done(200, redact_state(client.cluster_state()))
    r("GET", "/_cluster/state", cluster_state)

    def cluster_stats(req: RestRequest, done: DoneFn) -> None:
        """_cluster/stats (ClusterStatsAction analog): cluster-wide
        index/shard/doc totals + node membership summary."""
        state = client.node._applied_state()
        n_indices = len(state.metadata.indices)
        all_shards = list(state.routing_table.all_shards())
        primaries = sum(1 for sr in all_shards if sr.primary and sr.active)
        total_active = sum(1 for sr in all_shards if sr.active)
        role_counts: Dict[str, int] = {}
        for n in state.nodes.values():
            for role in n.roles:
                role_counts[role] = role_counts.get(role, 0) + 1

        def with_docs(resp, _err=None):
            resp = resp or {}
            docs = ((resp.get("_all") or {}).get("primaries") or {}) \
                .get("docs", {}).get("count", 0)
            shard_stats = resp.get("_shards", {})

            def emit(h) -> None:
                def finish(ns_resp, _err=None) -> None:
                    # fleet view of the per-node latency histograms:
                    # raw exponential buckets merged across every
                    # node's search_latency section, percentiles
                    # recomputed from the merged distribution (the
                    # nodes-stats aggregation leg — PR 8 follow-up)
                    merged: Dict[str, Any] = {}
                    merged_dp: Dict[str, Any] = {}
                    merged_rc: Dict[str, Any] = {}
                    node_sections = list(
                        (ns_resp or {}).get("nodes", {}).values())
                    try:
                        from elasticsearch_tpu_torch.search.telemetry import (
                            merge_latency_sections,
                        )
                        merged = merge_latency_sections(
                            [n.get("search_latency") or {}
                             for n in node_sections])
                    except Exception:  # noqa: BLE001 — stats must serve
                        merged = {}
                    try:
                        from elasticsearch_tpu_torch.search.device_profile \
                            import merge_device_profile_sections
                        merged_dp = merge_device_profile_sections(
                            [n.get("device_profile") or {}
                             for n in node_sections])
                    except Exception:  # noqa: BLE001 — stats must serve
                        merged_dp = {}
                    try:
                        from elasticsearch_tpu_torch.indices.request_cache \
                            import merge_request_cache_sections
                        merged_rc = merge_request_cache_sections(
                            [n.get("request_cache") or {}
                             for n in node_sections])
                    except Exception:  # noqa: BLE001 — stats must serve
                        merged_rc = {}
                    try:
                        from elasticsearch_tpu_torch.indices. \
                            cluster_state_service import (
                                merge_recovery_sections,
                            )
                        merged_rec = merge_recovery_sections(
                            [n.get("recovery") or {}
                             for n in node_sections])
                    except Exception:  # noqa: BLE001 — stats must serve
                        merged_rec = {}
                    try:
                        from elasticsearch_tpu_torch.utils.threadpool import (
                            merge_indexing_pressure_sections,
                        )
                        merged_ip = merge_indexing_pressure_sections(
                            [n.get("indexing_pressure") or {}
                             for n in node_sections])
                    except Exception:  # noqa: BLE001 — stats must serve
                        merged_ip = {}
                    done(200, {
                        "cluster_name": state.cluster_name,
                        "status": h["status"],
                        # partial stat collection must be VISIBLE:
                        # failed > 0 means docs.count undercounts
                        "_shards": {
                            "total": shard_stats.get("total", 0),
                            "successful": shard_stats.get(
                                "successful", 0),
                            "failed": shard_stats.get("failed", 0)},
                        "indices": {
                            "count": n_indices,
                            "shards": {"total": total_active,
                                       "primaries": primaries,
                                       "replication":
                                           ((total_active - primaries) /
                                            primaries)
                                           if primaries else 0.0},
                            "docs": {"count": docs},
                        },
                        "nodes": {
                            "count": {"total": len(state.nodes),
                                      **role_counts},
                            "versions": [__version__],
                        },
                        "search_latency": merged,
                        # fleet-merged device observatory (per-family
                        # compile/recompile counters summed, compile-ms
                        # maxima kept as maxima)
                        "device_profile": merged_dp,
                        # fleet-merged two-tier request cache (counters
                        # summed, typed invalidation causes summed per
                        # cause)
                        "request_cache": merged_rc,
                        # fleet-merged recovery accounting: kinds
                        # (ops_based vs wipe-and-copy), ops replayed,
                        # bytes copied vs avoided, typed file-fallback
                        # reasons, lease/history gauges
                        "recovery": merged_rec,
                        # fleet-merged write-path pressure plane: byte
                        # gauges and per-stage rejection buckets summed,
                        # the worst node's last Retry-After kept as max
                        "indexing_pressure": merged_ip,
                    })
                # section-filtered fan-out: every node builds ONLY its
                # search_latency section for this merge, not the full
                # probe walk (/proc, device backend, every shard) — and
                # a short timeout so a dead-but-still-in-state node
                # can't stall a polled monitoring endpoint for 30s (the
                # merge tolerates missing nodes)
                client.nodes_stats_all(
                    finish,
                    sections=("search_latency", "device_profile",
                              "request_cache", "recovery",
                              "indexing_pressure"),
                    timeout=5.0)

            # status through the master-routed health path (the
            # unverified-STARTED gate lives on the elected master only; a
            # non-master's local view must not report green during a
            # post-reboot verify window) — the same route _cluster/health
            # takes, with the same flagged local fallback
            # cluster_health_async always delivers a health dict (master's
            # answer or the FLAGGED local fallback) — no unflagged local
            # re-read here, which would undo the master routing
            client.cluster_health_async(None, lambda h, _e: emit(h))
        if n_indices:
            # one aggregation path: index_stats already sums primary
            # docs and carries the _shards success/failure counts
            client.index_stats("_all", with_docs)
        else:
            with_docs({})
    r("GET", "/_cluster/stats", cluster_stats)

    def cluster_settings_put(req: RestRequest, done: DoneFn) -> None:
        client.cluster_update_settings(req.body or {}, wrap_client_cb(done))
    r("PUT", "/_cluster/settings", cluster_settings_put)

    def cluster_settings_get(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch.xpack.security import redact_settings
        state = client.node._applied_state()
        done(200, {"persistent": redact_settings(
            dict(state.metadata.persistent_settings)),
            "transient": {}})
    r("GET", "/_cluster/settings", cluster_settings_get)

    def nodes(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        done(200, {"_nodes": {"total": len(state.nodes)},
                   "cluster_name": state.cluster_name,
                   "nodes": {nid: n.to_dict()
                             for nid, n in state.nodes.items()}})
    r("GET", "/_nodes", nodes)

    def nodes_stats(req: RestRequest, done: DoneFn) -> None:
        client.nodes_stats_all(wrap_client_cb(done))
    r("GET", "/_nodes/stats", nodes_stats)

    def allocation_explain(req: RestRequest, done: DoneFn) -> None:
        """Why is a shard where it is / unassigned
        (ClusterAllocationExplainAction analog): runs every decider
        against every data node and reports the verdicts."""
        from elasticsearch_tpu_torch.cluster.allocation import Decision
        node = client.node
        state = node._applied_state()
        body = req.body or {}
        target = None
        if body.get("index") is not None:
            want_primary = bool(body.get("primary", True))
            sid = int(body.get("shard", 0))
            if state.routing_table.has_index(body["index"]):
                for sr in state.routing_table.index(
                        body["index"]).shard_group(sid):
                    if sr.primary == want_primary:
                        target = sr
                        break
        else:
            target = next(
                (sr for sr in state.routing_table.all_shards()
                 if not sr.assigned), None)
        if target is None:
            done(400, {"error": {
                "type": "illegal_argument_exception",
                "reason": "unable to find any unassigned shards to "
                          "explain (pass index/shard/primary to explain "
                          "an assigned shard)"}})
            return
        decisions = []
        for nid, dnode in sorted(state.data_nodes().items()):
            verdict = node.allocation_service.decide(target, dnode, state)
            per_decider = [
                {"decider": type(d).__name__,
                 "decision": d.can_allocate(target, dnode, state)}
                for d in node.allocation_service.deciders]
            decisions.append({
                "node_id": nid, "node_name": dnode.name or nid,
                "node_decision":
                    "yes" if verdict == Decision.YES else
                    ("throttled" if verdict == Decision.THROTTLE
                     else "no"),
                "deciders": [d for d in per_decider
                             if d["decision"] != Decision.YES] or
                            per_decider[:1]})
        explanation = {
            "index": target.index, "shard": target.shard_id,
            "primary": target.primary,
            "current_state": target.state.value.lower(),
            "current_node": ({"id": target.node_id}
                             if target.node_id else None),
            "can_allocate":
                "yes" if any(d["node_decision"] == "yes"
                             for d in decisions) else "no",
            "node_allocation_decisions": decisions}
        if target.unassigned_reason or target.failed_attempts:
            # why the last copy died (UnassignedInfo.getDetails): this is
            # where a corruption-marked store becomes operator-visible
            explanation["unassigned_info"] = {
                "reason": target.unassigned_reason,
                "failed_allocation_attempts": target.failed_attempts,
            }
            if target.last_allocation_id:
                explanation["unassigned_info"]["last_allocation_id"] = \
                    target.last_allocation_id
        # what the gateway shard-state fetch learned about this shard's
        # on-disk copies (populated on the elected master): per-node
        # has_data / freshness / corruption — the evidence behind a
        # freshest-copy or refuse-corrupted decision
        fetch = node.gateway_allocator.describe(target.index,
                                                target.shard_id)
        if fetch is not None:
            explanation["gateway_fetch"] = fetch
        done(200, explanation)
    r("GET", "/_cluster/allocation/explain", allocation_explain)
    r("POST", "/_cluster/allocation/explain", allocation_explain)

    def pending_tasks(req: RestRequest, done: DoneFn) -> None:
        """Queued master state-update tasks (PendingClusterTasksAction)."""
        coord = client.node.coordinator
        queue = list(getattr(coord, "_update_queue", []))
        tasks = [{"insert_order": i, "priority": "NORMAL",
                  "source": desc, "executing": False}
                 for i, (desc, _fn, _cb) in enumerate(queue)]
        inflight = getattr(coord, "_inflight_update", None)
        if inflight is not None:
            source = inflight[2] if isinstance(inflight, tuple) \
                and len(inflight) > 2 else "inflight"
            tasks.insert(0, {"insert_order": -1, "priority": "URGENT",
                             "source": source, "executing": True})
        done(200, {"tasks": tasks})
    r("GET", "/_cluster/pending_tasks", pending_tasks)

    def clear_corruption_markers(req: RestRequest, done: DoneFn) -> None:
        """Operator escape hatch (the remove-corrupted-data tool analog):
        remove corruption markers from this node's local shard stores so
        a repaired/accepted-loss copy can reopen. Wired to the existing
        Store.clear_corruption_markers(); reports per-shard removals so
        the operator sees exactly which copies were unfenced."""
        node = client.node
        shards_out: List[Dict[str, Any]] = []
        total = 0
        for index_name, service in sorted(
                node.indices_service.indices.items()):
            for sid, shard in sorted(service.shards.items()):
                store = shard.engine.store
                if store is None:
                    continue
                removed = store.clear_corruption_markers()
                if removed:
                    total += removed
                    shards_out.append({"index": index_name, "shard": sid,
                                       "markers_removed": removed})
        done(200, {"acknowledged": True, "markers_removed": total,
                   "shards": shards_out})
    r("POST", "/_internal/corruption_markers/_clear",
      clear_corruption_markers)

    # -- cat (human tables) ----------------------------------------------

    def cat_indices(req: RestRequest, done: DoneFn) -> None:
        """Per-index status through the master-routed health path (the
        unverified-STARTED gate is master-only state): ONE bulk master
        request resolves every index's status in a single round trip —
        the chained per-index form paid O(n_indices) sequential RPCs on
        a non-master node. The flagged-local fallback (no master / no
        answer) rides inside cluster_healths_async."""
        state = client.node._applied_state()
        metas = list(state.metadata.indices.values())

        def cb(resp, _err=None) -> None:
            healths = (resp or {}).get("indices", {})
            rows = [[healths.get(meta.name, {}).get("status", "red"),
                     "open", meta.name, meta.uuid,
                     str(meta.number_of_shards),
                     str(meta.number_of_replicas)]
                    for meta in metas]
            done(200, _cat(req, ["health", "status", "index", "uuid",
                                 "pri", "rep"], rows))
        client.cluster_healths_async([m.name for m in metas], cb)
    r("GET", "/_cat/indices", cat_indices)

    def cat_health(req: RestRequest, done: DoneFn) -> None:
        def cb(h, _err=None) -> None:
            done(200, _cat(req, ["cluster", "status", "node.total",
                                 "shards", "pri", "unassign"],
                           [[h["cluster_name"], h["status"],
                             str(h["number_of_nodes"]),
                             str(h["active_shards"]),
                             str(h["active_primary_shards"]),
                             str(h["unassigned_shards"])]]))
        # master-routed, like _cluster/health (flagged local fallback)
        client.cluster_health_async(None, cb)
    r("GET", "/_cat/health", cat_health)

    def cat_allocation(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        rows = []
        for nid in sorted(state.data_nodes()):
            n = len(state.routing_table.shards_on_node(nid))
            rows.append([str(n), nid])
        unassigned = sum(1 for sr in state.routing_table.all_shards()
                         if not sr.assigned)
        if unassigned:
            rows.append([str(unassigned), "UNASSIGNED"])
        done(200, _cat(req, ["shards", "node"], rows))
    r("GET", "/_cat/allocation", cat_allocation)

    def cat_aliases(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        rows = []
        for meta in state.metadata.indices.values():
            for alias in sorted(meta.aliases):
                rows.append([alias, meta.name])
        done(200, _cat(req, ["alias", "index"], rows))
    r("GET", "/_cat/aliases", cat_aliases)

    def cat_count(req: RestRequest, done: DoneFn) -> None:
        index = req.params.get("index", "_all")

        def cb(resp, err):
            if err is not None:
                done(404, {"error": {"type": "index_not_found_exception",
                                     "reason": str(err)}})
                return
            done(200, _cat(req, ["epoch", "timestamp", "count"],
                           [["-", "-",
                             str(resp["hits"]["total"]["value"])]]))
        client.search(index, {"size": 0,
                              "track_total_hits": True,
                              "query": {"match_all": {}}}, cb)
    r("GET", "/_cat/count", cat_count)
    r("GET", "/_cat/count/{index}", cat_count)

    def cat_templates(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        rows = []
        for name, t in sorted(
                (state.metadata.templates or {}).items()):
            patterns = ",".join(t.get("index_patterns", []))
            rows.append([name, f"[{patterns}]",
                         str(t.get("priority", 0))])
        done(200, _cat(req, ["name", "index_patterns", "order"], rows))
    r("GET", "/_cat/templates", cat_templates)

    def cat_segments(req: RestRequest, done: DoneFn) -> None:
        rows = []
        for iname, svc in sorted(
                client.node.indices_service.indices.items()):
            for sid, shard in sorted(svc.shards.items()):
                try:
                    reader = shard.engine.acquire_reader()
                except Exception:  # noqa: BLE001
                    continue
                for gi, seg in enumerate(reader.segments):
                    rows.append([iname, str(sid),
                                 "p" if shard.primary else "r",
                                 f"_{gi}", str(seg.n_docs)])
        done(200, _cat(req, ["index", "shard", "prirep", "segment",
                             "docs.count"], rows))
    r("GET", "/_cat/segments", cat_segments)

    def cat_plugins(req: RestRequest, done: DoneFn) -> None:
        from elasticsearch_tpu_torch import plugins as plugin_mod
        rows = [[client.node.node_id, descriptor, "external"]
                for descriptor in sorted(
                    getattr(plugin_mod, "_loaded", []))]
        done(200, _cat(req, ["name", "component", "version"], rows))
    r("GET", "/_cat/plugins", cat_plugins)

    def cat_recovery(req: RestRequest, done: DoneFn) -> None:
        """RecoveryState view: completed recoveries from this node's
        reconciler log carry the ACTUAL kind (ops_based / peer_reuse /
        peer / in_place / ...) plus op/byte accounting; in-flight
        INITIALIZING copies from routing show as stage=init."""
        state = client.node._applied_state()
        rows = []
        logged = set()
        for entry in reversed(client.node.reconciler.recovery_log()):
            key = (entry["index"], entry["shard"], entry["node"])
            if key in logged:
                continue   # newest recovery per copy wins
            logged.add(key)
            rows.append([entry["index"], str(entry["shard"]),
                         entry["kind"], "done", entry["node"] or "-",
                         entry.get("source_node") or "-",
                         str(entry.get("ops_replayed", 0)),
                         str(entry.get("bytes_copied", 0)),
                         str(entry.get("bytes_avoided", 0)),
                         entry.get("file_reason") or "-"])
        rows.reverse()
        covered = {(r[0], r[1], r[4]) for r in rows}
        for sr in state.routing_table.all_shards():
            if sr.state == ShardState.INITIALIZING:
                rows.append([sr.index, str(sr.shard_id), "peer", "init",
                             sr.node_id or "-", "-", "0", "0", "0", "-"])
            elif sr.active and (sr.index, str(sr.shard_id),
                                sr.node_id) not in covered:
                # copies recovered on OTHER nodes (the log is node-local):
                # routing-derived placeholder row, like before
                rows.append([sr.index, str(sr.shard_id), "existing_store",
                             "done", sr.node_id or "-", "-", "0", "0",
                             "0", "-"])
        # post-promotion resync summary (PrimaryReplicaSyncer): one row
        # when this node has ever run one, so a failover's re-replication
        # is visible next to the recoveries it avoided
        resyncer = getattr(client.node.reconciler, "resyncer", None)
        if resyncer is not None and (
                resyncer.stats["resyncs_started"] or
                resyncer.stats["resyncs_noop"] or
                resyncer.stats["resync_failures"]):
            rs = resyncer.stats
            rows.append([
                "-", "-", "resync", "done", client.node.node_id, "-",
                str(rs["resync_ops_sent"]), "0", "0",
                f"started={rs['resyncs_started']}"
                f",completed={rs['resyncs_completed']}"
                f",noop={rs['resyncs_noop']}"
                f",failed={rs['resync_failures']}"])
        done(200, _cat(req, ["index", "shard", "type", "stage", "node",
                             "source_node", "ops", "bytes",
                             "bytes_avoided", "fallback_reason"], rows))
    r("GET", "/_cat/recovery", cat_recovery)

    def cat_pending_tasks(req: RestRequest, done: DoneFn) -> None:
        queue = list(getattr(client.node.coordinator,
                             "_update_queue", []))
        rows = [[str(i), "NORMAL", desc]
                for i, (desc, _f, _cb) in enumerate(queue)]
        done(200, _cat(req, ["insertOrder", "priority", "source"], rows))
    r("GET", "/_cat/pending_tasks", cat_pending_tasks)

    def cat_thread_pool(req: RestRequest, done: DoneFn) -> None:
        rows = []
        stats = client.node.thread_pool.stats()
        for name in sorted(stats):
            if name == "indexing_pressure":
                continue
            p = stats[name]
            rows.append([client.node.node_id, name, str(p["active"]),
                         str(p["queue"]), str(p["rejected"])])
        done(200, _cat(req, ["node_name", "name", "active", "queue",
                             "rejected"], rows))
    r("GET", "/_cat/thread_pool", cat_thread_pool)

    def cat_shards(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        only = req.params.get("index")
        allowed = None
        if only:
            from elasticsearch_tpu_torch.cluster.metadata import (
                resolve_index_expression,
            )
            try:
                allowed = set(resolve_index_expression(
                    only, state.metadata))
            except Exception:  # noqa: BLE001 — unknown name: empty table
                allowed = {only}
        # STARTED copies awaiting gateway verification after their host
        # rebooted (only the elected master tracks these)
        unverified = {(u["index"], u["shard"], u["node"])
                      for u in client.node.gateway_allocator
                      .health_unverified()}
        rows = []
        for sr in state.routing_table.all_shards():
            if allowed is not None and sr.index not in allowed:
                continue
            reason = sr.unassigned_reason or "-"
            if (sr.index, sr.shard_id, sr.node_id) in unverified:
                reason = "pending_gateway_verify"
            rows.append([sr.index, str(sr.shard_id),
                         "p" if sr.primary else "r",
                         sr.state.value, sr.node_id or "-",
                         reason])
        done(200, _cat(req, ["index", "shard", "prirep", "state", "node",
                             "unassigned.reason"], rows))
    r("GET", "/_cat/shards", cat_shards)
    r("GET", "/_cat/shards/{index}", cat_shards)

    def cat_nodes(req: RestRequest, done: DoneFn) -> None:
        state = client.node._applied_state()
        rows = []
        for nid, n in state.nodes.items():
            roles = "".join(sorted(role[0] for role in n.roles))
            master = "*" if nid == state.master_node_id else "-"
            rows.append([nid, roles, master, n.name or nid])
        done(200, _cat(req, ["id", "node.role", "master", "name"], rows))
    r("GET", "/_cat/nodes", cat_nodes)

    return rc


def _int_param(req: RestRequest, name: str,
               default: Optional[int] = None) -> Optional[int]:
    v = req.query.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        raise IllegalArgumentError(
            f"Failed to parse int parameter [{name}] with value [{v}]")


def _uri_query(q: str) -> Dict[str, Any]:
    """?q= URI search: 'field:value' → match on field; bare text → multi
    match over all text fields (query_string-lite)."""
    if ":" in q:
        field, _, text = q.partition(":")
        return {"match": {field.strip(): text.strip()}}
    return {"multi_match": {"query": q, "fields": ["*"]}}


def _cat(req: RestRequest, headers: List[str],
         rows: List[List[str]]):
    """Fixed-width text table; ?v adds the header row; ?format=json
    returns the row objects instead (the cat API contract)."""
    if (req.query or {}).get("format") == "json":
        return [dict(zip(headers, [str(c) for c in row])) for row in rows]
    show_header = req.flag("v")
    table = ([headers] if show_header else []) + rows
    if not table:
        return ""
    widths = [max(len(str(row[i])) for row in table)
              for i in range(len(headers))]
    lines = [" ".join(str(cell).ljust(w)
                      for cell, w in zip(row, widths)).rstrip()
             for row in table]
    return "\n".join(lines) + "\n"
