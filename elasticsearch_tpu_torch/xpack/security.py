"""Security: authentication (basic auth) + role-based authorization.

Reference: x-pack/plugin/security/ — Realms (native realm backed by the
.security index), Role/RoleDescriptor with cluster and index privileges,
and the REST filter that authenticates every request
(SecurityRestFilter). Re-designed for this build: users and roles live
in cluster-state metadata (replicated + persisted like every other
entity here), passwords hash with PBKDF2-HMAC-SHA256, and enforcement
wraps the REST dispatch — the same boundary the reference filters.

Security is OFF until the dynamic cluster setting
``xpack.security.enabled`` is true. When it turns on, the built-in
``elastic`` superuser authenticates with the bootstrap password from
``xpack.security.bootstrap_password`` (no silent default: enabling
without a bootstrap password and without any stored user locks the
cluster open only for _security/_cluster-settings management from
localhost-less anonymous, i.e. nothing — so the enable call should set
both together).
"""

from __future__ import annotations

import base64
import fnmatch
import hashlib
import hmac
import os
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

PBKDF2_ITERATIONS = 120_000

CLUSTER_PRIVILEGES = {"all", "monitor", "manage", "manage_security"}
INDEX_PRIVILEGES = {"all", "read", "write", "create_index", "delete_index",
                    "manage", "monitor"}

SUPERUSER_ROLE = {"cluster": ["all"],
                  "indices": [{"names": ["*"], "privileges": ["all"]}]}
BUILTIN_ROLES = {"superuser": SUPERUSER_ROLE}


class IllegalSecurityScope(Exception):
    """A request's targets cannot be covered by one DLS wrap; fails
    closed with 403."""


def hash_password(password: str, salt: Optional[bytes] = None
                  ) -> Dict[str, str]:
    salt = salt if salt is not None else os.urandom(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"), salt,
                                 PBKDF2_ITERATIONS)
    return {"salt": salt.hex(), "hash": digest.hex()}


def verify_password(password: str, entry: Dict[str, Any]) -> bool:
    digest = hashlib.pbkdf2_hmac(
        "sha256", password.encode("utf-8"), bytes.fromhex(entry["salt"]),
        PBKDF2_ITERATIONS)
    return hmac.compare_digest(digest.hex(), entry["hash"])


# ---------------------------------------------------------------------------
# route -> required privilege classification (the action-name mapping the
# reference derives from TransportAction names)
# ---------------------------------------------------------------------------

READ_ENDPOINTS = {"_search", "_count", "_doc", "_source", "_mget",
                  "_termvectors", "_explain", "_msearch", "_rank_eval",
                  "_search_template", "_scripts", "_analyze",
                  "_field_caps", "_validate", "_async_search",
                  # data-returning x-pack search APIs: read on both GET and
                  # POST (the reference classifies these as read actions;
                  # 'manage'/'monitor' here was an authz bypass for
                  # monitor-only users)
                  "_eql", "_graph", "_rollup_search", "_knn_search",
                  "_terms_enum"}
WRITE_ENDPOINTS = {"_doc", "_create", "_update", "_bulk", "_delete_by_query",
                   "_update_by_query", "_reindex", "_rollover"}
MANAGE_ENDPOINTS = {"_settings", "_mapping", "_mappings", "_aliases",
                    "_open", "_close", "_forcemerge", "_flush", "_refresh",
                    "_cache", "_snapshot"}


def required_privilege(method: str, path: str
                       ) -> Tuple[str, str, Optional[str]]:
    """(scope, privilege, index) for a REST call; scope is 'cluster',
    'index', or 'authenticated' (identity-only endpoints)."""
    segs = [s for s in path.split("/") if s]
    if not segs:
        return ("cluster", "monitor", None)          # GET /
    first = segs[0]
    if first.startswith("_") and first != "_all":
        if path.rstrip("/") == "/_security/_authenticate":
            # any authenticated principal may ask who it is (the
            # reference's _authenticate requires no privileges)
            return ("authenticated", "", None)
        if path.rstrip("/") == "/_security/api_key":
            # create/get/invalidate own keys needs only authentication
            # (manage_own_api_key); cross-user access is enforced inside
            # the handlers (owner checks / manage_security)
            return ("authenticated", "", None)
        if first == "_async_search":
            # get/delete by id: authentication plus the service's own
            # per-owner check (ids carry stored search RESULTS)
            return ("authenticated", "", None)
        if first == "_sql":
            # index-read against the FROM target, resolved from the body
            # by SecurityService.check (the path alone names no index)
            return ("index", "read", "_sql_body")
        if first == "_security":
            return ("cluster", "manage_security", None)
        if first == "_cat" and len(segs) >= 2 and segs[1] == "count":
            # _cat/count serves per-index doc counts — an index READ in
            # the reference, not a cluster monitor action
            return ("index", "read", segs[2] if len(segs) > 2 else "*")
        if first in ("_bulk", "_reindex", "_mget", "_msearch", "_search"):
            # request-body APIs spanning indices: classified by verb
            if method == "GET" or first in ("_mget", "_msearch", "_search"):
                return ("index", "read", "*")
            return ("index", "write", "*")
        if method in ("GET", "HEAD"):
            return ("cluster", "monitor", None)
        return ("cluster", "manage", None)
    # "_all" is an index EXPRESSION, not a cluster endpoint: classify it
    # like any other index path or index-level authorization is bypassed
    index = "*" if first == "_all" else first
    endpoint = next((s for s in segs[1:] if s.startswith("_")), None)
    if endpoint is None:
        # index create/delete/exists
        if method in ("GET", "HEAD"):
            return ("index", "monitor", index)
        if method == "DELETE":
            return ("index", "delete_index", index)
        return ("index", "create_index", index)
    if endpoint in WRITE_ENDPOINTS and method in ("POST", "PUT", "DELETE"):
        return ("index", "write", index)
    if endpoint in READ_ENDPOINTS:
        return ("index", "read", index)
    if endpoint in MANAGE_ENDPOINTS and method in ("POST", "PUT", "DELETE"):
        return ("index", "manage", index)
    if method in ("GET", "HEAD"):
        return ("index", "monitor", index)
    return ("index", "manage", index)


# ---------------------------------------------------------------------------
# service
# ---------------------------------------------------------------------------

_SECRET_MARKERS = ("password", "secret", "token")


def redact_settings(settings: Dict[str, Any]) -> Dict[str, Any]:
    """Mask secret-bearing settings in API output (the reference keeps
    such values in the keystore and never serves them; here they live in
    cluster state so the REST boundary must redact)."""
    return {k: ("::es_redacted::" if any(m in k.lower()
                                         for m in _SECRET_MARKERS) else v)
            for k, v in settings.items()}


def redact_state(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Cluster-state API output with credentials stripped: password
    hashes/salts and secret settings must not reach monitor-level users
    (they'd enable offline cracking / bootstrap-password takeover)."""
    out = dict(state_dict)
    meta = dict(out.get("metadata") or {})
    if meta.get("security"):
        security = {k: dict(v) for k, v in meta["security"].items()}
        for kind in ("users", "api_keys"):
            redacted = {name: {kk: vv for kk, vv in u.items()
                               if kk not in ("hash", "salt")}
                        for name, u in security.get(kind, {}).items()}
            if redacted:
                security[kind] = redacted
        meta["security"] = security
    if meta.get("persistent_settings"):
        meta["persistent_settings"] = redact_settings(
            meta["persistent_settings"])
    out["metadata"] = meta
    return out


class AuditTrail:
    """Append-only audit log of authn/authz decisions
    (x-pack/plugin/security/.../audit/logfile/LoggingAuditTrail.java).

    Events append to ``<data_path>/audit.log`` as JSON lines (and to a
    bounded in-memory ring for tests/introspection). Off until
    ``xpack.security.audit.enabled`` is true."""

    RING_CAP = 1000

    def __init__(self, node) -> None:
        self.node = node
        self.events: List[Dict[str, Any]] = []

    def _enabled(self) -> bool:
        v = dict(self.node._applied_state().metadata.persistent_settings
                 ).get("xpack.security.audit.enabled", False)
        return str(v).lower() in ("true", "1", "yes")

    def log(self, event_type: str, user: Optional[str], realm: str,
            method: str, path: str, reason: Optional[str] = None) -> None:
        if not self._enabled():
            return
        import json as _json
        record = {
            "@timestamp": self.node.scheduler.wall_now(),
            "event.type": event_type,
            "user.name": user,
            "realm": realm,
            "http.method": method,
            "url.path": path,
        }
        if reason:
            record["reason"] = reason
        self.events.append(record)
        if len(self.events) > self.RING_CAP:
            del self.events[: len(self.events) - self.RING_CAP]
        data_path = getattr(self.node.indices_service, "data_path", None)
        if data_path:
            try:
                with open(f"{data_path}/audit.log", "a",
                          encoding="utf-8") as fh:
                    fh.write(_json.dumps(record) + "\n")
            except OSError:
                pass   # auditing must never fail the request


class FileRealm:
    """File-backed users: ``<data_path>/config/users.json`` holding
    {username: {hash, salt, roles}} — hot-reloaded on change via the
    resource watcher (the reference's file realm +
    ResourceWatcherService)."""

    def __init__(self, node) -> None:
        self.node = node
        self._users: Dict[str, Any] = {}
        # bumped on every reload so cached verifications die with the file
        self.generation = 0
        data_path = getattr(node.indices_service, "data_path", None)
        self.path = f"{data_path}/config/users.json" if data_path else None
        if self.path:
            self.reload(self.path)

    def reload(self, _path: str) -> None:
        import json as _json
        if not self.path:
            return
        try:
            with open(self.path, encoding="utf-8") as fh:
                loaded = _json.load(fh)
            self._users = {str(k): dict(v) for k, v in loaded.items()} \
                if isinstance(loaded, dict) else {}
            self.generation += 1
        except FileNotFoundError:
            self._users = {}
            self.generation += 1
        except (OSError, ValueError):
            # a malformed file keeps the LAST GOOD realm contents (the
            # reference logs and keeps serving) — never lock everyone out
            pass

    def get(self, username: str) -> Optional[Dict[str, Any]]:
        return self._users.get(username)


class SecurityService:
    """Authenticates and authorizes REST requests against cluster state."""

    AUTH_CACHE_CAP = 256

    def __init__(self, node) -> None:
        self.node = node
        # (username, sha256(password), metadata.version) -> user record;
        # the KDF is deliberately slow, so successful verifications are
        # cached until the next cluster-state change (the reference's
        # realm cache with its security-index invalidation)
        self._auth_cache: Dict[Any, Dict[str, Any]] = {}
        self.audit = AuditTrail(node)
        self.file_realm = FileRealm(node)

    # -- state ------------------------------------------------------------

    def _settings(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.persistent_settings)

    def enabled(self) -> bool:
        v = self._settings().get("xpack.security.enabled", False)
        return str(v).lower() in ("true", "1", "yes")

    def _users(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.security.get("users", {}))

    def _roles(self) -> Dict[str, Any]:
        stored = dict(self.node._applied_state()
                      .metadata.security.get("roles", {}))
        return {**BUILTIN_ROLES, **stored}

    # -- authn ------------------------------------------------------------

    def authenticate(self, headers: Dict[str, str]
                     ) -> Optional[Dict[str, Any]]:
        """The authenticated user record, or None for bad/missing creds.
        Realm chain: API keys, then the file realm, then the native
        (cluster-state) realm — the reference's realm ordering."""
        auth = headers.get("authorization", "")
        if auth.lower().startswith("apikey "):
            return self._authenticate_api_key(auth)
        if not auth.lower().startswith("basic "):
            return None
        try:
            decoded = base64.b64decode(auth.split(None, 1)[1]).decode("utf-8")
            username, _, password = decoded.partition(":")
        except Exception:  # noqa: BLE001 — malformed header = unauthenticated
            return None
        file_user = self.file_realm.get(username)
        if file_user is not None:
            cache_key = ("file", username,
                         hashlib.sha256(password.encode()).hexdigest(),
                         self.file_realm.generation)
            record = {"username": username,
                      "roles": list(file_user.get("roles", [])),
                      "realm": "file"}
            if cache_key in self._auth_cache:
                return dict(record)
            try:
                if verify_password(password, file_user):
                    if len(self._auth_cache) >= self.AUTH_CACHE_CAP:
                        self._auth_cache.clear()
                    self._auth_cache[cache_key] = {"ok": True}
                    return record
            except (KeyError, ValueError):
                pass   # malformed file entry: fall through to native
        user = self._users().get(username)
        if user is None and username == "elastic":
            boot = self._settings().get("xpack.security.bootstrap_password")
            if boot is not None and hmac.compare_digest(
                    password.encode("utf-8"), str(boot).encode("utf-8")):
                return {"username": "elastic", "roles": ["superuser"]}
            return None
        if user is None:
            return None
        cache_key = (username,
                     hashlib.sha256(password.encode("utf-8")).hexdigest(),
                     self.node._applied_state().metadata.version)
        hit = self._auth_cache.get(cache_key)
        if hit is not None:
            return dict(hit)
        if not verify_password(password, user):
            return None
        record = {"username": username,
                  "roles": list(user.get("roles", []))}
        if len(self._auth_cache) >= self.AUTH_CACHE_CAP:
            self._auth_cache.clear()
        self._auth_cache[cache_key] = record
        return dict(record)

    # -- api keys ----------------------------------------------------------

    def _api_keys(self) -> Dict[str, Any]:
        return dict(self.node._applied_state()
                    .metadata.security.get("api_keys", {}))

    def _authenticate_api_key(self, auth: str
                              ) -> Optional[Dict[str, Any]]:
        """ApiKey base64(id:secret) -> the key's principal with its
        privilege layers attached (ApiKeyService.java:108)."""
        try:
            decoded = base64.b64decode(auth.split(None, 1)[1]).decode("utf-8")
            key_id, _, secret = decoded.partition(":")
        except Exception:  # noqa: BLE001 — malformed = unauthenticated
            return None
        entry = self._api_keys().get(key_id)
        if entry is None or entry.get("invalidated"):
            return None
        # the KDF is deliberately slow: cache verified secrets until the
        # next cluster-state change, like the native realm's _auth_cache
        cache_key = ("apikey", key_id,
                     hashlib.sha256(secret.encode("utf-8")).hexdigest(),
                     self.node._applied_state().metadata.version)
        if cache_key not in self._auth_cache:
            if not verify_password(secret, entry):
                return None
            if len(self._auth_cache) >= self.AUTH_CACHE_CAP:
                self._auth_cache.clear()
            self._auth_cache[cache_key] = {"ok": True}
        exp = entry.get("expiration_ms")
        if exp is not None and \
                self.node.scheduler.wall_now() * 1000 >= float(exp):
            return None
        chain = entry.get("limited_by_chain")
        if chain is None:   # entries written before chains existed
            chain = [entry.get("limited_by") or {}]
        return {"username": entry.get("creator", "_api_key"),
                "roles": [],
                "realm": "_es_api_key",
                "api_key": {
                    "id": key_id,
                    "name": entry.get("name"),
                    "role_descriptors": entry.get("role_descriptors") or {},
                    "limited_by_chain": [dict(c) for c in chain]}}

    def create_api_key(self, user: Dict[str, Any], body: Dict[str, Any],
                       on_done) -> None:
        """POST /_security/api_key: derive a credential from the CALLER.

        The key's effective privileges are the INTERSECTION of the
        requested role_descriptors and a snapshot of the caller's roles
        at creation time (limited_by) — a key can only narrow, never
        escalate. The secret is returned ONCE and stored hashed."""
        from elasticsearch_tpu_torch.action.admin import PUT_SECURITY
        from elasticsearch_tpu_torch.utils.settings import parse_time_to_seconds
        body = dict(body or {})
        name = body.get("name")
        if not name:
            on_done(None, ValueError("api key requires [name]"))
            return
        key_id = os.urandom(10).hex()
        secret = os.urandom(18).hex()
        # the limiting CHAIN: every layer constraining the creator also
        # constrains the child key — a key created by a narrow key keeps
        # the narrow layer AND the original snapshot, so the chain's
        # intersection can only shrink
        if user.get("api_key") is not None:
            parent = user["api_key"]
            chain = [dict(layer) for layer in
                     (parent.get("limited_by_chain") or
                      ([parent["limited_by"]] if parent.get("limited_by")
                       else []))]
            rd = parent.get("role_descriptors") or {}
            if rd:
                chain.append(dict(rd))
        else:
            chain = [{rname: dict(r) for rname in user.get("roles", [])
                      if (r := self._roles().get(rname)) is not None}]
        expiration_ms = None
        if body.get("expiration"):
            expiration_ms = self.node.scheduler.wall_now() * 1000 + \
                parse_time_to_seconds(body["expiration"]) * 1000
        entry = {
            "name": str(name),
            "creator": user["username"],
            "creation_ms": int(self.node.scheduler.wall_now() * 1000),
            "expiration_ms": expiration_ms,
            "invalidated": False,
            "role_descriptors": dict(body.get("role_descriptors") or {}),
            "limited_by_chain": chain,
            **hash_password(secret),
        }

        def stored(resp, err):
            if err is not None:
                on_done(None, err)
                return
            self.audit.log("create_api_key", user["username"], "native",
                           "PUT", f"/_security/api_key [{name}]")
            encoded = base64.b64encode(
                f"{key_id}:{secret}".encode()).decode()
            on_done({"id": key_id, "name": str(name),
                     "api_key": secret, "encoded": encoded}, None)

        self.node.master_client.execute(PUT_SECURITY, {
            "kind": "api_keys", "name": key_id, "body": entry}, stored)

    def get_api_keys(self, user: Dict[str, Any],
                     key_id: Optional[str] = None) -> Dict[str, Any]:
        """Own keys for everyone; every key for manage_security holders.
        Secrets (hash/salt) never leave."""
        can_manage = self.authorize(user, "PUT", "/_security/user/x")
        # an API-key credential without manage privileges sees only
        # ITSELF: user["username"] is the creator, so a creator-equality
        # check alone would let a minimally-scoped key enumerate all of
        # its creator's other keys (r4 advisor; ref restricts such a
        # caller to its own key)
        own_id = (user.get("api_key") or {}).get("id")
        out = []
        for kid, entry in self._api_keys().items():
            if key_id is not None and kid != key_id:
                continue
            if not can_manage and entry.get("creator") != user["username"]:
                continue
            if not can_manage and own_id is not None and kid != own_id:
                continue
            out.append({"id": kid,
                        "name": entry.get("name"),
                        "creation": entry.get("creation_ms"),
                        "expiration": entry.get("expiration_ms"),
                        "invalidated": bool(entry.get("invalidated")),
                        "username": entry.get("creator")})
        return {"api_keys": out}

    def invalidate_api_keys(self, user: Dict[str, Any],
                            body: Dict[str, Any], on_done) -> None:
        """DELETE /_security/api_key {ids: [...]} | {name: ...}: flips
        ``invalidated`` (keys never silently vanish — the audit trail and
        GET still show them)."""
        from elasticsearch_tpu_torch.action.admin import PUT_SECURITY
        body = dict(body or {})
        ids = list(body.get("ids") or ([body["id"]] if body.get("id")
                                       else []))
        name = body.get("name")
        can_manage = self.authorize(user, "PUT", "/_security/user/x")
        # see get_api_keys: an API-key caller without manage privileges
        # may invalidate only itself, not its creator's sibling keys
        own_id = (user.get("api_key") or {}).get("id")
        keys = self._api_keys()
        targets = []
        skipped = 0   # matched the selector but caller may not touch it
        for kid, entry in keys.items():
            if (kid in ids) or (name and entry.get("name") == name):
                if not can_manage and \
                        entry.get("creator") != user["username"]:
                    skipped += 1
                    continue   # not yours, not an admin: skipped
                if not can_manage and own_id is not None and \
                        kid != own_id:
                    skipped += 1
                    continue   # key caller: self-invalidation only
                targets.append((kid, entry))
        # error_count must surface BOTH unknown ids and permission skips,
        # or a partial skip hides behind a sibling's clean invalidation
        unknown = sum(1 for i in ids if i not in keys)
        if not targets:
            on_done({"invalidated_api_keys": [],
                     "error_count": skipped + unknown}, None)
            return
        pending = {"n": len(targets)}
        done_ids: List[str] = []

        def one(kid, entry):
            def cb(_r, err):
                if err is None:
                    done_ids.append(kid)
                    self.audit.log("invalidate_api_key",
                                   user["username"], "native",
                                   "DELETE", f"/_security/api_key [{kid}]")
                pending["n"] -= 1
                if pending["n"] == 0:
                    on_done({"invalidated_api_keys": sorted(done_ids),
                             "error_count": skipped + unknown}, None)
            self.node.master_client.execute(PUT_SECURITY, {
                "kind": "api_keys", "name": kid,
                "body": {**entry, "invalidated": True}}, cb)

        for kid, entry in targets:
            one(kid, entry)

    # -- authz ------------------------------------------------------------

    def _role_descriptors(self, user: Dict[str, Any]
                          ) -> List[List[Dict[str, Any]]]:
        """Privilege layers: a request is allowed only if EVERY layer
        allows it. Normal users have one layer (their roles); API keys
        have the assigned role_descriptors AND the creator snapshot
        (limited_by) — the reference's intersection semantics."""
        key = user.get("api_key")
        if key is None:
            return [[r for rname in user.get("roles", [])
                     if (r := self._roles().get(rname)) is not None]]
        layers = []
        rd = key.get("role_descriptors") or {}
        if rd:
            layers.append([dict(v) for v in rd.values()])
        chain = key.get("limited_by_chain")
        if chain is None:
            chain = [key.get("limited_by") or {}]
        for link in chain:
            layers.append([dict(v) for v in link.values()])
        return layers

    def _resolve_targets(self, expression: str) -> List[str]:
        """The CONCRETE indices a request expression reaches — commas
        split, wildcards and aliases expand — so authorization judges what
        the request actually touches, never the raw string (a grant on
        'logs-*' must not fnmatch-authorize 'logs-1,secrets')."""
        if expression == "*":
            return ["*"]   # body-level APIs: demand the catch-all grant
        from elasticsearch_tpu_torch.cluster.metadata import (
            resolve_index_expression,
        )
        metadata = self.node._applied_state().metadata
        try:
            resolved = resolve_index_expression(expression, metadata)
        except Exception:  # noqa: BLE001 — unknown names authz as literal
            resolved = [p.strip() for p in expression.split(",") if p.strip()]
        # grants name data STREAMS, not their .ds-* internals: a backing
        # index authorizes as its stream (the reference's data-stream
        # aware authorization); direct .ds-* access not belonging to any
        # stream stays literal
        backing_of = {b: ds_name
                      for ds_name, ds in metadata.data_streams.items()
                      for b in ds.get("indices", [])}
        resolved = list(dict.fromkeys(
            backing_of.get(n, n) for n in resolved))
        return resolved or [expression]

    def authorize(self, user: Dict[str, Any], method: str,
                  path: str) -> bool:
        scope, privilege, index = required_privilege(method, path)
        if scope == "authenticated":
            return True
        return all(self._layer_allows(layer, scope, privilege, index)
                   for layer in self._role_descriptors(user))

    def _layer_allows(self, roles: List[Dict[str, Any]], scope: str,
                      privilege: str, index: Optional[str]) -> bool:
        if any("all" in set(r.get("cluster", [])) for r in roles):
            return True
        if scope == "cluster":
            for role in roles:
                cluster = set(role.get("cluster", []))
                if privilege in cluster or \
                        (privilege == "monitor" and "manage" in cluster):
                    return True
            return False
        # index scope: EVERY concrete index the expression reaches must be
        # covered by some grant
        for target in self._resolve_targets(index or "*"):
            ok = False
            for role in roles:
                for grant in role.get("indices", []):
                    names = grant.get("names", [])
                    if isinstance(names, str):
                        names = [names]
                    privs = set(grant.get("privileges", []))
                    if target == "*":
                        if "*" not in names:
                            continue
                    elif not any(fnmatch.fnmatch(target, p)
                                 for p in names):
                        continue
                    if "all" in privs or privilege in privs or \
                            (privilege == "monitor" and
                             privs & {"manage", "read"}):
                        ok = True
                        break
                if ok:
                    break
            if not ok:
                return False
        return True

    # -- the REST filter ----------------------------------------------------

    def _authorize_request(self, user: Dict[str, Any], request) -> bool:
        scope, privilege, index = required_privilege(
            request.method, request.path)
        if index == "_sql_body":
            # /_sql: the target index lives in the SQL text, not the path
            from elasticsearch_tpu_torch.xpack.sql import parse_sql
            try:
                target = parse_sql(
                    (request.body or {}).get("query", ""))["index"]
            except Exception:  # noqa: BLE001 — parse errors 400 later
                return True
            return self.authorize(user, "GET", f"/{target}/_search")
        allowed = self.authorize(user, request.method, request.path)
        if allowed and request.method in ("PUT", "POST"):
            # definitions that later run AS THE SYSTEM (transforms read
            # source and write dest; watches read inputs and write action
            # targets) are authorized against the registering user at PUT
            # time, or cluster-manage would be an index-privilege
            # escalation channel
            allowed = self._authorize_body_indices(user, request)
        return allowed

    def _authorize_body_indices(self, user: Dict[str, Any],
                                request) -> bool:
        body = request.body or {}
        path = request.path
        reads: List[str] = []
        writes: List[str] = []
        if path.startswith("/_transform/"):
            src = (body.get("source") or {}).get("index")
            dst = (body.get("dest") or {}).get("index")
            reads += [src] if src else []
            writes += [dst] if dst else []
        elif path.startswith("/_watcher/watch/"):
            request_spec = ((body.get("input") or {}).get("search") or {}) \
                .get("request") or {}
            indices = request_spec.get("indices") or []
            reads += indices if isinstance(indices, list) else [indices]
            for action in (body.get("actions") or {}).values():
                dest = (action.get("index") or {}).get("index")
                if dest:
                    writes.append(dest)
        for target in reads:
            if not self.authorize(user, "GET", f"/{target}/_search"):
                return False
        for target in writes:
            if not self.authorize(user, "PUT", f"/{target}/_doc/x"):
                return False
        return True

    def dls_filter(self, user: Dict[str, Any],
                   index_expression: str) -> Optional[Dict[str, Any]]:
        """Document-level security filter for the user over the target
        indices (SecurityIndexSearcherWrapper analog). For API keys, the
        assigned-descriptor AND creator-snapshot layers' filters BOTH
        apply (intersection: a key can only narrow visibility)."""
        filters = [f for layer in self._role_descriptors(user)
                   if (f := self._layer_dls(layer,
                                            index_expression)) is not None]
        if not filters:
            return None
        if len(filters) == 1:
            return filters[0]
        return {"bool": {"filter": filters}}

    def _layer_dls(self, roles: List[Dict[str, Any]],
                   index_expression: str) -> Optional[Dict[str, Any]]:
        """One layer's DLS filter: each index grant may carry a "query";
        a grant WITHOUT one makes that INDEX unrestricted; role queries
        on one index OR together. One filter wraps the whole request, so
        heterogeneous targets — mixing restricted and unrestricted
        indices, or restricted indices with DIFFERENT filters — fail
        CLOSED (the reference applies DLS per-shard; that granularity is
        a documented divergence)."""
        import json as _json
        if any("all" in set(r.get("cluster", [])) for r in roles):
            return None
        targets = self._resolve_targets(index_expression or "*")
        per_target: List[Optional[tuple]] = []
        for target in targets:
            queries: List[Dict[str, Any]] = []
            unrestricted = False
            for role in roles:
                for grant in role.get("indices", []):
                    names = grant.get("names", [])
                    if isinstance(names, str):
                        names = [names]
                    if target != "*" and not any(
                            fnmatch.fnmatch(target, p) for p in names):
                        continue
                    # only READ-capable grants shape read filtering — a
                    # write-only grant must not unrestrict searches
                    privs = set(grant.get("privileges", []))
                    if not privs & {"all", "read"}:
                        continue
                    q = grant.get("query")
                    if q is None:
                        unrestricted = True
                    else:
                        queries.append(q)
            if unrestricted or not queries:
                per_target.append(None)
            else:
                per_target.append(tuple(
                    _json.dumps(q, sort_keys=True) for q in queries))
        restricted = {p for p in per_target if p is not None}
        if not restricted:
            return None
        if len(restricted) > 1 or any(p is None for p in per_target):
            raise IllegalSecurityScope(
                "document-level security filters differ across the "
                "requested indices; query them individually")
        queries = [_json.loads(q) for q in next(iter(restricted))]
        if len(queries) == 1:
            return queries[0]
        return {"bool": {"should": queries, "minimum_should_match": 1}}

    def fls_fields(self, user: Dict[str, Any],
                   index_expression: str) -> Optional[List[str]]:
        """Field-level security patterns, or None for unrestricted
        (FieldPermissions analog). For API keys both layers apply: when
        only one restricts, its grants rule; when BOTH restrict, the
        effective grant is the (conservative) literal intersection —
        patterns of the first layer that the second also covers."""
        layers = [f for layer in self._role_descriptors(user)
                  if (f := self._layer_fls(layer,
                                           index_expression)) is not None]
        if not layers:
            return None
        effective = layers[0]
        for nxt in layers[1:]:
            effective = [g for g in effective
                         if g in nxt or any(fnmatch.fnmatch(g, h)
                                            for h in nxt)]
        return effective

    def _layer_fls(self, roles: List[Dict[str, Any]],
                   index_expression: str) -> Optional[List[str]]:
        """One layer's union of granted field patterns over the targets.
        Heterogeneous targets fail closed like DLS."""
        if any("all" in set(r.get("cluster", [])) for r in roles):
            return None
        targets = self._resolve_targets(index_expression or "*")
        per_target: List[Optional[tuple]] = []
        for target in targets:
            grants: List[str] = []
            unrestricted = False
            for role in roles:
                for grant in role.get("indices", []):
                    names = grant.get("names", [])
                    if isinstance(names, str):
                        names = [names]
                    if target != "*" and not any(
                            fnmatch.fnmatch(target, p) for p in names):
                        continue
                    privs = set(grant.get("privileges", []))
                    if not privs & {"all", "read"}:
                        continue
                    fs = grant.get("field_security")
                    if fs is None:
                        unrestricted = True
                    else:
                        grants.extend(fs.get("grant", []))
            if unrestricted:
                per_target.append(None)
            else:
                per_target.append(tuple(sorted(set(grants))))
        restricted = {p for p in per_target if p is not None}
        if not restricted:
            return None
        if len(restricted) > 1 or any(p is None for p in per_target):
            raise IllegalSecurityScope(
                "field-level security grants differ across the "
                "requested indices; query them individually")
        return list(next(iter(restricted)))

    # APIs whose body query DLS can wrap (plain search-shaped bodies)
    _DLS_PATHS = ("_search", "_count", "_graph", "_validate",
                  "_async_search")
    # read APIs one wrap CANNOT protect (raw/ndjson bodies, per-spec
    # sub-requests, non-DSL query languages, direct doc reads): when a
    # filter applies these fail closed rather than leak hidden docs
    _DLS_BLOCKED_ALWAYS = ("_mget", "_msearch", "_termvectors",
                           "_explain", "_sql", "_knn_search",
                           "_rank_eval", "_eql", "_rollup_search")
    # doc APIs blocked only for READS — writes through them leak nothing
    _DLS_BLOCKED_READS = ("_doc", "_source")

    @staticmethod
    def _referenced_fields(node: Any) -> List[str]:
        """Every \"field\"-valued name plus sort keys in a request body —
        the surfaces that can leak restricted values via aggs/sort."""
        out: List[str] = []

        def walk(n: Any) -> None:
            if isinstance(n, dict):
                for k, v in n.items():
                    if k == "field" and isinstance(v, str):
                        out.append(v)
                    elif k in ("docvalue_fields", "stored_fields",
                               "fields") and isinstance(v, list):
                        out.extend(x if isinstance(x, str)
                                   else x.get("field", "")
                                   for x in v)
                    elif k == "fields" and isinstance(v, dict):
                        # highlight-style {field_name: options}: the KEYS
                        # are field references (highlighting reads stored
                        # source, a prime FLS exfiltration surface)
                        out.extend(v.keys())
                        for vv in v.values():
                            walk(vv)
                    elif k == "sort":
                        entries = v if isinstance(v, list) else [v]
                        for e in entries:
                            if isinstance(e, str):
                                out.append(e)
                            elif isinstance(e, dict):
                                out.extend(e.keys())
                    else:
                        walk(v)
            elif isinstance(n, list):
                for item in n:
                    walk(item)
        walk(node)
        return [f for f in out if f and not f.startswith("_")]

    @staticmethod
    def _query_fields(query_body: Any) -> Optional[List[str]]:
        """Field names a request query reads, via the parsed DSL tree —
        the FieldSubsetReader analog: a term/range query on an ungranted
        field is a match oracle on its values, so FLS must see every
        query-referenced field. Returns None when the query cannot be
        parsed (caller fails CLOSED). query_string without explicit
        fields searches all fields and reports the catch-all "*"."""
        import dataclasses
        from elasticsearch_tpu_torch.search import dsl as _dsl
        try:
            tree = _dsl.parse_query(query_body)
        except Exception:  # noqa: BLE001 — unparseable = unprovable
            return None
        out: List[str] = []

        def walk(node: Any) -> None:
            if isinstance(node, (_dsl.QueryString, _dsl.SimpleQueryString)) \
                    and not (node.fields or getattr(node, "default_field",
                                                    None)):
                out.append("*")   # unscoped: searches every field
            if isinstance(node, (_dsl.ScriptQuery, _dsl.ScriptScore)):
                # scripts read doc values of ANY field — a complete FLS
                # oracle; demand the catch-all grant
                out.append("*")
            if dataclasses.is_dataclass(node) and not isinstance(node, type):
                for f in dataclasses.fields(node):
                    v = getattr(node, f.name)
                    if f.name in ("field", "default_field", "path",
                                  "minimum_should_match_field") and \
                            isinstance(v, str) and v:
                        out.append(v)
                    elif f.name == "fields" and isinstance(v, list):
                        out.extend(x.partition("^")[0] for x in v
                                   if isinstance(x, str))
                    else:
                        walk(v)
            elif isinstance(node, list):
                for x in node:
                    walk(x)
            elif isinstance(node, dict):
                for k, v in node.items():
                    if k == "field" and isinstance(v, str):
                        out.append(v)   # raw sub-dicts (function_score etc.)
                    elif k == "script":
                        out.append("*")   # scripts read any field
                        walk(v)
                    else:
                        walk(v)
        walk(tree)
        return [f for f in out if f and not f.startswith("_")]

    def _apply_dls(self, user: Dict[str, Any], request) -> None:
        """Wrap the request query with the user's role filters for the
        APIs that accept one; deny filtered users every read path the
        wrap cannot protect."""
        parts = [p for p in request.path.split("/") if p]
        if not parts:
            return
        # id-based async-search get/delete is owner-checked by the
        # service and names no index — nothing to wrap or block
        if parts[0] == "_async_search":
            return
        if parts[0] == "_cat":
            if len(parts) >= 2 and parts[1] == "count":
                # _cat/count's internal search cannot be DLS-wrapped (no
                # body); a filtered user would learn exact hidden-doc
                # counts, so it fails closed
                index = parts[2] if len(parts) > 2 else "_all"
                if self.dls_filter(user, index) is not None:
                    raise IllegalSecurityScope(
                        "[_cat/count] cannot apply this user's "
                        "document-level security; use _count")
            return
        api = next((p for p in parts if p.startswith("_")), None)
        if api is None:
            return
        # search templates rebuild the body from source+params,
        # discarding any injected query — treat as unprotectable
        templated = "template" in parts or api == "_render"
        wrappable = (not templated and
                     any(api.startswith(p) for p in self._DLS_PATHS))
        blocked = templated or \
            any(api.startswith(p) for p in self._DLS_BLOCKED_ALWAYS) or \
            (api in self._DLS_BLOCKED_READS and
             request.method in ("GET", "HEAD"))
        if not wrappable and not blocked:
            if api == "_field_caps":
                # schema disclosure matters only under FLS
                index = parts[0] if not parts[0].startswith("_") \
                    else "_all"
                if self.fls_fields(user, index) is not None:
                    raise IllegalSecurityScope(
                        "[_field_caps] is unavailable under "
                        "field-level security")
            return
        index = parts[0] if not parts[0].startswith("_") else "_all"
        filt = self.dls_filter(user, index)
        fields = self.fls_fields(user, index)
        if filt is None and fields is None:
            return
        if blocked:
            raise IllegalSecurityScope(
                f"[{api}] cannot apply this user's document/field-level "
                f"security; use _search")
        body = dict(request.body or {})
        # malformed rank/sub_searches/knn container shapes must 400 here,
        # BEFORE the wrap dereferences them — a "rank": "rrf" string or a
        # string sub_searches entry would otherwise AttributeError/
        # TypeError into an opaque fail-closed 403 (ADVICE r5 low)
        from elasticsearch_tpu_torch.action.search_action import (
            _validate_composite_shapes,
        )
        _validate_composite_shapes(body)
        # the user's ORIGINAL query, captured before any DLS wrap: FLS
        # validates what the user asked to search, not the injected role
        # filter (which legitimately references restricted fields)
        user_query = body.get("query")
        user_subs = body.get("sub_searches")
        user_knn = body.get("knn")
        had_q_param = bool((request.query or {}).get("q"))
        if filt is not None:
            # a ?q= URI query must fold in BEFORE wrapping, or the
            # handler's later body["query"] = q overwrite would discard
            # the filter
            q_param = (request.query or {}).pop("q", None)
            if q_param:
                from elasticsearch_tpu_torch.rest.routes import _uri_query
                body["query"] = _uri_query(q_param)
            is_rrf = (body.get("rank") or {}).get("rrf") is not None
            if body.get("query") is not None or not (
                    is_rrf and (user_subs is not None
                                or user_knn is not None)):
                # wrap the query (or inject a wrapped match_all for a
                # query-less plain search). ONLY a genuine retriever-only
                # RRF request (rank:{rrf} + sub_searches/knn, no query)
                # skips the injection: there it would 400 against
                # sub_searches or add a phantom match_all retriever. A
                # non-RRF body with stray sub_searches/knn keys still
                # gets the wrapped match_all — the executor ignores
                # those keys, so the injected filter is what protects it.
                original = body.get("query", {"match_all": {}})
                body["query"] = {"bool": {"must": [original],
                                          "filter": [filt]}}
            # RRF retrievers run as their OWN sub-searches
            # (search_action._execute_rrf consumes top-level [knn] and
            # [sub_searches] directly), so each must carry the role
            # filter itself or a filtered user reads hidden docs through
            # the fused list.
            if user_subs is not None:
                wrapped = []
                for sub in (user_subs if isinstance(user_subs, list)
                            else [user_subs]):
                    sub = dict(sub or {})
                    orig = sub.get("query", {"match_all": {}})
                    sub["query"] = {"bool": {"must": [orig],
                                             "filter": [filt]}}
                    wrapped.append(sub)
                body["sub_searches"] = wrapped
            if user_knn is not None:
                clauses = []
                for clause in (user_knn if isinstance(user_knn, list)
                               else [user_knn]):
                    clause = dict(clause or {})
                    prior = clause.get("filter")
                    if prior is None:
                        clause["filter"] = filt
                    elif isinstance(prior, list):
                        clause["filter"] = {"bool": {"filter":
                                                     prior + [filt]}}
                    else:
                        clause["filter"] = {"bool": {"must": [prior],
                                                     "filter": [filt]}}
                    clauses.append(clause)
                body["knn"] = (clauses if isinstance(user_knn, list)
                               else clauses[0])
        if fields is not None:
            # aggs/sort/docvalue_fields surface raw values outside
            # _source: every referenced field must be granted
            outside = {k: body[k] for k in
                       ("aggs", "aggregations", "sort",
                        "docvalue_fields", "stored_fields",
                        "script_fields", "highlight", "collapse",
                        # graph explore: vertices[].field values become
                        # terms aggs over raw field values
                        "vertices", "connections")
                       if k in body}
            refs = self._referenced_fields(outside)
            if user_query is not None:
                qf = self._query_fields(user_query)
                if qf is None:
                    raise IllegalSecurityScope(
                        "cannot verify query fields under this user's "
                        "field-level security")
                refs = refs + qf
            # RRF retriever clauses are full queries in their own right:
            # a term filter inside a [knn] clause or a [sub_searches]
            # query is a match oracle on ungranted fields (r4 advisor).
            for sub in (user_subs if isinstance(user_subs, list)
                        else [user_subs]) if user_subs is not None else []:
                qf = self._query_fields((sub or {}).get("query"))
                if qf is None:
                    raise IllegalSecurityScope(
                        "cannot verify [sub_searches] query fields under "
                        "this user's field-level security")
                refs = refs + qf
            if user_knn is not None:
                for clause in (user_knn if isinstance(user_knn, list)
                               else [user_knn]):
                    clause = clause if isinstance(clause, dict) else {}
                    kfield = clause.get("field")
                    if isinstance(kfield, str) and kfield:
                        refs = refs + [kfield]
                    kf = clause.get("filter")
                    if kf is not None:
                        if isinstance(kf, list):
                            sub_refs = []
                            for one in kf:
                                r = self._query_fields(one)
                                sub_refs = None if r is None \
                                    else sub_refs + r
                                if sub_refs is None:
                                    break
                        else:
                            sub_refs = self._query_fields(kf)
                        if sub_refs is None:
                            raise IllegalSecurityScope(
                                "cannot verify [knn] filter fields under "
                                "this user's field-level security")
                        refs = refs + sub_refs
            if had_q_param:
                # ?q= lucene syntax may address any field — demand the
                # catch-all grant
                refs = refs + ["*"]
            for ref in refs:
                if not any(fnmatch.fnmatch(ref, g) for g in fields):
                    raise IllegalSecurityScope(
                        f"field [{ref}] is not granted by this user's "
                        f"field-level security")
            if "script_fields" in body:
                raise IllegalSecurityScope(
                    "[script_fields] is unavailable under field-level "
                    "security")
            # FLS via _source includes: granted patterns intersected
            # with whatever the request asked for
            requested = body.get("_source")
            if isinstance(requested, list):
                includes = [f for f in requested
                            if any(fnmatch.fnmatch(f, g)
                                   for g in fields)]
                body["_source"] = includes or ["__fls_nothing__"]
            else:
                body["_source"] = list(fields) or ["__fls_nothing__"]
        request.body = body

    def check(self, request) -> Optional[Tuple[int, Dict[str, Any]]]:
        """None = allowed; else (status, error body). SecurityRestFilter
        analog, invoked before dispatch."""
        if not self.enabled():
            return None
        user = self.authenticate(request.headers or {})
        if user is None:
            self.audit.log("authentication_failed", None, "-",
                           request.method, request.path)
            return 401, {"error": {
                "type": "security_exception",
                "reason": "missing or invalid credentials",
                "header": {"WWW-Authenticate": 'Basic realm="security"'}},
                "status": 401}
        realm = user.get("realm", "native")
        if not self._authorize_request(user, request):
            self.audit.log("access_denied", user["username"], realm,
                           request.method, request.path)
            return 403, {"error": {
                "type": "security_exception",
                "reason": f"action [{request.method} {request.path}] is "
                          f"unauthorized for user [{user['username']}]"},
                "status": 403}
        try:
            self._apply_dls(user, request)
        except IllegalSecurityScope as e:
            self.audit.log("access_denied", user["username"], realm,
                           request.method, request.path, reason=str(e))
            return 403, {"error": {
                "type": "security_exception", "reason": str(e)},
                "status": 403}
        except IllegalArgumentError as e:
            # malformed request shapes are the CLIENT's error: a clear
            # 400, consistent with the unsecured path's validation
            return 400, {"error": e.to_json(), "status": 400}
        except Exception:  # noqa: BLE001 — a DLS failure must fail CLOSED
            self.audit.log("access_denied", user["username"], realm,
                           request.method, request.path,
                           reason="dls failure")
            return 403, {"error": {
                "type": "security_exception",
                "reason": "failed to apply document-level security"},
                "status": 403}
        self.audit.log("access_granted", user["username"], realm,
                       request.method, request.path)
        request.params["_authenticated_user"] = user["username"]
        request.params["_authenticated_record"] = user
        return None
