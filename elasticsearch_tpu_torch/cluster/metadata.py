"""Index + cluster metadata: the schema half of cluster state.

Reference: cluster/metadata/IndexMetadata.java:84 and Metadata. Immutable;
every mutation returns a new object with a bumped version. Serialization is
dict-shaped (the control plane's JSON wire).
"""

from __future__ import annotations

import uuid as uuid_mod
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError, IndexAlreadyExistsError, IndexNotFoundError,
)


@dataclass(frozen=True)
class IndexMetadata:
    name: str
    uuid: str
    number_of_shards: int = 1
    number_of_replicas: int = 0
    version: int = 1
    state: str = "open"                       # open | close
    mappings: Mapping[str, Any] = field(default_factory=dict)
    settings: Mapping[str, Any] = field(default_factory=dict)
    aliases: Tuple[str, ...] = ()
    # alias name -> properties: {"filter": query?, "routing": str?,
    # "is_write_index": bool?} (AliasMetadata analog). aliases keeps the
    # plain name tuple for cheap membership; configs carry the rest.
    alias_configs: Mapping[str, Any] = field(default_factory=dict)
    # per-shard primary term, bumped on every primary failover
    # (IndexMetadata.java primaryTerms[]; carried by every replicated op)
    primary_terms: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.number_of_shards < 1:
            raise IllegalArgumentError("number_of_shards must be >= 1")
        if self.number_of_replicas < 0:
            raise IllegalArgumentError("number_of_replicas must be >= 0")
        if not self.primary_terms:
            object.__setattr__(self, "primary_terms",
                               tuple([1] * self.number_of_shards))

    def primary_term(self, shard: int) -> int:
        return self.primary_terms[shard]

    def with_primary_term_bump(self, shard: int) -> "IndexMetadata":
        terms = list(self.primary_terms)
        terms[shard] += 1
        return replace(self, primary_terms=tuple(terms),
                       version=self.version + 1)

    @staticmethod
    def create(name: str, number_of_shards: int = 1,
               number_of_replicas: int = 0,
               mappings: Optional[Mapping[str, Any]] = None,
               settings: Optional[Mapping[str, Any]] = None) -> "IndexMetadata":
        return IndexMetadata(name=name, uuid=uuid_mod.uuid4().hex,
                             number_of_shards=number_of_shards,
                             number_of_replicas=number_of_replicas,
                             mappings=dict(mappings or {}),
                             settings=dict(settings or {}))

    def with_mappings(self, mappings: Mapping[str, Any]) -> "IndexMetadata":
        return replace(self, mappings=dict(mappings), version=self.version + 1)

    def with_replicas(self, n: int) -> "IndexMetadata":
        return replace(self, number_of_replicas=n, version=self.version + 1)

    def with_settings(self, settings: Mapping[str, Any]) -> "IndexMetadata":
        merged = {**self.settings, **settings}
        return replace(self, settings=merged, version=self.version + 1)

    def with_aliases(self, aliases: Tuple[str, ...],
                     alias_configs: Optional[Mapping[str, Any]] = None
                     ) -> "IndexMetadata":
        configs = dict(alias_configs if alias_configs is not None
                       else self.alias_configs)
        configs = {k: v for k, v in configs.items() if k in aliases}
        return replace(self, aliases=tuple(aliases),
                       alias_configs=configs, version=self.version + 1)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "uuid": self.uuid,
            "number_of_shards": self.number_of_shards,
            "number_of_replicas": self.number_of_replicas,
            "version": self.version, "state": self.state,
            "mappings": dict(self.mappings), "settings": dict(self.settings),
            "aliases": list(self.aliases),
            "alias_configs": dict(self.alias_configs),
            "primary_terms": list(self.primary_terms),
        }

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "IndexMetadata":
        return IndexMetadata(
            name=d["name"], uuid=d["uuid"],
            number_of_shards=d["number_of_shards"],
            number_of_replicas=d["number_of_replicas"],
            version=d.get("version", 1), state=d.get("state", "open"),
            mappings=dict(d.get("mappings", {})),
            settings=dict(d.get("settings", {})),
            aliases=tuple(d.get("aliases", ())),
            alias_configs=dict(d.get("alias_configs", {})),
            primary_terms=tuple(d.get("primary_terms", ())))


@dataclass(frozen=True)
class Metadata:
    """All cluster-wide persistent metadata (indices, templates, settings)."""

    indices: Mapping[str, IndexMetadata] = field(default_factory=dict)
    # composable index templates: name -> {index_patterns, priority,
    # template: {settings, mappings, aliases}}
    # (cluster/metadata/ComposableIndexTemplate.java analog)
    templates: Mapping[str, Any] = field(default_factory=dict)
    # ILM policies: name -> {phases: {hot: {...}, delete: {...}}}
    # (x-pack/plugin/core/.../ilm/LifecyclePolicy.java analog)
    ilm_policies: Mapping[str, Any] = field(default_factory=dict)
    # security entities: {"users": {name: {hash, salt, roles}},
    # "roles": {name: {cluster, indices}}} — the .security index analog
    security: Mapping[str, Any] = field(default_factory=dict)
    # named custom sections (Metadata.Custom analog): transforms, watches,
    # ... — each a {name: body} map owned by one service
    custom: Mapping[str, Any] = field(default_factory=dict)
    persistent_settings: Mapping[str, Any] = field(default_factory=dict)
    version: int = 0

    @property
    def data_streams(self) -> Dict[str, Any]:
        """name -> {timestamp_field, generation, indices: [backing...]}
        (cluster/metadata/DataStream.java analog, stored as a custom
        section so it replicates/persists like all metadata)."""
        return dict(self.custom.get("data_streams", {}))

    def with_data_stream(self, name: str,
                         body: Optional[Mapping[str, Any]]) -> "Metadata":
        return self.with_custom_entry("data_streams", name, body)

    def index(self, name: str) -> IndexMetadata:
        # alias resolution: a name may be an alias for exactly one index,
        # or for several when exactly one carries is_write_index
        # (AliasOrIndex.Alias.getWriteIndex semantics)
        if name in self.indices:
            return self.indices[name]
        ds = self.custom.get("data_streams", {}).get(name)
        if ds and ds.get("indices"):
            # a data stream resolves to its WRITE index (the latest
            # backing index) for single-index operations
            backing = ds["indices"][-1]
            if backing not in self.indices:
                raise IndexNotFoundError(backing)
            return self.indices[backing]
        matches = [im for im in self.indices.values() if name in im.aliases]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            writers = [im for im in matches
                       if (im.alias_configs.get(name) or {})
                       .get("is_write_index")]
            if len(writers) == 1:
                return writers[0]
            raise IllegalArgumentError(
                f"alias [{name}] has more than one index associated "
                f"and no single is_write_index")
        raise IndexNotFoundError(name)

    def alias_filters(self, expression: str) -> list:
        """Query filters attached to aliases the expression reaches —
        LITERALLY or via a wildcard part matching the ALIAS name (the
        access path determines filtering; `_all`/bare wildcards over
        index names do not route through aliases).
        Returns [(alias, index, filter), ...]."""
        import fnmatch as _fn
        out = []
        for part in (expression or "").split(","):
            part = part.strip()
            if not part or part in self.indices or part == "_all":
                continue
            for im in self.indices.values():
                for alias in im.aliases:
                    if alias == part or ("*" in part and
                                         _fn.fnmatch(alias, part)):
                        filt = (im.alias_configs.get(alias)
                                or {}).get("filter")
                        if filt is not None:
                            out.append((alias, im.name, filt))
        return out

    def has_index(self, name: str) -> bool:
        try:
            self.index(name)
            return True
        except IndexNotFoundError:
            return False

    def put_index(self, im: IndexMetadata) -> "Metadata":
        if im.name in self.indices:
            raise IndexAlreadyExistsError(
                f"index [{im.name}] already exists")
        return replace(self, indices={**self.indices, im.name: im},
                       version=self.version + 1)

    def update_index(self, im: IndexMetadata) -> "Metadata":
        if im.name not in self.indices:
            raise IndexNotFoundError(im.name)
        return replace(self, indices={**self.indices, im.name: im},
                       version=self.version + 1)

    def remove_index(self, name: str) -> "Metadata":
        if name not in self.indices:
            raise IndexNotFoundError(name)
        indices = {k: v for k, v in self.indices.items() if k != name}
        return replace(self, indices=indices, version=self.version + 1)

    def with_template(self, name: str,
                      template: Optional[Mapping[str, Any]]) -> "Metadata":
        """Put (or with None, delete) one composable index template."""
        templates = {k: v for k, v in self.templates.items() if k != name}
        if template is not None:
            templates[name] = dict(template)
        return replace(self, templates=templates, version=self.version + 1)

    def with_ilm_policy(self, name: str,
                        policy: Optional[Mapping[str, Any]]) -> "Metadata":
        policies = {k: v for k, v in self.ilm_policies.items() if k != name}
        if policy is not None:
            policies[name] = dict(policy)
        return replace(self, ilm_policies=policies,
                       version=self.version + 1)

    def with_security_entity(self, kind: str, name: str,
                             body: Optional[Mapping[str, Any]]
                             ) -> "Metadata":
        """Put (or with None, delete) one user/role under security[kind]."""
        section = {k: v for k, v in
                   dict(self.security.get(kind, {})).items() if k != name}
        if body is not None:
            section[name] = dict(body)
        return replace(self, security={**self.security, kind: section},
                       version=self.version + 1)

    def with_custom_entry(self, section: str, name: str,
                          body: Optional[Mapping[str, Any]]) -> "Metadata":
        """Put (or with None, delete) one entry of a custom section."""
        entries = {k: v for k, v in
                   dict(self.custom.get(section, {})).items() if k != name}
        if body is not None:
            entries[name] = dict(body)
        return replace(self, custom={**self.custom, section: entries},
                       version=self.version + 1)

    def with_persistent_settings(self, settings: Mapping[str, Any]) -> "Metadata":
        # a None value unsets the key (the reference's null-reset semantics
        # for PUT _cluster/settings)
        merged = {**self.persistent_settings, **settings}
        merged = {k: v for k, v in merged.items() if v is not None}
        return replace(self, persistent_settings=merged,
                       version=self.version + 1)

    def matching_templates(self, index_name: str) -> list:
        """Templates whose index_patterns match, highest priority first
        (MetadataIndexTemplateService.findV2Template analog)."""
        import fnmatch
        hits = []
        for name, t in self.templates.items():
            if any(fnmatch.fnmatch(index_name, p)
                   for p in t.get("index_patterns", [])):
                hits.append((int(t.get("priority", 0)), name, t))
        hits.sort(key=lambda h: (-h[0], h[1]))
        return [(name, t) for _, name, t in hits]

    def to_dict(self) -> Dict[str, Any]:
        return {"indices": {k: v.to_dict() for k, v in self.indices.items()},
                "templates": dict(self.templates),
                "ilm_policies": dict(self.ilm_policies),
                "security": dict(self.security),
                "custom": dict(self.custom),
                "persistent_settings": dict(self.persistent_settings),
                "version": self.version}

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Metadata":
        return Metadata(
            indices={k: IndexMetadata.from_dict(v)
                     for k, v in d.get("indices", {}).items()},
            templates=dict(d.get("templates", {})),
            ilm_policies=dict(d.get("ilm_policies", {})),
            security=dict(d.get("security", {})),
            custom=dict(d.get("custom", {})),
            persistent_settings=dict(d.get("persistent_settings", {})),
            version=d.get("version", 0))


def resolve_index_expression(expression: Optional[str],
                             metadata: "Metadata") -> list:
    """Resolve comma lists, ``*`` wildcards, ``_all`` and aliases to concrete
    index names (IndexNameExpressionResolver analog,
    cluster/metadata/IndexNameExpressionResolver.java). Unknown concrete
    names raise IndexNotFoundError; unmatched wildcards resolve empty."""
    import fnmatch

    names = set()
    all_names = list(metadata.indices)
    alias_map: Dict[str, list] = {}
    for im in metadata.indices.values():
        for alias in im.aliases:
            alias_map.setdefault(alias, []).append(im.name)
    streams = metadata.custom.get("data_streams", {})
    for part in (expression or "_all").split(","):
        part = part.strip()
        if part in ("_all", "*", ""):
            names.update(all_names)
        elif "*" in part:
            matched = [n for n in all_names if fnmatch.fnmatch(n, part)]
            matched += [n for a, targets in alias_map.items()
                        if fnmatch.fnmatch(a, part) for n in targets]
            # a wildcard over data-stream NAMES reaches all their backing
            # indices (IndexNameExpressionResolver's data-stream aware
            # wildcard resolution)
            for ds_name, ds in streams.items():
                if fnmatch.fnmatch(ds_name, part):
                    matched += list(ds.get("indices", []))
            names.update(matched)
        elif part in metadata.indices:
            names.add(part)
        elif part in alias_map:
            names.update(alias_map[part])
        elif part in streams:
            # searching a data stream searches EVERY backing index
            names.update(streams[part].get("indices", []))
        else:
            raise IndexNotFoundError(part)
    return sorted(names)
