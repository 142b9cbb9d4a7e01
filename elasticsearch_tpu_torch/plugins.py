"""Plugin SPI: register extensions into the engine's open registries.

Reference: plugins/SearchPlugin.java:67, AnalysisPlugin, IngestPlugin,
MapperPlugin — interfaces a plugin implements to contribute queries,
aggregations, analyzers, ingest processors, and field types. This build
has no classloader isolation (plugins are ordinary Python modules), but
the same extension points exist as explicit registration functions, and
``load_plugins`` installs modules listed as ``module.path:ClassName``
(the plugin-descriptor analog). Everything registered here flows through
the exact dispatch tables the built-ins use, so extensions are
indistinguishable from first-party features at query time.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional, Type

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

__all__ = [
    "Plugin", "load_plugins",
    "register_query", "register_field_mapper", "register_analyzer",
    "register_ingest_processor", "register_aggregation",
]


def register_query(name: str, node_type: type,
                   parser: Callable[[Any], Any],
                   handler: Callable[[Any, Any], Any]) -> None:
    """A new query: DSL key -> parser -> (query node, SegmentContext)
    execution handler (SearchPlugin.getQueries analog)."""
    # the search package re-exports an `execute` FUNCTION that shadows the
    # submodule attribute — import_module returns the real module
    execute_mod = importlib.import_module("elasticsearch_tpu_torch.search.execute")
    from elasticsearch_tpu_torch.search import dsl
    if name in dsl._PARSERS:
        raise IllegalArgumentError(f"query [{name}] already registered")
    dsl._PARSERS[name] = parser
    execute_mod._HANDLERS[node_type] = handler


def register_field_mapper(type_name: str, mapper_cls: Type) -> None:
    """A new field type (MapperPlugin.getMappers analog)."""
    from elasticsearch_tpu_torch.mapping import mappers
    if type_name in mappers._MAPPER_TYPES:
        raise IllegalArgumentError(
            f"field type [{type_name}] already registered")
    mappers._MAPPER_TYPES[type_name] = mapper_cls


def register_analyzer(name: str, analyzer: Any) -> None:
    """A new named analyzer (AnalysisPlugin.getAnalyzers analog)."""
    from elasticsearch_tpu_torch.analysis import analyzers
    if name in analyzers.BUILTIN_ANALYZERS:
        raise IllegalArgumentError(
            f"analyzer [{name}] already registered")
    analyzers.BUILTIN_ANALYZERS[name] = analyzer


def register_ingest_processor(name: str,
                              factory: Callable[[Dict[str, Any]],
                                                Callable]) -> None:
    """A new ingest processor (IngestPlugin.getProcessors analog)."""
    from elasticsearch_tpu_torch import ingest
    if name in ingest.PROCESSORS:
        raise IllegalArgumentError(
            f"processor [{name}] already registered")
    ingest.PROCESSORS[name] = factory


def register_aggregation(type_name: str, *, collect: Callable,
                         merge: Callable, finalize: Callable,
                         bucket: bool = False) -> None:
    """A new aggregation (SearchPlugin.getAggregations analog): the
    collect/merge/finalize triple slots straight into the shard-collect +
    coordinator-reduce engine."""
    from elasticsearch_tpu_torch.search.aggregations import buckets, metrics, spec
    if type_name in spec.ALL_TYPES:
        raise IllegalArgumentError(
            f"aggregation [{type_name}] already registered")
    if bucket:
        spec.BUCKET_TYPES.add(type_name)
        buckets.BUCKET_COLLECT[type_name] = collect
        buckets.BUCKET_MERGE[type_name] = merge
        buckets.BUCKET_FINALIZE[type_name] = finalize
    else:
        spec.METRIC_TYPES.add(type_name)
        metrics.METRIC_COLLECT[type_name] = collect
        metrics.METRIC_MERGE[type_name] = merge
        metrics.METRIC_FINALIZE[type_name] = finalize
    spec.ALL_TYPES.add(type_name)


class Plugin:
    """Subclass and override ``install`` to register extensions."""

    name = "unnamed"

    def install(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


_loaded: List[str] = []


def load_plugins(specs: List[str]) -> List[str]:
    """Install plugins given ``module.path:ClassName`` descriptors.

    Idempotent per descriptor (a node restart in-process must not
    double-register). Returns the plugin names installed this call."""
    installed = []
    for descriptor in specs:
        if descriptor in _loaded:
            continue
        module_path, _, attr = descriptor.partition(":")
        try:
            module = importlib.import_module(module_path)
            plugin_cls = getattr(module, attr) if attr else None
        except (ImportError, AttributeError) as e:
            raise IllegalArgumentError(
                f"cannot load plugin [{descriptor}]: {e}")
        if plugin_cls is None or not issubclass(plugin_cls, Plugin):
            raise IllegalArgumentError(
                f"plugin [{descriptor}] must name a Plugin subclass")
        plugin = plugin_cls()
        plugin.install()
        _loaded.append(descriptor)
        installed.append(plugin.name)
    return installed
