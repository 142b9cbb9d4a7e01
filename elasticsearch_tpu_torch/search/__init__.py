"""Public search surface, resolved lazily (PEP 562).

The ops modules import ``search.device_profile`` / ``search.telemetry`` at
module load, and the serving stack under this package imports ops — an
eager ``__init__`` would close that cycle mid-import. Importing this
package therefore has no side effects; the exported names resolve on
first attribute access and then stay bound.
"""

_EXPORTS = {
    "SearchService": "elasticsearch_tpu_torch.search.service",
    "SegmentContext": "elasticsearch_tpu_torch.search.execute",
    "fetch_hits": "elasticsearch_tpu_torch.search.fetch",
    "filter_source": "elasticsearch_tpu_torch.search.fetch",
    "ShardDoc": "elasticsearch_tpu_torch.search.phase",
    "ShardQueryResult": "elasticsearch_tpu_torch.search.phase",
    "SortSpec": "elasticsearch_tpu_torch.search.phase",
    "parse_sort": "elasticsearch_tpu_torch.search.phase",
    "query_shard": "elasticsearch_tpu_torch.search.phase",
}

__all__ = sorted(_EXPORTS) + ["dsl"]


def __getattr__(name):
    import importlib
    module = _EXPORTS.get(name)
    if module is not None:
        value = getattr(importlib.import_module(module), name)
    else:
        qualified = f"elasticsearch_tpu_torch.search.{name}"
        try:
            value = importlib.import_module(qualified)
        except ModuleNotFoundError as e:
            if e.name != qualified:
                raise
            raise AttributeError(
                f"module 'elasticsearch_tpu_torch.search' has no attribute "
                f"{name!r}") from None
    globals()[name] = value
    return value


def __dir__():
    return sorted(__all__)
