from elasticsearch_tpu_torch.utils.settings import (
    Property,
    Scope,
    Setting,
    Settings,
    SettingsRegistry,
)
from elasticsearch_tpu_torch.utils.murmur3 import murmur3_32, shard_id_for

__all__ = [
    "Property",
    "Scope",
    "Setting",
    "Settings",
    "SettingsRegistry",
    "murmur3_32",
    "shard_id_for",
]
