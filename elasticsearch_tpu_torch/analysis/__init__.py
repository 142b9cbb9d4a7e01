from elasticsearch_tpu_torch.analysis.analyzers import (
    Analyzer,
    AnalysisRegistry,
    BUILTIN_ANALYZERS,
    ENGLISH,
    KEYWORD,
    STANDARD,
    Token,
)
from elasticsearch_tpu_torch.analysis.porter import porter_stem

__all__ = [
    "Analyzer",
    "AnalysisRegistry",
    "BUILTIN_ANALYZERS",
    "ENGLISH",
    "KEYWORD",
    "STANDARD",
    "Token",
    "porter_stem",
]
