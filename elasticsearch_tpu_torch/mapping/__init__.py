from elasticsearch_tpu_torch.mapping.mappers import (
    FieldMapper,
    MapperService,
    ParsedDocument,
    ParsedField,
    build_mapper,
    parse_date_millis,
)

__all__ = [
    "FieldMapper",
    "MapperService",
    "ParsedDocument",
    "ParsedField",
    "build_mapper",
    "parse_date_millis",
]
