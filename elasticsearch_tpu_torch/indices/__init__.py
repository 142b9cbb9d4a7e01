from elasticsearch_tpu_torch.indices.indices_service import IndexService, IndicesService
from elasticsearch_tpu_torch.indices.cluster_state_service import IndicesClusterStateService

__all__ = ["IndexService", "IndicesService", "IndicesClusterStateService"]
