from elasticsearch_tpu_torch.rest.controller import RestController, RestRequest
from elasticsearch_tpu_torch.rest.routes import build_controller

__all__ = ["RestController", "RestRequest", "build_controller"]
