from elasticsearch_tpu_torch.node.node import Node, NodeClient

__all__ = ["Node", "NodeClient"]
