"""Machine-learned inference on the card.

The JAX package's ``ml`` package: the learned-sparse text expansion model
(ELSER analog) and its registry. The model's whole forward pass is one
hand-written CUDA kernel (``csrc/text_expansion_forward.cu``) with a
plain PyTorch version beside its wrapper.
"""

from elasticsearch_tpu_torch.ml.text_expansion import (
    TextExpansionModel, get_model, register_model, rewrite_body_expansions,
    DEFAULT_MODEL_ID,
)

__all__ = ["TextExpansionModel", "get_model", "register_model",
           "rewrite_body_expansions", "DEFAULT_MODEL_ID"]
