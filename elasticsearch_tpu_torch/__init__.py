"""elasticsearch_tpu_torch — the PyTorch/CUDA build of elasticsearch_tpu.

The same search engine with its device work on an NVIDIA Hopper card:
host modules (analysis, mapping, the segment/translog/store formats, the
query DSL, fetch, telemetry) are copies of the JAX package's, so both read
the same on-disk index; the scoring programs are hand-written CUDA kernels
under ``csrc/`` with a plain PyTorch version of each beside its wrapper
(``ops/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).

This package imports PyTorch and never JAX, nor anything of
``elasticsearch_tpu``.
"""

from elasticsearch_tpu_torch.version import __version__

__all__ = ["__version__"]
