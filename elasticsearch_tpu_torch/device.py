"""The one device decision of the package.

Every entry point takes ``device=None`` and resolves it here: no argument
means the CUDA card, and a missing card is an error, never a silent move
to the CPU. Tests pass ``device="cpu"`` explicitly, which routes every
kernel wrapper to its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``torch.device`` for ``device``; ``None`` means ``cuda``.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{dev}]")
    return dev
