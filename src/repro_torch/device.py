"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU
(``device="cpu"``, as the CPU tests do).  Asking for CUDA where no card is
present raises: nothing slides to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain CPU path")
    return dev
