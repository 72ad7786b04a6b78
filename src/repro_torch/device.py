"""Where the port runs: ``cuda`` unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device on a machine without one
    raises: the port never carries on quietly on the CPU; pass
    ``device="cpu"`` to run the plain versions there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """``"bfloat16"`` -> ``torch.bfloat16`` (None stays None)."""
    return None if name is None else getattr(torch, name)
