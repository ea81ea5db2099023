"""Device policy: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA card, and raises when there is none; any
    explicit device (for example "cpu") is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "slam3d_gx_torch runs on a CUDA device and none is present; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
