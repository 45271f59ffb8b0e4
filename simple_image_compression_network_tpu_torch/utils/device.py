"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else as given.

    Entry points run on the card unless the caller asks for the CPU
    (``device="cpu"``, as the CPU tests do).  With no device given and no
    card present this raises: the port never drops quietly to the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
