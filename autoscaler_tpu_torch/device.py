"""Default device of the port's entry points.

Entry points take ``device=None``, which means the first CUDA card. On a
host without one they raise unless the caller asked for the CPU
explicitly (``device="cpu"``, as the tests do): nothing carries on
silently on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda:0``; anything else → ``torch.device(device)``.
    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is present."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host"
        )
    return dev
