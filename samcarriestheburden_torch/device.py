"""Device policy of the port's entry points.

``device=None`` means the card.  Without one the entry points raise: they
never carry on quietly on the CPU.  Tests ask for the CPU by name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
