"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device. Without a CUDA device this
    raises instead of falling back to the CPU: a run that silently moved
    to the host would report host numbers as the card's. Callers that
    want the CPU (the parity tests) pass ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the "
            "host explicitly"
        )
    return torch.device("cuda", torch.cuda.current_device())
