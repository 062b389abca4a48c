"""Device selection for the port.

Every node takes an explicit ``device``. Asking for CUDA on a host without
it raises: the port never drops silently to the CPU, because a CPU run would
then be mistaken for a measurement of the card.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CPU; ``"cuda"`` (or ``"cuda:N"``) must exist."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False on this host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
