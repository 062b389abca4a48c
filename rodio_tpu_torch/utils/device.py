"""Device selection for the port.

Every entry point (``SamplesBuffer``, ``make_flagship``, and every node
built on them) runs on the card unless the caller asks for the CPU:
``device=None`` means the current CUDA device, and ``device="cpu"`` the
CPU. Asking for CUDA, explicitly or by default, on a host without it
raises: the port never drops silently to the CPU, because a CPU run would
then be mistaken for a measurement of the card.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` and ``"cuda"`` mean the current CUDA device, ``"cuda:N"``
    card N (each must exist); ``"cpu"`` the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False on this host; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def hosted_block(block, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A block a host-driven source returned (a numpy array, as the
    microphone's and the streaming feeds' are, or a tensor) as a tensor of
    the sample type ``dtype`` on ``device``. From numpy to the card this is
    a pageable copy, which waits for it."""
    from ..core.types import np_float_dtype

    if isinstance(block, torch.Tensor):
        return block.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(block, dtype=np_float_dtype(dtype))).to(device)
