"""Buffer source: the slice's part of rodio_tpu/sources/generators.py.

Only :class:`SamplesBuffer` is ported. Its PCM lives on the device, zero
padded by ``pad_frames`` so that windows read past the end find silence.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State, clip_valid, mask_block
from ..core.types import StreamSpec
from ..utils.device import DeviceLike, resolve_device


class SamplesBuffer(Node):
    """Device-resident PCM buffer source (src/buffer.rs:23-200).

    Accepts interleaved 1-D data (rodio layout) or a [channels, frames]
    array. RANDOM_ACCESS marks the node as gatherable: downstream stages
    (the resampler, the fused pipeline) read frames directly.
    """

    RANDOM_ACCESS = True
    #: zero padding appended to the device array (per instance if given)
    PAD_FRAMES = 8192

    def __init__(self, channels: int, sample_rate: int, data,
                 *, start_frame: int = 0, pad_frames: Optional[int] = None,
                 device: DeviceLike = None):
        self.spec = StreamSpec(channels, sample_rate)
        self.device = resolve_device(device)
        if pad_frames is not None:
            if pad_frames < 1:
                raise ValueError("pad_frames must be >= 1")
            self.PAD_FRAMES = int(pad_frames)
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim == 1:
            frames = len(arr) // channels
            arr = arr[: frames * channels].reshape(frames, channels).T
        elif arr.ndim != 2 or arr.shape[0] != channels:
            raise ValueError("data must be 1-D interleaved or [channels, frames]")
        self._frames = arr.shape[1]
        data_t = torch.zeros((channels, self._frames + self.PAD_FRAMES),
                             dtype=torch.float32, device=self.device)
        data_t[:, : self._frames] = torch.from_numpy(np.ascontiguousarray(arr))
        self._data = data_t
        self._start = int(start_frame)

    def total_frames(self) -> Optional[int]:
        return max(0, self._frames - self._start)

    def init_state(self) -> State:
        # the logical end lives in the state, as in the JAX package
        return {
            "data": self._data,
            "pos": torch.tensor(self._start, dtype=torch.int64, device=self.device),
            "end": torch.tensor(self._frames, dtype=torch.int64, device=self.device),
        }

    def access_window(self, state: State):
        """(start_frame, frames_from_start) of the remaining stream."""
        return state["pos"], state["end"] - state["pos"]

    def gather_frames(self, state: State, idx: torch.Tensor) -> torch.Tensor:
        """Frames at device indices ``idx``; zero outside the buffer."""
        data = state["data"]
        inside = (idx >= 0) & (idx < data.shape[1])
        out = data[:, torch.clamp(idx, 0, data.shape[1] - 1)]
        return torch.where(inside[None, :], out, torch.zeros_like(out))

    def slice_frames(self, state: State, start: torch.Tensor, length: int):
        """Contiguous [C, length] window at a device start (clamped into
        the zero padding when past the end)."""
        start = torch.clamp(start, 0, self._frames + self.PAD_FRAMES - length)
        idx = start + torch.arange(length, device=self.device)
        return state["data"][:, idx]

    def emit(self, state: State, n: int):
        pos = state["pos"]
        block = self.gather_frames(state, pos + torch.arange(n, device=self.device))
        valid = clip_valid(state["end"] - pos, n)
        return {**state, "pos": pos + n}, mask_block(block, valid), valid
