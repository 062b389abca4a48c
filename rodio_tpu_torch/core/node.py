"""Block-engine node protocol (the counterpart of rodio_tpu/core/node.py).

A node is a plain object with an explicit ``device``:

- ``spec`` — output :class:`~rodio_tpu_torch.core.types.StreamSpec`.
- ``total_frames()`` — known output length in frames, or ``None``.
- ``init_state()`` — a dict of tensors on the node's device (a block
  offset that only ever advances by ``n`` may be a host int).
- ``emit(state, n)`` — returns ``(state', block, valid)``: ``block`` is
  ``[channels, n]`` f32, ``valid`` a 0-dim int64 tensor on the device that
  counts the valid leading frames. Frames at index >= valid are zero. After
  a stream ends, further emits return ``valid == 0``. ``emit`` never reads
  a device value back to the host, so a loop of emits never waits for
  the card.

Only the combinators whose nodes the port has are here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .types import StreamSpec

State = Dict[str, Any]


class Node:
    """Base class for block-engine audio nodes."""

    spec: StreamSpec
    device: torch.device

    def total_frames(self) -> Optional[int]:
        return None

    def init_state(self) -> State:
        raise NotImplementedError

    def emit(self, state: State, n: int) -> Tuple[State, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    # combinators (src/source/mod.rs:222-731), as far as the port goes
    def amplify(self, factor) -> "Node":
        from ..effects.basic import Amplify

        return Amplify(self, factor)

    def low_pass(self, freq: float, q: float = 0.5) -> "Node":
        from ..effects.blt import BltFilter

        return BltFilter(self, "low_pass", freq, q)

    def high_pass(self, freq: float, q: float = 0.5) -> "Node":
        from ..effects.blt import BltFilter

        return BltFilter(self, "high_pass", freq, q)

    def resample(self, sample_rate: int) -> "Node":
        from ..conversions.resample import Resample

        return Resample(self, sample_rate)

    def limit(self, settings=None) -> "Node":
        from ..effects.limit import Limit, LimitSettings

        return Limit(self, settings or LimitSettings())

    def automatic_gain_control(self, settings=None) -> "Node":
        from ..effects.agc import AgcSettings, AutomaticGainControl

        return AutomaticGainControl(self, settings or AgcSettings())

    def render(self, *, max_frames: Optional[int] = None,
               block_frames: int = 4096) -> np.ndarray:
        """Render to a [channels, frames] numpy array (pull to exhaustion)."""
        from ..graph.render import render

        return render(self, max_frames=max_frames, block_frames=block_frames)


def mask_block(block: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero out frames at index >= valid."""
    n = block.shape[-1]
    idx = torch.arange(n, device=block.device)
    return torch.where(idx[None, :] < valid, block, torch.zeros_like(block))


def clip_valid(valid: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(valid, 0, n).to(torch.int64)
