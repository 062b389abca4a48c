"""Block-engine node protocol (the counterpart of rodio_tpu/core/node.py).

A node is a plain object with an explicit ``device``:

- ``spec`` — output :class:`~rodio_tpu_torch.core.types.StreamSpec`.
- ``total_frames()`` — known output length in frames, or ``None``.
- ``init_state()`` — a dict of tensors on the node's device. A block
  offset that only ever advances by ``n`` may be a host int, but not
  under a node that selects its input's state by a device flag, as
  ``Pausable`` does: :func:`tree_select` refuses a host value that differs
  between its branches.
- ``emit(state, n)`` — returns ``(state', block, valid)``: ``block`` is
  ``[channels, n]`` f32 (bf16 after a ``Bf16Boundary``), ``valid`` a 0-dim
  int64 tensor on the device that counts the valid leading frames. Frames
  at index >= valid are zero. After a stream ends, further emits return
  ``valid == 0``. ``emit`` never reads a device value back to the host, so
  a loop of emits never waits for the card.

The combinators of the JAX package's Node are here, all but ``to_file``
(the WAV writer, ``io``, is not ported yet).
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

    def total_duration(self) -> Optional[float]:
        tf = self.total_frames()
        return None if tf is None else tf / self.spec.sample_rate

    def init_state(self) -> State:
        raise NotImplementedError

    def emit(self, state: State, n: int) -> Tuple[State, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    # combinators (src/source/mod.rs:222-731)
    def amplify(self, factor) -> "Node":
        from ..effects.basic import Amplify

        return Amplify(self, factor)

    def amplify_decibel(self, db: float) -> "Node":
        from ..effects.basic import Amplify
        from .math import db_to_linear_host

        return Amplify(self, db_to_linear_host(db))

    def amplify_normalized(self, value: float) -> "Node":
        from ..effects.basic import Amplify
        from .math import amplify_normalized_factor

        return Amplify(self, amplify_normalized_factor(value))

    def distortion(self, gain: float, threshold: float) -> "Node":
        from ..effects.basic import Distortion

        return Distortion(self, gain, threshold)

    def linear_gain_ramp(self, duration: float, start: float, end: float,
                         clamp_end: bool) -> "Node":
        from ..effects.basic import LinearGainRamp

        return LinearGainRamp(self, duration, start, end, clamp_end)

    def fade_in(self, duration: float) -> "Node":
        return self.linear_gain_ramp(duration, 0.0, 1.0, False)

    def fade_out(self, duration: float) -> "Node":
        return self.linear_gain_ramp(duration, 1.0, 0.0, True)

    def take_duration(self, duration: float, *, fadeout: bool = False) -> "Node":
        from ..effects.basic import TakeDuration

        return TakeDuration(self, duration, fadeout=fadeout)

    def skip_duration(self, duration: float) -> "Node":
        from ..effects.basic import SkipDuration

        return SkipDuration(self, duration)

    def delay(self, duration: float) -> "Node":
        from ..effects.basic import Delay

        return Delay(self, duration)

    def speed(self, factor: float) -> "Node":
        from ..effects.basic import Speed

        return Speed(self, factor)

    def low_pass(self, freq: float, q: float = 0.5) -> "Node":
        from ..effects.blt import BltFilter

        return BltFilter(self, "low_pass", freq, q)

    def high_pass(self, freq: float, q: float = 0.5) -> "Node":
        from ..effects.blt import BltFilter

        return BltFilter(self, "high_pass", freq, q)

    def low_pass_with_q(self, freq: float, q: float) -> "Node":
        return self.low_pass(freq, q)

    def high_pass_with_q(self, freq: float, q: float) -> "Node":
        return self.high_pass(freq, q)

    def limit(self, settings=None) -> "Node":
        from ..effects.limit import Limit, LimitSettings

        return Limit(self, settings or LimitSettings())

    def automatic_gain_control(self, settings=None) -> "Node":
        from ..effects.agc import AgcSettings, AutomaticGainControl

        return AutomaticGainControl(self, settings or AgcSettings())

    def channel_volume(self, volumes) -> "Node":
        from ..effects.basic import ChannelVolume

        return ChannelVolume(self, volumes)

    def spatial(self, emitter_pos, left_ear, right_ear) -> "Node":
        from ..effects.basic import Spatial

        return Spatial(self, emitter_pos, left_ear, right_ear)

    def mix(self, other: "Node") -> "Node":
        from ..effects.mix import Mix

        return Mix(self, other)

    def reverb(self, duration: float, amplitude: float) -> "Node":
        """Echo: self.mix(self.amplify(a).delay(d)) (src/source/mod.rs:628-634).
        Nodes are declarative and re-emittable, so no ``.buffered()`` is
        needed before it."""
        return self.mix(self.amplify(amplitude).delay(duration))

    def dither(self, bits: int, algorithm: str = "tpdf", seed: int = 0) -> "Node":
        from ..effects.dither import Dither

        return Dither(self, bits, algorithm, seed)

    def uniform(self, channels: int, sample_rate: int) -> "Node":
        """Convert to a fixed (channels, rate): UniformSourceIterator
        (src/source/uniform.rs:33)."""
        from ..conversions.uniform import Uniform

        return Uniform(self, channels, sample_rate)

    def resample(self, sample_rate: int) -> "Node":
        from ..conversions.resample import Resample

        return Resample(self, sample_rate)

    def rechannel(self, channels: int) -> "Node":
        from ..conversions.channels import RechannelNode

        return RechannelNode(self, channels)

    def repeat_infinite(self) -> "Node":
        from ..effects.basic import Repeat

        return Repeat(self)

    def track_position(self) -> "Node":
        from ..effects.basic import TrackPosition

        return TrackPosition(self)

    def pausable(self, initially_paused: bool = False) -> "Node":
        from ..effects.basic import Pausable

        return Pausable(self, initially_paused)

    def stoppable(self) -> "Node":
        from ..effects.basic import Stoppable

        return Stoppable(self)

    def skippable(self) -> "Node":
        from ..effects.basic import Skippable

        return Skippable(self)

    def buffered(self):
        """Lazy shared-cache buffering (src/source/buffered.rs): the result
        is host-driven and its clones share the cache. ``graph.render.record``
        gives an eager buffer on the device."""
        from ..sources.buffered import Buffered

        return Buffered(self)

    def record(self):
        return self.buffered()

    def take_crossfade_with(self, other: "Node", duration: float) -> "Node":
        fo = self.take_duration(duration, fadeout=True)
        fi = other.take_duration(duration).fade_in(duration)
        return fo.mix(fi)

    def render(self, *, max_frames: Optional[int] = None,
               block_frames: int = 4096) -> np.ndarray:
        """Render to a [channels, frames] numpy array (pull to exhaustion)."""
        from ..graph.render import render

        return render(self, max_frames=max_frames, block_frames=block_frames)


def mask_block(block: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero out frames at index >= valid (the block keeps its dtype)."""
    n = block.shape[-1]
    idx = torch.arange(n, device=block.device)
    return torch.where(idx[None, :] < valid, block, torch.zeros_like(block))


def clip_valid(valid: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(valid, 0, n).to(torch.int64)


def full_valid(n: int, device) -> torch.Tensor:
    """A 0-dim int64 ``valid`` of ``n`` made on the device by a fill, not
    copied from the host."""
    return torch.full((), n, dtype=torch.int64, device=device)


def tree_select(pred: torch.Tensor, on_true, on_false):
    """``torch.where(pred, a, b)`` over two states of one structure, the
    counterpart of the JAX package's ``_tree_select``. A tensor that is
    the same object on both sides (a buffer's PCM) is kept, not copied.

    A device predicate cannot choose between two different host values
    without reading it back, so a host value (an int offset) that differs
    between the branches raises TypeError; one that is equal is kept."""
    if isinstance(on_true, dict):
        if on_true.keys() != on_false.keys():
            raise TypeError(f"tree_select: keys differ: {sorted(on_true)} "
                            f"vs {sorted(on_false)}")
        return {k: tree_select(pred, on_true[k], on_false[k]) for k in on_true}
    if isinstance(on_true, (tuple, list)):
        if type(on_true) is not type(on_false) or len(on_true) != len(on_false):
            raise TypeError("tree_select: sequences differ in type or length")
        return type(on_true)(tree_select(pred, a, b) for a, b in zip(on_true, on_false))
    if isinstance(on_true, torch.Tensor):
        if on_true is on_false:
            return on_true
        if not isinstance(on_false, torch.Tensor):
            raise TypeError("tree_select: a tensor against a host value")
        return torch.where(pred, on_true, on_false)
    if isinstance(on_false, torch.Tensor) or on_true != on_false:
        raise TypeError(
            f"tree_select: host values {on_true!r} and {on_false!r} differ; a "
            "device predicate cannot choose between them without a readback "
            "(keep the value in the state as a device tensor)")
    return on_true
