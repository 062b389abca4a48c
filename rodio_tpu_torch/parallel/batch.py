"""Stream-batch execution (rodio_tpu/parallel/batch.py).

S structurally identical chains run in lockstep as one call:
:class:`BatchedChain` maps the template's ``emit`` over a leading stream
axis of the state with ``torch.func.vmap``, and :class:`BatchedMixer` sums
the streams (src/mixer.rs:185-198). The production layout for homogeneous
streams is :class:`WideMixer`'s instead: the stream axis folded into the
channels, one chain of S*C channels, no vmap.

Per-stream variation (PCM, gains, lengths) lives in the state; the
template node gives the structure.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.node import Node, State, widen
from ..core.types import StreamSpec, np_float_dtype


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_states(states: Sequence[State]) -> State:
    """Stack S per-stream states into one batched state: each tensor leaf
    on a new dim 0. A non-tensor leaf (a host int) must be equal in every
    state and stays as it is. Pad buffers to a common length; lengths live
    in the states' ``end`` fields."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        if any(x != xs[0] for x in xs[1:]):
            raise ValueError(f"host values differ between the states: {xs}")
        return xs[0]

    return _tree_map(stack, *states)


def _in_dims(state):
    """vmap's in_dims for a state: 0 for each tensor leaf, None for others."""
    return _tree_map(lambda x: 0 if isinstance(x, torch.Tensor) else None, state)


class BatchedChain:
    """S lockstep copies of one chain: ``emit`` maps the template's emit
    over the stream axis (dim 0 of every tensor of the state) with
    ``torch.func.vmap``. A template whose emit cannot run under vmap (a
    host read, a data-dependent shape, a host value that changes) raises
    ``NotImplementedError`` naming the node: there is no per-stream loop to
    fall back on."""

    def __init__(self, template: Node, batched_state: State, n_streams: int):
        self.template = template
        self.state = batched_state
        self.n_streams = n_streams
        self.spec = template.spec
        self.device = getattr(template, "device", None)

    @classmethod
    def from_states(cls, template: Node, states: Sequence[State]):
        return cls(template, stack_states(states), len(states))

    def emit(self, state: State, n: int):
        """(state', blocks [S, C, n], valids [S])"""
        try:
            return torch.func.vmap(lambda s: self.template.emit(s, n),
                                   in_dims=(_in_dims(state),))(state)
        except (RuntimeError, ValueError, TypeError) as e:
            raise NotImplementedError(
                f"{type(self.template).__name__}.emit cannot run under "
                f"torch.func.vmap: {e}") from e


class BatchedMixer(Node):
    """Sum a BatchedChain over the stream axis -> one [C, T] stream (the
    reference mixer's hot loop as one reduction)."""

    def __init__(self, chain: BatchedChain):
        self.chain = chain
        self.spec = chain.spec
        self.device = chain.device

    def total_frames(self) -> Optional[int]:
        return None

    def init_state(self) -> State:
        return self.chain.state

    def emit(self, state: State, n: int):
        state, blocks, valids = self.chain.emit(state, n)
        valid = (valids.max() if valids.numel()
                 else torch.zeros((), dtype=torch.int64, device=blocks.device))
        return state, blocks.sum(0), valid


class WideMixer(Node):
    """Stream-axis mixer for the WIDE-CHANNEL batch layout: S streams of C
    channels folded into one chain of S*C channels; this node sums
    [S*C, T] over the streams into [C, T] (src/mixer.rs:185-198)."""

    def __init__(self, input_node: Node, n_streams: int):
        wide = input_node.spec.channels
        if wide % n_streams:
            raise ValueError("channel count not divisible by stream count")
        self.input = input_node
        self.device = input_node.device
        self.n_streams = n_streams
        self.spec = StreamSpec(wide // n_streams, input_node.spec.sample_rate)

    def total_frames(self):
        return self.input.total_frames()

    def init_state(self) -> State:
        return self.input.init_state()

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state, n)
        # the stream sum is f32 whatever the block's dtype: a bf16 block is
        # read at half width but never summed at bf16 precision
        mixed = widen(block, self.dtype).reshape(self.n_streams, self.spec.channels, n).sum(0)
        return s, mixed, valid


def batched_buffers(channels: int, sample_rate: int, buffers: Sequence[np.ndarray],
                    *, device=None):
    """(template SamplesBuffer, stacked state) from per-stream PCM arrays of
    varying length ([C, frames], or 1-D interleaved), zero-padded to the
    longest; each stream's length is its state's ``end``."""
    from ..sources.generators import SamplesBuffer

    frames = [(b.shape[1] if b.ndim == 2 else len(b) // channels) for b in buffers]
    max_frames = max(frames)
    states = []
    template = None
    for buf, nf in zip(buffers, frames):
        arr = np.zeros((channels, max_frames), dtype=np_float_dtype())
        if buf.ndim == 1:
            buf = buf[: nf * channels].reshape(nf, channels).T
        arr[:, :nf] = buf
        node = SamplesBuffer(channels, sample_rate, arr, device=device)
        st = node.init_state()
        st["end"] = torch.full((), nf, dtype=torch.int64, device=node.device)
        states.append(st)
        if template is None:
            template = node
    return template, stack_states(states)
