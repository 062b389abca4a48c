"""Dynamic N-way mixer, the block-level control plane
(rodio_tpu/control/mixer.py, src/mixer.rs).

- Every added source is wrapped in a Uniform stage (src/mixer.rs:62-66).
- ``MixerSource.next_block`` is the host-driven pull: it emits every
  member's block and sums them on the device in their order of admission
  (src/mixer.rs:185-198), so the total rounds as the JAX package's does;
  then it reads the members' ``valid``s back, once a block, to prune the
  exhausted ones (src/mixer.rs:187) and to end the mixer at the first pull
  where none yields (src/mixer.rs:131-135).
- Admission is block-aligned: a source added between pulls joins at the
  next block.
- A host-driven member (a Player's queue, anything with ``next_block``)
  must match the mixer's format and is summed after the others. Its block
  may be a numpy array (a microphone's, a streaming feed's): it is moved
  to the mixer's device here, in one place (``hosted_block``).

With a fixed membership the mixer is itself a node (``init_state`` /
``emit``), and reads nothing back there.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..conversions.uniform import Uniform
from ..core.node import Node, State
from ..core.types import StreamSpec
from ..utils.device import DeviceLike, hosted_block, resolve_device


class Mixer:
    """Input handle (src/mixer.rs:25-67)."""

    def __init__(self, channels: int, sample_rate: int, *, rodio_compat: bool = False,
                 device: DeviceLike = None):
        self.spec = StreamSpec(channels, sample_rate)
        self.device = resolve_device(device)
        self._rodio_compat = rodio_compat
        self._pending: List[Tuple[object, Optional[State]]] = []
        self._source: Optional["MixerSource"] = None

    def add(self, node) -> None:
        if hasattr(node, "next_block"):
            # host-driven (e.g. a Player's queue): summed on the host side of
            # the block loop, so it must already have the mixer's format
            if node.spec != self.spec:
                raise ValueError("host-driven sources must match the mixer format")
            self._pending.append((node, None))
            return
        if node.device != self.device:
            raise ValueError(f"source on {node.device}, mixer on {self.device}")
        uni = Uniform(node, self.spec.channels, self.spec.sample_rate,
                      rodio_compat=self._rodio_compat)
        self._pending.append((uni, uni.init_state()))


class MixerSource(Node):
    """Output node (src/mixer.rs:70-198). Drive it with ``next_block``."""

    def __init__(self, mixer: Mixer):
        self.mixer = mixer
        self.spec = mixer.spec
        self.device = mixer.device
        mixer._source = self
        self._current: List[Tuple[object, Optional[State]]] = []

    def total_frames(self) -> Optional[int]:
        return None

    def _admit(self):
        if self.mixer._pending:
            self._current.extend(self.mixer._pending)
            self.mixer._pending.clear()

    def next_block(self, n: int):
        """One [channels, n] block on the mixer's device: (block, alive).
        ``alive`` is False when the mixer has ended (no source yielded)."""
        self._admit()
        total = torch.zeros((self.spec.channels, n), dtype=self.dtype,
                            device=self.device)
        if not self._current:
            return total, False
        traced = [(node, st) for node, st in self._current if not hasattr(node, "next_block")]
        hosted = [node for node, _ in self._current if hasattr(node, "next_block")]
        survivors: List[Tuple[object, Optional[State]]] = []
        any_yield = False
        if traced:
            new_states, valids = [], []
            for node, st in traced:
                st2, block, v = node.emit(st, n)
                total = total + block
                new_states.append(st2)
                valids.append(v)
            valids = torch.stack(valids).tolist()  # the one read-back a block
            survivors.extend((node, st) for (node, _), st, v in zip(traced, new_states, valids)
                             if v > 0)
            any_yield = any(v > 0 for v in valids)
        for node in hosted:
            block, alive = node.next_block(n)
            total = total + hosted_block(block, self.device, self.dtype)
            if alive:
                survivors.append((node, None))
                any_yield = True
        self._current = survivors
        return total, any_yield

    # the node protocol, for a fixed membership
    def init_state(self) -> State:
        self._admit()
        return [st for _, st in self._current]

    def emit(self, state: State, n: int):
        total = torch.zeros((self.spec.channels, n), dtype=self.dtype, device=self.device)
        new_states = []
        max_valid = torch.zeros((), dtype=torch.int64, device=self.device)
        for (node, _), st in zip(self._current, state):
            st2, block, v = node.emit(st, n)
            total = total + block
            new_states.append(st2)
            max_valid = torch.maximum(max_valid, v)
        return new_states, total, max_valid


def mixer(channels: int, sample_rate: int, *, rodio_compat: bool = False,
          device: DeviceLike = None):
    """(Mixer, MixerSource) pair (src/mixer.rs:25)."""
    m = Mixer(channels, sample_rate, rodio_compat=rodio_compat, device=device)
    return m, MixerSource(m)
