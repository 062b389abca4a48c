"""Sequential concatenation: from_iter and from_factory
(rodio_tpu/sources/concat.py, src/source/from_iter.rs, from_factory.rs).

Play a (lazy) sequence of sources back to back, each built on demand, on
the queue's machinery, which stitches the transitions at sample resolution.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from ..control.queue import SourcesQueueInput, SourcesQueueOutput
from ..core.node import Node, State, full_valid
from ..core.types import StreamSpec
from ..utils.device import DeviceLike, resolve_device


def from_iter(sources: Iterable[Node], *, keep_alive: bool = False,
              block_frames: int = 4096, device: DeviceLike = None) -> SourcesQueueOutput:
    """Lazy host-driven concatenation (src/source/from_iter.rs:8-19): a
    queue output that plays the sources in order."""
    q = SourcesQueueInput(keep_alive)
    for s in sources:
        q.append(s)
    return SourcesQueueOutput(q, block_frames=block_frames, device=device)


def from_factory(factory: Callable[[], Optional[Node]], *, block_frames: int = 4096,
                 device: DeviceLike = None) -> "FactoryQueueOutput":
    """Lazy factory-driven concatenation (src/source/from_factory.rs:4): the
    factory is called whenever the previous source drains; None ends the
    stream."""
    return FactoryQueueOutput(factory, block_frames=block_frames, device=device)


class FactoryQueueOutput(SourcesQueueOutput):
    def __init__(self, factory, *, block_frames: int = 4096, device: DeviceLike = None):
        super().__init__(SourcesQueueInput(False), block_frames=block_frames,
                         device=device)
        self._factory = factory
        self._factory_done = False

    def _go_next(self, target_rate: Optional[int] = None) -> bool:
        if not self.input.next_sounds and not self._factory_done:
            nxt = self._factory()
            if nxt is None:
                self._factory_done = True
            else:
                self.input.append(nxt)
        return super()._go_next(target_rate=target_rate)


class EmptyCallback(Node):
    """A zero-length source that calls ``callback`` when pulled by the host
    (src/source/empty_callback.rs:9): a queue sentinel that fires when
    playback reaches it."""

    def __init__(self, callback: Callable[[], None], channels: int = 1,
                 sample_rate: int = 48000, *, device: DeviceLike = None):
        self.callback = callback
        self.spec = StreamSpec(channels, sample_rate)
        self.device = resolve_device(device)

    def total_frames(self) -> Optional[int]:
        return 0

    def init_state(self) -> State:
        return {}

    def emit(self, state: State, n: int):
        return state, torch.zeros((self.spec.channels, n), dtype=self.dtype,
                                  device=self.device), full_valid(0, self.device)

    def next_block(self, n: int):
        self.callback()
        return torch.zeros((self.spec.channels, n), dtype=self.dtype,
                           device=self.device), False
