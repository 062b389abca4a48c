"""Sequential playback queue, the block-level control plane
(rodio_tpu/control/queue.py, src/queue.rs).

The reference plays queued sources back to back, emits keep-alive silence
when empty (src/queue.rs:221-240) and peeks the next source's format once
the current one is exhausted (src/queue.rs:166-192). Here the queue is
host-driven, as the control plane is host code in the reference: each
source runs its own block step (``graph.render.compile_step``), each
block's ``valid`` is read back, and at a transition the rest of the block
is stitched from the next source on the device, at sample resolution.
Blocks are tensors on the queue's device.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional

import torch

from ..core.node import Node
from ..core.types import DEFAULT_SAMPLE_RATE
from ..graph.render import compile_step
from ..utils.device import DeviceLike, resolve_device


class DoneSignal(list):
    """A one-element [bool] with an optional ``callback`` fired when it
    flips."""

    callback = None

    @property
    def done(self) -> bool:
        return self[0]


class SourcesQueueInput:
    """(src/queue.rs:52-111)"""

    def __init__(self, keep_alive_if_empty: bool):
        self.next_sounds: deque = deque()
        self.keep_alive_if_empty = keep_alive_if_empty

    def append(self, node: Node) -> None:
        self.next_sounds.append((node, None))

    def append_with_signal(self, node: Node, callback=None) -> DoneSignal:
        """The done signal flips to True when the sound finishes
        (src/queue.rs:79-89); ``callback`` fires then (src/source/done.rs)."""
        signal = DoneSignal([False])
        signal.callback = callback
        self.next_sounds.append((node, signal))
        return signal

    def clear(self) -> int:
        n = len(self.next_sounds)
        self.next_sounds.clear()
        return n


class SourcesQueueOutput:
    """(src/queue.rs:114-268): the host-driven block producer."""

    def __init__(self, input_queue: SourcesQueueInput, *, block_frames: int = 4096,
                 device: DeviceLike = None):
        self.input = input_queue
        self.block_frames = block_frames
        self.device = resolve_device(device)
        self.current: Optional[dict] = None
        #: called when a queued sound becomes current: the Player lands knobs
        #: changed between append and start before the sound's first sample
        #: (src/player.rs:138-165)
        self.on_start: Optional[Callable[[dict], None]] = None
        self.signal_after_end: Optional[List[bool]] = None
        #: [period_frames, countdown, fn] host hooks (src/source/periodic.rs)
        self._periodic: List[list] = []

    def periodic_access(self, period_seconds: float, fn: Callable[[], None],
                        sample_rate: int = 48000) -> None:
        period = max(1, int(period_seconds * sample_rate))
        self._periodic.append([period, 1, fn])

    def _tick_periodic(self, frames: int) -> None:
        for hook in self._periodic:
            hook[1] -= frames
            while hook[1] <= 0:
                hook[2]()
                hook[1] += hook[0]

    # the format peek (src/queue.rs:166-192)
    def channels(self) -> int:
        if self.current is not None:
            return self.current["node"].spec.channels
        if self.input.next_sounds:
            return self.input.next_sounds[0][0].spec.channels
        return 1

    def sample_rate(self) -> int:
        if self.current is not None:
            return self.current["node"].spec.sample_rate
        if self.input.next_sounds:
            return self.input.next_sounds[0][0].spec.sample_rate
        return DEFAULT_SAMPLE_RATE

    def _go_next(self, target_rate: Optional[int] = None) -> bool:
        if self.signal_after_end is not None:
            self.signal_after_end[0] = True
            cb = getattr(self.signal_after_end, "callback", None)
            if cb is not None:
                cb()
            self.signal_after_end = None
        if not self.input.next_sounds:
            self.current = None
            return False
        node, signal = self.input.next_sounds.popleft()
        if target_rate is not None and node.spec.sample_rate != target_rate:
            # a block cannot change rate mid-block, so a source stitched into
            # a block started at another rate is resampled to it here (the
            # reference re-bootstraps a downstream Uniform at the span
            # boundary, src/queue.rs:166-192)
            from ..conversions.uniform import Uniform

            node = Uniform(node, node.spec.channels, target_rate)
        self.current = {"node": node, "state": node.init_state(),
                        "step": compile_step(node, self.block_frames),
                        "leftover": None,  # [C, k] produced but not consumed
                        "ended": False}
        self.signal_after_end = signal
        if self.on_start is not None:
            self.on_start(self.current)
        return True

    def _pull_current(self) -> Optional[torch.Tensor]:
        """The current source's next chunk, or None once it is exhausted."""
        cur = self.current
        if cur["leftover"] is not None:
            chunk, cur["leftover"] = cur["leftover"], None
            return chunk
        if cur["ended"]:
            return None
        cur["state"], block, valid = cur["step"](cur["state"])
        v = int(valid)
        if v < self.block_frames:
            cur["ended"] = True
        if v == 0:
            return None
        return block[:, :v]

    def next_block(self, n: Optional[int] = None):
        """Pull one [channels, n] block: (block, alive). ``alive`` is False
        once the queue has ended (only without keep-alive). A source that
        ends mid-block is followed by the next queued source in the same
        block."""
        n = n or self.block_frames
        out, alive = self._next_block_inner(n)
        self._tick_periodic(n)
        return out, alive

    def _next_block_inner(self, n: int):
        from ..conversions.channels import rechannel_block

        channels, rate = self.channels(), self.sample_rate()
        out = torch.zeros((channels, n), dtype=torch.float32, device=self.device)
        filled = 0
        while filled < n:
            if self.current is None and not self._go_next(
                    target_rate=rate if filled > 0 else None):
                if self.input.keep_alive_if_empty:
                    return out, True  # the rest of the block stays silent
                return out, filled > 0
            chunk = self._pull_current()
            if chunk is None:
                self.current = None  # exhausted: the next source
                continue
            take = min(chunk.shape[1], n - filled)
            blk = rechannel_block(chunk[:, :take], chunk.shape[0], channels)
            out[:, filled: filled + take] = blk
            filled += take
            if take < chunk.shape[1]:
                self.current["leftover"] = chunk[:, take:]
        return out, True


def queue(keep_alive_if_empty: bool, *, block_frames: int = 4096,
          device: DeviceLike = None):
    """(input, output) pair (src/queue.rs:30)."""
    q = SourcesQueueInput(keep_alive_if_empty)
    return q, SourcesQueueOutput(q, block_frames=block_frames, device=device)
