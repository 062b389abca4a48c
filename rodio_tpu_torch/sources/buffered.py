"""Lazy shared-cache buffering: the Buffered combinator
(rodio_tpu/sources/buffered.py, src/source/buffered.rs).

The reference lazily materialises spans into a shared linked list; clones
replay from the cache while the original keeps extending it. Here the cache
is a shared list of rendered blocks on the node's device, each clone holds
its own read position, and blocks render through the node's step on demand
(reading each block's ``valid`` back: this is host-driven control).

A drained Buffered converts to a SamplesBuffer on the node's device
(``to_buffer()``), a random-access node again.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.node import Node


class _SharedCache:
    def __init__(self, node: Node, block_frames: int):
        from ..graph.render import compile_step

        self.node = node
        self.block_frames = block_frames
        self.step = compile_step(node, block_frames)
        self.state = node.init_state()
        self.chunks: List[torch.Tensor] = []
        self.frames = 0
        self.exhausted = False

    def ensure(self, frames: int) -> None:
        """Extend the cache to cover at least ``frames`` frames."""
        while self.frames < frames and not self.exhausted:
            self.state, block, valid = self.step(self.state)
            v = int(valid)
            if v > 0:
                self.chunks.append(block[:, :v])
                self.frames += v
            if v < self.block_frames:
                self.exhausted = True

    def read(self, start: int, n: int) -> torch.Tensor:
        """The [C, n] window at ``start`` (zero past the end)."""
        self.ensure(start + n)
        out = torch.zeros((self.node.spec.channels, n), dtype=torch.float32,
                          device=self.node.device)
        pos = 0
        for chunk in self.chunks:
            w = chunk.shape[1]
            lo, hi = max(start, pos), min(start + n, pos + w)
            if hi > lo:
                out[:, lo - start: hi - start] = chunk[:, lo - pos: hi - pos]
            pos += w
            if pos >= start + n:
                break
        return out


class Buffered:
    """Host-driven buffered source; ``clone()`` shares the cache
    (src/source/buffered.rs:11-125). Drives mixers and queues through
    ``next_block``."""

    def __init__(self, node: Node, *, block_frames: int = 4096,
                 _cache: Optional[_SharedCache] = None):
        self._cache = _cache or _SharedCache(node, block_frames)
        self.spec = self._cache.node.spec
        self.device = self._cache.node.device
        self._pos = 0

    def clone(self) -> "Buffered":
        return Buffered(self._cache.node, _cache=self._cache)

    def total_frames(self) -> Optional[int]:
        return self._cache.node.total_frames()

    def next_block(self, n: int):
        """(block [C, n] on the node's device, alive): alive is False once
        drained."""
        cache = self._cache
        cache.ensure(self._pos + n)
        if self._pos >= cache.frames and cache.exhausted:
            return torch.zeros((self.spec.channels, n), dtype=torch.float32,
                               device=self.device), False
        block = cache.read(self._pos, n)
        self._pos += n
        return block, True

    def to_buffer(self):
        """Materialise fully: a SamplesBuffer on the node's device."""
        from .generators import SamplesBuffer

        self._cache.ensure(2 ** 62)
        chunks = self._cache.chunks
        data = torch.cat(chunks, dim=1) if chunks else torch.zeros(
            (self.spec.channels, 0), dtype=torch.float32, device=self.device)
        return SamplesBuffer(self.spec.channels, self.spec.sample_rate, data,
                             device=self.device)
