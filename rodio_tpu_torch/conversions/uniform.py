"""Uniform format stage (rodio_tpu/conversions/uniform.py).

Converts any source to a fixed (channels, sample_rate) forever, as
src/source/uniform.rs:33-145 does: resample at the input's channel count,
then convert the channels.

``rodio_compat=True`` reproduces the reference's span re-bootstrap for
finite sources: spans are capped at 32768 interleaved samples
(src/source/uniform.rs:56), so the resampler's phase resets every
``32768 // channels`` frames (``Resample``'s span path). The default
resamples continuously.
"""
from __future__ import annotations

from typing import Optional

from ..core.node import Node, State
from ..core.types import MAX_SPAN_LEN, StreamSpec
from .channels import RechannelNode
from .resample import Resample


class Uniform(Node):
    def __init__(self, input_node: Node, channels: int, sample_rate: int,
                 *, rodio_compat: bool = False, max_block: int = 8192):
        self.input = input_node
        self.device = input_node.device
        self.spec = StreamSpec(channels, sample_rate)
        segment = None
        if rodio_compat and input_node.total_frames() is not None:
            segment = MAX_SPAN_LEN // input_node.spec.channels
        node = input_node
        if input_node.spec.sample_rate != sample_rate or segment is not None:
            node = Resample(node, sample_rate, segment_frames=segment,
                            max_block=max_block)
        if node.spec.channels != channels:
            node = RechannelNode(node, channels)
        self._pipeline = node

    def total_frames(self) -> Optional[int]:
        return self._pipeline.total_frames()

    def init_state(self) -> State:
        return self._pipeline.init_state()

    def emit(self, state: State, n: int):
        return self._pipeline.emit(state, n)
