"""Stream-batch mixing: the slice's part of rodio_tpu/parallel/batch.py."""
from __future__ import annotations

from ..core.node import Node, State
from ..core.types import StreamSpec


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
        mixed = block.float().reshape(self.n_streams, self.spec.channels, n).sum(0)
        return s, mixed, valid
