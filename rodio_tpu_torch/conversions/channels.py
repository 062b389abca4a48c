"""Channel-count conversion (rodio_tpu/conversions/channels.py).

The reference's positional up/down mix (src/conversions/channels.rs:57-84):
mono -> N duplicates channel 0 into channel 1 and zero-fills channels >= 2;
N -> M keeps the first M channels.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.node import Node, State
from ..core.types import StreamSpec


def rechannel_block(block: torch.Tensor, from_channels: int,
                    to_channels: int) -> torch.Tensor:
    """[from, T] -> [to, T] with the reference's positional rules."""
    if from_channels == to_channels:
        return block
    rows = []
    for c in range(to_channels):
        if c < from_channels:
            rows.append(block[c])
        elif c == 1 and from_channels == 1:
            rows.append(block[0])
        else:
            rows.append(torch.zeros_like(block[0]))
    return torch.stack(rows, dim=0)


class RechannelNode(Node):
    def __init__(self, input_node: Node, to_channels: int):
        self.input = input_node
        self.device = input_node.device
        self.from_channels = input_node.spec.channels
        self.spec = StreamSpec(to_channels, input_node.spec.sample_rate)

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        return self.input.init_state()

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state, n)
        return s, rechannel_block(block, self.from_channels, self.spec.channels), valid
