"""Pairwise mix (rodio_tpu/effects/mix.py).

The reference's Mix (src/source/mix.rs:10-56): both inputs are uniformized
to input1's format, and the mix goes on while either side yields. Frames
past ``valid`` are zero, so the sum needs no mask.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..conversions.uniform import Uniform
from ..core.node import Node, State


class Mix(Node):
    def __init__(self, input1: Node, input2: Node, *, rodio_compat: bool = False):
        spec = input1.spec
        self.input1 = Uniform(input1, spec.channels, spec.sample_rate,
                              rodio_compat=rodio_compat)
        self.input2 = Uniform(input2, spec.channels, spec.sample_rate,
                              rodio_compat=rodio_compat)
        self.spec = spec
        self.device = input1.device

    def total_frames(self) -> Optional[int]:
        f1, f2 = self.input1.total_frames(), self.input2.total_frames()
        if f1 is None or f2 is None:
            return None
        return max(f1, f2)

    def init_state(self) -> State:
        return {"a": self.input1.init_state(), "b": self.input2.init_state()}

    def emit(self, state: State, n: int):
        sa, xa, va = self.input1.emit(state["a"], n)
        sb, xb, vb = self.input2.emit(state["b"], n)
        return {"a": sa, "b": sb}, xa + xb, torch.maximum(va, vb)
