"""Stateless effects: the slice's part of rodio_tpu/effects/basic.py."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State


class Amplify(Node):
    """sample * factor (src/source/amplify.rs:10-22). The factor lives in
    the state; it may be a scalar or a per-channel vector (the wide-channel
    batch layout carries per-stream volumes as per-channel gains)."""

    def __init__(self, input_node: Node, factor):
        self.input = input_node
        self.spec = input_node.spec
        self.device = input_node.device
        self.factor = np.asarray(factor, dtype=np.float32)

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        f = torch.from_numpy(self.factor.copy()).to(self.device)
        if f.dim() == 1:
            f = f[:, None]  # broadcast over time
        return {"in": self.input.init_state(), "factor": f}

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state["in"], n)
        return {"in": s, "factor": state["factor"]}, block * state["factor"], valid
