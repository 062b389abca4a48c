"""Block-dtype boundaries: the opt-in bf16 inter-stage contract
(rodio_tpu/conversions/blockdtype.py).

The engine's sample type is f32. A :class:`Bf16Boundary` re-materialises
the block at bfloat16 between stages, halving the bytes of the inter-stage
``[S*C, T]`` buffers. Compute inside every stage stays f32: K4 upcasts on
load, runs its recurrence in f32 and stores bf16 (``ops/cuda_scan.py``),
``Amplify`` multiplies in f32, and ``WideMixer`` sums its streams in f32.

Contract (a documented deviation, as in the JAX package): each boundary
rounds the signal to 8 significand bits, ~2^-9 relative; a downstream
resonant biquad can integrate that to ~1e-2 relative. Off by default.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.node import Node, State


class Bf16Boundary(Node):
    """Round the block to bfloat16 (to nearest even) at a stage boundary.
    The block stays bf16 until a consumer upcasts; states stay f32."""

    def __init__(self, input_node: Node):
        self.input = input_node
        self.spec = input_node.spec
        self.device = input_node.device

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        return self.input.init_state()

    def emit(self, state: State, n: int):
        s, x, valid = self.input.emit(state, n)
        return s, x.to(torch.bfloat16), valid
