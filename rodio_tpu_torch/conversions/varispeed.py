"""Live variable-rate playback (rodio_tpu/conversions/varispeed.py).

The reference's ``Speed`` factor is a free runtime value
(src/source/speed.rs:56-65). Here the ratio is a state field: ``set_ratio``
is a state update that applies from the next block.

Each output frame i reads the input at ``p_i = frac + ratio * i`` by the
reference's two-point lerp (src/conversions/sample_rate.rs:158-173), over a
ring of pulled input frames. The integer part of the position is carried
in the ring's offset, so the per-block phase error stays at an ulp of 1.0.
As in the JAX package, ``emit`` reads nothing back:

- the input is pulled by a conditional fixed-size pull, committed with
  :func:`~rodio_tpu_torch.core.node.tree_select` only when the ring runs
  low and the input has not ended;
- the pull's scatter drops positions past the ring into a spare column;
- the lerp's two reads return 0 past the ring (a clamp and a ``where``);
- the consumed frames leave the ring by a gather at a device shift.

At ratio 1.0 the lerp fraction is identically zero and the node is
bit-transparent.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State, clip_valid, tree_select
from ..core.types import StreamSpec

_BIG = 2 ** 31 - 1


class VariSpeed(Node):
    """Playback-rate changer with a live ratio in the state: ``ratio`` > 1
    speeds playback up (and raises pitch), < 1 slows it. The output rate is
    the input's. ``max_ratio`` bounds a block's input demand (the pull
    size); ``set_ratio`` clips into [1e-3, max_ratio]."""

    def __init__(self, input_node: Node, ratio: float = 1.0,
                 *, max_ratio: float = 4.0, max_block: int = 8192):
        self.input = input_node
        self.device = input_node.device
        self.spec = StreamSpec(input_node.spec.channels, input_node.spec.sample_rate)
        self.ratio0 = float(ratio)
        self.max_ratio = float(max_ratio)
        assert 0.0 < ratio <= max_ratio
        self.max_block = int(max_block)
        #: the pull size that covers one block's worst-case demand
        self.P = int(math.ceil(max_block * max_ratio)) + 4
        self.R = 2 * self.P

    def total_frames(self) -> Optional[int]:
        return None  # the duration depends on the ratio's history

    def _i64(self, v) -> torch.Tensor:
        return torch.full((), v, dtype=torch.int64, device=self.device)

    def init_state(self) -> State:
        return {
            "in": self.input.init_state(),
            "ring": torch.zeros((self.spec.channels, self.R), dtype=torch.float32,
                                device=self.device),
            "fill": self._i64(0),
            "frac": torch.zeros((), dtype=torch.float32, device=self.device),
            "ratio": torch.full((), float(np.float32(self.ratio0)), dtype=torch.float32,
                                device=self.device),
            "in_pulled": self._i64(0),
            "in_end": self._i64(_BIG),
            "drained": torch.zeros((), dtype=torch.bool, device=self.device),
        }

    def set_ratio(self, state: State, ratio) -> State:
        """Live varispeed (speed.rs:56-65 ``set_factor``): a state update
        that applies from the next block."""
        if isinstance(ratio, torch.Tensor):
            r = ratio.to(device=self.device, dtype=torch.float32)
        else:  # a fill on the device, not a copy from the host
            r = torch.full((), float(np.float32(ratio)), dtype=torch.float32, device=self.device)
        r = torch.clamp(r, float(np.float32(1e-3)), float(np.float32(self.max_ratio)))
        return {**state, "ratio": r}

    def emit(self, state: State, n: int):
        assert n <= self.max_block, f"VariSpeed block {n} exceeds max_block={self.max_block}"
        dev, R = self.device, self.R
        ratio, frac = state["ratio"], state["frac"]
        # the pull scales with this block: a small block must not pay the
        # max_block worst case in upstream work every emit
        P = min(self.P, int(math.ceil(n * self.max_ratio)) + 4)

        i_idx = torch.arange(n, device=dev)
        p = frac + ratio * i_idx.to(torch.float32)  # block-local positions
        left = torch.floor(p).to(torch.int64)
        not_ended = state["in_end"] == _BIG
        do_pull = (left[n - 1] + 2 > state["fill"]) & not_ended
        in2, xblk, v_in = self.input.emit(state["in"], P)
        in_new = tree_select(do_pull, in2, state["in"])
        fill = state["fill"]
        pos = fill + torch.arange(P, device=dev)
        pos = torch.where(do_pull & (pos < R), pos, torch.full_like(pos, R))
        spare = torch.zeros((self.spec.channels, 1), dtype=torch.float32, device=dev)
        ring = torch.cat([state["ring"], spare], dim=1).index_copy(
            1, pos, xblk.to(torch.float32))[:, :R]
        in_pulled = torch.where(do_pull, state["in_pulled"] + P, state["in_pulled"])
        ended_now = do_pull & (v_in < P)
        in_end = torch.where(ended_now & not_ended, state["in_pulled"] + v_in,
                             state["in_end"])
        fill = torch.where(do_pull, fill + P, fill)

        # the two-point lerp (frac == 0 is bit-transparent: x + (r - x) * 0 == x)
        def take(idx):
            inside = idx < R
            v = ring[:, torch.clamp(idx, max=R - 1)]
            return torch.where(inside[None, :], v, torch.zeros_like(v))

        lval, rval = take(left), take(left + 1)
        f = (p - left.to(torch.float32))[None, :]
        out = lval + (rval - lval) * f

        # a full lerp needs the right-hand frame (the global input index of
        # `left` is in_pulled - fill + left)
        full = (in_pulled - fill + left) <= in_end - 2
        valid = torch.where(state["drained"], torch.zeros_like(in_end),
                            full.to(torch.int64).sum())
        out = torch.where(i_idx[None, :] < valid, out, torch.zeros_like(out))
        drained = state["drained"] | (valid < n)

        # shift the consumed whole frames out of the ring
        total = frac + ratio * torch.full((), float(n), dtype=torch.float32, device=dev)
        shift = torch.minimum(torch.floor(total).to(torch.int64), fill)
        frac_new = total - shift.to(torch.float32)
        ext = torch.cat([ring, torch.zeros((self.spec.channels, P), dtype=torch.float32,
                                           device=dev)], dim=1)
        ring_new = ext[:, torch.clamp(shift, 0, P) + torch.arange(R, device=dev)]
        return ({"in": in_new, "ring": ring_new, "fill": fill - shift, "frac": frac_new,
                 "ratio": ratio, "in_pulled": in_pulled, "in_end": in_end,
                 "drained": drained},
                out, clip_valid(valid, n))
