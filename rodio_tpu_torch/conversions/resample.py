"""Rational linear-interpolation resampler (rodio_tpu/conversions/resample.py).

For the reduced ratio from/to, output frame o (chunk c = o // to, phase
j = o % to) interpolates input frames

    left  = c*from + (from*j) // to,   right = left + 1
    frac  = ((from*j) % to) / to        (src/conversions/sample_rate.rs:158,173)

as ``(1 - frac)*x[left] + frac*x[right]``: the two nonzero taps of column j
of the JAX package's lerp operator ``G0``/``g1``, with the same f32 weights.
End of stream follows the reference's drain rule: after the last full lerp,
if the next output lands exactly on the final input frame, that frame is
emitted once, unmodified.

Only the random-access path (``_emit_random_access`` of the JAX package) is
ported: the upstream must be gatherable (a SamplesBuffer). Everything stays
on the device; the output offset is a host int that advances by ``n``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State, clip_valid, mask_block
from ..core.types import StreamSpec


def lerp_left(o, from_: int, to: int):
    """Left input frame of output frame(s) ``o`` (a host int or a tensor)."""
    return (o // to) * from_ + (from_ * (o % to)) // to


def _resample_counts(n_in: int, from_: int, to: int):
    """(n_full_lerps, has_drain) the reference emits for n_in input frames."""
    if n_in == 0:
        return 0, False
    lo, hi = 0, (n_in * to) // from_ + to + 2
    while lo < hi:
        mid = (lo + hi) // 2
        if lerp_left(mid, from_, to) <= n_in - 2:
            lo = mid + 1
        else:
            hi = mid
    return lo, lerp_left(lo, from_, to) == n_in - 1


def resample_output_frames(n_in: int, from_: int, to: int) -> int:
    """Output frames the reference emits for n_in input frames (full lerps
    plus the drain frame)."""
    if from_ == to:
        return n_in
    n_full, drain = _resample_counts(n_in, from_, to)
    return n_full + (1 if drain else 0)


def lerp_weights(from_: int, to: int):
    """Per phase j: (weight of x[left], weight of x[left+1]), the nonzero
    entries of column j of the JAX operator ``G0``/``g1``
    (resample.py:_build_lerp_matrix), in f32."""
    j = np.arange(to, dtype=np.int64)
    frac = ((from_ * j) % to).astype(np.float32) / np.float32(to)
    return np.float32(1.0) - frac, frac


def output_positions(o0: int, n: int, from_: int, to: int, device):
    """(left input frame, phase j) of output frames o0 .. o0+n-1."""
    o = torch.arange(o0, o0 + n, device=device, dtype=torch.int64)
    return lerp_left(o, from_, to), o % to


def drain_bookkeeping(left: torch.Tensor, in_end: torch.Tensor,
                      drained: torch.Tensor, n: int):
    """Validity of a block of outputs whose left taps are ``left``
    (resample.py:326-345): returns (n_full, drain_ok, valid, drained')."""
    full = left <= in_end - 2
    n_full = full.sum()
    # index_select, not left[n_full]: a 0-dim tensor index reads it back
    cand_left = left.index_select(0, torch.clamp(n_full, max=n - 1).view(1))[0]
    drain_ok = (n_full < n) & (cand_left == in_end - 1)
    valid = torch.where(drained, torch.zeros_like(n_full),
                        n_full + drain_ok.to(n_full.dtype))
    drained_new = drained | drain_ok | (valid < n)
    return n_full, drain_ok, clip_valid(valid, n), drained_new


class Resample(Node):
    def __init__(self, input_node: Node, to_rate: int):
        self.input = input_node
        self.device = input_node.device
        from_rate = input_node.spec.sample_rate
        self.spec = StreamSpec(input_node.spec.channels, to_rate)
        g = math.gcd(from_rate, to_rate)
        self.from_ = from_rate // g
        self.to = to_rate // g
        self.identity = self.from_ == self.to
        if not self.identity and not getattr(input_node, "RANDOM_ACCESS", False):
            raise NotImplementedError(
                "the streaming (ring) resampler is not ported; the upstream "
                "must be random-access (SamplesBuffer)"
            )
        if not self.identity:
            w0, w1 = lerp_weights(self.from_, self.to)
            self._w0 = torch.from_numpy(w0).to(self.device)
            self._w1 = torch.from_numpy(w1).to(self.device)

    def total_frames(self) -> Optional[int]:
        n_in = self.input.total_frames()
        if n_in is None:
            return None
        return resample_output_frames(n_in, self.from_, self.to)

    def init_state(self) -> State:
        if self.identity:
            return {"in": self.input.init_state()}
        return {
            "in": self.input.init_state(),
            "out_o": 0,
            "drained": torch.tensor(False, device=self.device),
        }

    def emit(self, state: State, n: int):
        if self.identity:
            s, block, valid = self.input.emit(state["in"], n)
            return {"in": s}, block, valid
        o0 = state["out_o"]
        left, j = output_positions(o0, n, self.from_, self.to, self.device)
        start, in_end = self.input.access_window(state["in"])
        lval = self.input.gather_frames(state["in"], start + left)
        rval = self.input.gather_frames(state["in"], start + left + 1)
        out = lval * self._w0[j][None, :] + rval * self._w1[j][None, :]

        n_full, drain_ok, valid, drained = drain_bookkeeping(
            left, in_end, state["drained"], n)
        i_idx = torch.arange(n, device=self.device)
        # the drain output is the final input frame, unmodified
        out = torch.where(((i_idx == n_full) & drain_ok)[None, :], lval, out)
        return (
            {"in": state["in"], "out_o": o0 + n, "drained": drained},
            mask_block(out, valid),
            valid,
        )
