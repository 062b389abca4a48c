"""Rational linear-interpolation resampler (rodio_tpu/conversions/resample.py).

For the reduced ratio from/to, output frame o (chunk c = o // to, phase
j = o % to) interpolates input frames

    left  = c*from + (from*j) // to,   right = left + 1
    frac  = ((from*j) % to) / to        (src/conversions/sample_rate.rs:158,173)

End of stream follows the reference's drain rule: after the last full lerp,
if the next output lands exactly on the final input frame, that frame is
emitted once, unmodified.

Three emit paths, chosen as the JAX package chooses them:

- the weight form, ``(1 - frac)*x[left] + frac*x[right]`` with the f32
  weights of the JAX package's lerp operator ``G0``/``g1``: the JAX
  package's matmul path, taken when the upstream is random-access with
  ``slice_frames``, there are no spans, and a block's window
  ``(n // to + 2) * from + 1`` fits in the upstream's zero padding. Over a
  ``SamplesBuffer`` it is one pass over the buffer's PCM
  (``ops.resample.resample_lerp``: a kernel on the card); over any other
  such upstream (a ``PushPort``, whose gathers wrap its ring) it is the
  same function in PyTorch ops through the upstream's ``gather_frames``;
- the lerp form, ``x[left] + (x[right] - x[left]) * frac``, over a
  random-access upstream otherwise (``_emit_random_access``), spans
  included: ``segment_frames`` re-bootstraps the phase every segment, each
  with its own drain frame, as UniformSourceIterator's spans do;
- the streaming ring, for any other upstream: the lerp form over a ring of
  ``R = 2P`` frames, fed by a pull of ``P = ceil(n*from/to) + 3`` frames
  that is committed only when the ring runs low (``tree_select``), with
  the ``in_end``/``drained`` bookkeeping of the JAX package.

The two forms round differently, so the dispatch is part of the contract.
Everything stays on the device: the output offset ``out_o`` is a 0-dim
int64 tensor, and no emit reads a device value back to the host.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State, tree_select
from ..core.types import StreamSpec, np_float_dtype
from ..ops.resample import drain_and_mask, lerp_block_plain, resample_lerp
from ..utils.trace import spanned

#: the ring path's "not ended yet" input end (the JAX package's int32 max)
BIG = 2**31 - 1


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


def lerp_weights(from_: int, to: int, dtype=np.float32):
    """Per phase j: (weight of x[left], weight of x[left+1]), the nonzero
    entries of column j of the JAX operator ``G0``/``g1``
    (resample.py:_build_lerp_matrix), in ``dtype`` (f32, or f64 under
    ``set_float64``)."""
    j = np.arange(to, dtype=np.int64)
    frac = ((from_ * j) % to).astype(dtype) / dtype(to)
    return dtype(1.0) - frac, frac


def output_positions(o0, n: int, from_: int, to: int, device):
    """(left input frame, phase j) of output frames o0 .. o0+n-1; ``o0`` a
    host int or a 0-dim int64 tensor on ``device``."""
    o = o0 + torch.arange(n, device=device, dtype=torch.int64)
    return lerp_left(o, from_, to), o % to


def host_drain_bookkeeping(o0: int, n: int, n_in: int, drained: bool,
                           from_: int, to: int):
    """``ops.resample.drain_bookkeeping`` in host ints, for the outputs
    o0 .. o0+n-1 of one continuous stream of ``n_in`` input frames (left taps
    ``lerp_left(o0 + arange(n))``, ``in_end`` = ``n_in``): returns (valid,
    drained'). The left taps never decrease, so the block's full lerps are
    those of the stream's that fall in it."""
    n_full = min(max(_resample_counts(n_in, from_, to)[0] - o0, 0), n)
    drain_ok = n_full < n and lerp_left(o0 + n_full, from_, to) == n_in - 1
    valid = 0 if drained else n_full + drain_ok
    return valid, drained or drain_ok or valid < n


class Resample(Node):
    """Resample to ``to_rate``. ``segment_frames``: the span length in
    input frames after which the phase re-bootstraps (None: one continuous
    stream). ``max_block``: the largest block the ring path takes."""

    def __init__(self, input_node: Node, to_rate: int, *,
                 segment_frames: Optional[int] = None, max_block: int = 8192):
        self.input = input_node
        self.device = input_node.device
        from_rate = input_node.spec.sample_rate
        self.spec = StreamSpec(input_node.spec.channels, to_rate)
        g = math.gcd(from_rate, to_rate)
        self.from_ = from_rate // g
        self.to = to_rate // g
        self.identity = self.from_ == self.to
        self.max_block = max_block
        self.segment_frames = None if self.identity else segment_frames
        if self.segment_frames is not None:
            n_full, drain = _resample_counts(self.segment_frames, self.from_, self.to)
            self._seg_out = n_full + (1 if drain else 0)
            self._seg_drain = drain
        self.random_access = bool(getattr(input_node, "RANDOM_ACCESS", False))
        # the ring path's ring: twice the largest pull (static)
        self.R = 2 * (-(-max_block * self.from_ // self.to) + 3)
        if not self.identity:
            dt = np_float_dtype(self.dtype)
            w0, w1 = lerp_weights(self.from_, self.to, dt)
            self._w0 = torch.from_numpy(w0).to(self.device)
            self._w1 = torch.from_numpy(w1).to(self.device)
            # the lerp form's f32(num) / f32(to) for every numerator, made
            # on the host: a CUDA division by a host scalar multiplies by
            # its reciprocal, which rounds differently
            frac = np.arange(self.to, dtype=dt) / dt(self.to)
            self._frac = torch.from_numpy(frac).to(self.device)

    def total_frames(self) -> Optional[int]:
        n_in = self.input.total_frames()
        if n_in is None:
            return None
        if self.identity:
            return n_in
        L = self.segment_frames
        if L is None:
            return resample_output_frames(n_in, self.from_, self.to)
        full, rem = divmod(n_in, L)
        return full * self._seg_out + resample_output_frames(rem, self.from_, self.to)

    def _zero(self, dtype=torch.int64) -> torch.Tensor:
        return torch.zeros((), dtype=dtype, device=self.device)

    def init_state(self) -> State:
        if self.identity:
            return {"in": self.input.init_state()}
        drained = self._zero(torch.bool)
        if self.random_access:
            return {"in": self.input.init_state(), "out_o": self._zero(),
                    "drained": drained}
        return {
            "in": self.input.init_state(),
            "ring": torch.zeros((self.spec.channels, self.R), dtype=self.dtype,
                                device=self.device),
            "base_g": self._zero(),
            "fill": self._zero(),
            "out_o": self._zero(),
            "in_pulled": self._zero(),
            "in_end": torch.full((), BIG, dtype=torch.int64, device=self.device),
            "drained": drained,
        }

    def uses_weight_form(self, n: int) -> bool:
        """Whether a block of ``n`` takes the weight form (the JAX
        package's matmul path, resample.py:204-213)."""
        window = (n // self.to + 2) * self.from_ + 1
        return (self.random_access and self.segment_frames is None
                and hasattr(self.input, "slice_frames")
                and window <= getattr(self.input, "PAD_FRAMES", 0))

    def _left_num(self, o: torch.Tensor):
        """(left input frame, lerp numerator, is a span's drain frame) of
        output frames ``o`` (resample.py:176-199)."""
        fr, to = self.from_, self.to
        L = self.segment_frames
        if L is None:
            return lerp_left(o, fr, to), (fr * (o % to)) % to, None
        seg, ol = o // self._seg_out, o % self._seg_out
        left_local = lerp_left(ol, fr, to)
        num = (fr * (ol % to)) % to
        if not self._seg_drain:
            return seg * L + left_local, num, None
        is_drain = ol == self._seg_out - 1
        left_local = torch.where(is_drain, torch.full_like(left_local, L - 1), left_local)
        num = torch.where(is_drain, torch.zeros_like(num), num)
        return seg * L + left_local, num, is_drain

    def _lerp(self, lval, rval, num):
        return lval + (rval - lval) * self._frac[num][None, :]

    @spanned("rodio.emit.Resample")
    def emit(self, state: State, n: int):
        if self.identity:
            s, block, valid = self.input.emit(state["in"], n)
            return {"in": s}, block, valid
        if not self.random_access:
            return self._emit_ring(state, n)
        start, in_end = self.input.access_window(state["in"])
        if self.uses_weight_form(n):
            from ..sources.generators import SamplesBuffer

            args = (start, in_end, state["out_o"], state["drained"], self._w0, self._w1, n,
                    self.from_, self.to)
            if isinstance(self.input, SamplesBuffer):
                out, out_o, valid, drained = resample_lerp(self.input.pcm(state["in"]), *args)
            else:
                out, out_o, valid, drained = lerp_block_plain(
                    lambda idx: self.input.gather_frames(state["in"], idx), *args)
            return {"in": state["in"], "out_o": out_o, "drained": drained}, out, valid
        o = state["out_o"] + torch.arange(n, device=self.device)
        left, num, seg_drain = self._left_num(o)
        lval = self.input.gather_frames(state["in"], start + left)
        out = self._lerp(lval, self.input.gather_frames(state["in"], start + left + 1), num)
        out, valid, drained = drain_and_mask(out, lval, left, in_end, state["drained"], n,
                                             seg_drain)
        return ({"in": state["in"], "out_o": state["out_o"] + n, "drained": drained},
                out, valid)

    def _emit_ring(self, state: State, n: int):
        """The streaming path over an upstream that is not random-access
        (resample.py:214-289), with no host read: the ring's roll is a
        gather at ``(arange + shift) % R``, the pull's scatter drops
        positions past the ring into a spare column, and reads past the
        ring are a clamp and a ``where``."""
        assert n <= self.max_block, f"Resample block {n} exceeds max_block={self.max_block}"
        dev, R = self.device, self.R
        o = state["out_o"] + torch.arange(n, device=dev)
        left, num, seg_drain = self._left_num(o)
        first_left = left[0]
        last_needed = left[-1] + 1

        # roll the ring so slot 0 holds input frame first_left
        shift = first_left - state["base_g"]
        ring = state["ring"][:, (torch.arange(R, device=dev) + shift) % R]
        fill = torch.clamp(state["fill"] - shift, min=0)
        base_g = first_left

        # the conditional pull: its size scales with this block; it is
        # committed only when the ring runs low and the input has not ended
        P = -(-n * self.from_ // self.to) + 3
        not_ended = state["in_end"] == BIG
        do_pull = ((last_needed + 1 - base_g) > fill) & not_ended
        in_pulled_state, xblk, v_in = self.input.emit(state["in"], P)
        in_state = tree_select(do_pull, in_pulled_state, state["in"])
        pos = fill + torch.arange(P, device=dev)
        pos = torch.where(do_pull & (pos < R), pos, torch.full_like(pos, R))
        spare = torch.zeros((ring.shape[0], 1), dtype=ring.dtype, device=dev)
        ring = torch.cat([ring, spare], dim=1).index_copy(
            1, pos, xblk.to(ring.dtype))[:, :R]
        in_pulled = torch.where(do_pull, state["in_pulled"] + P, state["in_pulled"])
        ended_now = do_pull & (v_in < P)
        in_end = torch.where(ended_now & not_ended, state["in_pulled"] + v_in,
                             state["in_end"])
        fill = torch.where(do_pull, fill + P, fill)

        def gather(i):
            inside = (i >= 0) & (i < R)
            v = ring[:, torch.clamp(i, 0, R - 1)]
            return torch.where(inside[None, :], v, torch.zeros_like(v))

        idx = left - base_g
        lval = gather(idx)
        out = self._lerp(lval, gather(idx + 1), num)
        out, valid, drained = drain_and_mask(out, lval, left, in_end, state["drained"], n,
                                             seg_drain)
        return ({"in": in_state, "ring": ring, "base_g": base_g, "fill": fill,
                 "out_o": state["out_o"] + n, "in_pulled": in_pulled,
                 "in_end": in_end, "drained": drained},
                out, valid)
