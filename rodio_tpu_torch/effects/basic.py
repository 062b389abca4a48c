"""Stateless and counter-based effects (rodio_tpu/effects/basic.py).

Per-sample loops become elementwise block ops; the reference's integer
nanosecond bookkeeping is resolved on the host into exact frame counts when
a node is built, and counters that advance a block at a time live in the
state as device tensors. Nodes that select their input's whole state with a
device flag (``Pausable``, ``Stoppable``, ``Skippable``) do it with
:func:`~rodio_tpu_torch.core.node.tree_select`, so they read nothing back.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.node import (Node, State, clip_valid, full_valid, mask_block,
                         tree_select, widen)
from ..core.types import (NANOS_PER_SEC, StreamSpec, duration_to_nanos,
                          np_float_dtype, to_sample)


def _scalar(value, device, dtype) -> torch.Tensor:
    """A 0-dim device tensor of ``dtype``."""
    return torch.full((), value, dtype=dtype, device=device)


def _divisor(value: float, device, dtype) -> torch.Tensor:
    """A divisor (rounded to the sample type ``dtype``) as a 0-dim device
    tensor: a CUDA division by a host scalar multiplies by its reciprocal,
    which rounds differently from the CPU's (and the reference's)
    division."""
    return _scalar(to_sample(value, dtype), device, dtype)


class _Wrap(Node):
    """Effect base: takes its spec, length and device from its input."""

    def __init__(self, input_node: Node):
        self.input = input_node
        self.spec = input_node.spec
        self.device = input_node.device

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        return self.input.init_state()


class Amplify(_Wrap):
    """sample * factor (src/source/amplify.rs:10-22). The factor lives in
    the state; it may be a scalar or a per-channel vector (the wide-channel
    batch layout carries per-stream volumes as per-channel gains). The
    product is of the sample type whatever the block's dtype: a bf16 block
    times an f32 array is f32 in JAX, while torch would keep bf16 against a
    0-dim factor."""

    def __init__(self, input_node: Node, factor):
        super().__init__(input_node)
        self.factor = np.asarray(factor, dtype=np_float_dtype(self.dtype))

    def init_state(self) -> State:
        f = torch.from_numpy(self.factor.copy()).to(self.device)
        if f.dim() == 1:
            f = f[:, None]  # broadcast over time
        return {"in": self.input.init_state(), "factor": f}

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state["in"], n)
        return ({"in": s, "factor": state["factor"]},
                widen(block, self.dtype) * state["factor"], valid)


class Distortion(_Wrap):
    """(x*gain).clamp(-t, t) (src/source/distortion.rs:66-72)."""

    def __init__(self, input_node: Node, gain: float, threshold: float):
        super().__init__(input_node)
        self.gain = float(gain)
        self.threshold = float(threshold)

    def init_state(self) -> State:
        return {"in": self.input.init_state(),
                "gain": _scalar(to_sample(self.gain, self.dtype), self.device, self.dtype),
                "threshold": _scalar(to_sample(self.threshold, self.dtype), self.device,
                                     self.dtype)}

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state["in"], n)
        t = state["threshold"]
        out = torch.clamp(widen(block, self.dtype) * state["gain"], min=-t, max=t)
        # frames past valid stay silent whatever the threshold does
        return ({"in": s, "gain": state["gain"], "threshold": t},
                mask_block(out, valid), valid)


class LinearGainRamp(_Wrap):
    """Linear gain over a duration (src/source/linear_ramp.rs:9-120).

    The reference advances an integer-nanosecond clock by floor(1e9/rate)
    ns a frame; the per-frame fraction step is taken in f64 on the host
    (step = dpf_ns/total_ns), as the JAX package takes it."""

    def __init__(self, input_node: Node, duration: float, start_gain: float,
                 end_gain: float, clamp_end: bool):
        super().__init__(input_node)
        total_ns = duration_to_nanos(duration)
        if total_ns <= 0:
            raise ValueError("duration must be greater than zero")
        self.start_gain = float(start_gain)
        self.end_gain = float(end_gain)
        self.clamp_end = bool(clamp_end)
        dpf_ns = NANOS_PER_SEC // self.spec.sample_rate
        #: frames for which elapsed < total (the ramp is active)
        self.ramp_frames = -(-total_ns // dpf_ns)
        self.step_p = float(np.float64(dpf_ns) / np.float64(total_ns))

    def init_state(self) -> State:
        return {"in": self.input.init_state(),
                "frame": torch.zeros((), dtype=torch.int64, device=self.device)}

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state["in"], n)
        f = state["frame"] + torch.arange(n, device=self.device)
        dt = self.dtype
        p = f.to(dt) * to_sample(self.step_p, dt)
        ramp = to_sample(self.start_gain, dt) * (1.0 - p) + to_sample(self.end_gain, dt) * p
        after = to_sample(self.end_gain, dt) if self.clamp_end else 1.0
        gain = torch.where(f < self.ramp_frames, ramp, torch.full_like(ramp, after))
        return {"in": s, "frame": state["frame"] + n}, widen(block, dt) * gain[None, :], valid


class TakeDuration(_Wrap):
    """Stop after a duration (src/source/take.rs:10-216).

    The reference counts interleaved samples with duration_per_sample =
    floor(1e9/(rate*channels)) ns and pads the final partial frame with
    silence; the exact interleaved sample budget is computed on the host
    and the final partial frame is channel-masked.

    With ``fadeout=True`` the gain is remaining/total, both truncated to
    whole milliseconds as the reference does (src/source/take.rs:36-38,
    as_millis): floor(remaining_ns/1e6)/floor(total_ns/1e6), in the
    reference's op order (sample * remaining, then / total). The remaining
    position is carried across blocks as a (whole-ms, ns-within-ms) pair,
    with the JAX package's floor-division semantics."""

    def __init__(self, input_node: Node, duration: float, *, fadeout: bool = False):
        super().__init__(input_node)
        self.duration_ns = duration_to_nanos(duration)
        c = self.spec.channels
        dps_ns = NANOS_PER_SEC // (self.spec.sample_rate * c)
        self.n_samples = 0 if dps_ns == 0 else self.duration_ns // dps_ns
        self.dps_ns = dps_ns
        self.fadeout = bool(fadeout)
        self._valid_frames = -(-self.n_samples // c)  # ceil: the final frame padded
        self._tail_channels = self.n_samples % c  # 0: a full final frame
        self._total_ms = _divisor(float(self.duration_ns // 1_000_000), self.device, self.dtype)

    def total_frames(self) -> Optional[int]:
        inner = self.input.total_frames()
        if inner is None:
            return self._valid_frames
        return min(inner, self._valid_frames)

    def init_state(self) -> State:
        st = {"in": self.input.init_state(),
              "frame": torch.zeros((), dtype=torch.int64, device=self.device)}
        if self.fadeout and self.n_samples > 0:
            st["fade_ms"] = _scalar(self.duration_ns // 1_000_000, self.device, torch.int64)
            st["fade_r"] = _scalar(self.duration_ns % 1_000_000, self.device, torch.int64)
        return st

    def emit(self, state: State, n: int):
        s, block, v_in = self.input.emit(state["in"], n)
        dev, c = self.device, self.spec.channels
        f = state["frame"] + torch.arange(n, device=dev)
        new_state = {"in": s, "frame": state["frame"] + n}
        if self.fadeout and self.n_samples > 0:
            d, M = self.dps_ns, 1_000_000
            # remaining whole ms at interleaved sample j of the block:
            # fade_ms + floor((fade_r - j*dps) / 1e6)
            j = (torch.arange(n, device=dev)[None, :] * c
                 + torch.arange(c, device=dev)[:, None])
            ms = state["fade_ms"] + torch.div(state["fade_r"] - j * d, M,
                                              rounding_mode="floor")
            ms = torch.clamp(ms, min=0).to(self.dtype)
            block = (widen(block, self.dtype) * ms) / self._total_ms
            raw = state["fade_r"] - n * c * d
            q = torch.div(raw, M, rounding_mode="floor")
            new_state["fade_ms"] = state["fade_ms"] + q
            new_state["fade_r"] = raw - q * M
        valid = torch.minimum(v_in, clip_valid(self._valid_frames - state["frame"], n))
        if self._tail_channels:
            # zero channels >= tail_channels on the final (padded) frame
            ch = torch.arange(c, device=dev)[:, None]
            pad = (f[None, :] == self._valid_frames - 1) & (ch >= self._tail_channels)
            block = torch.where(pad, torch.zeros_like(block), block)
        return new_state, mask_block(block, valid), valid


class SkipDuration(_Wrap):
    """Skip a duration at construction (src/source/skip.rs:275-339).

    The skip in frames is exact integer math; ``init_state`` fast-forwards
    by the input's own emits, or by an O(1) seek where the input has one."""

    def __init__(self, input_node: Node, duration: float):
        super().__init__(input_node)
        self.skip_ns = duration_to_nanos(duration)
        self.skip_frames = self.skip_ns * self.spec.sample_rate // NANOS_PER_SEC

    def total_frames(self) -> Optional[int]:
        inner = self.input.total_frames()
        return None if inner is None else max(0, inner - self.skip_frames)

    def init_state(self) -> State:
        from ..sources.generators import SamplesBuffer, SignalGenerator

        s = self.input.init_state()
        remaining = self.skip_frames
        if isinstance(self.input, SamplesBuffer):
            # the exact frame count, not through float seconds (int(secs *
            # rate) can land one frame low, e.g. 18 ms at 48 kHz)
            pos = min(self.input._start + remaining, self.input._frames)
            return {**s, "pos": _scalar(pos, self.device, torch.int64)}
        if isinstance(self.input, SignalGenerator):
            return self.input.seek_state(self.skip_ns / NANOS_PER_SEC)
        while remaining > 0:
            k = min(8192, remaining)
            s, _, _ = self.input.emit(s, int(k))
            remaining -= k
        return s

    def emit(self, state: State, n: int):
        return self.input.emit(state, n)


class Delay(_Wrap):
    """Prepend silence (src/source/delay.rs:522-637): a [channels, D] delay
    line carried in the state."""

    def __init__(self, input_node: Node, duration: float):
        super().__init__(input_node)
        ns = duration_to_nanos(duration)
        c = self.spec.channels
        n_interleaved = ns * c * self.spec.sample_rate // NANOS_PER_SEC
        self.delay_frames = int(n_interleaved // c)
        self.duration = duration

    def total_frames(self) -> Optional[int]:
        inner = self.input.total_frames()
        return None if inner is None else inner + self.delay_frames

    def init_state(self) -> State:
        return {
            "in": self.input.init_state(),
            "buf": torch.zeros((self.spec.channels, self.delay_frames),
                               dtype=self.dtype, device=self.device),
            "buffered_valid": _scalar(self.delay_frames, self.device, torch.int64),
            "ended": _scalar(False, self.device, torch.bool),
        }

    def emit(self, state: State, n: int):
        s, x, v_in = self.input.emit(state["in"], n)
        if self.delay_frames == 0:
            return {**state, "in": s}, x, v_in
        joined = torch.cat([state["buf"], widen(x, self.dtype)], dim=1)  # [C, d + n]
        avail = state["buffered_valid"] + v_in
        valid = clip_valid(avail, n)
        return ({"in": s, "buf": joined[:, n:],
                 "buffered_valid": torch.clamp(avail - n, min=0),
                 "ended": state["ended"]},
                mask_block(joined[:, :n], valid), valid)


class Speed(_Wrap):
    """Metadata-only speed change (src/source/speed.rs:56-144): the reported
    sample rate is scaled; the next uniform stage resamples."""

    def __init__(self, input_node: Node, factor: float):
        super().__init__(input_node)
        self.factor = float(factor)
        new_rate = max(1, int(input_node.spec.sample_rate * np.float32(factor)))
        self.spec = StreamSpec(input_node.spec.channels, new_rate)

    def emit(self, state: State, n: int):
        return self.input.emit(state, n)


class ChannelVolume(_Wrap):
    """Frame -> mono mean -> per-output-channel volumes
    (src/source/channel_volume.rs:12-115). The mean sums the channels in
    order, then divides, as the reference does."""

    def __init__(self, input_node: Node, volumes: Sequence[float]):
        super().__init__(input_node)
        self.volumes = [float(v) for v in volumes]
        if not self.volumes:
            raise ValueError("need at least one channel volume")
        self.spec = StreamSpec(len(self.volumes), input_node.spec.sample_rate)
        self._count = _divisor(float(input_node.spec.channels), self.device, self.dtype)

    def init_state(self) -> State:
        return {"in": self.input.init_state(),
                "volumes": torch.tensor(self.volumes, dtype=self.dtype,
                                        device=self.device)}

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state["in"], n)
        block = widen(block, self.dtype)
        acc = block[0]
        for c in range(1, block.shape[0]):
            acc = acc + block[c]
        mono = acc / self._count
        out = mono[None, :] * state["volumes"][:, None]
        return {"in": s, "volumes": state["volumes"]}, out, valid


def spatial_volumes(emitter_pos, left_ear, right_ear):
    """L/R gains from emitter and ear positions (src/source/spatial.rs:48-69):
    an inverse-square distance times an interaural difference modifier, in
    f32 on the host (the port's copy of rodio_tpu/refimpl/effects.py
    spatial_volumes)."""
    F = np.float32
    e = np.asarray(emitter_pos, dtype=F)
    le = np.asarray(left_ear, dtype=F)
    re = np.asarray(right_ear, dtype=F)

    def dist_sq(a, b):
        d = a - b
        return F(np.sum(d * d, dtype=F))

    def rust_min(a, b):
        # f32::min: a NaN operand yields the other (Python's min would
        # return a NaN first argument)
        if np.isnan(a):
            return b
        if np.isnan(b):
            return a
        return min(a, b)

    left_dist_sq, right_dist_sq = dist_sq(le, e), dist_sq(re, e)
    max_diff = F(np.sqrt(dist_sq(le, re)))
    left_dist, right_dist = F(np.sqrt(left_dist_sq)), F(np.sqrt(right_dist_sq))
    with np.errstate(divide="ignore", invalid="ignore"):
        # coincident ears (max_diff = 0) give 0/0 = NaN: modifier 1.0 by
        # rust_min; an emitter at an ear (dist_sq = 0) gives 1/0 = inf: 1.0
        left_diff = rust_min(
            F(F(F(F(left_dist - right_dist) / max_diff + F(1.0)) / F(4.0)) + F(0.5)), F(1.0))
        right_diff = rust_min(
            F(F(F(F(right_dist - left_dist) / max_diff + F(1.0)) / F(4.0)) + F(0.5)), F(1.0))
        left_dist_mod = rust_min(F(F(1.0) / left_dist_sq), F(1.0))
        right_dist_mod = rust_min(F(F(1.0) / right_dist_sq), F(1.0))
    return F(left_diff * left_dist_mod), F(right_diff * right_dist_mod)


class Spatial(ChannelVolume):
    """ChannelVolume driven by emitter and ear geometry (src/source/spatial.rs)."""

    def __init__(self, input_node: Node, emitter_position, left_ear, right_ear):
        lvol, rvol = spatial_volumes(emitter_position, left_ear, right_ear)
        super().__init__(input_node, [float(lvol), float(rvol)])

    @staticmethod
    def positions_state(state: State, emitter_pos, left_ear, right_ear) -> State:
        """A host-side reposition: the state with the new volumes
        (src/source/spatial.rs:48-69)."""
        lvol, rvol = spatial_volumes(emitter_pos, left_ear, right_ear)
        vol = state["volumes"]
        return {**state, "volumes": torch.tensor([float(lvol), float(rvol)],
                                                 dtype=vol.dtype, device=vol.device)}


class _Gate(_Wrap):
    """A device flag that, while set, silences the output and holds the
    input's state (``tree_select``); ``FLAG`` names it, ``VALID_WHILE_SET``
    says whether the frames count as valid then (silence) or not (ended)."""

    FLAG = ""
    VALID_WHILE_SET = False

    def _flag0(self) -> bool:
        return False

    def init_state(self) -> State:
        return {"in": self.input.init_state(),
                self.FLAG: _scalar(self._flag0(), self.device, torch.bool)}

    def emit(self, state: State, n: int):
        s2, block, valid = self.input.emit(state["in"], n)
        flag = state[self.FLAG]
        out = torch.where(flag, torch.zeros_like(block), block)
        v = torch.where(flag, full_valid(n if self.VALID_WHILE_SET else 0, self.device),
                        valid)
        return {"in": tree_select(flag, state["in"], s2), self.FLAG: flag}, out, v


class Pausable(_Gate):
    """Zeros while paused, the input frozen (src/source/pausable.rs:7-96)."""

    FLAG = "paused"
    VALID_WHILE_SET = True

    def __init__(self, input_node: Node, initially_paused: bool = False):
        super().__init__(input_node)
        self.initially_paused = bool(initially_paused)

    def _flag0(self) -> bool:
        return self.initially_paused


class Stoppable(_Gate):
    """Flag-based end (src/source/stoppable.rs:8-27)."""

    FLAG = "stopped"


class Skippable(_Gate):
    """skip() ends the source (src/source/skippable.rs:10-37)."""

    FLAG = "skipped"


class TrackPosition(_Wrap):
    """Frame counter -> playback position (src/source/position.rs:10-100)."""

    def init_state(self) -> State:
        return {"in": self.input.init_state(),
                "frames": torch.zeros((), dtype=torch.int64, device=self.device)}

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state["in"], n)
        return {"in": s, "frames": state["frames"] + valid}, block, valid

    def get_pos(self, state: State) -> float:
        """The position in seconds (reads the counter back to the host)."""
        return float(state["frames"]) / self.spec.sample_rate


class Repeat(Node):
    """Loop a finite source forever (src/source/repeat.rs:10-44). As the
    reference buffers the source, the input is rendered once when the node
    is built; playback is then a modular gather."""

    def __init__(self, input_node: Node):
        from ..graph.render import render

        data = render(input_node)  # [C, F] numpy
        if data.shape[1] == 0:
            raise ValueError("cannot repeat an empty source")
        self.spec = input_node.spec
        self.device = input_node.device
        self._data = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        self._frames = data.shape[1]

    def total_frames(self) -> Optional[int]:
        return None

    def init_state(self) -> State:
        return {"data": self._data,
                "pos": torch.zeros((), dtype=torch.int64, device=self.device)}

    def emit(self, state: State, n: int):
        idx = (state["pos"] + torch.arange(n, device=self.device)) % self._frames
        return ({"data": state["data"], "pos": (state["pos"] + n) % self._frames},
                state["data"][:, idx], full_valid(n, self.device))
