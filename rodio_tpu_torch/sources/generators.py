"""Generator sources (rodio_tpu/sources/generators.py): waveforms, chirp,
silence and device-resident buffers.

The reference accumulates a generator's phase with one f32 add a sample
(src/source/signal_generator.rs:133), which drifts by ~1e-4 over minutes.
By default a generator uses the JAX package's drift-free closed form: a
block's phase increments are computed in f64 on the host
(``_frac64(arange(n) * step64)``, made once per block size) and one f32
carry rounding happens a block. ``rodio_compat=True`` runs the reference's
recurrence instead, drift included, on ``ops/phase.py`` (a kernel on the
card). Every source takes ``device=``: ``None`` is the current CUDA
device, ``"cpu"`` the CPU.

A buffer's PCM lives on the device, zero padded by ``pad_frames`` so that
windows read past the end find silence.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State, clip_valid, full_valid, mask_block, take_frames
from ..core.types import (DEFAULT_SAMPLE_RATE, StreamSpec, np_float_dtype,
                          to_sample)
from ..ops.pack import content_flags, pack_time_major
from ..ops.phase import phase_accumulate
from ..utils.device import DeviceLike, resolve_device
from ..utils.trace import count, span

#: 2*pi rounded to f32, the factor the JAX package's f32 ``sin`` argument takes
TWO_PI = float(np.float32(2.0 * np.pi))


def _two_pi(dtype: torch.dtype) -> float:
    """2*pi as a tensor of ``dtype`` takes it (f64: unrounded)."""
    return 2.0 * np.pi if dtype == torch.float64 else TWO_PI


def _frac64(x):
    return x - np.floor(x)


class SignalGenerator(Node):
    """Periodic waveform generator: sine/triangle/square/sawtooth.

    Mono, infinite, codomain [-1, 1] (src/source/signal_generator.rs:73-170).
    ``function`` is a name or a callable phase -> sample over tensors (the
    GeneratorFunction extension point, src/source/signal_generator.rs:36).
    """

    def __init__(self, sample_rate: int, frequency: float, function,
                 *, rodio_compat: bool = False, device: DeviceLike = None):
        if frequency <= 0.0:
            raise ValueError("frequency must be greater than zero")
        if not callable(function) and function not in (
                "sine", "triangle", "square", "sawtooth"):
            raise ValueError(f"unknown generator function {function!r}")
        self.spec = StreamSpec(1, sample_rate)
        self.device = resolve_device(device)
        self.frequency = float(frequency)
        self.function = function
        self.rodio_compat = bool(rodio_compat)
        # the reference's period = rate/freq and step = 1/period in f32
        # (src/source/signal_generator.rs:113-114); the closed form keeps f64
        self._step64 = float(1.0 / (np.float64(sample_rate) / np.float64(frequency)))
        self._step32 = np.float32(1.0) / (np.float32(sample_rate) / np.float32(frequency))
        self._step_t = torch.full((1,), float(self._step32), dtype=self.dtype,
                                  device=self.device)
        self._incr = {}  # block size -> the closed form's increments

    def total_frames(self) -> Optional[int]:
        return None

    def init_state(self) -> State:
        return {"phase": torch.zeros((), dtype=self.dtype, device=self.device)}

    def seek_state(self, seconds: float) -> State:
        """O(1) seek (src/source/signal_generator.rs:165-169)."""
        period = np.float64(self.spec.sample_rate) / np.float64(self.frequency)
        seek = np.float64(seconds) * self.spec.sample_rate / period
        return {"phase": torch.full((), to_sample(_frac64(seek), self.dtype),
                                    dtype=self.dtype, device=self.device)}

    @staticmethod
    def waveform(function, phase: torch.Tensor) -> torch.Tensor:
        if callable(function):
            return function(phase)
        if function == "sine":
            return torch.sin(phase * _two_pi(phase.dtype))
        if function == "triangle":
            return 4.0 * torch.abs(phase - torch.floor(phase + 0.5)) - 1.0
        if function == "square":
            return torch.where(torch.remainder(phase, 1.0) < 0.5,
                               torch.ones_like(phase), -torch.ones_like(phase))
        if function == "sawtooth":
            return 2.0 * (phase - torch.floor(phase + 0.5))
        raise ValueError(function)

    def emit(self, state: State, n: int):
        if self.rodio_compat:
            phases, new_phase = phase_accumulate(state["phase"].view(1), self._step_t, n)
            block = SignalGenerator.waveform(self.function, phases)
            return {"phase": new_phase[0]}, block, full_valid(n, self.device)
        dt = state["phase"].dtype
        incr = self._incr.get((n, dt))
        if incr is None:
            table = _frac64(np.arange(n, dtype=np.float64) * self._step64)
            incr = self._incr[(n, dt)] = torch.from_numpy(table).to(self.device, dt)
        p = state["phase"] + incr
        p = p - torch.floor(p)
        block = SignalGenerator.waveform(self.function, p)[None, :]
        new_phase = state["phase"] + to_sample(_frac64(np.float64(n) * self._step64), self.dtype)
        new_phase = new_phase - torch.floor(new_phase)
        return {"phase": new_phase}, block, full_valid(n, self.device)


class SineWave(SignalGenerator):
    """(src/source/sine.rs:16): a 48 kHz sine."""

    def __init__(self, frequency: float, *, rodio_compat: bool = False,
                 device: DeviceLike = None):
        super().__init__(DEFAULT_SAMPLE_RATE, frequency, "sine",
                         rodio_compat=rodio_compat, device=device)


class SquareWave(SignalGenerator):
    def __init__(self, frequency: float, *, rodio_compat: bool = False,
                 device: DeviceLike = None):
        super().__init__(DEFAULT_SAMPLE_RATE, frequency, "square",
                         rodio_compat=rodio_compat, device=device)


class TriangleWave(SignalGenerator):
    def __init__(self, frequency: float, *, rodio_compat: bool = False,
                 device: DeviceLike = None):
        super().__init__(DEFAULT_SAMPLE_RATE, frequency, "triangle",
                         rodio_compat=rodio_compat, device=device)


class SawtoothWave(SignalGenerator):
    def __init__(self, frequency: float, *, rodio_compat: bool = False,
                 device: DeviceLike = None):
        super().__init__(DEFAULT_SAMPLE_RATE, frequency, "sawtooth",
                         rodio_compat=rodio_compat, device=device)


class Chirp(Node):
    """Linear sine sweep over a duration (src/source/chirp.rs:22-103)."""

    def __init__(self, sample_rate: int, start_frequency: float,
                 end_frequency: float, duration: float, *, device: DeviceLike = None):
        self.spec = StreamSpec(1, sample_rate)
        self.device = resolve_device(device)
        self.start_frequency = float(start_frequency)
        self.end_frequency = float(end_frequency)
        self._total = int(np.float64(duration) * sample_rate)
        # the divisors as device tensors: a CUDA division by a host scalar
        # multiplies by its reciprocal, which rounds differently
        self._div = torch.tensor([self._total, sample_rate], dtype=self.dtype,
                                 device=self.device)

    def total_frames(self) -> Optional[int]:
        return self._total

    def init_state(self) -> State:
        return {"i": torch.zeros((), dtype=torch.int64, device=self.device)}

    def emit(self, state: State, n: int):
        i = state["i"] + torch.arange(n, device=self.device)
        fi = i.to(self._div.dtype)
        ratio = fi / self._div[0]
        freq = (to_sample(self.start_frequency, self.dtype) * (1.0 - ratio)
                + to_sample(self.end_frequency, self.dtype) * ratio)
        t = (fi / self._div[1]) * _two_pi(fi.dtype) * freq
        valid = clip_valid(self._total - state["i"], n)
        block = mask_block(torch.sin(t)[None, :], valid)
        return {"i": state["i"] + n}, block, valid


class Zero(Node):
    """Silence, infinite or a fixed number of frames (src/source/zero.rs:19)."""

    def __init__(self, channels: int, sample_rate: int,
                 num_frames: Optional[int] = None, *, device: DeviceLike = None):
        self.spec = StreamSpec(channels, sample_rate)
        self.device = resolve_device(device)
        self._total = num_frames

    def total_frames(self) -> Optional[int]:
        return self._total

    def init_state(self) -> State:
        return {"i": torch.zeros((), dtype=torch.int64, device=self.device)}

    def emit(self, state: State, n: int):
        block = torch.zeros((self.spec.channels, n), dtype=self.dtype,
                            device=self.device)
        if self._total is None:
            valid = full_valid(n, self.device)
        else:
            valid = clip_valid(self._total - state["i"], n)
        return {"i": state["i"] + n}, block, valid


class Empty(Node):
    """Zero-length source (src/source/empty.rs:10)."""

    def __init__(self, channels: int = 1, sample_rate: int = DEFAULT_SAMPLE_RATE,
                 *, device: DeviceLike = None):
        self.spec = StreamSpec(channels, sample_rate)
        self.device = resolve_device(device)

    def total_frames(self) -> Optional[int]:
        return 0

    def init_state(self) -> State:
        return {}

    def emit(self, state: State, n: int):
        return state, torch.zeros((self.spec.channels, n), dtype=self.dtype,
                                  device=self.device), full_valid(0, self.device)


class SamplesBuffer(Node):
    """Device-resident PCM buffer source (src/buffer.rs:23-200).

    Accepts interleaved 1-D data (rodio layout) or a [channels, frames]
    array or tensor (a tensor on the node's device is read where it lies;
    host data is uploaded first). RANDOM_ACCESS marks the node as
    gatherable: downstream stages (the resampler, the fused pipeline) read
    frames directly.

    The buffer owns its PCM: one pass (``ops.pack``, a kernel on the card)
    copies the data into a time-major ``[frames + pad, C]`` buffer, zero
    padded, and gives the content probe's flags from the same read, so what
    the node renders is fixed when it is built. The fused pipeline reads
    that buffer (:meth:`time_major`) and the flags (:meth:`content_flags`);
    the gathers of the other consumers read a channel-major copy, made from
    it at their first use (:meth:`channel_major`, in ``init_state``'s
    ``"data"``) and kept.
    """

    RANDOM_ACCESS = True
    #: zero padding appended to the device array (per instance if given)
    PAD_FRAMES = 8192

    def __init__(self, channels: int, sample_rate: int, data,
                 *, start_frame: int = 0, pad_frames: Optional[int] = None,
                 device: DeviceLike = None):
        self.spec = StreamSpec(channels, sample_rate)
        self.device = resolve_device(device)
        if pad_frames is not None:
            if pad_frames < 1:
                raise ValueError("pad_frames must be >= 1")
            self.PAD_FRAMES = int(pad_frames)
        with span("rodio.setup.buffer"):
            if isinstance(data, torch.Tensor):
                arr = data.to(self.device, self.dtype)
            else:
                arr = torch.from_numpy(np.ascontiguousarray(np.asarray(
                    data, dtype=np_float_dtype(self.dtype)))).to(self.device)
            if arr.dim() == 1:  # a view: frame stride C, lane stride 1
                frames = arr.shape[0] // channels
                arr = arr[: frames * channels].reshape(frames, channels).T
            elif arr.dim() != 2 or arr.shape[0] != channels:
                raise ValueError("data must be 1-D interleaved or [channels, frames]")
            self._frames = arr.shape[1]
            self._tm, self._fails = pack_time_major(arr, self._frames + self.PAD_FRAMES)
        self._start = int(start_frame)
        self._flags = None  # the content flags, read back at their first use
        self._cm = None  # the channel-major copy, made at its first use

    def time_major(self) -> torch.Tensor:
        """The PCM time-major from the start frame: ``[frames + pad -
        start, C]``, a view of the buffer (frame ``start + f`` of lane l at
        ``[f, l]``, zero past the end)."""
        return self._tm[self._start:]

    def content_flags(self) -> tuple:
        """(int16_grid_exact, int24_grid_exact, two_piece_exact) of the
        whole buffer (``ops.pack``): read back from the pass's fail words
        at the first call, kept for the later ones. float32 only."""
        if self._flags is None:
            if self._fails is None:
                raise ValueError("the content probe reads float32 PCM")
            with span("rodio.setup.probe"):
                self._flags = content_flags(self._fails)
        return self._flags

    def channel_major(self) -> torch.Tensor:
        """The PCM channel-major, ``[C, frames + pad]``: copied from the
        time-major buffer at the first call (``trace.counts
        ["channel_major_copy"]``, the span ``rodio.setup.channel_major``)
        and kept."""
        if self._cm is None:
            with span("rodio.setup.channel_major"):
                self._cm = self._tm.T.contiguous()
            count("channel_major_copy")
        return self._cm

    def total_frames(self) -> Optional[int]:
        return max(0, self._frames - self._start)

    def init_state(self) -> State:
        # the logical end lives in the state, as in the JAX package
        return {
            "data": self.channel_major(),
            "pos": torch.tensor(self._start, dtype=torch.int64, device=self.device),
            "end": torch.tensor(self._frames, dtype=torch.int64, device=self.device),
        }

    def seek_state(self, state: State, seconds: float) -> State:
        """Frame-aligned O(1) seek (src/buffer.rs:101-120), saturating."""
        frames = int(np.float64(seconds) * self.spec.sample_rate)
        return {**state, "pos": torch.full((), min(frames, self._frames),
                                           dtype=torch.int64, device=self.device)}

    def access_window(self, state: State):
        """(start_frame, frames_from_start) of the remaining stream."""
        return state["pos"], state["end"] - state["pos"]

    def pcm(self, state: State) -> torch.Tensor:
        """The ``[C, frames + pad]`` tensor that :meth:`gather_frames` and
        :meth:`slice_frames` read in ``state``."""
        return state["data"]

    def gather_frames(self, state: State, idx: torch.Tensor) -> torch.Tensor:
        """Frames at device indices ``idx``; zero outside the buffer."""
        return take_frames(self.pcm(state), idx)

    def slice_frames(self, state: State, start: torch.Tensor, length: int):
        """Contiguous [C, length] window at a device start (clamped into
        the zero padding when past the end)."""
        start = torch.clamp(start, 0, self._frames + self.PAD_FRAMES - length)
        idx = start + torch.arange(length, device=self.device)
        return self.pcm(state)[:, idx]

    def emit(self, state: State, n: int):
        pos = state["pos"]
        block = self.gather_frames(state, pos + torch.arange(n, device=self.device))
        valid = clip_valid(state["end"] - pos, n)
        return {**state, "pos": pos + n}, mask_block(block, valid), valid
