"""Core sample model: the port's part of rodio_tpu/core/types.py.

Samples are f32 by default and f64 after ``set_float64(True)``, the analog
of the reference's ``64bit`` feature (rodio_tpu/core/types.py:27-48): a
node reads :func:`float_dtype` when it builds a sample tensor (its state,
its block), so the flag must be set before a graph is built. Wire formats
(i16/i24 PCM, ring indices, ``Bf16Boundary``) keep their own types. Sample
rates and channel counts are positive ints, checked as the reference checks
them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NANOS_PER_SEC = 1_000_000_000
#: the reference's default sample rate (src/common.rs:10)
DEFAULT_SAMPLE_RATE = 48_000
#: UniformSourceIterator's span cap in interleaved samples
#: (src/source/uniform.rs:56)
MAX_SPAN_LEN = 32_768


_FLOAT64 = False


def set_float64(enabled: bool) -> None:
    """Select f64 samples (the reference's ``64bit`` cargo feature) for the
    graphs built from now on."""
    global _FLOAT64
    _FLOAT64 = bool(enabled)


def float64_enabled() -> bool:
    return _FLOAT64


def float_dtype() -> torch.dtype:
    """The ``Float``/``Sample`` dtype (src/common.rs:18-48)."""
    return torch.float64 if _FLOAT64 else torch.float32


def sample_dtype() -> torch.dtype:
    return float_dtype()


def np_float_dtype(dtype: torch.dtype = None):
    """``dtype`` (by default :func:`float_dtype`) as a numpy type, for
    host-side sample arrays."""
    return np.float64 if (dtype or float_dtype()) == torch.float64 else np.float32


def to_sample(value: float, dtype: torch.dtype = None) -> float:
    """A host constant rounded to the sample type ``dtype`` (by default
    :func:`float_dtype`), as the JAX package's ``dt(value)`` takes it."""
    return float(np_float_dtype(dtype)(value))


def check_sample_rate(rate: int) -> int:
    rate = int(rate)
    if rate <= 0:
        raise ValueError(f"sample rate must be positive, got {rate}")
    return rate


def check_channels(channels: int) -> int:
    channels = int(channels)
    if channels <= 0:
        raise ValueError(f"channel count must be positive, got {channels}")
    if channels > 0xFFFF:
        raise ValueError(f"channel count must fit u16, got {channels}")
    return channels


def check_bit_depth(bits: int) -> int:
    bits = int(bits)
    if bits <= 0 or bits > 32:
        raise ValueError(f"bit depth must be in 1..=32, got {bits}")
    return bits


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static format of a stream: (channels, sample_rate)."""

    channels: int
    sample_rate: int

    def __post_init__(self):
        object.__setattr__(self, "channels", check_channels(self.channels))
        object.__setattr__(self, "sample_rate", check_sample_rate(self.sample_rate))


def duration_to_nanos(seconds: float) -> int:
    """Float seconds to integer nanoseconds (round-half-even like
    ``Duration::from_secs_f64``)."""
    if seconds < 0:
        raise ValueError("duration must be non-negative")
    return int(round(seconds * NANOS_PER_SEC))


def nanos_to_secs_f32(nanos: int) -> float:
    """Rust ``Duration::as_secs_f32``: f32(secs) as an f32 division."""
    return float(np.float32(nanos) / np.float32(NANOS_PER_SEC))
