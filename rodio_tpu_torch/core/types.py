"""Core sample model: the port's part of rodio_tpu/core/types.py.

Samples are f32 (``float_dtype`` is ``torch.float32``); the f64 mode of the
JAX package is not ported yet. Sample rates and channel counts are positive
ints, checked as the reference checks them.
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


def float_dtype() -> torch.dtype:
    """The ``Sample`` dtype of the port (f32 only)."""
    return torch.float32


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
