"""Sample-type conversion — the device-boundary dtype casts.

The port's copy of ``rodio_tpu/io/sample_convert.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_io.py`` holds the two equal.

The equivalent of the reference's dasp-based SampleTypeConverter
(src/conversions/sample.rs:6-50): integer formats scale by full-scale with
clipping only at the conversion boundary (src/common.rs:43-48); floats pass
through. Vectorized numpy, used at device/file boundaries.
"""
from __future__ import annotations

import numpy as np

_INT_SPECS = {
    np.dtype(np.int8): (128.0, 127.0),
    np.dtype(np.int16): (32768.0, 32767.0),
    np.dtype(np.int32): (2147483648.0, 2147483647.0),
    np.dtype(np.uint8): None,
    np.dtype(np.uint16): None,
    np.dtype(np.uint32): None,
}


def to_f32(x: np.ndarray) -> np.ndarray:
    """Any supported PCM dtype -> f32 in [-1, 1]."""
    dt = np.dtype(x.dtype)
    if dt in (np.dtype(np.float32), np.dtype(np.float64)):
        return x.astype(np.float32)
    if dt == np.dtype(np.int16):
        return x.astype(np.float32) / 32768.0
    if dt == np.dtype(np.int32):
        return x.astype(np.float32) / 2147483648.0
    if dt == np.dtype(np.int8):
        return x.astype(np.float32) / 128.0
    if dt == np.dtype(np.uint8):
        return (x.astype(np.float32) - 128.0) / 128.0
    if dt == np.dtype(np.uint16):
        return (x.astype(np.float32) - 32768.0) / 32768.0
    if dt == np.dtype(np.uint32):
        return (x.astype(np.float32) - 2147483648.0) / 2147483648.0
    raise TypeError(f"unsupported sample dtype {dt}")


def from_f32(x: np.ndarray, dtype) -> np.ndarray:
    """f32 -> target PCM dtype, clipping at the boundary."""
    dt = np.dtype(dtype)
    if dt in (np.dtype(np.float32), np.dtype(np.float64)):
        return x.astype(dt)
    c = np.clip(x, -1.0, 1.0)
    if dt == np.dtype(np.int16):
        return (c * 32767.0).round().astype(dt)
    if dt == np.dtype(np.int32):
        return (c * 2147483647.0).round().astype(dt)
    if dt == np.dtype(np.int8):
        return (c * 127.0).round().astype(dt)
    if dt == np.dtype(np.uint8):
        return ((c * 127.0).round() + 128.0).astype(dt)
    if dt == np.dtype(np.uint16):
        return ((c * 32767.0).round() + 32768.0).astype(dt)
    raise TypeError(f"unsupported sample dtype {dt}")
