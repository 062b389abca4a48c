"""K4: the standalone biquad kernel (rodio_tpu/ops/pallas_scan.py counterpart).

:func:`biquad_df1` runs ``csrc/biquad.cu`` on a CUDA tensor and its plain
version, the sequential scan of :mod:`rodio_tpu_torch.ops.scan`, on a CPU
tensor. Both round every mul and add alone in the same order, so on the
card they agree bit for bit. ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from . import _build
from .scan import biquad_df1 as _biquad_scan

#: kernel launches made by :func:`biquad_df1`
launches = 0


def biquad_df1_plain(x, coeffs, state):
    """The plain PyTorch version: the sequential DF-I scan."""
    return _biquad_scan(x, coeffs, state, mode="exact")


def biquad_df1(x: torch.Tensor, coeffs: torch.Tensor, state):
    """Biquad over x [L, T] (lanes by time), coefficients a [5] f32 tensor
    (b0, b1, b2, a1, a2) on x's device, state (x1, x2, y1, y2) each [L].
    Returns (y [L, T], state'), the state being the last two inputs and
    outputs of each lane."""
    if x.device.type == "cpu":
        return biquad_df1_plain(x, coeffs, state)
    if x.device.type != "cuda":
        raise ValueError(f"biquad_df1: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"biquad_df1: x must be [L, T], got {tuple(x.shape)}")
    L, T = x.shape
    x = _build.f32_arg("x", x, x.device, (L, T))
    coeffs = _build.f32_arg("coeffs", coeffs, x.device, (5,))
    st = [_build.f32_arg(f"state[{i}]", s, x.device, (L,))
          for i, s in enumerate(state)]
    lib = _build.load_library()
    y = torch.empty_like(x)
    out = torch.empty((4, L), dtype=torch.float32, device=x.device)
    err = lib.rt_biquad_df1(
        x.data_ptr(), y.data_ptr(), coeffs.data_ptr(),
        *[s.data_ptr() for s in st], *[out[i].data_ptr() for i in range(4)],
        L, T, _build.stream_handle(x.device),
    )
    _build.check(err, "rt_biquad_df1")
    global launches
    launches += 1
    return y, (out[0], out[1], out[2], out[3])
