"""Sequential recurrence scans (rodio_tpu/ops/scan.py, ``mode="exact"``).

Each step is one PyTorch op per mul and add, in the reference's operand
order, so nothing is contracted into an FMA: on the CPU these are the plain
versions of the kernels, and they round exactly as the CUDA kernels do.
``mode="assoc"`` (the associative-scan form) is not ported yet.

- linear:      y_t = a_t * y_{t-1} + b_t
- max-affine:  y_t = max(a_t, b_t + c_t * y_{t-1})

All functions scan over the LAST axis.
"""
from __future__ import annotations

import torch


def _check_mode(mode: str) -> None:
    if mode in ("assoc", "parallel"):
        raise NotImplementedError(
            f"scan mode {mode!r} (the associative scan) is not ported yet"
        )
    if mode != "exact":
        raise ValueError(f"unknown scan mode {mode!r}")


def linear_scan(a, b, init, *, mode: str = "exact"):
    """y_t = a_t * y_{t-1} + b_t with y_{-1} = init; a, b: [..., T]."""
    _check_mode(mode)
    y = init
    out = []
    for t in range(a.shape[-1]):
        y = a[..., t] * y + b[..., t]
        out.append(y)
    return torch.stack(out, dim=-1)


def max_affine_scan(a, b, c, init, *, mode: str = "exact"):
    """y_t = max(a_t, b_t + c_t * y_{t-1}) with y_{-1} = init, c_t >= 0."""
    _check_mode(mode)
    y = init
    out = []
    for t in range(a.shape[-1]):
        y = torch.maximum(a[..., t], b[..., t] + c[..., t] * y)
        out.append(y)
    return torch.stack(out, dim=-1)


def biquad_df1(x, coeffs, state, *, mode: str = "exact"):
    """Direct-form-I biquad over lanes (src/source/blt.rs:556-561):

        y = b0*x + b1*x1 + b2*x2 - a1*y1 - a2*y2

    x: [L, T] (any strides). coeffs: (b0, b1, b2, a1, a2) as scalars or a
    [5] tensor. state: (x1, x2, y1, y2) each [L]. Returns (y [L, T],
    state')."""
    _check_mode(mode)
    b0, b1, b2, a1, a2 = (coeffs[i] for i in range(5))
    x1, x2, y1, y2 = state
    out = []
    for t in range(x.shape[-1]):
        xt = x[:, t]
        y = b0 * xt + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        out.append(y)
        x1, x2, y1, y2 = xt, x1, y, y1
    y = torch.stack(out, dim=-1) if out else torch.empty_like(x)
    return y, (x1, x2, y1, y2)
