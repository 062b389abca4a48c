"""Recurrence scans (rodio_tpu/ops/scan.py), sequential and associative.

- linear:      y_t = a_t * y_{t-1} + b_t
- max-affine:  y_t = max(a_t, b_t + c_t * y_{t-1})

``mode="exact"`` is the sequential scan: each step is one PyTorch op per
mul and add, in the reference's operand order, so nothing is contracted
into an FMA; on the CPU these are the plain versions of the kernels, and
they round exactly as the CUDA kernels do.

``mode="parallel"`` is the associative scan, O(log T) deep, in torch ops
on every device (no kernel: ``lax.associative_scan`` is an XLA op, not a
Pallas kernel). :func:`associative_scan` rebuilds the combine tree of JAX
0.9.0's ``lax.associative_scan`` (jax/_src/lax/control_flow/loops.py
``_scan``): pairs ``[0:-1:2]`` with ``[1::2]``, the recursion on them, then
the odd results with ``elems[2::2]``, ``elems[0]`` first, interleaved. Same
tree and the same combine operands, so the rounding is JAX's but for its
FMA contraction on XLA:CPU, a few ulp. Every elementwise op rounds alone
on the CPU and the card alike (no matmul, no reduction), so the card's
results equal the CPU's bit for bit.

All functions scan over the LAST axis (the biquad's over time).
"""
from __future__ import annotations

import torch

#: the scan modes of the JAX package's documentation
MODES = ("exact", "parallel")


def check_mode(mode: str, allowed=MODES, *, who: str = "scan") -> None:
    """Raise ``ValueError`` for a mode name that is not one of ``allowed``
    (the JAX package's documented names). ``"assoc"`` is refused naming
    ``"parallel"``, the JAX package's name for the associative scan."""
    if mode in allowed:
        return
    hint = ' (the associative scan is mode="parallel")' if mode == "assoc" else ""
    raise ValueError(f"{who}: unknown mode {mode!r}{hint}; expected one of "
                     f"{', '.join(map(repr, allowed))}")


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim`` (len(a) - len(b) is 0 or 1)."""
    na, nb = a.shape[dim], b.shape[dim]
    shape = list(a.shape)
    shape[dim] = na + nb
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(combine, elems, dim: int = -1):
    """The inclusive scan of the tuple of tensors ``elems`` along ``dim``
    under ``combine(left, right) -> tuple``, by JAX 0.9.0's recursion, so
    that each output is combined by the same tree of the same operands."""
    elems = tuple(elems)
    dim = dim % elems[0].dim()

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(es):
        n = es[0].shape[dim]
        if n < 2:
            return es
        reduced = combine(tuple(sl(e, 0, n - 1, 2) for e in es),
                          tuple(sl(e, 1, None, 2) for e in es))
        odd = scan(tuple(reduced))
        if n % 2 == 0:
            even = combine(tuple(sl(e, 0, -1) for e in odd),
                           tuple(sl(e, 2, None, 2) for e in es))
        else:
            even = combine(odd, tuple(sl(e, 2, None, 2) for e in es))
        even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(es, even))
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    return scan(elems)


def _linear_combine(l, r):
    al, bl = l
    ar, br = r
    return al * ar, ar * bl + br


def _max_affine_combine(l, r):
    al, bl, cl = l
    ar, br, cr = r
    return torch.maximum(ar, br + cr * al), br + cr * bl, cr * cl


def linear_scan(a, b, init, *, mode: str = "exact"):
    """y_t = a_t * y_{t-1} + b_t with y_{-1} = init; a, b: [..., T]."""
    check_mode(mode)
    if mode == "parallel":
        A, B = associative_scan(_linear_combine, (a, b))
        return A * init[..., None] + B
    y = init
    out = []
    for t in range(a.shape[-1]):
        y = a[..., t] * y + b[..., t]
        out.append(y)
    return torch.stack(out, dim=-1)


def max_affine_scan(a, b, c, init, *, mode: str = "exact"):
    """y_t = max(a_t, b_t + c_t * y_{t-1}) with y_{-1} = init, c_t >= 0."""
    check_mode(mode)
    if mode == "parallel":
        A, B, C = associative_scan(_max_affine_combine, (a, b, c))
        return torch.maximum(A, B + C * init[..., None])
    y = init
    out = []
    for t in range(a.shape[-1]):
        y = torch.maximum(a[..., t], b[..., t] + c[..., t] * y)
        out.append(y)
    return torch.stack(out, dim=-1)


def ema_scan(x, coeff, init, *, mode: str = "exact"):
    """Exponential smoothing y_t = coeff*y_{t-1} + (1-coeff)*x_t; the b
    term is (1-coeff)*x, the reference's operand order."""
    coeff = torch.broadcast_to(torch.as_tensor(coeff, dtype=x.dtype,
                                               device=x.device), x.shape)
    return linear_scan(coeff, (1.0 - coeff) * x, init, mode=mode)


def _companion_combine(l, r):
    """(Ar @ Al, Ar @ dl + dr) for 2x2 maps held as their four entries and
    two-vectors as their two, each product and sum one rounded op: the
    JAX combine's ``Ar @ Al`` and ``einsum("...ij,...j->...i", Ar, dl) +
    dr`` (rodio_tpu/ops/scan.py:162-165) written out, so no matmul (cuBLAS
    on the card) sums them another way."""
    (l00, l01, l10, l11, d0l, d1l) = l
    (r00, r01, r10, r11, d0r, d1r) = r
    return (r00 * l00 + r01 * l10, r00 * l01 + r01 * l11,
            r10 * l00 + r11 * l10, r10 * l01 + r11 * l11,
            (r00 * d0l + r01 * d1l) + d0r, (r10 * d0l + r11 * d1l) + d1r)


def biquad_df1(x, coeffs, state, *, mode: str = "exact"):
    """Direct-form-I biquad over lanes (src/source/blt.rs:556-561):

        y = b0*x + b1*x1 + b2*x2 - a1*y1 - a2*y2

    x: [L, T] (any strides). coeffs: (b0, b1, b2, a1, a2) as scalars or a
    [5] tensor. state: (x1, x2, y1, y2) each [L]. Returns (y [L, T],
    state').

    ``"parallel"`` (JAX ``:136-175``): the FIR half from shifted inputs,
    the IIR half ``v_t = M v_{t-1} + [u_t, 0]``, M = [[-a1, -a2], [1, 0]],
    as an associative scan of the 2x2 companion maps; a block shorter than
    2 takes the exact scan, as JAX's does."""
    check_mode(mode)
    b0, b1, b2, a1, a2 = (coeffs[i] for i in range(5))
    x1, x2, y1, y2 = state
    if mode == "parallel" and x.shape[-1] >= 2:
        return _biquad_parallel(x, (b0, b1, b2, a1, a2), (x1, x2, y1, y2))
    out = []
    for t in range(x.shape[-1]):
        xt = x[:, t]
        y = b0 * xt + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        out.append(y)
        x1, x2, y1, y2 = xt, x1, y, y1
    y = torch.stack(out, dim=-1) if out else torch.empty_like(x)
    return y, (x1, x2, y1, y2)


def _biquad_parallel(x, coeffs, state):
    b0, b1, b2, a1, a2 = coeffs
    x1, x2, y1, y2 = state
    xm1 = torch.cat([x1[:, None], x[:, :-1]], dim=-1)
    xm2 = torch.cat([x2[:, None], x1[:, None], x[:, :-2]], dim=-1)
    u = b0 * x + b1 * xm1 + b2 * xm2  # [L, T]
    zeros, ones = torch.zeros_like(u), torch.ones_like(u)

    def lanes(v):  # a coefficient (scalar, 0-dim or [L]) over [L, T]
        v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        return torch.broadcast_to(v[:, None] if v.dim() == 1 else v, u.shape)

    m = (-lanes(a1), -lanes(a2), ones, zeros, u, zeros)
    a00, a01, a10, a11, d0, d1 = associative_scan(_companion_combine, m)
    # v = einsum("ltij,lj->lti", Ap, v0) + dp; y is its first component
    y = (a00 * y1[:, None] + a01 * y2[:, None]) + d0
    return y, (x[:, -1], x[:, -2], y[:, -1], y[:, -2])
