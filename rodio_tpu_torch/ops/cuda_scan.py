"""K4, K5, K6 and K7: the per-lane serial scans (rodio_tpu/ops/pallas_scan.py).

- :func:`biquad_df1` (K4, ``csrc/biquad.cu``): the DF-I biquad, on f32
  blocks and (its bf16 instance) on bf16 blocks.
- :func:`limiter_env` (K5, ``csrc/limiter_env.cu``): the limiter's two
  envelope recurrences; :func:`limiter_stream`, the same kernel with the
  ``Limit`` node's gain computer before them and its coupling and gain
  after them: the node's whole non-K3 path in one pass.
- :func:`agc` (K6, ``csrc/agc.cu``): the AGC's whole per-sample loop.
- :func:`first_order` (K7, ``csrc/first_order.cu``): a first-order
  recurrence, ``linear``, ``max_affine`` or ``agc_gain`` (the AGC's gain
  smoother).

Each wrapper runs its kernel on a CUDA tensor and its plain version, a
sequential loop of PyTorch ops, on a CPU tensor. Both round every mul and
add alone in the same order, so on the card they agree bit for bit.
``launches``, ``bf16_launches``, ``limiter_env_launches``,
``limiter_stream_launches``, ``agc_launches`` and ``first_order_launches``
count each wrapper's launches.

:func:`desired_gain` and :func:`smooth_gain` are the AGC's arithmetic as
the kernels write it (``csrc/agc_math.cuh``), shared by the plain versions
of K2, K6 and K7 and by the AGC node. The one rsqrt of the port is
``1 / sqrt(x)``, both correctly rounded (``torch.rsqrt`` and CUDA's
``rsqrtf`` are approximate, and PyTorch's f32 ``sqrt`` on the CPU can be
an ulp off: ``core.math.sqrt_rn``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import DB_TO_LOG2, LOG2_TO_DB, db_to_linear, sqrt_rn
from . import _build
from .limiter_block import limiter_gain_db
from .scan import biquad_df1 as _biquad_scan
from .scan import linear_scan, max_affine_scan

#: kernel launches made by :func:`biquad_df1` on f32 blocks (K4)
launches = 0
#: kernel launches made by :func:`biquad_df1` on bf16 blocks (K4's bf16 instance)
bf16_launches = 0
#: kernel launches made by :func:`limiter_env` (K5)
limiter_env_launches = 0
#: kernel launches made by :func:`limiter_stream` (K5, the Limit node's pass)
limiter_stream_launches = 0
#: kernel launches made by :func:`agc` (K6)
agc_launches = 0
#: kernel launches made by :func:`first_order` (K7)
first_order_launches = 0

FIRST_ORDER_OPS = ("linear", "max_affine", "agc_gain")


def biquad_df1_plain(x, coeffs, state):
    """The plain PyTorch version: the sequential DF-I scan. A bf16 block is
    upcast (exactly), scanned in f32 and stored bf16 rounded to nearest
    even; its y carries are the stored outputs, upcast."""
    if x.dtype != torch.bfloat16:
        return _biquad_scan(x, coeffs, state, mode="exact")
    y, (x1, x2, y1, y2) = _biquad_scan(x.float(), coeffs, state, mode="exact")
    y = y.to(torch.bfloat16)
    T = x.shape[-1]
    if T >= 1:
        y1 = y[:, -1].float()
    if T >= 2:
        y2 = y[:, -2].float()
    return y, (x1, x2, y1, y2)


def biquad_df1(x: torch.Tensor, coeffs: torch.Tensor, state):
    """Biquad over x [L, T] (lanes by time; f32, or bf16 behind a
    ``Bf16Boundary``), coefficients a [5] f32 tensor (b0, b1, b2, a1, a2)
    on x's device, state (x1, x2, y1, y2) each [L] f32. Returns (y [L, T]
    in x's dtype, state'), the state being the last two inputs and stored
    outputs of each lane (the carry-in where T < 2), in f32.

    A bf16 block runs K4's bf16 instance: it upcasts on load, runs the
    recurrence in f32 (inside a call the feedback is f32, as the Pallas
    kernel's scratch is) and stores y rounded to bf16; across calls the
    feedback is the rounded output (rodio_tpu/ops/pallas_scan.py:133-138)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"biquad_df1: x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return biquad_df1_plain(x, coeffs, state)
    if x.device.type != "cuda":
        raise ValueError(f"biquad_df1: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"biquad_df1: x must be [L, T], got {tuple(x.shape)}")
    L, T = x.shape
    bf16 = x.dtype == torch.bfloat16
    x = _build._typed_arg("x", x, x.dtype, x.device, (L, T))
    coeffs = _build.f32_arg("coeffs", coeffs, x.device, (5,))
    st = [_build.f32_arg(f"state[{i}]", s, x.device, (L,))
          for i, s in enumerate(state)]
    lib = _build.load_library()
    y = torch.empty_like(x)
    out = torch.empty((4, L), dtype=torch.float32, device=x.device)
    fn = lib.rt_biquad_df1_bf16 if bf16 else lib.rt_biquad_df1
    err = fn(x.data_ptr(), y.data_ptr(), coeffs.data_ptr(),
             *[s.data_ptr() for s in st], *[out[i].data_ptr() for i in range(4)],
             L, T, _build.stream_handle(x.device))
    _build.check(err, "rt_biquad_df1_bf16" if bf16 else "rt_biquad_df1")
    global launches, bf16_launches
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return y, (out[0], out[1], out[2], out[3])


def _one_minus(c: float) -> float:
    """1 - c rounded to f32, as the JAX kernel's ``(1.0 - c) * x`` takes
    it."""
    return float(np.float32(1.0 - c))


def limiter_env_plain(db, integ0, peak0, *, att: float, rel: float):
    """The plain PyTorch version of K5, on any device: the sequential
    scans of the limiter's ``mode="exact"`` path, one op at a time."""
    crel, catt = _one_minus(rel), _one_minus(att)
    integ = max_affine_scan(db, db * crel, torch.full_like(db, rel), integ0)
    peak = linear_scan(torch.full_like(integ, att), integ * catt, peak0)
    return peak, (integ[:, -1], peak[:, -1])


def limiter_env(db: torch.Tensor, integ0: torch.Tensor, peak0: torch.Tensor,
                *, att: float, rel: float):
    """The limiter envelopes over db [L, T] (the soft-knee gain in dB) from
    the carries integ0, peak0 [L]; att and rel are the f32 coefficients as
    floats. Per step ``integ = max(db, rel*integ + (1-rel)*db)``, ``peak =
    att*peak + (1-att)*integ``. Returns (peak [L, T], (integ', peak')), the
    carries of the last step. T >= 1."""
    if db.device.type == "cpu":
        return limiter_env_plain(db, integ0, peak0, att=att, rel=rel)
    if db.device.type != "cuda":
        raise ValueError(f"limiter_env: unsupported device {db.device}")
    if db.dim() != 2 or db.shape[1] < 1:
        raise ValueError(f"limiter_env: db must be [L, T >= 1], got {tuple(db.shape)}")
    L, T = db.shape
    dev = db.device
    db = _build.f32_arg("db", db, dev, (L, T))
    integ0 = _build.f32_arg("integ0", integ0, dev, (L,))
    peak0 = _build.f32_arg("peak0", peak0, dev, (L,))
    peak = torch.empty_like(db)
    out = torch.empty((2, L), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = lib.rt_limiter_env(db.data_ptr(), integ0.data_ptr(), peak0.data_ptr(),
                             peak.data_ptr(), out.data_ptr(), L, T, att, rel,
                             _one_minus(att), _one_minus(rel),
                             _build.stream_handle(dev))
    _build.check(err, "rt_limiter_env")
    global limiter_env_launches
    limiter_env_launches += 1
    return peak, (out[0], out[1])


def limiter_couple_gain(x, peak, peak0, group_channels: int):
    """The Limit node's gain from the peak envelopes peak [L, T] (carry-in
    peak0 [L]): within each group of ``group_channels`` lanes, channel c at
    frame t takes the max of the fresh peaks of channels <= c and the
    previous frame's of channels > c (the reference's interleaved order);
    then ``x * db_to_linear(-max_peak)``."""
    c, n = x.shape
    cg = group_channels
    if cg == 1:
        max_peak = peak  # per-channel groups: no coupling
    else:
        streams = c // cg
        peak_prev = torch.cat([peak0[:, None], peak[:, :-1]], dim=1)
        pg = peak.reshape(streams, cg, n)
        sg = peak_prev.reshape(streams, cg, n)
        fresh_cummax = torch.cummax(pg, dim=1).values
        stale_sufmax = torch.flip(
            torch.cummax(torch.flip(sg, [1]), dim=1).values, [1])
        stale_above = torch.cat(
            [stale_sufmax[:, 1:],
             torch.full((streams, 1, n), -float("inf"), dtype=x.dtype,
                        device=x.device)], dim=1)
        max_peak = torch.maximum(fresh_cummax, stale_above).reshape(c, n)
    return x * db_to_linear(-max_peak)


def limiter_stream_plain(x, integ0, peak0, *, att: float, rel: float,
                         threshold: float, knee_width: float,
                         inv_knee_8: float, group_channels: int):
    """The plain PyTorch version of :func:`limiter_stream`, on any device:
    the JAX ``Limit`` node's sequential path (rodio_tpu/effects/limit.py
    :166-212), one op at a time."""
    db = limiter_gain_db(x, threshold, knee_width, inv_knee_8)
    peak, carries = limiter_env_plain(db, integ0, peak0, att=att, rel=rel)
    return limiter_couple_gain(x, peak, peak0, group_channels), carries


def limiter_stream(x: torch.Tensor, integ0: torch.Tensor, peak0: torch.Tensor,
                   *, att: float, rel: float, threshold: float,
                   knee_width: float, inv_knee_8: float, group_channels: int):
    """The per-stream limiter over x [L, T] (lanes by time) in groups of
    ``group_channels`` consecutive lanes, from the envelope carries integ0,
    peak0 [L]: each sample's soft-knee gain in dB, the envelopes of
    :func:`limiter_env`, the gain coupled within each group (at frame t
    channel c takes the fresh peaks of channels <= c and the previous
    frame's of channels > c) and applied. Returns (y [L, T], (integ',
    peak')), the carries of the last step. T >= 1. On the card a group of
    at most 32 channels runs the whole pass in one kernel; a wider one runs
    its envelopes on :func:`limiter_env` and the gain computer, coupling
    and gain in torch around them."""
    cg = int(group_channels)
    if x.dim() != 2 or x.shape[1] < 1 or cg < 1 or x.shape[0] % cg:
        raise ValueError(f"limiter_stream: x must be [L, T >= 1] in groups of "
                         f"{cg} lanes, got {tuple(x.shape)}")
    kw = dict(att=att, rel=rel, threshold=threshold, knee_width=knee_width,
              inv_knee_8=inv_knee_8)
    if x.device.type == "cpu":
        return limiter_stream_plain(x, integ0, peak0, group_channels=cg, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"limiter_stream: unsupported device {x.device}")
    lib = _build.load_library()
    if cg > lib.rt_limiter_stream_max_group():  # wider than a chain warp
        db = limiter_gain_db(x, threshold, knee_width, inv_knee_8)
        peak, carries = limiter_env(db, integ0, peak0, att=att, rel=rel)
        return limiter_couple_gain(x, peak, peak0, cg), carries
    L, T = x.shape
    dev = x.device
    x = _build.f32_arg("x", x, dev, (L, T))
    integ0 = _build.f32_arg("integ0", integ0, dev, (L,))
    peak0 = _build.f32_arg("peak0", peak0, dev, (L,))
    y = torch.empty_like(x)
    out = torch.empty((2, L), dtype=torch.float32, device=dev)
    err = lib.rt_limiter_stream(x.data_ptr(), integ0.data_ptr(), peak0.data_ptr(),
                                y.data_ptr(), out.data_ptr(), L, T, cg, att, rel,
                                _one_minus(att), _one_minus(rel), threshold,
                                knee_width, inv_knee_8, LOG2_TO_DB, DB_TO_LOG2,
                                _build.stream_handle(dev))
    _build.check(err, "rt_limiter_stream")
    global limiter_stream_launches
    limiter_stream_launches += 1
    return y, (out[0], out[1])


def rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), each correctly rounded (the kernels' ``rsqrt_rn``)."""
    return 1.0 / sqrt_rn(x)


def desired_gain(rs, pk, target, max_gain, floor, inv_window):
    """The AGC's desired gain from the running window sum ``rs`` and the
    peak ``pk`` (src/source/agc.rs:450-460, in the TPU kernels' form):
    ``max(min(rg, pg), floor)``, ``rg = target * rsqrt(rs * inv_window)``
    where rs > 0 (else max_gain), ``pg = min(target / pk, max_gain)`` where
    pk > 0 (else max_gain). Scalars are 0-dim f32 tensors."""
    rg = torch.where(rs > 0.0, target * rsqrt_rn(rs * inv_window), max_gain)
    pg = torch.where(pk > 0.0, torch.minimum(target / pk, max_gain), max_gain)
    return torch.maximum(torch.minimum(rg, pg), floor)


def smooth_gain(g, des, att, rel, max_gain):
    """One step of the dual-rate gain smoother (src/source/agc.rs:486-496):
    ``clip(g*speed + des*(1-speed), 0.1, max_gain)``, speed = att while
    des > g, else rel."""
    speed = torch.where(des > g, att, rel)
    v = g * speed + des * (1.0 - speed)
    # clamp compares with 0.1 rounded to f32, and passes NaN, as maxn does
    return torch.minimum(torch.clamp(v, min=0.1), max_gain)


def ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n for an int n >= 1 by binary powering, each product rounded in
    x's dtype: the products of JAX's ``lax.integer_pow`` and of the JAX
    package's ``_ipow`` (rodio_tpu/ops/fused.py:86)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def smooth_gains(des, g0, att, rel, max_gain):
    """The smoother run over des [L, T] from g0 [L]: the gains [L, T]."""
    g = g0
    out = []
    for t in range(des.shape[-1]):
        g = smooth_gain(g, des[:, t], att, rel, max_gain)
        out.append(g)
    return torch.stack(out, dim=-1) if out else torch.empty_like(des)


def _scalars(params, n: int, like: torch.Tensor) -> torch.Tensor:
    """``params`` (a sequence of floats or 0-dim tensors, or a tensor) as
    an f32 [n] tensor on ``like``'s device."""
    if isinstance(params, torch.Tensor):
        p = params.to(dtype=torch.float32, device=like.device).reshape(-1)
    else:
        p = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                         device=like.device).reshape(())
                         for v in params])
    if p.shape != (n,):
        raise ValueError(f"expected {n} parameters, got {tuple(p.shape)}")
    return p


def agc_plain(xs, delta, peak0, sum0, gain0, params):
    """The plain PyTorch version of K6, on any device."""
    att, rel, target, max_gain, floor, inv_window = _scalars(params, 6, xs)
    peak, rsum = peak0, sum0
    zero = torch.zeros_like(peak0)
    pks, rss = [], []
    for t in range(xs.shape[-1]):
        x = xs[:, t]
        coeff = torch.where(x > peak, zero, rel)
        peak = peak * coeff + x * (1.0 - coeff)
        rsum = rsum + delta[:, t]
        pks.append(peak)
        rss.append(rsum)
    if not pks:
        return torch.empty_like(xs), (peak0, sum0, gain0)
    des = desired_gain(torch.stack(rss, -1), torch.stack(pks, -1), target,
                       max_gain, floor, inv_window)
    g = smooth_gains(des, gain0, att, rel, max_gain)
    return g, (peak, rsum, g[:, -1])


def agc(xs: torch.Tensor, delta: torch.Tensor, peak0: torch.Tensor,
        sum0: torch.Tensor, gain0: torch.Tensor, params):
    """The AGC's per-sample loop over xs = |x| [L, M] and delta = sq - old
    [L, M] from the carries peak0, sum0, gain0 [L]; params = (att, rel,
    target, max_gain, floor, 1/window), floats, 0-dim tensors or an f32
    [6] tensor. Returns (gain_seq [L, M], (peak', sum', gain'))."""
    if xs.device.type == "cpu":
        return agc_plain(xs, delta, peak0, sum0, gain0, params)
    if xs.device.type != "cuda":
        raise ValueError(f"agc: unsupported device {xs.device}")
    if xs.dim() != 2:
        raise ValueError(f"agc: xs must be [L, M], got {tuple(xs.shape)}")
    L, M = xs.shape
    dev = xs.device
    xs = _build.f32_arg("xs", xs, dev, (L, M))
    delta = _build.f32_arg("delta", delta, dev, (L, M))
    carries = [_build.f32_arg(name, v, dev, (L,)) for name, v in
               (("peak0", peak0), ("sum0", sum0), ("gain0", gain0))]
    p = _build.f32_arg("params", _scalars(params, 6, xs), dev, (6,))
    g = torch.empty_like(xs)
    out = torch.empty((3, L), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = lib.rt_agc(xs.data_ptr(), delta.data_ptr(), p.data_ptr(),
                     *[c.data_ptr() for c in carries], g.data_ptr(),
                     out.data_ptr(), L, M, _build.stream_handle(dev))
    _build.check(err, "rt_agc")
    global agc_launches
    agc_launches += 1
    return g, (out[0], out[1], out[2])


def first_order_plain(a, b, init, c=None, *, op: str = "linear", params=()):
    """The plain PyTorch version of K7, on any device."""
    if op == "linear":
        return linear_scan(a, b, init)
    if op == "max_affine":
        return max_affine_scan(a, b, c, init)
    if op == "agc_gain":
        att, rel, max_gain = _scalars(params, 3, a)
        return smooth_gains(a, init, att, rel, max_gain)
    raise ValueError(f"unknown first-order op {op!r}")


def first_order(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                c: torch.Tensor = None, *, op: str = "linear", params=()):
    """A first-order recurrence over [L, T] from init [L]:

    - ``linear``:     y = a*y' + b
    - ``max_affine``: y = max(a, b + c*y')
    - ``agc_gain``:   the AGC's gain smoother toward a, ``params`` =
      (att, rel, max_gain) as data (b is not read)

    Returns y [L, T] (the carry is y[:, -1])."""
    if op not in FIRST_ORDER_OPS:
        raise ValueError(f"unknown first-order op {op!r}")
    if a.device.type == "cpu":
        return first_order_plain(a, b, init, c, op=op, params=params)
    if a.device.type != "cuda":
        raise ValueError(f"first_order: unsupported device {a.device}")
    if a.dim() != 2:
        raise ValueError(f"first_order: a must be [L, T], got {tuple(a.shape)}")
    L, T = a.shape
    dev = a.device
    a = _build.f32_arg("a", a, dev, (L, T))
    b = _build.f32_arg("b", b, dev, (L, T)) if op != "agc_gain" else a
    c = _build.f32_arg("c", c, dev, (L, T)) if op == "max_affine" else a
    init = _build.f32_arg("init", init, dev, (L,))
    p = (_build.f32_arg("params", _scalars(params, 3, a), dev, (3,))
         if op == "agc_gain" else init)
    y = torch.empty_like(a)
    lib = _build.load_library()
    err = lib.rt_first_order(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                             init.data_ptr(), p.data_ptr(), y.data_ptr(), L,
                             T, FIRST_ORDER_OPS.index(op),
                             _build.stream_handle(dev))
    _build.check(err, "rt_first_order")
    global first_order_launches
    first_order_launches += 1
    return y
