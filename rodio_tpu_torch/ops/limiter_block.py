"""K3 and K8: the blocked scans of rodio_tpu/ops/limiter_block.py.

K3 is the blocked stereo master-bus limiter.

The limiter (src/source/limit.rs:854-930) is, per channel, a soft-knee dB
gain computer, a max-affine integrator ``integ = max(db, rel*integ' +
(1-rel)*db)``, a linear peak envelope ``peak = att*peak' + (1-att)*integ``
and the coupled gain. Both recurrences have constant coefficients, so time
is cut into P chunks of Lc = T/P rows: local prefix maps per chunk, log2 P
combine rounds across chunks, then the carry-in with rel^(t+1) / att^(t+1)
tables made in float64 on the host. Sequential depth Lc + log2 P, not T.

:func:`limiter_master` runs ``csrc/limiter_block.cu`` on a CUDA tensor and
:func:`limiter_master_plain`, the same blocked algorithm vectorised in
PyTorch with the same rounding order, on a CPU tensor.

K8, :func:`blocked_max_affine_const` (``csrc/bma.cu``), is the same blocked
order for one max-affine recurrence with its coefficient as data: the
AGC's peak detector. ``launches`` counts K3's launches, ``bma_launches``
K8's; ``f64_launches`` and ``bma_f64_launches`` their f64 instances'
(``set_float64``: the same kernels on f64 blocks, every op in f64, the
power tables f64).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.math import (TINY, db_to_log2_scale, exp2_precise, linear_to_db,
                         log2_to_db_scale)
from . import _build

#: kernel launches made by :func:`limiter_master` (K3)
launches = 0
#: kernel launches made by :func:`blocked_max_affine_const` (K8)
bma_launches = 0
#: kernel launches of K3's f64 instance
f64_launches = 0
#: kernel launches of K8's f64 instance
bma_f64_launches = 0

_BIG = 3.0e38


def _host(v: float, dtype: torch.dtype) -> float:
    """v rounded to ``dtype`` (f32; f64 keeps it)."""
    return v if dtype == torch.float64 else float(np.float32(v))


def limiter_gain_db(x, threshold: float, knee_width: float, inv_knee_8: float):
    """Soft-knee gain computer (src/source/limit.rs:854-873), elementwise."""
    bias_db = linear_to_db(torch.abs(x) + TINY) - threshold
    kb = bias_db * 2.0
    xk = kb + knee_width
    quad = xk * xk * inv_knee_8
    zero = torch.zeros_like(kb)
    return torch.where(kb < -knee_width, zero,
                       torch.where(torch.abs(kb) <= knee_width, quad, bias_db))


@functools.lru_cache(maxsize=32)
def _power_tables(att: float, rel: float, Lc: int, device: torch.device,
                  dtype: torch.dtype = torch.float32):
    """(rel^(t+1), att^(t+1)) for t < Lc, made in float64, stored in
    ``dtype`` (the block's: f32, or f64)."""
    tt = np.arange(1, Lc + 1, dtype=np.float64)
    return tuple(
        torch.from_numpy(np.power(float(c), tt)).to(device, dtype)
        for c in (rel, att)
    )


def _check_shape(x: torch.Tensor, P: int):
    C, T = x.shape
    if C != 2 or T % P or P > 128 or P & (P - 1) or P < 1:
        raise ValueError(
            f"limiter_master needs x [2, T] with T % P == 0 and P a power of "
            f"two <= 128; got {tuple(x.shape)}, P={P}"
        )
    return T // P


def limiter_master_plain(x, integ0, peak0, *, att: float, rel: float,
                         threshold: float, knee_width: float,
                         inv_knee_8: float, P: int):
    """The plain PyTorch version of K3, on any device."""
    Lc = _check_shape(x, P)
    T = x.shape[1]
    dt = x.dtype
    relpow, attpow = _power_tables(att, rel, Lc, x.device, dt)
    cr, ca = _host(1.0 - rel, dt), _host(1.0 - att, dt)
    x3 = x.reshape(2, P, Lc)  # x3[c, p, t] = x[c, p*Lc + t]
    d = limiter_gain_db(x3, threshold, knee_width, inv_knee_8)
    lane = torch.arange(P, device=x.device)

    # pass 1: local prefix maps of the integrator
    B = torch.full((2, P), -_BIG, dtype=x.dtype, device=x.device)
    Cv = torch.zeros_like(B)
    bs, cs = [], []
    for t in range(Lc):
        dt_ = d[:, :, t]
        B = torch.maximum(dt_, B * rel + dt_ * cr)
        Cv = Cv * rel + dt_ * cr
        bs.append(B)
        cs.append(Cv)
    b_all, c_all = torch.stack(bs, -1), torch.stack(cs, -1)

    # chunk combine (integ)
    A = torch.full_like(B, _host(rel ** Lc, dt))
    k = 1
    while k < P:
        As, Bs, Cs = (torch.roll(v, k, 1) for v in (A, B, Cv))
        m = lane >= k
        B, Cv, A = (torch.where(m, torch.maximum(B, A * Bs + Cv), B),
                    torch.where(m, A * Cs + Cv, Cv),
                    torch.where(m, A * As, A))
        k *= 2
    i0 = integ0[:, None].expand(2, P)
    As, Bs, Cs = (torch.roll(v, 1, 1) for v in (A, B, Cv))
    v_integ = torch.where(lane == 0, i0, torch.maximum(Bs, As * i0 + Cs))

    # pass 2: integ carry applied; local maps of the peak envelope
    integ = torch.maximum(b_all, relpow * v_integ[:, :, None] + c_all)
    Cp = torch.zeros_like(B)
    cps = []
    for t in range(Lc):
        Cp = Cp * att + integ[:, :, t] * ca
        cps.append(Cp)
    cp_all = torch.stack(cps, -1)

    # chunk combine (peak)
    A2 = torch.full_like(B, _host(att ** Lc, dt))
    C2 = Cp
    k = 1
    while k < P:
        As, Cs = torch.roll(A2, k, 1), torch.roll(C2, k, 1)
        m = lane >= k
        C2, A2 = torch.where(m, A2 * Cs + C2, C2), torch.where(m, A2 * As, A2)
        k *= 2
    p0 = peak0[:, None].expand(2, P)
    v_peak = torch.where(lane == 0, p0,
                         torch.roll(A2, 1, 1) * p0 + torch.roll(C2, 1, 1))

    # pass 3: peaks, stereo coupling (ch0 takes ch1's previous peak), gain
    peak = attpow * v_peak[:, :, None] + cp_all
    prev1 = torch.cat([v_peak[1][:, None], peak[1, :, :-1]], dim=1)
    mp = torch.stack([torch.maximum(peak[0], prev1),
                      torch.maximum(peak[0], peak[1])])
    y = x3 * exp2_precise(mp * -db_to_log2_scale(dt))
    return y.reshape(2, T), (integ[:, P - 1, Lc - 1], peak[:, P - 1, Lc - 1])


@functools.lru_cache(maxsize=None)
def _scratch_floats(T: int, P: int, dtype: torch.dtype = torch.float32) -> int:
    """The values (of ``dtype``) of global scratch K3 needs at (T, P), the
    kernel's own rule: 0 where it stages the block in shared memory, more
    for a block too long for that (it counts bytes, so an f64 block gives
    way at half the f32 length), whose per-chunk rows then live in global
    memory."""
    lib = _build.load_library()
    if dtype == torch.float64:
        return lib.rt_limiter_master_f64_scratch(T, P)
    return lib.rt_limiter_master_scratch_floats(T, P)


def limiter_master(x: torch.Tensor, integ0: torch.Tensor, peak0: torch.Tensor,
                   *, att: float, rel: float, threshold: float,
                   knee_width: float, inv_knee_8: float, P: int):
    """Whole master-bus limiter on x [2, T] -> (y [2, T], (integ', peak')).

    T % P == 0, P a power of two <= 128. The carries are those of the
    block's last sample. x and the carries f32, or f64 (K3's f64
    instance)."""
    if x.device.type == "cpu":
        return limiter_master_plain(
            x, integ0, peak0, att=att, rel=rel, threshold=threshold,
            knee_width=knee_width, inv_knee_8=inv_knee_8, P=P)
    if x.device.type != "cuda":
        raise ValueError(f"limiter_master: unsupported device {x.device}")
    Lc = _check_shape(x, P)
    T = x.shape[1]
    f64 = x.dtype == torch.float64
    dt = torch.float64 if f64 else torch.float32
    x = _build._typed_arg("x", x, dt, x.device, (2, T))
    integ0 = _build._typed_arg("integ0", integ0, dt, x.device, (2,))
    peak0 = _build._typed_arg("peak0", peak0, dt, x.device, (2,))
    relpow, attpow = _power_tables(att, rel, Lc, x.device, dt)
    y = torch.empty_like(x)
    carries = torch.empty((2, 2), dtype=dt, device=x.device)
    nscratch = _scratch_floats(T, P, dt)
    scratch = (torch.empty(nscratch, dtype=dt, device=x.device)
               if nscratch else None)
    name = "rt_limiter_master_f64" if f64 else "rt_limiter_master"
    err = getattr(_build.load_library(), name)(
        x.data_ptr(), y.data_ptr(), integ0.data_ptr(), peak0.data_ptr(),
        carries[0].data_ptr(), carries[1].data_ptr(), relpow.data_ptr(),
        attpow.data_ptr(), None if scratch is None else scratch.data_ptr(), T, P,
        att, rel, 1.0 - att, 1.0 - rel, att ** Lc, rel ** Lc,
        threshold, knee_width, inv_knee_8, log2_to_db_scale(dt),
        db_to_log2_scale(dt), _build.stream_handle(x.device),
    )
    _build.check(err, name)
    global launches, f64_launches
    if f64:
        f64_launches += 1
    else:
        launches += 1
    return y, (carries[0], carries[1])


def _check_bma_shape(x: torch.Tensor, P: int) -> int:
    if x.dim() != 2:
        raise ValueError(f"blocked_max_affine_const: x must be [L, M], got "
                         f"{tuple(x.shape)}")
    L, M = x.shape
    if not 1 <= L <= 8 or P < 1 or P > 128 or P & (P - 1) or M % P or M < P:
        raise ValueError(
            f"blocked_max_affine_const needs x [L, M] with L <= 8, M % P == 0 "
            f"and P a power of two <= 128; got {tuple(x.shape)}, P={P}")
    return M // P


def bma_power_table(a, Lc: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a^(t+1) for t < Lc on ``device`` (a float or a 0-dim tensor: a live
    knob stays on the card). One table serves K8 and its plain version, so
    they agree exactly. f32: made in float64 from the f32 coefficient and
    rounded (the JAX package makes it with an f32 ``cumprod``, a few ulp
    away). f64: an f64 ``cumprod``, as the JAX package's (one launch; XLA
    takes the products in another order, ulps apart)."""
    a64 = torch.as_tensor(a, device=device).to(torch.float64).reshape(())
    if dtype == torch.float64:
        return torch.cumprod(a64.expand(Lc), 0)
    tt = torch.arange(1, Lc + 1, dtype=torch.float64, device=device)
    return torch.pow(a64, tt).to(torch.float32)


def blocked_max_affine_const_plain(x, v0, a, *, P: int):
    """The plain PyTorch version of K8, on any device: the same blocked
    order, vectorised."""
    Lc = _check_bma_shape(x, P)
    L, M = x.shape
    pw = bma_power_table(a, Lc, x.device, x.dtype)
    av = pw[0]
    ca = 1.0 - av
    x3 = x.reshape(L, P, Lc)  # x3[r, p, t] = x[r, p*Lc + t]
    lane = torch.arange(P, device=x.device)

    # pass 1: local prefix maps of each chunk
    B = torch.full((L, P), -_BIG, dtype=x.dtype, device=x.device)
    Cv = torch.zeros_like(B)
    bs, cs = [], []
    for t in range(Lc):
        d = x3[:, :, t]
        B = torch.maximum(d, av * B + ca * d)
        Cv = av * Cv + ca * d
        bs.append(B)
        cs.append(Cv)
    b_all, c_all = torch.stack(bs, -1), torch.stack(cs, -1)

    # chunk combine: inclusive Hillis-Steele within each row
    A = pw[Lc - 1].expand(L, P)
    k = 1
    while k < P:
        As, Bs, Cs = (torch.roll(v, k, 1) for v in (A, B, Cv))
        m = lane >= k
        B, Cv, A = (torch.where(m, torch.maximum(B, A * Bs + Cv), B),
                    torch.where(m, A * Cs + Cv, Cv),
                    torch.where(m, A * As, A))
        k *= 2
    v = v0[:, None].expand(L, P)
    As, Bs, Cs = (torch.roll(t, 1, 1) for t in (A, B, Cv))
    v_in = torch.where(lane == 0, v, torch.maximum(Bs, As * v + Cs))

    # pass 2: the carry-in applied
    y = torch.maximum(b_all, pw * v_in[:, :, None] + c_all)
    return y.reshape(L, M)


@functools.lru_cache(maxsize=None)
def _bma_scratch_floats(L: int, M: int, P: int,
                        dtype: torch.dtype = torch.float32) -> int:
    """The values (of ``dtype``) of global scratch K8 needs for x [L, M] in
    chunks of M/P, the kernel's own rule: 0 where it stages each row in
    shared memory (it counts bytes, so f64 rows give way at half the f32
    length)."""
    lib = _build.load_library()
    if dtype == torch.float64:
        return lib.rt_blocked_max_affine_f64_scratch(L, M, P)
    return lib.rt_blocked_max_affine_scratch_floats(L, M, P)


def blocked_max_affine_const(x: torch.Tensor, v0: torch.Tensor, a, *, P: int):
    """y_t = max(x_t, a*y_{t-1} + (1-a)*x_t) over x [L, M] from v0 [L]
    (L <= 8, M % P == 0, P a power of two <= 128), sequential depth
    M/P + log2 P. ``a`` is a float or a 0-dim tensor (data: a live knob
    rebuilds nothing). Returns y [L, M]; the carry is y[:, -1]."""
    if x.device.type == "cpu":
        return blocked_max_affine_const_plain(x, v0, a, P=P)
    if x.device.type != "cuda":
        raise ValueError(f"blocked_max_affine_const: unsupported device {x.device}")
    Lc = _check_bma_shape(x, P)
    L, M = x.shape
    dev = x.device
    f64 = x.dtype == torch.float64
    dt = torch.float64 if f64 else torch.float32
    x = _build._typed_arg("x", x, dt, dev, (L, M))
    v0 = _build._typed_arg("v0", v0, dt, dev, (L,))
    pw = bma_power_table(a, Lc, dev, dt)
    y = torch.empty_like(x)
    nscratch = _bma_scratch_floats(L, M, P, dt)
    scratch = (torch.empty(nscratch, dtype=dt, device=dev)
               if nscratch else None)
    name = "rt_blocked_max_affine_f64" if f64 else "rt_blocked_max_affine"
    err = getattr(_build.load_library(), name)(
        x.data_ptr(), v0.data_ptr(), pw.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(), L, M, P,
        _build.stream_handle(dev))
    _build.check(err, name)
    global bma_launches, bma_f64_launches
    if f64:
        bma_f64_launches += 1
    else:
        bma_launches += 1
    return y
