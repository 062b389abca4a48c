"""The plain reference's stages, in plain PyTorch, on any device.

This is the semantics of rodio's Source chain (v0.22.2) as the benchmark's
configurations use it, written from the rodio sources cited on each function
and from nothing of the program under test: the coefficients are synthesised
here in f32 as rodio synthesises them, and every recurrence runs on the
whole signal from the stream's start.

Precision. The stages compute in float64, with the f32 coefficients rodio
uses. The recurrences are solved by Hillis-Steele doubling: the biquad as the
powers of its 2x2 companion matrix, the limiter's and the AGC's envelopes as
compositions of maps ``y -> clamp(a*y + b, lo, hi)`` (a >= 0), a class that
is closed under composition. The one exception is the AGC's gain smoother,
which runs in f32, sequentially, in rodio's own operation order: with a
4-second attack its f32 steps (1 - att = 5.7e-6) stall within ~1 % of the
exact fixed point, which rodio and every f32 port share, so an exact smoother
would be a different result (its outputs would differ by ~1e-3).

``store`` is the type every block between two stages is stored in: float64
for the reference, bfloat16 for the lower-precision control (the step the
port's own ``block_bf16`` takes: round on store, full precision inside).
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32 = np.float32
F64 = torch.float64
#: finite stand-ins for +-inf in the clamp maps (0 * inf would be NaN)
BIG = 1e300
#: f32's smallest normal, added before the limiter's log (rodio's Sample::MIN_POSITIVE)
TINY = float(np.finfo(np.float32).tiny)


def stage(x: torch.Tensor, store: torch.dtype) -> torch.Tensor:
    """A block handed from one stage to the next, stored in ``store``."""
    return x if store == F64 else x.to(store).to(F64)


def f32(v) -> float:
    return float(F32(v))


def coefficient(seconds: float, rate: int, max_nanos: int | None = None) -> float:
    """rodio's smoothing coefficient e^(-1 / (secs * rate)) in f32
    (src/math.rs:111-113), secs being ``Duration::as_secs_f32`` of the
    setting's nanoseconds; 0 for a zero duration."""
    nanos = int(round(seconds * 1e9))
    if max_nanos is not None:
        nanos = min(nanos, max_nanos)
    secs = F32(nanos) / F32(1e9)
    denom = F32(secs * F32(rate))
    if denom == 0:
        return 0.0
    return float(F32(np.exp(F32(-1.0) / denom)))


def low_pass(rate: int, freq: float, q: float):
    """(b0, b1, b2, a1, a2) of rodio's low-pass biquad, synthesised in f32
    (src/source/blt.rs:502-545, the Audio EQ Cookbook), normalised by a0."""
    w0 = F32(F32(2.0) * F32(np.pi) * F32(freq) / F32(rate))
    alpha = F32(F32(np.sin(w0)) / F32(2.0 * F32(q)))
    cos_w0 = F32(np.cos(w0))
    b1 = F32(1.0) - cos_w0
    b0 = F32(b1 / F32(2.0))
    a0 = F32(1.0) + alpha
    a1 = F32(-2.0) * cos_w0
    a2 = F32(1.0) - alpha
    return tuple(float(F32(v / a0)) for v in (b0, b1, b0, a1, a2))


def ratio(from_rate: int, to_rate: int):
    g = math.gcd(from_rate, to_rate)
    return from_rate // g, to_rate // g


def lerp_resample(x: torch.Tensor, from_: int, to: int, n_out: int) -> torch.Tensor:
    """rodio's linear-interpolation resampler (src/conversions/sample_rate.rs:
    158, 173): output frame o, in chunk c = o // to at phase j = o % to,
    interpolates input frames left = c*from + (from*j)//to and left + 1 at
    the fraction ((from*j) % to) / to. x [L, F] with F > the last right tap."""
    o = torch.arange(n_out, device=x.device)
    j = o % to
    left = (o // to) * from_ + (from_ * j) // to
    frac = ((from_ * j) % to).to(F64) / to
    return x[:, left] * (1.0 - frac) + x[:, left + 1] * frac


def biquad(x: torch.Tensor, coef) -> torch.Tensor:
    """Direct form I from a zero state, y_t = b0 x_t + b1 x_{t-1} + b2 x_{t-2}
    - a1 y_{t-1} - a2 y_{t-2} (src/source/blt.rs:104-120), per row of x [L, T]:
    the FIR part at once, the recursion by doubling over (y_t, y_{t-1})."""
    b0, b1, b2, a1, a2 = coef
    T = x.shape[1]
    s0 = b0 * x
    s0[:, 1:] += b1 * x[:, :-1]
    s0[:, 2:] += b2 * x[:, :-2]
    s1 = torch.zeros_like(s0)
    m = ((-a1, -a2), (1.0, 0.0))
    d = 1
    while d < T:
        n0, n1 = s0.clone(), s1.clone()
        n0[:, d:].add_(s0[:, :-d], alpha=m[0][0]).add_(s1[:, :-d], alpha=m[0][1])
        n1[:, d:].add_(s0[:, :-d], alpha=m[1][0]).add_(s1[:, :-d], alpha=m[1][1])
        s0, s1 = n0, n1
        m = tuple(tuple(sum(m[i][k] * m[k][j] for k in range(2)) for j in range(2))
                  for i in range(2))
        d *= 2
    return s0


def clamp_affine_scan(a, b, lo, hi, init: float) -> torch.Tensor:
    """y_t = clamp(a_t * y_{t-1} + b_t, lo_t, hi_t) along the last axis from
    y_{-1} = init, for a_t >= 0 and lo_t <= hi_t (scalars broadcast). By
    doubling: g after f is clamp(ag*af*y + ag*bf + bg, clamp(ag*lof + bg),
    clamp(ag*hif + bg)), the outer clamps to [log, hig]."""
    b = torch.as_tensor(b, dtype=F64)
    shape = b.shape
    A, B, LO, HI = (torch.as_tensor(v, dtype=F64, device=b.device).expand(shape).clone()
                    for v in (a, b, lo, hi))
    T = shape[-1]
    d = 1
    while d < T:
        Al, Bl, LOl, HIl = A[..., d:], B[..., d:], LO[..., d:], HI[..., d:]
        nA = Al * A[..., :-d]
        nB = Al * B[..., :-d] + Bl
        nLO = torch.clamp(Al * LO[..., :-d] + Bl, LOl, HIl)
        nHI = torch.clamp(Al * HI[..., :-d] + Bl, LOl, HIl)
        A = torch.cat([A[..., :d], nA], -1)
        B = torch.cat([B[..., :d], nB], -1)
        LO = torch.cat([LO[..., :d], nLO], -1)
        HI = torch.cat([HI[..., :d], nHI], -1)
        d *= 2
    return torch.clamp(A * init + B, LO, HI)


def limiter(x: torch.Tensor, rate: int, threshold=-1.0, knee_width=4.0,
            attack=0.005, release=0.1) -> torch.Tensor:
    """rodio's limiter on one stream x [C, T] (src/source/limit.rs, defaults
    ``LimitSettings::default()``): the soft-knee gain computer in dB
    (:854-873), the max-affine integrator integ = max(db, rel*integ +
    (1-rel)*db), the peak envelope peak = att*peak + (1-att)*integ, both from
    0, and the gain coupled over the channels as the interleaved loop sees it:
    at frame t channel c takes the largest of the fresh peaks of channels <= c
    and the previous frame's of channels > c; y = x * 10^(-peak/20)."""
    thr, knee = f32(threshold), f32(knee_width)
    inv_knee_8 = f32(F32(1.0) / (F32(8.0) * F32(knee_width)))
    att, rel = coefficient(attack, rate), coefficient(release, rate)
    bias = 20.0 * torch.log10(x.abs() + TINY) - thr
    kb = 2.0 * bias
    db = torch.where(kb < -knee, torch.zeros_like(kb),
                     torch.where(kb.abs() <= knee, (kb + knee) ** 2 * inv_knee_8, bias))
    integ = clamp_affine_scan(rel, (1.0 - rel) * db, db, BIG, 0.0)
    peak = clamp_affine_scan(att, (1.0 - att) * integ, -BIG, BIG, 0.0)
    C = x.shape[0]
    prev = torch.cat([torch.zeros_like(peak[:, :1]), peak[:, :-1]], 1)
    worst = torch.empty_like(peak)
    for c in range(C):
        worst[c] = torch.cat([peak[:c + 1], prev[c + 1:]]).amax(0)
    return x * torch.pow(10.0, -worst / 20.0)


def smooth_f32(des: np.ndarray, att: float, rel: float, max_gain: float,
               g0: float = 1.0, lanes: int = 1024, block: int = 256) -> np.ndarray:
    """rodio's AGC gain smoother over des [m] (f32), each step in f32 in
    its order (src/source/agc.rs:486-496): speed = att if des > g else rel,
    g = min(max(g*speed + des*(1 - speed), 0.1), max_gain), from g0; the
    gains [m], the sequential recurrence's own.

    The steps run as ~``lanes`` chunks side by side, each from a guessed
    start (the clamped desired gain there), in passes: after a pass, a chunk
    whose start differs from its predecessor's last gain runs again from
    that gain, until its gains meet the previous pass's (from a step where
    they agree they agree to the chunk's end). When no start changes, each
    chunk continues its predecessor exactly, so the gains are the
    sequential recurrence's. A step with des <= g sets g = des whatever g
    was, so two runs of a chunk meet at a step that resets both: the passes
    end after the longest stretch without one (~2 s of stereo audio)."""
    f = np.float32
    a, r, mg, lo = f(att), f(rel), f(max_gain), f(0.1)
    ca, cr = f(1.0) - a, f(1.0) - r
    m = len(des)
    chunk = max(4096, -(-m // lanes))
    K = -(-m // chunk)
    D = np.full(K * chunk, mg, np.float32)
    D[:m] = des
    D = np.ascontiguousarray(D.reshape(K, chunk).T)  # [chunk, K]: a step's lanes contiguous
    G = np.empty_like(D)
    starts = np.clip(D[0], lo, mg)
    starts[0] = f(g0)
    active, first = np.arange(K), True
    while True:
        g, run = starts[active].copy(), active
        for t0 in range(0, chunk, block):
            if not len(run):
                break
            Da = D[t0:t0 + block, run]
            Ga = np.empty_like(Da)
            down = np.empty(len(run), bool)
            u, w = np.empty_like(g), np.empty_like(g)
            for t in range(len(Da)):
                d = Da[t]
                np.less_equal(d, g, out=down)
                np.add(np.multiply(g, a, out=u), np.multiply(d, ca, out=w), out=u)
                if r != 0:
                    np.add(np.multiply(g, r, out=w), d * cr, out=w)
                    np.copyto(u, w, where=down)
                else:  # g*0 + d*1 is d exactly
                    np.copyto(u, d, where=down)
                np.clip(u, lo, mg, out=g)
                Ga[t] = g
            met = None if first else g == G[t0 + len(Da) - 1, run]
            G[t0:t0 + len(Da), run] = Ga
            if met is not None:
                run, g = run[~met], g[~met]
        first = False
        new = np.concatenate([[f(g0)], G[-1, :-1]])
        changed = np.flatnonzero(new != starts)
        if not len(changed):
            return G.T.reshape(-1)[:m]
        starts, active = new, changed


def agc(x: torch.Tensor, rate: int, target_level=1.0, attack_time=4.0,
        release_time=0.0, absolute_max_gain=7.0) -> torch.Tensor:
    """rodio's automatic gain control on one stream x [C, T]
    (src/source/agc.rs, ``AutomaticGainControlSettings::default()``), over
    the interleaved samples: the peak detector (instant attack, release
    coefficient), the RMS over the last 8192 samples' squares, the desired
    gain max(min(target/rms, min(target/peak, max_gain)), 0) (:450-460),
    rounded to f32, the smoother (:486-496) in f32 (:func:`smooth_f32`),
    y = x * gain."""
    C, T = x.shape
    xi = x.T.reshape(-1)
    ax = xi.abs()
    att = coefficient(attack_time, rate, max_nanos=10_000_000_000)
    rel = coefficient(release_time, rate, max_nanos=10_000_000_000)
    target, mg = f32(target_level), f32(absolute_max_gain)
    peak = clamp_affine_scan(rel, (1.0 - rel) * ax, ax, BIG, 0.0)
    cs = torch.cumsum(ax * ax, 0)
    window = cs - torch.cat([torch.zeros(8192, dtype=F64, device=x.device), cs])[:cs.numel()]
    rms = torch.sqrt(torch.clamp(window, min=0.0) / 8192.0)
    rms_gain = torch.where(window > 0, target / rms, torch.full_like(rms, mg))
    peak_gain = torch.where(peak > 0, torch.clamp(target / peak, max=mg),
                            torch.full_like(peak, mg))
    des = torch.clamp(torch.minimum(rms_gain, peak_gain), min=0.0).to(torch.float32)
    gain = smooth_f32(des.cpu().numpy(), att, rel, mg)
    g = torch.from_numpy(gain.astype(np.float64)).to(x.device)
    return (xi * g).reshape(T, C).T
