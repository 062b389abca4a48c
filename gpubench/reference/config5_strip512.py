"""Plain reference of ``config5_strip512``: per lane the lerp resampler and
the low-pass; per stream rodio's automatic gain control over its
interleaved samples, then rodio's limiter; each stream's gain, the sum over
streams, the master limiter.

The AGC is ``config5_agc512``'s, batched over streams (its ``desired`` and
``smooth_streams``). The per-stream limiter is ``common.limiter``'s
arithmetic batched over streams (:func:`strip_gain`): the gain computer,
both envelopes in f64 by doubling, and the gain coupled over the stream's
two channels as the interleaved loop sees it. Lanes run in chunks of whole
streams for the filter, the desired gains and the limiter, so that the
limiter's doubling scans fit beside a job's corpus on the card; the gain
smoother runs once over all streams.

Departures from rodio (v0.22.2, ``src/source/agc.rs``,
``src/source/limit.rs``):

- the filter and the limiters' envelopes run in f64 with rodio's f32
  coefficients, and the AGC's RMS window is summed exactly in f64, where
  rodio keeps a running f32 sum; the AGC's gain smoother steps in f32 as
  rodio's does (``common``'s module docstring);
- the strip order is the configuration's ``assumed``: low-pass, AGC,
  limiter, gain, each stream's two channels interleaved frame by frame as
  rodio's ``Source`` yields them;
- the resampler is rodio's linear one with no drain frame: every output
  frame has both its lerp taps inside the slice.
"""
from __future__ import annotations

import torch

from gpubench.reference.common import (BIG, F32, F64, TINY, biquad, clamp_affine_scan,
                                       coefficient, f32, lerp_resample, limiter, low_pass, ratio,
                                       stage)
from gpubench.reference.config5_agc512 import desired, settings, smooth_streams


def strip_gain(x: torch.Tensor, rate: int, threshold=-1.0, knee_width=4.0,
               attack=0.005, release=0.1) -> torch.Tensor:
    """The linear gain of rodio's limiter (``LimitSettings::default()``) on
    each stream of x [R, C, T] (f64): [R, C, T], ``common.limiter``'s
    arithmetic along each stream, so that ``x * strip_gain(x)`` is
    ``common.limiter`` run stream by stream."""
    thr, knee = f32(threshold), f32(knee_width)
    inv_knee_8 = f32(F32(1.0) / (F32(8.0) * F32(knee_width)))
    att, rel = coefficient(attack, rate), coefficient(release, rate)
    bias = 20.0 * torch.log10(x.abs() + TINY) - thr
    kb = 2.0 * bias
    db = torch.where(kb < -knee, torch.zeros_like(kb),
                     torch.where(kb.abs() <= knee, (kb + knee) ** 2 * inv_knee_8, bias))
    integ = clamp_affine_scan(rel, (1.0 - rel) * db, db, BIG, 0.0)
    del bias, kb, db
    peak = clamp_affine_scan(att, (1.0 - att) * integ, -BIG, BIG, 0.0)
    del integ
    C = x.shape[1]
    prev = torch.cat([torch.zeros_like(peak[..., :1]), peak[..., :-1]], -1)
    worst = torch.empty_like(peak)
    for c in range(C):
        worst[:, c] = torch.cat([peak[:, :c + 1], prev[:, c + 1:]], 1).amax(1)
    return torch.pow(10.0, -worst / 20.0)


def render(lanes: torch.Tensor, gains, cfg: dict, n_out: int,
           store: torch.dtype = F64, chunk: int = 128) -> torch.Tensor:
    """lanes [streams * channels, frames] (stream-major rows, any float
    type, frames past the last right tap), gains [streams] -> the limited
    mix [channels, n_out], float64."""
    C = cfg["channels"]
    L = lanes.shape[0]
    S = L // C
    chunk -= chunk % C  # whole streams a chunk
    dev = lanes.device
    rate = cfg["out_rate"]
    fr, to = ratio(cfg["in_rate"], rate)
    coef = low_pass(rate, cfg["low_pass_hz"], cfg["low_pass_q"])
    att, rel, target, mg = settings(cfg)
    per_lane = torch.as_tensor(gains, dtype=F64).repeat_interleave(C).to(dev)
    ys = torch.empty((L, n_out), dtype=F64, device=dev)
    des = torch.empty((S, C * n_out), dtype=torch.float32, device=dev)
    for l0 in range(0, L, chunk):
        x = stage(lanes[l0:l0 + chunk].to(F64), store)
        y = stage(lerp_resample(x, fr, to, n_out), store)
        y = stage(biquad(y, coef), store)
        ys[l0:l0 + chunk] = y
        des[l0 // C:(l0 + y.shape[0]) // C] = desired(y.reshape(-1, C, n_out), rel, target, mg)
        del x, y
    g = smooth_streams(des, att, rel, mg)  # every stream at once
    del des
    mix = torch.zeros((C, n_out), dtype=F64, device=dev)
    for l0 in range(0, L, chunk):
        y = ys[l0:l0 + chunk].reshape(-1, C, n_out)
        s0, s1 = l0 // C, l0 // C + y.shape[0]
        y = stage(y * g[s0:s1].to(F64).reshape(-1, n_out, C).transpose(1, 2), store)
        y = stage(y * strip_gain(y, rate), store)
        mix += (y * per_lane[l0:l0 + chunk].reshape(-1, C, 1)).sum(0)
        del y
    mix = stage(mix, store)
    return stage(limiter(mix, rate), store)
