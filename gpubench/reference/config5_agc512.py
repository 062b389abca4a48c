"""Plain reference of ``config5_agc512``: per lane the lerp resampler and
the low-pass; per stream rodio's automatic gain control over its
interleaved samples; each stream's gain, the sum over streams, the master
limiter.

The AGC is ``common.agc``'s, batched over streams: the peak detector and
the exact 8192-sample RMS window in f64, the desired gain rounded to f32,
and the gain smoother in f32 (:func:`smooth_streams`, ``common.smooth_f32``'s
chunked passes over every stream of a job at once, on the reference's
device). Lanes run in chunks for the filter and the desired gains; the
smoother runs once over all streams.

Departures from rodio (v0.22.2, ``src/source/agc.rs``):

- the filter runs in f64 with rodio's f32 coefficients, and the RMS window
  is summed exactly in f64, where rodio keeps a running f32 sum; the gain
  smoother steps in f32 as rodio's does (``common``'s module docstring);
- the AGC sits after the low-pass and before the stream's gain (the
  configuration's ``assumed``), each stream's two channels interleaved
  frame by frame as rodio's ``Source`` yields them;
- the resampler is rodio's linear one with no drain frame: every output
  frame has both its lerp taps inside the slice.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.common import (BIG, F64, biquad, clamp_affine_scan, coefficient, f32,
                                       lerp_resample, limiter, low_pass, ratio, stage)

#: samples in the AGC's RMS window (src/source/agc.rs RMS_WINDOW_SIZE)
WINDOW = 8192
#: the longest duration rodio turns into a coefficient (agc.rs clamps at 10 s)
MAX_NANOS = 10_000_000_000


def settings(cfg: dict):
    """(attack coefficient, release coefficient, target, max gain) of the
    configuration's AGC at its output rate, in f32 as rodio computes them."""
    rate = cfg["out_rate"]
    return (coefficient(cfg["agc_attack_time"], rate, max_nanos=MAX_NANOS),
            coefficient(cfg["agc_release_time"], rate, max_nanos=MAX_NANOS),
            f32(cfg["agc_target_level"]), f32(cfg["agc_absolute_max_gain"]))


def desired(x: torch.Tensor, rel: float, target: float, max_gain: float) -> torch.Tensor:
    """The AGC's desired gains of streams x [R, C, T] (f64) over their
    interleaved samples: [R, C*T] f32, ``common.agc``'s arithmetic along
    each row."""
    R, C, T = x.shape
    ax = x.transpose(1, 2).reshape(R, C * T).abs()
    peak = clamp_affine_scan(rel, (1.0 - rel) * ax, ax, BIG, 0.0)
    cs = torch.cumsum(ax * ax, -1)
    window = cs - torch.cat([torch.zeros((R, WINDOW), dtype=F64, device=x.device), cs],
                            -1)[:, :cs.shape[1]]
    rms = torch.sqrt(torch.clamp(window, min=0.0) / float(WINDOW))
    rms_gain = torch.where(window > 0, target / rms, torch.full_like(rms, max_gain))
    peak_gain = torch.where(peak > 0, torch.clamp(target / peak, max=max_gain),
                            torch.full_like(peak, max_gain))
    return torch.clamp(torch.minimum(rms_gain, peak_gain), min=0.0).to(torch.float32)


def smooth_streams(des: torch.Tensor, att: float, rel: float, max_gain: float,
                   g0: float = 1.0, chunk: int = 4096, block: int = 256) -> torch.Tensor:
    """rodio's gain smoother over each row of des [R, m] (f32), every step in
    f32 in its order (src/source/agc.rs:486-496), each row from g0: the
    gains [R, m], each row the sequential recurrence's own.

    ``common.smooth_f32``'s passes, over the chunks of every row side by
    side: a row's first chunk starts from g0, every other chunk from a guess
    (its clamped first desired gain); after a pass, a chunk whose start
    differs from its predecessor's last gain runs again from that gain until
    it meets the previous pass's gains at the end of a ``block`` of steps;
    when no start changes the gains are the recurrence's. A step is one f32
    multiply and one f32 add for each product, never a fused multiply-add."""
    R, m = des.shape
    dev = des.device
    a, r = np.float32(att), np.float32(rel)
    ca, cr = float(np.float32(1.0) - a), float(np.float32(1.0) - r)
    a, r, lo, mg = float(a), float(r), float(np.float32(0.1)), float(np.float32(max_gain))
    K = -(-m // chunk)
    D = torch.full((R, K * chunk), mg, dtype=torch.float32, device=dev)
    D[:, :m] = des
    D = D.reshape(R * K, chunk).T.contiguous()  # [chunk, R*K]: a step's lanes contiguous
    G = torch.empty_like(D)
    head = torch.arange(R * K, device=dev) % K == 0  # a row's first chunk
    g0_t = torch.full((R * K,), float(np.float32(g0)), dtype=torch.float32, device=dev)
    starts = torch.where(head, g0_t, torch.clamp(D[0], lo, mg))
    active, first = torch.arange(R * K, device=dev), True
    while True:
        g, run = starts[active].clone(), active
        for t0 in range(0, chunk, block):
            if not run.numel():
                break
            Da = D[t0:t0 + block].index_select(1, run)
            Ga = torch.empty_like(Da)
            u, w = torch.empty_like(g), torch.empty_like(g)
            for t in range(Da.shape[0]):
                d = Da[t]
                torch.add(torch.mul(g, a, out=u), torch.mul(d, ca, out=w), out=u)
                if r != 0:
                    torch.add(torch.mul(g, r, out=w), torch.mul(d, cr), out=w)
                    u = torch.where(d <= g, w, u)
                else:  # g*0 + d*1 is d exactly
                    u = torch.where(d <= g, d, u)
                g = torch.clamp(u, lo, mg, out=Ga[t])
            met = None if first else g == G[t0 + Da.shape[0] - 1].index_select(0, run)
            G[t0:t0 + Da.shape[0]].index_copy_(1, run, Ga)
            if met is not None:
                run, g = run[~met], g[~met]
        first = False
        new = torch.where(head, g0_t, torch.roll(G[-1], 1))
        changed = torch.nonzero(new != starts).flatten()
        if not changed.numel():
            return G.T.reshape(R, K * chunk)[:, :m].contiguous()
        starts, active = new, changed


def agc(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """rodio's AGC on each stream of x [R, C, T] (f64): [R, C, T] f64."""
    att, rel, target, mg = settings(cfg)
    R, C, T = x.shape
    g = smooth_streams(desired(x, rel, target, mg), att, rel, mg)
    return x * g.to(F64).reshape(R, T, C).transpose(1, 2)


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
    fr, to = ratio(cfg["in_rate"], cfg["out_rate"])
    coef = low_pass(cfg["out_rate"], cfg["low_pass_hz"], cfg["low_pass_q"])
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
        mix += (y * per_lane[l0:l0 + chunk].reshape(-1, C, 1)).sum(0)
        del y
    mix = stage(mix, store)
    return stage(limiter(mix, cfg["out_rate"]), store)
