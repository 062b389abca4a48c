"""K1: the fused resample + gain + biquad + mix kernel (rodio_tpu/ops/fused.py).

One pass per block over the time-major PCM ``pcm [F, L]`` (lane l = stream
s*C + c): for the block's output frames, whose left input frames and
phases ``conversions.resample.output_positions`` gives, the two-tap lerp with the f32
weights of the JAX lerp operator, the per-lane gain (after the lerp: the
JAX package's ``gain_post`` order), the DF-I biquad with carries across
blocks, and the sum over streams into C channels.

:func:`fused_resample_biquad_mix` runs ``csrc/fused.cu`` on CUDA tensors
and :func:`fused_resample_biquad_mix_plain` on CPU tensors. They agree up
to the order of the mix's sum (the kernel sums in a fixed order per block
of streams, then over blocks).
"""
from __future__ import annotations

import torch

from . import _build
from .scan import biquad_df1

#: kernel launches made by :func:`fused_resample_biquad_mix`
launches = 0


def _lerp_gain(pcm, left, wts, gains):
    """[n, L] gained lerp ``wts[:, 0]*x[left] + wts[:, 1]*x[left+1]`` (rows
    past F read as zero)."""
    F = pcm.shape[0]

    def rows(idx):
        r = pcm[torch.clamp(idx, max=F - 1)]
        return torch.where((idx < F)[:, None], r, torch.zeros_like(r))

    return (rows(left) * wts[:, 0:1] + rows(left + 1) * wts[:, 1:2]) * gains


def fused_resample_biquad_mix_plain(pcm, left, wts, *, gains, coeffs, bq,
                                    channels: int):
    """The plain PyTorch version of K1, on any device."""
    v = _lerp_gain(pcm, left, wts, gains)                    # [n, L]
    y, st = biquad_df1(v.T, coeffs, tuple(bq))               # [L, n]
    mix = y.reshape(-1, channels, v.shape[0]).sum(0)
    return mix, torch.stack(st)


def fused_resample_biquad_mix(pcm: torch.Tensor, left: torch.Tensor,
                              wts: torch.Tensor, *, gains: torch.Tensor,
                              coeffs: torch.Tensor, bq: torch.Tensor,
                              channels: int):
    """One block of the fused pipeline.

    pcm: [F, L] f32 time-major PCM (frame 0 = the stream's first frame).
    left: [n] int64, each output frame's left input frame, and wts: [n, 2]
    f32, its two lerp weights (``conversions.resample.output_positions``
    and ``lerp_weights``).
    gains: [L]; coeffs: [5] (b0, b1, b2, a1, a2); bq: [4, L] biquad carries
    (x1, x2, y1, y2). Returns (mix [C, n], bq' [4, L])."""
    if pcm.device.type == "cpu":
        return fused_resample_biquad_mix_plain(
            pcm, left, wts, gains=gains, coeffs=coeffs, bq=bq,
            channels=channels)
    if pcm.device.type != "cuda":
        raise ValueError(f"fused_resample_biquad_mix: unsupported device {pcm.device}")
    F, L = pcm.shape
    n = left.shape[0]
    C = int(channels)
    if not 1 <= C <= 32 or L % C or n < 1 or F < 1:
        raise ValueError(
            f"fused_resample_biquad_mix: need 1 <= C <= 32 dividing L, n >= 1 "
            f"and F >= 1; got C={C}, L={L}, n={n}, F={F}")
    dev = pcm.device
    pcm = _build.f32_arg("pcm", pcm, dev, (F, L))
    left = _build.i64_arg("left", left, dev, (n,))
    wts = _build.f32_arg("wts", wts, dev, (n, 2))
    gains = _build.f32_arg("gains", gains, dev, (L,))
    coeffs = _build.f32_arg("coeffs", coeffs, dev, (5,))
    bq = _build.f32_arg("bq", bq, dev, (4, L))
    lanes_per_block = 32 // C * C
    nblk = -(-L // lanes_per_block)
    partial = torch.empty((nblk, C, n), dtype=torch.float32, device=dev)
    mix = torch.empty((C, n), dtype=torch.float32, device=dev)
    bq_out = torch.empty_like(bq)
    lib = _build.load_library()
    err = lib.rt_fused_resample_biquad_mix(
        pcm.data_ptr(), F, L, left.data_ptr(), wts.data_ptr(),
        gains.data_ptr(), coeffs.data_ptr(), bq.data_ptr(), bq_out.data_ptr(),
        partial.data_ptr(), mix.data_ptr(), n, C, _build.stream_handle(dev),
    )
    _build.check(err, "rt_fused_resample_biquad_mix")
    global launches
    launches += 1
    return mix, bq_out
