"""K1 and K2: the fused pipeline kernels (rodio_tpu/ops/fused.py).

K1 is the fused resample + gain + biquad + mix kernel.

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

K2, :func:`fused_resample_biquad_agc_mix` (``csrc/fused_agc.cu``), is K1
with a per-stream AGC between the biquad and the mix, the gain applied
after it; :func:`fused_resample_biquad_agc_mix_plain` is its plain version.
With ``agc_group`` = AG > 0 it runs K2's group branch, K2g
(``csrc/fused_agc_group.cu``): the AGC advances once per group of AG
frames and its ring holds one rounded group sum per stream.
``launches`` counts K1's launches, ``agc_launches`` K2's and
``agc_group_launches`` K2g's.
"""
from __future__ import annotations

import torch

from . import _build
from .cuda_scan import desired_gain, ipow, smooth_gains
from .scan import biquad_df1

#: kernel launches made by :func:`fused_resample_biquad_mix` (K1)
launches = 0
#: kernel launches made by :func:`fused_resample_biquad_agc_mix` (K2)
agc_launches = 0
#: ... and with ``agc_group`` > 0 (K2g, K2's group branch)
agc_group_launches = 0

#: frames of K2's RMS window: 8192 interleaved samples of a stereo stream
AGC_RING_FRAMES = 4096


def _lerp(pcm, left, wts):
    """[n, L] lerp ``wts[:, 0]*x[left] + wts[:, 1]*x[left+1]`` (rows past F
    read as zero)."""
    F = pcm.shape[0]

    def rows(idx):
        r = pcm[torch.clamp(idx, max=F - 1)]
        return torch.where((idx < F)[:, None], r, torch.zeros_like(r))

    return rows(left) * wts[:, 0:1] + rows(left + 1) * wts[:, 1:2]


def _lerp_gain(pcm, left, wts, gains):
    """[n, L] gained lerp: the gain after the lerp (``gain_post``)."""
    return _lerp(pcm, left, wts) * gains


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


def _interleave(v: torch.Tensor) -> torch.Tensor:
    """[S, 2, n] -> [S, 2n] in interleaved order (frame t: ch 0, then ch 1)."""
    S, C, n = v.shape
    return v.transpose(1, 2).reshape(S, C * n)


def _ring_rows(ring, rows, new, fresh):
    """The values leaving the window at ``rows`` of the ring: the ring's
    own, then, past its length, this block's ``new`` ones (``fresh`` = how
    many the ring holds)."""
    old = ring[rows[:fresh]].T
    if new.shape[1] > fresh:
        old = torch.cat([old, new[:, : new.shape[1] - fresh]], dim=1)
    return old


def _agc_group_plain(y, gains, agc, agc_params, ring, ring_row: int, ag: int):
    """K2g's AGC and mix over the biquad outputs y [L, n] (the group branch,
    rodio_tpu/ops/fused.py:652-764): returns (mix, agc', ring')."""
    L, n = y.shape
    S, G, Rg = L // 2, n // ag, AGC_RING_FRAMES // ag
    att, rel, target, max_gain, floor, inv_window = (
        agc_params[i] for i in range(6))
    yg = y.reshape(S, 2, G, ag)
    cur, mx = yg[..., 0] * yg[..., 0], torch.abs(yg[..., 0])
    for j in range(1, ag):                                   # frame order
        cur = cur + yg[..., j] * yg[..., j]
        mx = torch.maximum(mx, torch.abs(yg[..., j]))
    q = (cur[:, 0] + cur[:, 1]).to(ring.dtype)               # [S, G]
    ym = torch.maximum(mx[:, 0], mx[:, 1])
    rows = (torch.arange(G, device=y.device) + ring_row) % Rg
    d = q.float() - _ring_rows(ring, rows, q, min(G, Rg)).float()
    att_g, rel_g = ipow(att, 2 * ag), ipow(rel, 2 * ag)
    crel_g = 1.0 - rel_g
    rs, pk = agc[0], agc[1]
    rss, pks = [], []
    for k in range(G):
        rs = rs + d[:, k]
        pk = torch.maximum(ym[:, k], rel_g * pk + crel_g * ym[:, k])
        rss.append(rs)
        pks.append(pk)
    des = desired_gain(torch.stack(rss, -1), torch.stack(pks, -1), target,
                       max_gain, floor, inv_window)
    g = smooth_gains(des, agc[2], att_g, rel_g, max_gain)   # [S, G]
    gf = g.repeat_interleave(ag, dim=1)[:, None, :]          # the staircase
    out = y.reshape(S, 2, n) * gf * gains.reshape(S, 2, 1)
    new_ring = ring.clone()
    keep = min(G, Rg)
    new_ring[rows[G - keep:]] = q[:, G - keep:].T
    return out.sum(0), torch.stack([rs, pk, g[:, -1]]), new_ring


def fused_resample_biquad_agc_mix_plain(pcm, left, wts, *, gains, coeffs, bq,
                                        agc, agc_params, ring, ring_row: int,
                                        agc_group: int = 0):
    """The plain PyTorch version of K2 (and of K2g with ``agc_group``), on
    any device."""
    L = pcm.shape[1]
    n = left.shape[0]
    S = L // 2
    R = AGC_RING_FRAMES
    att, rel, target, max_gain, floor, inv_window = (
        agc_params[i] for i in range(6))
    v = _lerp(pcm, left, wts)                                # [n, L]
    y, st = biquad_df1(v.T, coeffs, tuple(bq))               # [L, n]
    if agc_group:
        mix, agc_out, new_ring = _agc_group_plain(
            y, gains, agc, agc_params, ring, ring_row, agc_group)
        return mix, torch.stack(st), agc_out, new_ring
    # the squares, rounded to the ring's type, and the ones leaving the
    # window: ring row (ring_row + t) % R, or this block's own 4096 frames
    # back
    q = (y * y).to(ring.dtype)                               # [L, n]
    rows = (torch.arange(n, device=pcm.device) + ring_row) % R
    old = _ring_rows(ring, rows, q, min(n, R))
    d = _interleave((q.float() - old.float()).reshape(S, 2, n))
    xs = _interleave(torch.abs(y).reshape(S, 2, n))
    crel = 1.0 - rel
    rs, pk = agc[0], agc[1]
    rss, pks = [], []
    for t in range(2 * n):
        rs = rs + d[:, t]
        x = xs[:, t]
        pk = torch.maximum(x, rel * pk + crel * x)
        rss.append(rs)
        pks.append(pk)
    des = desired_gain(torch.stack(rss, -1), torch.stack(pks, -1), target,
                       max_gain, floor, inv_window)
    g = smooth_gains(des, agc[2], att, rel, max_gain)        # [S, 2n]
    g3 = g.reshape(S, n, 2).transpose(1, 2)                  # [S, 2, n]
    out = y.reshape(S, 2, n) * g3 * gains.reshape(S, 2, 1)
    new_ring = ring.clone()
    keep = min(n, R)
    new_ring[rows[n - keep:]] = q[:, n - keep:].T
    return (out.sum(0), torch.stack(st), torch.stack([rs, pk, g[:, -1]]),
            new_ring)


def fused_resample_biquad_agc_mix(pcm: torch.Tensor, left: torch.Tensor,
                                  wts: torch.Tensor, *, gains: torch.Tensor,
                                  coeffs: torch.Tensor, bq: torch.Tensor,
                                  agc: torch.Tensor, agc_params: torch.Tensor,
                                  ring: torch.Tensor, ring_row: int,
                                  agc_group: int = 0):
    """One block of the fused AGC pipeline (stereo streams, lane 2s + c).

    pcm, left, wts, coeffs, bq: as :func:`fused_resample_biquad_mix`.
    gains: [L], applied after the AGC. agc: [3, S] per-stream carries
    (rms_sum, peak, gain). agc_params: f32 [6] (att, rel, target, max_gain,
    floor, 1/8192). ring: [4096, L] f32 or bf16, row f % 4096 holding the
    rounded square of global frame f - 4096 for the frames to come;
    ring_row: the block's first global frame mod 4096 (a host int).

    ``agc_group`` = AG > 0 (K2g): the AGC steps once per group of AG frames
    of the block, which must hold whole groups (n % AG == 0; AG divides
    4096). ring is then [4096 // AG, S], row k % (4096 // AG)
    holding the rounded sum of squares of global group k - 4096 // AG, and
    ring_row the block's first global group mod 4096 // AG.

    Returns (mix [2, n], bq' [4, L], agc' [3, S], ring'); the input ring is
    left as it was."""
    ag = int(agc_group)
    R = AGC_RING_FRAMES
    n = left.shape[0]
    if ag and (ag < 2 or R % ag or n % ag):
        raise ValueError(
            f"agc_group {ag} must be >= 2, divide the RMS window {R} and the "
            f"block {n}")
    if pcm.device.type == "cpu":
        return fused_resample_biquad_agc_mix_plain(
            pcm, left, wts, gains=gains, coeffs=coeffs, bq=bq, agc=agc,
            agc_params=agc_params, ring=ring, ring_row=ring_row,
            agc_group=ag)
    if pcm.device.type != "cuda":
        raise ValueError(
            f"fused_resample_biquad_agc_mix: unsupported device {pcm.device}")
    F, L = pcm.shape
    rows = R // ag if ag else R
    if L < 2 or L % 2 or n < 1 or F < 1 or not 0 <= ring_row < rows:
        raise ValueError(
            f"fused_resample_biquad_agc_mix: need stereo lanes (L even), "
            f"n >= 1, F >= 1 and 0 <= ring_row < {rows}; got L={L}, n={n}, "
            f"F={F}, ring_row={ring_row}")
    if ring.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ring must be float32 or bfloat16, got {ring.dtype}")
    dev = pcm.device
    pcm = _build.f32_arg("pcm", pcm, dev, (F, L))
    left = _build.i64_arg("left", left, dev, (n,))
    wts = _build.f32_arg("wts", wts, dev, (n, 2))
    gains = _build.f32_arg("gains", gains, dev, (L,))
    coeffs = _build.f32_arg("coeffs", coeffs, dev, (5,))
    bq = _build.f32_arg("bq", bq, dev, (4, L))
    agc = _build.f32_arg("agc", agc, dev, (3, L // 2))
    agc_params = _build.f32_arg("agc_params", agc_params, dev, (6,))
    ring_shape = (rows, L // 2) if ag else (R, L)
    if ring.device != dev or tuple(ring.shape) != ring_shape:
        raise ValueError(f"ring must be {ring_shape} on {dev}, got "
                         f"{tuple(ring.shape)} on {ring.device}")
    # the kernel reads and rewrites its rows in place, on a copy (8 MB at
    # 1024 lanes in bf16), so the state passed in stays valid
    new_ring = ring.clone(memory_format=torch.contiguous_format)
    lib = _build.load_library()
    nblk = -(-L // lib.rt_fused_agc_block_lanes())
    partial = torch.empty((nblk, 2, n), dtype=torch.float32, device=dev)
    mix = torch.empty((2, n), dtype=torch.float32, device=dev)
    bq_out = torch.empty_like(bq)
    agc_out = torch.empty_like(agc)
    args = (pcm.data_ptr(), F, L, left.data_ptr(), wts.data_ptr(),
            gains.data_ptr(), coeffs.data_ptr(), bq.data_ptr(),
            bq_out.data_ptr(), agc.data_ptr(), agc_out.data_ptr(),
            agc_params.data_ptr(), new_ring.data_ptr(),
            int(ring.dtype == torch.bfloat16), ring_row)
    tail = (partial.data_ptr(), mix.data_ptr(), n, _build.stream_handle(dev))
    global agc_launches, agc_group_launches
    if ag:
        err = lib.rt_fused_resample_biquad_agc_group_mix(*args, ag, *tail)
        _build.check(err, "rt_fused_resample_biquad_agc_group_mix")
        agc_group_launches += 1
    else:
        err = lib.rt_fused_resample_biquad_agc_mix(*args, *tail)
        _build.check(err, "rt_fused_resample_biquad_agc_mix")
        agc_launches += 1
    return mix, bq_out, agc_out, new_ring
