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

With an ``agc_plan`` of :data:`AGC_REL0_PLANS` it runs one of K2's rel0
plans, the JAX package's schedules for a release coefficient of exactly 0
(rodio_tpu/ops/fused.py:782-1158): the peak detector is memoryless and the
smoother a clamp of an affine map, ``g' = max(0.1, min(d, att*g +
(1-att)*d))``. ``rel0`` and ``rel0f`` step it sample by sample (K2r,
``csrc/fused_agc.cu``); ``rel0b*`` and ``rel0c*`` compose the maps within
chunks of the JAX pipeline's grid steps and thread the gain through the
chunk totals only (K2b, ``csrc/fused_agc_blocked.cu``).

With ``ring=True`` (K1's ring mode, the farm's ``FusedFarmPipeline``) the
PCM is a rolling ring of R rows: input row r is ring row r mod R, and no
row reads as zero (rodio_tpu/ops/fused.py:300-309, ``ring_chunks``).

``utils.trace.counts`` counts each launch under its entry point's name:
K1 ``rt_fused_resample_biquad_mix`` (``..._mix_ring`` in ring mode), K2
``rt_fused_resample_biquad_agc_mix``, K2g ``..._agc_group_mix``, K2r
``..._agc_rel0_mix`` and K2b ``..._agc_blocked_mix``.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from .cuda_scan import desired_gain, ipow, rsqrt_rn, smooth_gains
from .scan import biquad_df1

#: the fewest rows K1's ring mode takes (a tile stages at most this many)
RING_MIN_ROWS = 192
#: frames of K2's RMS window: 8192 interleaved samples of a stereo stream
AGC_RING_FRAMES = 4096

#: K2's plans for a release coefficient of exactly 0 (the JAX package's
#: ``agc_plan`` values, rodio_tpu/flagship.py:403-406)
AGC_REL0_PLANS = ("rel0", "rel0f", "rel0b", "rel0b16", "rel0b32", "rel0b64",
                  "rel0c", "rel0c8", "rel0c16", "rel0c32")
#: the longest chunk K2b takes on the card (its power table's length)
AGC_BLOCKED_MAX_CHUNK = 256


def rel0_chunks(plan: str) -> int:
    """Chunks per grid step (RPC) of a blocked rel0 plan: 8 for ``rel0b``,
    16 for ``rel0c``, else the number in the name; 0 for ``rel0`` and
    ``rel0f``, which step sample by sample."""
    if plan not in AGC_REL0_PLANS:
        raise ValueError(f"unknown rel0 plan {plan!r}")
    if plan in ("rel0", "rel0f"):
        return 0
    return int(plan[5:]) if len(plan) > 5 else (16 if plan[4] == "c" else 8)


def _lerp(pcm, left, wts, ring: bool = False):
    """[n, L] lerp ``wts[:, 0]*x[left] + wts[:, 1]*x[left+1]`` (rows past F
    read as zero; with ``ring`` row r reads row r mod F)."""
    F = pcm.shape[0]

    def rows(idx):
        if ring:
            return pcm[idx % F]
        r = pcm[torch.clamp(idx, max=F - 1)]
        return torch.where((idx < F)[:, None], r, torch.zeros_like(r))

    return rows(left) * wts[:, 0:1] + rows(left + 1) * wts[:, 1:2]


def _lerp_gain(pcm, left, wts, gains, ring: bool = False):
    """[n, L] gained lerp: the gain after the lerp (``gain_post``)."""
    return _lerp(pcm, left, wts, ring) * gains


def fused_resample_biquad_mix_plain(pcm, left, wts, *, gains, coeffs, bq,
                                    channels: int, ring: bool = False):
    """The plain PyTorch version of K1 (and of its ring mode), on any
    device."""
    v = _lerp_gain(pcm, left, wts, gains, ring)              # [n, L]
    y, st = biquad_df1(v.T, coeffs, tuple(bq))               # [L, n]
    mix = y.reshape(-1, channels, v.shape[0]).sum(0)
    return mix, torch.stack(st)


@functools.lru_cache(maxsize=None)
def _block_lanes(C: int) -> int:
    """K1's lanes per block for C channels, the kernel's own rule: its
    partials hold ceil(L / this) rows."""
    return _build.load_library().rt_fused_block_lanes(C)


def fused_resample_biquad_mix(pcm: torch.Tensor, left: torch.Tensor,
                              wts: torch.Tensor, *, gains: torch.Tensor,
                              coeffs: torch.Tensor, bq: torch.Tensor,
                              channels: int, ring: bool = False):
    """One block of the fused pipeline.

    pcm: [F, L] f32 time-major PCM (frame 0 = the stream's first frame);
    with ``ring`` a rolling ring of F >= :data:`RING_MIN_ROWS` rows, input
    row r at ring row r mod F (K1's ring mode).
    left: [n] int64, each output frame's left input frame, and wts: [n, 2]
    f32, its two lerp weights (``conversions.resample.output_positions``
    and ``lerp_weights``).
    gains: [L]; coeffs: [5] (b0, b1, b2, a1, a2); bq: [4, L] biquad carries
    (x1, x2, y1, y2). Returns (mix [C, n], bq' [4, L])."""
    F, L = pcm.shape
    if ring and F < RING_MIN_ROWS:
        raise ValueError(f"fused_resample_biquad_mix: a ring of {F} rows; ring "
                         f"mode takes at least {RING_MIN_ROWS}")
    if pcm.device.type == "cpu":
        return fused_resample_biquad_mix_plain(
            pcm, left, wts, gains=gains, coeffs=coeffs, bq=bq,
            channels=channels, ring=ring)
    if pcm.device.type != "cuda":
        raise ValueError(f"fused_resample_biquad_mix: unsupported device {pcm.device}")
    _build.refuse_f64("fused_resample_biquad_mix", pcm, "ROADMAP F8")
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
    nblk = -(-L // _block_lanes(C))
    partial = torch.empty((nblk, C, n), dtype=torch.float32, device=dev)
    mix = torch.empty((C, n), dtype=torch.float32, device=dev)
    bq_out = torch.empty_like(bq)
    _build.launch(
        "rt_fused_resample_biquad_mix" + ("_ring" if ring else ""),
        pcm.data_ptr(), F, L, left.data_ptr(), wts.data_ptr(),
        gains.data_ptr(), coeffs.data_ptr(), bq.data_ptr(), bq_out.data_ptr(),
        partial.data_ptr(), mix.data_ptr(), n, C, device=dev)
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


def _rel0_window(dlo, dhi, rs, chunk: int):
    """The window sums of the two sub-steps of every frame, [S, n] each,
    and the carry: ``rs + dlo``, then ``rs += dhi``; with ``chunk`` (rel0c)
    a prefix from zero within each chunk of that many frames plus the
    chunk's base, the bases chained over the chunks (rodio_tpu/ops/fused.py
    :979-1029)."""
    S, n = dlo.shape
    if not chunk:
        los, his = [], []
        for t in range(n):
            los.append(rs + dlo[:, t])
            rs = rs + dhi[:, t]
            his.append(rs)
        return torch.stack(los, 1), torch.stack(his, 1), rs
    nc = n // chunk
    dl, dh = dlo.reshape(S, nc, chunk), dhi.reshape(S, nc, chunk)
    acc = torch.zeros_like(dl[..., 0])
    los, his = [], []
    for r in range(chunk):
        los.append(acc + dl[..., r])
        acc = acc + dh[..., r]
        his.append(acc)
    bases = []
    for c in range(nc):
        bases.append(rs)
        rs = rs + acc[:, c]
    base = torch.stack(bases, 1)[..., None]
    return ((torch.stack(los, -1) + base).reshape(S, n),
            (torch.stack(his, -1) + base).reshape(S, n), rs)


def _rel0_blocked_gains(des, g, att, max_gain, chunk: int):
    """The blocked smoother (rodio_tpu/ops/fused.py:1062-1139) over the
    desired gains des [S, 2, n] from the carry g [S]: each sub-step's map
    ``f(g) = min(H, max(0.1, att*g + B))``, B = (1-att)*des, H = max(0.1,
    des), composed within each chunk from (B, L, H) = (0, 0, max_gain)
    (pass 2), g threaded through the chunk totals with att^(2*chunk)
    (pass 3), every gain rebuilt from its chunk's first g (pass 4).
    Returns (gains [S, 2, n], g')."""
    S, _, n = des.shape
    nc = n // chunk
    Bv = ((1.0 - att) * des).reshape(S, 2, nc, chunk)
    Hv = torch.clamp(des, min=0.1).reshape(S, 2, nc, chunk)
    Bc = Lc = torch.zeros_like(Bv[:, 0, :, 0])
    Hc = torch.zeros_like(Bc) + max_gain
    maps = []
    for j in range(chunk):
        bl, bh = Bv[:, 0, :, j], Bv[:, 1, :, j]
        Bl = att * Bc + bl
        Ll = torch.clamp(att * Lc + bl, min=0.1)
        Hl = torch.minimum(Hv[:, 0, :, j], torch.clamp(att * Hc + bl, min=0.1))
        Bc = att * Bl + bh
        Lc = torch.clamp(att * Ll + bh, min=0.1)
        Hc = torch.minimum(Hv[:, 1, :, j], torch.clamp(att * Hl + bh, min=0.1))
        maps.append(((Bl, Ll, Hl), (Bc, Lc, Hc)))
    att_r = ipow(att, 2 * chunk)
    g0 = []
    for c in range(nc):
        g0.append(g)
        g = torch.minimum(Hc[:, c], torch.maximum(Lc[:, c], att_r * g + Bc[:, c]))
    g0 = torch.stack(g0, 1)
    ap = att
    out = []
    for (Bl, Ll, Hl), (Bh, Lh, Hh) in maps:
        ap2 = ap * att
        out.append(torch.stack([
            torch.minimum(Hl, torch.maximum(Ll, ap * g0 + Bl)),
            torch.minimum(Hh, torch.maximum(Lh, ap2 * g0 + Bh))], 1))
        ap = ap2 * att
    return torch.stack(out, -1).reshape(S, 2, n), g


def _agc_rel0_plain(y, agc, agc_params, ring, ring_row: int, plan: str,
                    step_frames: int):
    """K2's AGC under a rel0 plan over the biquad outputs y [L, n]: returns
    (the AGC's gains [S, 2, n], agc', ring'), in the JAX package's op order
    (rodio_tpu/ops/fused.py:782-1158)."""
    L, n = y.shape
    S, R = L // 2, AGC_RING_FRAMES
    att, _, target, max_gain, floor, inv_window = (agc_params[i] for i in range(6))
    y3 = y.reshape(S, 2, n)
    sq = y * y
    if plan != "rel0":  # the packed basis: (sq0, sq0 + sq1) per stream
        sq3 = sq.reshape(S, 2, n)
        sq = torch.stack([sq3[:, 0], sq3[:, 0] + sq3[:, 1]], 1).reshape(L, n)
    q = sq.to(ring.dtype)
    rows = (torch.arange(n, device=y.device) + ring_row) % R
    d = (q.float() - _ring_rows(ring, rows, q, min(n, R)).float()).reshape(S, 2, n)
    dlo, dhi = d[:, 0], d[:, 1]
    if plan == "rel0":  # the hi sub-step's delta pre-added (:828-832)
        dhi = dlo + dhi
    rpc = rel0_chunks(plan)
    chunk = step_frames // rpc if rpc else 0
    rlo, rhi, rs = _rel0_window(dlo, dhi, agc[0],
                                chunk if plan.startswith("rel0c") else 0)
    rsv = torch.stack([rlo, rhi], 1)                         # [S, 2, n]
    if plan == "rel0":  # the peak is the current |y| (:840-846)
        des = desired_gain(rsv, torch.abs(y3), target, max_gain, floor,
                           inv_window)
    else:  # one rsqrt of the larger of the two terms (:876-897)
        qq = torch.maximum(rsv * inv_window, y3 * y3)
        des = torch.where(qq > 0.0,
                          torch.minimum(target * rsqrt_rn(qq), max_gain),
                          max_gain)
    if rpc:
        g3, g = _rel0_blocked_gains(des, agc[2], att, max_gain, chunk)
    else:  # the clamped-min smoother, ch0 then ch1 of each frame (:848-851)
        bv = (1.0 - att) * des
        g, gs = agc[2], []
        for t in range(n):
            for c in (0, 1):
                g = torch.clamp(torch.minimum(des[:, c, t], att * g + bv[:, c, t]),
                                min=0.1)
                gs.append(g)
        g3 = torch.stack(gs, -1).reshape(S, n, 2).transpose(1, 2)
    new_ring = ring.clone()
    keep = min(n, R)
    new_ring[rows[n - keep:]] = q[:, n - keep:].T
    # the peak carry stays as it was: the detector is memoryless (:867)
    return g3, torch.stack([rs, agc[1], g]), new_ring


def fused_resample_biquad_agc_mix_plain(pcm, left, wts, *, gains, coeffs, bq,
                                        agc, agc_params, ring, ring_row: int,
                                        agc_group: int = 0,
                                        agc_plan: str = "serial",
                                        step_frames: int = 0):
    """The plain PyTorch version of K2 (and of K2g with ``agc_group``, K2r
    and K2b with a rel0 ``agc_plan``), on any device."""
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
    if agc_plan != "serial":
        g3, agc_out, new_ring = _agc_rel0_plain(
            y, agc, agc_params, ring, ring_row, agc_plan, step_frames)
        out = y.reshape(S, 2, n) * g3 * gains.reshape(S, 2, 1)
        return out.sum(0), torch.stack(st), agc_out, new_ring
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
                                  agc_group: int = 0, agc_plan: str = "serial",
                                  step_frames: int = 0):
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

    ``agc_plan`` (one of :data:`AGC_REL0_PLANS`, else "serial") runs a rel0
    plan, which assumes a release coefficient of exactly 0 in agc_params
    (the caller's check) and leaves the peak carry as it was. ``rel0`` keeps
    the serial plan's ring; the others keep the packed basis: lane 2s holds
    the rounded sq0 and lane 2s+1 the rounded sq0 + sq1 of stream s. The
    blocked plans (``rel0b*``, ``rel0c*``) cut the JAX pipeline's grid
    steps of ``step_frames`` = m*to frames into RPC chunks (:func:`rel0_chunks`):
    RPC must divide step_frames, the block must hold whole steps and start
    at one (ring_row a multiple of gcd(step_frames, 4096)).

    Returns (mix [2, n], bq' [4, L], agc' [3, S], ring'); the input ring is
    left as it was."""
    ag = int(agc_group)
    R = AGC_RING_FRAMES
    n = left.shape[0]
    if ag and (ag < 2 or R % ag or n % ag):
        raise ValueError(
            f"agc_group {ag} must be >= 2, divide the RMS window {R} and the "
            f"block {n}")
    rpc = 0
    if agc_plan != "serial":
        rpc = rel0_chunks(agc_plan)
        if ag:
            raise ValueError(f"agc_plan={agc_plan!r} takes no agc_group")
        if rpc and (step_frames < 1 or step_frames % rpc or n % step_frames
                    or ring_row % math.gcd(step_frames, R)):
            raise ValueError(
                f"agc_plan={agc_plan!r} needs its {rpc} chunks to divide the "
                f"grid step m*to = {step_frames}, a block of whole steps and a "
                f"ring_row on the step grid; got n={n}, ring_row={ring_row}")
    if pcm.device.type == "cpu":
        return fused_resample_biquad_agc_mix_plain(
            pcm, left, wts, gains=gains, coeffs=coeffs, bq=bq, agc=agc,
            agc_params=agc_params, ring=ring, ring_row=ring_row,
            agc_group=ag, agc_plan=agc_plan, step_frames=step_frames)
    if pcm.device.type != "cuda":
        raise ValueError(
            f"fused_resample_biquad_agc_mix: unsupported device {pcm.device}")
    _build.refuse_f64("fused_resample_biquad_agc_mix", pcm, "ROADMAP F8")
    if rpc and step_frames // rpc > AGC_BLOCKED_MAX_CHUNK:
        raise ValueError(
            f"agc_plan={agc_plan!r}: chunks of {step_frames // rpc} frames; "
            f"the card's kernel takes up to {AGC_BLOCKED_MAX_CHUNK}")
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
    nblk = -(-L // _build.load_library().rt_fused_agc_block_lanes())
    partial = torch.empty((nblk, 2, n), dtype=torch.float32, device=dev)
    mix = torch.empty((2, n), dtype=torch.float32, device=dev)
    bq_out = torch.empty_like(bq)
    agc_out = torch.empty_like(agc)
    args = (pcm.data_ptr(), F, L, left.data_ptr(), wts.data_ptr(),
            gains.data_ptr(), coeffs.data_ptr(), bq.data_ptr(),
            bq_out.data_ptr(), agc.data_ptr(), agc_out.data_ptr(),
            agc_params.data_ptr(), new_ring.data_ptr(),
            int(ring.dtype == torch.bfloat16), ring_row)
    if rpc:  # K2b
        name = "rt_fused_resample_biquad_agc_blocked_mix"
        extra = (step_frames // rpc, int(agc_plan.startswith("rel0c")))
    elif agc_plan != "serial":  # K2r
        name = "rt_fused_resample_biquad_agc_rel0_mix"
        extra = (int(agc_plan == "rel0f"),)
    elif ag:  # K2g
        name, extra = "rt_fused_resample_biquad_agc_group_mix", (ag,)
    else:  # K2
        name, extra = "rt_fused_resample_biquad_agc_mix", ()
    _build.launch(name, *args, *extra, partial.data_ptr(), mix.data_ptr(), n,
                  device=dev)
    return mix, bq_out, agc_out, new_ring
