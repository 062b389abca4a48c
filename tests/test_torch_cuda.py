"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import). On a GPU host:

    python -m pytest tests/test_torch_cuda.py -q

Bounds: K4 bit-equal (same op order, every op rounded alone); K3 bit-equal
to the same blocked order (1e-6 allowed); K1 1e-6 (only the mix's
summation order differs), its biquad carries bit-equal (the FIR/IIR split
keeps the scan's op order). K6, K7 and K8 bit-equal, outputs and carries
(the same op order; K8 the same blocked order and the same power table;
NaN where the plain version has NaN); K2 1e-6 on the mix, its carries and
ring bit-equal. K5 bit-equal (the same op order), ``limiter_env`` and
``limiter_stream`` (the Limit node's gain computer, envelopes, coupling and
gain), NaN where the plain version has NaN; K2g (K2's group branch, on
K1's front end) as K2; K9 bit-equal on both routes (the same sum order; the
contiguous stream's max is order-free), eager and in a CUDA graph. K2r and K2b (K2's rel0 plans) as K2, their peak carry
untouched. K4's bf16 instance and the generators' phase kernel bit-equal;
the ring resampler on the card within 1e-6 of the CPU (the same ops).
"""
import numpy as np
import pytest
import torch

from rodio_tpu_torch import make_flagship, render_blocks
from rodio_tpu_torch.benches import dma_roofline, op_latency
from rodio_tpu_torch.conversions.resample import lerp_weights, output_positions
from rodio_tpu_torch.effects import AgcSettings, AutomaticGainControl
from rodio_tpu_torch.effects.blt import blt_coefficients
from rodio_tpu_torch.effects.limit import Limit, LimitSettings
from rodio_tpu_torch.ops import cuda_scan, fused, limiter_block
from rodio_tpu_torch.sources.generators import SamplesBuffer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _f32(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


@pytest.mark.parametrize("L,T", [
    (5, 1), (5, 2), (64, 300), (1024, 1000),
    (2, 4096),                       # path B's block: one block of 2 lanes
    (1024, 12800),                   # the unfused chain's and path C's
    (8, 127), (8, 129), (8, 130),    # a tail tile of 127, 1 and 2 steps
    (13, 128), (3, 4097), (6, 258),  # ragged L; T % 4 != 0: 4-byte copies
    (16, 3),
])
def test_k4_biquad_matches_plain(dev, L, T):
    rng = np.random.default_rng(L * 7 + T)
    x = _f32(rng.standard_normal((L, T)) * 0.3, dev)
    _k4_check(dev, x, tuple(_f32(rng.standard_normal(L) * 0.1, dev) for _ in range(4)))


def _k4_check(dev, x, st):
    """K4 against its plain version: y and the four carries bit-equal (NaN
    where the plain version has NaN), one launch."""
    coef = _f32(blt_coefficients("high_pass", 48000, 300.0, 0.8).as_tuple(), dev)
    before = cuda_scan.launches
    yk, sk = cuda_scan.biquad_df1(x, coef, st)
    yp, sp = cuda_scan.biquad_df1_plain(x, coef, st)
    torch.cuda.synchronize()
    assert cuda_scan.launches == before + 1
    assert torch.equal(yk.nan_to_num(7.0), yp.nan_to_num(7.0))
    assert torch.equal(yk.isnan(), yp.isnan())
    for a, b in zip(sk, sp):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert torch.equal(a.isnan(), b.isnan())


@pytest.mark.parametrize("T", [128, 300])
def test_k4_special_values(dev, T):
    """NaN, +inf and -inf in x, one lane of each and a few samples in
    others: the FIR half carries them across a tile edge as the scan does."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((12, T)) * 0.3
    x[1, :] = np.nan
    x[2, :] = np.inf
    x[3, :] = -np.inf
    x[4, [0, 1, T - 1]] = [np.nan, np.inf, -np.inf]
    x[5, [126, 127, 128 % T]] = [np.inf, np.nan, -np.inf]
    x[6, :] = 0.0
    st = [rng.standard_normal(12) * 0.1 for _ in range(4)]
    st[0][7], st[3][8] = np.nan, np.inf
    _k4_check(dev, _f32(x, dev), tuple(_f32(s, dev) for s in st))


@pytest.mark.parametrize("T", [4096, 1000])
def test_k4_misaligned_inputs(dev, T):
    """x and y off 16-byte alignment (views one float into a buffer): the
    kernel takes its 4-byte copies and stores."""
    rng = np.random.default_rng(T + 1)
    L = 9
    buf = _f32(rng.standard_normal(L * T + 1) * 0.3, dev)
    x = buf[1:].view(L, T)
    assert x.data_ptr() % 16 != 0
    _k4_check(dev, x, tuple(_f32(rng.standard_normal(L) * 0.1, dev) for _ in range(4)))


@pytest.mark.parametrize("scale", [0.8, 4.0, 0.02])  # mixed, loud, quiet
@pytest.mark.parametrize("T,P", [(640, 128), (96, 32), (12800, 128), (4096, 128),
                                 (12800, 8), (65536, 128), (262144, 128), (64, 2)])
def test_k3_limiter_matches_plain(dev, T, P, scale):
    """Every knee branch (below, inside and above the knee) runs across the
    scales; at T = 262144 a block's chunks are too long to stage in shared
    memory, so the kernel keeps them in a global scratch."""
    rng = np.random.default_rng(T + P)
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32), device="cpu"),
                LimitSettings.mastering())
    kw = dict(att=lim.attack, rel=lim.release, threshold=lim.threshold,
              knee_width=lim.knee_width, inv_knee_8=lim.inv_knee_8, P=P)
    x = _f32(rng.standard_normal((2, T)) * scale, dev)
    i0, p0 = _f32([0.3, 1.2], dev), _f32([0.6, 0.1], dev)
    before = limiter_block.launches
    yk, ck = limiter_block.limiter_master(x, i0, p0, **kw)
    yp, cp = limiter_block.limiter_master_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert limiter_block.launches == before + 1
    assert (yk - yp).abs().max().item() <= 1e-6
    for a, b in zip(ck, cp):
        assert (a - b).abs().max().item() <= 1e-6


def test_k3_stages_in_shared_memory_up_to_its_limit(dev):
    """K3 asks for a global scratch only where a block's chunks do not fit in
    shared memory: not at the main path's T = 12800, path B's 4096 or 65536;
    at 262144 for all 2P chunks of 2049 floats (the odd row stride)."""
    for T in (12800, 4096, 65536):
        assert limiter_block._scratch_floats(T, 128) == 0
    assert limiter_block._scratch_floats(262144, 128) == 2 * 128 * 2049


def test_k1_blocks_hold_whole_streams(dev):
    """K1's lanes per block for every C the wrapper takes: whole streams of
    C lanes, 8 lanes where C divides 8, one stream for C > 8."""
    for C in range(1, 33):
        lb = fused._block_lanes(C)
        assert lb % C == 0 and lb <= 32
        assert lb == (8 // C * C if C <= 8 else C)


@pytest.mark.parametrize("S,C,n,o0,F", [
    (3, 2, 640, 0, 5000), (8, 2, 320, 480, 5000), (5, 1, 640, 160, 700),
    (512, 2, 1280, 160, 4000),
    # a single frame, two, a part of a 128-frame tile (half of one: the IIR
    # warp's register run), one tile and past it, two whole tiles
    (4, 2, 1, 7, 100), (4, 1, 2, 0, 100), (6, 1, 63, 3, 200), (6, 2, 64, 160, 200),
    (6, 1, 127, 9, 300), (6, 2, 128, 0, 300), (4, 1, 129, 21, 300),
    (4, 2, 256, 11, 600),
    (5, 3, 65, 37, 200),                     # C = 3: blocks of 6 lanes
    (3, 12, 130, 320, 800), (1, 32, 100, 5, 300),  # C > 8: one stream a block
    (2, 2, 200, 0, 150),                     # the reads run past the PCM
    (512, 2, 12800, 480, 13000),             # the main path's block
])
def test_k1_fused_matches_plain(dev, S, C, n, o0, F):
    """F small enough in some cases that the reads run past the PCM (zero);
    two blocks in a row, the second from the first's carries."""
    _k1_two_blocks(dev, S, C, n, o0, F, 147, 160)


@pytest.mark.parametrize("fr,to,S,C", [(320, 147, 4, 2), (320, 147, 3, 3),
                                       (160, 147, 4, 2), (160, 147, 2, 12)])
def test_k1_rows_outside_the_staged_range(dev, fr, to, S, C):
    """48 -> 22.05 kHz: a 128-frame tile reads ~280 PCM rows, more than the
    192 a tile stages, so its later frames load their rows from global
    memory; 48 -> 44.1 kHz downsamples within the staged range. Several
    tiles and a tail, the second block's last frames past the PCM."""
    n, o0 = 300, 5
    _k1_two_blocks(dev, S, C, n, o0, (o0 + 2 * n) * fr // to - 4, fr, to)


def _k1_two_blocks(dev, S, C, n, o0, F, fr, to):
    rng = np.random.default_rng(S * 100 + n)
    L = S * C
    pcm = _f32(rng.standard_normal((F, L)) * 0.1, dev)
    kw = dict(gains=_f32(rng.uniform(0.1, 1.0, L), dev),
              coeffs=_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev),
              channels=C)
    bk = bp = _f32(rng.standard_normal((4, L)) * 0.01, dev)
    for block in range(2):
        left, phase = output_positions(o0 + block * n, n, fr, to, dev)
        wts = _f32(np.stack(lerp_weights(fr, to), axis=1), dev)[phase]
        before = fused.launches
        mk, bk = fused.fused_resample_biquad_mix(pcm, left, wts, bq=bk, **kw)
        mp, bp = fused.fused_resample_biquad_mix_plain(pcm, left, wts, bq=bp, **kw)
        torch.cuda.synchronize()
        assert fused.launches == before + 1
        assert (mk - mp).abs().max().item() <= 1e-6, block
        assert torch.equal(bk, bp), block


def test_flagship_on_card_matches_cpu(dev):
    """The fused slice and the unfused chain on the card against the same
    graphs on the CPU (plain versions), 3 blocks of 640."""
    for mode, bound in (("fused", 1e-6), ("auto", 1e-6)):
        node_g, st_g = make_flagship(8, seconds=0.5, scan_mode=mode, device=dev)
        node_c, st_c = make_flagship(8, seconds=0.5, scan_mode=mode, device="cpu")
        before = (fused.launches, limiter_block.launches, cuda_scan.launches)
        _, og, vg = render_blocks(node_g, st_g, 3, 640)
        _, oc, vc = render_blocks(node_c, st_c, 3, 640)
        after = (fused.launches, limiter_block.launches, cuda_scan.launches)
        assert torch.equal(vg.cpu(), vc)
        # the card's limiter is the blocked order, the CPU's the sequential
        assert np.abs(og.cpu().numpy() - oc.numpy()).max() <= bound + 4e-6
        k1 = 3 if mode == "fused" else 0
        assert after == (before[0] + k1, before[1] + 3, before[2] + 3 - k1)


@pytest.mark.parametrize("L,T", [(6, 700), (1024, 12800), (3, 1), (40, 33), (1, 127),
                                 (8, 128), (9, 129), (17, 4410)])
def test_k5_limiter_env_matches_plain(dev, L, T):
    rng = np.random.default_rng(L + T)
    db = rng.uniform(0.0, 12.0, (L, T)) * (rng.uniform(size=(L, T)) < 0.3)
    x = _f32(db, dev)
    i0, p0 = _f32(rng.uniform(0, 6, L), dev), _f32(rng.uniform(0, 6, L), dev)
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32), device="cpu"),
                LimitSettings())
    kw = dict(att=lim.attack, rel=lim.release)
    before = cuda_scan.limiter_env_launches
    pk, ck = cuda_scan.limiter_env(x, i0, p0, **kw)
    pp, cp = cuda_scan.limiter_env_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert cuda_scan.limiter_env_launches == before + 1
    assert torch.equal(pk, pp)
    for a, b in zip(ck, cp):
        assert torch.equal(a, b)


def test_limit_off_k3_on_card_matches_cpu(dev):
    """Limit's K5 cases on the card (streams=4, mono, P = 2, and "exact")
    against the CPU: the envelopes bit-equal, the output 1e-6 (path B's
    bound: the CPU's torch ops against the kernel's)."""
    rng = np.random.default_rng(3)
    for channels, streams, n, mode in ((8, 4, 640, "pallas"), (1, 1, 640, "pallas"),
                                       (2, 1, 4410, "pallas"), (2, 1, 640, "exact")):
        data = (rng.uniform(-1, 1, (channels, 3 * n)) * 2.0).astype(np.float32)
        outs, states = [], []
        for device in (dev, "cpu"):
            node = Limit(SamplesBuffer(channels, 48000, data, device=device),
                         LimitSettings(), mode=mode, streams=streams)
            before = cuda_scan.limiter_stream_launches
            st, out, _ = render_blocks(node, node.init_state(), 3, n)
            if device != "cpu":
                assert cuda_scan.limiter_stream_launches == before + 3
            outs.append(out.cpu())
            states.append((st["integ"].cpu(), st["peak"].cpu()))
        assert (outs[0] - outs[1]).abs().max().item() <= 1e-6
        assert all(torch.equal(a, b) for a, b in zip(*states))


def _limit_kw(cg):
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32), device="cpu"),
                LimitSettings())
    return dict(att=lim.attack, rel=lim.release, threshold=lim.threshold,
                knee_width=lim.knee_width, inv_knee_8=lim.inv_knee_8,
                group_channels=cg)


def _limit_inputs(L, T, seed, dev):
    """x [L, T] at quiet, limited and loud levels per lane, and envelope
    carries in dB."""
    rng = np.random.default_rng(seed)
    level = rng.choice([0.05, 0.6, 2.5], (L, 1))
    x = rng.uniform(-1, 1, (L, T)) * level
    return (_f32(x, dev), _f32(rng.uniform(0, 6, L), dev),
            _f32(rng.uniform(0, 6, L), dev))


def _k5_stream_check(dev, x, i0, p0, cg, xp=None):
    """limiter_stream on the card against its plain version (on xp, the
    same values, if x is a view the plain version should not see): y and
    the carries bit-equal, NaN where the plain version has NaN; one
    launch."""
    kw = _limit_kw(cg)
    before = cuda_scan.limiter_stream_launches
    yk, ck = cuda_scan.limiter_stream(x, i0, p0, **kw)
    yp, cp = cuda_scan.limiter_stream_plain(x if xp is None else xp, i0, p0, **kw)
    torch.cuda.synchronize()
    assert cuda_scan.limiter_stream_launches == before + 1
    _equal_nan(yk, yp)
    for a, b in zip(ck, cp):
        _equal_nan(a, b)
    return yk, ck


@pytest.mark.parametrize("T", [1, 127, 128, 129, 4410])
@pytest.mark.parametrize("streams", [1, 3, 85])
@pytest.mark.parametrize("cg", [1, 2, 4, 6, 8, 12])
def test_k5_limiter_stream_matches_plain(dev, cg, streams, T):
    """Groups of 1-12 channels (a block holds 8 lanes of whole groups, or
    one group of 12), 1 to 1020 lanes, T around the 128-step tile (T % 4 !=
    0 at 1, 127, 129 and 4410: the 4-byte copies)."""
    x, i0, p0 = _limit_inputs(cg * streams, T, cg * 1000 + streams + T, dev)
    _k5_stream_check(dev, x, i0, p0, cg)


@pytest.mark.parametrize("cg", [1, 2])
def test_k5_limiter_stream_at_path_c_shape(dev, cg):
    """[1024, 12800]: path C's Limit(streams=512), and 1024 mono groups."""
    x, i0, p0 = _limit_inputs(1024, 12800, cg, dev)
    _k5_stream_check(dev, x, i0, p0, cg)


def test_k5_limiter_stream_wider_groups(dev):
    """A group wider than a block's 32 chain threads (40 channels) runs its
    envelopes on limiter_env and the rest in torch, the plain version's
    ops: bit-equal to it, one limiter_env launch."""
    x, i0, p0 = _limit_inputs(80, 300, 7, dev)
    kw = _limit_kw(40)
    before = (cuda_scan.limiter_stream_launches, cuda_scan.limiter_env_launches)
    yk, ck = cuda_scan.limiter_stream(x, i0, p0, **kw)
    yp, cp = cuda_scan.limiter_stream_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert (cuda_scan.limiter_stream_launches, cuda_scan.limiter_env_launches) == (
        before[0], before[1] + 1)
    assert torch.equal(yk, yp)
    assert all(torch.equal(a, b) for a, b in zip(ck, cp))


def test_k5_limiter_stream_special_values(dev):
    """Zeros (the knee's zero branch), NaN and +-inf samples, and a NaN
    carry: NaN where the plain version has NaN, else bit-equal."""
    L, T = 12, 700
    x, i0, p0 = _limit_inputs(L, T, 5, dev)
    x[:, :150] = 0.0
    x[1, 200] = float("nan")
    x[2, 300] = float("inf")
    x[5, 310] = -float("inf")
    x[7, 400:410] = float("nan")
    i0[9] = float("nan")
    for cg in (1, 2, 4, 6):
        yk, _ = _k5_stream_check(dev, x, i0, p0, cg)
        assert bool(yk[1, 200].isnan()) and bool(torch.isfinite(yk[0]).all())


def test_k5_misaligned_inputs(dev):
    """An input and an output off a 16-byte boundary take the 4-byte copies
    and stores: both K5 entry points still equal their plain versions."""
    L, T = 10, 640
    x, i0, p0 = _limit_inputs(L, T, 6, dev)
    flat = torch.empty(x.numel() + 1, device=dev)
    xo = flat[1:].view(L, T)
    xo.copy_(x)
    assert xo.data_ptr() % 16 != 0
    _k5_stream_check(dev, xo, i0, p0, 2, xp=x)
    db = x.abs() * 6.0
    flat.zero_()
    dbo = flat[1:].view(L, T)
    dbo.copy_(db)
    kw = dict(att=_limit_kw(1)["att"], rel=_limit_kw(1)["rel"])
    pk, ck = cuda_scan.limiter_env(dbo, i0, p0, **kw)
    pp, cp = cuda_scan.limiter_env_plain(db, i0, p0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and all(torch.equal(a, b) for a, b in zip(ck, cp))


@pytest.mark.parametrize("cut", [1, 128, 383])
def test_k5_carries_cross_calls(dev, cut):
    """Two calls in a row, the second from the first's carries, give the one
    call's result bit for bit: limiter_stream's y (the coupling at the
    second call's first frame reads the peak carry) and limiter_env's
    peaks, and both carries."""
    L, T = 12, 1000
    x, i0, p0 = _limit_inputs(L, T, cut, dev)
    kw = _limit_kw(4)
    y, c = cuda_scan.limiter_stream(x, i0, p0, **kw)
    y1, c1 = cuda_scan.limiter_stream(x[:, :cut], i0, p0, **kw)
    y2, c2 = cuda_scan.limiter_stream(x[:, cut:], *c1, **kw)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert all(torch.equal(a, b) for a, b in zip(c2, c))
    db, ekw = x.abs() * 6.0, dict(att=kw["att"], rel=kw["rel"])
    pk, c = cuda_scan.limiter_env(db, i0, p0, **ekw)
    pk1, c1 = cuda_scan.limiter_env(db[:, :cut], i0, p0, **ekw)
    pk2, c2 = cuda_scan.limiter_env(db[:, cut:], *c1, **ekw)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([pk1, pk2], 1), pk)
    assert all(torch.equal(a, b) for a, b in zip(c2, c))


@pytest.mark.parametrize("ring_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,n,o0,F,ag", [
    (3, 640, 0, 5000, 16), (16, 320, 4000, 5000, 2), (512, 1280, 160, 4000, 16),
    (4, 5120, 320, 6000, 64),  # n > 4096: the block reads its own sums back
    (6, 352, 0, 1000, 32),     # a tail tile of 32 frames
    # groups over 2, 4 and 64 tiles; at 128, 40 groups wrap the 32-row ring
    (4, 5120, 128, 6000, 128), (3, 1024, 512, 2000, 256), (2, 8192, 0, 9000, 4096),
])
def test_k2g_fused_agc_group_matches_plain(dev, ring_dtype, S, n, o0, F, ag):
    rng = np.random.default_rng(S * 100 + n + ag)
    L = 2 * S
    fr, to = 147, 160
    pcm = _f32(rng.standard_normal((F, L)) * 0.3, dev)
    left, phase = output_positions(o0, n, fr, to, dev)
    wts = _f32(np.stack(lerp_weights(fr, to), axis=1), dev)[phase]
    agc = _f32(np.stack([rng.uniform(10, 100, S), rng.uniform(0, .5, S),
                         rng.uniform(.5, 3, S)]), dev)
    rows = 4096 // ag
    ring = _f32(rng.uniform(0, 0.1 * ag, (rows, S)), dev).to(ring_dtype)
    gains = np.repeat(rng.uniform(0.5, 1.5, S) / S, 2)
    kw = dict(gains=_f32(gains, dev),
              coeffs=_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev),
              bq=_f32(rng.standard_normal((4, L)) * 0.01, dev), agc=agc,
              agc_params=_f32(AGC_PARAMS, dev), ring=ring,
              ring_row=(o0 // ag) % rows, agc_group=ag)
    before = (fused.agc_group_launches, fused.agc_launches)
    mk, bk, ak, rk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw)
    mp, bp, ap, rp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw)
    torch.cuda.synchronize()
    assert (fused.agc_group_launches, fused.agc_launches) == (before[0] + 1, before[1])
    assert (mk - mp).abs().max().item() <= 1e-6
    assert torch.equal(bk, bp) and torch.equal(ak, ap) and torch.equal(rk, rp)


def test_group_agc_flagship_on_card_matches_cpu(dev):
    """make_flagship(agc_group=16) on the card against the CPU, 3 blocks of
    640: K2g and K3 once per block."""
    kw = dict(seconds=0.5, scan_mode="fused", with_agc=True, agc_group=16)
    node_g, st_g = make_flagship(12, device=dev, **kw)
    node_c, st_c = make_flagship(12, device="cpu", **kw)
    before = (fused.agc_group_launches, limiter_block.launches)
    _, og, _ = render_blocks(node_g, st_g, 3, 640)
    after = (fused.agc_group_launches, limiter_block.launches)
    _, oc, _ = render_blocks(node_c, st_c, 3, 640)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 3)
    # the card's master limiter is the blocked order, the CPU's the
    # sequential one (4e-6)
    assert np.abs(og.cpu().numpy() - oc.numpy()).max() <= 5e-6


# K1's block at n = 12800 in its 128-frame tiles; a part block of lanes
# (36 = 4 blocks of 8 and 4 lanes of zero fill); R < tr (one partial tile);
# 3 tiles, fewer than the ring's slots at depth 8 and 32
K9_SHAPES = [(11761, 1024, 118), (100, 36, 7), (5, 8, 59), (300, 64, 100)]


@pytest.mark.parametrize("depth", [2, 3, 8, 32])
@pytest.mark.parametrize("lanes", [8, 32])
@pytest.mark.parametrize("route", ["tma", "cp.async"])
@pytest.mark.parametrize("R,L,tr", K9_SHAPES)
def test_k9_dma_ring_matches_plain(dev, R, L, tr, route, lanes, depth):
    x = _f32(np.random.default_rng(R).standard_normal((R, L)), dev)
    before = dma_roofline.launches
    want = dma_roofline.dma_ring_plain(x, tr=tr)
    kw = dict(tr=tr, depth=depth, lanes=lanes, route=route)
    if dma_roofline.ring_bytes(tr, lanes, depth, route) > dma_roofline.SMEM_OPTIN:
        with pytest.raises(ValueError, match="shared memory"):
            dma_roofline.dma_ring(x, **kw)  # refused before it launches
        assert dma_roofline.launches == before
        return
    got = dma_roofline.dma_ring(x, **kw)
    torch.cuda.synchronize()
    assert dma_roofline.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("R,L", [(11761, 1024), (100, 36), (5, 8), (3, 4), (1000, 64)])
def test_k9_stream_max_matches_plain(dev, R, L):
    x = _f32(np.random.default_rng(R + L).standard_normal((R, L)), dev)
    want = dma_roofline.stream_max_plain(x, blocks=dma_roofline.stream_blocks(x))
    assert torch.equal(dma_roofline.stream_max(x), want)


def test_k9_in_a_cuda_graph_equals_the_eager_call(dev):
    """K9's TMA ring, K1's cp.async route and the contiguous stream
    captured in one CUDA graph (each launch with its own tensor map) give
    the eager calls' results, on each of the rotating copies."""
    rows, tr = dma_roofline.k1_stream(12800)
    xs = [_f32(np.random.default_rng(s).standard_normal((rows, 1024)), dev)
          for s in range(3)]
    eager = [(dma_roofline.dma_ring(x, tr=tr),
              dma_roofline.dma_ring(x, tr=tr, depth=3, route="cp.async"),
              dma_roofline.stream_max(x)) for x in xs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    before = dma_roofline.launches
    with torch.cuda.graph(g, stream=side):
        outs = [(dma_roofline.dma_ring(x, tr=tr),
                 dma_roofline.dma_ring(x, tr=tr, depth=3, route="cp.async"),
                 dma_roofline.stream_max(x)) for x in xs]
    assert dma_roofline.launches == before + 6  # counted where captured
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dma_roofline.launches == before + 6  # replays add none
    assert dma_roofline.time_ms_cold(lambda t: dma_roofline.dma_ring(t, tr=tr),
                                     xs[0], reps=4, copies=xs) > 0.0


def test_op_chain_matches_plain(dev):
    xab = torch.tensor([1.0, 0.999, 1e-3], device=dev)
    assert torch.equal(op_latency.op_chain(xab, 5),
                       op_latency.op_chain_plain(xab, 5))
    assert 0.0 < op_latency.seconds_per_op(dev) < 1e-8


def test_smooth_chain_matches_plain(dev):
    p = torch.tensor(op_latency.SMOOTH_PARAMS, device=dev)
    out = op_latency.smooth_chain(p, 5)
    assert torch.equal(out[:1], op_latency.smooth_chain_plain(p, 5))
    assert out[1].item() > 0.0
    seconds, cycles = op_latency.smooth_step(dev)
    assert 0.0 < seconds < 1e-7 and 0.0 < cycles < 200.0


def test_emit_never_waits_for_the_card(dev):
    """A render of the fused slice and of the unfused chain makes no
    host-device synchronisation (set_sync_debug_mode raises on one)."""
    for mode in ("fused", "auto"):
        node, st = make_flagship(8, seconds=0.5, scan_mode=mode, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, out, valids = render_blocks(node, st, 3, 640)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert out.shape == (2, 1920)


#: (att, rel, target, max_gain, floor, 1/8192): fast knobs, so the smoother
#: moves both ways
AGC_PARAMS = (0.99583, 0.99896, 0.8, 5.0, 0.0, 1.0 / 8192)


def _agc_inputs(S, M, dev, seed):
    rng = np.random.default_rng(seed)
    env = 0.05 + 0.5 * (0.5 + 0.5 * np.sin(np.arange(M) / 200.0))
    xs = np.abs(rng.standard_normal((S, M)) * env)
    sq = (xs * xs).astype(np.float32)
    delta = sq - sq * rng.uniform(0.0, 1.0, (S, M)).astype(np.float32)
    carries = [rng.uniform(lo, hi, S) for lo, hi in ((0, .5), (10, 200), (.5, 3))]
    return (_f32(xs, dev), _f32(delta, dev), *[_f32(c, dev) for c in carries])


#: K6's lanes (4 a block: 1, a whole block, ragged tails, 128 blocks) and
#: steps (1, around its 128-step tile, path C's 25600)
K6_SHAPES = [(S, M) for S in (1, 3, 4, 5, 9, 512) for M in (1, 127, 128, 129, 383, 25600)]


@pytest.mark.parametrize("S,M", K6_SHAPES + [(5, 70), (64, 1000)])
def test_k6_agc_matches_plain(dev, S, M):
    xs, delta, p0, s0, g0 = _agc_inputs(S, M, dev, S + M)
    params = _f32(AGC_PARAMS, dev)
    before = cuda_scan.agc_launches
    gk, ck = cuda_scan.agc(xs, delta, p0, s0, g0, params)
    gp, cp = cuda_scan.agc_plain(xs, delta, p0, s0, g0, params)
    torch.cuda.synchronize()
    assert cuda_scan.agc_launches == before + 1
    assert torch.equal(gk, gp)
    for a, b in zip(ck, cp):
        assert torch.equal(a, b)


def _equal_nan(a, b):
    torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)


def test_k6_zeros_and_nans_take_the_plain_branches(dev):
    """Stretches of zero |x| and d from zero carries (rsum = 0 and peak = 0:
    both max_gain branches of the desired gain), a negative window sum, and
    a NaN in |x| (peak NaN: pk > 0 false) and in d (rsum NaN) of one lane
    each: gains and carries equal the plain version's, NaN where it has
    NaN."""
    S, M = 6, 700
    xs, delta, p0, s0, g0 = _agc_inputs(S, M, dev, 11)
    xs[:, :200] = 0.0
    delta[:, :200] = 0.0
    xs[1:3, 300:450] = 0.0
    delta[2, 320:330] = -1.0
    xs[3, 400] = float("nan")
    delta[4, 500] = float("nan")
    p0[:] = 0.0
    s0[:] = 0.0
    params = _f32(AGC_PARAMS, dev)
    gk, ck = cuda_scan.agc(xs, delta, p0, s0, g0, params)
    gp, cp = cuda_scan.agc_plain(xs, delta, p0, s0, g0, params)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(gp).all())
    assert bool(ck[0][3].isnan()) and bool(ck[1][4].isnan())
    _equal_nan(gk, gp)
    for a, b in zip(ck, cp):
        _equal_nan(a, b)


def test_k6_k7_misaligned_inputs(dev):
    """Inputs 4 bytes off a 16-byte boundary (a contiguous view at an odd
    offset) take the kernels' 4-byte copies: still equal to the plain
    versions."""
    def offset(t):
        flat = torch.empty(t.numel() + 1, device=dev)
        v = flat[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 != 0
        return v

    xs, delta, p0, s0, g0 = _agc_inputs(5, 384, dev, 3)
    params = _f32(AGC_PARAMS, dev)
    gk, ck = cuda_scan.agc(offset(xs), offset(delta), p0, s0, g0, params)
    gp, cp = cuda_scan.agc_plain(xs, delta, p0, s0, g0, params)
    assert torch.equal(gk, gp)
    for a, b in zip(ck, cp):
        assert torch.equal(a, b)
    a = offset(xs + 0.5)
    p7 = params[[0, 1, 3]]
    yk = cuda_scan.first_order(a, a, g0, op="agc_gain", params=p7)
    yp = cuda_scan.first_order_plain(xs + 0.5, xs + 0.5, g0, op="agc_gain", params=p7)
    torch.cuda.synchronize()
    assert torch.equal(yk, yp)


def _k7_inputs(op, L, T, seed):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(0.2, 6.0, (L, T)) if op == "agc_gain"
         else rng.uniform(0.9, 1.0, (L, T)))
    return (a, rng.standard_normal((L, T)) * 0.1, rng.uniform(0.5, 1.0, (L, T)),
            rng.uniform(0.5, 2.0, L))


#: K7's lanes (4 a block) and steps (around its 64-step register halves and
#: 128-step tiles, path B's [1, 512] and [1, 8192], and a long row)
K7_SHAPES = [(L, T) for L in (1, 2, 9, 37)
             for T in (1, 63, 64, 127, 128, 129, 512, 8192, 65536)]


@pytest.mark.parametrize("op", ["linear", "max_affine", "agc_gain"])
@pytest.mark.parametrize("L,T", K7_SHAPES + [(37, 300), (3, 1)])
def test_k7_first_order_matches_plain(dev, op, L, T):
    a, b, c, init = (_f32(v, dev) for v in _k7_inputs(op, L, T, L * T))
    params = _f32([AGC_PARAMS[0], AGC_PARAMS[1], AGC_PARAMS[3]], dev)
    kw = dict(op=op, params=params)
    before = cuda_scan.first_order_launches
    yk = cuda_scan.first_order(a, b, init, c, **kw)
    yp = cuda_scan.first_order_plain(a, b, init, c, **kw)
    torch.cuda.synchronize()
    assert cuda_scan.first_order_launches == before + 1
    assert torch.equal(yk, yp)


@pytest.mark.parametrize("cut", [1, 128, 383])
def test_k6_k7_carries_cross_calls(dev, cut):
    """Two calls in a row, the second from the first's carries, give the
    one call's result bit for bit (K6: gains and carries; K7, each op: y,
    whose last column is its carry)."""
    S, M = 5, 1000
    xs, delta, p0, s0, g0 = _agc_inputs(S, M, dev, cut)
    params = _f32(AGC_PARAMS, dev)
    g, c = cuda_scan.agc(xs, delta, p0, s0, g0, params)
    g1, c1 = cuda_scan.agc(xs[:, :cut], delta[:, :cut], p0, s0, g0, params)
    g2, c2 = cuda_scan.agc(xs[:, cut:], delta[:, cut:], *c1, params)
    assert torch.equal(torch.cat([g1, g2], 1), g)
    for a, b in zip(c2, c):
        assert torch.equal(a, b)
    p7 = params[[0, 1, 3]]
    for op in ("linear", "max_affine", "agc_gain"):
        a, b, c, init = (_f32(v, dev) for v in _k7_inputs(op, S, M, cut))
        y = cuda_scan.first_order(a, b, init, c, op=op, params=p7)
        y1 = cuda_scan.first_order(a[:, :cut], b[:, :cut], init, c[:, :cut], op=op,
                                   params=p7)
        y2 = cuda_scan.first_order(a[:, cut:], b[:, cut:], y1[:, -1], c[:, cut:], op=op,
                                   params=p7)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([y1, y2], 1), y), op


@pytest.mark.parametrize("L,P,M", [
    (1, 128, 8192), (3, 8, 64), (8, 32, 3200),
    (1, 128, 128),     # Lc = 1 (M = P)
    (2, 1, 64),        # P = 1: one chunk, no combine
    (8, 128, 16384),   # 8 rows of 128 chunks: 1024 chunk threads
    (2, 128, 262144),  # rows too long to stage in shared memory: a global scratch
])
@pytest.mark.parametrize("special", [False, True])
def test_k8_blocked_max_affine_matches_plain(dev, L, P, M, special):
    """Bit-equal (NaN where the plain version has NaN) from a warm and a zero
    carry, at a coefficient of 0, 1, a live one and one on the card; with
    ``special``, NaN and +-inf among the samples."""
    rng = np.random.default_rng(L * P)
    x = np.abs(rng.standard_normal((L, M)) * 0.3)
    if special:
        x.flat[rng.choice(L * M, 6, replace=False)] = [np.nan, np.inf, -np.inf] * 2
    x = _f32(x, dev)
    for v0 in (_f32(rng.uniform(0, 1, L), dev), torch.zeros(L, device=dev)):
        for a in (0.0, 0.99896, _f32(0.9, dev), 1.0):
            before = limiter_block.bma_launches
            yk = limiter_block.blocked_max_affine_const(x, v0, a, P=P)
            yp = limiter_block.blocked_max_affine_const_plain(x, v0, a, P=P)
            torch.cuda.synchronize()
            assert limiter_block.bma_launches == before + 1
            assert torch.equal(yk.nan_to_num(7.0), yp.nan_to_num(7.0))
            assert torch.equal(yk.isnan(), yp.isnan())


@pytest.mark.parametrize("ring_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,n,o0,F,to", [
    (3, 640, 0, 5000, 160), (16, 333, 4000, 5000, 160), (512, 1280, 160, 4000, 160),
    (4, 5000, 320, 6000, 160),  # n > 4096: the block reads its own squares back
    # the 128-frame tile's edges: a lone frame, a tail of 127, whole tiles,
    # a tail of 1; blocks starting off the tile grid
    (3, 1, 0, 5000, 160), (5, 127, 0, 5000, 160), (4, 128, 128, 5000, 160),
    (3, 129, 77, 5000, 160), (5, 255, 333, 5000, 160),
    (6, 1280, 640, 3000, 320),  # 22.05 -> 48 kHz
])
def test_k2_fused_agc_matches_plain(dev, ring_dtype, S, n, o0, F, to):
    rng = np.random.default_rng(S * 100 + n)
    L = 2 * S
    fr = 147
    pcm = _f32(rng.standard_normal((F, L)) * 0.3, dev)
    left, phase = output_positions(o0, n, fr, to, dev)
    wts = _f32(np.stack(lerp_weights(fr, to), axis=1), dev)[phase]
    agc = _f32(np.stack([rng.uniform(10, 100, S), rng.uniform(0, .5, S),
                         rng.uniform(.5, 3, S)]), dev)
    ring = _f32(rng.uniform(0, 0.1, (4096, L)), dev).to(ring_dtype)
    # stream gains of the flagship's scale (1/S), so the mix is of unit
    # scale and the bound is about the summation order alone
    gains = np.repeat(rng.uniform(0.5, 1.5, S) / S, 2)
    kw = dict(gains=_f32(gains, dev),
              coeffs=_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev),
              bq=_f32(rng.standard_normal((4, L)) * 0.01, dev), agc=agc,
              agc_params=_f32(AGC_PARAMS, dev), ring=ring, ring_row=o0 % 4096)
    before = fused.agc_launches
    mk, bk, ak, rk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw)
    mp, bp, ap, rp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw)
    torch.cuda.synchronize()
    assert fused.agc_launches == before + 1
    assert (mk - mp).abs().max().item() <= 1e-6
    assert torch.equal(bk, bp) and torch.equal(ak, ap) and torch.equal(rk, rp)


def test_agc_flagship_on_card_matches_cpu(dev):
    """The fused AGC slice and the unfused pallas AGC chain on the card
    against the same graphs on the CPU (plain versions), 3 blocks of 640."""
    counters = (lambda: (fused.agc_launches, cuda_scan.agc_launches,
                         limiter_block.launches, cuda_scan.launches))
    for mode, want in (("fused", (3, 0, 3, 0)), ("pallas", (0, 3, 3, 3))):
        node_g, st_g = make_flagship(12, seconds=0.5, scan_mode=mode,
                                     with_agc=True, device=dev)
        node_c, st_c = make_flagship(12, seconds=0.5, scan_mode=mode,
                                     with_agc=True, device="cpu")
        before = counters()
        _, og, vg = render_blocks(node_g, st_g, 3, 640)
        after = counters()
        _, oc, vc = render_blocks(node_c, st_c, 3, 640)
        assert torch.equal(vg.cpu(), vc)
        # fused: the card's limiter is the blocked order, the CPU's the
        # sequential one (4e-6)
        bound = 5e-6 if mode == "fused" else 1e-6
        assert np.abs(og.cpu().numpy() - oc.numpy()).max() <= bound
        assert tuple(a - b for a, b in zip(after, before)) == want


def test_config2_chain_on_card_matches_cpu(dev):
    """Path B: low_pass -> AGC (decomposed: K8 + K7) -> Limit (K3), with
    the per-sample and the group-rate smoother."""
    rng = np.random.default_rng(2)
    data = (rng.standard_normal((2, 3 * 4096)) * 0.3).astype(np.float32)
    for group in (0, 8):
        outs = []
        for device in (dev, "cpu"):
            node = SamplesBuffer(2, 44100, data, device=device).low_pass(2000.0)
            node = AutomaticGainControl(node, AgcSettings(), mode="pallas",
                                        group=group)
            node = Limit(node, LimitSettings(), mode="pallas")
            before = (limiter_block.bma_launches, cuda_scan.first_order_launches)
            _, out, _ = render_blocks(node, node.init_state(), 3, 4096)
            after = (limiter_block.bma_launches, cuda_scan.first_order_launches)
            if device != "cpu":
                assert after == (before[0] + 3, before[1] + 3)
            outs.append(out.cpu().numpy())
        assert np.abs(outs[0] - outs[1]).max() <= 1e-6


def test_fused_agc_emit_never_waits_for_the_card(dev):
    node, st = make_flagship(8, seconds=0.5, scan_mode="fused", with_agc=True,
                             device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, out, valids = render_blocks(node, st, 3, 640)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (2, 1920)


#: AGC_PARAMS with a release coefficient of 0, as K2's rel0 plans require
AGC_PARAMS_REL0 = (AGC_PARAMS[0], 0.0) + AGC_PARAMS[2:]


#: (S, n, o0, F, to) for every rel0 plan; then, for K2r's serial plans only
#: (a blocked plan takes whole grid steps), the 128-frame tile's edges
_REL0_CASES = [
    (3, 640, 0, 5000, 160), (512, 1280, 320, 4000, 160),
    (4, 5120, 960, 7000, 160),  # n > 4096: the block reads its own squares back
    (6, 1280, 640, 3000, 320),  # 22.05 -> 48 kHz: m*to = 640
]
_REL0_EDGES = [(3, 1, 0, 5000, 160), (5, 127, 0, 5000, 160), (4, 128, 128, 5000, 160),
               (3, 129, 77, 5000, 160), (5, 255, 333, 5000, 160),
               (6, 129, 640, 3000, 320)]


@pytest.mark.parametrize("ring_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("plan,S,n,o0,F,to", [
    (plan, *case) for plan in fused.AGC_REL0_PLANS for case in _REL0_CASES
] + [(plan, *case) for plan in ("rel0", "rel0f") for case in _REL0_EDGES])
def test_k2r_k2b_rel0_plans_match_plain(dev, ring_dtype, plan, S, n, o0, F, to):
    """K2r (rel0, rel0f) and K2b (rel0b*, rel0c*) at 44.1 and 22.05 kHz,
    from the stream's start and mid-stream (o0 > 0, on the step grid; K2r
    also off it, and at the tile's edges)."""
    rng = np.random.default_rng(S * 100 + n + to)
    L, fr = 2 * S, 147
    pcm = _f32(rng.standard_normal((F, L)) * 0.3, dev)
    left, phase = output_positions(o0, n, fr, to, dev)
    wts = _f32(np.stack(lerp_weights(fr, to), axis=1), dev)[phase]
    agc = _f32(np.stack([rng.uniform(10, 100, S), rng.uniform(0, .5, S),
                         rng.uniform(.5, 3, S)]), dev)
    ring = _f32(rng.uniform(0, 0.1, (4096, L)), dev).to(ring_dtype)
    gains = np.repeat(rng.uniform(0.5, 1.5, S) / S, 2)
    kw = dict(gains=_f32(gains, dev),
              coeffs=_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev),
              bq=_f32(rng.standard_normal((4, L)) * 0.01, dev), agc=agc,
              agc_params=_f32(AGC_PARAMS_REL0, dev), ring=ring, ring_row=o0 % 4096,
              agc_plan=plan, step_frames=2 * to)
    blocked = fused.rel0_chunks(plan) > 0
    before = (fused.agc_rel0_launches, fused.agc_blocked_launches, fused.agc_launches)
    mk, bk, ak, rk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw)
    mp, bp, ap, rp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw)
    torch.cuda.synchronize()
    after = (fused.agc_rel0_launches, fused.agc_blocked_launches, fused.agc_launches)
    assert after == (before[0] + (not blocked), before[1] + blocked, before[2])
    assert (mk - mp).abs().max().item() <= 1e-6
    assert torch.equal(bk, bp) and torch.equal(ak, ap) and torch.equal(rk, rp)
    assert torch.equal(ak[1], agc[1])  # the peak carry untouched


@pytest.mark.parametrize("ring_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("plan", [p for p in fused.AGC_REL0_PLANS if fused.rel0_chunks(p)])
@pytest.mark.parametrize("to,m,S,n", [
    (160, 2, 5, 1280),   # 44.1 kHz, grid steps of 320: chunks of 5 to 40
    (160, 8, 4, 2560),   # ... steps of 1280: chunks of 20 to 160
    (320, 2, 6, 1280),   # 22.05 kHz, steps of 640: chunks of 10 to 80
    (320, 4, 4, 2560),   # ... steps of 1280: chunks of 20 to 160
])
def test_k2b_chunks_across_tiles(dev, ring_dtype, plan, to, m, S, n):
    """K2b's chunks against its 128-frame tiles: chunks of 20 and 40 cross
    tile edges, chunks of 160 span two tiles (pass 2 carries a chunk's
    partial maps from tile to tile); a block mid-stream, on the step grid,
    its ring warm. Carries and ring bit-equal, the mix within 1e-6."""
    step = m * to
    rng = np.random.default_rng(S * 10 + n + to + m)
    L, fr, o0 = 2 * S, 147, 2 * step
    F = (o0 + n) * fr // to + 8
    pcm = _f32(rng.standard_normal((F, L)) * 0.3, dev)
    left, phase = output_positions(o0, n, fr, to, dev)
    wts = _f32(np.stack(lerp_weights(fr, to), axis=1), dev)[phase]
    ring = _f32(rng.uniform(0, 0.1, (4096, L)), dev).to(ring_dtype)
    agc = _f32(np.stack([ring.float().cpu().numpy().reshape(4096, S, 2)[:, :, 1].sum(0),
                         rng.uniform(0, .5, S), rng.uniform(.5, 3, S)]), dev)
    kw = dict(gains=_f32(np.repeat(rng.uniform(0.5, 1.5, S) / S, 2), dev),
              coeffs=_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev),
              bq=_f32(rng.standard_normal((4, L)) * 0.01, dev), agc=agc,
              agc_params=_f32(AGC_PARAMS_REL0, dev), ring=ring, ring_row=o0 % 4096,
              agc_plan=plan, step_frames=step)
    before = fused.agc_blocked_launches
    mk, bk, ak, rk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw)
    mp, bp, ap, rp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw)
    torch.cuda.synchronize()
    assert fused.agc_blocked_launches == before + 1
    assert (mk - mp).abs().max().item() <= 1e-6
    assert torch.equal(bk, bp) and torch.equal(ak, ap) and torch.equal(rk, rp)


@pytest.mark.parametrize("plan", ["rel0f", "rel0b16", "rel0c16"])
def test_rel0_flagship_on_card_matches_cpu(dev, plan):
    """make_flagship(agc_plan=plan) on the card against the CPU, 3 blocks of
    640, the last two with no host synchronisation (the first builds the
    limiter's tables): K2r or K2b and K3 once per block."""
    kw = dict(seconds=0.5, scan_mode="fused", with_agc=True, agc_plan=plan,
              precision="int2")
    node_g, st_g = make_flagship(12, device=dev, **kw)
    node_c, st_c = make_flagship(12, device="cpu", **kw)
    counters = (lambda: (fused.agc_rel0_launches, fused.agc_blocked_launches,
                         limiter_block.launches))
    before = counters()
    st_g, og1, _ = render_blocks(node_g, st_g, 1, 640)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, og2, _ = render_blocks(node_g, st_g, 2, 640)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = counters()
    og = torch.cat([og1, og2], dim=1)
    _, oc, _ = render_blocks(node_c, st_c, 3, 640)
    blocked = plan != "rel0f"
    assert tuple(a - b for a, b in zip(after, before)) == (3 * (not blocked), 3 * blocked, 3)
    # the card's master limiter is the blocked order, the CPU's the
    # sequential one (4e-6)
    assert np.abs(og.cpu().numpy() - oc.numpy()).max() <= 5e-6


# K4's bf16 instance: odd T, T % 8 != 0 (plain loads and scalar stores),
# T < 2, a part block of lanes, path B's and the unfused chain's shapes
@pytest.mark.parametrize("L,T", [
    (5, 0), (5, 1), (5, 2), (3, 7), (8, 127), (8, 129), (13, 300), (6, 4100),
    (2, 4096), (1024, 12800), (11, 4096), (9, 1000),
])
def test_k4_bf16_matches_plain(dev, L, T):
    rng = np.random.default_rng(L * 11 + T)
    x = _f32(rng.standard_normal((L, T)) * 0.3, dev).to(torch.bfloat16)
    st = tuple(_f32(rng.standard_normal(L) * 0.1, dev) for _ in range(4))
    coef = _f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev)
    before = cuda_scan.bf16_launches
    yk, sk = cuda_scan.biquad_df1(x, coef, st)
    yp, sp = cuda_scan.biquad_df1_plain(x, coef, st)
    torch.cuda.synchronize()
    assert cuda_scan.bf16_launches == before + 1
    assert yk.dtype == torch.bfloat16 and torch.equal(yk, yp)
    for a, b in zip(sk, sp):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_k4_bf16_misaligned_and_across_calls(dev):
    """x off 16-byte alignment (plain loads) and two calls in a row: the
    second's feedback is the first's stored, rounded output."""
    rng = np.random.default_rng(3)
    L, T = 9, 4096
    buf = _f32(rng.standard_normal(L * T + 1) * 0.3, dev).to(torch.bfloat16)
    x = buf[1:].view(L, T)
    assert x.data_ptr() % 16 != 0
    coef = _f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev)
    sk = sp = tuple(torch.zeros(L, device=dev) for _ in range(4))
    for xx in (x, x.flip(1).contiguous()):
        yk, sk = cuda_scan.biquad_df1(xx, coef, sk)
        yp, sp = cuda_scan.biquad_df1_plain(xx, coef, sp)
        assert torch.equal(yk, yp) and all(torch.equal(a, b) for a, b in zip(sk, sp))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_scan.biquad_df1(x.half(), coef, sk)


@pytest.mark.parametrize("G,n", [(1, 4096), (1, 1), (3, 777), (130, 64), (1, 0)])
def test_phase_kernel_matches_plain(dev, G, n):
    from rodio_tpu_torch.ops import phase

    rng = np.random.default_rng(G + n)
    p0 = _f32(rng.uniform(0, 1, G), dev)
    step = _f32(rng.uniform(1e-3, 0.2, G), dev)
    before = phase.launches
    pk, ck = phase.phase_accumulate(p0, step, n)
    pp, cp = phase.phase_accumulate_plain(p0, step, n)
    torch.cuda.synchronize()
    assert phase.launches == before + 1
    assert torch.equal(pk, pp) and torch.equal(ck, cp)


def test_ring_resampler_on_card_matches_cpu(dev):
    """The streaming ring path (an Amplify upstream is not random-access),
    spans included, on the card against the CPU, with no host read."""
    from rodio_tpu_torch.conversions import Resample, Uniform
    from rodio_tpu_torch.effects import Amplify

    rng = np.random.default_rng(9)
    data = rng.uniform(-1, 1, (4, 20000)).astype(np.float32)
    outs = []
    for d in (dev, "cpu"):
        src = Amplify(SamplesBuffer(4, 44100, data, device=d), 0.5)
        for node in (Resample(src, 48000, max_block=1024),
                     Uniform(src, 2, 48000, rodio_compat=True, max_block=1024)):
            st = node.init_state()
            if d is dev:
                torch.cuda.set_sync_debug_mode("error")
            try:
                _, out, valids = render_blocks(node, st, 24, 1000)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs.append((out.cpu(), valids.cpu()))
    for (a, va), (b, vb) in zip(outs[:2], outs[2:]):
        assert torch.equal(va, vb)
        assert (a - b).abs().max().item() <= 1e-6


# -- threefry, the noise sources, dither, varispeed and the control plane --

@pytest.mark.parametrize("mode,n,kw", [
    ("bits", 1, {}), ("bits", 4097, {}), ("bits", 1 << 20, {}),
    ("uniform", 4096, dict(lo=-1.0, hi=1.0)), ("uniform", 777, {}),
    ("uniform", 3001, dict(lo=float(np.nextafter(np.float32(-1), np.float32(0))), hi=1.0)),
    ("velvet", 4096, dict(grid=24)), ("velvet", 513, dict(grid=7)),
    ("pink", 4096, {}), ("pink", 1, {})])
@pytest.mark.parametrize("i", [0, 2 ** 31 - 100, -2 ** 31])
def test_threefry_kernel_matches_plain(dev, mode, n, kw, i):
    """Threefry's four modes bit-equal to the plain int64 version, one
    launch each, the counter across the int32 wrap."""
    from rodio_tpu_torch.ops import threefry

    key = threefry.seed_key(77, dev)
    ctr = torch.full((), i, dtype=torch.int64, device=dev)
    before = threefry.launches
    k = threefry.threefry(key, ctr, n, mode, **kw)
    p = threefry.threefry_plain(key, ctr, n, mode, **kw)
    torch.cuda.synchronize()
    assert threefry.launches == before + 1
    if mode == "bits":
        k = k.to(torch.int64) & threefry.M32
    assert torch.equal(k, p)


def test_threefry_kernel_refuses(dev):
    from rodio_tpu_torch.ops import threefry

    key = threefry.seed_key(1, dev)
    ctr = torch.zeros((), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        threefry.threefry(key, ctr, 16, "velvet", grid=0)
    with pytest.raises(ValueError):
        threefry.threefry(key, ctr, 16, "nope")
    with pytest.raises(ValueError):  # the key must be int64 [2] on the card
        threefry.threefry(key.to(torch.int32), ctr, 16, "bits")


NOISE_BOUNDS = {"WhiteGaussian": 2e-6, "Brownian": 1e-5}


@pytest.mark.parametrize("name", ["WhiteUniform", "WhiteTriangular", "WhiteGaussian",
                                  "Velvet", "Pink", "Blue", "Violet", "Brownian", "Red"])
def test_noise_sources_on_card_match_cpu(dev, name):
    """Path K at a small size: 3 blocks on the card against the CPU,
    bit-equal but the erf_inv sources (PyTorch's log1p and sqrt may round
    an ulp apart on the two devices)."""
    from rodio_tpu_torch.ops import threefry
    from rodio_tpu_torch.profile_slice import noise_source

    outs = []
    for d in (dev, "cpu"):
        node = noise_source(name, d)
        st = node.init_state()
        st["i"] = torch.full((), 2 ** 31 - 700, dtype=torch.int64, device=st["i"].device)
        before = threefry.launches
        _, out, _ = render_blocks(node, st, 3, 511)
        if d is dev:
            torch.cuda.synchronize()
            assert threefry.launches == before + 3
        outs.append(out.cpu())
    assert (outs[0] - outs[1]).abs().max().item() <= NOISE_BOUNDS.get(name, 0.0)


@pytest.mark.parametrize("algo", ["tpdf", "rpdf", "gpdf", "highpass"])
def test_dither_on_card_matches_cpu(dev, algo):
    from rodio_tpu_torch.effects import Dither

    data = np.random.default_rng(2).uniform(-0.9, 0.9, (2, 3000)).astype(np.float32)
    outs = [render_blocks(n, n.init_state(), 4, 1000)[1].cpu() for n in (
        Dither(SamplesBuffer(2, 48000, data, device=d), 16, algo, seed=4) for d in (dev, "cpu"))]
    bound = 4 * 2.0 ** -21 * 2.0 ** -15 + 2.0 ** -24 if algo == "gpdf" else 0.0
    assert (outs[0] - outs[1]).abs().max().item() <= bound


def test_varispeed_on_card_matches_cpu(dev):
    """A ratio schedule on the card against the CPU, with no host read in
    emit."""
    from rodio_tpu_torch.conversions import VariSpeed

    data = (np.random.default_rng(3).standard_normal((2, 6000)) * 0.4).astype(np.float32)
    outs = []
    for d in (dev, "cpu"):
        node = VariSpeed(SamplesBuffer(2, 44100, data, device=d), ratio=0.75, max_block=512)
        st = node.init_state()
        blocks = []
        if d is dev:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for k, r in enumerate((0.75, 1.0, 1.3, 2.5, 0.5, 1.7) * 3):
                st = node.set_ratio(st, r)
                st, out, _ = node.emit(st, 512)
                blocks.append(out)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append(torch.cat(blocks, dim=1).cpu())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6


def test_config3_small_on_card_matches_cpu(dev):
    """Path I at 0.1 s: the 64-source mix on the card against the CPU."""
    from rodio_tpu_torch.ops import phase
    from rodio_tpu_torch.profile_slice import config3, pull_to_end

    res = []
    for d in (dev, "cpu"):
        _, rx = config3(d, 0.1)
        before = phase.launches
        blocks, pulls = pull_to_end(rx, 2048)
        if d is dev:
            assert phase.launches - before == 60 * pulls
        res.append((torch.cat(blocks, dim=1).cpu(), pulls))
    assert res[0][1] == res[1][1]
    assert (res[0][0] - res[1][0]).abs().max().item() <= 1e-6


def test_player_script_on_card_matches_cpu(dev):
    """Path J, the first 450 blocks (through the seek and the skip)."""
    from rodio_tpu_torch.profile_slice import player_script

    a = player_script(dev, 450).cpu()
    b = player_script("cpu", 450)
    assert (a - b).abs().max().item() <= 1e-6
    assert a.abs().max().item() > 0.1


def test_seek_and_checkpoint_on_card(dev, tmp_path):
    """Path L at 3 s: seek on path B's chain replays the same blocks for
    any target past the pre-roll, lands where the CPU lands, and a
    checkpoint loads back on the card and continues bit-equal."""
    from rodio_tpu_torch.graph import seek
    from rodio_tpu_torch.graph.checkpoint import load_state, save_state
    from rodio_tpu_torch.profile_slice import config2

    outs, replays = [], []
    for d in (dev, "cpu"):
        node = config2(d, 0, seconds=3)
        st = seek.seek_state(node, 2.0, pre_roll=0.5)
        replays.append(seek.replayed_blocks)
        st, out, _ = render_blocks(node, st, 2, 4096)
        outs.append(out.cpu())
        if d is dev:
            path = str(tmp_path / "s.npz")
            save_state(path, st)
            st2 = load_state(path, node.init_state())
            assert st2["integ"].device.type == "cuda"
            _, a, _ = render_blocks(node, st, 2, 4096)
            _, b, _ = render_blocks(node, st2, 2, 4096)
            assert torch.equal(a, b)
    assert replays[0] == replays[1] == -(-int(0.5 * 44100) // 8192)
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6


def test_sqrt_rn_on_card(dev):
    """``sqrt_rn`` on the card is CUDA's f32 sqrt, which is correctly
    rounded: it equals the CPU's sqrt_rn (the f64 root and its exact
    correction) on every element."""
    from rodio_tpu_torch.core.math import sqrt_rn

    x = _f32(np.abs(np.random.default_rng(5).standard_normal(1 << 20)) * 9.0, dev)
    assert torch.equal(sqrt_rn(x).cpu(), sqrt_rn(x.cpu()))


# -- the io layer (M7): no kernel of its own; the device side on the card --

class _HostBlocks:
    """A host-driven source over a list of [C, n] numpy blocks."""

    def __init__(self, blocks, rate=48000):
        from rodio_tpu_torch.core.types import StreamSpec

        self.spec = StreamSpec(blocks[0].shape[0], rate)
        self._it = iter(blocks)

    def next_block(self, n):
        b = next(self._it, None)
        if b is None:
            return np.zeros((self.spec.channels, n), np.float32), False
        return b, True


@pytest.mark.parametrize("delay", ["consumer", "copy"])
def test_device_feeder_pinned_double_buffer(dev, delay):
    """200 blocks through DeviceFeeder with the consumer's stream held back
    by a sleep kernel before each use (or the side stream, before each
    copy): every block bit-equal to its host block. A pinned buffer
    refilled while its copy is still in flight, or a block read before its
    copy, would show here."""
    from rodio_tpu_torch.io.streaming import DeviceFeeder

    rng = np.random.default_rng(200)
    blocks = [rng.standard_normal((2, 4096)).astype(np.float32) for _ in range(200)]
    feeder = DeviceFeeder(_HostBlocks(blocks), 4096, device=dev)
    outs = []
    for _ in range(200):
        torch.cuda._sleep(100_000 if delay == "consumer" else 0)
        if delay == "copy":
            with torch.cuda.stream(feeder._stream):
                torch.cuda._sleep(100_000)
        b, alive = feeder.next_device_block()
        assert alive and b.device == dev
        outs.append(b * 1.0)  # read on the consumer's stream
    torch.cuda.synchronize()
    for o, h in zip(outs, blocks):
        assert torch.equal(o.cpu(), torch.from_numpy(h))
    assert not feeder.next_device_block()[1]


def test_push_port_feed_loop_on_card_matches_cpu(dev):
    """The feed loop (next_device_block -> push -> emit) under sync-debug
    "error": no host wait; the outputs and the port's state equal the
    CPU's."""
    from rodio_tpu_torch.io.streaming import DeviceFeeder, PushPort

    rng = np.random.default_rng(7)
    blocks = [rng.standard_normal((2, 512)).astype(np.float32) for _ in range(30)]
    res = []
    for d in (dev, "cpu"):
        port = PushPort(2, 48000, 1024, 512, device=d)
        feeder = DeviceFeeder(_HostBlocks(blocks), 512, device=d)
        st, outs = port.init_state(), []
        if d is dev:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for k in range(30):
                blk, _ = feeder.next_device_block()
                st = port.push(st, blk, 512 - (k % 3), k % 2)
                st, out, _ = port.emit(st, 500)
                outs.append(out)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        res.append((torch.cat(outs, 1).cpu(), {k: v.cpu() for k, v in st.items()}))
    assert torch.equal(res[0][0], res[1][0])
    for k in res[1][1]:
        assert torch.equal(res[0][1][k], res[1][1][k]), k


def test_resample_push_port_on_card(dev):
    """Resample(PushPort) 44.1 -> 48 kHz on the card equals the CPU's and
    Resample(Decoder)'s on the card (the weight form on both)."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_io_fixtures import pcm16_master, resampled_feed
    from rodio_tpu_torch.conversions.resample import Resample

    _, pcm = pcm16_master(3, 2, 3 * 44100)
    outs = [resampled_feed(pcm, 44100, 48000, 4096, 20, device=d)[1].cpu() for d in (dev, "cpu")]
    ref = Resample(SamplesBuffer(2, 44100, pcm, device=dev), 48000)
    _, want, _ = render_blocks(ref, ref.init_state(), 20, 4096)
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6
    assert (outs[0] - want.cpu()).abs().max().item() <= 1e-6


def test_looped_decoder_and_decoder_on_card_match_cpu(dev, tmp_path):
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_io_fixtures import pcm16_master, write_flac
    from rodio_tpu_torch.io.decoder import Decoder, LoopedDecoder
    from rodio_tpu_torch.io.wav import read_wav

    k, master = pcm16_master(4, 2, 30000)
    path = str(tmp_path / "a.flac")
    write_flac(path, k, 44100)
    for block in (4096, 9000):  # within the pre-filled tail, and past it
        outs = []
        for d in (dev, "cpu"):
            node = LoopedDecoder(path, device=d)
            _, o, v = render_blocks(node, node.init_state(), -(-3 * 30000 // block), block)
            outs.append(o.cpu())
        assert torch.equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[0][:, 30000:60000].numpy(), master)
    d = Decoder(path, device=dev)
    assert d.init_state()["data"].device == dev
    d.low_pass(2000.0).to_file(str(tmp_path / "o.wav"))
    c = Decoder(path, device="cpu").low_pass(2000.0)
    assert torch.equal(torch.from_numpy(read_wav(str(tmp_path / "o.wav"))[0]),
                       torch.from_numpy(c.render()))


def test_hosted_blocks_and_the_sink_on_card(dev, tmp_path):
    """A Microphone's numpy blocks summed into a mixer on the card, through
    a file sink (one read-back a buffer): the WAV equals the CPU's."""
    from rodio_tpu_torch.io.device import DeviceSinkBuilder
    from rodio_tpu_torch.io.microphone import Microphone, MicrophoneConfig
    from rodio_tpu_torch.io.wav import read_wav

    voice = np.random.default_rng(1).uniform(-0.3, 0.3, (2, 8192)).astype(np.float32)
    tone = np.full((2, 8192), 0.25, np.float32)
    outs = []
    for d in (dev, "cpu"):
        path = str(tmp_path / f"{len(outs)}.wav")
        sink = DeviceSinkBuilder(device=d).to_file(path).prefer_buffer_frames(2048).open()
        mic = Microphone(MicrophoneConfig(channels=2, sample_rate=48000, buffer_duration=1.0))
        assert mic.feed(np.ascontiguousarray(voice.T).reshape(-1)) == voice.size
        sink.mixer().add(SamplesBuffer(2, 48000, tone, device=d))
        sink.mixer().add(mic)
        sink.render_blocks(4)
        sink.close()
        outs.append(read_wav(path)[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], tone + voice)


# -- M8: K1's ring mode, the farm and the sharded farm on the card --

@pytest.mark.parametrize("S,C,n,R,c0", [
    (4, 2, 640, (4 * 4 + 1) * 147, 15),     # a small farm: the block's rows wrap
    (3, 2, 1280, 300, 3),                   # a ring barely over a tile's 192 rows
    (5, 1, 129, 200, 1),                    # C = 1, a tail tile
    (2, 12, 640, 441, 2),                   # C > 8: one stream a block
    (512, 2, 12800, (4 * 80 + 1) * 147, 283),  # the farm's block at 512 streams
    (512, 2, 12800, (4 * 80 + 1) * 147, 241),  # ... its last right tap at row R
])
def test_k1_ring_mode_matches_plain_across_the_seam(dev, S, C, n, R, c0):
    """K1's ring mode against its plain version, two blocks in a row, at a
    start whose staged tiles and last right tap cross ring row R."""
    fr, to = 147, 160
    rng = np.random.default_rng(S * 31 + n)
    L = S * C
    ring = _f32(rng.standard_normal((R, L)) * 0.1, dev)
    kw = dict(gains=_f32(rng.uniform(0.1, 1.0, L), dev), channels=C,
              coeffs=_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev))
    o0 = c0 * to
    bk = bp = _f32(rng.standard_normal((4, L)) * 0.01, dev)
    crossed = False
    for block in range(2):
        left, phase = output_positions(o0 + block * n, n, fr, to, dev)
        crossed |= bool(((left // R) != ((left + 1) // R)).any() or
                        (left[0] // R != left[-1] // R))
        wts = _f32(np.stack(lerp_weights(fr, to), axis=1), dev)[phase]
        before = fused.ring_launches
        mk, bk = fused.fused_resample_biquad_mix(ring, left, wts, bq=bk, ring=True, **kw)
        mp, bp = fused.fused_resample_biquad_mix_plain(ring, left, wts, bq=bp, ring=True, **kw)
        torch.cuda.synchronize()
        assert fused.ring_launches == before + 1
        assert (mk - mp).abs().max().item() <= 1e-6, block
        assert torch.equal(bk, bp), block
    assert crossed


def test_k1_ring_mode_rows_outside_the_staged_range(dev):
    """48 -> 22.05 kHz over a ring: the later frames of a tile load their
    rows from global memory, modulo the ring there too."""
    fr, to, S, C, n, R = 320, 147, 4, 2, 300, 1000
    rng = np.random.default_rng(9)
    ring = _f32(rng.standard_normal((R, S * C)) * 0.1, dev)
    kw = dict(gains=_f32(rng.uniform(0.1, 1.0, S * C), dev), channels=C,
              coeffs=_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev),
              bq=_f32(np.zeros((4, S * C)), dev))
    left, phase = output_positions(2 * to + 5, n, fr, to, dev)
    assert int(left[-1]) > R
    wts = _f32(np.stack(lerp_weights(fr, to), axis=1), dev)[phase]
    mk, bk = fused.fused_resample_biquad_mix(ring, left, wts, ring=True, **kw)
    mp, bp = fused.fused_resample_biquad_mix_plain(ring, left, wts, ring=True, **kw)
    assert (mk - mp).abs().max().item() <= 1e-6 and torch.equal(bk, bp)


def test_k1_ring_mode_in_a_cuda_graph(dev):
    """The ring kernel captured in a CUDA graph and replayed equals eager."""
    fr, to, S, n = 147, 160, 64, 1280
    R = (4 * (n // to) + 1) * fr
    rng = np.random.default_rng(4)
    ring = _f32(rng.standard_normal((R, S * 2)) * 0.1, dev)
    left, phase = output_positions(5 * to, n, fr, to, dev)
    wts = _f32(np.stack(lerp_weights(fr, to), axis=1), dev)[phase]
    kw = dict(gains=_f32(rng.uniform(0.1, 1.0, S * 2), dev), channels=2, ring=True,
              coeffs=_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev),
              bq=_f32(np.zeros((4, S * 2)), dev))
    want, _ = fused.fused_resample_biquad_mix(ring, left, wts, **kw)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fused.fused_resample_biquad_mix(ring, left, wts, **kw)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got, _ = fused.fused_resample_biquad_mix(ring, left, wts, **kw)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _farm_corpus(tmp_path, n=4, seconds=2):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_io_fixtures import pcm16_master, write_pcm_wav

    paths = []
    for i in range(n):
        k, _ = pcm16_master(60 + i, 2, seconds * 44100)
        paths.append(str(tmp_path / f"f{i}.wav"))
        write_pcm_wav(paths[-1], k, 44100, 16)
    return paths


@pytest.mark.parametrize("fused_path", [True, False])
def test_stream_farm_on_card_matches_cpu(dev, tmp_path, fused_path):
    """The farm on the card (K1's ring mode + K3, or K4 + K3; every step
    under sync-debug "error" but the 32-block read-backs) against the CPU
    farm, on the i16 wire with looping staggered streams."""
    from rodio_tpu_torch.ops import cuda_scan
    from rodio_tpu_torch.parallel.farm import StreamFarm

    paths = _farm_corpus(tmp_path)
    outs, runs = {}, {}
    for d in (dev, "cpu"):
        farm = StreamFarm(paths, block_frames=1280, fused=fused_path, wire="i16", loop=True,
                          start_offsets=[0.0, 0.5, 1.2, 1.9], device=d)
        blocks = []
        launches = (fused.ring_launches, cuda_scan.launches, limiter_block.launches)
        res = farm.run(40, on_block=lambda k, o, v: blocks.append(o),
                       sync_debug=d is dev)
        farm.close()
        runs[str(d)] = (res, tuple(a - b for a, b in zip(
            (fused.ring_launches, cuda_scan.launches, limiter_block.launches), launches)))
        outs[str(d)] = torch.cat(blocks, 1).cpu()
    (res_card, l_card), (res_cpu, _) = runs[str(dev)], runs["cpu"]
    assert res_card[0] == res_cpu[0] == 40 * 1280 and res_card[2] is res_cpu[2] is False
    assert l_card == ((40, 0, 40) if fused_path else (0, 40, 40))
    assert (outs[str(dev)] - outs["cpu"]).abs().max().item() <= 1e-6


def test_fused_farm_overflow_on_card_matches_cpu(dev):
    """Pushes past the ring with no emit set the overflow flag on the card
    as on the CPU, with no read-back in the emits."""
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.flagship import ChunkRingFeed, FusedFarmPipeline

    flags = []
    for d in (dev, "cpu"):
        feed = ChunkRingFeed(8, 44100, 147, 4, 16, "int2", np.full(8, 0.25, np.float32),
                             gain_post=True, device=d)
        m = Limit(FusedFarmPipeline(feed, 48000, 4), LimitSettings(), mode="auto")
        st = m.init_state()
        rng = np.random.default_rng(1)

        def push(st, T, prime=False):
            b = torch.from_numpy(rng.standard_normal((8, T)).astype(np.float32) * 0.1).to(d)
            return {**st, "in": {**st["in"], "in": feed.push(st["in"]["in"], b, prime=prime)}}

        st = push(st, 5 * 147, prime=True)
        seen = []
        for k in range(8):
            st = push(st, 4 * 147)
            if k >= 3:
                st = push(st, 4 * 147)  # running ahead of the emits
            st, _, _ = m.emit(st, 640)
            seen.append(bool(st["in"]["in"]["overflow"]))
        flags.append(seen)
    assert flags[0] == flags[1] and flags[0][0] is False and flags[0][-1] is True


def test_sharded_stream_farm_nccl_group_of_one(dev, tmp_path):
    """ShardedStreamFarm over a NCCL group of one (initialised here, on a
    free localhost port) is bit-equal to the single-card fused farm."""
    import socket

    import torch.distributed as dist

    from rodio_tpu_torch.parallel.farm import StreamFarm
    from rodio_tpu_torch.parallel.sharded_farm import ShardedStreamFarm
    from rodio_tpu_torch.parallel.sharding import stream_mesh

    paths = _farm_corpus(tmp_path)
    kw = dict(block_frames=1280, wire="i16", loop=True, start_offsets=[0.0, 0.3, 0.6, 0.9])
    farm = StreamFarm(paths, fused=True, device=dev, **kw)
    a = []
    farm.run(8, on_block=lambda k, o, v: a.append(o))
    farm.close()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        sfarm = ShardedStreamFarm(paths, stream_mesh(), device=dev, **kw)
        b = []
        sfarm.run(8, on_block=lambda k, o, v: b.append(o))
        sfarm.close()
    finally:
        dist.destroy_process_group()
    assert torch.equal(torch.cat(a, 1), torch.cat(b, 1))
