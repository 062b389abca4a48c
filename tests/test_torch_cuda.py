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
The f64 instances of K4, K5, K6, K7, K8, threefry and the phase
accumulator bit-equal to their f64 plain versions, K3's within 1e-12 (its
f32 instance is held at 1e-6); the f64 noise sources and Dither on the card
against the CPU bit-equal but the erf_inv ones (NOISE_BOUNDS_F64); the
associative scans of ``mode="parallel"`` (torch ops) bit-equal between the
card and the CPU; K1 and K2, which have no f64 instance (ROADMAP F8), raise
``NotImplementedError`` by name on an f64 CUDA tensor. The buffer's pack
(the time-major PCM and the content probe's flags) bit-equal to its plain
version, flags included (``probe_cases.py``), its f64 instance too.
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
from probe_cases import FAIL_ONE as PROBE_FAIL_ONE
from probe_cases import NAMES as PROBE_CASES
from probe_cases import case as probe_case
from rodio_tpu_torch.ops import cuda_scan, fused, limiter_block, pack
from rodio_tpu_torch.sources.generators import SamplesBuffer
from rodio_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


def launched(*entries):
    """The launches counted so far of each kernel entry point named
    (``trace.counts``), as a tuple."""
    return tuple(trace.counts[e] for e in entries)


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
    before = trace.counts["rt_biquad_df1"]
    yk, sk = cuda_scan.biquad_df1(x, coef, st)
    yp, sp = cuda_scan.biquad_df1_plain(x, coef, st)
    torch.cuda.synchronize()
    assert trace.counts["rt_biquad_df1"] == before + 1
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
    before = trace.counts["rt_limiter_master"]
    yk, ck = limiter_block.limiter_master(x, i0, p0, **kw)
    yp, cp = limiter_block.limiter_master_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert trace.counts["rt_limiter_master"] == before + 1
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
        before = trace.counts["rt_fused_resample_biquad_mix"]
        mk, bk = fused.fused_resample_biquad_mix(pcm, left, wts, bq=bk, **kw)
        mp, bp = fused.fused_resample_biquad_mix_plain(pcm, left, wts, bq=bp, **kw)
        torch.cuda.synchronize()
        assert trace.counts["rt_fused_resample_biquad_mix"] == before + 1
        assert (mk - mp).abs().max().item() <= 1e-6, block
        assert torch.equal(bk, bp), block


def test_flagship_on_card_matches_cpu(dev):
    """The fused slice and the unfused chain on the card against the same
    graphs on the CPU (plain versions), 3 blocks of 640."""
    for mode, bound in (("fused", 1e-6), ("auto", 1e-6)):
        node_g, st_g = make_flagship(8, seconds=0.5, scan_mode=mode, device=dev)
        node_c, st_c = make_flagship(8, seconds=0.5, scan_mode=mode, device="cpu")
        kernels = ("rt_fused_resample_biquad_mix", "rt_limiter_master", "rt_biquad_df1")
        before = launched(*kernels)
        _, og, vg = render_blocks(node_g, st_g, 3, 640)
        _, oc, vc = render_blocks(node_c, st_c, 3, 640)
        after = launched(*kernels)
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
    before = trace.counts["rt_limiter_env"]
    pk, ck = cuda_scan.limiter_env(x, i0, p0, **kw)
    pp, cp = cuda_scan.limiter_env_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert trace.counts["rt_limiter_env"] == before + 1
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
            before = trace.counts["rt_limiter_stream"]
            st, out, _ = render_blocks(node, node.init_state(), 3, n)
            if device != "cpu":
                assert trace.counts["rt_limiter_stream"] == before + 3
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
    before = trace.counts["rt_limiter_stream"]
    yk, ck = cuda_scan.limiter_stream(x, i0, p0, **kw)
    yp, cp = cuda_scan.limiter_stream_plain(x if xp is None else xp, i0, p0, **kw)
    torch.cuda.synchronize()
    assert trace.counts["rt_limiter_stream"] == before + 1
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
    before = launched("rt_limiter_stream", "rt_limiter_env")
    yk, ck = cuda_scan.limiter_stream(x, i0, p0, **kw)
    yp, cp = cuda_scan.limiter_stream_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert launched("rt_limiter_stream", "rt_limiter_env") == (
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
    kernels = ("rt_fused_resample_biquad_agc_group_mix", "rt_fused_resample_biquad_agc_mix")
    before = launched(*kernels)
    mk, bk, ak, rk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw)
    mp, bp, ap, rp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw)
    torch.cuda.synchronize()
    assert launched(*kernels) == (before[0] + 1, before[1])
    assert (mk - mp).abs().max().item() <= 1e-6
    assert torch.equal(bk, bp) and torch.equal(ak, ap) and torch.equal(rk, rp)


def test_group_agc_flagship_on_card_matches_cpu(dev):
    """make_flagship(agc_group=16) on the card against the CPU, 3 blocks of
    640: K2g and K3 once per block."""
    kw = dict(seconds=0.5, scan_mode="fused", with_agc=True, agc_group=16)
    node_g, st_g = make_flagship(12, device=dev, **kw)
    node_c, st_c = make_flagship(12, device="cpu", **kw)
    before = launched("rt_fused_resample_biquad_agc_group_mix", "rt_limiter_master")
    _, og, _ = render_blocks(node_g, st_g, 3, 640)
    after = launched("rt_fused_resample_biquad_agc_group_mix", "rt_limiter_master")
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
    before = trace.counts["rt_dma_ring"]
    want = dma_roofline.dma_ring_plain(x, tr=tr)
    kw = dict(tr=tr, depth=depth, lanes=lanes, route=route)
    if dma_roofline.ring_bytes(tr, lanes, depth, route) > dma_roofline.SMEM_OPTIN:
        with pytest.raises(ValueError, match="shared memory"):
            dma_roofline.dma_ring(x, **kw)  # refused before it launches
        assert trace.counts["rt_dma_ring"] == before
        return
    got = dma_roofline.dma_ring(x, **kw)
    torch.cuda.synchronize()
    assert trace.counts["rt_dma_ring"] == before + 1
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
    before = trace.counts["rt_dma_ring"]
    with torch.cuda.graph(g, stream=side):
        outs = [(dma_roofline.dma_ring(x, tr=tr),
                 dma_roofline.dma_ring(x, tr=tr, depth=3, route="cp.async"),
                 dma_roofline.stream_max(x)) for x in xs]
    assert trace.counts["rt_dma_ring"] == before + 6  # counted where captured
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trace.counts["rt_dma_ring"] == before + 6  # replays add none
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
    before = trace.counts["rt_agc"]
    gk, ck = cuda_scan.agc(xs, delta, p0, s0, g0, params)
    gp, cp = cuda_scan.agc_plain(xs, delta, p0, s0, g0, params)
    torch.cuda.synchronize()
    assert trace.counts["rt_agc"] == before + 1
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
    before = trace.counts["rt_first_order"]
    yk = cuda_scan.first_order(a, b, init, c, **kw)
    yp = cuda_scan.first_order_plain(a, b, init, c, **kw)
    torch.cuda.synchronize()
    assert trace.counts["rt_first_order"] == before + 1
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
            before = trace.counts["rt_blocked_max_affine"]
            yk = limiter_block.blocked_max_affine_const(x, v0, a, P=P)
            yp = limiter_block.blocked_max_affine_const_plain(x, v0, a, P=P)
            torch.cuda.synchronize()
            assert trace.counts["rt_blocked_max_affine"] == before + 1
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
    _k2_matches_plain(pcm, left, wts, kw)


def _k2_matches_plain(pcm, left, wts, kw):
    """One launch of K2 against its plain version on the same inputs: the
    mix within 1e-6 (the order of its sum over streams and blocks), the
    biquad and AGC carries and the ring bit for bit."""
    before = trace.counts["rt_fused_resample_biquad_agc_mix"]
    mk, bk, ak, rk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw)
    mp, bp, ap, rp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw)
    torch.cuda.synchronize()
    assert trace.counts["rt_fused_resample_biquad_agc_mix"] == before + 1
    assert rk.dtype == kw["ring"].dtype
    assert (mk - mp).abs().max().item() <= 1e-6
    assert torch.equal(bk, bp) and torch.equal(ak, ap) and torch.equal(rk, rp)


def _bench_job(name, streams, dev, blocks, seed=0xA6C):
    """The benchmark's configuration ``name`` at ``streams``: its config
    module, its plain reference, its sizes, and a job's seeded PCM and
    gains."""
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from gpubench import harness, signals

    bench = os.path.join(root, "gpubench")
    cfg = json.load(open(os.path.join(bench, "configs", f"{name}.json")))
    cfg["streams"] = streams
    config = harness.load_module(os.path.join(bench, "configs", f"{name}.py"),
                                 f"cuda_test_{name}")
    ref = harness.load_module(os.path.join(bench, "reference", f"{name}.py"),
                              f"cuda_test_reference_{name}")
    fr, to = config.ratio(cfg)
    n_out = blocks * cfg["block_frames"]
    n_in = n_out * fr // to + fr
    rng = np.random.default_rng([seed, 0])
    pcm = signals.corpus(signals.generator(seed, dev), rng, streams, 2, n_in, 44100, dev)
    gains = rng.uniform(0.5, 1.5, streams).astype(np.float32) / np.float32(streams)
    return config, ref, cfg, pcm, gains, n_out


def test_config5_agc512_job_runs_k2_once_a_block(dev):
    """One job of the benchmark's config5_agc512 at 16 streams, 3 blocks of
    the cell's 12800: one K2 launch a block and no K1, and the mix within
    1e-5 of the plain reference (the CPU's chain reads 4e-7-6e-7 against it;
    the card's K2 sums the mix in another order and K3 limits in its blocked
    order, 4e-6 from the CPU's sequential one)."""
    config, ref, cfg, pcm, gains, n_out = _bench_job("config5_agc512", 16, dev, 3)
    chain = config.job_chain(pcm, gains, cfg, dev)
    state = chain.init_state()
    assert state["in"]["ring"].dtype == torch.float32
    kernels = ("rt_fused_resample_biquad_agc_mix", "rt_fused_resample_biquad_mix")
    before = launched(*kernels)
    blocks = []
    for i in range(3):
        state, y, valid = chain.emit(state, cfg["block_frames"])
        assert launched(*kernels) == (before[0] + i + 1, before[1])
        blocks.append(y)
    got = torch.cat(blocks, 1).double()
    want = ref.render(pcm, gains, cfg, n_out)
    assert (got - want).abs().max().item() <= 1e-5


def test_config5_strip512_job_runs_k4_k6_k5_k3_once_a_block(dev):
    """One job of the benchmark's config5_strip512 at 16 streams, 3 blocks of
    the cell's 12800, through the node graph: one launch a block of each of
    K4, K6, K5 (``limiter_stream``) and K3, none of K1's or K2's, and one
    channel-major copy a job. The blocks equal the same chain's plain
    versions on the CPU within 1e-6, as path C's check holds them: K4, K6
    and K5 equal their plain versions bit for bit, the mixer sums the
    streams in another order, and the CPU's master Limit runs K3's blocked
    order (``mode="pallas"``)."""
    config, _, cfg, pcm, gains, _ = _bench_job("config5_strip512", 16, dev, 3)
    n = cfg["block_frames"]
    kernels = ("rt_biquad_df1", "rt_agc", "rt_limiter_stream", "rt_limiter_master")
    fused_kernels = ("rt_fused_resample_biquad_mix", "rt_fused_resample_biquad_agc_mix")
    before = launched(*kernels, *fused_kernels, "channel_major_copy")
    chain = config.job_chain(pcm, gains, cfg, dev)
    state = chain.init_state()
    assert launched("channel_major_copy") == (before[-1] + 1,)
    plain = Limit(config.job_chain(pcm.cpu(), gains, cfg, "cpu").input,
                  LimitSettings(), mode="pallas")
    st_c = plain.init_state()
    for i in range(3):
        state, y, v = chain.emit(state, n)
        assert launched(*kernels) == tuple(b + i + 1 for b in before[:4])
        st_c, y_c, v_c = plain.emit(st_c, n)
        assert int(v) == int(v_c) == n
        assert (y.cpu() - y_c).abs().max().item() <= 1e-6
    assert launched(*fused_kernels) == before[4:6]


def test_jobs_chain_block_is_k1_k3_and_little_else(dev):
    """The jobs cell's chain (``config5_mix512`` at its 512 streams and
    block of 12800), its second block under the profiler: K1's two
    kernels, K3 and at most 3 other device operations, since the block's
    validity is counted on the host and a full block is not masked; every
    block known full on the host. The blocks equal the same chain's plain
    versions on the CPU within K1's 1e-6 (its mix sums in another order;
    the CPU's Limit runs K3's blocked order, ``mode="pallas"``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile


    config, _, cfg, pcm, gains, _ = _bench_job("config5_mix512", 512, dev, 3)
    n = cfg["block_frames"]
    chain = config.job_chain(pcm, gains, cfg, dev)
    plain = Limit(config.job_chain(pcm.cpu(), gains, cfg, "cpu").input,
                  LimitSettings(), mode="pallas")
    state, st_c = chain.init_state(), plain.init_state()
    counted = np.zeros(2, np.int64)  # the card chain's blocks: host, device
    for i in range(3):
        torch.cuda.synchronize()
        before = launched("host_valid_block", "device_masked_block")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, y, v = chain.emit(state, n)
            torch.cuda.synchronize()
        counted += np.subtract(launched("host_valid_block", "device_masked_block"), before)
        st_c, y_c, v_c = plain.emit(st_c, n)
        assert int(v) == int(v_c) == n
        assert (y.cpu() - y_c).abs().max().item() <= 1e-6
        if i == 1:
            ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            k1 = [o for o in ops if "fused_kernel" in o or "mix_partials" in o]
            k3 = [o for o in ops if "limiter_master" in o]
            assert (len(k1), len(k3)) == (2, 1), ops
            assert len(ops) <= 6, ops
    assert counted.tolist() == [3, 0]


def test_k2_f32_ring_at_the_cell_block_matches_plain(dev):
    """K2's serial plan with the f32 ring at the cell's shape (512 stereo
    streams, a block of 12800), on the second block of a job, so the
    carries and the ring are a running job's."""
    config, _, cfg, pcm, gains, _ = _bench_job("config5_agc512", 512, dev, 2)
    node = config.job_chain(pcm, gains, cfg, dev).input
    n = cfg["block_frames"]
    st, _, _ = node.emit(node.init_state(), n)
    left, wts = node._taps(n, n)
    assert st["ring"].dtype == torch.float32
    _k2_matches_plain(st["pcm"], left, wts,
                      dict(gains=st["gains"], coeffs=st["coeffs"], bq=st["bq"], agc=st["agc"],
                           agc_params=st["agc_par"], ring=st["ring"], ring_row=n % 4096))


def test_agc_flagship_on_card_matches_cpu(dev):
    """The fused AGC slice and the unfused pallas AGC chain on the card
    against the same graphs on the CPU (plain versions), 3 blocks of 640."""
    counters = (lambda: launched("rt_fused_resample_biquad_agc_mix", "rt_agc",
                                 "rt_limiter_master", "rt_biquad_df1"))
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
            before = launched("rt_blocked_max_affine", "rt_first_order")
            _, out, _ = render_blocks(node, node.init_state(), 3, 4096)
            after = launched("rt_blocked_max_affine", "rt_first_order")
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
    kernels = ("rt_fused_resample_biquad_agc_rel0_mix",
               "rt_fused_resample_biquad_agc_blocked_mix", "rt_fused_resample_biquad_agc_mix")
    before = launched(*kernels)
    mk, bk, ak, rk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw)
    mp, bp, ap, rp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw)
    torch.cuda.synchronize()
    after = launched(*kernels)
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
    before = trace.counts["rt_fused_resample_biquad_agc_blocked_mix"]
    mk, bk, ak, rk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw)
    mp, bp, ap, rp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw)
    torch.cuda.synchronize()
    assert trace.counts["rt_fused_resample_biquad_agc_blocked_mix"] == before + 1
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
    counters = (lambda: launched("rt_fused_resample_biquad_agc_rel0_mix",
                                 "rt_fused_resample_biquad_agc_blocked_mix",
                                 "rt_limiter_master"))
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
    before = trace.counts["rt_biquad_df1_bf16"]
    yk, sk = cuda_scan.biquad_df1(x, coef, st)
    yp, sp = cuda_scan.biquad_df1_plain(x, coef, st)
    torch.cuda.synchronize()
    assert trace.counts["rt_biquad_df1_bf16"] == before + 1
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
    before = trace.counts["rt_phase_accumulate"]
    pk, ck = phase.phase_accumulate(p0, step, n)
    pp, cp = phase.phase_accumulate_plain(p0, step, n)
    torch.cuda.synchronize()
    assert trace.counts["rt_phase_accumulate"] == before + 1
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
    before = trace.counts["rt_threefry"]
    k = threefry.threefry(key, ctr, n, mode, **kw)
    p = threefry.threefry_plain(key, ctr, n, mode, **kw)
    torch.cuda.synchronize()
    assert trace.counts["rt_threefry"] == before + 1
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
    from rodio_tpu_torch.profile_slice import noise_source

    outs = []
    for d in (dev, "cpu"):
        node = noise_source(name, d)
        st = node.init_state()
        st["i"] = torch.full((), 2 ** 31 - 700, dtype=torch.int64, device=st["i"].device)
        before = trace.counts["rt_threefry"]
        _, out, _ = render_blocks(node, st, 3, 511)
        if d is dev:
            torch.cuda.synchronize()
            assert trace.counts["rt_threefry"] == before + 3
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
    from rodio_tpu_torch.profile_slice import config3, pull_to_end

    res = []
    for d in (dev, "cpu"):
        _, rx = config3(d, 0.1)
        before = trace.counts["rt_phase_accumulate"]
        blocks, pulls = pull_to_end(rx, 2048)
        if d is dev:
            assert trace.counts["rt_phase_accumulate"] - before == 60 * pulls
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
        before = trace.counts["rt_fused_resample_biquad_mix_ring"]
        mk, bk = fused.fused_resample_biquad_mix(ring, left, wts, bq=bk, ring=True, **kw)
        mp, bp = fused.fused_resample_biquad_mix_plain(ring, left, wts, bq=bp, ring=True, **kw)
        torch.cuda.synchronize()
        assert trace.counts["rt_fused_resample_biquad_mix_ring"] == before + 1
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
    from rodio_tpu_torch.parallel.farm import StreamFarm

    paths = _farm_corpus(tmp_path)
    outs, runs = {}, {}
    for d in (dev, "cpu"):
        farm = StreamFarm(paths, block_frames=1280, fused=fused_path, wire="i16", loop=True,
                          start_offsets=[0.0, 0.5, 1.2, 1.9], device=d)
        blocks = []
        kernels = ("rt_fused_resample_biquad_mix_ring", "rt_biquad_df1", "rt_limiter_master")
        launches = launched(*kernels)
        res = farm.run(40, on_block=lambda k, o, v: blocks.append(o),
                       sync_debug=d is dev)
        farm.close()
        runs[str(d)] = (res, tuple(a - b for a, b in zip(
            launched(*kernels), launches)))
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


# ---- M9 and M10: the f64 instances and the associative scans ----

@pytest.fixture
def f64_mode():
    """set_float64(True) for the graphs a test builds, restored after."""
    from rodio_tpu_torch.core import types

    was = types.float64_enabled()
    types.set_float64(True)
    try:
        yield
    finally:
        types.set_float64(was)


def _f64(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dev)


@pytest.mark.parametrize("L,T", [(5, 1), (5, 2), (64, 300), (2, 4096), (1024, 12800),
                                 (13, 128), (3, 4097), (8, 129), (6, 258)])
def test_k4_f64_matches_plain(dev, L, T):
    """K4's f64 instance (4 lanes a block): y and the carries bit-equal to
    the f64 sequential scan; its f32 launch count untouched."""
    rng = np.random.default_rng(L * 11 + T)
    x = _f64(rng.standard_normal((L, T)) * 0.3, dev)
    st = tuple(_f64(rng.standard_normal(L) * 0.1, dev) for _ in range(4))
    coef = _f64(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple(), dev)
    before = launched("rt_biquad_df1_f64", "rt_biquad_df1")
    yk, sk = cuda_scan.biquad_df1(x, coef, st)
    yp, sp = cuda_scan.biquad_df1_plain(x, coef, st)
    torch.cuda.synchronize()
    assert launched("rt_biquad_df1_f64", "rt_biquad_df1") == (before[0] + 1, before[1])
    assert yk.dtype == torch.float64 and torch.equal(yk, yp)
    for a, b in zip(sk, sp):
        assert a.dtype == torch.float64 and torch.equal(a, b)


@pytest.mark.parametrize("op", ["linear", "max_affine", "agc_gain"])
@pytest.mark.parametrize("L,T", [(1, 1), (1, 8192), (2, 127), (3, 300), (9, 512), (1, 65536)])
def test_k7_f64_first_order_matches_plain(dev, op, L, T):
    a, b, c, init = (_f64(v, dev) for v in _k7_inputs(op, L, T, L + T))
    params = _f64([AGC_PARAMS[0], AGC_PARAMS[1], AGC_PARAMS[3]], dev)
    before = launched("rt_first_order_f64", "rt_first_order")
    yk = cuda_scan.first_order(a, b, init, c, op=op, params=params)
    yp = cuda_scan.first_order_plain(a, b, init, c, op=op, params=params)
    torch.cuda.synchronize()
    assert launched("rt_first_order_f64", "rt_first_order") == (before[0] + 1, before[1])
    assert yk.dtype == torch.float64 and torch.equal(yk, yp)


@pytest.mark.parametrize("L,P,M", [(1, 128, 8192), (3, 8, 64), (8, 32, 3200), (2, 1, 64),
                                   (1, 128, 128), (1, 128, 12800), (2, 128, 25600)])
def test_k8_f64_matches_plain(dev, L, P, M):
    """Bit-equal, the f64 power table (an f64 cumprod) the same; at M =
    25600, P = 128 an f64 row's chunks take the global scratch where an f32
    row's still stage in shared memory."""
    rng = np.random.default_rng(L * P + M)
    x = np.abs(rng.standard_normal((L, M)) * 0.3)
    x.flat[rng.choice(L * M, 2, replace=False)] = [np.nan, np.inf]
    x = _f64(x, dev)
    for v0 in (_f64(rng.uniform(0, 1, L), dev), torch.zeros(L, dtype=torch.float64, device=dev)):
        for a in (0.99896, _f64(0.9, dev)[0], 1.0):
            before = trace.counts["rt_blocked_max_affine_f64"]
            yk = limiter_block.blocked_max_affine_const(x, v0, a, P=P)
            yp = limiter_block.blocked_max_affine_const_plain(x, v0, a, P=P)
            torch.cuda.synchronize()
            assert trace.counts["rt_blocked_max_affine_f64"] == before + 1
            assert yk.dtype == torch.float64
            assert torch.equal(yk.nan_to_num(7.0), yp.nan_to_num(7.0))
            assert torch.equal(yk.isnan(), yp.isnan())


def test_k8_f64_scratch_at_half_the_f32_row(dev):
    assert limiter_block._bma_scratch_floats(2, 12800, 128, torch.float64) == 0
    assert limiter_block._bma_scratch_floats(2, 25600, 128, torch.float32) == 0
    assert limiter_block._bma_scratch_floats(2, 25600, 128, torch.float64) > 0


def _k3_f64(dev, T, P, scale):
    rng = np.random.default_rng(T + P)
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32), device="cpu"),
                LimitSettings.mastering())
    kw = dict(att=lim.attack, rel=lim.release, threshold=lim.threshold,
              knee_width=lim.knee_width, inv_knee_8=lim.inv_knee_8, P=P)
    x = _f64(rng.standard_normal((2, T)) * scale, dev)
    i0, p0 = _f64([0.3, 1.2], dev), _f64([0.6, 0.1], dev)
    before = launched("rt_limiter_master_f64", "rt_limiter_master")
    yk, ck = limiter_block.limiter_master(x, i0, p0, **kw)
    yp, cp = limiter_block.limiter_master_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert launched("rt_limiter_master_f64", "rt_limiter_master") == (before[0] + 1, before[1])
    assert yk.dtype == torch.float64
    assert (yk - yp).abs().max().item() <= 1e-12
    for a, b in zip(ck, cp):
        assert (a - b).abs().max().item() <= 1e-12


@pytest.mark.parametrize("scale", [0.8, 4.0, 0.02])
@pytest.mark.parametrize("T,P", [(640, 128), (96, 32), (12800, 128), (4096, 128),
                                 (12800, 8), (64, 2)])
def test_k3_f64_matches_plain(dev, T, P, scale):
    _k3_f64(dev, T, P, scale)


@pytest.mark.parametrize("T", [102392, 102408])
def test_k3_f64_where_staging_gives_way(dev, T):
    """P = 8: a block of 8 x 12799 f64 frames stages its chunks in shared
    memory (204784 bytes), one of 8 x 12801 takes the global scratch; an
    f32 block stages both."""
    assert limiter_block._scratch_floats(T, 8, torch.float32) == 0
    staged = limiter_block._scratch_floats(T, 8, torch.float64) == 0
    assert staged == (T == 102392)
    _k3_f64(dev, T, 8, 0.8)


def test_op_chain_f64_matches_plain(dev):
    xab = torch.tensor([1.0, 0.999, 1e-3], dtype=torch.float64, device=dev)
    k = op_latency.op_chain(xab, 4)
    p = op_latency.op_chain_plain(xab.cpu(), 4)
    torch.cuda.synchronize()
    assert k.dtype == torch.float64 and torch.equal(k.cpu(), p)


def test_assoc_scans_on_card_equal_cpu(dev):
    """The torch-op associative scans round every op alone on both devices:
    bit-equal, at odd and even lengths and at the main path's block."""
    from rodio_tpu_torch.ops import scan

    rng = np.random.default_rng(5)
    for L, T in ((3, 1), (3, 7), (4, 1000), (2, 4096), (1024, 12800)):
        a, b, c = (rng.uniform(0.5, 1.0, (L, T)), rng.standard_normal((L, T)),
                   rng.uniform(0.9, 1.0, (L, T)))
        init = rng.standard_normal(L)
        co = torch.tensor(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple())
        st = tuple(rng.standard_normal(L) * 0.1 for _ in range(4))
        for cast in (_f32, _f64):
            outs = []
            for d in (dev, torch.device("cpu")):
                A, B, C, I = (cast(v, d) for v in (a, b, c, init))
                y1 = scan.linear_scan(A, B, I, mode="parallel")
                y2 = scan.max_affine_scan(B, B * 0.1, C, I, mode="parallel")
                y3, s3 = scan.biquad_df1(B, co.to(d, B.dtype), tuple(cast(v, d) for v in st),
                                         mode="parallel")
                outs.append([t.cpu() for t in (y1, y2, y3, *s3)])
            for g, cpu in zip(*outs):
                assert torch.equal(g, cpu)


@pytest.mark.parametrize("mode", ["auto", "parallel"])
def test_assoc_agc_flagship_on_card_matches_cpu(dev, mode):
    """make_flagship(16, with_agc=True) in the associative modes, 3 blocks
    of 640: the card (K4 and K3 under "auto", torch-op scans under
    "parallel", K7's smoother in both) against the CPU's plain versions."""
    node_g, st_g = make_flagship(16, seconds=0.2, scan_mode=mode, with_agc=True, device=dev)
    node_c, st_c = make_flagship(16, seconds=0.2, scan_mode=mode, with_agc=True, device="cpu")
    before = trace.counts["rt_first_order"]
    _, og, _ = render_blocks(node_g, st_g, 3, 640)
    _, oc, _ = render_blocks(node_c, st_c, 3, 640)
    torch.cuda.synchronize()
    assert trace.counts["rt_first_order"] == before + 3
    # the card's limiter is K3's blocked order under "auto", the CPU's the
    # sequential one (as test_flagship_on_card_matches_cpu)
    assert np.abs(og.cpu().numpy() - oc.numpy()).max() <= 1e-6 + 4e-6 * (mode == "auto")


@pytest.mark.parametrize("mode", ["pallas", "auto"])
def test_f64_flagship_on_card_matches_cpu(dev, f64_mode, mode):
    """BASELINE config 5's unfused chain in f64 at 16 streams: K4's and K3's
    f64 instances on the card against the f64 plain versions on the CPU
    (the mix over streams sums in another order: 1e-12)."""
    node_g, st_g = make_flagship(16, seconds=0.2, scan_mode=mode, device=dev)
    node_c, st_c = make_flagship(16, seconds=0.2, scan_mode=mode, device="cpu")
    before = launched("rt_biquad_df1_f64", "rt_limiter_master_f64")
    _, og, _ = render_blocks(node_g, st_g, 3, 640)
    _, oc, _ = render_blocks(node_c, st_c, 3, 640)
    torch.cuda.synchronize()
    assert og.dtype == torch.float64
    assert launched("rt_biquad_df1_f64", "rt_limiter_master_f64") == (before[0] + 3, before[1] + 3)
    bound = 1e-12 if mode == "pallas" else 4e-6  # "auto": the CPU's limiter is sequential
    assert np.abs(og.cpu().numpy() - oc.numpy()).max() <= bound


def test_kernels_without_f64_raise_by_name(dev, f64_mode):
    """F8: K1 and K2 refuse an f64 CUDA tensor by name (no cast, no
    fallback), and the fused pipelines refuse to build under set_float64;
    every other kernel has its f64 instance."""
    from rodio_tpu_torch.flagship import FusedWidePipeline

    x = torch.zeros((2, 256), dtype=torch.float64, device=dev)
    v = torch.zeros(2, dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="F8"):
        fused.fused_resample_biquad_mix(x, torch.zeros(8, dtype=torch.int64, device=dev),
                                        x, gains=v, coeffs=v, bq=v, channels=2)
    with pytest.raises(NotImplementedError, match="F8"):
        fused.fused_resample_biquad_agc_mix(x, torch.zeros(8, dtype=torch.int64, device=dev),
                                            x, gains=v, coeffs=v, bq=v, agc=v,
                                            agc_params=v, ring=x, ring_row=0)
    with pytest.raises(NotImplementedError, match="F8"):
        make_flagship(4, seconds=0.1, scan_mode="fused", device=dev)
    assert FusedWidePipeline  # the class the fused mode builds


# ---- the last f64 instances: K6, K5, threefry and the phase accumulator ----

@pytest.mark.parametrize("S,M", [(1, 1), (3, 129), (5, 383), (9, 1000), (64, 2561),
                                 (512, 25600)])
def test_k6_f64_matches_plain(dev, S, M):
    """K6's f64 instance (its ring in dynamic shared memory): gains and
    carries bit-equal to the f64 plain loop; its f32 launch count
    untouched."""
    xs, delta, p0, s0, g0 = (t.double() for t in _agc_inputs(S, M, dev, S + M))
    params = _f64(AGC_PARAMS, dev)
    before = launched("rt_agc_f64", "rt_agc")
    gk, ck = cuda_scan.agc(xs, delta, p0, s0, g0, params)
    gp, cp = cuda_scan.agc_plain(xs, delta, p0, s0, g0, params)
    torch.cuda.synchronize()
    assert launched("rt_agc_f64", "rt_agc") == (before[0] + 1, before[1])
    assert gk.dtype == torch.float64 and torch.equal(gk, gp)
    for a, b in zip(ck, cp):
        assert a.dtype == torch.float64 and torch.equal(a, b)


def test_k6_f64_zeros_and_nans_take_the_plain_branches(dev):
    S, M = 6, 700
    xs, delta, p0, s0, g0 = (t.double() for t in _agc_inputs(S, M, dev, 11))
    xs[:, :200] = 0.0
    delta[:, :200] = 0.0
    delta[2, 320:330] = -1.0
    xs[3, 400] = float("nan")
    delta[4, 500] = float("nan")
    p0[:] = 0.0
    s0[:] = 0.0
    gk, ck = cuda_scan.agc(xs, delta, p0, s0, g0, _f64(AGC_PARAMS, dev))
    gp, cp = cuda_scan.agc_plain(xs, delta, p0, s0, g0, _f64(AGC_PARAMS, dev))
    torch.cuda.synchronize()
    assert bool(ck[0][3].isnan()) and bool(ck[1][4].isnan())
    _equal_nan(gk, gp)
    for a, b in zip(ck, cp):
        _equal_nan(a, b)


@pytest.mark.parametrize("L,T", [(6, 700), (1024, 12800), (3, 1), (9, 129), (17, 4410)])
def test_k5_f64_limiter_env_matches_plain(dev, L, T):
    rng = np.random.default_rng(L + T)
    db = _f64(rng.uniform(0.0, 12.0, (L, T)) * (rng.uniform(size=(L, T)) < 0.3), dev)
    i0, p0 = _f64(rng.uniform(0, 6, L), dev), _f64(rng.uniform(0, 6, L), dev)
    kw = {k: _limit_kw(1)[k] for k in ("att", "rel")}
    before = launched("rt_limiter_env_f64", "rt_limiter_env")
    pk, ck = cuda_scan.limiter_env(db, i0, p0, **kw)
    pp, cp = cuda_scan.limiter_env_plain(db, i0, p0, **kw)
    torch.cuda.synchronize()
    assert launched("rt_limiter_env_f64", "rt_limiter_env") == (before[0] + 1, before[1])
    assert pk.dtype == torch.float64 and torch.equal(pk, pp)
    assert all(torch.equal(a, b) for a, b in zip(ck, cp))


def _k5_f64_stream_check(x, i0, p0, cg):
    kw = _limit_kw(cg)
    before = launched("rt_limiter_stream_f64", "rt_limiter_stream")
    yk, ck = cuda_scan.limiter_stream(x, i0, p0, **kw)
    yp, cp = cuda_scan.limiter_stream_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert launched("rt_limiter_stream_f64", "rt_limiter_stream") == (before[0] + 1, before[1])
    assert yk.dtype == torch.float64
    _equal_nan(yk, yp)
    for a, b in zip(ck, cp):
        _equal_nan(a, b)


@pytest.mark.parametrize("cg,streams,T", [
    (1, 3, 129), (2, 512, 12800), (2, 3, 4410), (6, 2, 127), (8, 3, 1), (12, 3, 700),
    (16, 2, 300)])
def test_k5_f64_limiter_stream_matches_plain(dev, cg, streams, T):
    """Groups of 1-16 channels (16 is the f64 instance's widest: its two
    rings of 16 f64 lanes take 166 KB), path C's [1024, 12800] among them."""
    x, i0, p0 = (t.double() for t in _limit_inputs(cg * streams, T, cg + streams + T, dev))
    _k5_f64_stream_check(x, i0, p0, cg)


def test_k5_f64_special_values(dev):
    x, i0, p0 = (t.double() for t in _limit_inputs(12, 700, 5, dev))
    x[:, :150] = 0.0
    x[1, 200] = float("nan")
    x[2, 300] = float("inf")
    x[5, 310] = -float("inf")
    i0[9] = float("nan")
    for cg in (1, 2, 6):
        _k5_f64_stream_check(x, i0, p0, cg)


def test_k5_f64_limiter_stream_wider_groups(dev):
    """Past 16 channels the f64 pass runs its envelopes on limiter_env's
    f64 instance and the rest in torch: bit-equal, one limiter_env launch."""
    from rodio_tpu_torch.ops import _build

    assert _build.load_library().rt_limiter_stream_f64_max_group() == 16
    x, i0, p0 = (t.double() for t in _limit_inputs(40, 300, 7, dev))
    kw = _limit_kw(20)
    before = launched("rt_limiter_stream_f64", "rt_limiter_env_f64")
    yk, ck = cuda_scan.limiter_stream(x, i0, p0, **kw)
    yp, cp = cuda_scan.limiter_stream_plain(x, i0, p0, **kw)
    torch.cuda.synchronize()
    assert launched("rt_limiter_stream_f64", "rt_limiter_env_f64") == (before[0], before[1] + 1)
    assert torch.equal(yk, yp) and all(torch.equal(a, b) for a, b in zip(ck, cp))


@pytest.mark.parametrize("mode,n,kw", [
    ("bits", 4097, {}), ("bits", 1 << 20, {}),
    ("uniform", 4096, dict(lo=-1.0, hi=1.0)), ("uniform", 777, {}),
    ("uniform", 3001, dict(lo=float(np.nextafter(-1.0, 0.0)), hi=1.0)),
    ("uniform", 999, dict(lo=0.1, hi=0.75)),   # an odd span: each op rounded alone
    ("velvet", 4096, dict(grid=24)), ("velvet", 513, dict(grid=7)),
    ("pink", 4096, {}), ("pink", 1, {})])
@pytest.mark.parametrize("i", [0, 2 ** 31 - 100, -2 ** 31])
def test_threefry_f64_matches_plain(dev, mode, n, kw, i):
    """The f64 instance (64-bit draws, an int64 seed) bit-equal to its plain
    version, its f32 launch count untouched."""
    from rodio_tpu_torch.ops import threefry

    key = threefry.seed_key(-77, dev, x64=True)
    ctr = torch.full((), i, dtype=torch.int64, device=dev)
    before = launched("rt_threefry_f64", "rt_threefry")
    k = threefry.threefry(key, ctr, n, mode, dtype=torch.float64, **kw)
    p = threefry.threefry_plain(key, ctr, n, mode, dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    assert launched("rt_threefry_f64", "rt_threefry") == (before[0] + 1, before[1])
    assert k.dtype == (torch.int64 if mode == "bits" else torch.float64)
    assert torch.equal(k, p)


#: the f64 erf_inv sources on the card against the CPU: PyTorch's f64 log1p
#: rounds apart on the two devices here and there (a draw within
#: ERFINV64_ULPS of 2^-50 at |z| < 8, times 0.6); Brownian's integrator
#: carries a draw's difference over ~1/(1 - leak) = 1500 steps
NOISE_BOUNDS_F64 = {"WhiteGaussian": 1e-13, "Brownian": 1e-11}


@pytest.mark.parametrize("name", ["WhiteUniform", "WhiteTriangular", "WhiteGaussian",
                                  "Velvet", "Pink", "Blue", "Violet", "Brownian", "Red"])
def test_noise_sources_f64_on_card_match_cpu(dev, f64_mode, name):
    from rodio_tpu_torch.profile_slice import noise_source

    outs = []
    for d in (dev, "cpu"):
        node = noise_source(name, d)
        st = node.init_state()
        st["i"] = torch.full((), 2 ** 31 - 700, dtype=torch.int64, device=st["i"].device)
        before = launched("rt_threefry_f64", "rt_first_order_f64")
        _, out, _ = render_blocks(node, st, 3, 511)
        if d is dev:
            torch.cuda.synchronize()
            k7 = 3 if name in ("Brownian", "Red") else 0
            assert launched("rt_threefry_f64", "rt_first_order_f64") == (
                before[0] + 3, before[1] + k7)
        outs.append(out.cpu())
    assert outs[0].dtype == torch.float64
    assert (outs[0] - outs[1]).abs().max().item() <= NOISE_BOUNDS_F64.get(name, 0.0)


@pytest.mark.parametrize("algo", ["tpdf", "rpdf", "gpdf", "highpass"])
def test_dither_f64_on_card_matches_cpu(dev, f64_mode, algo):
    from rodio_tpu_torch.effects import Dither

    data = np.random.default_rng(2).uniform(-0.9, 0.9, (2, 3000))
    outs = [render_blocks(n, n.init_state(), 4, 1000)[1].cpu() for n in (
        Dither(SamplesBuffer(2, 48000, data, device=d), 16, algo, seed=4) for d in (dev, "cpu"))]
    assert outs[0].dtype == torch.float64
    # gpdf: the noise's bound times the lsb, plus an ulp of an output below 1
    # where x - noise * lsb rounds the other way (the f32 test's 2^-24)
    bound = NOISE_BOUNDS_F64["WhiteGaussian"] * 2.0 ** -15 + 2.0 ** -53 if algo == "gpdf" else 0.0
    assert (outs[0] - outs[1]).abs().max().item() <= bound


@pytest.mark.parametrize("G,n", [(1, 4096), (1, 1), (3, 777), (130, 64), (1, 0)])
def test_phase_f64_matches_plain(dev, G, n):
    from rodio_tpu_torch.ops import phase

    rng = np.random.default_rng(G + n)
    p0 = _f64(rng.uniform(0, 1, G), dev)
    step = _f64(rng.uniform(1e-3, 0.2, G).astype(np.float32), dev)  # f32 steps widened
    before = launched("rt_phase_accumulate_f64", "rt_phase_accumulate")
    pk, ck = phase.phase_accumulate(p0, step, n)
    pp, cp = phase.phase_accumulate_plain(p0, step, n)
    torch.cuda.synchronize()
    assert launched("rt_phase_accumulate_f64", "rt_phase_accumulate") == (before[0] + 1, before[1])
    assert pk.dtype == torch.float64 and torch.equal(pk, pp) and torch.equal(ck, cp)


def test_f64_per_stream_chain_on_card_matches_cpu(dev, f64_mode):
    """Config 5's per-stream chain in f64 at 16 streams ("pallas"): K4, K6,
    K5 (limiter_stream) and K3's f64 instances once a block, against the f64
    plain versions on the CPU (the mix sums in another order: 1e-12)."""
    from rodio_tpu_torch import make_per_stream_chain

    node_g, st_g = make_per_stream_chain(16, seconds=0.2, seed=3, device=dev)
    node_c, st_c = make_per_stream_chain(16, seconds=0.2, seed=3, device="cpu")
    kernels = ("rt_biquad_df1_f64", "rt_agc_f64", "rt_limiter_stream_f64",
               "rt_limiter_master_f64")
    before = launched(*kernels)
    _, og, _ = render_blocks(node_g, st_g, 3, 640)
    _, oc, _ = render_blocks(node_c, st_c, 3, 640)
    torch.cuda.synchronize()
    after = launched(*kernels)
    assert og.dtype == torch.float64 and [a - b for a, b in zip(after, before)] == [3] * 4
    assert np.abs(og.cpu().numpy() - oc.numpy()).max() <= 1e-12


def _pack_check(src, rows):
    """The pack of ``src`` on the card, one launch, against its plain
    version on the same tensor: ``tm`` bit-equal (NaN included: the bits are
    compared), the fail words equal. Returns the flags."""
    f64 = src.dtype == torch.float64
    entry = "rt_pack_time_major" + ("_f64" if f64 else "")
    before = trace.counts[entry]
    tm, fails = pack.pack_time_major(src, rows)
    assert trace.counts[entry] == before + 1
    tp, fp = pack.pack_time_major_plain(src, rows)
    bits = torch.int64 if f64 else torch.int32
    assert tm.shape == tp.shape and tm.is_contiguous()
    assert torch.equal(tm.view(bits), tp.view(bits))
    if fails is None:
        assert fp is None
        return None
    assert torch.equal(fails, fp)
    return pack.content_flags(fails)


@pytest.mark.parametrize("name", PROBE_CASES)
def test_pack_flags_match_plain(dev, name):
    """The pack's kernel against its plain version on the card, on every
    content case of the CPU test, as a [C, frames] source and as its
    transposed view (frame stride C): one launch each, the same PCM and
    flags."""
    arr, want = probe_case(name)
    x = _f32(arr, dev)
    for src in (x, x.T.contiguous().T):
        assert _pack_check(src, arr.shape[1] + 7) == want


#: (rows, cols, offset): one lane, a few lanes and frames, a source off its
#: 16-byte boundary by ``offset`` floats, lanes past one tile of 32 and
#: not a multiple of 4 (scalar stores), and sources larger than one sweep
#: of the persistent grid
PROBE_SHAPES = [(1, 1, 0), (1, 1, 3), (1, 5, 0), (3, 7, 0), (3, 7, 1), (2, 6, 2), (3, 7, 3),
                (1, 4096, 0), (1024, 5000, 0), (1024, 5003, 1), (37, 1000, 2)]


@pytest.mark.parametrize("rows,cols,offset", PROBE_SHAPES)
@pytest.mark.parametrize("where", ["first", "last"])
def test_pack_ragged(dev, rows, cols, offset, where):
    """16-bit-grid content as a slice at ``offset`` of a wider source, with
    an element off each grid at the first frame of the first lane or the
    last of the last (the vectors read element by element at a row's ends
    where it is off its boundary): the kernel's PCM and flags equal the
    plain version's, and the flags the expected ones."""
    rng = np.random.default_rng(rows * cols * 4 + offset)
    wide = _f32(rng.integers(-32768, 32768, (rows, cols + offset + 5)) / 32768.0, dev)
    x = wide[:, offset:offset + cols]
    assert x.data_ptr() % 16 == 4 * offset % 16
    assert _pack_check(x, cols + 33) == (True, True, True)
    index = (0, 0) if where == "first" else (rows - 1, cols - 1)
    for value, want in PROBE_FAIL_ONE.values():
        x[index] = float(value)
        assert _pack_check(x, cols + 33) == want
        x[index] = 0.0


@pytest.fixture(scope="module")
def cell_corpus():
    """A corpus as the jobs cells hold it, [1024, 2,646,000] f32 on the
    16-bit grid (10.8 GB); freed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    x = torch.empty((1024, 2646000), dtype=torch.float32, device="cuda")
    x.random_(-32768, 32768, generator=torch.Generator("cuda").manual_seed(7))
    yield x.div_(32768.0)
    del x
    torch.cuda.empty_cache()


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_pack_at_the_cell_shape(dev, cell_corpus, offset):
    """A render job's slice, [1024, 470,547] of the cell's corpus at an
    offset of 0-3 floats past a 16-byte boundary, into [482,835, 1024]:
    the kernel bit-equal to its plain version, flags included."""
    x = cell_corpus[:, 1000 + offset:1000 + offset + 470547]
    assert _pack_check(x, 482835) == (True, True, True)


@pytest.mark.parametrize("offset", [0, 1])
def test_pack_stereo_interleaved_and_f64(dev, offset):
    """C = 2: a stereo slice and 1-D interleaved stereo (frame stride 2)
    through ``SamplesBuffer``, and the f64 instance, against the plain
    version."""
    rng = np.random.default_rng(offset)
    arr = (rng.integers(-32768, 32768, (2, 300001)) / 32768.0).astype(np.float32)
    x = _f32(arr, dev)[:, offset:]
    assert _pack_check(x, x.shape[1] + 8192) == (True, True, True)
    inter = _f32(np.ascontiguousarray(arr.T).reshape(-1), dev)[2 * offset:]
    assert _pack_check(inter.view(-1, 2).T, 300001 - offset + 100) == (True, True, True)
    buf = SamplesBuffer(2, 44100, inter, device=dev)
    assert torch.equal(buf.time_major()[:300001 - offset], x.T)
    assert buf.content_flags() == (True, True, True)
    assert _pack_check(_f64(arr, dev)[:, offset:], 300001 + 50) is None


def test_pack_once_a_job_and_only_on_floats(dev):
    """A job of the benchmark's config5_mix512 at 16 streams: one launch of
    the pack from ``SamplesBuffer(...)`` through ``init_state()``, one
    read-back of its flags, no channel-major copy; a tensor the kernel
    does not take raises, with no plain fallback."""
    config, _, cfg, pcm, gains, _ = _bench_job("config5_mix512", 16, dev, 3)
    before = launched("rt_pack_time_major", "channel_major_copy")
    chain = config.job_chain(pcm, gains, cfg, dev)
    chain.init_state()
    assert launched("rt_pack_time_major", "channel_major_copy") == (before[0] + 1, before[1])
    assert chain.input.precision == "i8"
    x = _f32(np.zeros((4, 64)), dev)
    for bad in (x.to(torch.bfloat16), x.to(torch.float16), x.to(torch.int32),
                x.reshape(-1), x[None]):
        with pytest.raises(ValueError, match="2-D float32 or float64"):
            pack.pack_time_major(bad, 64)
    assert launched("rt_pack_time_major")[0] == before[0] + 1
