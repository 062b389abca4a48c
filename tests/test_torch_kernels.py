"""The plain versions of the port's kernels against the JAX functions they
replace, run as the JAX package's own tests run them on the CPU (Pallas in
interpret mode). Inputs are numpy arrays from fixed seeds fed to both.

Bounds and why:
- K4 (biquad): 1e-6. The port rounds each mul and add alone; XLA:CPU may
  contract a mul-add into an FMA, ~1 ulp per step, decaying through the
  filter's memory.
- K3 (blocked limiter): 1e-6 against the same blocked order, 4e-6 against
  the sequential JAX Limit (reassociated envelopes; ROADMAP's bound). The
  envelope carries are in dB (~10), so they are held to 1e-6 relative.
- K1 (fused pipeline): 1e-6 against the JAX FusedWidePipeline (another lerp
  and mix summation order, gains folded into the PCM vs applied after the
  lerp, the JAX kernel's look-ahead biquad).
- K6 (the AGC loop): 2e-5, the AGC kernel bound (``lax.rsqrt`` against the
  port's 1/sqrt, FMA contraction through the smoother's near-unity attack
  coefficient).
- K7 (first-order recurrence): 1e-6 plus 2e-6 relative (16 ulp): XLA:CPU
  contracts ``a*y + b`` and the smoother's mul-adds into FMAs (ROADMAP F4),
  ~1 ulp per step, which a coefficient near 1 carries over ~1/(1-a) steps.
- K8 (blocked max-affine): the same, for the same reason; besides, the JAX
  power table is an f32 cumprod and the port's a^(t+1) is made in float64,
  a few ulp apart.
- K2 (fused AGC pipeline): 2e-5 on the mix, the AGC kernel bound: the JAX
  kernel on XLA:CPU contracts the smoother's mul-adds into FMAs (F4), and
  through the default attack coefficient (1 - 5e-6) the gain drifts ~1e-5
  from the port's in a few blocks; the port's K2 equals its unfused exact
  chain, whose AGC equals the scalar oracle bit for bit
  (tests/test_torch_flagship.py, tests/test_torch_agc.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodio_tpu.effects.limit import Limit as JLimit
from rodio_tpu.effects.limit import LimitSettings as JLimitSettings
from rodio_tpu.flagship import FusedWidePipeline as JFused
from rodio_tpu.ops.limiter_block import blocked_max_affine_const as j_bma
from rodio_tpu.ops.limiter_block import limiter_master_pallas
from rodio_tpu.ops.pallas_scan import agc_pallas, biquad_df1_pallas, first_order_pallas
from rodio_tpu.ops.scan import biquad_df1 as j_biquad
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
from rodio_tpu_torch import resolve_device
from rodio_tpu_torch.conversions.resample import lerp_weights, output_positions
from rodio_tpu_torch.effects.blt import blt_coefficients
from rodio_tpu_torch.effects.limit import Limit, LimitSettings
from rodio_tpu_torch.flagship import FusedWidePipeline
from rodio_tpu_torch.ops import cuda_scan, fused, limiter_block
from rodio_tpu_torch.sources.generators import SamplesBuffer


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@pytest.mark.parametrize("L,T", [(16, 640), (7, 1), (7, 2), (1024, 96),
                                 (2, 4096), (13, 300)])  # path B's block; a ragged L
def test_k4_plain_matches_pallas_interpret(L, T):
    rng = np.random.default_rng(L + T)
    x = (rng.standard_normal((L, T)) * 0.3).astype(np.float32)
    st = [(rng.standard_normal(L) * 0.1).astype(np.float32) for _ in range(4)]
    co = blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple()
    yj, sj = biquad_df1_pallas(jnp.asarray(x), co, tuple(map(jnp.asarray, st)),
                               interpret=True)
    ye, se = j_biquad(jnp.asarray(x), co, tuple(map(jnp.asarray, st)))
    yt, stt = cuda_scan.biquad_df1(_t(x), _t(co), tuple(map(_t, st)))
    # at T < 2 the Pallas wrapper returns the kernel's carries, which have
    # run on through the zero padding of its time tile (ROADMAP F5); the
    # port keeps the sequential scan's carries there
    refs = ((yj, sj), (ye, se)) if T >= 2 else ((yj, se), (ye, se))
    for ref, ref_st in refs:
        np.testing.assert_allclose(yt.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
        for a, b in zip(stt, ref_st):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def _limiter_kw(settings, rate=48000):
    lim = Limit(SamplesBuffer(2, rate, np.zeros((2, 1), np.float32), device="cpu"), settings)
    return dict(att=lim.attack, rel=lim.release, threshold=lim.threshold,
                knee_width=lim.knee_width, inv_knee_8=lim.inv_knee_8)


@pytest.mark.parametrize("T,P", [(640, 128), (96, 32), (1280, 128), (64, 8)])
@pytest.mark.parametrize("preset", ["default", "mastering", "live_performance"])
def test_k3_plain_matches_pallas_interpret(T, P, preset):
    rng = np.random.default_rng(T * P)
    x = (rng.standard_normal((2, T)) * 0.8).astype(np.float32)
    i0 = np.array([0.4, 1.5], np.float32)
    p0 = np.array([0.9, 0.2], np.float32)
    kw = _limiter_kw(getattr(LimitSettings, preset)())
    yj, (ij, pj) = limiter_master_pallas(
        jnp.asarray(x), jnp.asarray(i0), jnp.asarray(p0), P=P, interpret=True, **kw)
    yt, (it, pt) = limiter_block.limiter_master(_t(x), _t(i0), _t(p0), P=P, **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6, rtol=0)
    # the carries are envelopes in dB (~10 here): a few f32 ulp
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)


def test_k3_plain_matches_sequential_jax_limit_over_blocks():
    """The blocked plain version, block after block with its carries, against
    the JAX package's sequential Limit (mode="exact") on the same input."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 5 * 640)) * 0.9).astype(np.float32)
    jnode = JLimit(JBuffer(2, 48000, x), JLimitSettings(), mode="exact")
    js = jnode.init_state()
    jemit = jax.jit(lambda s: jnode.emit(s, 640))
    kw = _limiter_kw(LimitSettings())
    integ = peak = torch.zeros(2)
    for b in range(5):
        js, yj, _ = jemit(js)
        yt, (integ, peak) = limiter_block.limiter_master(
            _t(x[:, b * 640:(b + 1) * 640]), integ, peak, P=128, **kw)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=4e-6, rtol=0)
    # envelope carries in dB (~10): the blocked-vs-sequential class, relative
    np.testing.assert_allclose(integ.numpy(), np.asarray(js["integ"]), rtol=4e-6)
    np.testing.assert_allclose(peak.numpy(), np.asarray(js["peak"]), rtol=4e-6)


def _fused_pair(S, frames, seed, gains=None, **kw):
    rng = np.random.default_rng(seed)
    wide = (rng.standard_normal((S * 2, frames)) * 0.1).astype(np.float32)
    if gains is None:
        gains = (rng.uniform(0.5, 1.5, S) / S).astype(np.float32)
    jn = JFused(JBuffer(S * 2, 44100, wide), 48000, gains, S, "low_pass", 2000.0,
                0.5, **kw)
    tn = FusedWidePipeline(SamplesBuffer(S * 2, 44100, wide, device="cpu"), 48000, gains, S,
                           "low_pass", 2000.0, 0.5, **kw)
    return jn, tn


@pytest.mark.parametrize("S,frames,blocks", [(8, 44100, 5), (4, 13230, 25)])
def test_k1_plain_matches_jax_fused_interpret(S, frames, blocks):
    """5 blocks of 640 mid-stream, and (S=4, 0.3 s) blocks past the drain."""
    jn, tn = _fused_pair(S, frames, seed=S)
    js, ts = jn.init_state(), tn.init_state()
    jemit = jax.jit(lambda s: jn.emit(s, 640))
    for b in range(blocks):
        js, oj, vj = jemit(js)
        ts, ot, vt = tn.emit(ts, 640)
        assert int(vt) == int(vj), b
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6, rtol=0,
                                   err_msg=f"block {b}")
    for a, b in zip(ts["bq"], js["bq"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[: S * 2], atol=1e-6)


@pytest.mark.parametrize("C", [1, 2, 3, 12])
@pytest.mark.parametrize("cuts", [(1, 1, 1), (2, 1, 70), (64, 64, 5), (65, 1, 130)])
def test_k1_plain_carries_cross_calls(C, cuts):
    """K1's plain version over calls of 1, 2 and more frames in a row, each
    from the last one's carries, equals one call over the whole run bit for
    bit, mix and carries; F is short enough that the last calls read past
    the PCM."""
    rng = np.random.default_rng(C * 1000 + sum(cuts))
    L, o0, fr, to = 3 * C, 11, 147, 160
    pcm = _t(rng.standard_normal((sum(cuts) * fr // to + 8, L)) * 0.1)
    kw = dict(gains=_t(rng.uniform(0.1, 1.0, L)),
              coeffs=_t(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple()),
              channels=C)
    bq0 = _t(rng.standard_normal((4, L)) * 0.01)

    def call(o, n, bq):
        left, phase = output_positions(o, n, fr, to, "cpu")
        wts = _t(np.stack(lerp_weights(fr, to), axis=1))[phase]
        return fused.fused_resample_biquad_mix(pcm, left, wts, bq=bq, **kw)

    whole, whole_bq = call(o0, sum(cuts), bq0)
    bq, mixes, t0 = bq0, [], 0
    for n in cuts:
        mix, bq = call(o0 + t0, n, bq)
        mixes.append(mix)
        t0 += n
    assert torch.equal(torch.cat(mixes, dim=1), whole)
    assert torch.equal(bq, whole_bq)


def test_k2_plain_matches_jax_fused_agc_interpret():
    """S = 4, 4 blocks of 640 against the JAX fused AGC kernel (interpret):
    the mix, and the per-stream carries."""
    S = 4
    jn, tn = _fused_pair(S, 44100, seed=7, with_agc=True)
    js, ts = jn.init_state(), tn.init_state()
    jemit = jax.jit(lambda s: jn.emit(s, 640))
    for b in range(4):
        js, oj, vj = jemit(js)
        ts, ot, vt = tn.emit(ts, 640)
        assert int(vt) == int(vj) == 640
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5, rtol=0,
                                   err_msg=f"block {b}")
    jagc = np.asarray(js["agc"]).reshape(3, 512)[:, :S]
    # the gain carry drifts with F4 (1e-4, the JAX package's CPU bound)
    np.testing.assert_allclose(ts["agc"].numpy(), jagc, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("o0,n", [(0, 640), (37, 640), (803, 333),
                                  (10**6 + 11, 1), (160 * 80, 12800)])
def test_k1_taps_match_output_positions(o0, n):
    """K1's cached rows and weights of a block equal output_positions at
    that block's o0 and the lerp weights of its phases, exactly."""
    _, tn = _fused_pair(2, 4410, seed=3)
    for _ in range(2):  # built, then taken from the cache
        left, wts = tn._taps(o0, n)
        want_left, phase = output_positions(o0, n, tn.from_, tn.to, "cpu")
        assert torch.equal(left, want_left)
        w0, w1 = lerp_weights(tn.from_, tn.to)
        np.testing.assert_array_equal(wts.numpy(), np.stack([w0, w1], 1)[phase.numpy()])


def test_k1_plain_block_size_invariance():
    """Blocks of 320 and of 640 (and an odd 733, which K1 allows) give the
    same samples: the kernel state carries across blocks exactly."""
    _, tn = _fused_pair(4, 22050, seed=9)

    def run(T, nb):
        s = tn.init_state()
        outs = []
        for _ in range(nb):
            s, o, _ = tn.emit(s, T)
            outs.append(o)
        return torch.cat(outs, dim=1).numpy()

    a, b, c = run(320, 6), run(640, 3), run(733, 3)
    np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)
    np.testing.assert_allclose(c[:, :1920], b, atol=1e-7, rtol=0)


def _counts():
    return (cuda_scan.launches, cuda_scan.agc_launches,
            cuda_scan.first_order_launches, limiter_block.launches,
            limiter_block.bma_launches, fused.launches, fused.agc_launches)


def test_cpu_tensors_never_launch_a_kernel():
    rng = np.random.default_rng(3)
    before = _counts()
    co = _t(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple())
    z = torch.zeros(8)
    x = _t(rng.standard_normal((8, 64)))
    cuda_scan.biquad_df1(x, co, (z, z, z, z))
    cuda_scan.agc(x.abs(), x, z, z, z + 1, AGC_PARAMS)
    cuda_scan.first_order(x, x, z, op="agc_gain", params=AGC_PARAMS[[0, 1, 3]])
    limiter_block.limiter_master(_t(rng.standard_normal((2, 64))), torch.zeros(2),
                                 torch.zeros(2), P=8, **_limiter_kw(LimitSettings()))
    limiter_block.blocked_max_affine_const(x, z, 0.9, P=8)
    _, tn = _fused_pair(4, 4410, seed=1)
    tn.emit(tn.init_state(), 640)
    _, tn = _fused_pair(4, 4410, seed=1, with_agc=True)
    tn.emit(tn.init_state(), 640)
    assert _counts() == before


#: (att, rel, target, max_gain, floor, 1/8192): a fast attack and release
#: at 48 kHz, so the smoother moves both ways
AGC_PARAMS = torch.tensor([0.99583, 0.99896, 0.8, 5.0, 0.0, 1.0 / 8192],
                          dtype=torch.float32)


@pytest.mark.parametrize("S,M", [(3, 1000), (3, 9000), (512, 300)])
def test_k6_plain_matches_pallas_interpret(S, M):
    rng = np.random.default_rng(S + M)
    env = 0.05 + 0.5 * (0.5 + 0.5 * np.sin(np.arange(M) / 200.0))
    xs = np.abs(rng.standard_normal((S, M)) * env).astype(np.float32)
    sq = xs * xs
    old = (sq * rng.uniform(0.0, 1.0, (S, M))).astype(np.float32)
    delta = sq - old
    peak0 = rng.uniform(0.0, 0.5, S).astype(np.float32)
    sum0 = rng.uniform(10.0, 200.0, S).astype(np.float32)
    gain0 = rng.uniform(0.5, 3.0, S).astype(np.float32)
    p = AGC_PARAMS.numpy()
    gj, cj = agc_pallas(*map(jnp.asarray, (xs, delta, peak0, sum0, gain0)),
                        params=tuple(jnp.float32(v) for v in p), interpret=True)
    gt, ct = cuda_scan.agc(*map(_t, (xs, delta, peak0, sum0, gain0)), AGC_PARAMS)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-5, rtol=0)
    for a, b in zip(ct, cj):  # peak, window sum (~100: relative), gain
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("op", ["linear", "max_affine", "agc_gain"])
@pytest.mark.parametrize("L,T", [(1, 1000), (5, 700)])
def test_k7_plain_matches_pallas_interpret(op, L, T):
    """T not a multiple of the TPU kernel's 256-step tile: its padding."""
    rng = np.random.default_rng(T + L)
    if op == "linear":
        a = rng.uniform(0.5, 0.95, (L, T))
        b = rng.standard_normal((L, T)) * 0.05
    elif op == "max_affine":
        a = rng.standard_normal((L, T)) * 0.3
        b = rng.standard_normal((L, T)) * 0.05
    else:
        a = rng.uniform(0.05, 1.0, (L, T))
        b = a
    c = rng.uniform(0.5, 1.0, (L, T))
    init = rng.uniform(0.5, 2.0, L)
    a, b, c, init = (v.astype(np.float32) for v in (a, b, c, init))
    # a 2 ms attack and a 5 ms release at 48 kHz
    params = np.float32([0.9896, 0.99584, 5.0]) if op == "agc_gain" else ()
    yj = first_order_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(init),
                            c=jnp.asarray(c) if op == "max_affine" else None,
                            op=op, params=tuple(jnp.float32(v) for v in params),
                            interpret=True)
    yt = cuda_scan.first_order(_t(a), _t(b), _t(init),
                               _t(c) if op == "max_affine" else None, op=op,
                               params=tuple(float(v) for v in params))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6, rtol=2e-6)


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("P", [8, 32, 128])
def test_k8_plain_matches_pallas_interpret(L, P):
    rng = np.random.default_rng(L * P)
    M = P * 24
    x = np.abs(rng.standard_normal((L, M)) * 0.3).astype(np.float32)
    v0 = rng.uniform(0.0, 1.0, L).astype(np.float32)
    for a in (0.0, 0.99896, 0.9):
        yj = j_bma(jnp.asarray(x), jnp.asarray(v0), jnp.float32(a), P=P,
                   interpret=True)
        yt = limiter_block.blocked_max_affine_const(_t(x), _t(v0), a, P=P)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6,
                                   rtol=2e-6, err_msg=f"a={a}")


def test_k8_plain_is_the_peak_detector():
    """The blocked order against the sequential max-affine scan it
    reassociates, y = max(x, a*y' + (1-a)*x): ulp-class."""
    rng = np.random.default_rng(8)
    x = _t(np.abs(rng.standard_normal((2, 4096)) * 0.3))
    v0 = _t([0.2, 0.9])
    a = np.float32(0.99896)
    y = limiter_block.blocked_max_affine_const(x, v0, float(a), P=128)
    ca = float(np.float32(1.0) - a)
    ref = cuda_scan.first_order(x, x * ca, v0, torch.full_like(x, float(a)),
                                op="max_affine")
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-6, rtol=0)


def test_resolve_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        SamplesBuffer(2, 44100, np.zeros((2, 10), np.float32), device="cuda")
    # the card is the default device: without one, None raises too
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros((2, 64), device="meta")
    z = x[:, 0]
    with pytest.raises(ValueError):
        cuda_scan.agc(x, x, z, z, z, AGC_PARAMS)
    with pytest.raises(ValueError):
        cuda_scan.first_order(x, x, z, op="linear")
    with pytest.raises(ValueError):
        cuda_scan.first_order(torch.zeros((2, 8)), torch.zeros((2, 8)),
                              torch.zeros(2), op="bogus")
    with pytest.raises(ValueError):
        limiter_block.blocked_max_affine_const(x, z, 0.5, P=8)
    with pytest.raises(ValueError):  # more than 8 rows
        limiter_block.blocked_max_affine_const(torch.zeros((9, 64)),
                                               torch.zeros(9), 0.5, P=8)
    with pytest.raises(ValueError):
        cuda_scan.biquad_df1(x, torch.zeros(5, device="meta"),
                             tuple(torch.zeros(2, device="meta") for _ in range(4)))
    with pytest.raises(ValueError):
        limiter_block.limiter_master(x, x[:, 0], x[:, 0], P=8,
                                     **_limiter_kw(LimitSettings()))
    with pytest.raises(ValueError):
        limiter_block.limiter_master_plain(torch.zeros((2, 60)), torch.zeros(2),
                                           torch.zeros(2), P=8,
                                           **_limiter_kw(LimitSettings()))
