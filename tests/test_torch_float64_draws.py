"""The f64 instances of the last kernels against the JAX package with x64
on, on the CPU: threefry's 64-bit draws and XLA's f64 ``erf_inv``, the noise
family and ``Dither``, K6 and K5 (their plain versions against the Pallas
kernels in interpret mode), the phase accumulator, BASELINE config 5's
per-stream chain, and JAX f64 states carried into the port.

The contract is JAX 0.9.0 with ``jax_threefry_partitionable`` True, as in
``tests/test_torch_noise.py``: the draws' tests skip on any other. Bounds:

- 64-bit bits, ``uniform`` on spans 1 and 2 (and ``normal``'s, which rounds
  to 2), ``randint`` under x64 and every source built on them (WhiteUniform,
  WhiteTriangular, Velvet, Pink, Blue, Violet) and ``Dither``'s tpdf, rpdf
  and highpass: bit-equal;
- ``erf_inv``, ``normal`` and WhiteGaussian: ``ERFINV64_ULPS`` (48) ulp of
  the result: XLA:CPU's f64 ``log1p`` lies up to 128 ulp from PyTorch's,
  which the polynomial carries to 31 ulp of a draw (measured); with XLA's
  ``log1p`` substituted the rest is within 2 ulp (its FMA contraction of
  the Horner steps, ROADMAP F4). Dither's gpdf: that bound times its lsb;
- an odd span (0.65): the port's ``uniform`` equals the plain formula with
  every op rounded alone; JAX's contracts ``f * span + lo`` into an FMA and
  lands within 1 ulp of it (F4);
- Brownian and Red, the per-stream chain, K6 and K5: 1e-12 absolute on
  renders of unit scale (XLA:CPU's FMAs; measured at most 5.3e-15 for the
  integrators).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rodio_tpu.sources.noise as jnoise
from rodio_tpu.effects.dither import Dither as JDither
from rodio_tpu.graph import render as j_render
from rodio_tpu.ops.pallas_scan import agc_pallas, limiter_env_pallas
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
from rodio_tpu.sources.generators import SineWave as JSine
import rodio_tpu_torch as rtt
from rodio_tpu_torch import render, render_blocks
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.effects import Dither
from rodio_tpu_torch.ops import cuda_scan, phase
from rodio_tpu_torch.ops import threefry as tf
from rodio_tpu_torch import sources as tsources
from rodio_tpu_torch.sources import SamplesBuffer, SineWave
from test_torch_float64 import f64  # noqa: F401  (the x64 and set_float64 fixture)
from test_torch_limit import _jax_path_c

NODE = 1e-12
SOURCES = ["WhiteUniform", "WhiteTriangular", "WhiteGaussian", "Velvet", "Pink",
           "Blue", "Violet", "Brownian", "Red"]
F64 = torch.float64


@pytest.fixture
def contract(f64):
    if jax.__version__ != "0.9.0" or not jax.config.jax_threefry_partitionable:
        pytest.skip(f"the bitwise contract is JAX 0.9.0's partitionable threefry; "
                    f"installed: {jax.__version__}, partitionable="
                    f"{jax.config.jax_threefry_partitionable}")


def _ulps(a, b):
    """Distance in ulp of same-signed f64 arrays (the bit patterns apart)."""
    return np.abs(np.asarray(a).view(np.int64) - np.asarray(b).view(np.int64))


@pytest.mark.parametrize("seed", [0, 42, -5, 2 ** 31 - 1, 2 ** 40 + 3])
def test_seed_key_x64(contract, seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed))).astype(np.int64)
    np.testing.assert_array_equal(tf.seed_key(seed, x64=True).numpy(), want)


@pytest.mark.parametrize("i", [0, 123, 2 ** 31 - 300, -2 ** 31])
@pytest.mark.parametrize("seed", [5, -9])
def test_bits64_and_uniform_bit_equal(contract, seed, i):
    """The 64-bit words and the f64 uniform draws of a block under
    fold_in(key, i), on the spans the sources and Dither use."""
    jk = jax.random.fold_in(jax.random.key(seed), jnp.int32(i))
    pk = tf.seed_key(seed, x64=True)
    want = np.asarray(jax.random.bits(jk, (1001,), dtype=jnp.uint64)).view(np.int64)
    np.testing.assert_array_equal(tf.threefry_plain(pk, i, 1001, "bits", dtype=F64).numpy(),
                                  want)
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (tf.NORMAL_LO64, 1.0)):
        want = np.asarray(jax.random.uniform(jk, (1001,), dtype=jnp.float64,
                                             minval=lo, maxval=hi))
        got = tf.threefry_plain(pk, i, 1001, "uniform", lo, hi, dtype=F64).numpy()
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 48), (0, 2), (-7, 1000), (5, 5), (0, 2 ** 20 + 3)])
def test_randint_x64(contract, lo, hi):
    """Under x64 randint's default type is int64: 64-bit draws, reduced in
    uint64 (Velvet's cells draw so)."""
    for seed in (0, 9):
        want = np.asarray(jax.random.randint(jax.random.key(seed), (5,), lo, hi))
        assert want.dtype == np.int64
        got = tf.randint_plain(tf.seed_key(seed, x64=True), 5, lo, hi, x64=True)
        np.testing.assert_array_equal(got.numpy(), want)


def test_erf_inv_f64_within_ulps(f64):
    """XLA's f64 erf_inv on a dense grid, points near 0 and near +-1, and
    +-1 themselves (+-inf)."""
    near1 = 1.0 - np.logspace(-16, -1, 40000)
    x = np.concatenate([np.linspace(-1, 1, 100001), near1, -near1,
                        np.logspace(-300, -1, 2000), -np.logspace(-300, -1, 2000),
                        [0.0, -0.0, np.nextafter(1.0, 0.0), np.nextafter(-1.0, 0.0)]])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = tf.erf_inv(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float64
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    assert inf.sum() == 2 and set(x[inf]) == {-1.0, 1.0}
    assert _ulps(got[~inf], want[~inf]).max() <= tf.ERFINV64_ULPS


def test_normal_f64_within_ulps(contract):
    want = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(42), 3),
                                        (200000,), dtype=jnp.float64))
    got = tf.normal(tf.seed_key(42, x64=True), 3, 200000, dtype=F64).numpy()
    d = _ulps(got, want)
    assert d.max() <= tf.ERFINV64_ULPS and (d == 0).mean() > 0.8


def test_odd_span_uniform_is_the_plain_formula(contract):
    """F4: on a span whose product is not exact, JAX's f64 uniform takes an
    FMA; the port rounds the mul and the add alone, as the plain formula."""
    lo, hi = 0.1, 0.75
    pk = tf.seed_key(3, x64=True)
    b1, b2 = tf.random_words_plain(pk, 65536)
    got = tf.words_to_uniform64(b1, b2, lo, hi).numpy()
    w = (b1.numpy().astype(np.uint64) << np.uint64(32)) | b2.numpy().astype(np.uint64)
    f = ((w >> np.uint64(12)) | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
    plain = np.maximum(lo, f * (hi - lo) + lo)
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jax.random.uniform(jax.random.key(3), (65536,), dtype=jnp.float64,
                                         minval=lo, maxval=hi))
    assert _ulps(got, want).max() <= 1 and (got != want).any()


def _source_pair(name, seed):
    return (getattr(tsources, name)(48000, seed=seed, device="cpu"),
            getattr(jnoise, name)(48000, seed=seed))


@pytest.mark.parametrize("seed", [3, -7])
@pytest.mark.parametrize("name", SOURCES)
def test_noise_source_f64_matches_jax(contract, name, seed):
    tn, jn = _source_pair(name, seed)
    got = render(tn, max_frames=5000, block_frames=1000)
    want = np.asarray(j_render(jn, max_frames=5000, block_frames=1000))
    assert got.dtype == want.dtype == np.float64
    if name == "WhiteGaussian":
        assert _ulps(got, want).max() <= tf.ERFINV64_ULPS
    elif name in ("Brownian", "Red"):
        np.testing.assert_allclose(got, want, atol=NODE, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algo", ["tpdf", "rpdf", "gpdf", "highpass"])
def test_dither_f64_matches_jax(contract, algo):
    data = np.random.default_rng(1).uniform(-1, 1, (2, 5000)) * 0.5
    tn = Dither(SamplesBuffer(2, 48000, data, device="cpu"), 16, algo, seed=3)
    got = render(tn, block_frames=1000)
    want = np.asarray(j_render(JDither(JBuffer(2, 48000, data), 16, algo, seed=3),
                               block_frames=1000))
    assert got.dtype == want.dtype == np.float64
    if algo == "gpdf":  # 48 ulp of a draw of at most ~6 (2^-50 an ulp) times the lsb
        np.testing.assert_allclose(got, want, atol=tf.ERFINV64_ULPS * 2.0 ** -50 * 2.0 ** -15,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
    prev = tn.init_state().get("prev")  # highpass's carried white sample
    assert prev is None or prev.dtype == F64


@pytest.mark.parametrize("S,M", [(3, 1000), (9, 4100), (512, 300)])
def test_k6_plain_f64_matches_pallas_interpret(f64, S, M):
    rng = np.random.default_rng(S + M)
    env = 0.05 + 0.5 * (0.5 + 0.5 * np.sin(np.arange(M) / 200.0))
    xs = np.abs(rng.standard_normal((S, M)) * env)
    sq = xs * xs
    delta = sq - sq * rng.uniform(0.0, 1.0, (S, M))
    peak0, sum0, gain0 = (rng.uniform(0.0, 0.5, S), rng.uniform(10.0, 200.0, S),
                          rng.uniform(0.5, 3.0, S))
    p = np.array([0.99583, 0.99896, 0.8, 5.0, 0.0, 1.0 / 8192])
    gj, cj = agc_pallas(*map(jnp.asarray, (xs, delta, peak0, sum0, gain0)),
                        params=tuple(jnp.float64(v) for v in p), interpret=True)
    gt, ct = cuda_scan.agc(*map(torch.from_numpy, (xs, delta, peak0, sum0, gain0)),
                           torch.from_numpy(p))
    assert gt.dtype == F64 and np.asarray(gj).dtype == np.float64
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=NODE, rtol=0)
    for a, b in zip(ct, cj):  # peak, window sum (~100: relative), gain
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=NODE, atol=NODE)


@pytest.mark.parametrize("L,T", [(4, 700), (1, 4410), (8, 1)])
def test_k5_plain_f64_matches_pallas_interpret(f64, L, T):
    """limiter_env's plain version, and limiter_stream's envelopes, against
    limiter_env_pallas in f64 on the same dB input."""
    from rodio_tpu_torch.ops.limiter_block import limiter_gain_db

    rng = np.random.default_rng(L * T)
    x = rng.uniform(-1, 1, (L, T)) * rng.choice([0.05, 0.6, 2.5], (L, 1))
    i0, p0 = rng.uniform(0, 6, L), rng.uniform(0, 6, L)
    att, rel = 0.9896, 0.99958
    kw = dict(threshold=-1.0, knee_width=4.0, inv_knee_8=1.0 / 32.0)
    db = limiter_gain_db(torch.from_numpy(x), **kw)
    pj, (ij, qj) = limiter_env_pallas(jnp.asarray(db.numpy()), jnp.asarray(i0),
                                      jnp.asarray(p0), att=att, rel=rel, interpret=True)
    pt, (it, qt) = cuda_scan.limiter_env(db, torch.from_numpy(i0), torch.from_numpy(p0),
                                         att=att, rel=rel)
    assert pt.dtype == F64
    for a, b in ((pt, pj), (it, ij), (qt, qj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=NODE, rtol=0)
    _, (is_, qs) = cuda_scan.limiter_stream(torch.from_numpy(x), torch.from_numpy(i0),
                                            torch.from_numpy(p0), att=att, rel=rel,
                                            group_channels=1, **kw)
    np.testing.assert_allclose(is_.numpy(), np.asarray(ij), atol=NODE, rtol=0)
    np.testing.assert_allclose(qs.numpy(), np.asarray(qj), atol=NODE, rtol=0)


def test_phase_accumulator_f64_matches_lax_scan(f64):
    """JAX's rodio_compat step: the f32 step widened, f64 adds and floors."""
    step32 = np.float32(1.0) / (np.float32(48000) / np.float32(440.0))
    step = jnp.float64(step32)

    def body(p, _):
        pn = p + step
        return pn - jnp.floor(pn), p

    p0 = 0.123456789
    pj_end, pj = jax.lax.scan(body, jnp.float64(p0), None, length=5000)
    pt, pt_end = phase.phase_accumulate(torch.tensor([p0], dtype=F64),
                                        torch.tensor([float(step32)], dtype=F64), 5000)
    assert pt.dtype == F64
    np.testing.assert_array_equal(pt[0].numpy(), np.asarray(pj))
    assert float(pt_end[0]) == float(pj_end)
    # it drifts from the f32 recurrence: the f64 mode ran
    p32, _ = phase.phase_accumulate(torch.tensor([p0], dtype=torch.float32),
                                    torch.tensor([step32]), 5000)
    assert np.abs(pt[0].numpy() - p32[0].numpy()).max() > 1e-9


def test_sine_compat_f64_state_from_jax(f64):
    jn = JSine(440.0, rodio_compat=True)
    js, _, _ = jax.jit(lambda s: jn.emit(s, 777))(jn.init_state())
    tn = SineWave(440.0, rodio_compat=True, device="cpu")
    ts = state_from_jax(tn, jax.device_get(js))
    assert ts["phase"].dtype == F64
    _, got, _ = tn.emit(ts, 1000)
    _, want, _ = jn.emit(js, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NODE, rtol=0)


def _jax_states(jn, n, blocks):
    emit = jax.jit(lambda s: jn.emit(s, n))
    js, outs = jn.init_state(), []
    for _ in range(blocks):
        js, o, _ = emit(js)
        outs.append(np.asarray(o))
    return js, emit, outs


def _key_data(state):
    """A JAX state with its keys as key data (state_from_jax's input)."""
    return {k: (_key_data(v) if isinstance(v, dict) else
                jax.random.key_data(v) if k == "key" else v) for k, v in state.items()}


@pytest.mark.parametrize("name", ["WhiteUniform", "Velvet", "Pink", "Violet", "Red",
                                  "dither_highpass", "dither_tpdf"])
def test_noise_state_from_jax_f64(contract, name):
    """A JAX f64 noise or Dither state mid-render (its key words, its
    counter, its f64 carries) continues in the port as in JAX."""
    if name.startswith("dither"):
        algo = name.split("_")[1]
        data = np.random.default_rng(2).uniform(-1, 1, (2, 4000)) * 0.5
        jn = JDither(JBuffer(2, 48000, data), 16, algo, seed=-4)
        tn = Dither(SamplesBuffer(2, 48000, data, device="cpu"), 16, algo, seed=-4)
    else:
        tn, jn = _source_pair(name, 11)
    js, emit, _ = _jax_states(jn, 700, 2)
    ts = state_from_jax(tn, jax.device_get(_key_data(js)))
    for k in ("prev", "prev_white", "prev_blue", "acc"):
        if k in ts:
            assert ts[k].dtype == F64
    _, got, _ = render_blocks(tn, ts, 2, 700)
    outs = []
    for _ in range(2):
        js, o, _ = emit(js)
        outs.append(np.asarray(o))
    want = np.concatenate(outs, axis=1)
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, atol=NODE, rtol=0)


def test_per_stream_chain_f64_matches_jax(f64):
    """BASELINE config 5's per-stream chain at S = 12 streams ("pallas"):
    past 8 streams the AGC takes K6's route and each Limit(streams) K5's,
    in f64 on both sides; then a JAX state taken mid-render (K6's and K5's
    f64 carries) continues in the port."""
    S, n, blocks = 12, 640, 3
    jn = _jax_path_c(S, 0.2, 5, "pallas")
    tn, ts = rtt.make_per_stream_chain(S, seconds=0.2, seed=5, mode="pallas", device="cpu")
    js, emit, outs = _jax_states(jn, n, blocks)
    ts, got, _ = render_blocks(tn, ts, blocks, n)
    want = np.concatenate(outs, axis=1)
    assert got.dtype == F64 and want.dtype == np.float64
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got.numpy(), want, atol=NODE, rtol=0)
    # the carries mid-render: the AGC's (K6) and the per-stream Limit's (K5)
    limit = ts["in"]  # the mix's state is its input's
    agc = limit["in"]["in"]
    assert agc["peak"].dtype == limit["integ"].dtype == F64 and agc["peak"].shape == (S,)
    ts2 = state_from_jax(tn, jax.device_get(js))
    for a, b in ((ts2["in"]["integ"], limit["integ"]),
                 (ts2["in"]["in"]["in"]["gain"], agc["gain"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=NODE, rtol=1e-12)
    _, got2, _ = render_blocks(tn, ts2, 2, n)
    outs = []
    for _ in range(2):
        js, o, _ = emit(js)
        outs.append(np.asarray(o))
    np.testing.assert_allclose(got2.numpy(), np.concatenate(outs, axis=1), atol=NODE, rtol=0)
