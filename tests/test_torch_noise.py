"""The port's threefry bits and noise sources against JAX's ``jax.random``.

The contract is the JAX version installed here, 0.9.0, with
``jax_threefry_partitionable`` True: the tests skip with a message on any
other. Bounds:

- the threefry bits, ``fold_in``, ``split``, ``uniform`` and ``randint``,
  and every noise source built on uniform draws (WhiteUniform,
  WhiteTriangular, Velvet, Pink, Blue, Violet): bit-equal, across the
  int32 wrap of the sample counter;
- WhiteGaussian: XLA's f32 ``erf_inv`` polynomial, ported op for op; XLA's
  ``log1p`` and its FMA contraction of the polynomial's Horner steps round
  differently here and there, so a draw is within ERFINV_ULPS = 4 ulp of
  JAX's (measured 3 on 200000 draws, 2 on these blocks);
- Brownian and Red: the leaky integrator's ``leak*acc + white``, which
  XLA:CPU contracts into an FMA (ROADMAP F4); the port rounds the mul and
  the add alone, as its kernel K7 does, so they are held to
  INTEGRATED_ABS = 5e-6 against JAX (measured 1.55e-6 on unit-variance
  output), and Red bit-equal to a numpy recurrence over JAX's own draws.

The 12 statistical cases of ``tests/test_noise_dither.py`` are ported at
the end, on the port's sources.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rodio_tpu.sources.noise as jnoise
from rodio_tpu.effects.dither import Dither as JDither
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
from rodio_tpu.sources.generators import Zero as JZero
from rodio_tpu_torch import render
from rodio_tpu_torch.effects import Dither
from rodio_tpu_torch.ops import threefry as tf
from rodio_tpu_torch.sources import (
    Blue, Brownian, Pink, Red, SamplesBuffer, Velvet, Violet, WhiteGaussian,
    WhiteTriangular, WhiteUniform, Zero)

ERFINV_ULPS = 4
INTEGRATED_ABS = 5e-6
SOURCES = ["WhiteUniform", "WhiteTriangular", "WhiteGaussian", "Velvet", "Pink",
           "Blue", "Violet", "Brownian", "Red"]
PORT = dict(WhiteUniform=WhiteUniform, WhiteTriangular=WhiteTriangular,
            WhiteGaussian=WhiteGaussian, Velvet=Velvet, Pink=Pink, Blue=Blue,
            Violet=Violet, Brownian=Brownian, Red=Red)
N = 1 << 16


@pytest.fixture(autouse=True)
def _jax_contract():
    if jax.__version__ != "0.9.0" or not jax.config.jax_threefry_partitionable:
        pytest.skip(f"the bitwise contract is JAX 0.9.0's partitionable threefry; "
                    f"installed: {jax.__version__}, partitionable="
                    f"{jax.config.jax_threefry_partitionable}")


def _jkey(seed):
    return jax.random.key(seed)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -5])
def test_seed_and_fold_in(seed):
    pk = tf.seed_key(seed)
    np.testing.assert_array_equal(
        pk.numpy(), np.asarray(jax.random.key_data(_jkey(seed))).astype(np.int64))
    for d in (0, 1, 7, 2 ** 31 - 1, -1, -2 ** 31):
        want = jax.random.key_data(jax.random.fold_in(_jkey(seed), jnp.int32(d)))
        np.testing.assert_array_equal(tf.fold_in_plain(pk, d).numpy(),
                                      np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed,shape", [(3, ()), (3, (1,)), (11, (7,)), (11, (3, 5)),
                                        (0, (2, 1, 999)), (2 ** 30, (4097,))])
def test_random_bits_uniform_split(seed, shape):
    key, pk = _jkey(seed), tf.seed_key(seed)
    n = int(np.prod(shape))
    want = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(tf.random_bits_plain(pk, n).numpy(), want.ravel())
    # the ranges the noise sources and Dither draw from, where the
    # conversion's mul and add are exact (so an FMA changes nothing)
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (tf.NORMAL_LO, 1.0)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
        got = tf.bits_to_uniform(tf.random_bits_plain(pk, n), lo, hi).numpy()
        np.testing.assert_array_equal(got, want.ravel())
    k1, k2 = tf.split2_plain(pk)
    jk = np.asarray(jax.random.key_data(jax.random.split(key, 2))).astype(np.int64)
    np.testing.assert_array_equal(np.stack([k1.numpy(), k2.numpy()]), jk)


@pytest.mark.parametrize("lo,hi", [(0, 48), (0, 2), (-7, 1000), (5, 5), (0, 2 ** 20 + 3)])
def test_randint(lo, hi):
    for seed in (0, 9):
        want = np.asarray(jax.random.randint(_jkey(seed), (5,), lo, hi))
        np.testing.assert_array_equal(tf.randint_plain(tf.seed_key(seed), 5, lo, hi).numpy(),
                                      want)


@pytest.mark.parametrize("i", [0, 123, 2 ** 31 - 300, -2 ** 31])
def test_block_draws_and_int32_wrap(i):
    """A block's draws under fold_in(key, i): the kernel's ``bits`` and
    ``uniform`` modes' plain version, at counters across the int32 wrap."""
    key, pk = _jkey(5), tf.seed_key(5)
    jk = jax.random.fold_in(key, jnp.int32(i))
    got = tf.threefry_plain(pk, i, 1001, "bits").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.bits(jk, (1001,), dtype=jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(
        tf.threefry_plain(pk, i, 1001, "uniform", -1.0, 1.0).numpy(),
        np.asarray(jax.random.uniform(jk, (1001,), minval=-1.0, maxval=1.0)))
    assert tf.wrap_i32(2 ** 31 - 1 + 2) == -2 ** 31 + 1


def test_erf_inv_normal_within_ulps():
    """``normal``: XLA's erf_inv polynomial in PyTorch ops, within
    ERFINV_ULPS of ``jax.random.normal``; ``torch.erfinv`` is far off."""
    key, pk = _jkey(42), tf.seed_key(42)
    want = np.asarray(jax.random.normal(jax.random.fold_in(key, 3), (50000,)))
    got = tf.normal(pk, 3, 50000).numpy()
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= ERFINV_ULPS, ulps.max()
    u = tf.uniform(pk, 3, 50000, tf.NORMAL_LO, 1.0)
    far = (torch.erfinv(u) * tf.SQRT2).numpy()
    assert (np.abs(far - want) / np.spacing(np.abs(want))).max() > 10 * ERFINV_ULPS


def _run_both(name, seed, sizes, i0):
    jn = getattr(jnoise, name)(48000, seed=seed)
    pn = PORT[name](48000, seed=seed, device="cpu")
    js, ps = jn.init_state(), pn.init_state()
    js["i"], ps["i"] = jnp.int32(i0), torch.tensor(i0)
    jouts, pouts = [], []
    for n in sizes:
        js, jb, jv = jn.emit(js, n)
        ps, pb, pv = pn.emit(ps, n)
        assert int(jv) == int(pv) == n
        jouts.append(np.asarray(jb))
        pouts.append(pb.numpy())
    assert int(js["i"]) == int(ps["i"])
    return np.concatenate(pouts, axis=1), np.concatenate(jouts, axis=1)


@pytest.mark.parametrize("name", SOURCES)
@pytest.mark.parametrize("i0", [0, 2 ** 31 - 600])
def test_noise_source_matches_jax(name, i0):
    """3 blocks of odd sizes, from a fresh counter and across its wrap."""
    got, want = _run_both(name, 7, (257, 1001, 513), i0)
    if name in ("Brownian", "Red"):
        np.testing.assert_allclose(got, want, rtol=0, atol=INTEGRATED_ABS)
    elif name == "WhiteGaussian":
        ulps = np.abs(got - want) / np.spacing(np.abs(want))
        assert ulps.max() <= ERFINV_ULPS, ulps.max()
    else:
        np.testing.assert_array_equal(got, want)


def test_red_integrates_jax_draws_exactly():
    """Red's white draws are JAX's bit for bit; its output is the leaky
    recurrence over them with the mul and the add each rounded (the JAX
    package's differs only where XLA:CPU fuses them into an FMA)."""
    n = 3000
    pn = Red(48000, seed=4, device="cpu")
    _, out, _ = pn.emit(pn.init_state(), n)
    white = np.asarray(jax.random.uniform(jax.random.fold_in(_jkey(4), 0), (n,),
                                          minval=-1.0, maxval=1.0))
    leak, scale = np.float32(pn.leak), np.float32(pn.scale)
    acc, want = np.float32(0.0), np.empty(n, np.float32)
    for t in range(n):
        acc = np.float32(np.float32(leak * acc) + white[t])
        want[t] = acc * scale
    np.testing.assert_array_equal(out[0].numpy(), want)


def test_state_from_jax_continues_noise():
    """A JAX noise state taken mid-stream (its key as key data) continues
    in the port identically."""
    from rodio_tpu_torch.convert import state_from_jax

    for name in ("Pink", "Violet", "Velvet"):
        jn = getattr(jnoise, name)(44100, seed=2)
        pn = PORT[name](44100, seed=2, device="cpu")
        js = jn.init_state()
        for _ in range(2):
            js, _, _ = jn.emit(js, 300)
        jstate = jax.tree_util.tree_map(
            lambda x: jax.random.key_data(x)
            if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else x, js)
        ps = state_from_jax(pn, jax.device_get(jstate))
        _, jb, _ = jn.emit(js, 411)
        _, pb, _ = pn.emit(ps, 411)
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


def test_dither_state_from_jax():
    from rodio_tpu_torch.convert import state_from_jax

    data = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 900)).astype(np.float32)
    jd = JDither(JBuffer(2, 48000, data), 12, "highpass", seed=3)
    pd = Dither(SamplesBuffer(2, 48000, data, device="cpu"), 12, "highpass", seed=3)
    js = jd.init_state()
    js, _, _ = jd.emit(js, 256)
    jstate = jax.tree_util.tree_map(
        lambda x: jax.random.key_data(x)
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else x, js)
    ps = state_from_jax(pd, jax.device_get(jstate))
    _, jb, _ = jd.emit(js, 256)
    _, pb, _ = pd.emit(ps, 256)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


# -- the cases of tests/test_noise_dither.py, on the port ------------------

def spectrum_slope(x, rate=48000):
    """dB-per-octave slope of the power spectrum between 100 Hz and 10 kHz."""
    f = np.fft.rfftfreq(len(x), 1 / rate)
    p = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    sel = (f > 100) & (f < 10000) & (p > 0)
    return np.polyfit(np.log2(f[sel]), 10 * np.log10(p[sel]), 1)[0]


def _render(node, n=N):
    return np.asarray(render(node, max_frames=n, block_frames=8192))[0]


def test_white_uniform_stats():
    x = _render(WhiteUniform(48000, device="cpu"))
    assert abs(x.mean()) < 0.02
    assert abs(x.std() - np.sqrt(1 / 3)) < 0.02
    assert x.min() >= -1.0 and x.max() <= 1.0
    assert abs(spectrum_slope(x)) < 1.0  # flat


def test_white_triangular_stats():
    x = _render(WhiteTriangular(48000, device="cpu"))
    assert abs(x.mean()) < 0.02
    assert abs(x.std() - 1 / np.sqrt(6)) < 0.02
    assert x.min() >= -1.0 and x.max() <= 1.0


def test_white_gaussian_stats():
    x = _render(WhiteGaussian(48000, device="cpu"))
    assert abs(x.mean()) < 0.02
    assert abs(x.std() - 0.6) < 0.02


def test_velvet_density_and_values():
    rate, density = 48000, 2000
    x = _render(Velvet(rate, density, device="cpu"))
    nonzero = x[x != 0]
    grid = int(np.ceil(rate / density))
    expected_impulses = len(x) // grid
    assert abs(len(nonzero) - expected_impulses) <= expected_impulses * 0.02
    assert set(np.unique(nonzero)).issubset({-1.0, 1.0})
    assert abs(nonzero.mean()) < 0.1


def test_pink_slope():
    s = spectrum_slope(_render(Pink(48000, device="cpu")))
    assert -4.5 < s < -1.5  # pink ~ -3 dB/octave


def test_pink_continuity_across_blocks():
    a = _render(Pink(48000, seed=7, device="cpu"), n=8192)
    b = np.asarray(render(Pink(48000, seed=7, device="cpu"), max_frames=8192,
                          block_frames=1024))[0]
    np.testing.assert_array_equal(a[:8192], b)


def test_blue_slope():
    s = spectrum_slope(_render(Blue(48000, device="cpu")))
    assert 4.0 < s < 8.0  # a first difference: +6 dB/octave


def test_violet_slope():
    s = spectrum_slope(_render(Violet(48000, device="cpu")))
    assert 9.0 < s < 15.0  # twice differenced: ~ +12 dB/octave


@pytest.mark.parametrize("cls", [Brownian, Red])
def test_integrated_noise(cls):
    x = _render(cls(48000, device="cpu"))
    s = spectrum_slope(x)
    assert -8.0 < s < -4.0  # ~ -6 dB/octave
    assert 0.5 < x.std() < 2.0  # variance-normalised to ~1


def test_dither_subtracts_scaled_noise(rng):
    data = rng.uniform(-0.5, 0.5, size=2000).astype(np.float32)
    out = render(Dither(SamplesBuffer(2, 48000, data, device="cpu"), 16, "tpdf"),
                 block_frames=256)
    diff = out - data.reshape(1000, 2).T
    lsb = 1.0 / (1 << 15)
    assert np.abs(diff).max() <= lsb  # TPDF amplitude within 1 lsb
    assert np.abs(diff).max() > 0
    assert abs(diff.mean()) < lsb * 0.1


@pytest.mark.parametrize("algo", ["tpdf", "rpdf", "gpdf", "highpass"])
def test_dither_algorithms_run(rng, algo):
    data = rng.uniform(-0.5, 0.5, size=512).astype(np.float32)
    out = render(Dither(SamplesBuffer(2, 48000, data, device="cpu"), 8, algo),
                 block_frames=128)
    assert out.shape == (2, 256)
    assert not np.array_equal(out, data.reshape(256, 2).T)


def test_highpass_dither_continuous_at_block_boundaries():
    """Adjacent samples share a white draw across block boundaries too."""
    bf, n = 128, 128 * 512
    out = _render(Dither(Zero(1, 48000, num_frames=n, device="cpu"), 2, "highpass"), n=n)
    noise = -out / 0.5
    var = noise.var()
    boundary_corr = np.mean(noise[bf - 1::bf][:-1] * noise[bf::bf]) / var
    interior_corr = np.mean(noise[:-1] * noise[1:]) / var
    assert interior_corr < -0.35
    assert boundary_corr < -0.25, boundary_corr


def test_jax_zero_highpass_equal():
    """The highpass case above against the JAX package's own render."""
    from rodio_tpu.graph import render as j_render

    n = 128 * 8
    want = np.asarray(j_render(JDither(JZero(1, 48000, num_frames=n), 2, "highpass"),
                               max_frames=n, block_frames=128))
    got = render(Dither(Zero(1, 48000, num_frames=n, device="cpu"), 2, "highpass"),
                 max_frames=n, block_frames=128)
    np.testing.assert_array_equal(got, want)
