"""The ``float64`` sample mode (``set_float64``, the reference's ``64bit``
feature) against the JAX package's, on the CPU.

The fixture ``f64`` turns on JAX's x64 and both packages' f64 flags, and
restores all three, because xdist runs other files in the same worker.
Every case gives numpy-seeded input to both packages and holds the port's
f64 render to JAX's f64 render. Bounds:

- math: ``exp2_precise``/``log2_precise``/``db_to_linear``/``linear_to_db``
  4e-16 relative (measured 0), the host coefficient equal.
- nodes and generators: 1e-12 absolute on renders of unit scale (measured
  at most 9.8e-15, the AGC's parallel mode; 5.6e-13 for the parallel
  biquad, whose JAX combine sums through XLA's dot; the f32 bounds of the
  same cases are 1e-6 to 2e-5).
- ``BltFilter`` in f64 against ``scipy.signal.lfilter`` run with the node's
  own coefficients: 1e-12 (measured 1.5e-14; test_independent_oracles.py's
  pattern).
- the AGC in "pallas" past 8 streams (K6's route) and ``Limit`` on a mono
  input and with ``streams`` = 4 (K5's): 1e-12, as the nodes above.
- config 2 and ``make_flagship(4)`` unfused: 1e-12 from JAX (measured
  3.1e-16 and 4.7e-17), float64 out, and at least 1e-9 away from the f32
  render somewhere (the f64 mode ran); a JAX f64 state carried across,
  1e-12 (measured 2.9e-16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodio_tpu import effects as J
from rodio_tpu.conversions import Resample as JResample
from rodio_tpu.conversions import Uniform as JUniform
from rodio_tpu.core import math as jmath
from rodio_tpu.core import types as jtypes
from rodio_tpu.flagship import make_flagship as j_make_flagship
from rodio_tpu.graph import render as j_render
from rodio_tpu.parallel.batch import WideMixer as JWideMixer
from rodio_tpu.sources import Chirp as JChirp
from rodio_tpu.sources import SamplesBuffer as JBuffer
from rodio_tpu.sources import SineWave as JSine
from rodio_tpu.sources import Zero as JZero
from rodio_tpu_torch import make_flagship, render, render_blocks, set_float64
from rodio_tpu_torch import effects as T
from rodio_tpu_torch.conversions import Resample, Uniform
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.core import math as tmath
from rodio_tpu_torch.core import types as ttypes
from rodio_tpu_torch.parallel.batch import WideMixer
from rodio_tpu_torch.profile_slice import config2_chain
from rodio_tpu_torch.sources import Chirp, SamplesBuffer, SineWave, Zero

signal = pytest.importorskip("scipy.signal")

NODE = 1e-12


@pytest.fixture
def f64():
    was = (jtypes.float64_enabled(), ttypes.float64_enabled())
    with jax.enable_x64(True):
        try:
            jtypes.set_float64(True)
            set_float64(True)
            yield
        finally:
            jtypes.set_float64(was[0])
            ttypes.set_float64(was[1])


def _pcm(channels, frames, seed, scale=0.5):
    return np.random.default_rng(seed).uniform(-1, 1, (channels, frames)) * scale


def _interleave(block):
    return np.asarray(block).T.reshape(-1)


def test_flag_and_dtypes(f64):
    assert ttypes.float64_enabled() and ttypes.float_dtype() == torch.float64
    assert ttypes.sample_dtype() == torch.float64
    assert SamplesBuffer(1, 48000, np.zeros((1, 4)), device="cpu").init_state() is not None
    set_float64(False)
    assert ttypes.float_dtype() == torch.float32


@pytest.mark.parametrize("fn", ["exp2_precise", "log2_precise", "db_to_linear",
                                "linear_to_db"])
def test_math_matches_jax_in_f64(f64, fn):
    rng = np.random.default_rng(1)
    x = (rng.uniform(-60, 20, 4096) if fn in ("exp2_precise", "db_to_linear")
         else np.abs(rng.standard_normal(4096)) * 3 + 1e-30)
    want = np.asarray(getattr(jmath, fn)(jnp.asarray(x)))
    got = getattr(tmath, fn)(torch.from_numpy(x)).numpy()
    assert want.dtype == got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=4e-16, atol=0)


def test_log2_keeps_the_f32_mantissa(f64):
    """JAX's f64 log2 reads x rounded to f32: two f64 values that round to
    the same f32 give the same log2 (ROADMAP queue 3: upstream's 64bit
    feature takes f64's own)."""
    x = torch.tensor([1.5, 1.5 + 2.0 ** -40], dtype=torch.float64)
    y = tmath.log2_precise(x)
    assert y.dtype == torch.float64 and y[0] == y[1]


@pytest.mark.parametrize("seconds,rate", [(0.005, 48000), (4.0, 44100), (0.1, 48000)])
def test_duration_to_coefficient_f64(f64, seconds, rate):
    from rodio_tpu.core.types import duration_to_nanos

    nanos = duration_to_nanos(seconds)
    want = jmath.duration_to_coefficient(0, rate, nanos=nanos)
    got = tmath.duration_to_coefficient(0, rate, nanos=nanos)
    assert isinstance(got, np.float64) and got == want
    assert float(got) != float(np.float32(got))


def _buffers(channels, frames, seed, rate=48000):
    data = _pcm(channels, frames, seed)
    return (SamplesBuffer(channels, rate, data, device="cpu"),
            JBuffer(channels, rate, data), data)


#: (name, block frames, build(port buffer, JAX buffer) -> (port node, JAX node))
NODES = [
    ("SamplesBuffer", 512, lambda t, j: (t, j)),
    ("Resample_weights", 1024, lambda t, j: (Resample(t, 48000), JResample(j, 48000))),
    ("Resample_ring", 777, lambda t, j: (Resample(T.Amplify(t, 0.5), 48000),
                                         JResample(J.Amplify(j, 0.5), 48000))),
    ("Uniform_compat", 1000, lambda t, j: (Uniform(t, 1, 48000, rodio_compat=True),
                                           JUniform(j, 1, 48000, rodio_compat=True))),
    ("BltFilter_exact", 512, lambda t, j: (T.BltFilter(t, "low_pass", 1200.0, 0.5, mode="exact"),
                                           J.BltFilter(j, "low_pass", 1200.0, 0.5, mode="exact"))),
    ("BltFilter_parallel", 512, lambda t, j: (
        T.BltFilter(t, "high_pass", 300.0, 0.7, mode="parallel"),
        J.BltFilter(j, "high_pass", 300.0, 0.7, mode="parallel"))),
    ("BltFilter_pallas", 512, lambda t, j: (
        T.BltFilter(t, "low_pass", 2000.0, 0.5, mode="pallas"),
        J.BltFilter(j, "low_pass", 2000.0, 0.5, mode="pallas"))),
    ("Amplify", 400, lambda t, j: (T.Amplify(t, 0.3), J.Amplify(j, 0.3))),
    ("Distortion", 400, lambda t, j: (T.Distortion(t, 3.0, 0.5), J.Distortion(j, 3.0, 0.5))),
    ("LinearGainRamp", 300, lambda t, j: (T.LinearGainRamp(t, 0.03, 0.2, 1.3, True),
                                          J.LinearGainRamp(j, 0.03, 0.2, 1.3, True))),
    ("TakeDuration_fade", 250, lambda t, j: (T.TakeDuration(t, 0.04, fadeout=True),
                                             J.TakeDuration(j, 0.04, fadeout=True))),
    ("Delay", 300, lambda t, j: (T.Delay(t, 0.004), J.Delay(j, 0.004))),
    ("ChannelVolume", 300, lambda t, j: (T.ChannelVolume(t, [0.2, 0.9, 0.5]),
                                         J.ChannelVolume(j, [0.2, 0.9, 0.5]))),
    ("Limit_exact", 512, lambda t, j: (T.Limit(T.Amplify(t, 3.0), T.LimitSettings(), mode="exact"),
                                       J.Limit(J.Amplify(j, 3.0), J.LimitSettings(), mode="exact"))),
    ("Limit_parallel", 512, lambda t, j: (
        T.Limit(T.Amplify(t, 3.0), T.LimitSettings(), mode="parallel"),
        J.Limit(J.Amplify(j, 3.0), J.LimitSettings(), mode="parallel"))),
    ("Limit_pallas", 512, lambda t, j: (
        T.Limit(T.Amplify(t, 3.0), T.LimitSettings(), mode="pallas"),
        J.Limit(J.Amplify(j, 3.0), J.LimitSettings(), mode="pallas"))),
    ("Agc_exact", 1024, lambda t, j: (T.AutomaticGainControl(t, mode="exact"),
                                      J.AutomaticGainControl(j, mode="exact"))),
    ("Agc_pallas", 1024, lambda t, j: (T.AutomaticGainControl(t, mode="pallas"),
                                       J.AutomaticGainControl(j, mode="pallas"))),
    ("Agc_parallel", 1024, lambda t, j: (T.AutomaticGainControl(t, mode="parallel"),
                                         J.AutomaticGainControl(j, mode="parallel"))),
    # past 8 streams "pallas" is K6's whole loop (its f64 instance on the card)
    ("Agc_pallas_streams10", 1024, lambda t, j: (
        T.AutomaticGainControl(t, mode="pallas", streams=10),
        J.AutomaticGainControl(j, mode="pallas", streams=10))),
    # off the blocked stereo case "pallas" is K5 (limiter_stream)
    ("Limit_pallas_mono", 512, lambda t, j: (
        T.Limit(T.Amplify(t, 3.0), T.LimitSettings(), mode="pallas"),
        J.Limit(J.Amplify(j, 3.0), J.LimitSettings(), mode="pallas"))),
    ("Limit_pallas_streams4", 512, lambda t, j: (
        T.Limit(T.Amplify(t, 3.0), T.LimitSettings(), mode="pallas", streams=4),
        J.Limit(J.Amplify(j, 3.0), J.LimitSettings(), mode="pallas", streams=4))),
]
#: the cases' channel counts where they are not stereo
CHANNELS = {"ChannelVolume": 3, "Agc_pallas_streams10": 20, "Limit_pallas_mono": 1,
            "Limit_pallas_streams4": 8}


@pytest.mark.parametrize("name,block,build", NODES, ids=[n[0] for n in NODES])
def test_node_renders_f64_like_jax(f64, name, block, build):
    channels = CHANNELS.get(name, 2)
    t, j, _ = _buffers(channels, 9000 if name.startswith("Agc") else 3000, len(name),
                       rate=44100 if "Resample" in name or "Uniform" in name else 48000)
    tn, jn = build(t, j)
    got = render(tn, block_frames=block)
    want = np.asarray(j_render(jn, block_frames=block))
    assert want.dtype == np.float64 and got.dtype == np.float64, (want.dtype, got.dtype)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=NODE, rtol=0)


GENERATORS = [
    ("SineWave", lambda: (SineWave(440.0, device="cpu"), JSine(440.0))),
    ("SineWave_compat", lambda: (SineWave(440.0, rodio_compat=True, device="cpu"),
                                 JSine(440.0, rodio_compat=True))),
    ("Chirp", lambda: (Chirp(48000, 100.0, 1000.0, 0.05, device="cpu"),
                       JChirp(48000, 100.0, 1000.0, 0.05))),
    ("Zero", lambda: (Zero(2, 48000, 1000, device="cpu"), JZero(2, 48000, 1000))),
]


@pytest.mark.parametrize("name,build", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generator_renders_f64_like_jax(f64, name, build):
    tn, jn = build()
    got = render(tn, max_frames=2400, block_frames=600)
    want = np.asarray(j_render(jn, max_frames=2400, block_frames=600))
    assert want.dtype == np.float64 and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=NODE, rtol=0)


def test_wide_mixer_f64(f64):
    t, j, _ = _buffers(8, 2000, 3)
    got = render(WideMixer(T.Amplify(t, [0.1, 0.2, 0.3, 0.4] * 2), 4), block_frames=500)
    want = np.asarray(j_render(JWideMixer(J.Amplify(j, [0.1, 0.2, 0.3, 0.4] * 2), 4),
                               block_frames=500))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=NODE, rtol=0)


@pytest.mark.parametrize("kind,fc", [("low_pass", 1200.0), ("high_pass", 300.0)])
def test_blt_filter_f64_vs_scipy_lfilter(f64, kind, fc):
    """BltFilter's f64 render against scipy's f64 lfilter run with the
    node's own coefficients: an independent recurrence, f64 end to end."""
    data = _pcm(2, 4096, 11)
    node = T.BltFilter(SamplesBuffer(2, 44100, data, device="cpu"), kind, fc, 0.5)
    b0, b1, b2, a1, a2 = node.coeffs
    want = signal.lfilter([b0, b1, b2], [1.0, a1, a2], data, axis=-1)
    got = render(node, block_frames=1000)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=NODE, rtol=0)


def _both_renders(build_t, build_j, n_blocks, T_):
    tn, ts = build_t()
    _, got, _ = render_blocks(tn, ts, n_blocks, T_)
    jn, js = build_j()
    emit = jax.jit(lambda s: jn.emit(s, T_))
    outs = []
    for _ in range(n_blocks):
        js, o, _ = emit(js)
        outs.append(np.asarray(o))
    return got.numpy(), np.concatenate(outs, axis=1)


def _config2_pcm():
    return _pcm(2, int(0.3 * 44100), 2, scale=0.3)


def test_config2_f64_matches_jax_and_differs_from_f32(f64):
    """BASELINE config 2 (low_pass -> AGC "pallas" -> Limit "pallas") in f64:
    K4's, K8's, K7's and K3's plain versions in f64 against the JAX
    package's interpret-mode kernels in f64, over 3 blocks of 4096."""
    pcm = _config2_pcm()

    def port():
        node = config2_chain(SamplesBuffer(2, 44100, pcm, device="cpu"))
        return node, node.init_state()

    def jax_():
        node = J.BltFilter(JBuffer(2, 44100, pcm), "low_pass", 2000.0, 0.5)
        node = J.AutomaticGainControl(node, J.AgcSettings(), mode="pallas")
        node = J.Limit(node, J.LimitSettings(), mode="pallas")
        return node, node.init_state()

    got, want = _both_renders(port, jax_, 3, 4096)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=NODE, rtol=0)
    set_float64(False)
    tn, ts = port()
    _, o32, _ = render_blocks(tn, ts, 3, 4096)
    assert o32.dtype == torch.float32
    assert np.abs(got - o32.numpy()).max() > 1e-9


def _fixed_type_chain():
    """Nodes that round host constants or widen blocks in ``emit``: a ramp,
    a fading take, amplify, distortion, and config 2's chain behind them."""
    node = SamplesBuffer(2, 44100, _config2_pcm(), device="cpu")
    node = T.TakeDuration(T.LinearGainRamp(node, 0.1, 0.3, 1.7, True), 0.25, fadeout=True)
    node = T.Distortion(T.Amplify(node, 1.3), 1.1, 0.9)
    return config2_chain(node)


@pytest.mark.parametrize("built,rendered", [(True, False), (False, True)],
                         ids=["f64_rendered_under_f32", "f32_rendered_under_f64"])
def test_sample_type_is_fixed_when_built(f64, built, rendered):
    """A graph keeps the sample type it was built with: its render under
    the other flag equals, bit for bit, its render under its own."""
    set_float64(built)
    node = _fixed_type_chain()
    _, want, _ = render_blocks(node, node.init_state(), 3, 4096)
    node = _fixed_type_chain()
    set_float64(rendered)
    _, got, _ = render_blocks(node, node.init_state(), 3, 4096)
    assert got.dtype == want.dtype == (torch.float64 if built else torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["exact", "pallas"])
def test_flagship_unfused_f64_matches_jax(f64, mode):
    got, want = _both_renders(
        lambda: make_flagship(4, seconds=0.1, scan_mode=mode, device="cpu"),
        lambda: j_make_flagship(4, seconds=0.1, scan_mode=mode), 3, 640)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=NODE, rtol=0)
    set_float64(False)
    tn, ts = make_flagship(4, seconds=0.1, scan_mode=mode, device="cpu")
    _, o32, _ = render_blocks(tn, ts, 3, 640)
    assert np.abs(got - o32.numpy()).max() > 1e-9


def test_fused_family_refused_in_f64_by_both_packages(f64):
    """F8: the JAX package's fused pipeline cannot run in f64 (a TypeError
    from lax.rem on int32 against int64); the port refuses it when the
    graph is built."""
    jn, js = j_make_flagship(4, seconds=0.1, scan_mode="fused")
    with pytest.raises(TypeError):
        jn.emit(js, 640)
    with pytest.raises(NotImplementedError, match="F8"):
        make_flagship(4, seconds=0.1, scan_mode="fused", device="cpu")
    with pytest.raises(NotImplementedError, match="F8"):
        make_flagship(4, seconds=0.1, scan_mode="fused", with_agc=True, device="cpu")


def test_state_from_jax_f64(f64):
    """A JAX f64 state carried into the port stays f64 and continues the
    render as the JAX package does."""
    jn, js = j_make_flagship(4, seconds=0.1, scan_mode="exact", with_agc=True)
    emit = jax.jit(lambda s: jn.emit(s, 640))
    js, _, _ = emit(js)
    tn, _ = make_flagship(4, seconds=0.1, scan_mode="exact", with_agc=True, device="cpu")
    ts = state_from_jax(tn, js)

    def floats(st):
        for v in st.values():
            if isinstance(v, dict):
                yield from floats(v)
            elif torch.is_tensor(v) and v.is_floating_point():
                yield v

    assert {t.dtype for t in floats(ts)} == {torch.float64}
    _, got, _ = render_blocks(tn, ts, 2, 640)
    outs = []
    for _ in range(2):
        js, o, _ = emit(js)
        outs.append(np.asarray(o))
    np.testing.assert_allclose(got.numpy(), np.concatenate(outs, axis=1), atol=NODE, rtol=0)
