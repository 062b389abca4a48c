"""The port's AutomaticGainControl against the JAX package's and the oracle,
on the CPU (the plain versions of K6, K7 and K8).

Both packages get the same numpy PCM from fixed seeds: noise under an
envelope that swings over 20 dB, so the gain both attacks and releases.
Bounds and why:

- ``mode="exact"`` against the scalar oracle ``rodio_tpu.refimpl``: 1e-6,
  aiming at 0 (every op rounds alone, in the oracle's order).
- against the JAX node: 1e-4 for ``"exact"`` (XLA:CPU contracts mul-adds
  into FMAs, ROADMAP F4; the JAX package's own CPU bound on this chain),
  2e-5 for ``"pallas"`` (the AGC kernel bound: JAX sums the window in f32
  and takes ``lax.rsqrt``, the port sums in f64 and takes 1/sqrt), 1e-2 for
  ``group`` (``tools/parity_tpu.py:256``, the relaxed contract).
- the config-2 chain (low_pass -> AGC -> Limit, kernel modes): 2e-5.
"""
import jax
import numpy as np
import pytest
import torch

from rodio_tpu import refimpl as ri
from rodio_tpu.effects.agc import AgcSettings as JAgcSettings
from rodio_tpu.effects.agc import AutomaticGainControl as JAgc
from rodio_tpu.effects.limit import Limit as JLimit
from rodio_tpu.effects.limit import LimitSettings as JLimitSettings
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
from rodio_tpu_torch import render
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.effects import (
    AgcSettings, AutomaticGainControl, Limit, LimitSettings)
from rodio_tpu_torch.effects.agc import ipow
from rodio_tpu_torch.sources.generators import SamplesBuffer

FAST = dict(target_level=0.8, attack_time=0.005, release_time=0.02,
            absolute_max_gain=5.0)


def _pcm(channels, frames, seed):
    """Noise under a slow envelope from 0.02 to 0.6."""
    rng = np.random.default_rng(seed)
    env = 0.02 + 0.58 * (0.5 + 0.5 * np.sin(np.arange(frames) / 900.0))
    x = rng.standard_normal((channels, frames)) * env
    return x.astype(np.float32)


def _pair(mode, S, seed, settings=None, group=0, frames=12000, rate=48000):
    data = _pcm(2 * S, frames, seed)
    st = settings or {}
    jn = JAgc(JBuffer(2 * S, rate, data), JAgcSettings(**st), mode=mode,
              streams=S, group=group)
    tn = AutomaticGainControl(SamplesBuffer(2 * S, rate, data, device="cpu"),
                              AgcSettings(**st), mode=mode, streams=S,
                              group=group)
    return jn, tn


@pytest.mark.parametrize("settings", [{}, FAST])
def test_exact_matches_the_oracle(settings):
    """Stereo, 14000 interleaved samples: the 8192-sample window wraps."""
    data = _pcm(2, 7000, seed=11)
    ns = {"attack_ns": round(settings.get("attack_time", 4.0) * 1e9),
          "release_ns": round(settings.get("release_time", 0.0) * 1e9)}
    ref = ri.AutomaticGainControl(
        ri.SamplesBuffer(2, 48000, data.T.reshape(-1)),
        ri.AgcSettings(target_level=settings.get("target_level", 1.0),
                       absolute_max_gain=settings.get("absolute_max_gain", 7.0),
                       **ns))
    expected = ref.collect()
    node = AutomaticGainControl(SamplesBuffer(2, 48000, data, device="cpu"),
                                AgcSettings(**settings), mode="exact")
    got = render(node, block_frames=1500).T.reshape(-1)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, atol=1e-6, rtol=0)
    assert np.abs(got - data.T.reshape(-1)).max() > 1e-3  # the AGC acted


def _knob(node, state, b):
    """The live knobs, turned between blocks."""
    if b == 2:
        state = node.set_attack_time(state, 0.002)
        state = node.set_release_time(state, 0.05)
    if b == 4:
        state = node.set_enabled(state, False)
    if b == 5:
        state = node.set_enabled(state, True)
    return state


@pytest.mark.parametrize("mode,S,group,atol", [
    ("exact", 1, 0, 1e-4),
    ("pallas", 1, 0, 2e-5),    # decomposed: K8 + K7
    ("pallas", 16, 0, 2e-5),   # K6
    ("pallas", 1, 8, 1e-2),    # decomposed, group-rate smoother
])
def test_node_matches_jax_with_live_knobs(mode, S, group, atol):
    jn, tn = _pair(mode, S, seed=S + group, settings=FAST, group=group)
    js, ts = jn.init_state(), tn.init_state()
    steps = {}
    sizes = [640, 4096, 640, 1280, 640, 4096, 640]  # 4096: m >= 8192
    for b, n in enumerate(sizes):
        js, ts = _knob(jn, js, b), _knob(tn, ts, b)
        if n not in steps:
            steps[n] = jax.jit(lambda s, n=n: jn.emit(s, n))
        js, oj, vj = steps[n](js)
        ts, ot, vt = tn.emit(ts, n)
        assert int(vt) == int(vj)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=atol,
                                   rtol=0, err_msg=f"block {b}")
    for k in ("peak", "rms_sum"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(ts["gain"].numpy(), np.asarray(js["gain"]),
                               atol=atol, rtol=0)
    np.testing.assert_array_equal(ts["window"].numpy(), np.asarray(js["window"]))
    assert int(ts["widx"]) == int(js["widx"])


def test_disabled_agc_passes_through_and_freezes():
    _, tn = _pair("pallas", 1, seed=3, settings=FAST)
    ts = tn.emit(tn.init_state(), 640)[0]
    off = tn.set_enabled(ts, False)
    ts2, out, _ = tn.emit(off, 640)
    x = tn.input.emit(ts["in"], 640)[1]
    assert torch.equal(out, x)
    for k in ("peak", "gain", "rms_sum", "window", "widx"):
        assert torch.equal(ts2[k], ts[k])


def test_state_carried_from_jax_into_the_port():
    """3 blocks in JAX, the state carried across bit for bit, 3 more in the
    port; against 6 blocks in JAX (the pallas mode, K6), at the mode's bound
    against JAX: the JAX node on XLA:CPU is itself ~3e-5 from the oracle
    (ROADMAP F4; see test_kernel_modes_match_the_oracle)."""
    jn, tn = _pair("pallas", 12, seed=5, settings=FAST)
    js = jn.init_state()
    step = jax.jit(lambda s: jn.emit(s, 640))
    for _ in range(3):
        js, _, _ = step(js)
    ts = state_from_jax(tn, jax.device_get(js))
    for k in ("peak", "gain", "rms_sum", "window", "widx", "enabled", "att",
              "rel"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
    for b in range(3):
        js, oj, _ = step(js)
        ts, ot, _ = tn.emit(ts, 640)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5,
                                   rtol=0, err_msg=f"block {b}")


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("settings", [{}, FAST])
def test_kernel_modes_match_the_oracle(S, settings):
    """``mode="pallas"`` (S = 1: K8 + K7; S = 9: K6) and ``"exact"``
    against the scalar oracle, stream by stream: exact bit for bit, the
    kernel modes within the AGC kernel bound 2e-5 (the rsqrt form and the
    window sum's order). The JAX node on XLA:CPU misses both here
    (measured 2.7e-5 against the oracle with the default settings, ROADMAP
    F4), so the oracle decides."""
    data = _pcm(2 * S, 7000, seed=13)
    ns = {"attack_ns": round(settings.get("attack_time", 4.0) * 1e9),
          "release_ns": round(settings.get("release_time", 0.0) * 1e9)}
    for mode, atol in (("exact", 0.0), ("pallas", 2e-5)):
        node = AutomaticGainControl(SamplesBuffer(2 * S, 48000, data, device="cpu"),
                                    AgcSettings(**settings), mode=mode,
                                    streams=S)
        got = render(node, block_frames=1750)
        for s in (0, S - 1):
            pair = data[2 * s:2 * s + 2]
            ref = ri.AutomaticGainControl(
                ri.SamplesBuffer(2, 48000, pair.T.reshape(-1)),
                ri.AgcSettings(
                    target_level=settings.get("target_level", 1.0),
                    absolute_max_gain=settings.get("absolute_max_gain", 7.0),
                    **ns)).collect()
            np.testing.assert_allclose(got[2 * s:2 * s + 2].T.reshape(-1), ref,
                                       atol=atol, rtol=0,
                                       err_msg=f"{mode} stream {s}")


def test_unported_modes_raise():
    """The associative modes build and render (M10); unknown names, "assoc"
    among them, raise ValueError; the group-rate smoother needs "pallas"."""
    src = SamplesBuffer(2, 48000, np.zeros((2, 10), np.float32), device="cpu")
    for mode in ("auto", "parallel"):
        node = AutomaticGainControl(src, mode=mode)
        _, out, valid = node.emit(node.init_state(), 10)
        assert out.shape == (2, 10) and int(valid) == 10
        with pytest.raises(ValueError):
            AutomaticGainControl(src, mode=mode, group=8)
    with pytest.raises(ValueError, match="parallel"):
        AutomaticGainControl(src, mode="assoc")
    with pytest.raises(ValueError):
        AutomaticGainControl(src, mode="exact", group=8)
    with pytest.raises(ValueError):
        AutomaticGainControl(src, mode="pallas", group=1)
    with pytest.raises(ValueError):
        AutomaticGainControl(src, mode="bogus")
    assert isinstance(src.automatic_gain_control(), AutomaticGainControl)


@pytest.mark.parametrize("n", [1, 2, 3, 16, 37])
def test_ipow_is_jax_integer_pow(n):
    x = np.float32(0.99987)
    want = np.asarray(jax.lax.integer_pow(jax.numpy.float32(x), n))
    got = ipow(torch.tensor(x), n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group", [0, 8])
def test_config2_chain_matches_jax(group):
    """BASELINE config 2 (path B): low_pass -> AGC -> Limit in the kernel
    modes, 10 s of seeded stereo PCM at 44.1 kHz cut to 3 blocks of 4096
    (m = 8192 interleaved samples, P = 128)."""
    data = _pcm(2, 3 * 4096, seed=21)
    jn = JBuffer(2, 44100, data).low_pass(2000.0)
    jn = JAgc(jn, JAgcSettings(), mode="pallas", group=group)
    jn = JLimit(jn, JLimitSettings(), mode="pallas")
    tn = SamplesBuffer(2, 44100, data, device="cpu").low_pass(2000.0)
    tn = AutomaticGainControl(tn, AgcSettings(), mode="pallas", group=group)
    tn = Limit(tn, LimitSettings(), mode="pallas")
    js, ts = jn.init_state(), tn.init_state()
    step = jax.jit(lambda s: jn.emit(s, 4096))
    for b in range(3):
        js, oj, _ = step(js)
        ts, ot, _ = tn.emit(ts, 4096)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj),
                                   atol=1e-2 if group else 2e-5, rtol=0,
                                   err_msg=f"block {b}")
