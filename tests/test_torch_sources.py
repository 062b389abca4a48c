"""The port's sources against the JAX package's and the scalar oracle.

The same seeds give both packages the same PCM. Bounds:

- buffers, silence and the generators' phases (closed form and the
  ``rodio_compat`` accumulator, ``ops/phase.py``): bit-equal;
- a waveform of those phases: ``torch.sin`` and ``jnp.sin`` (and numpy's,
  the oracle's) may differ by an ulp, so sine cases hold 2 ulps at unit
  scale, 2.4e-7; the piecewise-linear waves are bit-equal;
- against the accumulating oracle, the closed form drifts (within 2e-4 over
  2048 samples, as ``tests/test_block_parity.py`` holds JAX);
- the chirp: 2 ulps of sin against the oracle; its sine argument reaches
  ~3000 rad, where an ulp of it is 2.4e-4 (~75 rad and 7.6e-6 for the
  small sweep), and XLA:CPU may contract its frequency's mul-add, so
  against JAX 4 ulps of the argument.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rodio_tpu.refimpl as ri
from rodio_tpu.graph import render as j_render
from rodio_tpu.sources import Chirp as JChirp
from rodio_tpu.sources import SamplesBuffer as JBuffer
from rodio_tpu.sources import SignalGenerator as JGen
from rodio_tpu.sources import Zero as JZero
from rodio_tpu_torch import render
from rodio_tpu_torch.ops import phase
from rodio_tpu_torch.sources import (
    Chirp, Empty, SamplesBuffer, SawtoothWave, SignalGenerator, SineWave, SquareWave,
    TriangleWave, Zero)

SIN_ULPS = 2.4e-7
FUNCS = ["sine", "triangle", "square", "sawtooth"]


def interleave(block):
    return np.asarray(block).T.reshape(-1)


def ref_collect(src, limit=500_000):
    out = []
    for _ in range(limit):
        v = src.next()
        if v is None:
            break
        out.append(v)
    return np.asarray(out, dtype=np.float32)


def test_buffer_passthrough(rng):
    data = rng.uniform(-1, 1, size=2000).astype(np.float32)
    out = render(SamplesBuffer(2, 48000, data, device="cpu"), block_frames=256)
    np.testing.assert_array_equal(interleave(out), data)


def test_buffer_odd_blocks(rng):
    data = rng.uniform(-1, 1, size=1554).astype(np.float32)
    out = render(SamplesBuffer(2, 48000, data, device="cpu"), block_frames=256)
    np.testing.assert_array_equal(interleave(out), data)


def test_buffer_seek_state(rng):
    data = rng.uniform(-1, 1, (2, 5000)).astype(np.float32)
    tn = SamplesBuffer(2, 48000, data, device="cpu")
    jn = JBuffer(2, 48000, data)
    for secs in (0.0125, 0.5):
        ts = tn.seek_state(tn.init_state(), secs)
        js = jn.seek_state(jn.init_state(), secs)
        assert int(ts["pos"]) == int(js["pos"])
        _, ot, vt = tn.emit(ts, 700)
        _, oj, vj = jn.emit(js, 700)
        assert int(vt) == int(vj)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize("func", FUNCS)
def test_generator_parity(func):
    """The closed form against the accumulating oracle (drift), and against
    JAX's closed form (the same phases; an ulp of sin)."""
    n = 2048
    expected = ref_collect(ri.SignalGenerator(48000, 440.0, func), n)[:n]
    blk = SignalGenerator(48000, 440.0, func, device="cpu")
    got = interleave(render(blk, max_frames=n, block_frames=512))
    err = np.abs(got - expected)
    if func in ("square", "sawtooth"):
        assert np.sum(err > 2e-4) <= 4  # isolated samples at a jump
    else:
        np.testing.assert_allclose(got, expected, atol=2e-4)
    want = interleave(j_render(JGen(48000, 440.0, func), max_frames=n, block_frames=512))
    np.testing.assert_allclose(got, want, atol=SIN_ULPS if func == "sine" else 0, rtol=0)


@pytest.mark.parametrize("func", FUNCS)
def test_generator_rodio_compat_matches_the_oracle(func):
    """rodio_compat=True: the reference's f32 accumulator, drift included,
    over blocks of an odd size; the oracle and JAX's lax.scan run the same
    recurrence."""
    n = 3000
    expected = ref_collect(ri.SignalGenerator(48000, 441.0, func), n)[:n]
    blk = SignalGenerator(48000, 441.0, func, rodio_compat=True, device="cpu")
    got = interleave(render(blk, max_frames=n, block_frames=777))
    tol = SIN_ULPS if func == "sine" else 0
    np.testing.assert_allclose(got, expected, atol=tol, rtol=0)
    jn = JGen(48000, 441.0, func, rodio_compat=True)
    want = interleave(j_render(jn, max_frames=n, block_frames=777))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_phase_accumulator_matches_the_jax_scan():
    """ops/phase.py's plain version (the kernel's, on the CPU) against the
    JAX package's lax.scan: the phases and the carry, bit-equal."""
    gen = JGen(44100, 997.3, "sine", rodio_compat=True)
    step = np.float32(gen._step32)
    p0 = np.float32(0.8731)

    def body(p, _):
        pn = p + step
        return pn - jnp.floor(pn), p

    jp, jph = jax.lax.scan(body, jnp.float32(p0), None, length=4099)
    ph, p = phase.phase_accumulate(torch.tensor([p0]), torch.tensor([step]), 4099)
    np.testing.assert_array_equal(ph[0].numpy(), np.asarray(jph))
    assert p[0].item() == float(jp)
    ph0, p0_out = phase.phase_accumulate(torch.tensor([p0]), torch.tensor([step]), 0)
    assert ph0.shape == (1, 0) and p0_out[0].item() == float(p0)


@pytest.mark.parametrize("cls,func", [(SineWave, "sine"), (SquareWave, "square"),
                                      (TriangleWave, "triangle"),
                                      (SawtoothWave, "sawtooth")])
def test_named_waves(cls, func):
    a = render(cls(330.0, device="cpu"), max_frames=1000, block_frames=300)
    b = render(SignalGenerator(48000, 330.0, func, device="cpu"), max_frames=1000,
               block_frames=300)
    np.testing.assert_array_equal(a, b)


def test_generator_f64_accuracy():
    """The closed form stays closer to the ideal sine than the accumulator."""
    n = 48000 * 5
    got = interleave(render(SignalGenerator(48000, 440.0, "sine", device="cpu"),
                            max_frames=n, block_frames=4096))
    i = np.arange(n, dtype=np.float64)
    ideal = np.sin(2 * np.pi * ((i * (440.0 / 48000.0)) % 1.0))
    assert np.max(np.abs(got - ideal)) < 5e-5


def test_generator_seek_and_callable():
    tn = SignalGenerator(48000, 440.0, "sine", device="cpu")
    jn = JGen(48000, 440.0, "sine")
    ts, js = tn.seek_state(1.2345), jn.seek_state(1.2345)
    assert ts["phase"].item() == float(js["phase"])
    ramp = SignalGenerator(48000, 100.0, lambda p: 2.0 * p - 1.0, device="cpu")
    out = render(ramp, max_frames=960, block_frames=480)
    assert out.min() >= -1.0 and out.max() < 1.0
    with pytest.raises(ValueError):
        SignalGenerator(48000, 0.0, "sine", device="cpu")
    with pytest.raises(ValueError):
        SignalGenerator(48000, 10.0, "noise", device="cpu")


def test_chirp_parity():
    expected = ref_collect(ri.Chirp(48000, 100.0, 1000.0, 500_000_000))
    got = interleave(render(Chirp(48000, 100.0, 1000.0, 0.5, device="cpu"),
                            block_frames=1024))
    assert len(got) == len(expected)
    # the port rounds each op alone, as the oracle does: an ulp of sin
    # (measured 6.0e-8); the JAX node is 7.2e-4 from the oracle
    np.testing.assert_allclose(got, expected, atol=SIN_ULPS, rtol=0)
    want = interleave(j_render(JChirp(48000, 100.0, 1000.0, 0.5), block_frames=1024))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_chirp_parity_small_phase():
    expected = ref_collect(ri.Chirp(48000, 20.0, 60.0, 200_000_000))
    got = interleave(render(Chirp(48000, 20.0, 60.0, 0.2, device="cpu"), block_frames=1024))
    assert len(got) == len(expected)
    np.testing.assert_allclose(got, expected, atol=SIN_ULPS, rtol=0)
    # the argument reaches ~75 rad, an ulp of it 7.6e-6; XLA:CPU may
    # contract the frequency's mul-add (the JAX node is 1.5e-5 from the
    # oracle): 4 ulps of the argument
    want = interleave(j_render(JChirp(48000, 20.0, 60.0, 0.2), block_frames=1024))
    np.testing.assert_allclose(got, want, atol=4e-5, rtol=0)


def test_zero_finite():
    out = render(Zero(2, 48000, num_frames=100, device="cpu"), block_frames=64)
    assert out.shape == (2, 100) and np.all(out == 0)
    tn, jn = Zero(3, 48000, device="cpu"), JZero(3, 48000)
    _, ot, vt = tn.emit(tn.init_state(), 50)
    _, oj, vj = jn.emit(jn.init_state(), 50)
    assert int(vt) == int(vj) == 50 and tn.total_frames() is None
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_empty():
    node = Empty(2, 44100, device="cpu")
    assert node.total_frames() == 0
    _, out, v = node.emit(node.init_state(), 16)
    assert int(v) == 0 and out.shape == (2, 16) and not out.any()
    assert render(node).shape == (2, 0)
