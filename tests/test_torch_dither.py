"""The port's Dither against the JAX package's, in all four algorithms.

The noise is drawn by the port's threefry, bit for bit JAX's, and the
subtraction is exact (the noise times a power of two), so TPDF, RPDF and
HighPass are bit-equal to JAX's output; GPDF's Gaussian goes through XLA's
``erf_inv`` polynomial, within ERFINV_ULPS = 4 ulp of JAX's draws
(``tests/test_torch_noise.py``), so its output is held to 4 ulp of the
noise (|noise| < 4: 4 * 2^-21) times lsb, plus one ulp of the output
(|out| < 1: 2^-24) where the subtraction then rounds the other way.
"""
import jax
import numpy as np
import pytest

from rodio_tpu.effects.dither import Dither as JDither
from rodio_tpu.graph import render as j_render
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
from rodio_tpu_torch import render
from rodio_tpu_torch.effects import Dither
from rodio_tpu_torch.sources import SamplesBuffer


@pytest.fixture(autouse=True)
def _jax_contract():
    if jax.__version__ != "0.9.0" or not jax.config.jax_threefry_partitionable:
        pytest.skip("the bitwise contract is JAX 0.9.0's partitionable threefry")


@pytest.mark.parametrize("algo", ["tpdf", "rpdf", "gpdf", "highpass"])
@pytest.mark.parametrize("bits,block", [(16, 256), (8, 333), (24, 1000)])
def test_dither_matches_jax(algo, bits, block):
    data = np.random.default_rng(bits).uniform(-0.9, 0.9, (2, 2500)).astype(np.float32)
    want = np.asarray(j_render(JDither(JBuffer(2, 48000, data), bits, algo, seed=11),
                               block_frames=block))
    got = render(Dither(SamplesBuffer(2, 48000, data, device="cpu"), bits, algo, seed=11),
                 block_frames=block)
    assert got.shape == want.shape == (2, 2500)
    if algo == "gpdf":
        lsb = 1.0 / (1 << (bits - 1))
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -21 * lsb + 2.0 ** -24)
        assert not np.array_equal(got, data)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [128, 1000])
def test_highpass_continuity_at_block_boundaries(block):
    """The carried white sample keeps the blue noise continuous across
    blocks: each sample is white[t] - white[t-1] with white[t-1] from the
    previous block at a boundary, so the running sum gives the white draws
    back, within [-1, 1] (without the carry it would wander off). Equal to
    the JAX package's render at the same blocks."""
    data = np.zeros((1, 4000), np.float32)
    got = render(Dither(SamplesBuffer(1, 48000, data, device="cpu"), 4, "highpass", seed=2),
                 block_frames=block)
    want = np.asarray(j_render(JDither(JBuffer(1, 48000, data), 4, "highpass", seed=2),
                               block_frames=block))
    np.testing.assert_array_equal(got, want)
    white = np.cumsum(-got[0].astype(np.float64) / (1.0 / 8))
    assert np.abs(white).max() <= 1.0 + 1e-6
