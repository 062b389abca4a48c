"""The port's host helpers and precise math against the JAX package.

Inputs are numpy arrays made from fixed seeds or grids and fed to both
packages. Bound: bit-equal. XLA:CPU runs with denormals flushed to zero,
the port (and the CUDA kernels) with gradual underflow, so where an input
or a result is subnormal the two differ by design; those points are left
out and the port's own value is checked instead.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodio_tpu.core import math as jmath
from rodio_tpu.core import types as jtypes
from rodio_tpu.effects.limit import LimitSettings as JLimitSettings
from rodio_tpu.refimpl.effects import blt_coefficients as j_blt
from rodio_tpu_torch.core import math as tmath
from rodio_tpu_torch.core import types as ttypes
from rodio_tpu_torch.effects.blt import blt_coefficients as t_blt
from rodio_tpu_torch.effects.limit import LimitSettings as TLimitSettings

TINY = np.finfo(np.float32).tiny


def _bits_equal(a, b, mask):
    assert np.array_equal(a[mask].view(np.int32), b[mask].view(np.int32)), (
        np.abs(a[mask] - b[mask]).max())


def test_exp2_precise_bit_equal_on_dense_grid():
    x = np.concatenate([
        np.linspace(-150.0, 130.0, 1_000_001, dtype=np.float32),
        np.random.default_rng(0).standard_normal(100_000).astype(np.float32) * 20,
    ])
    j = np.asarray(jmath.exp2_precise(jnp.asarray(x)))
    t = tmath.exp2_precise(torch.from_numpy(x)).numpy()
    normal = (np.abs(j) >= TINY) | (x < -150)
    _bits_equal(j, t, normal)
    # gradual underflow in the port: 2^x for -149 < x < -126 is subnormal
    sub = (x > -149) & (x < -126.5)
    assert np.all((t[sub] > 0) & (t[sub] < TINY))


def test_log2_precise_bit_equal_on_dense_grid():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        np.logspace(-37.9, 38.3, 1_000_001).astype(np.float32),
        np.linspace(0.5, 2.0, 200_001, dtype=np.float32),
        np.abs(rng.standard_normal(100_000)).astype(np.float32) + TINY,
        np.array([0.0, -1.0, np.inf, TINY], np.float32),
    ])
    j = np.asarray(jmath.log2_precise(jnp.asarray(x)))
    t = tmath.log2_precise(torch.from_numpy(x)).numpy()
    _bits_equal(j, t, np.ones_like(x, dtype=bool))
    # a subnormal input is taken as 2^-126 by the port (XLA:CPU flushes it)
    sub = np.array([1e-40, 1e-45], np.float32)
    assert np.all(tmath.log2_precise(torch.from_numpy(sub)).numpy() == -126.0)


@pytest.mark.parametrize("lo,hi", [(-120.0, 60.0), (-2.0, 2.0)])
def test_db_to_linear_bit_equal(lo, hi):
    db = np.linspace(lo, hi, 400_001, dtype=np.float32)
    j = np.asarray(jmath.db_to_linear(jnp.asarray(db)))
    t = tmath.db_to_linear(torch.from_numpy(db)).numpy()
    _bits_equal(j, t, np.abs(j) >= TINY)


def test_linear_to_db_bit_equal():
    x = np.abs(np.random.default_rng(2).standard_normal(400_000)).astype(np.float32)
    x = np.concatenate([x, np.logspace(-30, 10, 100_000).astype(np.float32), [0.0]])
    x = x.astype(np.float32)
    j = np.asarray(jmath.linear_to_db(jnp.asarray(x)))
    t = tmath.linear_to_db(torch.from_numpy(x)).numpy()
    _bits_equal(j, t, np.ones_like(x, dtype=bool))


@pytest.mark.parametrize("kind", ["low_pass", "high_pass"])
@pytest.mark.parametrize("rate", [8000, 44100, 48000, 96000])
@pytest.mark.parametrize("freq,q", [(20.0, 0.5), (2000.0, 0.5), (5000.0, 0.707),
                                    (3999.0, 2.0)])
def test_blt_coefficients_equal(kind, rate, freq, q):
    a = t_blt(kind, rate, freq, q)
    b = j_blt(kind, rate, freq, q)
    for name in ("b0", "b1", "b2", "a1", "a2"):
        assert np.float32(getattr(a, name)) == np.float32(getattr(b, name)), name
        assert isinstance(getattr(a, name), np.float32)


@pytest.mark.parametrize("rate", [8000, 44100, 48000, 192000])
@pytest.mark.parametrize("secs", [0.0, 0.0005, 0.005, 0.1, 0.2, 1.0, 3.3])
def test_duration_to_coefficient_equal(rate, secs):
    ns = jtypes.duration_to_nanos(secs)
    assert ttypes.duration_to_nanos(secs) == ns
    assert tmath.duration_to_coefficient(0, rate, nanos=ns) == \
        jmath.duration_to_coefficient(0, rate, nanos=ns)
    assert tmath.duration_to_coefficient(secs, rate) == \
        jmath.duration_to_coefficient(secs, rate)


def test_stream_spec_and_nanos_match():
    for ch, rate in [(1, 8000), (2, 44100), (1024, 48000)]:
        a, b = ttypes.StreamSpec(ch, rate), jtypes.StreamSpec(ch, rate)
        assert (a.channels, a.sample_rate) == (b.channels, b.sample_rate)
    for bad in [(0, 48000), (2, 0), (70000, 48000)]:
        with pytest.raises(ValueError):
            ttypes.StreamSpec(*bad)
        with pytest.raises(ValueError):
            jtypes.StreamSpec(*bad)
    with pytest.raises(ValueError):
        ttypes.duration_to_nanos(-1.0)
    for ns in (0, 1, 999_999_999, 5_000_000, 123_456_789_012):
        assert ttypes.nanos_to_secs_f32(ns) == jtypes.nanos_to_secs_f32(ns)
    assert ttypes.float_dtype() is torch.float32


@pytest.mark.parametrize("preset", ["default", "dynamic_content", "broadcast",
                                    "mastering", "live_performance", "gaming"])
def test_limit_settings_presets_equal(preset):
    a, b = getattr(TLimitSettings, preset)(), getattr(JLimitSettings, preset)()
    assert (a.threshold, a.knee_width, a.attack, a.release) == \
        (b.threshold, b.knee_width, b.attack, b.release)
    fields = lambda s: (s.threshold, s.knee_width, s.attack, s.release)  # noqa: E731
    assert fields(a.with_attack(0.01).with_release(0.2).with_threshold(-6.0)
                  .with_knee_width(2.0)) == \
        fields(b.with_attack(0.01).with_release(0.2).with_threshold(-6.0)
               .with_knee_width(2.0))


def test_cuda_constants_match_the_python_ones():
    """csrc/precise_math.cuh carries the same f32 constants as core/math.py."""
    src = (Path(tmath.__file__).resolve().parents[1] / "csrc"
           / "precise_math.cuh").read_text()
    consts = {k: float.fromhex(v) for k, v in re.findall(
        r"(\w+) = (0x[0-9a-f.]+p[+-]\d+)f", src)}
    for i, c in enumerate(tmath.EXP2_C):
        assert consts[f"EXP2_C{i}"] == c
    for i, c in enumerate(tmath.LOG2_K):
        assert consts[f"LOG2_K{i}"] == c
    assert consts["SQRT2_F32"] == tmath.SQRT2_F32
    assert consts["TINY"] == tmath.TINY


def test_sqrt_rn_correctly_rounded():
    """``sqrt_rn`` is the correctly rounded f32 root (numpy's), on values
    across the range and at the edges; PyTorch's CPU f32 ``sqrt`` (MKL's)
    may be an ulp off on some elements, differently from one process to
    the next, which made the noise's erf_inv irreproducible."""
    from rodio_tpu_torch.core.math import sqrt_rn

    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.abs(rng.standard_normal(300000)).astype(np.float32) * 7.0,
        rng.uniform(0, 1e-30, 1000).astype(np.float32),
        np.array([0.0, 1e-45, 1.0, 2.0, 4.0, 3.4e38, np.inf], np.float32)])
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
    assert np.isnan(sqrt_rn(torch.tensor([np.nan, -1.0])).numpy()).all()
