"""The associative scans (``mode="parallel"``, the AGC's ``"auto"``) against
the JAX package, on the CPU.

Each case gives numpy-seeded inputs to the port's function or node and to
the JAX package's. Bounds:

- ``linear_scan``, ``max_affine_scan`` and ``ema_scan``: bit-equal to JAX's
  ``mode="parallel"`` (the port rebuilds ``lax.associative_scan``'s combine
  tree, so each output is combined from the same operands in the same
  order), at odd and even lengths.
- ``biquad_df1``: within 32 ulp of the block's peak |y| (measured 14 over
  six seeds at T up to 3000; 5.4e-7 absolute at T = 512): JAX's combine
  takes ``Ar @ Al`` and an ``einsum`` through XLA:CPU's dot, which sums
  the two products with an FMA; the port rounds each product (ROADMAP
  F4). Any other tree would sit ~5e-5 away.
- The nodes at ``test_block_parity.py``'s own bounds against ``refimpl``:
  ``BltFilter`` 5e-5 (measured 4.8e-6), ``Limit`` 1e-4 (3.0e-6; 2.4e-7
  from the JAX node's parallel mode, held at 2e-6), the AGC's parallel and
  auto modes 1e-4 from its exact mode (measured 0.0).
- K7's ``agc_gain`` (the AGC's gain smoother on this path) bit-equal to
  JAX's ``gain_step`` dispatched op by op (``jax.disable_jit``); under
  ``jit`` XLA:CPU contracts ``g*speed + d*(1-speed)`` into an FMA, 4.3e-6
  apart over 600 steps (F4), held at 1e-4.
- ``make_flagship(4, with_agc=True)`` in ``"auto"`` and ``"parallel"``
  against JAX over 3 blocks of 640 at 2e-5 (the AGC's F4 drift; measured
  2.5e-6; without the AGC 1e-6, measured 1.9e-8), and the JAX f32
  ``cumsum`` of the window sum, itself an associative scan, against the
  port's f64 one at 3e-5 of the largest running sum of |delta|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rodio_tpu.refimpl as ri
from rodio_tpu import effects as J
from rodio_tpu.flagship import make_flagship as j_make_flagship
from rodio_tpu.ops import scan as jscan
from rodio_tpu.sources import SamplesBuffer as JBuffer
from rodio_tpu_torch import make_flagship, render, render_blocks
from rodio_tpu_torch.effects import (AgcSettings, AutomaticGainControl, BltFilter,
                                     Limit, LimitSettings)
from rodio_tpu_torch.effects.blt import blt_coefficients
from rodio_tpu_torch.ops import scan
from rodio_tpu_torch.ops.cuda_scan import first_order
from rodio_tpu_torch.sources import SamplesBuffer

LENGTHS = [1, 2, 3, 7, 512, 1000]


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_inputs(T, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.uniform(0.5, 1.0, (3, T)).astype(f), rng.standard_normal((3, T)).astype(f),
            rng.uniform(0.9, 1.0, (3, T)).astype(f), rng.standard_normal(3).astype(f))


@pytest.mark.parametrize("T", LENGTHS)
def test_linear_scan_matches_jax_parallel(T):
    a, b, _, init = _scan_inputs(T, T)
    want = np.asarray(jscan.linear_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(init),
                                        mode="parallel"))
    got = scan.linear_scan(_t(a), _t(b), _t(init), mode="parallel").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", LENGTHS)
def test_max_affine_scan_matches_jax_parallel(T):
    _, b, c, init = _scan_inputs(T, T + 1)
    a, bb = np.abs(b), (np.float32(0.05) * np.abs(b))
    want = np.asarray(jscan.max_affine_scan(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(c),
                                            jnp.asarray(init), mode="parallel"))
    got = scan.max_affine_scan(_t(a), _t(bb), _t(c), _t(init), mode="parallel").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", LENGTHS)
def test_ema_scan_matches_jax_parallel(T):
    _, x, c, init = _scan_inputs(T, T + 2)
    want = np.asarray(jscan.ema_scan(jnp.asarray(x), jnp.asarray(c), jnp.asarray(init),
                                     mode="parallel"))
    got = scan.ema_scan(_t(x), _t(c), _t(init), mode="parallel").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", LENGTHS)
def test_biquad_parallel_matches_jax_parallel(T):
    rng = np.random.default_rng(T + 3)
    x = rng.standard_normal((4, T)).astype(np.float32)
    st = [(rng.standard_normal(4) * 0.1).astype(np.float32) for _ in range(4)]
    co = blt_coefficients("low_pass", 44100, 1200.0, 0.5).as_tuple()
    yj, sj = jscan.biquad_df1(jnp.asarray(x), co, tuple(jnp.asarray(v) for v in st),
                              mode="parallel")
    yt, stt = scan.biquad_df1(_t(x), torch.tensor(co), tuple(_t(v) for v in st),
                              mode="parallel")
    yj = np.asarray(yj)
    bound = 32 * np.spacing(np.float32(np.abs(yj).max()))
    np.testing.assert_allclose(yt.numpy(), yj, atol=bound, rtol=0)
    for a, b in zip(stt, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=bound, rtol=0)


def test_biquad_parallel_short_blocks_take_the_exact_scan():
    """T < 2 falls back to the sequential scan, carries and all, as JAX's."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((3, 1)).astype(np.float32))
    st = tuple(_t(rng.standard_normal(3).astype(np.float32)) for _ in range(4))
    co = torch.tensor(blt_coefficients("high_pass", 48000, 300.0, 0.7).as_tuple())
    yp, sp = scan.biquad_df1(x, co, st, mode="parallel")
    ye, se = scan.biquad_df1(x, co, st, mode="exact")
    assert torch.equal(yp, ye) and all(torch.equal(a, b) for a, b in zip(sp, se))


@pytest.mark.parametrize("kind", ["low_pass", "high_pass"])
@pytest.mark.parametrize("channels", [1, 2])
def test_blt_parity_parallel(rng, kind, channels):
    """test_block_parity.py::test_blt_parity[parallel] on the port: 5e-5."""
    data = rng.uniform(-1, 1, size=3000 * channels).astype(np.float32)
    expected = ref_collect(ri.BltFilter(ri.SamplesBuffer(channels, 44100, data), kind,
                                        1200.0, 0.5))
    node = BltFilter(SamplesBuffer(channels, 44100, data, device="cpu"), kind, 1200.0, 0.5,
                     mode="parallel")
    got = interleave(render(node, block_frames=512))
    assert len(got) == len(expected)
    np.testing.assert_allclose(got, expected, atol=5e-5, rtol=0)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_limit_parity_parallel(rng, channels):
    """test_block_parity.py::test_limit_parity[parallel] on the port: 1e-4
    against refimpl; against the JAX node's parallel mode 2e-6 (the dB
    path's F4)."""
    data = (rng.uniform(-1, 1, size=3000 * channels) * 2.0).astype(np.float32)
    expected = ref_collect(ri.Limit(ri.SamplesBuffer(channels, 44100, data),
                                    ri.LimitSettings()))
    node = Limit(SamplesBuffer(channels, 44100, data, device="cpu"), LimitSettings(),
                 mode="parallel")
    got = interleave(render(node, block_frames=512))
    assert len(got) == len(expected)
    np.testing.assert_allclose(got, expected, atol=1e-4, rtol=0)
    from rodio_tpu.graph import render as j_render

    want = interleave(j_render(J.Limit(JBuffer(channels, 44100, data), J.LimitSettings(),
                                       mode="parallel"), block_frames=512))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_agc_parallel_close(rng):
    """test_block_parity.py::test_agc_parallel_close on the port: the
    parallel and auto modes within 1e-4 of the exact mode."""
    data = (rng.uniform(-1, 1, size=12000) * 0.4).astype(np.float32)
    exact = interleave(render(AutomaticGainControl(
        SamplesBuffer(1, 44100, data, device="cpu"), AgcSettings(), mode="exact"),
        block_frames=1024))
    for mode in ("parallel", "auto"):
        par = interleave(render(AutomaticGainControl(
            SamplesBuffer(1, 44100, data, device="cpu"), AgcSettings(), mode=mode),
            block_frames=1024))
        np.testing.assert_allclose(par, exact, atol=1e-4, rtol=0, err_msg=mode)


def _jax_gain_step(desired, g0, att, rel, max_gain):
    """The JAX AGC's sequential gain smoother (rodio_tpu/effects/agc.py
    ``gain_step``), as written there."""
    dt = np.float32

    def gain_step(g, d):
        speed = jnp.where(d > g, att, rel)
        g = g * speed + d * (1.0 - speed)
        g = jnp.clip(g, dt(0.1), max_gain)
        return g, g

    _, gs = jax.lax.scan(gain_step, g0, desired.T)
    return gs.T


@pytest.mark.parametrize("att", [0.99, 0.9999948])
def test_k7_agc_gain_equals_jax_gain_step(att):
    rng = np.random.default_rng(int(att * 1000))
    des = rng.uniform(0.05, 8.0, (2, 600)).astype(np.float32)
    g0 = rng.uniform(0.5, 2.0, 2).astype(np.float32)
    p = (np.float32(att), np.float32(0.9995834), np.float32(7.0))
    args = (jnp.asarray(des), jnp.asarray(g0), *(jnp.asarray(v) for v in p))
    got = first_order(_t(des), _t(des), _t(g0), op="agc_gain",
                      params=[float(v) for v in p]).numpy()
    with jax.disable_jit():
        np.testing.assert_array_equal(got, np.asarray(_jax_gain_step(*args)))
    jitted = np.asarray(jax.jit(_jax_gain_step)(*args))
    np.testing.assert_allclose(got, jitted, atol=1e-4, rtol=0)


def test_window_sum_against_jax_cumsum():
    """The third branch's running window sum: the port's f64 cumsum rounded
    back against JAX's f32 cumsum (an associative scan of f32 adds)."""
    rng = np.random.default_rng(4)
    sq = (rng.uniform(-1, 1, (3, 8192)) * 0.5).astype(np.float32) ** 2
    old = np.roll(sq, 3000, axis=1)
    delta = sq - old
    want = np.asarray(jnp.cumsum(jnp.asarray(delta), axis=1))
    got = torch.cumsum(_t(delta).double(), dim=1).float().numpy()
    scale = np.abs(np.cumsum(np.abs(delta), axis=1)).max()
    np.testing.assert_allclose(got, want, atol=3e-5 * scale, rtol=0)


@pytest.mark.parametrize("mode", ["auto", "parallel"])
def test_agc_flagship_matches_jax(mode):
    jn, js = j_make_flagship(4, seconds=0.05, scan_mode=mode, with_agc=True)
    emit = jax.jit(lambda s: jn.emit(s, 640))
    outs = []
    for _ in range(3):
        js, o, _ = emit(js)
        outs.append(np.asarray(o))
    tn, ts = make_flagship(4, seconds=0.05, scan_mode=mode, with_agc=True, device="cpu")
    _, ot, vt = render_blocks(tn, ts, 3, 640)
    assert vt.tolist() == [640] * 3
    np.testing.assert_allclose(ot.numpy(), np.concatenate(outs, axis=1), atol=2e-5, rtol=0)


def test_parallel_flagship_matches_jax_without_agc():
    jn, js = j_make_flagship(4, seconds=0.05, scan_mode="parallel")
    emit = jax.jit(lambda s: jn.emit(s, 640))
    outs = []
    for _ in range(3):
        js, o, _ = emit(js)
        outs.append(np.asarray(o))
    tn, ts = make_flagship(4, seconds=0.05, scan_mode="parallel", device="cpu")
    _, ot, _ = render_blocks(tn, ts, 3, 640)
    np.testing.assert_allclose(ot.numpy(), np.concatenate(outs, axis=1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["assoc", "bogus", "Parallel"])
def test_unknown_mode_names_raise(name):
    src = SamplesBuffer(2, 48000, np.zeros((2, 16), np.float32), device="cpu")
    match = "parallel" if name == "assoc" else "unknown mode"
    for build in (lambda: BltFilter(src, "low_pass", 1000.0, mode=name),
                  lambda: Limit(src, LimitSettings(), mode=name),
                  lambda: AutomaticGainControl(src, mode=name),
                  lambda: make_flagship(4, seconds=0.1, scan_mode=name, device="cpu")):
        with pytest.raises(ValueError, match=match):
            build()
    with pytest.raises(ValueError, match="parallel"):
        scan.linear_scan(torch.zeros(1, 2), torch.zeros(1, 2), torch.zeros(1), mode=name
                         if name == "assoc" else "assoc")
