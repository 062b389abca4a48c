"""The port's flagship slice against the JAX package's, on the CPU.

Both packages build ``make_flagship(8, seconds=0.5, ...)`` from the same
seed (identical numpy PCM and gains) and render blocks of 640. Bounds:
1e-6 against the JAX fused path (another lerp and mix summation order, the
gain before the biquad), 1e-5 against the JAX unfused chain away from the
drain frame (the JAX package's own fused-vs-unfused bound).
"""
import subprocess
import sys

import jax
import numpy as np
import pytest

from rodio_tpu.flagship import make_flagship as j_make_flagship
from rodio_tpu_torch import make_flagship, render_blocks
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.flagship import FusedWidePipeline
from rodio_tpu_torch.sources.generators import SamplesBuffer


def _jax_blocks(node, state, n_blocks, T=640):
    emit = jax.jit(lambda s: node.emit(s, T))
    outs, valids = [], []
    for _ in range(n_blocks):
        state, o, v = emit(state)
        outs.append(np.asarray(o))
        valids.append(int(v))
    return state, np.concatenate(outs, axis=1), valids


def test_fused_slice_matches_jax_fused_and_unfused():
    jf, jfs = j_make_flagship(8, seconds=0.5, scan_mode="fused")
    je, jes = j_make_flagship(8, seconds=0.5, scan_mode="exact")
    tn, ts = make_flagship(8, seconds=0.5, scan_mode="fused")
    assert tn.input.precision == jf.input.precision
    _, of, vf = _jax_blocks(jf, jfs, 5)
    _, oe, ve = _jax_blocks(je, jes, 5)
    _, ot, vt = render_blocks(tn, ts, 5, 640)
    assert vt.tolist() == vf == ve == [640] * 5
    np.testing.assert_allclose(ot.numpy(), of, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ot.numpy(), oe, atol=1e-5, rtol=0)


def test_unfused_slice_matches_jax_exact():
    je, jes = j_make_flagship(8, seconds=0.5, scan_mode="exact")
    tn, ts = make_flagship(8, seconds=0.5, scan_mode="exact")
    assert tn.total_frames() == je.total_frames()
    _, oe, ve = _jax_blocks(je, jes, 5)
    _, ot, vt = render_blocks(tn, ts, 5, 640)
    assert vt.tolist() == ve
    np.testing.assert_allclose(ot.numpy(), oe, atol=1e-6, rtol=0)


def test_fused_slice_through_the_drain():
    """0.3 s of input: the render runs past the end; valid counts and
    outputs match the JAX fused path, and the unfused chain away from the
    one drain frame."""
    jf, jfs = j_make_flagship(4, seconds=0.3, seed=2, scan_mode="fused")
    je, jes = j_make_flagship(4, seconds=0.3, seed=2, scan_mode="exact")
    tn, ts = make_flagship(4, seconds=0.3, seed=2, scan_mode="fused")
    _, of, vf = _jax_blocks(jf, jfs, 24)
    _, oe, ve = _jax_blocks(je, jes, 24)
    _, ot, vt = render_blocks(tn, ts, 24, 640)
    assert vt.tolist() == vf == ve
    assert vf[-1] == 0 and 0 < min(v for v in vf if v) < 640
    np.testing.assert_allclose(ot.numpy(), of, atol=1e-6, rtol=0)
    drain = sum(vf) - 1
    keep = np.ones(ot.shape[1], bool)
    keep[drain] = False
    np.testing.assert_allclose(ot.numpy()[:, keep], oe[:, keep], atol=1e-5, rtol=0)


@pytest.mark.parametrize("scan_mode", ["fused", "exact"])
def test_state_carried_from_jax_into_the_port(scan_mode):
    """Render 3 blocks in JAX, carry the state across, render 3 more in the
    port; compare with 6 blocks in JAX."""
    jn, js = j_make_flagship(8, seconds=0.5, seed=4, scan_mode=scan_mode)
    tn, _ = make_flagship(8, seconds=0.5, seed=4, scan_mode=scan_mode)
    js3, o3, _ = _jax_blocks(jn, js, 3)
    _, o6, v6 = _jax_blocks(jn, js3, 3)
    ts = state_from_jax(tn, jax.device_get(js3))
    ts, ot, vt = render_blocks(tn, ts, 3, 640)
    assert vt.tolist() == v6
    np.testing.assert_allclose(ot.numpy(), o6, atol=1e-6, rtol=0)
    assert np.abs(o3).max() > 0


def test_fused_retune_matches_jax():
    jf, jfs = j_make_flagship(8, seconds=0.5, seed=1, scan_mode="fused")
    tn, ts = make_flagship(8, seconds=0.5, seed=1, scan_mode="fused")
    jfs, _, _ = _jax_blocks(jf, jfs, 2)
    ts, _, _ = render_blocks(tn, ts, 2, 640)
    jfs = {**jfs, "in": jf.input.retune(jfs["in"], freq=900.0, q=0.8)}
    ts = {**ts, "in": tn.input.retune(ts["in"], freq=900.0, q=0.8)}
    np.testing.assert_array_equal(ts["in"]["coeffs"].numpy(),
                                  np.asarray(jfs["in"]["coeffs"]))
    _, of, _ = _jax_blocks(jf, jfs, 3)
    _, ot, _ = render_blocks(tn, ts, 3, 640)
    np.testing.assert_allclose(ot.numpy(), of, atol=1e-6, rtol=0)


def _grid_pcm(bits, frames=4000, seed=3):
    k = np.random.default_rng(seed).integers(-2 ** (bits - 3), 2 ** (bits - 3),
                                             size=(2, frames))
    return (k / 2.0 ** (bits - 1)).astype(np.float32)


@pytest.mark.parametrize("bits,label", [(16, "i8"), (24, "i24")])
def test_precision_probe_matches_jax(bits, label):
    pcm = _grid_pcm(bits)
    jn, _ = j_make_flagship(4, seconds=0.1, scan_mode="fused", source_pcm=pcm)
    tn, _ = make_flagship(4, seconds=0.1, scan_mode="fused", source_pcm=pcm)
    assert tn.input.precision == jn.input.precision == label
    tn2, _ = make_flagship(4, seconds=0.1, scan_mode="fused", source_pcm=pcm,
                           precision=label)
    assert tn2.input.precision == label


@pytest.mark.parametrize("precision", ["i8", "i24"])
def test_precision_off_grid_raises(precision):
    with pytest.raises(ValueError, match="grid"):
        make_flagship(4, seconds=0.1, scan_mode="fused", precision=precision)
    with pytest.raises(AssertionError):
        j_make_flagship(4, seconds=0.1, scan_mode="fused", precision=precision)


def test_refused_configurations():
    with pytest.raises(NotImplementedError, match="K2"):
        FusedWidePipeline(SamplesBuffer(4, 44100, np.zeros((4, 100), np.float32)),
                          48000, np.ones(2, np.float32), 2, with_agc=True)
    with pytest.raises(ValueError, match="identity"):
        FusedWidePipeline(SamplesBuffer(4, 48000, np.zeros((4, 100), np.float32)),
                          48000, np.ones(2, np.float32), 2)
    with pytest.raises(ValueError):
        make_flagship(4, seconds=0.1, scan_mode="fused", precision="bf16")
    with pytest.raises(NotImplementedError):
        make_flagship(4, seconds=0.1, scan_mode="assoc")
    with pytest.raises(NotImplementedError):
        make_flagship(4, seconds=0.1, with_agc=True)


def test_import_loads_no_jax():
    code = ("import sys, rodio_tpu_torch, rodio_tpu_torch.convert, "
            "rodio_tpu_torch.ops.fused; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'rodio_tpu' or m.startswith('rodio_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
