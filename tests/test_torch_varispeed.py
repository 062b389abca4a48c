"""The port's VariSpeed against the JAX package's.

Bounds: at ratio 1 the node is bit-transparent; a live ratio change is
held to JAX at 1e-6 (the positions and lerp fractions are the same f32
ops; measured 0 at these ratios, whose products are exact); the cases of
``tests/test_live_controls.py:129-190`` are ported as they are.
"""
import jax
import numpy as np
import pytest
import torch

from rodio_tpu.conversions.varispeed import VariSpeed as JVariSpeed
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
from rodio_tpu_torch.conversions import VariSpeed
from rodio_tpu_torch.sources import SamplesBuffer


def _buf(data, rate=44100):
    return SamplesBuffer(data.shape[0], rate, data, device="cpu")


def test_varispeed_transparent_at_unity(rng):
    data = (rng.standard_normal((2, 3000)) * 0.5).astype(np.float32)
    node = VariSpeed(_buf(data), ratio=1.0, max_block=512)
    state = node.init_state()
    outs = []
    for _ in range(5):
        state, out, v = node.emit(state, 512)
        outs.append(out[:, : int(v)].numpy())
    got = np.concatenate(outs, axis=1)
    assert got.shape[1] > 2000
    np.testing.assert_array_equal(got, data[:, : got.shape[1]])


def test_varispeed_live_ratio_change(rng):
    """Positions follow the continuous phase p += ratio per output frame."""
    frames = 48000
    t = np.arange(frames, dtype=np.float32)
    ramp = np.stack([t, -t]) / frames
    node = VariSpeed(_buf(ramp), ratio=0.5, max_block=256, max_ratio=4.0)
    state = node.init_state()
    state, out_a, va = node.emit(state, 256)
    state = node.set_ratio(state, 2.0)
    state, out_b, vb = node.emit(state, 256)
    assert int(va) == int(vb) == 256
    pa = np.float32(0.5) * np.arange(256, dtype=np.float32)
    pb = np.float32(128.0) + np.float32(2.0) * np.arange(256, dtype=np.float32)
    for ch, sign in ((0, 1.0), (1, -1.0)):
        np.testing.assert_allclose(out_a[ch].numpy(), sign * pa / frames, atol=1e-6)
        np.testing.assert_allclose(out_b[ch].numpy(), sign * pb / frames, atol=1e-6)


def test_varispeed_duration_scales(rng):
    """ratio=2 consumes the stream in half the output frames."""
    frames = 8000
    data = (rng.standard_normal((1, frames)) * 0.5).astype(np.float32)
    node = VariSpeed(_buf(data), ratio=2.0, max_block=512)
    state = node.init_state()
    total = 0
    for _ in range(12):
        state, out, v = node.emit(state, 512)
        total += int(v)
    assert abs(total - frames // 2) <= 2


@pytest.mark.parametrize("ratios,block", [((1.0, 1.25, 0.5, 2.0, 0.75), 300),
                                          ((0.5, 3.0, 1.5), 512)])
def test_varispeed_live_ratio_matches_jax(ratios, block):
    """A ratio schedule against the JAX package's node, through the end of
    the stream (the pull, the ring's shift and the drain)."""
    data = (np.random.default_rng(block).standard_normal((2, 5000)) * 0.4).astype(np.float32)
    jn = JVariSpeed(JBuffer(2, 44100, data), ratio=ratios[0], max_block=block)
    pn = VariSpeed(_buf(data), ratio=ratios[0], max_block=block)
    js, ps = jn.init_state(), pn.init_state()
    step = jax.jit(lambda s: jn.emit(s, block))
    for k in range(20):
        r = ratios[k % len(ratios)]
        js, ps = jn.set_ratio(js, r), pn.set_ratio(ps, r)
        js, jb, jv = step(js)
        ps, pb, pv = pn.emit(ps, block)
        assert int(jv) == int(pv)
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    assert int(pv) == 0  # drained
    for k in ("fill", "in_pulled", "in_end"):
        assert int(js[k]) == int(ps[k]), k
    assert float(js["frac"]) == float(ps["frac"])


def test_varispeed_state_from_jax():
    from rodio_tpu_torch.convert import state_from_jax

    data = (np.random.default_rng(1).standard_normal((1, 4000)) * 0.4).astype(np.float32)
    jn = JVariSpeed(JBuffer(1, 48000, data), ratio=1.5, max_block=256)
    pn = VariSpeed(_buf(data, 48000), ratio=1.5, max_block=256)
    js = jn.init_state()
    for _ in range(3):
        js, _, _ = jn.emit(js, 256)
    js = jn.set_ratio(js, 0.75)
    ps = state_from_jax(pn, jax.device_get(js))
    for _ in range(3):
        js, jb, _ = jn.emit(js, 256)
        ps, pb, _ = pn.emit(ps, 256)
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    assert ps["ratio"].dtype == torch.float32
