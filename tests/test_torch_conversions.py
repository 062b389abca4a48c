"""The port's conversions against the JAX package's and the scalar oracle.

Each case gives the same numpy-seeded PCM to the JAX node, to the port's
node on the CPU and, where one exists, to ``rodio_tpu.refimpl``. The
resampler's three emit paths:

- the weight form (the JAX matmul path): within 2e-7 of the oracle (one
  f32 ulp at unit scale; the oracle lerps) and 1e-6 of JAX;
- the lerp form over a random-access upstream (spans, and windows past the
  upstream's padding) and the streaming ring over any other upstream: the
  oracle's own lerp, held at 2e-7 as ``tests/test_block_parity.py`` holds
  JAX (measured: bit-equal), and JAX at 2e-7 (XLA:CPU may contract the
  lerp's mul-add into an FMA).

``block_bf16``'s bounds are those of ``test_bf16_block_mode``: within 1e-2
relative of the f32 render and more than 1e-6 from it; against the JAX
package's bf16 render (K4's bf16 instance against the Pallas kernel in
interpret mode) within 4e-3 relative, two bf16 ulps.
"""
import jax
import numpy as np
import pytest
import torch

import rodio_tpu.refimpl as ri
from rodio_tpu.conversions import RechannelNode as JRechannel
from rodio_tpu.conversions import Resample as JResample
from rodio_tpu.conversions import Uniform as JUniform
from rodio_tpu.conversions.blockdtype import Bf16Boundary as JBf16
from rodio_tpu.effects import Amplify as JAmplify
from rodio_tpu.graph import render as j_render
from rodio_tpu.ops.pallas_scan import biquad_df1_pallas
from rodio_tpu.sources import SamplesBuffer as JBuffer
from rodio_tpu_torch import make_flagship, render
from rodio_tpu_torch.conversions import Bf16Boundary, RechannelNode, Resample, Uniform
from rodio_tpu_torch.core.node import tree_select
from rodio_tpu_torch.effects import Amplify, Pausable
from rodio_tpu_torch.ops import cuda_scan
from rodio_tpu_torch.sources import SamplesBuffer

ORACLE = 2e-7


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


class _Iter:
    def __init__(self, s):
        self.s = s

    def next(self):
        return self.s.next()


class _HideRandomAccess:
    """Hides an upstream's gathers so the resampler takes its streaming
    ring path (the JAX test's wrapper; the port's needs a device)."""

    def __init__(self, inner):
        self._inner = inner
        self.spec = inner.spec
        self.device = getattr(inner, "device", None)

    def total_frames(self):
        return self._inner.total_frames()

    def init_state(self):
        return self._inner.init_state()

    def emit(self, state, n):
        return self._inner.emit(state, n)


RATE_PAIRS = [(44100, 48000), (48000, 44100), (48000, 96000), (96000, 48000),
              (22050, 48000), (48000, 8000), (44100, 192000), (12000, 2400),
              (1000, 7000)]


@pytest.mark.parametrize("from_rate,to_rate", RATE_PAIRS)
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("path", ["fast", "generic"])
def test_resample_parity(rng, from_rate, to_rate, channels, path):
    """tests/test_block_parity.py's case on the port; "generic" hides the
    gathers, so the port's ring path runs (the acceptance case: every rate
    pair and channel count within 2e-7 of the oracle)."""
    frames = 997
    data = rng.uniform(-1, 1, size=frames * channels).astype(np.float32)
    conv = ri.SampleRateConverter(_Iter(ri.SamplesBuffer(channels, from_rate, data)),
                                  from_rate, to_rate, channels)
    expected = ref_collect(conv)
    src = SamplesBuffer(channels, from_rate, data, device="cpu")
    jsrc = JBuffer(channels, from_rate, data)
    if path == "generic":
        src, jsrc = _HideRandomAccess(src), _HideRandomAccess(jsrc)
    blk = Resample(src, to_rate, max_block=1024)
    assert blk.total_frames() == len(expected) // channels
    got = interleave(render(blk, block_frames=251))
    assert len(got) == len(expected)
    np.testing.assert_allclose(got, expected, atol=ORACLE, rtol=0)
    want = interleave(j_render(JResample(jsrc, to_rate, max_block=1024), block_frames=251))
    np.testing.assert_allclose(got, want, atol=ORACLE if path == "generic" else 1e-6,
                               rtol=0)


def test_resample_ring_path_reads_in_pulls(rng):
    """The ring's bookkeeping matches the JAX node's block by block: the
    pulled count, the input end and the drain flag."""
    data = rng.uniform(-1, 1, (2, 3001)).astype(np.float32)
    tn = Resample(_HideRandomAccess(SamplesBuffer(2, 44100, data, device="cpu")), 48000,
                  max_block=640)
    jn = JResample(_HideRandomAccess(JBuffer(2, 44100, data)), 48000, max_block=640)
    ts, js = tn.init_state(), jn.init_state()
    step = jax.jit(lambda s: jn.emit(s, 640))
    for _ in range(7):
        ts, ot, vt = tn.emit(ts, 640)
        js, oj, vj = step(js)
        assert int(vt) == int(vj)
        for k in ("base_g", "fill", "out_o", "in_pulled", "in_end", "drained"):
            assert int(ts[k]) == int(js[k]), k
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ORACLE, rtol=0)
    assert int(vt) == 0
    with pytest.raises(AssertionError, match="max_block"):
        tn.emit(ts, 641)


def test_resample_identity(rng):
    data = rng.uniform(-1, 1, size=1000).astype(np.float32)
    blk = Resample(SamplesBuffer(2, 44100, data, device="cpu"), 44100)
    np.testing.assert_array_equal(interleave(render(blk, block_frames=128)), data)


def test_resample_dispatch_lerp_form_past_the_padding(rng):
    """A default-padded buffer (8192 frames) at 44.1 -> 48 kHz in blocks of
    12800: the window (12800 // 160 + 2) * 147 + 1 = 12055 exceeds the
    padding, so the JAX package takes the lerp form, and so must the port
    (it used to take the weight form everywhere, which rounds
    differently)."""
    data = rng.uniform(-1, 1, (2, 30000)).astype(np.float32)
    node = Resample(SamplesBuffer(2, 44100, data, device="cpu"), 48000)
    assert not node.uses_weight_form(12800) and node.uses_weight_form(4096)
    got = render(node, block_frames=12800)
    expected = ref_collect(ri.SampleRateConverter(
        _Iter(ri.SamplesBuffer(2, 44100, interleave(data))), 44100, 48000, 2))
    # the lerp form is the oracle's own: bit-equal
    np.testing.assert_array_equal(interleave(got), expected)
    want = j_render(JResample(JBuffer(2, 44100, data), 48000), block_frames=12800)
    np.testing.assert_allclose(got, want, atol=ORACLE, rtol=0)
    # the weight form, where the padding admits it, rounds differently
    wide = Resample(SamplesBuffer(2, 44100, data, pad_frames=16384, device="cpu"), 48000)
    assert wide.uses_weight_form(12800)
    weight = render(wide, block_frames=12800)
    assert 0 < np.abs(weight - got).max() <= ORACLE


@pytest.mark.parametrize("hide", [False, True])
def test_uniform_rodio_compat_long_buffer(rng, hide):
    """BASELINE config 1 on the CPU: 40 000 stereo frames, three spans
    (src/source/uniform.rs:56), through the span path (random access) and
    the ring path with spans (hidden gathers): within 2e-7 of the oracle's
    UniformSourceIterator and of JAX's Uniform."""
    channels, frames = 2, 40_000
    data = rng.uniform(-1, 1, size=frames * channels).astype(np.float32)
    expected = ref_collect(ri.UniformSourceIterator(
        ri.SamplesBuffer(channels, 44100, data), 2, 48000))
    src = SamplesBuffer(channels, 44100, data, device="cpu")
    jsrc = JBuffer(channels, 44100, data)
    if hide:
        src, jsrc = _HideRandomAccess(src), _HideRandomAccess(jsrc)
    blk = Uniform(src, 2, 48000, rodio_compat=True)
    assert blk.total_frames() == len(expected) // channels
    got = interleave(render(blk, block_frames=1024))
    assert len(got) == len(expected)
    np.testing.assert_allclose(got, expected, atol=ORACLE, rtol=0)
    want = interleave(j_render(JUniform(jsrc, 2, 48000, rodio_compat=True),
                               block_frames=1024))
    np.testing.assert_allclose(got, want, atol=ORACLE, rtol=0)


def test_uniform_channel_upmix(rng):
    data = rng.uniform(-1, 1, size=300).astype(np.float32)
    got = render(Uniform(SamplesBuffer(1, 48000, data, device="cpu"), 2, 48000))
    np.testing.assert_array_equal(got[0], data)
    np.testing.assert_array_equal(got[1], data)


@pytest.mark.parametrize("frm,to", [(1, 2), (1, 3), (3, 2), (2, 5), (2, 2)])
def test_rechannel_matches(rng, frm, to):
    data = rng.uniform(-1, 1, (frm, 700)).astype(np.float32)
    got = render(RechannelNode(SamplesBuffer(frm, 48000, data, device="cpu"), to),
                 block_frames=256)
    want = j_render(JRechannel(JBuffer(frm, 48000, data), to), block_frames=256)
    np.testing.assert_array_equal(got, want)
    node = SamplesBuffer(frm, 48000, data, device="cpu").rechannel(to)
    np.testing.assert_array_equal(render(node), got)


def test_tree_select_refuses_a_differing_host_value():
    pred = torch.tensor(True)
    a, b = torch.zeros(3), torch.ones(3)
    out = tree_select(pred, {"x": a, "o": 5, "t": (a, 1)}, {"x": b, "o": 5, "t": (b, 1)})
    assert out["o"] == 5 and torch.equal(out["x"], a) and torch.equal(out["t"][0], a)
    assert tree_select(pred, {"x": a}, {"x": a})["x"] is a  # shared: kept
    with pytest.raises(TypeError, match="differ"):
        tree_select(pred, {"o": 0}, {"o": 12800})
    with pytest.raises(TypeError):
        tree_select(pred, {"o": a}, {"o": 3})
    # the fused pipeline keeps a host output offset (K1's taps are built
    # from it), so a device flag cannot hold its state: it raises
    master, state = make_flagship(2, seconds=0.05, scan_mode="fused", device="cpu")
    node = Pausable(master)
    with pytest.raises(TypeError, match="differ"):
        node.emit(node.init_state(), 256)


def test_pausable_resample_resumes_at_frame_zero(rng):
    """SamplesBuffer(...).resample(48000).pausable(True): silent (and
    valid) while paused, the resampler's state held; unpaused, it starts
    at output frame 0."""
    data = rng.uniform(-1, 1, (2, 4000)).astype(np.float32)
    node = SamplesBuffer(2, 44100, data, device="cpu").resample(48000).pausable(True)
    st = node.init_state()
    for _ in range(3):
        st, out, v = node.emit(st, 512)
        assert int(v) == 512 and not out.any()
    assert int(st["in"]["out_o"]) == 0
    st = {**st, "paused": torch.tensor(False)}
    st, out, v = node.emit(st, 512)
    plain = Resample(SamplesBuffer(2, 44100, data, device="cpu"), 48000)
    _, want, _ = plain.emit(plain.init_state(), 512)
    assert int(v) == 512
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_bf16_boundary_then_scalar_amplify_is_f32(rng):
    """A bf16 block times a scalar f32 factor is f32 in JAX; in torch a 0-dim
    f32 factor would keep bf16, so Amplify upcasts: equal to JAX."""
    data = rng.uniform(-1, 1, (2, 600)).astype(np.float32)
    node = Amplify(Bf16Boundary(SamplesBuffer(2, 48000, data, device="cpu")), 0.7)
    st, out, _ = node.emit(node.init_state(), 256)
    assert out.dtype == torch.float32
    jn = JAmplify(JBf16(JBuffer(2, 48000, data)), 0.7)
    _, jout, _ = jn.emit(jn.init_state(), 256)
    assert jout.dtype == np.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    _, b, _ = Bf16Boundary(SamplesBuffer(2, 48000, data, device="cpu")).emit(
        SamplesBuffer(2, 48000, data, device="cpu").init_state(), 8)
    assert b.dtype == torch.bfloat16  # the boundary itself, and mask_block, keep bf16


@pytest.mark.parametrize("T", [640, 7, 1])
def test_biquad_bf16_carries_cross_blocks(rng, T):
    """K4's bf16 instance (the plain version on the CPU) against the Pallas
    kernel in interpret mode over two blocks: y is stored bf16 and the y
    carries are the stored outputs, so the second block's feedback is the
    rounded output. Bound: one bf16 ulp of y (XLA:CPU may contract the
    biquad's mul-adds, which moves the f32 y by ulps and may flip its bf16
    rounding)."""
    L = 6
    from rodio_tpu_torch.effects.blt import blt_coefficients

    co = blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple()
    xs = [torch.from_numpy(rng.standard_normal((L, T)).astype(np.float32) * 0.3)
          .to(torch.bfloat16) for _ in range(2)]
    st = tuple(torch.zeros(L) for _ in range(4))
    jst = tuple(np.zeros(L, np.float32) for _ in range(4))
    for x in xs:
        y, st = cuda_scan.biquad_df1(x, torch.tensor(co), st)
        assert y.dtype == torch.bfloat16 and all(s.dtype == torch.float32 for s in st)
        # the carries: the last inputs and the stored, rounded outputs
        np.testing.assert_array_equal(st[2].numpy(), y[:, -1].float().numpy())
        if T >= 2:
            np.testing.assert_array_equal(st[3].numpy(), y[:, -2].float().numpy())
        np.testing.assert_array_equal(st[0].numpy(), x[:, -1].float().numpy())
        if T < 2:
            continue  # the JAX wrapper's T < 2 carries come off padded steps
        jx = jax.numpy.asarray(x.float().numpy()).astype(jax.numpy.bfloat16)
        jy, jst = biquad_df1_pallas(jx, co, jst, interpret=True)
        np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                                   atol=2 ** -8 * 0.3 * 4, rtol=2 ** -7)
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2 ** -7, atol=1e-3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_scan.biquad_df1(xs[0].half(), torch.tensor(co), st)


def _flagship_blocks(make, jit=False, **kw):
    node, state = make(16, seconds=0.6, seed=4, scan_mode="pallas", max_block=1024, **kw)
    step = jax.jit(lambda s: node.emit(s, 512)) if jit else lambda s: node.emit(s, 512)
    acc = []
    for _ in range(4):
        state, out, v = step(state)
        assert int(v) == 512
        acc.append(np.asarray(out, np.float32))
    return np.concatenate(acc, axis=1)


def test_bf16_block_mode():
    """make_flagship(16, scan_mode="pallas", block_bf16=True) on the CPU:
    within 1e-2 relative of its f32 render and more than 1e-6 from it (the
    JAX package's test_bf16_block_mode), and within 4e-3 relative of the
    JAX package's bf16 render (measured: 2.0e-4)."""
    from rodio_tpu.flagship import make_flagship as jmake

    f32 = _flagship_blocks(make_flagship, device="cpu")
    bf16 = _flagship_blocks(make_flagship, block_bf16=True, device="cpu")
    err = np.abs(bf16 - f32).max() / np.abs(f32).max()
    assert 1e-6 < err < 1e-2, err
    jbf16 = _flagship_blocks(jmake, jit=True, block_bf16=True)
    assert np.abs(bf16 - jbf16).max() / np.abs(jbf16).max() < 4e-3
    with pytest.raises(NotImplementedError):
        make_flagship(2, seconds=0.05, scan_mode="pallas", with_agc=True,
                      block_bf16=True, device="cpu")
