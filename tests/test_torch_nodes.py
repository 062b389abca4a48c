"""The port's nodes against the JAX package's, block by block, on the CPU.

Both packages get the same numpy PCM (from fixed seeds). Blocks of 640 and
of an odd size alternate, so carries cross block boundaries at every phase,
and every render runs past the stream's end through its drain tail.
Bound: 1e-6 (the JAX resampler sums its lerp as a matmul, and XLA:CPU may
contract mul-adds into FMAs; the port rounds each op alone). The buffer
source itself is bit-equal.

Where XLA:CPU's FMA contraction (ROADMAP F4) moves the JAX node itself
past 1e-6 from the scalar oracle ``rodio_tpu/refimpl`` (a resonant
high-pass; the limiter's dB envelopes on loud input), the oracle decides,
as ROADMAP says: the port is held to it at 1e-6 (bit-equal for the
biquad), and to the JAX node at the distance the JAX node keeps from the
oracle.
"""
import jax
import numpy as np
import pytest
import torch

from rodio_tpu.conversions.resample import Resample as JResample
from rodio_tpu.effects.basic import Amplify as JAmplify
from rodio_tpu.effects.blt import BltFilter as JBlt
from rodio_tpu.effects.limit import Limit as JLimit
from rodio_tpu.effects.limit import LimitSettings as JLimitSettings
from rodio_tpu.graph.render import render as j_render
from rodio_tpu.parallel.batch import WideMixer as JWideMixer
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
from rodio_tpu_torch import record, render
from rodio_tpu_torch.conversions.resample import Resample
from rodio_tpu_torch.effects.basic import Amplify
from rodio_tpu_torch.effects.blt import BltFilter
from rodio_tpu_torch.effects.limit import Limit, LimitSettings
from rodio_tpu_torch.parallel.batch import WideMixer
from rodio_tpu_torch.sources.generators import SamplesBuffer

BOUND = 1e-6


def _pcm(channels, frames, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((channels, frames)) * scale).astype(np.float32)


def _compare(jnode, tnode, sizes, atol=BOUND, to_end=True):
    """Emit the given block sizes through both nodes; compare each block."""
    js, ts = jnode.init_state(), tnode.init_state()
    steps = {}
    valids = []
    for i, n in enumerate(sizes):
        if n not in steps:
            steps[n] = jax.jit(lambda s, n=n: jnode.emit(s, n))
        js, oj, vj = steps[n](js)
        ts, ot, vt = tnode.emit(ts, n)
        assert ot.shape == (tnode.spec.channels, n) and ot.dtype == torch.float32
        assert int(vt) == int(vj), f"block {i}"
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=atol, rtol=0,
                                   err_msg=f"block {i} (n={n})")
        valids.append(int(vt))
    assert valids[-1] == 0 or not to_end, "render did not reach the stream's end"
    return js, ts


SIZES = [640, 437] * 6


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("start,pad", [(0, None), (100, 700)])
def test_samples_buffer_matches(interleaved, start, pad):
    data = _pcm(3, 3001, seed=1)
    arg = data.T.reshape(-1) if interleaved else data
    jn = JBuffer(3, 44100, arg, start_frame=start, pad_frames=pad)
    tn = SamplesBuffer(3, 44100, arg, start_frame=start, pad_frames=pad, device="cpu")
    assert tn.total_frames() == jn.total_frames()
    assert tn.PAD_FRAMES == jn.PAD_FRAMES
    _compare(jn, tn, [640, 437] * 4, atol=0.0)


@pytest.mark.parametrize("start", [0, 1500, 2990, 3400, 5000])
def test_samples_buffer_windows_match(start):
    """access_window, slice_frames (clamped into the padding past the end)
    and gather_frames (zero outside the buffer): bit-equal."""
    data = _pcm(2, 3001, seed=3)
    jn = JBuffer(2, 44100, data, start_frame=100, pad_frames=700)
    tn = SamplesBuffer(2, 44100, data, start_frame=100, pad_frames=700, device="cpu")
    js, ts = jn.init_state(), tn.init_state()
    for a, b in zip(tn.access_window(ts), jn.access_window(js)):
        assert int(a) == int(b)
    for length in (1, 437):
        got = tn.slice_frames(ts, torch.tensor(start), length)
        want = jn.slice_frames(js, np.int32(start), length)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = np.arange(start - 5, start + 40)
    np.testing.assert_array_equal(
        tn.gather_frames(ts, torch.from_numpy(idx)).numpy(),
        np.asarray(jn.gather_frames(js, idx)))


@pytest.mark.parametrize("from_rate,to_rate,frames", [
    (44100, 48000, 4410 * 2 + 7), (48000, 44100, 5000), (22050, 48000, 2205),
    (44100, 44100, 3000),
])
def test_resample_matches(from_rate, to_rate, frames):
    data = _pcm(8, frames, seed=frames)
    jn = JResample(JBuffer(8, from_rate, data), to_rate)
    tn = Resample(SamplesBuffer(8, from_rate, data, device="cpu"), to_rate)
    assert tn.total_frames() == jn.total_frames()
    _compare(jn, tn, SIZES + [640] * 8)


@pytest.mark.parametrize("kind,freq,q", [("low_pass", 2000.0, 0.5),
                                         ("low_pass", 5000.0, 0.7)])
def test_blt_filter_exact_matches_with_retune(kind, freq, q):
    data = _pcm(6, 4000, seed=2)  # the flagship's per-stream level
    jn = JBlt(JBuffer(6, 48000, data), kind, freq, q, mode="exact")
    tn = BltFilter(SamplesBuffer(6, 48000, data, device="cpu"), kind, freq, q, mode="exact")
    js, ts = _compare(jn, tn, SIZES[:4], to_end=False)
    # live retune mid-stream: history kept, new response from the next block
    js, ts = jn.retune(js, freq=900.0, q=0.7), tn.retune(ts, freq=900.0, q=0.7)
    np.testing.assert_array_equal(ts["coef"].numpy(), np.asarray(js["coef"]))
    jemit = jax.jit(lambda s: jn.emit(s, 640))
    for _ in range(6):
        js, oj, vj = jemit(js)
        ts, ot, vt = tn.emit(ts, 640)
        assert int(vt) == int(vj)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=BOUND, rtol=0)


@pytest.mark.parametrize("kind,freq,q", [("high_pass", 300.0, 0.9),
                                         ("high_pass", 5000.0, 0.7),
                                         ("low_pass", 2000.0, 0.5)])
def test_blt_filter_bit_equal_to_the_oracle(kind, freq, q):
    """The oracle's biquad rounds each f32 op alone in the reference's
    order, as the port does: bit-equal, even for a resonant high-pass where
    the JAX node on the CPU drifts ~2e-5 away."""
    from rodio_tpu import refimpl as ri

    data = _pcm(3, 3000, seed=7, scale=0.5)
    src = ri.BltFilter(ri.SamplesBuffer(3, 48000, data.T.reshape(-1)), kind, freq, q)
    expected = np.array(src.collect(), np.float32)
    got = render(BltFilter(SamplesBuffer(3, 48000, data, device="cpu"), kind, freq, q),
                 block_frames=437)
    np.testing.assert_array_equal(got.T.reshape(-1), expected)


def test_blt_filter_assoc_not_ported():
    """The associative scan is mode="parallel" (M10): it builds and renders;
    "assoc" and unknown names raise ValueError."""
    src = SamplesBuffer(1, 48000, np.zeros((1, 4), np.float32), device="cpu")
    node = BltFilter(src, "low_pass", 1000.0, mode="parallel")
    assert node.emit(node.init_state(), 4)[1].shape == (1, 4)
    with pytest.raises(ValueError, match="parallel"):
        BltFilter(src, "low_pass", 1000.0, mode="assoc")
    with pytest.raises(ValueError):
        BltFilter(src, "low_pass", 1000.0, mode="bogus")


@pytest.mark.parametrize("S", [4, 8])
def test_amplify_and_wide_mixer_match(S):
    data = _pcm(S * 2, 3000, seed=S)
    gains = np.repeat(np.random.default_rng(S).uniform(0.5, 1.5, S), 2)
    jn = JWideMixer(JAmplify(JBuffer(S * 2, 48000, data), gains), S)
    tn = WideMixer(Amplify(SamplesBuffer(S * 2, 48000, data, device="cpu"), gains), S)
    assert tn.spec.channels == jn.spec.channels == 2
    _compare(jn, tn, SIZES[:8])
    # scalar factor
    jn = JAmplify(JBuffer(2, 48000, data[:2]), 0.25)
    tn = Amplify(SamplesBuffer(2, 48000, data[:2], device="cpu"), 0.25)
    _compare(jn, tn, SIZES[:8], atol=0.0)


@pytest.mark.parametrize("channels,streams,preset", [
    (2, 1, "default"), (2, 1, "mastering"), (8, 4, "gaming"), (3, 1, "broadcast"),
])
def test_limit_sequential_matches(channels, streams, preset):
    # the JAX package's own limiter parity input (test_block_parity.py)
    rng = np.random.default_rng(channels + streams)
    data = (rng.uniform(-1, 1, (channels, 3000)) * 2.0).astype(np.float32)
    jn = JLimit(JBuffer(channels, 48000, data),
                getattr(JLimitSettings, preset)(), mode="exact", streams=streams)
    tn = Limit(SamplesBuffer(channels, 48000, data, device="cpu"),
               getattr(LimitSettings, preset)(), mode="exact", streams=streams)
    # 2e-6: the JAX node's own distance from the oracle on this input
    js, ts = _compare(jn, tn, SIZES[:6] + [640] * 2, atol=2e-6, to_end=False)
    np.testing.assert_allclose(ts["integ"].numpy(), np.asarray(js["integ"]), rtol=2e-6)
    np.testing.assert_allclose(ts["peak"].numpy(), np.asarray(js["peak"]), rtol=2e-6)
    # the oracle, group by group (each stream is its own limiter)
    from rodio_tpu import refimpl as ri

    got = render(Limit(SamplesBuffer(channels, 48000, data, device="cpu"),
                       getattr(LimitSettings, preset)(), mode="exact",
                       streams=streams), block_frames=640)
    cg = channels // streams
    for g in range(streams):
        grp = data[g * cg:(g + 1) * cg]
        src = ri.Limit(ri.SamplesBuffer(cg, 48000, grp.T.reshape(-1)),
                       getattr(ri.LimitSettings, preset)())
        expected = np.array(src.collect(), np.float32)
        np.testing.assert_allclose(got[g * cg:(g + 1) * cg].T.reshape(-1),
                                   expected, atol=BOUND, rtol=0)


@pytest.mark.parametrize("S", [4, 6])
def test_unfused_chain_matches_through_drain(S):
    """Resample -> BltFilter -> Amplify -> WideMixer -> Limit, the flagship's
    unfused chain, past the stream's end (the drain frame included)."""
    data = _pcm(S * 2, 4410 * 2 + 3, seed=10 + S)
    gains = np.repeat(np.random.default_rng(S).uniform(0.5, 1.5, S) / S, 2)

    def chain(buf, res, blt, amp, mix, lim, settings, **dev):
        n = res(buf(S * 2, 44100, data, **dev), 48000)
        n = blt(n, "low_pass", 2000.0, 0.5, mode="exact")
        return lim(mix(amp(n, gains), S), settings(), mode="exact")

    jn = chain(JBuffer, JResample, JBlt, JAmplify, JWideMixer, JLimit, JLimitSettings)
    tn = chain(SamplesBuffer, Resample, BltFilter, Amplify, WideMixer, Limit,
               LimitSettings, device="cpu")
    assert tn.total_frames() == jn.total_frames()
    _compare(jn, tn, SIZES + [640] * 6)


def test_limit_sequential_closer_to_the_oracle():
    """Against the scalar oracle (rodio_tpu/refimpl), which decides when the
    packages disagree: the port's sequential limiter stays within 1e-6 on
    loud Gaussian input, where XLA:CPU's FMA contraction (ROADMAP F4) puts
    the JAX node further away."""
    from rodio_tpu import refimpl as ri

    for C in (1, 2, 3):
        data = _pcm(C, 3500, seed=C, scale=0.9)
        src = ri.Limit(ri.SamplesBuffer(C, 48000, data.T.reshape(-1)),
                       ri.LimitSettings())
        expected = np.array(src.collect(), np.float32)
        got = render(Limit(SamplesBuffer(C, 48000, data, device="cpu"), LimitSettings(),
                           mode="exact"), block_frames=640)
        np.testing.assert_allclose(got.T.reshape(-1), expected, atol=BOUND, rtol=0)


def test_render_and_record_match():
    data = _pcm(2, 5000, seed=4)
    jn = JResample(JBuffer(2, 44100, data), 48000)
    tn = Resample(SamplesBuffer(2, 44100, data, device="cpu"), 48000)
    a = render(tn, block_frames=1000)
    b = j_render(jn, block_frames=1000)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=BOUND, rtol=0)
    rec = record(tn)
    assert rec.total_frames() == a.shape[1]
    np.testing.assert_array_equal(render(rec, block_frames=777), a)
    assert render(tn, max_frames=1234, block_frames=500).shape == (2, 1234)
