"""The port's effects, Mix and combinators against the JAX package's and the
scalar oracle (the cases of tests/test_block_parity.py on the port, and
BASELINE config 4).

Each case gives the same numpy-seeded PCM to the port's node on the CPU, to
``rodio_tpu.refimpl`` where it has the node, and to the JAX node. Bounds:
the oracle's tolerance of test_block_parity or tighter (the port rounds
each op alone, as the oracle does; the JAX package on XLA:CPU may contract
mul-adds into FMAs, ROADMAP F4), and against JAX 1e-6 (the f32 parity
contract), or the distance the JAX node keeps from the oracle where F4 puts
it further away (a resonant biquad, the limiter's dB path, the AGC).
"""
import jax
import numpy as np
import pytest
import torch

import rodio_tpu.refimpl as ri
from rodio_tpu import effects as J
from rodio_tpu.graph import render as j_render
from rodio_tpu.sources import SamplesBuffer as JBuffer
from rodio_tpu.sources import SineWave as JSine
from rodio_tpu_torch import render
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.core.node import Node
from rodio_tpu_torch.effects import (
    AgcSettings, Amplify, AutomaticGainControl, BltFilter, ChannelVolume, Delay,
    Distortion, Limit, LimitSettings, LinearGainRamp, Mix, Pausable, Repeat,
    SkipDuration, Skippable, Spatial, Speed, Stoppable, TakeDuration, TrackPosition)
from rodio_tpu_torch.effects.basic import spatial_volumes
from rodio_tpu_torch.sources import SamplesBuffer, SineWave

PARITY = 1e-6
#: the fade-out divides by its whole-ms total; XLA:CPU may multiply by the
#: reciprocal instead, an ulp at unit scale (the port divides, as the
#: oracle does: bit-equal to it)
FADE_JAX = 1.2e-7


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


def rand_buffer(rng, channels, frames, rate=48000):
    """(oracle buffer, port buffer, JAX buffer, interleaved data)."""
    data = rng.uniform(-1, 1, size=frames * channels).astype(np.float32)
    return (ri.SamplesBuffer(channels, rate, data),
            SamplesBuffer(channels, rate, data, device="cpu"),
            JBuffer(channels, rate, data), data)


def check(node, jnode, expected, block, atol, jax_atol=PARITY):
    """Render the port node; hold it to the oracle's samples and to the JAX
    node's render."""
    got = interleave(render(node, block_frames=block))
    if expected is not None:
        assert len(got) == len(expected)
        np.testing.assert_allclose(got, expected, atol=atol, rtol=0)
    want = interleave(j_render(jnode, block_frames=block))
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=jax_atol, rtol=0)
    return got


# ---------------- stateless effects ----------------

def test_amplify_parity(rng):
    r, t, j, _ = rand_buffer(rng, 2, 500)
    check(Amplify(t, 0.7), J.Amplify(j, 0.7), ref_collect(ri.Amplify(r, 0.7)), 128, 1e-7)


def test_distortion_parity(rng):
    r, t, j, _ = rand_buffer(rng, 2, 500)
    check(Distortion(t, 3.0, 0.8), J.Distortion(j, 3.0, 0.8),
          ref_collect(ri.Distortion(r, 3.0, 0.8)), 128, 1e-7)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("clamp_end", [True, False])
def test_ramp_parity(rng, channels, clamp_end):
    r, t, j, _ = rand_buffer(rng, channels, 2000)
    expected = ref_collect(ri.LinearGainRamp(r, 25_000_000, 0.2, 0.9, clamp_end))
    check(LinearGainRamp(t, 0.025, 0.2, 0.9, clamp_end),
          J.LinearGainRamp(j, 0.025, 0.2, 0.9, clamp_end), expected, 256, 1e-6)


@pytest.mark.parametrize("channels", [1, 2])
def test_take_parity(rng, channels):
    r, t, j, _ = rand_buffer(rng, channels, 2000)
    dur_ns = 17_345_678
    check(TakeDuration(t, dur_ns / 1e9), J.TakeDuration(j, dur_ns / 1e9),
          ref_collect(ri.TakeDuration(r, dur_ns)), 256, 1e-7, 0.0)


@pytest.mark.parametrize("channels", [1, 2])
def test_take_fadeout_ms_truncation_parity(rng, channels):
    """The fade-out gain's whole-ms staircase (src/source/take.rs:36-38) in
    an odd block size, so blocks straddle ms boundaries."""
    r, t, j, _ = rand_buffer(rng, channels, 12000, rate=44100)
    dur_ns = 234_567_000
    ref = ri.TakeDuration(r, dur_ns)
    ref.set_filter_fadeout()
    check(TakeDuration(t, dur_ns / 1e9, fadeout=True),
          J.TakeDuration(j, dur_ns / 1e9, fadeout=True), ref_collect(ref), 193, 0.0, FADE_JAX)


def test_take_fadeout_long_position(rng):
    """Past 2.1 s of nanoseconds (beyond i32): the (ms, ns-within-ms) pair."""
    r, t, j, _ = rand_buffer(rng, 2, 25000, rate=8000)
    dur_ns = 3_000_000_000
    ref = ri.TakeDuration(r, dur_ns)
    ref.set_filter_fadeout()
    check(TakeDuration(t, dur_ns / 1e9, fadeout=True),
          J.TakeDuration(j, dur_ns / 1e9, fadeout=True), ref_collect(ref, 200_000),
          1024, 0.0, FADE_JAX)


def test_take_mid_frame_padding():
    dps = 1_000_000_000 // (44100 * 2)
    expected = ref_collect(ri.TakeDuration(ri.SamplesBuffer(2, 44100, [1.0] * 20), dps * 5))
    got = check(TakeDuration(SamplesBuffer(2, 44100, [1.0] * 20, device="cpu"), dps * 5 / 1e9),
                J.TakeDuration(JBuffer(2, 44100, [1.0] * 20), dps * 5 / 1e9),
                expected, 16, 0.0, 0.0)
    assert len(got) == 6


def test_delay_parity(rng):
    r, t, j, _ = rand_buffer(rng, 2, 1000)
    check(Delay(t, 0.003), J.Delay(j, 0.003), ref_collect(ri.Delay(r, 3_000_000)),
          128, 1e-7, 0.0)


def test_skip_parity(rng):
    r, t, j, _ = rand_buffer(rng, 2, 2000)
    check(SkipDuration(t, 0.010), J.SkipDuration(j, 0.010),
          ref_collect(ri.skip_duration(r, 10_000_000)), 256, 1e-7, 0.0)


def test_skip_by_emits_and_by_phase_seek(rng):
    """SkipDuration's other two routes: a generator's O(1) phase seek, and
    an input without a seek, fast-forwarded by its own emits."""
    node = SkipDuration(SineWave(440.0, device="cpu"), 0.0123)
    jnode = J.SkipDuration(JSine(440.0), 0.0123)
    a = render(node, max_frames=1000, block_frames=500)
    b = j_render(jnode, max_frames=1000, block_frames=500)
    np.testing.assert_allclose(a, b, atol=2.4e-7, rtol=0)  # an ulp of sin
    _, t, j, _ = rand_buffer(rng, 2, 20000)
    check(SkipDuration(Amplify(t, 0.5), 0.25), J.SkipDuration(J.Amplify(j, 0.5), 0.25),
          None, 1000, 0.0, 0.0)


def test_channel_volume_parity(rng):
    r, t, j, _ = rand_buffer(rng, 2, 600)
    vols = [0.5, 2.0, 0.25]
    check(ChannelVolume(t, vols), J.ChannelVolume(j, vols),
          ref_collect(ri.ChannelVolume(r, vols)), 128, 1e-7)


def test_mix_parity(rng):
    ra, ta, ja, _ = rand_buffer(rng, 2, 700)
    rb, tb, jb, _ = rand_buffer(rng, 2, 400)
    check(Mix(ta, tb), J.Mix(ja, jb), ref_collect(ri.Mix(ra, rb)), 128, 1e-7)


def test_mix_different_formats(rng):
    """input2 is uniformized to input1's format (src/source/mix.rs:20-22)."""
    ra, ta, ja, _ = rand_buffer(rng, 2, 500, rate=48000)
    data_b = rng.uniform(-1, 1, size=300).astype(np.float32)
    expected = ref_collect(ri.Mix(ra, ri.SamplesBuffer(1, 44100, data_b)))
    check(Mix(ta, SamplesBuffer(1, 44100, data_b, device="cpu"), rodio_compat=True),
          J.Mix(ja, JBuffer(1, 44100, data_b), rodio_compat=True), expected, 128, 2e-7, 2e-7)


# ---------------- stateful effects ----------------

@pytest.mark.parametrize("kind", ["low_pass", "high_pass"])
@pytest.mark.parametrize("channels", [1, 2])
def test_blt_parity(rng, kind, channels):
    """The port's biquad rounds each op alone, as the oracle does: 3e-6 as
    test_block_parity holds JAX, and JAX within the distance it keeps from
    the oracle."""
    r, t, j, _ = rand_buffer(rng, channels, 3000, rate=44100)
    check(BltFilter(t, kind, 1200.0, 0.5, mode="exact"),
          J.BltFilter(j, kind, 1200.0, 0.5, mode="exact"),
          ref_collect(ri.BltFilter(r, kind, 1200.0, 0.5)), 512, 3e-6, 6e-6)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_limit_parity(rng, channels):
    data = rng.uniform(-1, 1, size=3000 * channels).astype(np.float32) * 2.0
    expected = ref_collect(ri.Limit(ri.SamplesBuffer(channels, 44100, data),
                                    ri.LimitSettings()))
    check(Limit(SamplesBuffer(channels, 44100, data, device="cpu"), LimitSettings(),
                mode="exact"),
          J.Limit(JBuffer(channels, 44100, data), J.LimitSettings(), mode="exact"),
          expected, 512, 1e-6, 2e-6)


def test_limit_settles_to_threshold():
    """A -6 dB limited loud sine settles near 0.5 peak (tests/limit.rs)."""
    node = Limit(Amplify(SineWave(440.0, device="cpu"), 2.0),
                 LimitSettings(threshold=-6.0, knee_width=0.5))
    settled = np.abs(render(node, max_frames=48000, block_frames=4096)[0, 24000:])
    assert 0.45 < settled.max() < 0.56


@pytest.mark.parametrize("channels", [1, 2])
def test_agc_parity(rng, channels):
    data = rng.uniform(-1, 1, size=3000 * channels).astype(np.float32) * 0.3
    expected = ref_collect(ri.AutomaticGainControl(ri.SamplesBuffer(channels, 44100, data),
                                                   ri.AgcSettings()))
    check(AutomaticGainControl(SamplesBuffer(channels, 44100, data, device="cpu"),
                               AgcSettings(), mode="exact"),
          J.AutomaticGainControl(JBuffer(channels, 44100, data), J.AgcSettings(),
                                 mode="exact"),
          expected, 512, 1e-5, 2e-5)


def test_agc_parity_long_window(rng):
    """Across the 8192-sample RMS ring's boundary."""
    data = rng.uniform(-1, 1, size=12000).astype(np.float32) * 0.4
    expected = ref_collect(ri.AutomaticGainControl(ri.SamplesBuffer(1, 44100, data),
                                                   ri.AgcSettings()))
    check(AutomaticGainControl(SamplesBuffer(1, 44100, data, device="cpu"), AgcSettings(),
                               mode="exact"),
          J.AutomaticGainControl(JBuffer(1, 44100, data), J.AgcSettings(), mode="exact"),
          expected, 999, 2e-5, 2e-5)


# ---------------- combinator chains ----------------

def test_pipeline_chain_parity(rng):
    """high_pass -> amplify -> fade_in -> delay, end to end."""
    data = rng.uniform(-1, 1, size=10000).astype(np.float32)
    ref = ri.SamplesBuffer(2, 44100, data)
    ref = ri.Delay(ri.fade_in(ri.Amplify(ri.BltFilter(ref, "high_pass", 300.0, 0.5), 1.2),
                              20_000_000), 10_000_000)

    def chain(buf, blt, amp, **dev):
        node = amp(blt(buf(2, 44100, data, **dev), "high_pass", 300.0, 0.5), 1.2)
        return node.fade_in(0.020).delay(0.010)

    check(chain(SamplesBuffer, BltFilter, Amplify, device="cpu"),
          chain(JBuffer, J.BltFilter, J.Amplify), ref_collect(ref), 512, 2e-5, 2e-5)


def test_reverb_runs(rng):
    _, t, j, _ = rand_buffer(rng, 2, 2000)
    got = check(t.reverb(0.01, 0.5), j.reverb(0.01, 0.5), None, 256, 0.0)
    assert len(got) > 2 * 2000  # the echo extends the stream


def test_repeat(rng):
    _, t, _, data = rand_buffer(rng, 2, 100)
    out = render(t.repeat_infinite(), max_frames=350, block_frames=64)
    np.testing.assert_array_equal(out, np.tile(data.reshape(100, 2).T, (1, 4))[:, :350])


def test_blt_pallas_mode(rng):
    """K4's route (the plain version on the CPU) equals the exact scan."""
    _, t, _, data = rand_buffer(rng, 2, 2000, rate=44100)
    exact = render(BltFilter(t, "low_pass", 1200.0, 0.5, mode="exact"), block_frames=512)
    pal = render(BltFilter(SamplesBuffer(2, 44100, data, device="cpu"), "low_pass", 1200.0,
                           0.5, mode="pallas"), block_frames=512)
    np.testing.assert_array_equal(pal, exact)


def test_agc_wide_stream_groups(rng):
    S, C, frames = 3, 2, 4000
    datas = [rng.uniform(-0.5, 0.5, (C, frames)).astype(np.float32) for _ in range(S)]
    per = [render(AutomaticGainControl(SamplesBuffer(C, 44100, d, device="cpu"),
                                       AgcSettings(), mode="exact"), block_frames=512)
           for d in datas]
    got = render(AutomaticGainControl(SamplesBuffer(S * C, 44100, np.concatenate(datas),
                                                    device="cpu"),
                                      AgcSettings(), mode="exact", streams=S),
                 block_frames=512)
    for s in range(S):
        np.testing.assert_allclose(got[s * C:(s + 1) * C], per[s], atol=1e-6)


def test_limit_wide_stream_groups(rng):
    S, C, frames = 3, 2, 3000
    datas = [(rng.uniform(-1, 1, (C, frames)) * (0.5 + s)).astype(np.float32)
             for s in range(S)]
    per = [render(Limit(SamplesBuffer(C, 44100, d, device="cpu"), LimitSettings(),
                        mode="exact"), block_frames=512) for d in datas]
    got = render(Limit(SamplesBuffer(S * C, 44100, np.concatenate(datas), device="cpu"),
                       LimitSettings(), mode="exact", streams=S), block_frames=512)
    for s in range(S):
        np.testing.assert_allclose(got[s * C:(s + 1) * C], per[s], atol=1e-6)


@pytest.mark.parametrize("block,tol", [(512, 4e-6), (251, 0.0)])
def test_limit_pallas_mode(rng, block, tol):
    """K3's blocked order (power-of-two blocks) within reassociation ulps of
    the exact scan; blocks without a power-of-two factor run the
    sequential envelopes, bit-equal (test_block_parity's _blocked and
    _sequential cases)."""
    data = (rng.uniform(-1, 1, (2, 3000)) * 2.0).astype(np.float32)
    exact = render(Limit(SamplesBuffer(2, 44100, data, device="cpu"), LimitSettings(),
                         mode="exact"), block_frames=block)
    pal = render(Limit(SamplesBuffer(2, 44100, data, device="cpu"), LimitSettings(),
                       mode="pallas"), block_frames=block)
    np.testing.assert_allclose(pal, exact, atol=tol, rtol=0)


def test_agc_pallas_mode(rng):
    data = rng.uniform(-0.4, 0.4, (2, 6000)).astype(np.float32)
    exact = render(AutomaticGainControl(SamplesBuffer(2, 44100, data, device="cpu"),
                                        AgcSettings(), mode="exact"), block_frames=1024)
    pal = render(AutomaticGainControl(SamplesBuffer(2, 44100, data, device="cpu"),
                                      AgcSettings(), mode="pallas"), block_frames=1024)
    np.testing.assert_allclose(pal, exact, atol=1e-4)


def test_agc_group_mode(rng):
    """The group-rate AGC deviates from the per-sample smoother one-sidedly
    (never more gain), within test_block_parity's bounds; bad settings raise."""

    def pair(data, settings):
        exact = render(AutomaticGainControl(SamplesBuffer(2, 44100, data, device="cpu"),
                                            settings, mode="exact"), block_frames=1024)
        grp = render(AutomaticGainControl(SamplesBuffer(2, 44100, data, device="cpu"),
                                          settings, mode="pallas", group=8),
                     block_frames=1024)
        rel = np.abs(grp - exact) / (np.abs(exact) + 1e-6)
        mask = rel > 1e-3
        onesided = (not mask.any()) or np.all(np.abs(grp[mask]) <= np.abs(exact[mask]) + 1e-6)
        return rel.max(), onesided

    data = rng.uniform(-0.4, 0.4, (2, 8192)).astype(np.float32)
    mx, ones = pair(data * 0.25, AgcSettings())
    assert mx < 2e-3 and ones
    mx, ones = pair(data, AgcSettings(release_time=0.1))
    assert mx < 2e-3 and ones
    mx, ones = pair(data, AgcSettings())
    assert mx < 0.2 and ones
    src = SamplesBuffer(2, 44100, data, device="cpu")
    with pytest.raises(ValueError, match="mode='pallas'"):
        AutomaticGainControl(src, AgcSettings(), mode="exact", group=8)
    with pytest.raises(ValueError, match=">= 2"):
        AutomaticGainControl(src, AgcSettings(), mode="pallas", group=1)
    bad = AutomaticGainControl(src, AgcSettings(), mode="pallas", group=24)
    with pytest.raises(ValueError, match="divide"):
        bad.emit(bad.init_state(), 1024)


@pytest.mark.parametrize("blocks", [(256, 1024), (251, 997)])
def test_block_size_invariance(rng, blocks):
    data = rng.uniform(-1, 1, (2, 9000)).astype(np.float32)

    def chain():
        node = SamplesBuffer(2, 44100, data, device="cpu").resample(48000)
        node = AutomaticGainControl(BltFilter(node, "low_pass", 1500.0, 0.5), AgcSettings())
        return Limit(node.amplify(1.5), LimitSettings())

    out1 = render(chain(), block_frames=blocks[0])
    out2 = render(chain(), block_frames=blocks[1])
    assert out1.shape == out2.shape
    np.testing.assert_array_equal(out1, out2)


# ---------------- Spatial, config 4 ----------------

POSITIONS = [((-0.7, 0.2, 0.0), (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
             ((3.0, -1.0, 0.5), (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
             ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),     # coincident ears
             ((-1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0)),   # at an ear
             ((float("nan"), 0.0, 0.0), (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0))]


@pytest.mark.parametrize("pos", POSITIONS)
def test_spatial_volumes_equal_the_oracle(pos):
    from rodio_tpu.refimpl.effects import spatial_volumes as ri_volumes

    got, want = spatial_volumes(*pos), ri_volumes(*pos)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and (a == b or (np.isnan(a) and np.isnan(b)))


def test_config4_parity_case():
    """BASELINE config 4's parity case (tools/parity_tpu.py:174-191):
    Spatial(TakeDuration(SineWave(440, rodio_compat=True), 0.3), ...) within
    1e-6 of the oracle (and of JAX)."""
    pos = POSITIONS[0]
    expected = ref_collect(ri.Spatial(ri.TakeDuration(ri.SineWave(440.0), int(0.3e9)), *pos))
    node = Spatial(TakeDuration(SineWave(440.0, rodio_compat=True, device="cpu"), 0.3), *pos)
    jnode = J.Spatial(J.TakeDuration(JSine(440.0, rodio_compat=True), 0.3), *pos)
    check(node, jnode, expected, 1024, 1e-6)


def config4_scene(sine, device_kw):
    """The scene of tests/test_baseline_configs.py:130-158 without the
    control plane."""
    src = sine(330.0, rodio_compat=True, **device_kw)
    return (src.take_duration(1.0).fade_in(0.1).reverb(0.03, 0.4)
            .spatial((-2.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0)))


def test_config4_scene_matches_jax():
    node = config4_scene(SineWave, {"device": "cpu"})
    got = check(node, config4_scene(JSine, {}), None, 1024, 0.0)
    assert len(got) == 2 * (48000 + 1440)  # a second plus the 30 ms echo
    st = node.init_state()
    st = Spatial.positions_state(st, (2.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0))
    _, out, _ = node.emit(st, 4096)
    assert out[1].abs().mean() > out[0].abs().mean()  # moved to the right


# ---------------- flags, position, speed ----------------

@pytest.mark.parametrize("cls,flag,valid_when_set", [(Pausable, "paused", True),
                                                      (Stoppable, "stopped", False),
                                                      (Skippable, "skipped", False)])
def test_flags_match_jax(rng, cls, flag, valid_when_set):
    _, t, j, _ = rand_buffer(rng, 2, 3000)
    tn, jn = cls(t), getattr(J, cls.__name__)(j)
    ts, js = tn.init_state(), jn.init_state()
    for i, on in enumerate([False, True, True, False, False]):
        ts = {**ts, flag: torch.tensor(on)}
        js = {**js, flag: jax.numpy.asarray(on)}
        ts, ot, vt = tn.emit(ts, 700)
        js, oj, vj = jax.jit(lambda s: jn.emit(s, 700))(js)
        assert int(vt) == int(vj), i
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        if on:
            assert int(vt) == (700 if valid_when_set else 0) and not ot.any()


def test_track_position_and_speed(rng):
    _, t, j, _ = rand_buffer(rng, 2, 1000)
    node = TrackPosition(t)
    st = node.init_state()
    for _ in range(3):
        st, _, _ = node.emit(st, 400)
    assert node.get_pos(st) == 1000 / 48000
    fast, jfast = Speed(t, 1.5), J.Speed(j, 1.5)
    assert fast.spec == type(fast.spec)(2, jfast.spec.sample_rate)
    check(fast.uniform(2, 48000), jfast.uniform(2, 48000), None, 256, 0.0, 2e-7)


def test_take_crossfade_with(rng):
    _, ta, ja, _ = rand_buffer(rng, 2, 3000)
    _, tb, jb, _ = rand_buffer(rng, 2, 3000)
    check(ta.take_crossfade_with(tb, 0.02), ja.take_crossfade_with(jb, 0.02), None, 256, 0.0)


def test_every_combinator_of_the_jax_node_is_ported():
    """The JAX Node's combinators (rodio_tpu/core/node.py:68-236) all exist
    on the port's Node, but those whose nodes wait for M5c and M7."""
    from rodio_tpu.core.node import Node as JNode

    waiting = {"dither", "buffered", "record", "to_file"}
    names = {k for k, v in vars(JNode).items() if callable(v) and not k.startswith("_")}
    missing = {k for k in names - waiting if not hasattr(Node, k)}
    assert not missing, missing
    _, t, j, _ = rand_buffer(np.random.default_rng(5), 2, 2000)
    for name, args in [("amplify_decibel", (-6.0,)), ("amplify_normalized", (0.05,)),
                       ("distortion", (2.0, 0.5)), ("fade_out", (0.01,)),
                       ("low_pass_with_q", (900.0, 0.7)), ("channel_volume", ([0.3],))]:
        check(getattr(t, name)(*args), getattr(j, name)(*args), None, 512, 0.0, 3e-6)


def test_state_from_jax_carries_a_render_across(rng):
    """A render started in the JAX package continues in the port: the ring
    resampler, the generators, the fade and delay counters, the flags."""
    data = rng.uniform(-0.5, 0.5, (2, 6000)).astype(np.float32)

    def graph(buf, sine, mod, **dev):
        # an Amplify upstream is not random-access: the ring path
        a = mod.Resample(mod.Amplify(buf(2, 44100, data, **dev), 0.8), 48000, max_block=512)
        b = sine(300.0, rodio_compat=True, **dev).take_duration(0.2, fadeout=True)
        b = b.rechannel(2).delay(0.004).pausable().stoppable().track_position()
        return mod.Mix(a, b).distortion(1.5, 0.9).fade_in(0.01)

    import rodio_tpu.conversions as JC
    import rodio_tpu_torch.conversions as TC

    class JMod:
        Resample, Mix, Amplify = JC.Resample, J.Mix, J.Amplify

    class TMod:
        Resample, Mix, Amplify = TC.Resample, Mix, Amplify

    jn = graph(JBuffer, JSine, JMod)
    tn = graph(SamplesBuffer, SineWave, TMod, device="cpu")
    js = jn.init_state()
    step = jax.jit(lambda s: jn.emit(s, 512))
    for _ in range(5):
        js, _, _ = step(js)
    ts = state_from_jax(tn, jax.device_get(js))
    for _ in range(8):
        js, oj, vj = step(js)
        ts, ot, vt = tn.emit(ts, 512)
        assert int(vt) == int(vj)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2.4e-7, rtol=0)
