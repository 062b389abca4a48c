"""The port's control plane (mixer, queue, Player, SpatialPlayer, Buffered,
from_iter) against the JAX package's and the scalar oracle, on the CPU.

The cases of ``tests/test_control_device.py`` (lines 16-150, 255-327,
355; not those that need ``io``) and of ``tests/test_live_controls.py``
(lines 190-284) are ported with their own bounds. Beside them:

- BASELINE config 3 as ``tools/parity_tpu.py:121-171`` builds it, on a
  synthesized 16-bit-grid stereo source in place of ``music.wav``, against
  ``rodio_tpu.refimpl``'s mixer at 1e-6. The last frame is skipped as
  ``parity_tpu.py:160-169`` skips it: the reference's TakeDuration reports
  an odd span, so its take cuts mid-frame and the converter mixes drain
  samples across channels in that one frame, where the block engine stays
  frame-aligned.
- the 64-source shape of ``tests/test_baseline_configs.py:105-127`` against
  the JAX package's ``Mixer``, at 1e-6 (the same f32 ops; ``sin`` may
  differ by an ulp).
"""
import jax
import numpy as np
import pytest
import torch

import rodio_tpu.refimpl as ri
from rodio_tpu_torch import render
from rodio_tpu_torch.control import Player, mixer, queue
from rodio_tpu_torch.control.spatial_player import SpatialPlayer
from rodio_tpu_torch.sources import (
    Buffered, EmptyCallback, SamplesBuffer, SineWave, SquareWave, TriangleWave, Zero,
    from_factory, from_iter)

CPU = dict(device="cpu")


def _np(block):
    return block.numpy()


def interleave(b):
    return np.asarray(b).T.reshape(-1)


# -- tests/test_control_device.py -----------------------------------------

def test_mixer_sums_and_prunes(rng):
    tx, rx = mixer(1, 48000, **CPU)
    a = rng.uniform(-1, 1, 1000).astype(np.float32)
    b = rng.uniform(-1, 1, 500).astype(np.float32)
    tx.add(SamplesBuffer(1, 48000, a, **CPU))
    tx.add(SamplesBuffer(1, 48000, b, **CPU))
    block, alive = rx.next_block(256)
    assert alive
    np.testing.assert_allclose(_np(block)[0], a[:256] + b[:256], atol=1e-7)
    rx.next_block(256)
    block, alive = rx.next_block(256)
    np.testing.assert_allclose(
        _np(block)[0], a[512:768] + np.concatenate([b[500:], np.zeros(268, np.float32)])[:256],
        atol=1e-6)
    block, alive = rx.next_block(256)
    assert alive
    block, alive = rx.next_block(256)
    assert not alive  # no source yielded (src/mixer.rs:131)


def test_mixer_admits_pending_at_block_boundary():
    tx, rx = mixer(1, 48000, **CPU)
    a = np.ones(1000, np.float32)
    tx.add(SamplesBuffer(1, 48000, a, **CPU))
    block, _ = rx.next_block(256)
    np.testing.assert_array_equal(_np(block)[0], np.ones(256, np.float32))
    tx.add(SamplesBuffer(1, 48000, a * 2, **CPU))
    block, _ = rx.next_block(256)
    np.testing.assert_array_equal(_np(block)[0], np.full(256, 3.0, np.float32))


def test_mixer_uniformizes_formats():
    tx, rx = mixer(2, 48000, **CPU)
    tx.add(SamplesBuffer(1, 44100, np.ones(441, np.float32), **CPU))
    block, alive = rx.next_block(128)
    assert alive
    np.testing.assert_allclose(_np(block)[0], _np(block)[1])  # mono upmixed
    assert np.abs(_np(block)).max() > 0.9


def test_queue_sequential_and_stitching(rng):
    q_tx, q_rx = queue(False, block_frames=256, **CPU)
    a = rng.uniform(-1, 1, 300).astype(np.float32)
    b = rng.uniform(-1, 1, 300).astype(np.float32)
    q_tx.append(SamplesBuffer(1, 48000, a, **CPU))
    q_tx.append(SamplesBuffer(1, 48000, b, **CPU))
    block, alive = q_rx.next_block(256)
    np.testing.assert_array_equal(_np(block)[0], a[:256])
    block, alive = q_rx.next_block(256)  # 44 frames of a, then 212 of b
    np.testing.assert_array_equal(_np(block)[0][:44], a[256:])
    np.testing.assert_array_equal(_np(block)[0][44:], b[:212])


def test_queue_keep_alive_emits_silence():
    q_tx, q_rx = queue(True, block_frames=128, **CPU)
    block, alive = q_rx.next_block(128)
    assert alive
    np.testing.assert_array_equal(_np(block), np.zeros((1, 128), np.float32))
    q_tx.append(SamplesBuffer(1, 48000, np.ones(64, np.float32), **CPU))
    block, alive = q_rx.next_block(128)
    np.testing.assert_array_equal(_np(block)[0][:64], np.ones(64, np.float32))


def test_queue_done_signal():
    q_tx, q_rx = queue(False, block_frames=128, **CPU)
    sig = q_tx.append_with_signal(SamplesBuffer(1, 48000, np.ones(100, np.float32), **CPU))
    assert not sig[0]
    q_rx.next_block(128)
    q_rx.next_block(128)  # drains and moves past the source
    assert sig[0] and sig.done


def test_player_volume_pause_stop():
    tx, rx = mixer(2, 48000, **CPU)
    player = Player.connect_new(tx, block_frames=128)
    player.append(Zero(2, 48000, num_frames=100000, **CPU))
    player.append(SineWave(440.0, **CPU).take_duration(1.0))
    block, alive = rx.next_block(128)
    assert alive
    player.set_volume(0.5)
    assert player.volume() == 0.5
    player.pause()
    assert player.is_paused()
    block, _ = rx.next_block(128)
    np.testing.assert_array_equal(_np(block), np.zeros((2, 128), np.float32))
    player.play()
    assert not player.is_paused()
    assert player.len() >= 1


def test_player_skip_one_advances():
    tx, rx = mixer(1, 48000, **CPU)
    player = Player.connect_new(tx, block_frames=128)
    player.append(SamplesBuffer(1, 48000, np.full(10000, 0.25, np.float32), **CPU))
    player.append(SamplesBuffer(1, 48000, np.full(10000, 0.5, np.float32), **CPU))
    block, _ = rx.next_block(128)
    np.testing.assert_allclose(_np(block)[0], 0.25, atol=1e-6)
    player.skip_one()
    rx.next_block(128)  # the transition block
    block, _ = rx.next_block(128)
    np.testing.assert_allclose(_np(block)[0], 0.5, atol=1e-6)


def test_player_position_tracks():
    tx, rx = mixer(1, 48000, **CPU)
    player = Player.connect_new(tx, block_frames=128)
    player.append(SamplesBuffer(1, 48000, np.ones(48000, np.float32), **CPU))
    for _ in range(10):
        rx.next_block(128)
    assert player.get_pos() == pytest.approx(10 * 128 / 48000, abs=1e-6)


def test_spatial_player_pans():
    tx, rx = mixer(2, 48000, **CPU)
    player = SpatialPlayer.connect_new(
        tx, emitter_position=(-1.0, 0.0, 0.0), left_ear=(-1.0, 0.0, 0.0),
        right_ear=(1.0, 0.0, 0.0), block_frames=128)
    player.append(SamplesBuffer(1, 48000, np.ones(48000, np.float32) * 0.5, **CPU))
    block, _ = rx.next_block(128)
    assert np.abs(_np(block)[0]).mean() > np.abs(_np(block)[1]).mean()
    player.set_emitter_position((1.0, 0.0, 0.0))  # applied from the next block
    rx.next_block(128)
    block, _ = rx.next_block(128)
    assert np.abs(_np(block)[1]).mean() > np.abs(_np(block)[0]).mean()


def test_player_live_speed_change():
    """set_speed rebuilds the sound with a VariSpeed stage at the same
    position; the source then advances 2 frames an output frame."""
    rate = 48000
    ramp = np.arange(rate * 4, dtype=np.float32) / (rate * 4)
    tx, rx = mixer(1, rate, **CPU)
    player = Player.connect_new(tx, block_frames=480)
    player.append(SamplesBuffer(1, rate, ramp, **CPU))
    for _ in range(10):
        rx.next_block(480)
    player.set_speed(2.0)
    block, _ = rx.next_block(480)
    slope = np.diff(_np(block)[0][10:470]).mean()
    assert slope == pytest.approx(2.0 / (rate * 4), rel=0.05)
    assert abs(_np(block)[0][0] - ramp[4800]) < 0.01


def test_player_on_done_and_periodic_access():
    tx, rx = mixer(1, 48000, **CPU)
    player = Player.connect_new(tx, block_frames=480)
    fired, ticks = [], []
    player.periodic_access(0.02, lambda: ticks.append(1))  # every 960 frames
    player.append(SamplesBuffer(1, 48000, np.ones(1000, np.float32), **CPU),
                  on_done=lambda: fired.append(1))
    for _ in range(6):
        rx.next_block(480)
    assert fired == [1]
    assert len(ticks) >= 2


def test_buffered_lazy_shared_cache():
    data = np.random.default_rng(9).uniform(-1, 1, (2, 1000)).astype(np.float32)
    buf = Buffered(SamplesBuffer(2, 48000, data, **CPU), block_frames=256)
    clone = buf.clone()
    b1, alive = buf.next_block(300)
    np.testing.assert_allclose(_np(b1), data[:, :300], atol=1e-7)
    assert len(buf._cache.chunks) >= 2  # only what was needed was rendered
    c1, alive = clone.next_block(300)  # the clone replays the shared cache
    np.testing.assert_array_equal(_np(c1), _np(b1))
    buf.next_block(800)  # past the end: zero padded, then dead
    block, alive = buf.next_block(64)
    assert not alive
    sb = clone.to_buffer()
    assert sb.device == torch.device("cpu")
    np.testing.assert_allclose(render(sb), data, atol=1e-7)


def test_buffered_and_record_combinators():
    data = np.random.default_rng(2).uniform(-1, 1, (1, 700)).astype(np.float32)
    node = SamplesBuffer(1, 48000, data, **CPU).amplify(0.5)
    for buf in (node.buffered(), node.record()):
        assert isinstance(buf, Buffered)
        np.testing.assert_array_equal(render(buf.to_buffer()), data * np.float32(0.5))


def test_queue_rate_mismatch_stitches_resampled():
    """A source stitched mid-block at another rate is resampled to the
    block's rate."""
    q_tx, q_rx = queue(False, block_frames=256, **CPU)
    q_tx.append(SamplesBuffer(1, 48000, np.full(300, 0.25, np.float32), **CPU))
    q_tx.append(SamplesBuffer(1, 24000, np.ones(300, np.float32), **CPU))
    blocks = []
    for _ in range(5):
        blk, alive = q_rx.next_block(256)
        blocks.append(_np(blk)[0])
        if not alive:
            break
    out = np.concatenate(blocks)
    np.testing.assert_allclose(out[:300], 0.25)
    assert np.all(np.abs(out[310:880] - 1.0) < 1e-5), out[300:320]
    assert np.abs(out[920:]).max() == 0.0
    assert np.abs(out[300:880]).min() > 0.9


def test_from_iter_from_factory_empty_callback():
    a = np.full(100, 0.5, np.float32)
    b = np.full(50, -0.25, np.float32)
    q = from_iter([SamplesBuffer(1, 48000, a, **CPU), SamplesBuffer(1, 48000, b, **CPU)],
                  block_frames=64, **CPU)
    out = np.concatenate([_np(q.next_block(64)[0])[0] for _ in range(3)])
    np.testing.assert_array_equal(out[:150], np.concatenate([a, b]))
    assert not q.next_block(64)[1]
    made = iter([SamplesBuffer(1, 48000, a, **CPU)])
    f = from_factory(lambda: next(made, None), block_frames=64, **CPU)
    out = np.concatenate([_np(f.next_block(64)[0])[0] for _ in range(2)])
    np.testing.assert_array_equal(out[:100], a)
    assert not f.next_block(64)[1]
    hits = []
    cb = EmptyCallback(lambda: hits.append(1), **CPU)
    assert cb.total_frames() == 0 and not cb.next_block(8)[1] and hits == [1]


# -- tests/test_live_controls.py:190-284 ----------------------------------

def test_player_set_speed_no_replan():
    """The first set_speed on a plain chain rebuilds it once with the
    VariSpeed stage; later changes are state updates on the same node and
    step."""
    tx, rx = mixer(2, 48000, **CPU)
    player = Player.connect_new(tx, block_frames=256)
    player.append(SineWave(440.0, **CPU))
    for _ in range(3):
        player.queue_rx.next_block(256)
    player.set_speed(1.5)
    cur = player.queue_rx.current
    node_after_first, step_after_first = cur["node"], cur["step"]
    assert node_after_first.varispeed is not None
    blk, alive = player.queue_rx.next_block(256)
    assert alive and np.max(np.abs(_np(blk))) > 0
    for ratio in (0.75, 2.0, 1.0):
        player.set_speed(ratio)
        assert player.queue_rx.current["node"] is node_after_first
        assert player.queue_rx.current["step"] is step_after_first
        blk, alive = player.queue_rx.next_block(256)
        assert alive and np.max(np.abs(_np(blk))) > 0


def test_player_speed_appended_sound_live():
    tx, rx = mixer(2, 48000, **CPU)
    player = Player.connect_new(tx, block_frames=256)
    player.set_speed(1.25)
    player.append(SineWave(330.0, **CPU))
    player.queue_rx.next_block(256)
    cur = player.queue_rx.current
    node_before, step_before = cur["node"], cur["step"]
    assert node_before.varispeed is not None
    player.set_speed(0.5)
    assert player.queue_rx.current["node"] is node_before
    assert player.queue_rx.current["step"] is step_before
    blk, alive = player.queue_rx.next_block(256)
    assert alive and np.max(np.abs(_np(blk))) > 0


def test_player_set_speed_late_in_long_sound():
    """The first set_speed's seek replays within VariSpeed's max_block."""
    tx, rx = mixer(2, 48000, **CPU)
    player = Player.connect_new(tx, block_frames=256)
    player.append(SineWave(440.0, **CPU))
    for _ in range(40):
        player.queue_rx.next_block(256)
    player.set_speed(1.5)
    blk, alive = player.queue_rx.next_block(256)
    assert alive and np.max(np.abs(_np(blk))) > 0


def test_player_try_seek_keeps_live_speed():
    rate = 48000
    t = np.arange(rate * 30, dtype=np.float32)
    ramp = np.stack([t, t]) / rate  # value == source seconds
    tx, rx = mixer(2, rate, **CPU)
    player = Player.connect_new(tx, block_frames=256)
    player.append(SamplesBuffer(2, rate, ramp, **CPU))
    player.queue_rx.next_block(256)
    player.set_speed(1.5)
    player.set_speed(2.0)
    player.try_seek(5.0)  # output seconds -> source 10.0 s
    blk, alive = player.queue_rx.next_block(256)
    assert alive
    v0 = float(blk[0, 8])
    assert 9.8 < v0 < 10.4, v0
    slope = (float(blk[0, 200]) - float(blk[0, 8])) / ((200 - 8) / rate)
    assert 1.7 < slope < 2.3, slope


# -- the Player against the JAX package's ---------------------------------

def _player_script(pkg, block=256):
    """The same knob schedule through either package's Player."""
    if pkg == "jax":
        from rodio_tpu.control import Player as P, mixer as m
        from rodio_tpu.sources import SamplesBuffer as B, SineWave as S
        kw = {}
    else:
        P, m, B, S, kw = Player, mixer, SamplesBuffer, SineWave, CPU
    data = (np.random.default_rng(8).integers(-2048, 2049, (2, 9000)) / 4096.0).astype(
        np.float32)
    tx, rx = m(2, 48000, **kw)
    player = P.connect_new(tx, block_frames=block)
    player.append(B(2, 44100, data, **kw))
    player.append(S(330.0, **kw).take_duration(0.05))
    out = []
    for k in range(18):
        if k == 2:
            player.set_volume(0.5)
        if k == 4:
            player.pause()
        if k == 5:
            player.play()
        if k == 7:
            player.set_speed(1.25)
        if k == 10:
            player.try_seek(0.05)
        if k == 12:
            player.skip_one()
        blk, _ = rx.next_block(block)
        out.append(np.asarray(blk))
    return np.concatenate(out, axis=1), player.get_pos(), player.len()


def test_player_matches_jax():
    """Volume, pause, live speed, seek and skip through both Players: the
    same audio within 1e-6 (sin may differ by an ulp; the rest is the
    same f32 ops), the same position and count."""
    got, gpos, glen = _player_script("torch")
    want, wpos, wlen = _player_script("jax")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert gpos == pytest.approx(wpos) and glen == wlen


def test_player_control_state_from_jax():
    from rodio_tpu.control.player import PlayerControl as JControl
    from rodio_tpu.sources import SamplesBuffer as JBuffer
    from rodio_tpu_torch.control import PlayerControl
    from rodio_tpu_torch.convert import state_from_jax

    data = np.random.default_rng(4).uniform(-1, 1, (2, 3000)).astype(np.float32)
    jn = JControl(JBuffer(2, 48000, data), volume=0.5)
    pn = PlayerControl(SamplesBuffer(2, 48000, data, **CPU), volume=0.5)
    js = jn.init_state()
    js, _, _ = jn.emit(js, 700)
    js = {**js, "paused": jax.numpy.asarray(True)}
    ps = state_from_jax(pn, jax.device_get(js))
    for paused in (True, False):
        js, ps = {**js, "paused": jax.numpy.asarray(paused)}, {**ps, "paused": torch.tensor(paused)}
        js, jb, jv = jn.emit(js, 700)
        ps, pb, pv = pn.emit(ps, 700)
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
        assert int(jv) == int(pv) and int(js["frames"]) == int(ps["frames"])


# -- BASELINE config 3 --------------------------------------------------------

def _grid_pcm(frames, seed=3):
    """Seeded 16-bit-grid stereo PCM (a decoded asset's values)."""
    k = np.random.default_rng(seed).integers(-20000, 20001, (2, frames))
    return (k / 32768.0).astype(np.float32)


def test_config3_parity_vs_refimpl():
    """tools/parity_tpu.py's config 3 (6 sines with rodio_compat and a
    44.1 kHz buffer, each 1/8, taken 0.2 s) against refimpl's mixer."""
    cut = _grid_pcm(20000)
    srcs = [ri.TakeDuration(ri.Amplify(ri.SineWave(220.0 * (1 + i)), 1 / 8), int(0.2e9))
            for i in range(6)]
    srcs.append(ri.TakeDuration(ri.Amplify(ri.SamplesBuffer(2, 44100, interleave(cut)), 1 / 8),
                                int(0.2e9)))
    rtx, rrx = ri.mixer(2, 48000)
    for s in srcs:
        rtx.add(s)
    exp = []
    while (v := rrx.next()) is not None:
        exp.append(v)
    exp = np.asarray(exp, np.float32)

    tx, rx = mixer(2, 48000, **CPU)
    for i in range(6):
        tx.add(SineWave(220.0 * (1 + i), rodio_compat=True, **CPU).amplify(1 / 8)
               .take_duration(0.2))
    tx.add(SamplesBuffer(2, 44100, cut, **CPU).amplify(1 / 8).take_duration(0.2))
    got = interleave(np.concatenate([_np(rx.next_block(2048)[0]) for _ in range(5)], axis=1))
    n = min(len(got), len(exp)) - 2  # the last frame: the take-span edge
    assert n > 19000
    np.testing.assert_allclose(got[:n], exp[:n], rtol=0, atol=1e-6)


def _config3_64(pkg, seconds=0.05, block=2048):
    """The 64-source shape of tests/test_baseline_configs.py:105-127: 60
    generators and 4 buffers (2 stereo at 44.1 kHz, 2 mono at 48 kHz, for
    the decoded assets), each 1/64, into mixer(2, 48000)."""
    if pkg == "jax":
        from rodio_tpu.control import mixer as m
        from rodio_tpu.sources import SamplesBuffer as B, SineWave as S1, SquareWave as S2
        from rodio_tpu.sources import TriangleWave as S3
        kw = {}
    else:
        m, B, S1, S2, S3, kw = mixer, SamplesBuffer, SineWave, SquareWave, TriangleWave, CPU
    tx, rx = m(2, 48000, **kw)
    for i in range(60):
        cls = (S1, S2, S3)[i % 3]
        tx.add(cls(110.0 * (1 + i % 16), rodio_compat=True, **kw).amplify(1 / 64)
               .take_duration(seconds))
    for j, (ch, rate) in enumerate(((2, 44100), (2, 44100), (1, 48000), (1, 48000))):
        pcm = _grid_pcm(int(seconds * rate) + 100, seed=10 + j)[:ch]
        tx.add(B(ch, rate, pcm, **kw).amplify(1 / 64).take_duration(seconds))
    blocks = []
    while True:
        out, alive = rx.next_block(block)
        if not alive:
            break
        blocks.append(np.asarray(out))
    return np.concatenate(blocks, axis=1)


def test_config3_64_sources_vs_jax_mixer():
    got = _config3_64("torch")
    want = _config3_64("jax")
    assert got.shape == want.shape and got.shape[1] >= int(0.05 * 48000)
    assert 0.001 < np.abs(got).max() < 4.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
