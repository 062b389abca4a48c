"""The port's device side of io (sinks, the OS backends through injected
fake libraries, the microphone, hosted sources in the mixer) against the
JAX package's, on the CPU.

The cases of ``test_control_device.py:152-252`` (sinks, microphone),
``test_alsa_backend.py`` (the realtime soak with the JAX package's
bounds), ``test_pulse_backend.py`` and ``test_robustness.py``'s
``play`` error are ported. Beside them: the file sink's WAV against the
JAX package's for the same mixer (1e-6: the resampler's weight form is
a matmul in the JAX package, whose XLA:CPU dot rounds an ulp apart), a
``Microphone`` and a ``StreamingWav`` inside a mixer, the threaded
``start``/``close`` with a ``CallbackDevice``, and the host helpers
(``nearest_multiple_of_two``, ``BlockTimer``) against their originals.

Every test that waits on a thread or polls runs under ``bounded``, with a
time limit of its own.
"""
import ctypes
import threading
import time

import numpy as np
import pytest
import torch

from rodio_tpu_torch.control.player import Player
from rodio_tpu_torch.io.alsa import AlsaCapture, AlsaDevice
from rodio_tpu_torch.io.alsa import available as alsa_available
from rodio_tpu_torch.io.device import (
    CallbackDevice, DeviceConfig, DeviceSinkBuilder, FileDevice, MixerDeviceSink, NullDevice,
    play)
from rodio_tpu_torch.io.microphone import Microphone, MicrophoneBuilder, MicrophoneConfig
from rodio_tpu_torch.io.pulse import PulseCapture, PulseDevice
from rodio_tpu_torch.io.pulse import available as pulse_available
from rodio_tpu_torch.io.streaming import StreamingWav
from rodio_tpu_torch.io.wav import read_wav
from rodio_tpu_torch.sources.generators import SamplesBuffer, SineWave
from test_torch_io_fixtures import bounded, pcm16_master, write_flac, write_pcm_wav

CPU = dict(device="cpu")


def _sink():
    return DeviceSinkBuilder(**CPU)


# -- sinks (test_control_device.py:152-252) ----------------------------------

def test_device_file_sink_renders_wav(tmp_path):
    path = str(tmp_path / "out.wav")
    sink = _sink().to_file(path).prefer_sample_rate(48000).prefer_buffer_frames(512).open()
    sink.mixer().add(SamplesBuffer(2, 48000, np.ones(2048 * 2, np.float32) * 0.5, **CPU))
    sink.render_blocks(4)
    sink.close()
    pcm, rate = read_wav(path)
    assert rate == 48000 and pcm.shape == (2, 2048)
    np.testing.assert_allclose(pcm, 0.5, atol=1e-6)


def test_device_callback_and_play():
    got = []
    sink = _sink().with_callback(got.append).prefer_buffer_frames(256).open()
    play(sink, SineWave(440.0, **CPU).take_duration(0.05))
    sink.render_blocks(3)
    sink.close()
    assert len(got) == 3
    assert all(len(g) == 512 for g in got)
    assert max(np.abs(g).max() for g in got) > 0.5


def test_device_dtype_conversion():
    got = []
    sink = (_sink().with_callback(got.append).with_dtype(np.int16)
            .prefer_buffer_frames(128).open())
    sink.mixer().add(SamplesBuffer(2, 48000, np.ones(1024, np.float32), **CPU))
    sink.render_blocks(1)
    sink.close()
    assert got[0].dtype == np.int16 and got[0].max() == 32767


def test_play_decodes_a_path_onto_the_sinks_device(tmp_path):
    k, master = pcm16_master(4, 2, 4000)
    path = str(tmp_path / "a.flac")
    write_flac(path, k, 48000)
    got = []
    sink = _sink().with_callback(got.append).prefer_buffer_frames(1000).open()
    player = play(sink, path)
    assert player.len() == 1
    sink.render_blocks(4)
    sink.close()
    out = np.concatenate(got).reshape(-1, 2).T
    np.testing.assert_array_equal(out, master)


def test_play_error_on_undecodable_path(tmp_path):
    from rodio_tpu_torch.core.errors import PlayError

    bad = tmp_path / "not_audio.xyz"
    bad.write_bytes(b"this is not audio at all")
    sink = _sink().open()
    try:
        with pytest.raises(PlayError):
            play(sink, str(bad))
    finally:
        sink.close()


def test_file_sink_matches_jax(tmp_path):
    """The same mixer (a 44.1 kHz buffer through the mixer's Uniform, a
    48 kHz one beside it) through each package's file sink: within 1e-6
    (an ulp apart where the JAX package's matmul rounds)."""
    from rodio_tpu.io.device import DeviceSinkBuilder as JBuilder
    from rodio_tpu.io.wav import read_wav as jread_wav
    from rodio_tpu.sources.generators import SamplesBuffer as JBuffer

    rng = np.random.default_rng(6)
    a = rng.uniform(-0.5, 0.5, (2, 9000)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (2, 5000)).astype(np.float32)
    outs = []
    for builder, buf, reader, kw in ((_sink(), SamplesBuffer, read_wav, CPU),
                                     (JBuilder(), JBuffer, jread_wav, {})):
        path = str(tmp_path / f"{len(outs)}.wav")
        sink = builder.to_file(path).prefer_buffer_frames(2048).open()
        sink.mixer().add(buf(2, 44100, a, **kw))
        sink.mixer().add(buf(2, 48000, b, **kw))
        sink.render_blocks(6)
        sink.close()
        outs.append(reader(path)[0])
    assert outs[0].shape == (2, 6 * 2048)
    assert np.abs(outs[0] - outs[1]).max() <= 1e-6


@bounded(30)
def test_threaded_start_and_close_with_a_callback_device():
    got = []
    sink = _sink().with_callback(got.append).prefer_buffer_frames(256).open()
    sink.mixer().add(SineWave(440.0, **CPU))
    sink.start()
    deadline = time.monotonic() + 20
    while len(got) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    sink.close()
    assert len(got) >= 5 and all(len(g) == 512 for g in got)
    assert sink._thread is None


def test_sink_error_callback_receives_the_failure():
    errors = []

    class Broken(CallbackDevice):
        def write(self, interleaved, config):
            raise OSError("device gone")

    sink = MixerDeviceSink(Broken(None), DeviceConfig(buffer_frames=64), **CPU)
    sink.on_error = errors.append
    sink.mixer().add(SineWave(440.0, **CPU))
    sink.start()
    sink._thread.join(timeout=10)
    sink.close()
    assert len(errors) == 1 and isinstance(errors[0], OSError)


def test_device_config_and_buffer_duration_match_jax():
    from rodio_tpu.core.math import nearest_multiple_of_two as jn
    from rodio_tpu.io.device import DeviceConfig as JConfig
    from rodio_tpu_torch.core.math import nearest_multiple_of_two

    for n in (0, 1, 2, 3, 5, 6, 7, 1000, 2400, 2205, 3072, 4097, 1 << 20):
        assert nearest_multiple_of_two(n) == jn(n)
    for rate, dur in ((48000, 0.05), (44100, 0.05), (8000, 0.1), (96000, 0.02)):
        assert (DeviceConfig(sample_rate=rate, buffer_duration=dur).buffer_frames
                == JConfig(sample_rate=rate, buffer_duration=dur).buffer_frames)
    b = _sink().prefer_sample_rate(44100).prefer_buffer_duration(0.05)
    assert b._config.buffer_frames == 2048


def test_block_timer_stats_match_jax():
    from rodio_tpu.utils.trace import BlockTimer as JTimer
    from rodio_tpu_torch.utils.trace import BlockTimer, log_event

    a, b = BlockTimer(48000, 480), JTimer(48000, 480)
    a.times = b.times = [0.001, 0.02, 0.005, 0.011]
    assert a.stats() == b.stats()
    with a.block():
        pass
    assert len(a.times) == 5
    log_event("test_event", n=1)  # a debug record, no handler needed


# -- the microphone ----------------------------------------------------------

def test_microphone_feed_and_pull():
    mic = (MicrophoneBuilder().default_device().prefer_channels(2)
           .prefer_sample_rate(48000).open_stream())
    data = np.arange(512, dtype=np.float32) / 512.0
    assert mic.feed(data) == 512
    block, alive = mic.next_block(256)
    assert alive
    np.testing.assert_allclose(block.T.reshape(-1), data, atol=1e-7)
    mic.close()
    _, alive = mic.next_block(16, timeout=0.05)
    assert not alive


def test_microphone_drop_on_full():
    mic = Microphone(MicrophoneConfig(channels=1, sample_rate=1000, buffer_duration=1.0))
    assert mic.feed(np.ones(10000, np.float32)) <= mic._ring.capacity


def test_microphone_matches_jax():
    from rodio_tpu.io.microphone import Microphone as JMic
    from rodio_tpu.io.microphone import MicrophoneConfig as JConfig

    rng = np.random.default_rng(9)
    a = Microphone(MicrophoneConfig(channels=2, sample_rate=48000))
    b = JMic(JConfig(channels=2, sample_rate=48000))
    for n in (1000, 4000, 3):
        x = (rng.uniform(-1, 1, 2 * n) * 32767).astype(np.int16)
        assert a.feed(x) == b.feed(x)
        np.testing.assert_array_equal(a.next_block(n, timeout=0.01)[0],
                                      b.next_block(n, timeout=0.01)[0])
    np.testing.assert_array_equal(a.record(0.001), b.record(0.001))


@bounded(60)
def test_microphone_and_streaming_wav_inside_a_mixer(tmp_path):
    """Hosted sources hand the mixer numpy blocks: the mixer moves them to
    its device and sums them after the device members, as the JAX package
    does."""
    from rodio_tpu_torch.control import mixer

    k, master = pcm16_master(5, 2, 12000)
    path = str(tmp_path / "s.wav")
    write_pcm_wav(path, k, 48000, 16)
    mic = Microphone(MicrophoneConfig(channels=2, sample_rate=48000, buffer_duration=1.0))
    voice = np.random.default_rng(10).uniform(-0.2, 0.2, (2, 12000)).astype(np.float32)
    tone = np.full((2, 12000), 0.125, np.float32)
    tx, rx = mixer(2, 48000, **CPU)
    tx.add(SamplesBuffer(2, 48000, tone, **CPU))
    tx.add(StreamingWav(path, chunk_frames=1000))
    tx.add(mic)

    def talk():
        inter = np.ascontiguousarray(voice.T).reshape(-1)
        off = 0
        while off < len(inter):
            off += mic.feed(inter[off:off + 4000])
            time.sleep(0.001)

    t = threading.Thread(target=talk, daemon=True)
    t.start()
    blocks = []
    for _ in range(6):
        block, alive = rx.next_block(2000)
        assert alive and isinstance(block, torch.Tensor) and block.device.type == "cpu"
        blocks.append(block.numpy())
    t.join(timeout=20)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1), (tone + master) + voice)


# -- ALSA, through an injected fake libasound (test_alsa_backend.py) ----------

class FakeAlsa:
    """Records calls; injects one EPIPE underrun mid-stream."""

    def __init__(self, fail_at_write: int = 2, capture_blocks: int = 6):
        self.writes, self.reads, self.recovered = [], 0, []
        self.opened, self.closed, self.drained = [], 0, 0
        self._fail_at, self._capture_blocks = fail_at_write, capture_blocks
        self.params = None

    def snd_pcm_open(self, pcm_ref, name, stream, mode):
        self.opened.append((name, stream))
        return 0

    def snd_pcm_set_params(self, pcm, fmt, access, ch, rate, resample, latency):
        self.params = (fmt, access, ch, rate, latency)
        return 0

    def snd_pcm_writei(self, pcm, buf, frames):
        if len(self.writes) + 1 == self._fail_at and self._fail_at > 0:
            self._fail_at = -1
            return -32  # EPIPE underrun
        self.writes.append(int(frames))
        return int(frames)

    def snd_pcm_readi(self, pcm, buf, frames):
        self.reads += 1
        if self.reads > self._capture_blocks:
            time.sleep(0.005)
            return -11  # EAGAIN: nothing captured
        arr = (ctypes.c_float * int(frames)).from_address(
            ctypes.cast(buf, ctypes.c_void_p).value)
        for i in range(int(frames)):
            arr[i] = 0.25
        return int(frames)

    def snd_pcm_recover(self, pcm, err, silent):
        self.recovered.append(int(err))
        return 0

    def snd_pcm_drain(self, pcm):
        self.drained += 1
        return 0

    def snd_pcm_close(self, pcm):
        self.closed += 1
        return 0


def test_alsa_device_write_path_and_xrun_recovery():
    fake = FakeAlsa(fail_at_write=2)
    dev = AlsaDevice(lib=fake)
    cfg = DeviceConfig(channels=2, sample_rate=48000)
    blk = np.zeros(1024 * 2, np.float32)
    for _ in range(3):
        dev.write(blk, cfg)  # the second hits the injected EPIPE, recovers, retries
    dev.close()
    assert fake.opened == [(b"default", 0)]
    assert fake.params == (14, 3, 2, 48000, 100000)  # f32le interleaved
    assert dev.xruns == 1 and fake.recovered == [-32]
    assert sum(fake.writes) == 3 * 1024
    assert fake.drained == 1 and fake.closed == 1


def test_alsa_device_through_sink():
    fake = FakeAlsa(fail_at_write=0)
    sink = MixerDeviceSink(AlsaDevice(lib=fake), DeviceConfig(buffer_frames=256), **CPU)
    Player.connect_new(sink.mixer()).append(SineWave(440.0, **CPU))
    sink.render_blocks(4)
    sink.close()
    assert sum(fake.writes) == 4 * 256 and fake.closed == 1


@bounded(30)
def test_alsa_capture_feeds_microphone():
    fake = FakeAlsa(capture_blocks=6)
    mic = Microphone(MicrophoneConfig(channels=1, sample_rate=48000))
    cap = AlsaCapture(mic, period_frames=256, lib=fake)
    cap.start()
    assert fake.opened == [(b"default", 1)]  # a capture stream
    block, ok = mic.next_block(512, timeout=2.0)
    cap.close()
    assert ok and block.shape == (1, 512)
    np.testing.assert_allclose(block, 0.25)


def test_open_default_sink_backend_selection():
    """With no sound hardware the default sink is the null device."""
    sink = DeviceSinkBuilder.open_default_sink(**CPU)
    try:
        if pulse_available():
            assert isinstance(sink._backend, PulseDevice)
        elif alsa_available():
            assert isinstance(sink._backend, AlsaDevice)
        else:
            assert isinstance(sink._backend, NullDevice)
    finally:
        sink.close()


@bounded(120)
def test_realtime_soak_zero_xruns():
    """~1.5 s of realtime-paced playback through the device layer: every
    block meets its deadline (one preempted block allowed on a shared
    host), and the cadence matches the device rate (the JAX package's
    bounds)."""
    from rodio_tpu_torch.utils.trace import BlockTimer

    cfg = DeviceConfig(buffer_frames=2048)
    sink = MixerDeviceSink(NullDevice(), cfg, **CPU)
    Player.connect_new(sink.mixer()).append(SineWave(440.0, **CPU))
    timer = BlockTimer(sample_rate=cfg.sample_rate, block_frames=cfg.buffer_frames)
    deadline = cfg.buffer_frames / cfg.sample_rate
    sink.render_blocks(1)
    xruns = 0
    for _ in range(36):
        with timer.block():
            sink.render_blocks(1)
        if timer.times[-1] > 3.0 * deadline:
            xruns += 1
    sink.close()
    stats = timer.stats()
    assert stats["blocks"] == 36
    assert xruns <= 1, f"{xruns} blocks missed the realtime deadline"
    assert 0.5 * deadline < stats["mean_ms"] / 1e3 < 1.5 * deadline


# -- PulseAudio, through an injected fake libpulse-simple ---------------------

class FakePulse:
    """Records calls; injects one write failure mid-stream."""

    def __init__(self, fail_at_write: int = 0, capture_blocks: int = 4):
        self.news, self.writes, self.reads = [], [], 0
        self.freed = self.drained = 0
        self._fail_at, self._capture_blocks, self._next = fail_at_write, capture_blocks, 1

    def pa_simple_new(self, server, app, direction, dev, name, spec, chmap, attr, err):
        self.news.append((direction, bytes(app), (spec.contents.format, spec.contents.rate,
                                                  spec.contents.channels)))
        self._next += 1
        return self._next - 1

    def pa_simple_write(self, s, data, nbytes, err):
        if len(self.writes) + 1 == self._fail_at and self._fail_at > 0:
            self._fail_at = -1
            err.contents.value = 11
            return -1
        self.writes.append(int(nbytes))
        return 0

    def pa_simple_read(self, s, data, nbytes, err):
        self.reads += 1
        if self.reads > self._capture_blocks:
            time.sleep(0.005)
            err.contents.value = 6  # the daemon is gone
            return -1
        n = int(nbytes) // 4
        arr = (ctypes.c_float * n).from_address(ctypes.cast(data, ctypes.c_void_p).value)
        for i in range(n):
            arr[i] = 0.5
        return 0

    def pa_simple_drain(self, s, err):
        self.drained += 1
        return 0

    def pa_simple_free(self, s):
        self.freed += 1


def test_pulse_device_write_and_reconnect():
    fake = FakePulse(fail_at_write=2)
    dev = PulseDevice(lib=fake)
    cfg = DeviceConfig(channels=2, sample_rate=48000)
    blk = np.zeros(1024 * 2, np.float32)
    for _ in range(3):
        dev.write(blk, cfg)  # the injected failure: reconnect, retry
    dev.close()
    assert [n[0] for n in fake.news] == [1, 1]
    assert fake.news[0][2] == (5, 48000, 2)
    assert dev.errors == 1
    assert sum(fake.writes) == 3 * 1024 * 2 * 4
    assert fake.drained == 1 and fake.freed == 2


def test_pulse_device_through_sink():
    fake = FakePulse()
    sink = MixerDeviceSink(PulseDevice(lib=fake), DeviceConfig(buffer_frames=256), **CPU)
    Player.connect_new(sink.mixer()).append(SineWave(440.0, **CPU))
    sink.render_blocks(4)
    sink.close()
    assert sum(fake.writes) == 4 * 256 * 2 * 4 and fake.freed == 1


@bounded(30)
def test_pulse_capture_feeds_microphone():
    fake = FakePulse(capture_blocks=6)
    mic = Microphone(MicrophoneConfig(channels=1, sample_rate=48000))
    cap = PulseCapture(mic, period_frames=256, lib=fake)
    cap.start()
    assert fake.news[0][0] == 2  # a record stream
    block, ok = mic.next_block(512, timeout=2.0)
    cap.close()
    assert ok and block.shape == (1, 512)
    np.testing.assert_allclose(block, 0.5)


@bounded(30)
def test_os_capture_error_ends_the_microphone():
    """A capture failure signals the microphone, which then ends."""
    fake = FakePulse(capture_blocks=0)
    mic = Microphone(MicrophoneConfig(channels=1, sample_rate=48000))
    cap = PulseCapture(mic, period_frames=256, lib=fake).start()
    cap._thread.join(timeout=10)
    _, alive = mic.next_block(64, timeout=0.1)
    cap.close()
    assert not alive


def test_file_device_without_writes_leaves_no_file(tmp_path):
    dev = FileDevice(str(tmp_path / "never.wav"))
    dev.close()
    assert not (tmp_path / "never.wav").exists()
