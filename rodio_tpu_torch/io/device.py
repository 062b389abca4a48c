"""Device sinks — the playback edge of the framework (layer L0)
(rodio_tpu/io/device.py).

The reference's stream layer (src/stream.rs) and experimental speakers
API (src/speakers/). The reference's OS audio callback pulls one sample at
a time from the mixer (src/stream.rs:536-548); here a playback thread (or
``render_blocks``) pulls whole BLOCKS from the mixer, on the mixer's
device, and reads each back to the host once (one device-to-host copy, a
wait for the card), to hand it interleaved to a backend:

- NullDevice     — realtime-paced sink (no audio hardware on a GPU host);
                   the default device, useful for soak tests and timing
- FileDevice     — streams rendered audio into a WAV file
- CallbackDevice — hands each interleaved block to user code (the cpal
                   callback analog for embedders)

Config mirrors the reference: default 2 ch / 48 kHz / f32, device buffer
about 50 ms rounded to a power of two (src/stream.rs:222-231), preference
order 48k -> 44.1k -> max (src/stream.rs:247-274).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from ..core.types import DEFAULT_SAMPLE_RATE
from ..core.math import nearest_multiple_of_two
from ..control.mixer import Mixer, mixer as _mixer
from ..utils.device import DeviceLike
from .sample_convert import from_f32


class DeviceConfig:
    """(src/speakers/config.rs:7-27)"""

    def __init__(self, channels: int = 2, sample_rate: int = DEFAULT_SAMPLE_RATE,
                 buffer_frames: Optional[int] = None,
                 buffer_duration: float = 0.050, dtype=np.float32):
        self.channels = channels
        self.sample_rate = sample_rate
        if buffer_frames is None:
            buffer_frames = nearest_multiple_of_two(
                int(buffer_duration * sample_rate)
            )
        self.buffer_frames = buffer_frames
        self.dtype = dtype


class _Backend:
    def write(self, interleaved: np.ndarray, config: DeviceConfig) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullDevice(_Backend):
    """Consumes audio at realtime cadence (sleep-paced)."""

    def __init__(self):
        self._next_deadline = None

    def write(self, interleaved, config):
        now = time.monotonic()
        if self._next_deadline is None:
            self._next_deadline = now
        frames = len(interleaved) // config.channels
        self._next_deadline += frames / config.sample_rate
        delay = self._next_deadline - now
        if delay > 0:
            time.sleep(delay)


class FileDevice(_Backend):
    """Streams to a WAV file (header patched on close, the analog of
    src/wav_output.rs:86)."""

    def __init__(self, path: str):
        self.path = path
        self._chunks = []
        self._config = None

    def write(self, interleaved, config):
        self._config = config
        self._chunks.append(np.asarray(interleaved, dtype=np.float32))

    def close(self):
        if self._config is None:
            return
        from .wav import write_wav

        data = np.concatenate(self._chunks) if self._chunks else np.zeros(0)
        frames = len(data) // self._config.channels
        pcm = data[: frames * self._config.channels].reshape(
            frames, self._config.channels
        ).T
        write_wav(self.path, pcm, self._config.sample_rate)


class CallbackDevice(_Backend):
    def __init__(self, callback: Callable[[np.ndarray], None]):
        self.callback = callback

    def write(self, interleaved, config):
        self.callback(interleaved)


class MixerDeviceSink:
    """Open device + attached mixer; a playback thread drives the graph
    (src/stream.rs:56-191). ``mixer()`` returns the handle to add sources;
    the mixer runs on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, backend: _Backend, config: DeviceConfig,
                 *, device: DeviceLike = None):
        self.config = config
        self._backend = backend
        self._mixer, self._source = _mixer(config.channels, config.sample_rate,
                                           device=device)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.log_on_drop = True
        #: invoked with the exception if the playback thread fails — the
        #: stream error callback analog (src/stream.rs:382-391)
        self.on_error: Optional[Callable[[Exception], None]] = None

    def mixer(self) -> Mixer:
        return self._mixer

    def start(self) -> "MixerDeviceSink":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _write_buffer(self) -> None:
        """Pull one device buffer from the mixer, read it back (the sink's
        one device-to-host copy a buffer) and hand it to the backend."""
        block, _alive = self._source.next_block(self.config.buffer_frames)
        interleaved = block.cpu().numpy().T.reshape(-1)
        if self.config.dtype != np.float32:
            interleaved = from_f32(interleaved, self.config.dtype)
        self._backend.write(interleaved, self.config)

    def _run(self):
        try:
            while self._running:
                self._write_buffer()
        except Exception as e:
            from ..utils.trace import log_event

            log_event("device_sink_error", error=repr(e))
            if self.on_error is not None:
                self.on_error(e)

    def render_blocks(self, n_blocks: int) -> None:
        """Synchronous drive (no thread): pull n device buffers through the
        backend — deterministic for tests and offline use."""
        for _ in range(n_blocks):
            self._write_buffer()

    def close(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._backend.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DeviceSinkBuilder:
    """Fluent sink builder with fallback negotiation
    (src/stream.rs:191-274, src/speakers/builder.rs:62-569)."""

    #: rate preference when the requested rate is unavailable
    RATE_PREFERENCE = (48000, 44100)

    def __init__(self, *, device: DeviceLike = None):
        self._config = DeviceConfig()
        self._backend: Optional[_Backend] = None
        self._device = device

    @classmethod
    def open_default_sink(cls, *, device: DeviceLike = None) -> MixerDeviceSink:
        """(src/stream.rs:247) — OS audio when the host has it, probed
        in cpal's Linux order (PulseAudio/PipeWire daemon first, raw
        ALSA second); the realtime-paced null sink otherwise (GPU hosts
        in racks have no sound hardware)."""
        builder = cls(device=device)
        from . import alsa, pulse

        if pulse.available():
            builder._backend = pulse.PulseDevice()
        elif alsa.available():
            builder._backend = alsa.AlsaDevice()
        return builder.open()

    def to_alsa(self, device: str = "default", **kw) -> "DeviceSinkBuilder":
        """Explicit OS-audio backend (io/alsa.py); raises where
        libasound is absent."""
        from .alsa import AlsaDevice

        self._backend = AlsaDevice(device, **kw)
        return self

    def to_pulse(self, device: Optional[str] = None,
                 **kw) -> "DeviceSinkBuilder":
        """Explicit PulseAudio/PipeWire backend (io/pulse.py); raises
        where libpulse-simple is absent."""
        from .pulse import PulseDevice

        self._backend = PulseDevice(device, **kw)
        return self

    def with_backend(self, backend: _Backend) -> "DeviceSinkBuilder":
        self._backend = backend
        return self

    def to_file(self, path: str) -> "DeviceSinkBuilder":
        self._backend = FileDevice(path)
        return self

    def with_callback(self, fn) -> "DeviceSinkBuilder":
        self._backend = CallbackDevice(fn)
        return self

    def prefer_channels(self, channels: int) -> "DeviceSinkBuilder":
        self._config.channels = channels
        return self

    def prefer_sample_rate(self, rate: int) -> "DeviceSinkBuilder":
        self._config.sample_rate = rate
        return self

    def prefer_buffer_duration(self, seconds: float) -> "DeviceSinkBuilder":
        self._config.buffer_frames = nearest_multiple_of_two(
            int(seconds * self._config.sample_rate)
        )
        return self

    def prefer_buffer_frames(self, frames: int) -> "DeviceSinkBuilder":
        self._config.buffer_frames = frames
        return self

    def with_dtype(self, dtype) -> "DeviceSinkBuilder":
        self._config.dtype = dtype
        return self

    def open(self) -> MixerDeviceSink:
        backend = self._backend or NullDevice()
        return MixerDeviceSink(backend, self._config, device=self._device)

    def open_and_start(self) -> MixerDeviceSink:
        return self.open().start()


def play(sink: MixerDeviceSink, source_or_path):
    """Decode (onto the sink's device) + attach a Player + append
    (src/stream.rs:429-437)."""
    from ..control.player import Player
    from ..core.node import Node

    if isinstance(source_or_path, Node):
        node = source_or_path
    else:
        from ..core.errors import PlayError
        from .decoder import Decoder

        try:
            node = Decoder(source_or_path, device=sink.mixer().device)
        except Exception as e:
            # src/play.rs PlayError::DecoderError
            raise PlayError(f"cannot decode {source_or_path!r}: {e}") from e
    player = Player.connect_new(sink.mixer())
    player.append(node)
    return player
