"""Capture source — the recording edge (microphone equivalent).

The port's copy of ``rodio_tpu/io/microphone.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_io_device.py`` holds the two to the same cases.

TPU-native rebuild of src/microphone.rs + src/microphone/builder.rs: a
producer (an OS capture thread, a network feed, a test generator) pushes
interleaved f32 samples into the native lock-free SPSC ring (100 ms deep by
default, src/microphone.rs:267-270, drop-on-full); the consumer side pops
whole blocks with a 5 ms sleep-poll (src/microphone.rs:229-239) and feeds
them into the block engine as a host-driven source.

On this TPU host there is no OS capture device; the producer side is the
public ``feed()`` API (network/file/test injection). An OS backend slots in
as another producer thread when hardware exists.
"""
from __future__ import annotations

import threading
import time
import numpy as np

from ..core.types import DEFAULT_SAMPLE_RATE, StreamSpec
from .native import SpscRing
from .sample_convert import to_f32


class MicrophoneConfig:
    """(src/microphone/config.rs)"""

    def __init__(self, channels: int = 1, sample_rate: int = DEFAULT_SAMPLE_RATE,
                 buffer_duration: float = 0.100):
        self.channels = channels
        self.sample_rate = sample_rate
        self.buffer_duration = buffer_duration


class Microphone:
    """Host-driven capture source (has ``next_block`` like queue outputs,
    so it can join a mixer or be pulled directly)."""

    POLL_SLEEP = 0.005  # 5 ms (src/microphone.rs:237)

    def __init__(self, config: MicrophoneConfig):
        self.config = config
        self.spec = StreamSpec(config.channels, config.sample_rate)
        capacity = int(
            config.buffer_duration * config.sample_rate * config.channels
        )
        self._ring = SpscRing(max(capacity, 1024))
        self._error = threading.Event()
        self._closed = threading.Event()

    # -- producer side (capture thread / feeder) --
    def feed(self, samples: np.ndarray) -> int:
        """Push interleaved samples; returns the number accepted (excess is
        dropped when the ring is full, src/microphone.rs:287-289)."""
        return self._ring.push(to_f32(np.asarray(samples)).reshape(-1))

    def signal_error(self):
        """Capture-side failure -> the source ends (src/microphone.rs:233)."""
        self._error.set()

    def close(self):
        self._closed.set()

    # -- consumer side --
    def next_block(self, n: int, *, timeout: float = 1.0):
        """Pop one [channels, n] block, waiting up to ``timeout`` for data.

        Returns (block, alive). Missing samples at timeout are zero-filled;
        alive=False after an error or close with an empty ring."""
        c = self.spec.channels
        want = n * c
        out = np.zeros(want, dtype=np.float32)
        got = 0
        deadline = time.monotonic() + timeout
        while got < want:
            chunk = self._ring.pop(want - got)
            if len(chunk):
                out[got : got + len(chunk)] = chunk
                got += len(chunk)
                continue
            if self._error.is_set() or self._closed.is_set():
                if got == 0:
                    return out.reshape(n, c).T, False
                break
            if time.monotonic() > deadline:
                break
            time.sleep(self.POLL_SLEEP)
        return np.ascontiguousarray(out.reshape(n, c).T), True

    def record(self, seconds: float, *, block_frames: int = 1024) -> np.ndarray:
        """Pull a fixed duration into a [channels, frames] array."""
        frames = int(seconds * self.spec.sample_rate)
        chunks = []
        remaining = frames
        while remaining > 0:
            take = min(block_frames, remaining)
            block, alive = self.next_block(take)
            chunks.append(block)
            remaining -= take
            if not alive:
                break
        return np.concatenate(chunks, axis=1) if chunks else np.zeros(
            (self.spec.channels, 0), np.float32
        )


class MicrophoneBuilder:
    """Fluent builder (src/microphone/builder.rs:117-550). The typestate
    device/config negotiation collapses to defaults on a host without
    capture hardware."""

    def __init__(self):
        self._config = MicrophoneConfig()

    def default_device(self) -> "MicrophoneBuilder":
        return self

    def default_config(self) -> "MicrophoneBuilder":
        return self

    def prefer_channels(self, channels: int) -> "MicrophoneBuilder":
        self._config.channels = channels
        return self

    def prefer_sample_rate(self, rate: int) -> "MicrophoneBuilder":
        self._config.sample_rate = rate
        return self

    def prefer_buffer_duration(self, seconds: float) -> "MicrophoneBuilder":
        self._config.buffer_duration = seconds
        return self

    def open_stream(self) -> Microphone:
        """Host-fed microphone: the caller drives ``feed()``."""
        return Microphone(self._config)

    def open_os_stream(self, device: str = "default", **kw) -> Microphone:
        """OS capture: an ALSA reader thread (io/alsa.py AlsaCapture)
        produces into the mic's ring (src/microphone.rs:262-324).
        The returned mic carries the capture handle as ``.capture``;
        close() stops it. Raises where libasound is absent."""
        from .alsa import AlsaCapture

        mic = Microphone(self._config)
        mic.capture = AlsaCapture(mic, device, **kw).start()
        _orig_close = mic.close

        def _close():
            mic.capture.close()
            _orig_close()

        mic.close = _close
        return mic
