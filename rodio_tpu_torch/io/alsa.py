"""ALSA output/capture backends — OS audio for hosts that have it.

The port's copy of ``rodio_tpu/io/alsa.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_io_device.py`` holds the two to the same cases.

The reference's OS edge is cpal: a device callback pulls samples from
the mixer (src/stream.rs:520-571) and a capture stream feeds the
microphone source (src/microphone.rs:262-324). TPU hosts in production
racks have no sound hardware, so these backends bind `libasound.so.2`
AT RUNTIME via ctypes — no compile- or import-time dependency; the
`available()` probe gates them and the realtime-paced NullDevice stays
the default everywhere ALSA is absent.

- :class:`AlsaDevice` — a `_Backend` for :class:`MixerDeviceSink`:
  blocking interleaved writes (`snd_pcm_writei`), xrun recovery via
  `snd_pcm_recover` with an xrun counter (the BlockTimer-visible
  underrun signal).
- :class:`AlsaCapture` — a producer thread calling `snd_pcm_readi` and
  feeding a :class:`rodio_tpu_torch.io.microphone.Microphone` through its
  ``feed()`` contract (drop-on-full stays the mic's policy).

Both accept an injected ``lib`` object implementing the six entry
points, so the control flow is unit-testable without sound hardware.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..core.errors import StreamError
from .device import DeviceConfig, _Backend

SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_STREAM_CAPTURE = 1
SND_PCM_FORMAT_FLOAT_LE = 14
SND_PCM_ACCESS_RW_INTERLEAVED = 3
_EPIPE = -32

_lib = None
_lib_err: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        lib = ctypes.CDLL("libasound.so.2")
    except OSError as e:
        _lib_err = str(e)
        return None
    proto = [
        ("snd_pcm_open", ctypes.c_int,
         [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
          ctypes.c_int, ctypes.c_int]),
        ("snd_pcm_set_params", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
          ctypes.c_uint, ctypes.c_int, ctypes.c_uint]),
        ("snd_pcm_writei", ctypes.c_long,
         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]),
        ("snd_pcm_readi", ctypes.c_long,
         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]),
        ("snd_pcm_recover", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]),
        ("snd_pcm_drain", ctypes.c_int, [ctypes.c_void_p]),
        ("snd_pcm_close", ctypes.c_int, [ctypes.c_void_p]),
    ]
    for name, res, args in proto:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _lib = lib
    return lib


def available() -> bool:
    """True when libasound loads AND a sound device exists."""
    import os

    return _load() is not None and os.path.isdir("/dev/snd")


class AlsaDevice(_Backend):
    """Blocking interleaved f32 playback on an ALSA PCM (the cpal output
    stream analog, src/stream.rs:520-571). ``xruns`` counts recovered
    underruns (asserted zero by the soak test where hardware exists)."""

    def __init__(self, device: str = "default", *, latency_us: int = 100_000,
                 lib=None):
        self._lib = lib if lib is not None else _load()
        if self._lib is None:
            raise StreamError(f"libasound unavailable: {_lib_err}")
        self._pcm = ctypes.c_void_p()
        self._device = device.encode()
        self._opened = False
        self._latency_us = int(latency_us)
        self.xruns = 0

    def _open(self, config: DeviceConfig) -> None:
        rc = self._lib.snd_pcm_open(
            ctypes.byref(self._pcm), self._device,
            SND_PCM_STREAM_PLAYBACK, 0,
        )
        if rc < 0:
            raise StreamError(f"snd_pcm_open failed ({rc})")
        rc = self._lib.snd_pcm_set_params(
            self._pcm, SND_PCM_FORMAT_FLOAT_LE,
            SND_PCM_ACCESS_RW_INTERLEAVED, config.channels,
            config.sample_rate, 1, self._latency_us,
        )
        if rc < 0:
            self._lib.snd_pcm_close(self._pcm)
            raise StreamError(f"snd_pcm_set_params failed ({rc})")
        self._opened = True

    def write(self, interleaved: np.ndarray, config: DeviceConfig) -> None:
        if not self._opened:
            self._open(config)
        buf = np.ascontiguousarray(interleaved, dtype=np.float32)
        frames = len(buf) // config.channels
        off = 0
        while off < frames:
            chunk = buf[off * config.channels :]
            n = self._lib.snd_pcm_writei(
                self._pcm, chunk.ctypes.data_as(ctypes.c_void_p),
                frames - off,
            )
            if n == _EPIPE:
                # underrun: recover and retry (snd_pcm_recover silences
                # the EPIPE class; the cpal path does the same dance)
                self.xruns += 1
                rc = self._lib.snd_pcm_recover(self._pcm, int(n), 1)
                if rc < 0:
                    raise StreamError(f"xrun recovery failed ({rc})")
                continue
            if n < 0:
                rc = self._lib.snd_pcm_recover(self._pcm, int(n), 1)
                if rc < 0:
                    raise StreamError(f"snd_pcm_writei failed ({n})")
                continue
            off += int(n)

    def close(self) -> None:
        if self._opened:
            self._lib.snd_pcm_drain(self._pcm)
            self._lib.snd_pcm_close(self._pcm)
            self._opened = False


class AlsaCapture:
    """Capture thread feeding a Microphone through ``feed()`` — the OS
    producer for io/microphone.py (src/microphone.rs:262-324). The mic's
    drop-on-full policy is preserved: this thread never blocks on the
    consumer."""

    def __init__(self, microphone, device: str = "default", *,
                 period_frames: int = 512, latency_us: int = 100_000,
                 lib=None):
        self._lib = lib if lib is not None else _load()
        if self._lib is None:
            raise StreamError(f"libasound unavailable: {_lib_err}")
        self.mic = microphone
        self._device = device.encode()
        self._period = int(period_frames)
        self._latency_us = int(latency_us)
        self._pcm = ctypes.c_void_p()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AlsaCapture":
        spec = self.mic.spec
        rc = self._lib.snd_pcm_open(
            ctypes.byref(self._pcm), self._device,
            SND_PCM_STREAM_CAPTURE, 0,
        )
        if rc < 0:
            raise StreamError(f"snd_pcm_open(capture) failed ({rc})")
        rc = self._lib.snd_pcm_set_params(
            self._pcm, SND_PCM_FORMAT_FLOAT_LE,
            SND_PCM_ACCESS_RW_INTERLEAVED, spec.channels,
            spec.sample_rate, 1, self._latency_us,
        )
        if rc < 0:
            self._lib.snd_pcm_close(self._pcm)
            raise StreamError(f"snd_pcm_set_params(capture) failed ({rc})")
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        ch = self.mic.spec.channels
        buf = np.empty(self._period * ch, dtype=np.float32)
        while self._running:
            n = self._lib.snd_pcm_readi(
                self._pcm, buf.ctypes.data_as(ctypes.c_void_p),
                self._period,
            )
            if n == _EPIPE or (n < 0 and n != -11):  # overrun / error
                rc = self._lib.snd_pcm_recover(self._pcm, int(n), 1)
                if rc < 0:
                    self.mic.signal_error()
                    return
                continue
            if n <= 0:
                continue
            block = buf[: int(n) * ch].reshape(int(n), ch).T
            self.mic.feed(np.array(block))

    def close(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._pcm:
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = ctypes.c_void_p()
