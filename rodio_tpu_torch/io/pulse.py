"""PulseAudio/PipeWire output/capture backends.

The port's copy of ``rodio_tpu/io/pulse.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_io_device.py`` holds the two to the same cases.

The reference's cpal edge speaks ALSA *and* Pulse on Linux
(src/stream.rs builds on cpal's host enumeration); PipeWire hosts serve
the same `libpulse-simple` ABI through pipewire-pulse, so this one
binding covers both daemons. Same design rules as :mod:`.alsa`:

- `libpulse-simple.so.0` binds AT RUNTIME via ctypes (no import-time
  dependency); `available()` gates on the library loading AND a
  reachable daemon socket, so production TPU racks fall back to the
  realtime-paced NullDevice.
- :class:`PulseDevice` is a `_Backend` for MixerDeviceSink: blocking
  interleaved f32 writes through `pa_simple_write` (the daemon paces
  the stream; underruns surface as write errors counted in `errors`).
- :class:`PulseCapture` runs a producer thread over `pa_simple_read`
  feeding a Microphone's ``feed()`` (drop-on-full stays the mic's
  policy).
- Both accept an injected ``lib`` implementing the five entry points,
  so control flow is unit-testable without a daemon.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from ..core.errors import StreamError
from .device import DeviceConfig, _Backend

PA_STREAM_PLAYBACK = 1
PA_STREAM_RECORD = 2
PA_SAMPLE_FLOAT32LE = 5

_lib = None
_lib_err: Optional[str] = None


class PaSampleSpec(ctypes.Structure):
    _fields_ = [
        ("format", ctypes.c_int),
        ("rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint8),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        lib = ctypes.CDLL("libpulse-simple.so.0")
    except OSError as e:
        _lib_err = str(e)
        return None
    proto = [
        ("pa_simple_new", ctypes.c_void_p,
         [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
          ctypes.c_char_p, ctypes.POINTER(PaSampleSpec), ctypes.c_void_p,
          ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]),
        ("pa_simple_write", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
          ctypes.POINTER(ctypes.c_int)]),
        ("pa_simple_read", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
          ctypes.POINTER(ctypes.c_int)]),
        ("pa_simple_drain", ctypes.c_int,
         [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]),
        ("pa_simple_free", None, [ctypes.c_void_p]),
    ]
    for name, res, args in proto:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _lib = lib
    return lib


def _daemon_socket() -> Optional[str]:
    if os.environ.get("PULSE_SERVER"):
        return os.environ["PULSE_SERVER"]
    run = os.environ.get("XDG_RUNTIME_DIR", f"/run/user/{os.getuid()}")
    sock = os.path.join(run, "pulse", "native")
    return sock if os.path.exists(sock) else None


def available() -> bool:
    """True when libpulse-simple loads AND a daemon socket is visible
    (PulseAudio or pipewire-pulse)."""
    return _load() is not None and _daemon_socket() is not None


class PulseDevice(_Backend):
    """Blocking interleaved f32 playback through the simple API — the
    cpal Pulse output-stream analog. ``errors`` counts recovered write
    failures (stream re-opened, like the ALSA xrun dance)."""

    def __init__(self, device: Optional[str] = None, *,
                 app_name: str = "rodio_tpu", lib=None):
        self._lib = lib if lib is not None else _load()
        if self._lib is None:
            raise StreamError(f"libpulse-simple unavailable: {_lib_err}")
        self._device = device.encode() if device else None
        self._app = app_name.encode()
        self._s = None
        self._config: Optional[DeviceConfig] = None
        self.errors = 0

    def _open(self, config: DeviceConfig) -> None:
        spec = PaSampleSpec(PA_SAMPLE_FLOAT32LE, config.sample_rate,
                            config.channels)
        err = ctypes.c_int(0)
        s = self._lib.pa_simple_new(
            None, self._app, PA_STREAM_PLAYBACK, self._device,
            b"playback", ctypes.pointer(spec), None, None,
            ctypes.pointer(err),
        )
        if not s:
            raise StreamError(f"pa_simple_new failed (pa error {err.value})")
        self._s = s
        self._config = config

    def write(self, interleaved: np.ndarray, config: DeviceConfig) -> None:
        if self._s is None:
            self._open(config)
        buf = np.ascontiguousarray(interleaved, dtype=np.float32)
        err = ctypes.c_int(0)
        rc = self._lib.pa_simple_write(
            self._s, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
            ctypes.pointer(err),
        )
        if rc < 0:
            # daemon hiccup (suspend/reconnect): re-open once and retry,
            # the cpal stream-error recovery analog
            self.errors += 1
            self._lib.pa_simple_free(self._s)
            self._s = None
            self._open(config)
            rc = self._lib.pa_simple_write(
                self._s, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
                ctypes.pointer(err),
            )
            if rc < 0:
                raise StreamError(
                    f"pa_simple_write failed (pa error {err.value})"
                )

    def close(self) -> None:
        if self._s is not None:
            err = ctypes.c_int(0)
            self._lib.pa_simple_drain(self._s, ctypes.pointer(err))
            self._lib.pa_simple_free(self._s)
            self._s = None


class PulseCapture:
    """Capture thread feeding a Microphone through ``feed()`` — the
    Pulse analog of AlsaCapture (src/microphone.rs:262-324 semantics)."""

    def __init__(self, microphone, device: Optional[str] = None, *,
                 period_frames: int = 512, app_name: str = "rodio_tpu",
                 lib=None):
        self._lib = lib if lib is not None else _load()
        if self._lib is None:
            raise StreamError(f"libpulse-simple unavailable: {_lib_err}")
        self.mic = microphone
        self._device = device.encode() if device else None
        self._app = app_name.encode()
        self._period = int(period_frames)
        self._s = None
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PulseCapture":
        spec = self.mic.spec
        pspec = PaSampleSpec(PA_SAMPLE_FLOAT32LE, spec.sample_rate,
                             spec.channels)
        err = ctypes.c_int(0)
        s = self._lib.pa_simple_new(
            None, self._app, PA_STREAM_RECORD, self._device,
            b"capture", ctypes.pointer(pspec), None, None,
            ctypes.pointer(err),
        )
        if not s:
            raise StreamError(
                f"pa_simple_new(record) failed (pa error {err.value})"
            )
        self._s = s
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        ch = self.mic.spec.channels
        buf = np.empty(self._period * ch, dtype=np.float32)
        err = ctypes.c_int(0)
        while self._running:
            rc = self._lib.pa_simple_read(
                self._s, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
                ctypes.pointer(err),
            )
            if rc < 0:
                self.mic.signal_error()
                return
            block = buf.reshape(self._period, ch).T
            self.mic.feed(np.array(block))

    def close(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._s is not None:
            self._lib.pa_simple_free(self._s)
            self._s = None
