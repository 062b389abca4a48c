"""Native host libraries: the FLAC decoder, the SPSC ring and the libav shim.

The port's counterpart of ``rodio_tpu/io/native.py``, over its own copies
of the C++ sources (``rodio_tpu_torch/native/*.cpp``). Two libraries are
built with ``g++`` at first use, into ``build/rodio_tpu_torch_native/`` at
the root of the checkout (nothing is written into the package), each
named by a hash of its sources and flags so a changed source rebuilds:

- ``core``: ``flac.cpp`` and ``ring.cpp``, with no dependency beyond the
  C++ runtime: FLAC and the ring always work;
- ``ffdec``: ``ffdec.cpp`` linked to ``-lavformat -lavcodec -lavutil``,
  built only where libav's headers are found. Where they are not,
  :class:`FfStream`, :func:`ff_decode` and :func:`encode_ogg` raise
  :class:`LibavUnavailable`, which names the missing headers.

Concurrent builds (test workers) each write a temporary file and rename it
into place.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..utils.trace import span

_PKG = Path(__file__).resolve().parents[1]
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG.parent / "build" / "rodio_tpu_torch_native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
#: library name -> (sources, link flags)
LIBRARIES = {
    "core": (("flac.cpp", "ring.cpp"), ()),
    "ffdec": (("ffdec.cpp",), ("-lavformat", "-lavcodec", "-lavutil")),
}
#: the libav headers ffdec.cpp includes
LIBAV_HEADERS = ("libavcodec/avcodec.h", "libavformat/avformat.h",
                 "libavutil/opt.h")

_libs: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


class LibavUnavailable(RuntimeError):
    """libav's headers (or libraries) are missing: the formats decoded
    through ``ffdec.cpp`` (Ogg, Opus, m4a, streaming FLAC) are unavailable;
    WAV and FLAC decode without it."""


def library_path(name: str) -> Path:
    sources, link = LIBRARIES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + link).encode())
    for src in sources:
        h.update(src.encode())
        h.update((NATIVE_DIR / src).read_bytes())
    return BUILD_DIR / f"librodio_tpu_torch_{name}_{h.hexdigest()[:16]}.so"


def missing_libav_headers() -> List[str]:
    """The libav headers the compiler cannot find (empty where all are)."""

    def found(headers) -> bool:
        src = "".join(f"#include <{h}>\n" for h in headers)
        return subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                              input=src, capture_output=True, text=True).returncode == 0

    if found(LIBAV_HEADERS):
        return []
    return [h for h in LIBAV_HEADERS if not found((h,))]


def build(name: str) -> Path:
    """Compile library ``name`` unless one of the same sources exists."""
    out = library_path(name)
    if out.exists():
        return out
    sources, link = LIBRARIES[name]
    if name == "ffdec":
        missing = missing_libav_headers()
        if missing:
            raise LibavUnavailable(
                f"libav headers not found: {', '.join(missing)} (install libav's "
                "development headers to decode Ogg, Opus, m4a and streaming FLAC)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *[str(NATIVE_DIR / s) for s in sources],
           "-o", str(tmp), *link]
    with span("rodio.setup.build"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        err = LibavUnavailable if name == "ffdec" else NativeBuildError
        raise err(f"native build of {name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


class _FlacInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("total_samples", ctypes.c_uint64),
        ("decoded_frames", ctypes.c_uint64),
    ]


_SIGNATURES = {
    "core": [
        ("rtpu_flac_decode", ctypes.c_int,
         [ctypes.c_char_p, ctypes.c_size_t,
          ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)), ctypes.POINTER(_FlacInfo)]),
        ("rtpu_free", None, [ctypes.c_void_p]),
        ("rtpu_ring_create", ctypes.c_void_p, [ctypes.c_size_t]),
        ("rtpu_ring_destroy", None, [ctypes.c_void_p]),
        ("rtpu_ring_capacity", ctypes.c_size_t, [ctypes.c_void_p]),
        ("rtpu_ring_len", ctypes.c_size_t, [ctypes.c_void_p]),
        ("rtpu_ring_push", ctypes.c_size_t,
         [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]),
        ("rtpu_ring_pop", ctypes.c_size_t,
         [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]),
    ],
    "ffdec": [
        ("rtpu_ff_decode", ctypes.c_int,
         [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
          ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_uint),
          ctypes.POINTER(ctypes.c_uint64)]),
        ("rtpu_ffs_open", ctypes.c_void_p,
         [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_uint),
          ctypes.POINTER(ctypes.c_double)]),
        ("rtpu_ffs_read", ctypes.c_longlong,
         [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]),
        ("rtpu_ffs_seek", ctypes.c_int, [ctypes.c_void_p, ctypes.c_double]),
        ("rtpu_ffs_seek_pos", ctypes.c_longlong, [ctypes.c_void_p, ctypes.c_double]),
        ("rtpu_ffs_param_change", ctypes.c_int,
         [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_uint)]),
        ("rtpu_ffs_close", None, [ctypes.c_void_p]),
        ("rtpu_ff_encode_ogg", ctypes.c_int,
         [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
          ctypes.c_int, ctypes.c_int]),
    ],
}


def lib(name: str = "core") -> ctypes.CDLL:
    """Library ``name`` ("core" or "ffdec"), built and bound at first use.
    "ffdec" raises :class:`LibavUnavailable` where libav is missing."""
    if name not in _libs:
        path = build(name)
        with span("rodio.setup.load"):
            try:
                handle = ctypes.CDLL(str(path))
            except OSError as e:
                if name == "ffdec":
                    raise LibavUnavailable(f"libav libraries not loadable: {e}") from e
                raise
            for fn_name, restype, argtypes in _SIGNATURES[name]:
                fn = getattr(handle, fn_name)
                fn.restype = restype
                fn.argtypes = argtypes
        _libs[name] = handle
    return _libs[name]


class FfStream:
    """Re-entrant streaming decoder over the native ffmpeg shim:
    O(packet) memory for any file length (the incremental analog of the
    reference's packet loop, src/decoder/symphonia.rs:336-417).

    read(n) -> [channels, m] f32 (m < n only at end of stream; m == 0 =>
    exhausted). seek(seconds) is demuxer-coarse (keyframe-backward).
    """

    def __init__(self, path: str):
        L = lib("ffdec")
        ch = ctypes.c_uint()
        rate = ctypes.c_uint()
        dur = ctypes.c_double()
        self._h = L.rtpu_ffs_open(
            str(path).encode(), ctypes.byref(ch), ctypes.byref(rate),
            ctypes.byref(dur),
        )
        if not self._h:
            raise ValueError(f"cannot open {path!r} for streaming decode")
        self.channels = int(ch.value)
        self.sample_rate = int(rate.value)
        self.duration = float(dur.value) if dur.value > 0 else None
        self._param_event = None
        self._L = L

    def read(self, max_frames: int) -> np.ndarray:
        """Read up to max_frames at the CURRENT (channels, sample_rate).
        A chained-container boundary (span change) ends the read early;
        take_param_change() then reports the new spec, and subsequent
        reads decode the next chain link. A 0-frame read with a pending
        param change is a boundary, NOT end of stream."""
        ch = self.channels
        buf = np.empty(max_frames * ch, dtype=np.float32)
        got = self._L.rtpu_ffs_read(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_frames,
        )
        if got < 0:
            raise ValueError(f"streaming decode error (code {got})")
        nch = ctypes.c_uint()
        nrt = ctypes.c_uint()
        if self._L.rtpu_ffs_param_change(
                self._h, ctypes.byref(nch), ctypes.byref(nrt)) == 1:
            # span re-bootstrap point (src/source/span.rs:66-101): the
            # wrapper tracks the NEW spec so later reads deinterleave
            # correctly; callers poll take_param_change()
            self._param_event = (int(nch.value), int(nrt.value))
            self.channels = int(nch.value)
            self.sample_rate = int(nrt.value)
        n = int(got)
        return np.ascontiguousarray(buf[: n * ch].reshape(n, ch).T)

    def take_param_change(self):
        """(channels, rate) of the new chain link if a span boundary was
        crossed since the last call, else None. Clears the event."""
        e = self._param_event
        self._param_event = None
        return e

    def seek(self, seconds: float) -> None:
        rc = self._L.rtpu_ffs_seek(self._h, float(seconds))
        if rc < 0:
            raise ValueError(f"streaming seek failed (code {rc})")

    def seek_accurate(self, seconds: float = None, *,
                      frames: int = None) -> int:
        """Sample-accurate seek: demuxer-coarse keyframe seek, learn the
        landed position from the first decoded frame's timestamp, then
        decode-skip to the exact target (src/decoder/symphonia.rs:225-330).
        Target by ``seconds`` or exact ``frames``; returns the frame index
        actually reached (== the target unless the stream ends first)."""
        if frames is not None:
            target = int(frames)
            req = target / self.sample_rate
        else:
            target = int(round(float(seconds) * self.sample_rate))
            req = float(seconds)
        # pre-roll: codecs with inter-frame decoder state (the mp3 bit
        # reservoir) decode the first frame(s) after a mid-stream entry
        # imperfectly; ask for a point ~0.2 s earlier so the decoder
        # state converges inside the skip
        req = max(req - 0.2, 0.0)
        landed = 0
        for _ in range(4):
            landed = int(self._L.rtpu_ffs_seek_pos(self._h, max(req, 0.0)))
            if landed < 0:
                raise ValueError(f"streaming seek failed (code {landed})")
            if landed <= target or req <= 0.0:
                break
            # demuxer overshoot (VBR index granularity): back off by the
            # overshoot plus a margin and retry
            req -= (landed - target) / self.sample_rate + 0.25
        skip = max(target - landed, 0)
        while skip > 0:
            blk = self.read(min(skip, 65536))
            m = blk.shape[1]
            if m == 0:
                break  # stream ended inside the skip
            skip -= m
        return target - skip

    def close(self) -> None:
        if self._h:
            self._L.rtpu_ffs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def chunks(self, chunk_frames: int):
        """Iterator of [channels, chunk] blocks to end of stream. Spans
        are transparent: a chained-container boundary continues into the
        next link (poll take_param_change() between blocks to observe
        it)."""
        while True:
            blk = self.read(chunk_frames)
            if blk.shape[1] == 0:
                if self._param_event is not None:
                    continue  # span boundary, not end of stream
                return
            yield blk


def encode_ogg(path, pcm, rate: int) -> None:
    """Write [C, T] f32 PCM as FLAC-in-Ogg (s16-quantized, lossless
    thereafter). Concatenating two outputs gives a chained Ogg."""
    L = lib("ffdec")
    pcm = np.asarray(pcm, np.float32)
    channels, frames = pcm.shape
    inter = np.ascontiguousarray(pcm.T).reshape(-1)
    rc = L.rtpu_ff_encode_ogg(
        str(path).encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(frames), int(channels), int(rate),
    )
    if rc != 0:
        raise ValueError(f"ogg encode failed (code {rc})")


def ff_decode(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode any ffmpeg-supported container/codec (m4a/aac, opus, ...)
    -> ([channels, frames] float32, sample_rate)."""
    L = lib("ffdec")
    out = ctypes.POINTER(ctypes.c_float)()
    channels = ctypes.c_uint()
    rate = ctypes.c_uint()
    frames = ctypes.c_uint64()
    rc = L.rtpu_ff_decode(data, len(data), ctypes.byref(out),
                          ctypes.byref(channels), ctypes.byref(rate),
                          ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"ffmpeg decode failed (code {rc})")
    n = frames.value * channels.value
    try:
        pcm = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib("core").rtpu_free(out)  # malloc'd by the shim: libc's free
    return (np.ascontiguousarray(pcm.reshape(frames.value, channels.value).T),
            int(rate.value))


def flac_decode(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream -> ([channels, frames] float32, sample_rate).

    Integer samples scale by full-scale 2^(bps-1), matching the decode
    boundary convention (src/decoder/flac.rs semantics)."""
    L = lib("core")
    info = _FlacInfo()
    out = ctypes.POINTER(ctypes.c_int32)()
    rc = L.rtpu_flac_decode(data, len(data), ctypes.byref(out),
                            ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc})")
    n = info.decoded_frames * info.channels
    try:
        pcm = np.ctypeslib.as_array(out, shape=(n,)).astype(np.float32)
    finally:
        L.rtpu_free(out)
    scale = np.float32(1 << (info.bits_per_sample - 1))
    pcm /= scale
    frames = info.decoded_frames
    return (np.ascontiguousarray(pcm.reshape(frames, info.channels).T),
            int(info.sample_rate))


def flac_probe(data: bytes) -> bool:
    return data[:4] == b"fLaC"


class SpscRing:
    """Lock-free SPSC f32 ring buffer (native). The rtrb equivalent for
    capture/playback transport (src/microphone.rs:119)."""

    def __init__(self, capacity: int):
        self._lib = lib("core")
        self._h = self._lib.rtpu_ring_create(capacity)
        if not self._h:
            raise MemoryError("ring allocation failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.rtpu_ring_destroy(h)
            self._h = None

    @property
    def capacity(self) -> int:
        return self._lib.rtpu_ring_capacity(self._h)

    def __len__(self) -> int:
        return self._lib.rtpu_ring_len(self._h)

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        return self._lib.rtpu_ring_push(
            self._h, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            samples.size,
        )

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        got = self._lib.rtpu_ring_pop(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
        )
        return out[:got]
