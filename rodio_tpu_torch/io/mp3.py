"""MP3 decode via the system libmpg123 (ctypes).

The port's copy of ``rodio_tpu/io/mp3.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_io.py`` holds the two equal.

The reference decodes MP3 with the symphonia/minimp3 Rust crates
(src/decoder/mp3.rs, src/decoder/symphonia.rs); the rodio_tpu ingest stage
binds the system's libmpg123 and decodes to f32 PCM in one pass. Gapless
trimming (LAME/Xing delay+padding) is mpg123's default, matching the
reference's gapless=true default (src/decoder/builder.rs:61).
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

MPG123_OK = 0
MPG123_DONE = -12
MPG123_NEW_FORMAT = -11
MPG123_ENC_FLOAT_32 = 0x200

_lib: Optional[ctypes.CDLL] = None


class Mp3Unavailable(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise Mp3Unavailable(f"libmpg123 not available: {e}")
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_size_t]
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def mp3_probe(data: bytes) -> bool:
    if data[:3] == b"ID3":
        return True
    if len(data) >= 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        return True
    return False


MPG123_REMOVE_FLAGS = 13
MPG123_FLAG_GAPLESS = 0x100


def mp3_decode(data: bytes, *, gapless: bool = True) -> Tuple[np.ndarray, int]:
    """Decode MP3 bytes -> ([channels, frames] float32, sample_rate).

    gapless=True (the reference's default, src/decoder/builder.rs:61) trims
    LAME/Xing encoder delay and padding."""
    lib = _load()
    lib.mpg123_param.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double,
    ]
    err = ctypes.c_int()
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise Mp3Unavailable("mpg123_new failed")
    try:
        if not gapless:
            lib.mpg123_param(h, MPG123_REMOVE_FLAGS, MPG123_FLAG_GAPLESS, 0.0)
        # force f32 output for every rate/channel combo BEFORE decoding
        lib.mpg123_format_none(h)
        for rate_hz in (8000, 11025, 12000, 16000, 22050, 24000, 32000,
                        44100, 48000):
            lib.mpg123_format(h, rate_hz, 3, MPG123_ENC_FLOAT_32)  # 3 = mono|stereo
        if lib.mpg123_open_feed(h) != MPG123_OK:
            raise ValueError("mpg123_open_feed failed")
        if lib.mpg123_feed(h, data, len(data)) != MPG123_OK:
            raise ValueError("mpg123_feed failed")

        out = bytearray()
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        buf = ctypes.create_string_buffer(1 << 16)
        done = ctypes.c_size_t(0)
        got_format = False
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if rc == MPG123_NEW_FORMAT:
                lib.mpg123_getformat(
                    h, ctypes.byref(rate), ctypes.byref(channels),
                    ctypes.byref(enc),
                )
                if enc.value != MPG123_ENC_FLOAT_32:
                    raise ValueError(
                        f"mpg123 refused float output (enc={enc.value})"
                    )
                got_format = True
                continue
            if done.value:
                out += buf.raw[: done.value]
            if rc == MPG123_DONE:
                break
            if rc not in (MPG123_OK,):
                if rc < 0 and not done.value:
                    break  # needs more data = end of feed
        if not got_format or not out:
            raise ValueError("no MP3 audio decoded")
        pcm = np.frombuffer(bytes(out), dtype="<f4")
        frames = len(pcm) // channels.value
        return (
            np.ascontiguousarray(
                pcm[: frames * channels.value]
                .reshape(frames, channels.value).T
            ),
            int(rate.value),
        )
    finally:
        lib.mpg123_delete(h)
