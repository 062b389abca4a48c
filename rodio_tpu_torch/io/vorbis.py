"""Ogg Vorbis decode via the system libvorbisfile (ctypes).

The port's copy of ``rodio_tpu/io/vorbis.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_io.py`` holds the two equal.

The reference uses the lewton/symphonia Rust crates (src/decoder/vorbis.rs);
the rodio_tpu ingest stage binds libvorbisfile and decodes to f32 PCM in one
pass (via ov_fopen on a temp spill file — the library's callback-struct ABI
is not reliably expressible through ctypes).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

_libvf: Optional[ctypes.CDLL] = None

# OggVorbis_File is an opaque ~1KB struct; allocate generously
_OVF_SIZE = 2048


class VorbisUnavailable(RuntimeError):
    pass


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


def _load() -> ctypes.CDLL:
    global _libvf
    if _libvf is None:
        name = ctypes.util.find_library("vorbisfile") or "libvorbisfile.so.3"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise VorbisUnavailable(f"libvorbisfile not available: {e}")
        lib.ov_fopen.restype = ctypes.c_int
        lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
        lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_read_float.restype = ctypes.c_long
        lib.ov_read_float.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.ov_clear.argtypes = [ctypes.c_void_p]
        lib.ov_pcm_total.restype = ctypes.c_int64
        lib.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _libvf = lib
    return _libvf


def vorbis_probe(data: bytes) -> bool:
    return data[:4] == b"OggS"


def vorbis_decode(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode Ogg Vorbis bytes -> ([channels, frames] float32, rate)."""
    lib = _load()
    with tempfile.NamedTemporaryFile(suffix=".ogg", delete=False) as f:
        f.write(data)
        path = f.name
    vf = ctypes.create_string_buffer(_OVF_SIZE)
    opened = False
    try:
        rc = lib.ov_fopen(path.encode(), vf)
        if rc != 0:
            raise ValueError(f"ov_fopen failed ({rc})")
        opened = True
        info = lib.ov_info(vf, -1).contents
        channels, rate = info.channels, int(info.rate)
        chunks = []
        pcm_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        while True:
            n = lib.ov_read_float(
                vf, ctypes.byref(pcm_pp), 4096, ctypes.byref(bitstream)
            )
            if n <= 0:
                break
            frame = np.empty((channels, n), dtype=np.float32)
            for c in range(channels):
                frame[c] = np.ctypeslib.as_array(pcm_pp[c], shape=(n,))
            chunks.append(frame)
        if not chunks:
            raise ValueError("no Vorbis audio decoded")
        return np.concatenate(chunks, axis=1), rate
    finally:
        if opened:
            lib.ov_clear(vf)
        os.unlink(path)
