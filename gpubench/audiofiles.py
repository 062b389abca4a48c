"""WAV and FLAC writers for the inputs a run writes: a frozen copy of the
writers of ``examples_torch/_assets.py`` (``write_pcm_wav``; ``write_flac``,
verbatim subframes with real CRCs and the samples' MD5), numpy and the
standard library only, so that a change there cannot change the benchmark's
inputs."""
from __future__ import annotations

import hashlib
import struct

import numpy as np


def write_pcm_wav(path, ints: np.ndarray, rate: int, bits: int) -> None:
    """Write integer samples [C, T] as PCM WAV at ``bits`` (8 unsigned,
    16, 24, 32 signed) with no rescaling."""
    channels, frames = ints.shape
    inter = np.asarray(ints, np.int64).T.reshape(-1)
    if bits == 8:
        payload = (inter + 128).astype(np.uint8).tobytes()
    elif bits == 16:
        payload = inter.astype("<i2").tobytes()
    elif bits == 24:
        v = inter.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        payload = np.ascontiguousarray(v).tobytes()
    elif bits == 32:
        payload = inter.astype("<i4").tobytes()
    else:
        raise ValueError(f"bits {bits}")
    fmt = struct.pack("<HHIIHH", 1, channels, rate, rate * channels * bits // 8,
                      channels * bits // 8, bits)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)


def _crc_table(poly: int, width: int) -> np.ndarray:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = np.zeros(256, np.int64)
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if c & top else (c << 1)
        table[i] = c & mask
    return table


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC8[c ^ b])
    return c


def crc16_rows(rows: np.ndarray) -> np.ndarray:
    """CRC-16 (poly 0x8005, init 0) of each row of a uint8 matrix."""
    c = np.zeros(rows.shape[0], np.int64)
    for j in range(rows.shape[1]):
        c = ((c << 8) & 0xFFFF) ^ _CRC16[((c >> 8) ^ rows[:, j]) & 0xFF]
    return c


def _utf8_number(n: int) -> bytes:
    """FLAC's UTF-8-style coding of a frame number."""
    if n < 0x80:
        return bytes([n])
    nbytes = 2
    while n >= 1 << (5 * nbytes + 1):
        nbytes += 1
    first = ((0xFF << (8 - nbytes)) & 0xFF) | (n >> (6 * (nbytes - 1)))
    rest = [0x80 | ((n >> (6 * i)) & 0x3F) for i in range(nbytes - 2, -1, -1)]
    return bytes([first & 0xFF, *rest])


def write_flac(path, ints: np.ndarray, rate: int, bits: int = 16,
               block: int = 4096) -> None:
    """Write integer samples [C, T] (``bits`` 16 or 24) as FLAC with
    verbatim subframes, independent channels and fixed ``block``-frame
    frames (the last one shorter)."""
    if bits not in (16, 24):
        raise ValueError("the verbatim writer keeps fields byte-aligned: 16 or 24 bits")
    channels, total = ints.shape
    ints = np.asarray(ints, np.int64)
    inter = ints.T.reshape(-1)
    md5 = hashlib.md5(inter.astype("<i2" if bits == 16 else "<i4").view(np.uint8)
                      .reshape(-1, 2 if bits == 16 else 4)[:, :bits // 8].tobytes()).digest()
    si = struct.pack(">HH", block, block) + bytes(6)  # block sizes; frame sizes unknown
    packed = (rate << 44) | ((channels - 1) << 41) | ((bits - 1) << 36) | total
    si += packed.to_bytes(8, "big") + md5
    out = [b"fLaC", bytes([0x80, 0, 0, 34]), si]
    size_code = 0b100 if bits == 16 else 0b110
    bps = bits // 8
    frames = []
    for i, start in enumerate(range(0, total, block)):
        n = min(block, total - start)
        bs_code, bs_extra = ((0b1100, b"") if n == 4096 and block == 4096
                             else (0b0111, (n - 1).to_bytes(2, "big")))
        hdr = bytes([0xFF, 0xF8, (bs_code << 4) | 0b0000,
                     ((channels - 1) << 4) | (size_code << 1)])
        hdr += _utf8_number(i) + bs_extra
        hdr += bytes([crc8(hdr)])
        sub = []
        for c in range(channels):
            s = ints[c, start:start + n]
            if bps == 2:
                body = s.astype(">i2").tobytes()
            else:
                body = np.ascontiguousarray(
                    s.astype(">i4").view(np.uint8).reshape(-1, 4)[:, 1:]).tobytes()
            sub.append(b"\x02" + body)  # verbatim, no wasted bits
        frames.append(hdr + b"".join(sub))
    width = max(len(f) for f in frames)
    rows = np.zeros((len(frames), width), np.int64)
    for r, f in enumerate(frames):
        rows[r, width - len(f):] = np.frombuffer(f, np.uint8)
    crcs = crc16_rows(rows)
    for f, c in zip(frames, crcs):
        out.append(f + int(c).to_bytes(2, "big"))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
