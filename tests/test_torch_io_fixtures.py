"""In-process audio files for the io tests and ``chip_smoke.py``: seeded
16-bit-grid PCM, WAV at any PCM depth, and FLAC from a small verbatim
encoder; and the host side of a resampled PushPort feed. Numpy and the
standard library at import (no test here; pytest collects none).

The FLAC writer emits a STREAMINFO block with the MD5 of the samples, then
fixed-size frames of verbatim subframes (16 or 24 bits: every field stays
byte-aligned) with a real CRC-8 on each frame header and CRC-16 on each
frame. The CRCs of all frames run together, one byte position at a time
across the frames (a frame is left-padded with zeros to the longest:
with a zero initial value, leading zeros leave a CRC unchanged), so 180 s
of stereo encodes in about a second.
"""
from __future__ import annotations

import hashlib
import math
import struct

import numpy as np


def pcm16_master(seed: int, channels: int, frames: int, scale: float = 0.5):
    """(int16 samples [C, T], the same as f32 k / 32768): seeded noise."""
    rng = np.random.default_rng(seed)
    k = np.clip(np.round(rng.standard_normal((channels, frames)) * scale * 8192),
                -32768, 32767).astype(np.int16)
    return k, (k.astype(np.float32) / np.float32(32768.0))


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


def bounded(seconds: float):
    """Decorate a test that waits on threads or polls: its body runs in a
    daemon thread, and the test fails if it has not finished within
    ``seconds`` (an exception in the body is raised as the test's own), so
    no such test can hang the run."""
    import functools
    import threading

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            result = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # handed to the test's thread below
                    result["error"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                raise AssertionError(f"{fn.__name__} did not finish within {seconds} s")
            if "error" in result:
                raise result["error"]

        return run

    return wrap


def resampled_feed(pcm: np.ndarray, rate: int, to: int, n: int, blocks: int, device="cpu"):
    """Render ``Resample(PushPort)`` for ``blocks`` blocks of ``n``, the
    host pushing as the JAX package's farm does
    (``rodio_tpu/parallel/farm.py:560-660``): the window of the
    resampler's weight form ahead of each block, retiring what the next
    block no longer reaches."""
    import torch

    from rodio_tpu_torch.conversions.resample import Resample
    from rodio_tpu_torch.io.streaming import PushPort

    g = math.gcd(rate, to)
    fr, t = rate // g, to // g
    push = (n // t + 2) * fr + 1
    port = PushPort(pcm.shape[0], rate, push + (n // t + 4) * fr, push, device=device)
    node = Resample(port, to, max_block=n)
    want_total = lambda k: (k * n // t + n // t + 2) * fr + 1  # noqa: E731
    low_water = lambda k: (k * n // t) * fr  # noqa: E731
    src = torch.from_numpy(np.pad(pcm, ((0, 0), (0, push)))).to(device)
    st, pushed, base, outs = node.init_state(), 0, 0, []
    for k in range(blocks):
        count = min(max(want_total(k) - pushed, 0), push)
        while k == 0 and pushed + count < want_total(0):  # prime block 0's window
            st["in"] = port.push(st["in"], src[:, pushed:pushed + push], push)
            pushed += push
            count = min(max(want_total(k) - pushed, 0), push)
        retire = max(low_water(k) - base, 0)
        base += retire
        st["in"] = port.push(st["in"], src[:, pushed:pushed + push], count, retire)
        pushed += count
        st, out, _ = node.emit(st, n)
        outs.append(out)
    assert not bool(st["in"]["overflow"])
    return node, torch.cat(outs, dim=1)
