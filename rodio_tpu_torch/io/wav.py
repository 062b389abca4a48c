"""WAV read/write — self-contained RIFF codec.

The port's copy of ``rodio_tpu/io/wav.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_io.py`` holds the two equal.

The rebuild of the reference's hound-based paths: `wav_to_file`/`wav_to_writer`
write 32-bit-float WAV with whole-frame truncation (src/wav_output.rs:33-128),
and the WAV decode path (src/decoder/wav.rs) reads PCM 8/16/24/32-bit int and
32/64-bit float, converting to f32 samples with the reference's dasp scaling
(int full-scale division; silence 0.0).
"""
from __future__ import annotations

import io
import struct
from typing import BinaryIO, Union

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavError(Exception):
    pass


def read_wav(path_or_file: Union[str, bytes, BinaryIO]):
    """Read a WAV file -> (data [channels, frames] float32, sample_rate).

    Integer PCM is scaled by the full-scale divisor (i16 -> x/32768 etc.),
    matching dasp_sample's conversions used at the reference's decode
    boundary (src/conversions/sample.rs:6-50).
    """
    if isinstance(path_or_file, (str, bytes)):
        f = open(path_or_file, "rb")
        close = True
    else:
        f = path_or_file
        close = False
    try:
        riff, size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise WavError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csz = struct.unpack("<4sI", hdr)
            payload = f.read(csz)
            if csz % 2:
                f.read(1)  # chunks are word-aligned
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
                if fmt is not None:
                    break
        if fmt is None or data is None:
            raise WavError("missing fmt/data chunk")
        (tag, channels, rate, _brate, _balign, bits) = struct.unpack(
            "<HHIIHH", fmt[:16]
        )
        if tag == WAVE_FORMAT_EXTENSIBLE:
            if len(fmt) < 40:
                raise WavError("truncated extensible fmt chunk")
            tag = struct.unpack("<H", fmt[24:26])[0]

        if tag == WAVE_FORMAT_PCM:
            if bits == 8:
                x = np.frombuffer(data, dtype=np.uint8).astype(np.float32)
                x = (x - 128.0) / 128.0
            elif bits == 16:
                x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
            elif bits == 24:
                raw = np.frombuffer(data, dtype=np.uint8)
                n = len(raw) // 3
                raw = raw[: n * 3].reshape(n, 3)
                x = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                x = (x ^ 0x800000) - 0x800000  # sign-extend
                x = x.astype(np.float32) / 8388608.0
            elif bits == 32:
                x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
            else:
                raise WavError(f"unsupported PCM bit depth {bits}")
        elif tag == WAVE_FORMAT_IEEE_FLOAT:
            if bits == 32:
                x = np.frombuffer(data, dtype="<f4").astype(np.float32)
            elif bits == 64:
                x = np.frombuffer(data, dtype="<f8").astype(np.float32)
            else:
                raise WavError(f"unsupported float bit depth {bits}")
        else:
            raise WavError(f"unsupported format tag 0x{tag:04x}")

        frames = len(x) // channels
        pcm = x[: frames * channels].reshape(frames, channels).T
        return np.ascontiguousarray(pcm), int(rate)
    finally:
        if close:
            f.close()


def write_wav(path_or_file, data: np.ndarray, sample_rate: int,
              *, bits: int = 32, fmt: str = "float") -> None:
    """Write [channels, frames] float32 data as WAV.

    Default 32-bit float, matching the reference's wav output spec
    (src/wav_output.rs:66-71). fmt="int" writes PCM at the given depth with
    clipping at the type boundary (src/common.rs:43-48).
    """
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    channels, frames = data.shape
    interleaved = data.T.reshape(-1)

    if fmt == "float" and bits == 32:
        payload = interleaved.astype("<f4").tobytes()
        tag = WAVE_FORMAT_IEEE_FLOAT
    elif fmt == "int" and bits == 16:
        x = np.clip(interleaved, -1.0, 1.0)
        payload = (x * 32767.0).round().astype("<i2").tobytes()
        tag = WAVE_FORMAT_PCM
    elif fmt == "int" and bits == 24:
        x = np.clip(interleaved, -1.0, 1.0)
        v = (x * 8388607.0).round().astype(np.int32)
        b = np.zeros((len(v), 3), dtype=np.uint8)
        b[:, 0] = v & 0xFF
        b[:, 1] = (v >> 8) & 0xFF
        b[:, 2] = (v >> 16) & 0xFF
        payload = b.tobytes()
        tag = WAVE_FORMAT_PCM
    elif fmt == "int" and bits == 32:
        x = np.clip(interleaved, -1.0, 1.0)
        payload = (x * 2147483647.0).round().astype("<i4").tobytes()
        tag = WAVE_FORMAT_PCM
    else:
        raise WavError(f"unsupported output format {fmt}/{bits}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    fmt_chunk = struct.pack(
        "<HHIIHH", tag, channels, sample_rate, byte_rate, block_align, bits
    )
    out = io.BytesIO()
    out.write(b"RIFF")
    out.write(struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(payload)))
    out.write(b"WAVE")
    out.write(b"fmt ")
    out.write(struct.pack("<I", len(fmt_chunk)))
    out.write(fmt_chunk)
    out.write(b"data")
    out.write(struct.pack("<I", len(payload)))
    out.write(payload)

    blob = out.getvalue()
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "wb") as fh:
            fh.write(blob)
    else:
        path_or_file.write(blob)


def wav_to_file(node, path, *, block_frames: int = 4096, **kw) -> None:
    """Render a node to a 32-bit-float WAV file — the golden-output path
    (src/wav_output.rs:33-59). Trailing partial frames never occur in the
    block engine (frame-major blocks), matching WholeFrames truncation."""
    from ..graph.render import render

    data = render(node, block_frames=block_frames)
    write_wav(path, data, node.spec.sample_rate, **kw)
