"""Decoder facade: format probe, then decode to PCM on the device
(rodio_tpu/io/decoder.py; src/decoder/mod.rs, src/decoder/builder.rs).

Ingest decodes the whole stream to f32 PCM on the host and hands it to a
:class:`~rodio_tpu_torch.sources.generators.SamplesBuffer` on the node's
device (the card unless ``device="cpu"``): decode once, then every replay
or seek is O(1) device work. The host part (probe order, codec registry,
hints) is the JAX module's, unchanged: wav -> flac -> vorbis -> mp3
(src/decoder/builder.rs:299-341), with extension or MIME hints first.

A format whose system library is missing raises its own error naming it
(``Mp3Unavailable``, ``VorbisUnavailable``, ``LibavUnavailable``); it never
changes the device.
"""
from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import Optional, Union

import torch

from ..core.node import Node, State, full_valid
from ..sources.generators import SamplesBuffer
from ..utils.device import DeviceLike


class DecoderError(Exception):
    """Format unrecognized or decode failure (src/decoder/mod.rs:698)."""


@dataclasses.dataclass
class Settings:
    """Decode settings (src/decoder/builder.rs:61)."""

    gapless: bool = True
    hint: Optional[str] = None
    mime_type: Optional[str] = None
    byte_len: Optional[int] = None
    coarse_seek: bool = False
    seekable: bool = True


#: user-registered codecs: name -> (probe(bytes)->bool, decode(bytes)->(pcm, rate)),
#: the third-party-codec extension point (src/decoder/builder.rs:61)
_CUSTOM_CODECS = {}


def register_codec(name: str, probe, decode, *,
                   extensions: tuple = ()) -> None:
    """Register a third-party codec: ``probe(data) -> bool`` and
    ``decode(data) -> ([channels, frames] f32, sample_rate)``."""
    _CUSTOM_CODECS[name] = (probe, decode)
    for ext in extensions:
        _EXT_TO_FORMAT["." + ext.lstrip(".").lower()] = name


_EXT_TO_FORMAT = {
    ".wav": "wav", ".wave": "wav",
    ".flac": "flac",
    ".ogg": "vorbis", ".oga": "vorbis",
    ".mp3": "mp3",
    ".m4a": "m4a", ".mp4": "m4a", ".mp4a": "m4a", ".aac": "m4a",
    ".opus": "opus",
}


def _decode_as(fmt: str, data: bytes, settings: Settings):
    if fmt in _CUSTOM_CODECS:
        return _CUSTOM_CODECS[fmt][1](data)
    if fmt == "wav":
        from .wav import read_wav

        return read_wav(_io.BytesIO(data))
    if fmt == "flac":
        from .native import flac_decode

        return flac_decode(data)
    if fmt == "vorbis":
        from .vorbis import vorbis_decode

        try:
            return vorbis_decode(data)
        except Exception:
            # an Ogg container but not Vorbis (e.g. Opus): the ffmpeg shim
            from .native import ff_decode

            return ff_decode(data)
    if fmt == "mp3":
        from .mp3 import mp3_decode

        return mp3_decode(data, gapless=settings.gapless)
    if fmt in ("m4a", "opus", "ffmpeg"):
        from .native import ff_decode

        return ff_decode(data)
    raise DecoderError(f"unsupported format {fmt!r}")


def _probe(data: bytes) -> Optional[str]:
    for name, (probe, _) in _CUSTOM_CODECS.items():
        try:
            if probe(data):
                return name
        except Exception:
            pass
    from .mp3 import mp3_probe
    from .native import flac_probe
    from .vorbis import vorbis_probe

    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if flac_probe(data):
        return "flac"
    if vorbis_probe(data):
        return "vorbis"
    if len(data) > 8 and data[4:8] == b"ftyp":
        return "m4a"
    if mp3_probe(data):
        return "mp3"
    return None


def decode_bytes(data: bytes, settings: Optional[Settings] = None,
                 hint: Optional[str] = None):
    """-> ([channels, frames] float32, sample_rate). Tries the hint format
    first, then probes (src/decoder/builder.rs:299-341)."""
    settings = settings or Settings()
    hint = hint or settings.hint
    tried = []
    if hint:
        fmt = _EXT_TO_FORMAT.get("." + hint.lstrip(".").lower(), hint)
        try:
            return _decode_as(fmt, data, settings)
        except Exception:
            tried.append(fmt)
    fmt = _probe(data)
    if fmt is None:
        # last resort: let ffmpeg probe (it recognizes far more containers)
        try:
            return _decode_as("ffmpeg", data, settings)
        except Exception:
            raise DecoderError("unrecognized audio format")
    if fmt in tried:
        raise DecoderError(f"failed to decode as {fmt}")
    return _decode_as(fmt, data, settings)


def _read_source(source):
    """(bytes, extension hint) of a path, bytes or a file object."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            return f.read(), os.path.splitext(str(source))[1]
    if isinstance(source, bytes):
        return source, None
    name = getattr(source, "name", None)
    return source.read(), (os.path.splitext(str(name))[1] if name else None)


class Decoder(SamplesBuffer):
    """Decoded audio as a source node on the device.

    Mirrors the reference Decoder surface (src/decoder/mod.rs:84-618):
    metadata (channels, rate, total_duration) and O(1) frame-accurate seek
    (``seek_state``), since the PCM is resident after ingest.
    """

    def __init__(self, source: Union[str, bytes, os.PathLike, _io.IOBase],
                 settings: Optional[Settings] = None, *, device: DeviceLike = None):
        settings = settings or Settings()
        data, hint = _read_source(source)
        pcm, rate = decode_bytes(data, settings, hint=hint)
        super().__init__(pcm.shape[0], rate, pcm, device=device)
        self.settings = settings

    @classmethod
    def try_from(cls, path, **kw) -> "Decoder":
        """(src/decoder/mod.rs:284)"""
        return cls(path, **kw)

    @classmethod
    def builder(cls) -> "DecoderBuilder":
        return DecoderBuilder()


class LoopedDecoder(Node):
    """Decoder that restarts at EOF forever (src/decoder/mod.rs:621-688).

    As in the JAX package, the buffer's zero tail holds the first
    ``min(PAD_FRAMES, frames)`` frames of the PCM again, so a block of up
    to that many frames reads ``pos + arange(n)`` straight across the wrap
    seam (``pos < frames`` always); a longer block gathers modulo
    ``frames``. Both are device gathers at a device position: nothing is
    read back.
    """

    RANDOM_ACCESS = True

    def __init__(self, source, settings: Optional[Settings] = None,
                 *, device: DeviceLike = None):
        inner = Decoder(source, settings, device=device)
        self.inner = inner
        self.spec = inner.spec
        self.device = inner.device
        self._frames = inner._frames
        self._pad = min(Decoder.PAD_FRAMES, self._frames)
        data = inner._data.clone()
        data[:, self._frames: self._frames + self._pad] = data[:, : self._pad]
        self._data = data

    def access_window(self, state: State):
        return state["pos"], torch.full((), 2**31 - 1, dtype=torch.int64,
                                        device=self.device)

    def gather_frames(self, state: State, idx: torch.Tensor) -> torch.Tensor:
        return state["data"][:, : self._frames][:, idx % self._frames]

    def total_frames(self) -> Optional[int]:
        return None

    def init_state(self) -> State:
        return {**self.inner.init_state(), "data": self._data}

    def emit(self, state: State, n: int):
        pos = state["pos"]
        idx = pos + torch.arange(n, device=self.device)
        if n > self._pad:
            idx = idx % self._frames
        block = state["data"][:, idx]
        return ({**state, "pos": (pos + n) % self._frames}, block,
                full_valid(n, self.device))


class DecoderBuilder:
    """Fluent builder (src/decoder/builder.rs:138); ``device`` is the
    decoded buffer's (the card unless ``"cpu"``)."""

    def __init__(self, *, device: DeviceLike = None):
        self._settings = Settings()
        self._data = None
        self._looped = False
        self._device = device

    def with_data(self, data) -> "DecoderBuilder":
        self._data = data
        return self

    def with_byte_len(self, n: int) -> "DecoderBuilder":
        self._settings.byte_len = n
        return self

    def with_gapless(self, enabled: bool) -> "DecoderBuilder":
        self._settings.gapless = enabled
        return self

    def with_hint(self, hint: str) -> "DecoderBuilder":
        self._settings.hint = hint
        return self

    def with_mime_type(self, mime: str) -> "DecoderBuilder":
        self._settings.mime_type = mime
        self._settings.hint = mime.rsplit("/", 1)[-1]
        return self

    def with_coarse_seek(self, enabled: bool) -> "DecoderBuilder":
        self._settings.coarse_seek = enabled
        return self

    def with_seekable(self, enabled: bool) -> "DecoderBuilder":
        self._settings.seekable = enabled
        return self

    def looped(self, enabled: bool = True) -> "DecoderBuilder":
        self._looped = enabled
        return self

    def build(self):
        if self._data is None:
            raise DecoderError("no data provided")
        cls = LoopedDecoder if self._looped else Decoder
        return cls(self._data, self._settings, device=self._device)
