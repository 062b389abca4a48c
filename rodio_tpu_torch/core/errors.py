"""Typed error taxonomy (rodio_tpu/core/errors.py; src/source/mod.rs:763-811,
src/stream.rs, src/decoder/mod.rs DecoderError, src/play.rs PlayError).

The reference distinguishes recoverable control failures from broken
streams; the key contract is ``SeekError::source_intact``
(src/source/mod.rs:797-809): after a failed seek, is the source still
playing at its pre-seek position, or is it broken?
"""
from __future__ import annotations


class RodioTpuError(Exception):
    """Base for all framework errors."""


class SeekError(RodioTpuError):
    """A seek could not be performed (src/source/mod.rs:763-811).

    ``source_intact`` mirrors the reference's method: True means the
    chain keeps playing from its pre-seek position (nothing was
    modified); False means the underlying stream is broken.
    """

    def __init__(self, message: str, *, source_intact: bool):
        super().__init__(message)
        self.source_intact = source_intact


class SeekNotSupported(SeekError):
    """The source kind cannot seek (live inputs, unseekable streams):
    SeekError::NotSupported, always source-intact."""

    def __init__(self, source: str):
        super().__init__(f"seek not supported by {source}", source_intact=True)
        self.source = source


class PlayError(RodioTpuError):
    """Appending a sound to a sink failed (src/play.rs PlayError: decode
    failure or missing output stream)."""


class StreamError(RodioTpuError):
    """Opening or driving an output stream failed (src/stream.rs
    StreamError: no device, unsupported configuration, backend error)."""
