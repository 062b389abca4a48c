"""Host-side uniformization of decoded streams.

The port's copy of ``rodio_tpu/io/uniform_host.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_io.py`` holds the two equal.

The reference runs every queued source through a UniformSourceIterator
(src/source/uniform.rs:33-145) — convert to a fixed (channels, rate)
forever, re-bootstrapping the converter at span boundaries
(src/source/span.rs:66-101). These wrappers apply the same semantics at
HOST decode time: `_UniformStream` lerp-resamples + rechannels a whole
stream to a target spec (the farm's heterogeneous-ingest path), and
`SpanUniformStream` keeps a chained container's output at its FIRST
link's spec by re-bootstrapping a fresh converter at every parameter
change FfStream reports (the per-packet span protocol).
"""
from __future__ import annotations

import numpy as np


def _rechannel_np(block: np.ndarray, to_channels: int) -> np.ndarray:
    """Positional channel up/down mix, numpy mirror of
    conversions/channels.py:rechannel_block (src/conversions/channels.rs
    semantics: mono->N duplicates ch0 into ch1, zero-fills ch>=2; N->M
    keeps the first M)."""
    fc = block.shape[0]
    if fc == to_channels:
        return block
    rows = []
    for c in range(to_channels):
        if c < fc:
            rows.append(block[c])
        elif c == 1 and fc == 1:
            rows.append(block[0])
        else:
            rows.append(np.zeros_like(block[0]))
    return np.stack(rows, axis=0)


class _UniformStream:
    """Host-side per-stream uniformization to (channels, rate) at farm
    ingest — the reference's UniformSourceIterator applied per source
    (src/source/uniform.rs:33-97): rational-lerp resample at the
    source's OWN channel count, then positional rechannel (the
    composition order of conversions/uniform.py).

    The resampler mirrors the engine's closed form
    (conversions/resample.py: left = c*fr + (fr*j)//to,
    frac = f32(((fr*j) % to) / to), out = (1-frac)*x_l + frac*x_r,
    plus the end-of-stream drain rule) in vectorized f32 numpy, so a
    heterogeneous farm matches per-stream engine Uniform chains to
    f32-rounding order (~1 ulp per lerp).

    Presents the FfStream surface the farm pool uses (read/seek/close,
    channels/sample_rate attributes).
    """

    def __init__(self, stream, channels: int, rate: int):
        import math

        self._s = stream
        self.channels = int(channels)
        self.sample_rate = int(rate)
        g = math.gcd(stream.sample_rate, rate)
        self._fr = stream.sample_rate // g
        self._to = rate // g
        self._reset()

    def _reset(self):
        self._o = 0            # next output frame index
        self._base = 0         # global input index of self._buf[:, 0]
        self._buf = np.zeros((self._s.channels, 0), np.float32)
        self._n_in = None      # total input frames, known at source EOF
        self._drained = False

    def _left(self, o: int) -> int:
        c, j = divmod(o, self._to)
        return c * self._fr + (self._fr * j) // self._to

    def read(self, n: int) -> np.ndarray:
        if self._fr == self._to:
            return _rechannel_np(self._s.read(n), self.channels)
        if self._drained or n <= 0:
            return np.zeros((self.channels, 0), np.float32)
        fr, to = self._fr, self._to
        o0 = self._o
        need_right = self._left(o0 + n - 1) + 1
        while (self._n_in is None
               and self._base + self._buf.shape[1] <= need_right):
            want = need_right - (self._base + self._buf.shape[1]) + 1
            blk = self._s.read(max(want, 8192))
            if blk.shape[1] < max(want, 8192):
                self._n_in = (self._base + self._buf.shape[1]
                              + blk.shape[1])
            if blk.shape[1]:
                self._buf = np.concatenate([self._buf, blk], axis=1)

        drain_tail = None
        if self._n_in is not None:
            from ..conversions.resample import _resample_counts

            n_full, has_drain = _resample_counts(self._n_in, fr, to)
            k = min(n, max(n_full - o0, 0))
            if (has_drain and o0 + k == n_full and k < n
                    and self._base + self._buf.shape[1] == self._n_in
                    and self._n_in > self._base):
                # drain rule (src/conversions/sample_rate.rs:192-200):
                # the final input frame is emitted once, unmodified
                drain_tail = self._buf[:, self._n_in - self._base - 1]
                self._drained = True
            elif k < n:
                self._drained = True
        else:
            k = n

        if k > 0:
            o = np.arange(o0, o0 + k, dtype=np.int64)
            c, j = np.divmod(o, to)
            left = c * fr + (fr * j) // to - self._base
            frac = ((fr * j) % to).astype(np.float32) / np.float32(to)
            xl = self._buf[:, left]
            xr = self._buf[:, left + 1]
            out = (np.float32(1.0) - frac)[None, :] * xl \
                + frac[None, :] * xr
            self._o = o0 + k
        else:
            out = np.zeros((self._s.channels, 0), np.float32)
        if drain_tail is not None:
            out = np.concatenate([out, drain_tail[:, None]], axis=1)
            self._o += 1
        # retire input below the next output's left neighbor
        new_base = self._left(self._o)
        if new_base > self._base:
            self._buf = self._buf[:, new_base - self._base :]
            self._base = new_base
        return _rechannel_np(np.ascontiguousarray(out), self.channels)

    def seek(self, seconds: float):
        """Demuxer-coarse seek + span restart (phase resets to 0, the
        reference's span re-bootstrap at a seek)."""
        self._s.seek(seconds)
        self._reset()

    def seek_accurate(self, seconds: float) -> int:
        """Accurate seek in OUTPUT time: map the output target to its
        left input neighbor via the resampler's closed form, seek the
        source sample-exactly there, and restart the converter phase at
        the target — so post-seek output frame o is computed from the
        same input frames (and the same lerp fraction) a from-zero
        render produces at o."""
        o0 = int(round(seconds * self.sample_rate))
        i0 = self._left(o0)
        if hasattr(self._s, "seek_accurate"):
            got = self._s.seek_accurate(frames=i0)
        else:
            self._s.seek(i0 / self._s.sample_rate)
            got = i0
        self._reset()
        self._o = o0
        self._base = got
        return o0

    def close(self):
        self._s.close()


class _SectionFence:
    """Present exactly ONE chain link of an FfStream as a complete
    stream: reads pass through until the underlying stream reports a
    span boundary (FfStream.read stops AT the boundary, so every block
    is pure single-section data), then report end-of-stream. The fired
    event is held for the owner."""

    def __init__(self, stream):
        self._s = stream
        self.channels = int(stream.channels)
        self.sample_rate = int(stream.sample_rate)
        self.fired = None

    def read(self, n: int) -> np.ndarray:
        if self.fired is not None:
            return np.zeros((self.channels, 0), np.float32)
        blk = self._s.read(n)
        ev = (self._s.take_param_change()
              if hasattr(self._s, "take_param_change") else None)
        if ev is not None:
            self.fired = ev
        return blk

    def seek(self, seconds: float):
        raise ValueError("sections of a chained stream do not seek")

    def close(self):
        pass


class SpanUniformStream:
    """Pin a chained container's output to its FIRST link's
    (channels, rate): when the underlying FfStream reports a span
    boundary (take_param_change), subsequent links are host-uniformized
    to the original spec with a FRESH converter — exactly the
    reference's span re-bootstrap (src/source/span.rs:66-101 resets the
    UniformSourceIterator's converter at each new span). Passthrough
    (zero copy) until the first boundary. Each section is fenced so a
    converter never reads across a boundary.
    """

    def __init__(self, stream):
        self._s = stream
        self.channels = int(stream.channels)
        self.sample_rate = int(stream.sample_rate)
        self.duration = getattr(stream, "duration", None)
        self._fence = _SectionFence(stream)
        self._conv = None  # None = first section (native spec)

    def read(self, n: int) -> np.ndarray:
        for _ in range(16):  # bounded: one retry per chain boundary
            src = self._conv if self._conv is not None else self._fence
            blk = src.read(n)
            if blk.shape[1]:
                return blk
            if self._fence.fired is None:
                return blk  # true end of stream
            # span boundary fully drained: re-bootstrap a fresh
            # converter from the NEW link's spec to the pinned one
            self._fence = _SectionFence(self._s)
            self._conv = _UniformStream(
                self._fence, self.channels, self.sample_rate
            )
        return np.zeros((self.channels, 0), np.float32)

    def seek(self, seconds: float):
        self._s.seek(seconds)
        self._fence = _SectionFence(self._s)
        self._conv = None

    def seek_accurate(self, seconds: float = None, *,
                      frames: int = None) -> int:
        """Sample-accurate seek (delegates to the decoder's coarse+skip
        refinement). Seeking lands in whatever chain link covers the
        target; if its spec differs from the pinned first-link spec, the
        next read fires the usual span re-bootstrap."""
        got = self._s.seek_accurate(seconds, frames=frames)
        self._fence = _SectionFence(self._s)
        self._conv = None
        return got

    def take_param_change(self):
        return None  # the whole point: the spec never changes

    def close(self):
        self._s.close()
