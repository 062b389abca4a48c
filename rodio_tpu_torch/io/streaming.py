"""Streaming ingest: the decode and feed pipeline for unbounded audio
(rodio_tpu/io/streaming.py).

The decoder facade loads a whole file onto the device; for very long or
live material this module streams instead, as the reference's realtime
path does: a host thread decodes into the native SPSC ring, the consumer
assembles blocks, and :class:`DeviceFeeder` copies block k+1 to the card
while block k is processed.

- :class:`StreamingWav`: incremental WAV reader (no full load);
- :class:`StreamingFeed`: any producer of PCM chunks through the ring;
- :class:`StreamingDecoder`: any format, WAV natively, the rest through
  the libav shim (``FfStream``);
- :class:`PushPort`: the device-side FIFO a host feed pushes into, with the
  random-access surface the resampler reads;
- :class:`DeviceFeeder`: two pinned host buffers and a side CUDA stream.

The host API stays numpy (``next_block`` returns ``[C, n]`` float32
arrays), as the JAX package's does; the mixer moves a hosted block to its
device (``utils.device.hosted_block``). The WAV header is parsed by a
helper that returns the spec, so two threads may open streams at once.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import BinaryIO, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.node import State, clip_valid, full_valid, mask_block
from ..core.types import StreamSpec, float_dtype
from ..utils.device import DeviceLike, resolve_device
from .native import SpscRing
from .wav import WAVE_FORMAT_EXTENSIBLE, WAVE_FORMAT_IEEE_FLOAT, WAVE_FORMAT_PCM, WavError


def _wav_header(f: BinaryIO) -> Optional[Tuple[int, int, int, int, int]]:
    """Parse a RIFF/WAVE header up to the start of its data chunk:
    ``(format tag, channels, rate, bits, data bytes)``, or None when the
    file has no data chunk. The file is left at the first data byte."""
    riff, _, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            return None
        cid, csz = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            fmt = f.read(csz)
            if csz % 2:
                f.read(1)
        elif cid == b"data":
            break
        else:
            f.seek(csz + (csz % 2), 1)
    if fmt is None:
        raise WavError("missing fmt chunk")
    tag, channels, rate, _br, _ba, bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == WAVE_FORMAT_EXTENSIBLE:
        tag = struct.unpack("<H", fmt[24:26])[0]
    return tag, channels, rate, bits, csz


def _wav_convert(buf: bytes, tag: int, bits: int, channels: int) -> np.ndarray:
    """Interleaved little-endian PCM bytes -> [channels, frames] f32."""
    if tag == WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        x = np.frombuffer(buf, dtype="<f4").astype(np.float32)
    elif tag == WAVE_FORMAT_PCM and bits == 16:
        x = np.frombuffer(buf, dtype="<i2").astype(np.float32) / 32768.0
    elif tag == WAVE_FORMAT_PCM and bits == 32:
        x = np.frombuffer(buf, dtype="<i4").astype(np.float32) / 2147483648.0
    elif tag == WAVE_FORMAT_PCM and bits == 24:
        raw = np.frombuffer(buf, dtype=np.uint8)
        n3 = len(raw) // 3
        raw = raw[: n3 * 3].reshape(n3, 3)
        v = (raw[:, 0].astype(np.int32)
             | (raw[:, 1].astype(np.int32) << 8)
             | (raw[:, 2].astype(np.int32) << 16))
        v = (v ^ 0x800000) - 0x800000
        x = v.astype(np.float32) / 8388608.0
    else:
        raise WavError(f"unsupported streaming format {tag}/{bits}")
    frames = len(x) // channels
    return x[: frames * channels].reshape(frames, channels).T


def _wav_stream_chunks(path: str, chunk_frames: int,
                       start_frames: int = 0) -> Iterator[np.ndarray]:
    """Yield [channels, chunk] f32 chunks from a WAV file incrementally.
    ``start_frames`` seeks sample-exactly into the data chunk (a byte
    offset: WAV is constant-rate PCM)."""
    with open(path, "rb") as f:
        header = _wav_header(f)
        if header is None:
            return
        tag, channels, _rate, bits, remaining = header
        frame_bytes = bits // 8 * channels
        if start_frames > 0:
            skip = min(start_frames * frame_bytes, remaining)
            f.seek(skip, 1)
            remaining -= skip
        while remaining >= frame_bytes:
            want = min(chunk_frames * frame_bytes, remaining)
            want -= want % frame_bytes
            buf = f.read(want)
            if len(buf) < frame_bytes:
                return
            remaining -= len(buf)
            yield _wav_convert(buf, tag, bits, channels)


def wav_stream_spec(path: str) -> StreamSpec:
    """Read just the header -> StreamSpec."""
    with open(path, "rb") as f:
        header = _wav_header(f)
    if header is None:
        raise WavError("missing data chunk")
    return StreamSpec(header[1], header[2])


class WavStream:
    """A PCM WAV file with ``FfStream``'s interface (``channels``,
    ``sample_rate``, ``duration``, ``read``, ``seek``, ``seek_accurate``,
    ``take_param_change``, ``close``), read incrementally from the file:
    the farm's host decode of WAV without libav. Every seek is an exact
    byte offset (WAV is constant-rate PCM), so ``seek`` is as accurate as
    ``seek_accurate``."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        header = _wav_header(self._f)
        if header is None:
            self._f.close()
            raise WavError(f"{path!r}: missing data chunk")
        self._tag, self.channels, self.sample_rate, self._bits, nbytes = header
        if self._bits not in (16, 24, 32):
            self._f.close()
            raise WavError(f"unsupported streaming format {self._tag}/{self._bits}")
        self._frame_bytes = self._bits // 8 * self.channels
        self._data0 = self._f.tell()
        self._frames = nbytes // self._frame_bytes
        self._pos = 0
        self.duration = self._frames / self.sample_rate

    def read(self, max_frames: int) -> np.ndarray:
        """Up to ``max_frames`` [channels, m] f32 frames (m == 0: the end)."""
        m = max(0, min(int(max_frames), self._frames - self._pos))
        buf = self._f.read(m * self._frame_bytes)
        m = len(buf) // self._frame_bytes
        self._pos += m
        if m == 0:
            return np.zeros((self.channels, 0), np.float32)
        return np.ascontiguousarray(_wav_convert(buf[: m * self._frame_bytes], self._tag,
                                                 self._bits, self.channels))

    def take_param_change(self):
        return None  # a WAV file has one span

    def seek(self, seconds: float) -> None:
        self.seek_accurate(seconds)

    def seek_accurate(self, seconds: float = None, *, frames: int = None) -> int:
        """Seek to ``frames`` (or round(seconds * rate)); returns the frame
        reached (the target, or the end of the file before it)."""
        target = int(frames) if frames is not None else int(round(float(seconds) * self.sample_rate))
        self._pos = max(0, min(target, self._frames))
        self._f.seek(self._data0 + self._pos * self._frame_bytes)
        return self._pos

    def close(self) -> None:
        self._f.close()


def open_stream(path: str):
    """A host decode stream with ``FfStream``'s interface: :class:`WavStream`
    for a ``.wav``/``.wave`` path, else ``FfStream`` (libav; raises
    ``LibavUnavailable`` where libav is missing)."""
    if os.path.splitext(str(path))[1].lower() in (".wav", ".wave"):
        return WavStream(path)
    from .native import FfStream

    return FfStream(path)


class StreamingFeed:
    """Producer thread -> SPSC ring -> block consumer.

    ``producer`` yields [channels, n] f32 chunks; a daemon thread pushes
    them interleaved into the ring (waiting while it is full) and ends the
    stream when the iterator ends. The consumer side is the microphone's
    host-driven block API (src/microphone.rs). ``close`` stops the thread.
    """

    POLL_SLEEP = 0.002

    def __init__(self, producer: Iterator[np.ndarray], spec: StreamSpec,
                 *, buffer_seconds: float = 0.5):
        self.spec = spec
        capacity = int(buffer_seconds * spec.sample_rate * spec.channels)
        self._ring = SpscRing(max(capacity, 4096))
        self._done = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(producer,), daemon=True
        )
        self._thread.start()

    def _run(self, producer):
        try:
            for chunk in producer:
                interleaved = np.ascontiguousarray(
                    np.asarray(chunk, np.float32).T.reshape(-1)
                )
                off = 0
                while off < len(interleaved):
                    if self._stop.is_set():
                        return
                    pushed = self._ring.push(interleaved[off:])
                    off += pushed
                    if pushed == 0:
                        time.sleep(self.POLL_SLEEP)  # ring full: wait for the consumer
        finally:
            self._done.set()

    def next_block(self, n: int):
        """One [channels, n] block: (block, alive). Blocks until n frames
        arrive or the producer has ended; the tail is zero-filled, and
        ``alive`` is False once the stream has ended and the ring is
        empty."""
        c = self.spec.channels
        want = n * c
        out = np.zeros(want, dtype=np.float32)
        got = 0
        while got < want:
            chunk = self._ring.pop(want - got)
            if len(chunk):
                out[got : got + len(chunk)] = chunk
                got += len(chunk)
                continue
            if self._done.is_set() and len(self._ring) == 0:
                break
            time.sleep(self.POLL_SLEEP)
        if got == 0:
            return out.reshape(n, c).T, False
        return np.ascontiguousarray(out.reshape(n, c).T), True

    def close(self, timeout: float = 2.0) -> None:
        """Stop the producer thread (it ends at its next chunk or push)."""
        self._stop.set()
        self._thread.join(timeout)


class StreamingWav(StreamingFeed):
    """Incremental WAV playback source: O(ring) memory for any file length."""

    def __init__(self, path: str, *, chunk_frames: int = 8192,
                 buffer_seconds: float = 0.5):
        spec = wav_stream_spec(path)
        super().__init__(
            _wav_stream_chunks(path, chunk_frames), spec,
            buffer_seconds=buffer_seconds,
        )


class StreamingDecoder(StreamingFeed):
    """Incremental decode of any supported format at O(packet) memory, the
    streaming counterpart of :class:`~rodio_tpu_torch.io.decoder.Decoder`.
    WAV streams through the native RIFF reader; every compressed format
    (flac, mp3, ogg, opus, m4a) through the libav shim
    (``native/ffdec.cpp``), which raises ``LibavUnavailable`` where libav
    is missing (src/decoder/symphonia.rs:336-417).

    ``start_at``/``loop``: a sample-accurate seek before the first chunk
    (src/decoder/symphonia.rs:225-330; byte-exact for WAV) and a restart at
    the end of the stream.
    """

    def __init__(self, path: str, *, chunk_frames: int = 8192,
                 buffer_seconds: float = 0.5, start_at: float = 0.0,
                 loop: bool = False):
        ext = os.path.splitext(str(path))[1].lower()
        if ext in (".wav", ".wave"):
            spec = wav_stream_spec(path)
            start_frames = int(round(start_at * spec.sample_rate))
            if not (start_at or loop):
                producer = _wav_stream_chunks(path, chunk_frames)
            else:
                def producer_gen():
                    first = start_frames
                    while True:
                        yielded = False
                        for blk in _wav_stream_chunks(
                                path, chunk_frames, start_frames=first):
                            yielded = True
                            yield blk
                        if not loop or (not yielded and first == 0):
                            return
                        first = 0

                producer = producer_gen()
        else:
            from .native import FfStream
            from .uniform_host import SpanUniformStream

            # chained containers (multi-link ogg) re-bootstrap to the first
            # link's spec at every span boundary (src/source/span.rs:66-101)
            stream = SpanUniformStream(FfStream(path))
            spec = StreamSpec(stream.channels, stream.sample_rate)
            if start_at:
                stream.seek_accurate(start_at)

            def producer_gen():
                s = stream
                while True:
                    blk = s.read(chunk_frames)
                    if blk.shape[1] == 0:
                        if not loop:
                            s.close()
                            return
                        s.seek(0.0)
                        continue
                    yield blk

            producer = producer_gen()
        super().__init__(producer, spec, buffer_seconds=buffer_seconds)


def _slice_start(i: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Where JAX's ``dynamic_slice``/``dynamic_update_slice`` put a window
    of ``size`` at start ``i`` along a dimension of ``dim``: a negative
    start counts from the end, then the window is clamped inside."""
    i = torch.where(i < 0, i + dim, i)
    return torch.clamp(i, 0, dim - size)


class PushPort:
    """Device-resident sliding input window: the device end of a host feed,
    with the random-access surface (``access_window``, ``slice_frames``,
    ``gather_frames``) the resampler reads, and a sequential ``emit``.

    The buffer holds frames [base, base + level) of the global stream. The
    host appends fixed-shape [C, push_frames] blocks (``count`` of them
    valid) and retires consumed frames (``retire``) in the same
    :meth:`push`. All bookkeeping is 0-dim device tensors, so a push and an
    emit never wait for the card: the shift by a device ``retire`` is a
    gather at ``retire + arange(capacity)`` into the buffer padded by
    ``push_frames`` zeros (``torch.roll`` takes no tensor shift), the
    append an ``index_copy`` at the device ``level``. Both place their
    offsets as ``dynamic_slice``/``dynamic_update_slice`` do in the JAX
    package (:func:`_slice_start`), so even an overflowing script keeps
    the same buffer.

    ``overflow`` (a push past the capacity, or a retire past the level or
    the push size), ``underflow`` (a live pull past the level, answered
    with zeros) and ``ended`` are device booleans.
    """

    RANDOM_ACCESS = True
    #: live input: no seekable past (core/errors.py SeekNotSupported)
    LIVE = True

    def __init__(self, channels: int, sample_rate: int, capacity: int,
                 push_frames: int, *, device: DeviceLike = None):
        self.spec = StreamSpec(channels, sample_rate)
        self.device = resolve_device(device)
        #: the sample type when the port was built
        self.dtype = float_dtype()
        self.capacity = int(capacity)
        self.push_frames = int(push_frames)
        #: the resampler's window-eligibility bound (resample.py reads it):
        #: the host feed keeps requested windows inside the buffer
        self.PAD_FRAMES = int(capacity)
        if capacity < 2 * push_frames:
            raise ValueError(f"capacity {capacity} < 2 * push_frames {push_frames}")

    def total_frames(self):
        return None

    def _i64(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(torch.int64)
        return torch.full((), int(v), dtype=torch.int64, device=self.device)

    def init_state(self) -> State:
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        false = torch.zeros((), dtype=torch.bool, device=self.device)
        return {
            "buf": torch.zeros((self.spec.channels, self.capacity),
                               dtype=self.dtype, device=self.device),
            "base": zero, "level": zero.clone(),
            "overflow": false, "underflow": false.clone(), "ended": false.clone(),
        }

    def push(self, state: State, block: torch.Tensor, count, retire=0) -> State:
        """Drop ``retire`` frames from the front (consumed for good), then
        append ``count`` valid frames of ``block`` [C, push_frames]
        (``count`` and ``retire``: host ints or 0-dim device tensors)."""
        dev, cap, pf = self.device, self.capacity, self.push_frames
        retire = self._i64(retire)
        buf = state["buf"]
        ext = torch.cat([buf, torch.zeros((buf.shape[0], pf), dtype=buf.dtype,
                                          device=dev)], dim=1)
        start = _slice_start(retire, cap + pf, cap)
        buf = ext[:, start + torch.arange(cap, device=dev)]
        level = state["level"] - retire
        at = _slice_start(level, cap, pf) + torch.arange(pf, device=dev)
        buf = buf.index_copy(1, at, block.to(buf.dtype))
        overflow = (state["overflow"] | (level + pf > cap)
                    | (retire > state["level"]) | (retire > pf))
        return {**state, "buf": buf, "base": state["base"] + retire,
                "level": level + count, "overflow": overflow}

    def end(self, state: State) -> State:
        return {**state, "ended": torch.ones((), dtype=torch.bool, device=self.device)}

    # -- the random-access surface (the resampler) --

    def access_window(self, state: State):
        """(origin, frames available from it). While live the stream is
        unbounded (2^30), so downstream drain logic never fires; once
        ended, the true total."""
        total = state["base"] + state["level"]
        live = torch.full((), 2**30, dtype=torch.int64, device=self.device)
        return (torch.zeros((), dtype=torch.int64, device=self.device),
                torch.where(state["ended"], total, live))

    def slice_frames(self, state: State, start, length: int) -> torch.Tensor:
        local = torch.clamp(start - state["base"], 0, self.capacity - length)
        return state["buf"][:, local + torch.arange(length, device=self.device)]

    def gather_frames(self, state: State, idx: torch.Tensor) -> torch.Tensor:
        """Frames at global indices ``idx``; zero outside the buffer. As
        ``jnp.take(mode="fill")`` does, a local index in [-capacity, 0)
        counts from the end."""
        cap = self.capacity
        local = idx - state["base"]
        local = torch.where(local < 0, local + cap, local)
        inside = (local >= 0) & (local < cap)
        out = state["buf"][:, torch.clamp(local, 0, cap - 1)]
        return torch.where(inside[None, :], out, torch.zeros_like(out))

    # -- the sequential pull surface (identity-rate consumers) --

    def emit(self, state: State, n: int):
        buf, level, ended = state["buf"], state["level"], state["ended"]
        valid = torch.where(ended, clip_valid(level, n), full_valid(n, self.device))
        i = torch.arange(n, device=self.device)
        out = torch.where(i[None, :] < level, buf[:, :n], torch.zeros_like(buf[:, :n]))
        out = mask_block(out, valid)
        # a live pull past the buffered level substitutes zeros: flagged,
        # as ``overflow`` is, so an underrun is observable
        underflow = state["underflow"] | (~ended & (level < n))
        return ({**state, "buf": torch.roll(buf, -n, dims=1), "base": state["base"] + n,
                 "level": torch.clamp(level - n, min=0), "underflow": underflow},
                out, valid)


class PinnedStager:
    """Host arrays to the card through two pinned buffers and a side stream,
    with no wait for the card: a pinned buffer is refilled only after its
    previous copy's event has completed (polled), the copy runs on the side
    stream into a tensor allocated there, and :meth:`take` makes the
    consumer's stream wait on the copy's event and keeps the tensor alive
    for it (``record_stream``). On the CPU it hands out the array as a
    tensor."""

    POLL_SLEEP = 50e-6

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)
            self._pinned = [torch.empty(self.shape, dtype=dtype, pin_memory=True)
                            for _ in range(2)]
            self._copied: list = [None, None]  # each pinned buffer's last copy
            self._slot = 0

    def stage(self, block: np.ndarray) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Start ``block``'s copy: (the device tensor, its copy's event)."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.array(block)).to(self.dtype), None
        if tuple(block.shape) != self.shape:
            raise ValueError(f"staged block {tuple(block.shape)}, expected {self.shape}")
        slot = self._slot
        self._slot ^= 1
        done = self._copied[slot]
        while done is not None and not done.query():
            time.sleep(self.POLL_SLEEP)
        self._pinned[slot].numpy()[...] = block
        with torch.cuda.stream(self._stream):
            out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
            out.copy_(self._pinned[slot], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._copied[slot] = event
        return out, event

    def take(self, staged) -> torch.Tensor:
        """The staged tensor, ready for the consumer's (current) stream."""
        block, event = staged
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            block.record_stream(consumer)
        return block


class DeviceFeeder:
    """Double-buffered host-to-device block feed.

    Wraps a host-driven source (``next_block(n) -> ([C, n] numpy,
    alive)``); :meth:`next_device_block` hands out block k while block
    k+1's copy is already in flight. On the card:

    - each host block is staged in one of two pinned buffers, and a pinned
      buffer is refilled only after its previous copy's event has
      completed (a refill in flight would corrupt samples silently);
    - the copy runs on a side stream with ``non_blocking=True`` into a
      tensor allocated on that stream, and records an event;
    - at hand-out the consumer's stream waits on that event, and
      ``record_stream`` keeps the tensor alive until the consumer is done.

    Nothing here waits for the card: the event is polled. With
    ``device="cpu"`` it hands out CPU tensors and uses no stream.
    """

    def __init__(self, host_source, block_frames: int, *, device: DeviceLike = None):
        self.source = host_source
        self.block_frames = int(block_frames)
        self.device = resolve_device(device)
        self._stager = PinnedStager((host_source.spec.channels, self.block_frames),
                                    torch.float32, self.device)
        self._stream = getattr(self._stager, "_stream", None)  # the side stream
        self._pending = None
        self._alive = True
        self._prefetch()

    def _prefetch(self):
        if not self._alive:
            self._pending = None
            return
        block, alive = self.source.next_block(self.block_frames)
        self._alive = alive
        self._pending = (self._stager.stage(np.asarray(block, np.float32))
                         if alive else None)

    def next_device_block(self):
        """-> (block [C, block_frames] on the device, alive). The next
        block's copy starts before this one is consumed."""
        if self._pending is None:
            c = self.source.spec.channels
            return torch.zeros((c, self.block_frames), dtype=torch.float32,
                               device=self.device), False
        block = self._stager.take(self._pending)
        self._prefetch()
        return block, True
