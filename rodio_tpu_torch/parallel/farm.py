"""Streaming stream farm: N distinct files -> incremental host decode ->
a device-resident feed -> the wide-channel chain, at constant memory
(rodio_tpu/parallel/farm.py).

  [host]  N decode streams (WAV read directly, other formats through
            libav's FfStream), refilled by a worker pool into per-stream
            FIFOs -> [N*C, push] wide blocks, stream-major rows
  [wire]  f32, or i16 / i24 integers (half or three quarters of the bytes)
            through two pinned buffers and a side CUDA stream
  [card]  fused: ChunkRingFeed -> FusedFarmPipeline (K1 in ring mode) -> Limit
          unfused: PushPort -> Resample -> BltFilter -> Amplify -> WideMixer
            -> Limit

The host assembles block k+1 while the card runs block k: nothing in a
step waits for the card, and the host reads the card back once every 32
blocks and at the end (the JAX farm bounds its dispatch queue the same
way). Device memory is the feed, the chain's state and two staged blocks,
whatever the run's length; host memory a few chunks a stream.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import logging
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.types import StreamSpec
from ..io.uniform_host import SpanUniformStream, _UniformStream
from ..utils.device import DeviceLike, resolve_device

WIRES = ("f32", "i16", "i24")


def _find_state_with(state, keys):
    """The key path (through "in" links) to the innermost dict of the
    nested node states that holds all of ``keys``."""
    path = []
    cur = state
    while isinstance(cur, dict):
        if all(k in cur for k in keys):
            return path
        if "in" not in cur:
            break
        path.append("in")
        cur = cur["in"]
    raise KeyError(f"state with keys {keys} not found in the chain state")


def _find_port_state(state):
    """Path to the PushPort's dict (the FIFO keys)."""
    return _find_state_with(state, ("buf", "level", "overflow"))


def _find_feed_state(state):
    """Path to the ChunkRingFeed's dict."""
    return _find_state_with(state, ("ring", "w", "gain"))


def _get_path(state, path):
    for k in path:
        state = state[k]
    return state


def _set_path(state, path, value):
    if not path:
        return value
    return {**state, path[0]: _set_path(state[path[0]], path[1:], value)}


def _wire_encode(block: np.ndarray, wire: str) -> np.ndarray:
    """Host-side wire encode: i16 (exact for 16-bit-grid content), i24
    (little-endian 3-byte two's complement, uint8 [..., 3]; exact for 16-
    and 24-bit-grid content), or f32 as it is."""
    if wire == "i16":
        return np.clip(block * 32768.0, -32768, 32767).astype(np.int16)
    if wire == "i24":
        q = np.clip(np.rint(block * 8388608.0), -8388608, 8388607).astype("<i4")
        return np.ascontiguousarray(q.view(np.uint8).reshape(*q.shape, 4)[..., :3])
    return block


def _wire_decode(block: torch.Tensor, wire: str) -> torch.Tensor:
    """Device-side wire decode (torch ops on the block's device) back to
    f32; every step exact."""
    if wire == "i16":
        return block.to(torch.float32) * (1.0 / 32768.0)
    if wire == "i24":
        b = block.to(torch.int32)
        v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        v = (v ^ 0x800000) - 0x800000  # sign-extend 24 -> 32
        return v.to(torch.float32) * (1.0 / 8388608.0)
    return block


def _wire_staging(wire: str, rows: int, frames: int):
    """(shape, dtype) of an encoded [rows, frames] block."""
    if wire == "i16":
        return (rows, frames), torch.int16
    if wire == "i24":
        return (rows, frames, 3), torch.uint8
    return (rows, frames), torch.float32


class _SyncDebug:
    """torch.cuda's sync-debug mode "error" (a device wait raises) over a
    run's blocks from the second on (the first builds its shapes' cached
    tables, K3's powers and K1's taps, with a copy to the card), but the
    deliberate read-backs (:meth:`readback`). A no-op when not ``on``."""

    def __init__(self, on: bool):
        self.on, self.armed = on, False

    def block(self, k: int):
        if self.on and k == 1:
            torch.cuda.set_sync_debug_mode("error")
            self.armed = True

    def readback(self, value: torch.Tensor) -> int:
        if self.armed:
            torch.cuda.set_sync_debug_mode("default")
        try:
            return int(value)
        finally:
            if self.armed:
                torch.cuda.set_sync_debug_mode("error")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.armed:
            torch.cuda.set_sync_debug_mode("default")
            self.armed = False


def _corpus_spec(specs, out_rate: int):
    """(channels, rate, uniformize) of a corpus with these (channels, rate)
    specs: as it is when they agree, else the most channels at
    ``out_rate``, each stream uniformized."""
    if len(specs) == 1:
        (C, rate), = specs
        return C, rate, False
    return max(c for c, _ in specs), out_rate, True


class HostDecodePool:
    """N files -> per-stream host FIFOs refilled by a worker pool, with a
    sample-accurate per-stream seek: the host half of the farm, shared by
    :class:`StreamFarm` and the sharded farm. A ``.wav`` path streams
    through :class:`~rodio_tpu_torch.io.streaming.WavStream`, any other
    through libav's ``FfStream`` (``LibavUnavailable`` without libav).
    Files of another (channels, rate) than the corpus's largest channel
    count at ``out_rate`` are uniformized per stream at ingest (the
    reference runs every queued source through a UniformSourceIterator,
    src/source/uniform.rs:33); ``spec_rule(specs, out_rate) -> (channels,
    rate, uniformize)`` decides that for a corpus wider than the pool (the
    sharded farm's, whose ranks each open a slice)."""

    def __init__(self, paths: Sequence[str], *, out_rate: int,
                 chunk_frames: int = 8192, decode_workers: int = 8,
                 start_offsets: Optional[Sequence[float]] = None,
                 loop: bool = True, spec_rule=None):
        from ..io.streaming import open_stream

        self.paths = list(paths)
        S = len(self.paths)
        self._streams: List = []
        for i, p in enumerate(self.paths):
            # SpanUniformStream pins chained containers to their first
            # link's spec (span re-bootstrap at every boundary)
            s = SpanUniformStream(open_stream(p))
            if start_offsets is not None and start_offsets[i]:
                s.seek_accurate(start_offsets[i])
            self._streams.append(s)
        specs = {(s.channels, s.sample_rate) for s in self._streams}
        C, in_rate, uniformize = (spec_rule or _corpus_spec)(specs, out_rate)
        if uniformize:
            # each stream lerp-resampled once on the host straight to the
            # farm's rate and rechanneled, so the card runs identity-rate
            self._streams = [
                _UniformStream(s, C, out_rate)
                if (s.channels, s.sample_rate) != (C, out_rate) else s
                for s in self._streams
            ]
        self.spec_in = StreamSpec(C, in_rate)
        self.n_streams = S
        self.loop = loop
        self.chunk_frames = chunk_frames
        self._fifos = [collections.deque() for _ in range(S)]
        self._fifo_frames = [0] * S
        self._fifo_lock = threading.Condition()
        self._alive = [True] * S
        self._inflight = set()
        self._pool = cf.ThreadPoolExecutor(max_workers=max(1, decode_workers))

    def _refill_one(self, i: int):
        # a decode or seek error ends the stream (the reference skips decode
        # errors, src/decoder/symphonia.rs:366-372); the finally always
        # clears the in-flight mark, or _pop_frames would wait forever
        blk = None
        try:
            s = self._streams[i]
            blk = s.read(self.chunk_frames)
            if blk.shape[1] < self.chunk_frames and self.loop:
                parts = [blk]
                got = blk.shape[1]
                while got < self.chunk_frames:
                    s.seek(0.0)
                    more = s.read(self.chunk_frames - got)
                    if more.shape[1] == 0:
                        break
                    parts.append(more)
                    got += more.shape[1]
                blk = np.concatenate(parts, axis=1)
        except Exception:
            logging.getLogger("rodio_tpu_torch.farm").warning(
                "stream %d refill failed; marking it ended", i, exc_info=True)
        finally:
            with self._fifo_lock:
                if blk is not None and blk.shape[1]:
                    self._fifos[i].append(blk)
                    self._fifo_frames[i] += blk.shape[1]
                else:
                    self._alive[i] = False
                self._inflight.discard(i)
                self._fifo_lock.notify_all()

    def schedule_refills(self, threshold: int):
        with self._fifo_lock:
            todo = [i for i in range(self.n_streams)
                    if self._alive[i] and i not in self._inflight
                    and self._fifo_frames[i] < threshold]
            self._inflight.update(todo)
        for i in todo:
            self._pool.submit(self._refill_one, i)

    def _pop_frames(self, i: int, n: int) -> np.ndarray:
        """Exactly n frames of stream i, waiting while a live stream's
        refill is in flight (the feed never substitutes silence for late
        decode); an ended stream pads with zeros."""
        parts = []
        got = 0
        with self._fifo_lock:
            while got < n:
                while self._fifo_frames[i] == 0 and self._alive[i]:
                    if i not in self._inflight:
                        self._inflight.add(i)
                        self._pool.submit(self._refill_one, i)
                    self._fifo_lock.wait(timeout=10.0)
                if self._fifo_frames[i] == 0:
                    break  # stream ended
                blk = self._fifos[i][0]
                take = min(n - got, blk.shape[1])
                parts.append(blk[:, :take])
                if take == blk.shape[1]:
                    self._fifos[i].popleft()
                else:
                    self._fifos[i][0] = blk[:, take:]
                self._fifo_frames[i] -= take
                got += take
        if got < n:
            parts.append(np.zeros((self.spec_in.channels, n - got), np.float32))
        return np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]

    def prime(self):
        """Fill the host FIFOs before the first step (waits for it)."""
        with self._fifo_lock:
            todo = [i for i in range(self.n_streams) if i not in self._inflight]
            self._inflight.update(todo)
        cf.wait([self._pool.submit(self._refill_one, i) for i in todo])

    def assemble_frames(self, n: int) -> np.ndarray:
        """[S*C, n] wide block from the per-stream FIFOs (stream-major rows)."""
        C = self.spec_in.channels
        out = np.empty((self.n_streams * C, n), np.float32)
        for i in range(self.n_streams):
            out[i * C:(i + 1) * C] = self._pop_frames(i, n)
        return out

    def try_seek(self, stream: int, seconds: float) -> int:
        """Sample-accurate live seek of one stream (src/source/mod.rs
        try_seek): drops its host FIFO and repositions its decoder; frames
        already pushed to the card play out first. Returns the frame
        reached; a failed seek ends the stream (the farm goes on)."""
        with self._fifo_lock:
            while stream in self._inflight:
                self._fifo_lock.wait(timeout=10.0)
            self._inflight.add(stream)  # no refill during the seek
            self._fifos[stream].clear()
            self._fifo_frames[stream] = 0
        got = -1
        ok = False
        try:
            s = self._streams[stream]
            if hasattr(s, "seek_accurate"):
                got = s.seek_accurate(seconds)
            else:
                s.seek(seconds)
                got = int(round(seconds * self.spec_in.sample_rate))
            ok = True
        except Exception:
            logging.getLogger("rodio_tpu_torch.farm").warning(
                "stream %d seek(%s) failed; marking it ended", stream, seconds,
                exc_info=True)
        finally:
            with self._fifo_lock:
                self._inflight.discard(stream)
                self._alive[stream] = ok
                self._fifo_lock.notify_all()
        return got

    def close(self):
        self._pool.shutdown(wait=False)
        for s in self._streams:
            s.close()


class StreamFarm:
    """N file paths -> one mixed stereo output through streaming decode
    (BASELINE config 5 fed live).

    ``start_offsets`` staggers each stream's start (a sample-accurate
    seek); ``loop`` restarts a stream at its end. ``wire``: the host ->
    card format, "f32" (exact), "i16" (half the bytes, exact for 16-bit
    content) or "i24" (exact for 16- and 24-bit content). ``fused=True``
    runs K1 in ring mode over a :class:`~rodio_tpu_torch.flagship.ChunkRingFeed`
    (blocks a multiple of 2*to; the identity ratio is refused, ROADMAP
    F3), else the unfused chain on a PushPort. The device runs on the card
    unless ``device="cpu"``.
    """

    def __init__(self, paths: Sequence[str], *, out_rate: int = 48000,
                 block_frames: int = 4096, gains=None,
                 low_pass: Optional[float] = 2000.0,
                 start_offsets: Optional[Sequence[float]] = None,
                 loop: bool = True, chunk_frames: int = 8192,
                 decode_workers: int = 8, wire: str = "f32",
                 fused: bool = False, device: DeviceLike = None):
        from ..conversions.resample import Resample
        from ..effects.basic import Amplify
        from ..effects.blt import BltFilter
        from ..effects.limit import Limit, LimitSettings
        from ..flagship import ChunkRingFeed, FusedFarmPipeline
        from ..io.streaming import PushPort
        from .batch import WideMixer

        if wire not in WIRES:
            raise ValueError(f"wire must be one of {WIRES}, got {wire!r}")
        self.device = resolve_device(device)
        self._host = HostDecodePool(
            paths, out_rate=out_rate, chunk_frames=chunk_frames,
            decode_workers=decode_workers, start_offsets=start_offsets, loop=loop)
        self.paths = self._host.paths
        self._streams = self._host._streams
        self.spec_in = self._host.spec_in
        C, in_rate = self.spec_in.channels, self.spec_in.sample_rate
        S = self._host.n_streams
        self.n_streams = S
        self.loop = loop
        self.chunk_frames = chunk_frames
        self.block_frames = block_frames
        self.wire = wire
        # the port window covers the resampler's window of a block (K =
        # n // to + 2 chunks of fr frames and a boundary frame)
        g = int(np.gcd(in_rate, out_rate))
        fr, to = in_rate // g, out_rate // g
        self._fr, self._to = int(fr), int(to)
        if fr != to:
            self._push = (block_frames // to + 2) * fr + 1
            capacity = self._push + (block_frames // to + 4) * fr
        else:
            self._push = block_frames
            capacity = 4 * block_frames
        if gains is None:
            gains = np.full(S, 1.0 / S, np.float32)
        gains = np.asarray(gains, np.float32)
        per_lane = np.repeat(gains, C) if gains.shape == (S,) else gains
        self.fused = bool(fused)
        self.port = self.feed = None
        if fused:
            m = 2
            if fr == to or to < 2:
                raise ValueError("fused farm needs a non-identity rational rate ratio")
            if block_frames % (m * to):
                raise ValueError(f"fused farm block must be a multiple of {m * to}")
            self._Kp = block_frames // to
            # the JAX farm keeps the i16 wire's ring raw in its lossless
            # int2 layout with the gains after the lerp; here the ring is
            # f32 and K1 applies the gains after the lerp on every wire
            self.feed = ChunkRingFeed(
                S * C, in_rate, fr, self._Kp, 4 * self._Kp,
                "int2" if wire == "i16" else "int3", per_lane,
                gain_post=wire == "i16", device=self.device)
            self._push = self._Kp * fr
            pipe = FusedFarmPipeline(
                self.feed, out_rate, S, "low_pass" if low_pass is not None else None,
                low_pass if low_pass is not None else 2000.0, 0.5, m=m)
            self.master = Limit(pipe, LimitSettings(), mode="auto")
        else:
            self.port = PushPort(S * C, in_rate, capacity, self._push, device=self.device)
            chain = Resample(self.port, out_rate, max_block=block_frames)
            if low_pass is not None:
                chain = BltFilter(chain, "low_pass", low_pass, 0.5)
            chain = Amplify(chain, per_lane)
            chain = WideMixer(chain, S)
            self.master = Limit(chain, LimitSettings(), mode="auto")
        self._port_path = None

    # ---- host decode side (HostDecodePool) ----

    def try_seek(self, stream: int, seconds: float) -> int:
        """See :meth:`HostDecodePool.try_seek`."""
        return self._host.try_seek(stream, seconds)

    def _encode(self, block: np.ndarray) -> np.ndarray:
        return _wire_encode(block, self.wire)

    def _to_device(self, enc: np.ndarray) -> torch.Tensor:
        """A one-off (set-up) copy of an encoded block to the card."""
        return torch.from_numpy(np.ascontiguousarray(enc)).to(self.device)

    def _stager(self, frames: int):
        from ..io.streaming import PinnedStager

        shape, dtype = _wire_staging(self.wire, self.n_streams * self.spec_in.channels,
                                     frames)
        return PinnedStager(shape, dtype, self.device)

    # ---- device side ----

    def init_state(self):
        state = self.master.init_state()
        self._port_path = (_find_feed_state(state) if self.fused
                           else _find_port_state(state))
        return state

    def _push_fused(self, state, blk: torch.Tensor, prime: bool = False):
        fs = _get_path(state, self._port_path)
        fs = self.feed.push(fs, _wire_decode(blk, self.wire), prime=prime)
        return _set_path(state, self._port_path, fs)

    def _push_port(self, state, blk: torch.Tensor, count: int, retire: int):
        ps = _get_path(state, self._port_path)
        ps = self.port.push(ps, _wire_decode(blk, self.wire), count, retire)
        return _set_path(state, self._port_path, ps)

    def _want_total(self, k: int) -> int:
        """Cumulative feed target before emitting block k: the resampler's
        input window end for that block."""
        n = self.block_frames
        fr, to = self._fr, self._to
        if fr == to:
            return (k + 1) * n
        return (k * n // to + n // to + 2) * fr + 1

    def _low_water(self, k: int) -> int:
        """First input frame block k's window can still touch."""
        if self._fr == self._to:
            return k * self.block_frames
        return (k * self.block_frames // self._to) * self._fr

    def _next_push(self, k: int, pushed_total: int):
        """The push accompanying block k's step: enough frames that the
        cumulative feed covers the next block's window."""
        count = min(max(self._want_total(k) - pushed_total, 0), self._push)
        out = np.zeros((self.n_streams * self.spec_in.channels, self._push), np.float32)
        C = self.spec_in.channels
        if count:
            for i in range(self.n_streams):
                out[i * C:(i + 1) * C, :count] = self._host._pop_frames(i, count)
        return out, count

    def run(self, n_blocks: int, *, on_block=None, spans=None, sync_debug: bool = False):
        """Drive n_blocks; returns (total valid frames, energy, overflow).

        ``on_block(k, out, valid)`` sees each block (a read there waits for
        the card). ``spans`` (a :class:`~rodio_tpu_torch.utils.trace.FarmSpans`)
        times each block's host assembly, push and emit. ``sync_debug``
        runs every step but the first under sync-debug "error", the 32-block
        read-backs aside (on the card)."""
        sync_debug = sync_debug and self.device.type == "cuda"
        spans = spans if spans is not None else _NO_SPANS
        if self.fused:
            return self._run_fused(n_blocks, on_block, spans, sync_debug)
        self._host.prime()
        state = self.init_state()
        stager = self._stager(self._push)
        pushed_total = 0
        base = 0  # the host's mirror of the port's window base
        # prime the window up to block 0's horizon; a push a block then
        # keeps pace
        while pushed_total < self._want_total(0):
            block, count = self._next_push(0, pushed_total)
            pushed_total += count
            state = self._push_port(state, self._to_device(self._encode(block)), count, 0)
        block, count = self._next_push(1, pushed_total)
        pushed_total += count
        nxt = stager.stage(self._encode(block))
        retire = 0
        n = self.block_frames
        energy_acc = torch.zeros((), device=self.device)
        valid_acc = torch.zeros((), dtype=torch.int64, device=self.device)
        with _SyncDebug(sync_debug) as sd:
            for k in range(n_blocks):
                sd.block(k)
                self._host.schedule_refills(threshold=2 * self._push)
                with spans.span("push"):
                    state = self._push_port(state, stager.take(nxt), count, retire)
                with spans.span("emit"):
                    state, out, valid = self.master.emit(state, n)
                if k + 1 < n_blocks:
                    with spans.host("assemble"):
                        block, count = self._next_push(k + 2, pushed_total)
                        enc = self._encode(block)
                    pushed_total += count
                    nxt = stager.stage(enc)
                    # frames below block k+1's window are consumed
                    if self._fr != self._to:
                        retire = max(self._low_water(k + 1) - base, 0)
                        base += retire
                if on_block is not None:
                    on_block(k, out, valid)
                valid_acc = valid_acc + valid
                energy_acc = energy_acc + torch.sum(out * out)
                if (k + 1) % 32 == 0:
                    sd.readback(valid_acc)  # bound the queue
        return self._finish(state, valid_acc, energy_acc)

    def _run_fused(self, n_blocks: int, on_block, spans, sync_debug: bool):
        """Every host block pushes exactly Kp chunks into the ring; K1 reads
        it modulo its rows: no retire bookkeeping."""
        self._host.prime()
        state = self.init_state()
        fr, Kp, n = self._fr, self._Kp, self.block_frames
        # the first push, (Kp+1)*fr frames: chunks 0..Kp-1 and the tail
        first = self._encode(self._host.assemble_frames((Kp + 1) * fr))
        state = self._push_fused(state, self._to_device(first), prime=True)
        stager = self._stager(self._push)
        nxt = stager.stage(self._encode(self._host.assemble_frames(self._push)))
        energy_acc = torch.zeros((), device=self.device)
        valid_acc = torch.zeros((), dtype=torch.int64, device=self.device)
        with _SyncDebug(sync_debug) as sd:
            for k in range(n_blocks):
                sd.block(k)
                self._host.schedule_refills(threshold=2 * self._push)
                with spans.span("push"):
                    state = self._push_fused(state, stager.take(nxt))
                with spans.span("emit"):
                    state, out, valid = self.master.emit(state, n)
                if k + 1 < n_blocks:
                    with spans.host("assemble"):
                        enc = self._encode(self._host.assemble_frames(self._push))
                    nxt = stager.stage(enc)
                if on_block is not None:
                    on_block(k, out, valid)
                valid_acc = valid_acc + valid
                energy_acc = energy_acc + torch.sum(out * out)
                if (k + 1) % 32 == 0:
                    sd.readback(valid_acc)
        return self._finish(state, valid_acc, energy_acc)

    def _finish(self, state, valid_acc, energy_acc):
        self._final_state = state
        overflow = _get_path(state, self._port_path)["overflow"]
        return int(valid_acc), float(energy_acc), bool(overflow)

    def close(self):
        self._host.close()


class _NoSpans:
    """Spans that time nothing."""

    @contextlib.contextmanager
    def span(self, name):
        yield

    host = span


_NO_SPANS = _NoSpans()
