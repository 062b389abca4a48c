"""The live-feed stream farm over several cards (rodio_tpu/parallel/sharded_farm.py).

Each rank of a :class:`~rodio_tpu_torch.parallel.sharding.StreamMesh` (one
process a card) runs the single-card farm's path on its contiguous slice
of the streams:

  [host]  its own HostDecodePool over its slice of the stream-major paths
          (the decode workers divided among the ranks of a host)
  [card]  ChunkRingFeed push -> K1 in ring mode on its streams -> the
          all-reduce of the [C, T] partial mix (within the host, then
          across hosts on a hybrid mesh) -> the master limiter on every
          rank

The host assembly of block k+1 overlaps the card's block k, as in
:class:`~rodio_tpu_torch.parallel.farm.StreamFarm`, and the same host
blocks give the same output as that farm, up to the all-reduce's order of
the mix's sum.
"""
from __future__ import annotations

from typing import Optional, Sequence

import math

import numpy as np
import torch

from ..core.types import StreamSpec
from ..utils.device import DeviceLike, resolve_device
from ..utils.trace import NO_SPANS
from .farm import (
    HostDecodePool, _find_feed_state, _get_path, _set_path, _SyncDebug,
    _wire_decode, _wire_encode, _wire_staging, WIRES)
from .sharding import ShardedFusedPipeline, StreamMesh


class ShardedFusedFarm:
    """The device side of the sharded farm: this rank's ChunkRingFeed
    under a :class:`ShardedFusedPipeline`, with the push + emit step. It
    takes host blocks (so a caller can drive it with PCM made in memory);
    :class:`ShardedStreamFarm` puts live file decode on top. A host block
    is the global [S*C, T] block (this rank takes its rows) or this rank's
    own [S/n*C, T] rows."""

    def __init__(self, mesh: StreamMesh, n_streams: int, channels: int, in_rate: int,
                 out_rate: int, block_frames: int, *, gains=None,
                 low_pass: Optional[float] = 2000.0, wire: str = "f32",
                 master_mode: str = "auto", m: int = 2, device: DeviceLike = None):
        from ..flagship import ChunkRingFeed, FusedFarmPipeline

        self.mesh = mesh
        self.device = resolve_device(device)
        n_dev = mesh.size
        if n_streams % n_dev:
            raise ValueError(f"{n_streams} streams not divisible by {n_dev} ranks")
        if wire not in WIRES:
            raise ValueError(f"wire must be one of {WIRES}, got {wire!r}")
        self.n_dev, self.n_streams = n_dev, n_streams
        s_local = n_streams // n_dev
        C = channels
        g = math.gcd(in_rate, out_rate)
        fr, to = in_rate // g, out_rate // g
        if fr == to or to < 2:
            raise ValueError("fused farm needs a non-identity rational rate ratio")
        if block_frames % (m * to):
            raise ValueError(f"sharded farm block must be a multiple of {m * to}")
        self.block_frames = block_frames
        self.spec_in = StreamSpec(C, in_rate)
        self._fr = int(fr)
        self._Kp = block_frames // to
        self.push_frames = self._Kp * self._fr
        self.wire = wire
        if gains is None:
            gains = np.full(n_streams, 1.0 / n_streams, np.float32)
        gains = np.asarray(gains, np.float32)
        per_lane = np.repeat(gains, C) if gains.shape == (n_streams,) else gains
        if per_lane.shape != (n_streams * C,):
            raise ValueError(f"gains must be [{n_streams}] or [{n_streams * C}]")
        self._rows = range(mesh.rank * s_local * C, (mesh.rank + 1) * s_local * C)
        # this rank's gains ride its feed's state
        self.feed = ChunkRingFeed(
            s_local * C, in_rate, self._fr, self._Kp, 4 * self._Kp,
            "int2" if wire == "i16" else "int3",
            per_lane[self._rows.start:self._rows.stop], gain_post=wire == "i16",
            device=self.device)

        def build(S_local, shard):
            return FusedFarmPipeline(
                self.feed, out_rate, S_local, "low_pass" if low_pass is not None else None,
                low_pass if low_pass is not None else 2000.0, 0.5, m=m)

        self.pipe = ShardedFusedPipeline(build, n_streams, mesh, master_mode=master_mode)
        self._feed_path = ["chain"] + _find_feed_state(self.pipe.template.init_state())
        shape, dtype = _wire_staging(wire, s_local * C, self.push_frames)
        from ..io.streaming import PinnedStager

        self._stager = PinnedStager(shape, dtype, self.device)

    def init_state(self):
        return self.pipe.init_state()

    def _local(self, host_block: np.ndarray) -> np.ndarray:
        if host_block.shape[0] == self.n_streams * self.spec_in.channels:
            return host_block[self._rows.start:self._rows.stop]
        if host_block.shape[0] != len(self._rows):
            raise ValueError(f"host block of {host_block.shape[0]} rows")
        return host_block

    def _push(self, state, blk: torch.Tensor, prime: bool = False):
        fs = _get_path(state, self._feed_path)
        fs = self.feed.push(fs, _wire_decode(blk, self.wire), prime=prime)
        return _set_path(state, self._feed_path, fs)

    def prime_push(self, state, host_block: np.ndarray):
        """Push the first block ((Kp+1)*fr frames; a one-off copy)."""
        enc = _wire_encode(self._local(host_block), self.wire)
        blk = torch.from_numpy(np.ascontiguousarray(enc)).to(self.device)
        return self._push(state, blk, prime=True)

    def stage(self, host_block: np.ndarray):
        """Start a [.., Kp*fr] host block's copy to the card (pinned, side
        stream); :meth:`step` takes what this returns."""
        return self._stager.stage(_wire_encode(self._local(host_block), self.wire))

    def step(self, state, host_block):
        """One block: push (a host block, or what :meth:`stage` returned) +
        the fused emit + the all-reduce of the mix + the master limiter.
        Returns (state', [C, T] mix, valid)."""
        staged = host_block if isinstance(host_block, tuple) else self.stage(host_block)
        state = self._push(state, self._stager.take(staged))
        return self.pipe.emit(state, self.block_frames)

    def overflow(self, state) -> bool:
        """Whether any rank's feed overflowed (a collective)."""
        fs = _get_path(state, self._feed_path)
        return bool(self.mesh.all_reduce_max(fs["overflow"].to(torch.int32)))

    def retune(self, state, **kw):
        return self.pipe.retune(state, **kw)


def _global_spec_rule(mesh: StreamMesh):
    """The corpus rule over every rank's slice: each rank's (channels,
    rate) extremes all-reduced, so every rank uniformizes alike."""
    def rule(specs, out_rate):
        cs = [c for c, _ in specs]
        rs = [r for _, r in specs]
        t = torch.tensor([max(cs), -min(cs), max(rs), -min(rs)], dtype=torch.int64)
        t = mesh.all_reduce_max(t.to(mesh.device)).cpu().tolist()
        c_hi, c_lo, r_hi, r_lo = t[0], -t[1], t[2], -t[3]
        if c_hi == c_lo and r_hi == r_lo:
            return c_hi, r_hi, False
        return c_hi, out_rate, True

    return rule


class ShardedStreamFarm:
    """N files -> one mixed output over the ranks of ``mesh``: each rank
    decodes its contiguous slice of ``paths`` in its own HostDecodePool
    (``decode_workers`` divided among a host's ranks) and feeds a
    :class:`ShardedFusedFarm`. Every rank runs the same calls (SPMD)."""

    def __init__(self, paths: Sequence[str], mesh: StreamMesh, *,
                 out_rate: int = 48000, block_frames: int = 4096, gains=None,
                 low_pass: Optional[float] = 2000.0,
                 start_offsets: Optional[Sequence[float]] = None,
                 loop: bool = True, chunk_frames: int = 8192, decode_workers: int = 8,
                 wire: str = "f32", master_mode: str = "auto", device: DeviceLike = None):
        paths = list(paths)
        self.mesh = mesh
        self.n_streams = len(paths)
        self._mine = mesh.streams_of(self.n_streams)
        sl = slice(self._mine.start, self._mine.stop)
        self._host = HostDecodePool(
            paths[sl], out_rate=out_rate, chunk_frames=chunk_frames,
            decode_workers=max(1, decode_workers // mesh.per_host),
            start_offsets=None if start_offsets is None else list(start_offsets)[sl],
            loop=loop, spec_rule=_global_spec_rule(mesh))
        self.spec_in = self._host.spec_in
        self.core = ShardedFusedFarm(
            mesh, self.n_streams, self.spec_in.channels, self.spec_in.sample_rate,
            out_rate, block_frames, gains=gains, low_pass=low_pass, wire=wire,
            master_mode=master_mode, device=device)
        self.device = self.core.device
        self.block_frames = block_frames
        self._push = self.core.push_frames

    def try_seek(self, stream: int, seconds: float) -> int:
        """Sample-accurate live seek of one stream (global index): its rank
        seeks, and every rank returns the frame reached (a collective)."""
        owner = stream // len(self._mine)
        got = -1
        if owner == self.mesh.rank:
            got = self._host.try_seek(stream - self._mine.start, seconds)
        t = torch.full((1,), got, dtype=torch.int64, device=self.mesh.device)
        return int(self.mesh.broadcast(t, owner)[0])

    def run(self, n_blocks: int, *, on_block=None, spans=None, sync_debug: bool = False):
        """Drive n_blocks; returns (total valid frames, energy, overflow),
        as :meth:`StreamFarm.run`."""
        core = self.core
        sync_debug = sync_debug and self.device.type == "cuda"
        spans = spans if spans is not None else NO_SPANS
        self._host.prime()
        state = core.init_state()
        fr, Kp = core._fr, core._Kp
        state = core.prime_push(state, self._host.assemble_frames((Kp + 1) * fr))
        nxt = core.stage(self._host.assemble_frames(self._push))
        energy_acc = torch.zeros((), device=self.device)
        valid_acc = torch.zeros((), dtype=torch.int64, device=self.device)
        with _SyncDebug(sync_debug) as sd:
            for k in range(n_blocks):
                sd.block(k)
                self._host.schedule_refills(threshold=2 * self._push)
                with spans.span("step"):
                    state, out, valid = core.step(state, nxt)
                if k + 1 < n_blocks:
                    with spans.host("assemble"):
                        blk = self._host.assemble_frames(self._push)
                    nxt = core.stage(blk)
                if on_block is not None:
                    on_block(k, out, valid)
                valid_acc = valid_acc + valid
                energy_acc = energy_acc + torch.sum(out * out)
                if (k + 1) % 32 == 0:
                    sd.readback(valid_acc)
        self._final_state = state
        return int(valid_acc), float(energy_acc), core.overflow(state)

    def close(self):
        self._host.close()
