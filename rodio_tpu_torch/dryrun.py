"""A dry run of the multi-card paths (the port of ``__graft_entry__.dryrun_multichip``).

    python -m rodio_tpu_torch.dryrun N [--backend gloo|nccl]

:func:`dryrun_multichip` runs, on n ranks of a ``torch.distributed`` group
(gloo ranks on the CPU, or NCCL ranks one a card), with 2 streams a rank:

- the full stateful chain sharded (ShardedWidePipeline: Resample ->
  BltFilter -> AutomaticGainControl -> Amplify -> per-stream Limit ->
  WideMixer, the master limiter on the all-reduced mix), 10 blocks of 256;
- the fused pipeline sharded (ShardedFusedPipeline over FusedWidePipeline,
  each rank its own PCM), 3 blocks of 320, a live retune broadcast into
  every rank, and one more block;
- the farm-fed fused leg on the i16 wire (ShardedFusedFarm: each rank's
  ChunkRingFeed and K1 in ring mode), 3 blocks of 640;
- with n >= 4 and even, the same three on the hybrid 2 x n/2 mesh
  (the mix reduced within a host, then across hosts).

n = 1 runs in this process, in the default group if one is initialised
(a group of one otherwise); n > 1 spawns n ranks.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def _legs(mesh, n_ranks: int, device) -> dict:
    """The dry run's legs on this rank; returns its energies and shapes."""
    from .conversions.resample import Resample
    from .effects.agc import AgcSettings, AutomaticGainControl
    from .effects.basic import Amplify
    from .effects.blt import BltFilter
    from .effects.limit import Limit, LimitSettings
    from .flagship import FusedWidePipeline
    from .parallel.batch import WideMixer
    from .parallel.sharded_farm import ShardedFusedFarm
    from .parallel.sharding import ShardedFusedPipeline, ShardedWidePipeline
    from .sources.generators import SamplesBuffer

    n_streams = 2 * n_ranks
    rng = np.random.default_rng(0)

    def build(S):
        # every per-stream effect is stateful (biquad carries, the AGC's
        # RMS window, the per-stream limiter's envelopes) and sharded
        pcm = rng.standard_normal((S * 2, 4096)).astype(np.float32) * 0.3
        gains = np.repeat(np.full(S, 1.0 / n_streams, np.float32), 2)
        node = SamplesBuffer(S * 2, 44100, pcm, device=device)
        node = Resample(node, 48000, max_block=512)
        node = BltFilter(node, "low_pass", 2000.0, 0.5, mode="exact")
        node = AutomaticGainControl(node, AgcSettings(), mode="exact", streams=S)
        node = Amplify(node, gains)
        node = Limit(node, LimitSettings(), mode="exact", streams=S)
        return WideMixer(node, S)

    s_local = 2

    def build_fused(S_local, shard):
        r = np.random.default_rng(100 + shard)
        pcm = r.standard_normal((S_local * 2, 2200)).astype(np.float32) * 0.3
        g = np.full(S_local, 1.0 / (s_local * n_ranks), np.float32)
        return FusedWidePipeline(SamplesBuffer(S_local * 2, 44100, pcm, device=device),
                                 48000, g, S_local)

    frng = np.random.default_rng(7)

    def farm_block(T):
        return (frng.standard_normal((n_streams * 2, T)) * 0.3).astype(np.float32)

    def wide_leg(m, blocks):
        sharded = ShardedWidePipeline(build, n_streams, m)
        st = sharded.init_state()
        energy = 0.0
        for _ in range(blocks):
            st, out, valid = sharded.emit(st, 256)
            energy += float((out * out).sum())
        assert tuple(out.shape) == (2, 256) and int(valid) == 256, (out.shape, valid)
        return energy

    def fused_leg(m, blocks, retune):
        fused = ShardedFusedPipeline(build_fused, s_local * n_ranks, m, master_mode="exact")
        st = fused.init_state()
        energy = 0.0
        for _ in range(blocks):
            st, out, _ = fused.emit(st, 320)
            energy += float((out * out).sum())
        if retune:
            # a live retune broadcast into every rank's state: nothing rebuilt
            st = fused.retune(st, kind="high_pass", freq=900.0)
            st, out, _ = fused.emit(st, 320)
            energy += float((out * out).sum())
        assert tuple(out.shape) == (2, 320), out.shape
        return energy

    def farm_leg(m, blocks):
        farm = ShardedFusedFarm(m, n_streams, 2, 44100, 48000, block_frames=640,
                                low_pass=2000.0, wire="i16", device=device)
        st = farm.init_state()
        st = farm.prime_push(st, farm_block((farm._Kp + 1) * farm._fr))
        energy = 0.0
        for _ in range(blocks):
            st, out, _ = farm.step(st, farm_block(farm.push_frames))
            energy += float((out * out).sum())
        assert tuple(out.shape) == (2, 640) and not farm.overflow(st), out.shape
        return energy

    res = {"wide": wide_leg(mesh, 10), "fused": fused_leg(mesh, 3, True),
           "farm": farm_leg(mesh, 3)}
    if n_ranks >= 4 and n_ranks % 2 == 0:
        from .parallel.sharding import hybrid_stream_mesh

        hmesh = hybrid_stream_mesh(2, device=mesh.device)
        res.update(hybrid_wide=wide_leg(hmesh, 2), hybrid_fused=fused_leg(hmesh, 2, False),
                   hybrid_farm=farm_leg(hmesh, 1))
    for k, v in res.items():
        assert v > 0.0 and np.isfinite(v), (k, v)
    return res


def _rank(rank: int, n: int, backend: str):
    from .parallel.sharding import stream_mesh

    device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    return _legs(stream_mesh(), n, device)


def dryrun_multichip(n: int, *, backend: str = None, device=None, timeout: float = 600.0) -> dict:
    """Run the dry run on n ranks and return rank 0's energies; raises on
    any failure. ``backend``: "gloo" (CPU ranks) or "nccl" (rank r on card
    r); by default NCCL where n cards are present, else gloo. n = 1 runs
    here, on ``device`` (default: the card if present, else the CPU)."""
    if n == 1:
        from .parallel.sharding import stream_mesh

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        res = _legs(stream_mesh(), 1, device)
    else:
        from .parallel.launch import spawn_ranks

        if backend is None:
            backend = ("nccl" if torch.cuda.is_available()
                       and torch.cuda.device_count() >= n else "gloo")
        with tempfile.TemporaryDirectory() as tmp:
            init = "file://" + os.path.join(tmp, "store")
            res = spawn_ranks(_rank, n, backend=backend, init_method=init,
                              args=(n, backend), timeout=timeout)[0]
    hyb = (f", hybrid 2x{n // 2} (unfused + fused + farm-fed fused)"
           if "hybrid_wide" in res else "")
    print(f"dryrun_multichip OK: {n} ranks, {2 * n} streams; full stateful chain 10 "
          f"blocks, energy {res['wide']:.4g}; fused sharded 4 blocks with a live retune, "
          f"energy {res['fused']:.4g}; farm-fed fused (i16 wire, K1's ring mode) 3 "
          f"blocks, energy {res['farm']:.4g}{hyb}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--backend", choices=("gloo", "nccl"))
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, backend=a.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
