"""The rank side of ``test_torch_distributed.py``: what each gloo rank runs,
and the seeded content both packages render. Numpy and the port only (a
rank imports nothing of JAX); pytest collects no test here."""
from __future__ import annotations

import pickle

import numpy as np

S_WIDE, WIDE_FRAMES, WIDE_T, WIDE_BLOCKS = 16, 6000, 512, 4
S_FARM, FARM_T, FARM_BLOCKS = 8, 640, 4
S_FUSED, FUSED_T, FUSED_FRAMES = 8, 320, 2200
AUDIT_FREQS = (1500.0, 2500.0, 900.0, 3100.0)


def farm_blocks(kp: int, fr: int = 147):
    """The farm's host blocks: the first push and FARM_BLOCKS more, 16-bit
    grid (exact on the i16 wire), and the per-stream gains."""
    rng = np.random.default_rng(31)
    sizes = [(kp + 1) * fr] + [kp * fr] * FARM_BLOCKS
    blocks = [(np.round(rng.standard_normal((S_FARM * 2, t)) * 6000) / 32768).astype(np.float32)
              for t in sizes]
    gains = (rng.uniform(0.5, 1.5, S_FARM) / S_FARM).astype(np.float32)
    return blocks, gains


def fused_shards(n_dev: int, seed: int = 11):
    """Per-shard (PCM, gains) of the fused pipeline: every shard its own."""
    r = np.random.default_rng(seed)
    s_local = S_FUSED // n_dev
    pcms = [r.standard_normal((s_local * 2, FUSED_FRAMES)).astype(np.float32) * 0.3
            for _ in range(n_dev)]
    gains = [r.uniform(0.5, 1.5, s_local).astype(np.float32) / S_FUSED for _ in range(n_dev)]
    return pcms, gains


def wide_builder(frames, rng_seed=7):
    """The full stateful chain's builder (tests/test_parallel.py:87-117)."""
    from rodio_tpu_torch.conversions.resample import Resample
    from rodio_tpu_torch.effects.agc import AgcSettings, AutomaticGainControl
    from rodio_tpu_torch.effects.basic import Amplify
    from rodio_tpu_torch.effects.blt import BltFilter
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.parallel.batch import WideMixer
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    r = np.random.default_rng(rng_seed)

    def build(S):
        pcm = r.standard_normal((S * 2, frames)).astype(np.float32) * 0.4
        gains = np.repeat(r.uniform(0.5, 1.5, S).astype(np.float32) / max(S, 1), 2)
        n = SamplesBuffer(S * 2, 44100, pcm, device="cpu")
        n = Resample(n, 48000, max_block=512)
        n = BltFilter(n, "low_pass", 2000.0, 0.5, mode="exact")
        n = AutomaticGainControl(n, AgcSettings(), mode="exact", streams=S)
        n = Amplify(n, gains)
        n = Limit(n, LimitSettings(), mode="exact", streams=S)
        return WideMixer(n, S)

    return build


def fused_builder(n_dev: int, freqs=None, seed: int = 11):
    from rodio_tpu_torch.flagship import FusedWidePipeline
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    pcms, gains = fused_shards(n_dev, seed)

    def build(S_local, shard):
        node = SamplesBuffer(S_local * 2, 44100, pcms[shard], device="cpu")
        freq = 2000.0 if freqs is None else freqs[shard]
        return FusedWidePipeline(node, 48000, gains[shard], S_local, freq=freq)

    return build


def rank_main(rank: int, hybrid: bool, jax_state_path: str):
    """One rank's legs; returns its outputs (each replicated on every
    rank) as numpy."""
    import torch

    from rodio_tpu_torch.parallel.batch import BatchedChain, stack_states
    from rodio_tpu_torch.parallel.sharded_farm import ShardedFusedFarm
    from rodio_tpu_torch.parallel.sharding import (
        ShardedFusedPipeline, ShardedMixer, ShardedWidePipeline, hybrid_stream_mesh,
        stream_mesh)

    torch.set_num_threads(1)
    mesh = hybrid_stream_mesh(2) if hybrid else stream_mesh()
    out = {"shape": mesh.shape, "rank": mesh.rank}

    wide = ShardedWidePipeline(wide_builder(WIDE_FRAMES), S_WIDE, mesh)
    st = wide.init_state()
    out["local_streams"] = int(st["chain"]["in"]["in"]["in"]["in"]["in"]["data"].shape[0] // 2)
    mixes = []
    for _ in range(WIDE_BLOCKS):
        st, mix, valid = wide.emit(st, WIDE_T)
        mixes.append(mix.numpy())
    out["wide"] = np.concatenate(mixes, 1)

    blocks, gains = farm_blocks(FARM_T // 160)
    farm = ShardedFusedFarm(mesh, S_FARM, 2, 44100, 48000, FARM_T, gains=gains,
                            wire="i16", device="cpu")
    fst = farm.prime_push(farm.init_state(), blocks[0])
    mixes = []
    for b in blocks[1:]:
        fst, mix, _ = farm.step(fst, b)
        mixes.append(mix.numpy())
    out["farm"] = np.concatenate(mixes, 1)
    out["farm_overflow"] = farm.overflow(fst)
    if hybrid:
        return out

    rng = np.random.default_rng(3)
    datas = [rng.uniform(-1, 1, (2, 2000)).astype(np.float32) for _ in range(16)]
    from rodio_tpu_torch.effects.basic import Amplify
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    tmpl = Amplify(SamplesBuffer(2, 48000, datas[0], device="cpu"), 1.0 / 16)
    states = [Amplify(SamplesBuffer(2, 48000, d, device="cpu"), 1.0 / 16).init_state()
              for d in datas]
    mixer = ShardedMixer(BatchedChain(tmpl, stack_states(states), 16), mesh)
    _, mix, valid = mixer.emit(mixer.init_state(), 256)
    out["mixer"], out["mixer_valid"] = mix.numpy(), int(valid)

    # the audit: every rank its own PCM, gains and low-pass frequency
    audit = ShardedFusedPipeline(fused_builder(mesh.size, AUDIT_FREQS), S_FUSED, mesh,
                                 master_mode="exact")
    ast = audit.init_state()
    mixes = []
    for _ in range(2):
        ast, mix, _ = audit.emit(ast, FUSED_T)
        mixes.append(mix.numpy())
    out["audit"] = np.concatenate(mixes, 1)

    # a JAX ShardedFusedPipeline's stacked state, this rank's entry, goes on
    from rodio_tpu_torch.convert import sharded_state_from_jax

    with open(jax_state_path, "rb") as f:
        jstate = pickle.load(f)
    pipe = ShardedFusedPipeline(fused_builder(mesh.size), S_FUSED, mesh, master_mode="exact")
    pst = sharded_state_from_jax(pipe, jstate)
    mixes = []
    for _ in range(2):
        pst, mix, _ = pipe.emit(pst, FUSED_T)
        mixes.append(mix.numpy())
    out["continued"] = np.concatenate(mixes, 1)
    return out


def sleep_rank(rank: int):
    """A rank that outlives any test's limit."""
    import time

    time.sleep(60)


def farm_rank(rank: int, paths, cfg):
    """A rank of the sharded farm fuzz: its ShardedStreamFarm's output."""
    import torch

    from rodio_tpu_torch.parallel.sharded_farm import ShardedStreamFarm
    from rodio_tpu_torch.parallel.sharding import stream_mesh

    torch.set_num_threads(1)
    sfarm = ShardedStreamFarm(paths, stream_mesh(), device="cpu", **cfg["common"])
    if cfg["seek"] is not None:
        sfarm.try_seek(*cfg["seek"])
    blocks = []
    res = sfarm.run(cfg["n_blocks"], on_block=lambda k, o, v: blocks.append(o.numpy()))
    sfarm.close()
    return np.concatenate(blocks, 1), res
