"""The port's sharding on real ranks: 4 gloo processes on the CPU, spawned
with a file store under ``tmp_path``, as a 1-D mesh and as the hybrid
2 x 2 mesh, against the JAX package's shardings on the 8 (or 4) virtual
CPU devices ``conftest.py`` sets and against the port's dense renders.

Each spawn has a 60 s limit and kills its ranks when it runs out
(``parallel.launch.spawn_ranks``), so no test can hang the run. The ranks
(``torch_dist_ranks.rank_main``) return their outputs; the master mix is
replicated, so every rank's must be the same.

Bounds: 2e-6 for the sharded fused farm and pipelines against JAX and
the dense renders (the mix's order); 1e-6 for the mixer; 2e-5 for the
full stateful chain against JAX (its AGC's drift on XLA:CPU, ROADMAP F4),
2e-6 against the port's dense chain.
"""
import pickle

import jax
import numpy as np
import pytest

import torch_dist_ranks as R
from rodio_tpu_torch.parallel.launch import spawn_ranks

N_RANKS = 4


def _spawn(tmp, hybrid, jax_state_path=""):
    return spawn_ranks(R.rank_main, N_RANKS, backend="gloo",
                       init_method=f"file://{tmp}/store_{int(hybrid)}",
                       args=(hybrid, jax_state_path), timeout=60.0)


def _jax_fused_state(path):
    """A JAX ShardedFusedPipeline over 4 devices (a shard a rank) after 2
    blocks, pickled for the ranks, and its next 2 blocks."""
    from rodio_tpu.flagship import FusedWidePipeline
    from rodio_tpu.parallel.sharding import ShardedFusedPipeline, stream_mesh
    from rodio_tpu.sources.generators import SamplesBuffer

    pcms, gains = R.fused_shards(N_RANKS)

    def build(S_local, shard):
        return FusedWidePipeline(SamplesBuffer(S_local * 2, 44100, pcms[shard]), 48000,
                                 gains[shard], S_local)

    pipe = ShardedFusedPipeline(build, R.S_FUSED, stream_mesh(jax.devices()[:N_RANKS]),
                                master_mode="exact")
    st = pipe.init_state()
    for _ in range(2):
        st, _, _ = pipe.emit(st, R.FUSED_T)
    with open(path, "wb") as f:
        pickle.dump(jax.device_get(st), f)
    outs = []
    for _ in range(2):
        st, out, _ = pipe.emit(st, R.FUSED_T)
        outs.append(np.asarray(out))
    return np.concatenate(outs, 1)


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("dist")
    want = _jax_fused_state(str(tmp / "jstate.pkl"))
    return _spawn(tmp, False, str(tmp / "jstate.pkl")), want


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("dist_h"), True)


@pytest.fixture(scope="module")
def jax_farm():
    """JAX's ShardedFusedFarm over 8 devices on the same host blocks."""
    from rodio_tpu.parallel.sharded_farm import ShardedFusedFarm
    from rodio_tpu.parallel.sharding import stream_mesh

    blocks, gains = R.farm_blocks(R.FARM_T // 160)
    farm = ShardedFusedFarm(stream_mesh(jax.devices()[:8]), R.S_FARM, 2, 44100, 48000,
                            R.FARM_T, gains=gains, wire="i16")
    st = farm.prime_push(farm.init_state(), blocks[0])
    outs = []
    for b in blocks[1:]:
        st, out, _ = farm.step(st, b)
        outs.append(np.asarray(out))
    return np.concatenate(outs, 1), farm.overflow(st)


def _replicated(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def _dense_wide():
    from rodio_tpu_torch.parallel.sharding import ShardedWidePipeline, stream_mesh

    # a group of one is the dense render: the whole chain, the same master
    pipe = ShardedWidePipeline(R.wide_builder(R.WIDE_FRAMES), R.S_WIDE, stream_mesh())
    st = pipe.init_state()
    outs = []
    for _ in range(R.WIDE_BLOCKS):
        st, out, _ = pipe.emit(st, R.WIDE_T)
        outs.append(out.numpy())
    return np.concatenate(outs, 1)


def test_ranks_hold_their_slice_of_the_streams(flat, hybrid):
    ranks, _ = flat
    assert [r["rank"] for r in ranks] == list(range(N_RANKS))
    assert all(r["shape"] == {"streams": N_RANKS} for r in ranks)
    assert all(r["local_streams"] == R.S_WIDE // N_RANKS for r in ranks + hybrid)
    assert all(r["shape"] == {"dcn": 2, "streams": 2} for r in hybrid)


def test_sharded_wide_pipeline_on_four_ranks(flat):
    """The full stateful chain over 4 ranks equals the dense render and
    JAX's over 8 devices."""
    from rodio_tpu.parallel.sharding import ShardedWidePipeline, stream_mesh
    import test_torch_parallel as P

    got = _replicated(flat[0], "wide")
    np.testing.assert_allclose(got, _dense_wide(), atol=2e-6)
    jp = ShardedWidePipeline(P._wide_builder(R.WIDE_FRAMES, jax_side=True), R.S_WIDE,
                             stream_mesh(jax.devices()[:8]))
    st = jp.init_state()
    outs = []
    for _ in range(R.WIDE_BLOCKS):
        st, out, _ = jp.emit(st, R.WIDE_T)
        outs.append(np.asarray(out))
    np.testing.assert_allclose(got, np.concatenate(outs, 1), atol=2e-5)


def test_sharded_wide_pipeline_on_the_hybrid_mesh(flat, hybrid):
    """2 x 2: the mix reduced within a host, then across: as the 1-D mesh."""
    np.testing.assert_allclose(_replicated(hybrid, "wide"), _replicated(flat[0], "wide"),
                               atol=2e-6)


@pytest.mark.parametrize("layout", ["flat", "hybrid"])
def test_sharded_fused_farm_matches_jax(flat, hybrid, jax_farm, layout):
    """The farm-fed fused leg on the i16 wire over 4 ranks (and 2 x 2)
    against JAX's ShardedFusedFarm over 8 devices on the same host blocks;
    the overflow flags equal."""
    ranks = flat[0] if layout == "flat" else hybrid
    want, jovf = jax_farm
    np.testing.assert_allclose(_replicated(ranks, "farm"), want, atol=2e-6)
    assert all(r["farm_overflow"] is jovf is False for r in ranks)


def test_sharded_mixer_on_four_ranks(flat):
    rng = np.random.default_rng(3)
    datas = [rng.uniform(-1, 1, (2, 2000)).astype(np.float32) for _ in range(16)]
    np.testing.assert_allclose(_replicated(flat[0], "mixer"),
                               sum(d[:, :256] for d in datas) / 16, atol=1e-6)
    assert {r["mixer_valid"] for r in flat[0]} == {256}


def test_ranks_with_different_content_match_the_dense_render(flat):
    """The shard-varying audit: ranks with their own PCM, gains and filter
    coefficients (each in its state) give the dense sum of the four
    pipelines through the same master limiter."""
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.parallel.sharding import _BlockFeed

    build = R.fused_builder(N_RANKS, R.AUDIT_FREQS)
    pipes = [build(R.S_FUSED // N_RANKS, r) for r in range(N_RANKS)]
    states = [p.init_state() for p in pipes]
    master = Limit(_BlockFeed(2, 48000, "cpu"), LimitSettings(), mode="exact")
    mst = master.init_state()
    outs = []
    for _ in range(2):
        parts = []
        for i, p in enumerate(pipes):
            states[i], part, v = p.emit(states[i], R.FUSED_T)
            parts.append(part)
        mst, out, _ = master.emit({**mst, "in": {"blk": sum(parts), "v": v}}, R.FUSED_T)
        mst = {**mst, "in": {}}
        outs.append(out.numpy())
    np.testing.assert_allclose(_replicated(flat[0], "audit"), np.concatenate(outs, 1),
                               atol=2e-6)


def test_sharded_fused_pipeline_state_from_jax_continues(flat):
    """Each rank converts its entry of JAX's stacked ShardedFusedPipeline
    state and goes on: its 2 blocks equal JAX's continuation."""
    ranks, want = flat
    np.testing.assert_allclose(_replicated(ranks, "continued"), want, atol=2e-6)


def test_spawn_kills_ranks_that_overrun(tmp_path):
    """A rank that outlives the limit is killed, and the spawn raises."""
    with pytest.raises(TimeoutError):
        spawn_ranks(R.sleep_rank, 2, backend="gloo", init_method=f"file://{tmp_path}/s",
                    timeout=3.0)
