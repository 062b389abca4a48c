"""The port's stream batching and sharding (M8) against the JAX package,
the cases of tests/test_parallel.py, in one process on the CPU.

Without a launcher the port's mesh is a group of one (the same code path
as a rank of n, its collectives the identity); the JAX side shards over
the 8 virtual CPU devices ``conftest.py`` sets. ``test_torch_distributed.py``
runs the same classes on 4 gloo ranks. Bounds: 1e-6 against the dense sum
and between the packages, as ``test_parallel.py`` holds them, but 2e-6
for the full stateful chain and the fused pipelines (the mix's order) and
2e-5 where the JAX AGC on XLA:CPU drifts from the exact recurrence
(ROADMAP F4).
"""
import jax
import numpy as np
import pytest
import torch

from rodio_tpu_torch.effects.basic import Amplify
from rodio_tpu_torch.parallel.batch import BatchedChain, BatchedMixer, WideMixer, stack_states
from rodio_tpu_torch.parallel.sharding import (
    ShardedBatch, ShardedFusedPipeline, ShardedMixer, ShardedWidePipeline,
    hybrid_stream_mesh, stream_mesh)
from rodio_tpu_torch.sources.generators import SamplesBuffer


@pytest.fixture
def jmesh():
    from rodio_tpu.parallel.sharding import stream_mesh as jstream_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jstream_mesh(jax.devices()[:8])


def _datas(rng, n_streams, frames=2000):
    return [rng.uniform(-1, 1, (2, frames)).astype(np.float32) for _ in range(n_streams)]


def _port_chain(datas):
    S = len(datas)
    template = Amplify(SamplesBuffer(2, 48000, datas[0], device="cpu"), 1.0 / S)
    states = [Amplify(SamplesBuffer(2, 48000, d, device="cpu"), 1.0 / S).init_state()
              for d in datas]
    return BatchedChain(template, stack_states(states), S)


def _jax_chain(datas):
    from rodio_tpu.effects.basic import Amplify as JAmplify
    from rodio_tpu.parallel.batch import BatchedChain as JChain, stack_states as jstack
    from rodio_tpu.sources.generators import SamplesBuffer as JBuffer

    S = len(datas)
    template = JAmplify(JBuffer(2, 48000, datas[0]), 1.0 / S)
    states = [JAmplify(JBuffer(2, 48000, d), 1.0 / S).init_state() for d in datas]
    return JChain(template, jstack(states), S)


def test_sharded_mixer_equals_dense_sum(rng, jmesh):
    from rodio_tpu.parallel.sharding import ShardedMixer as JMixer

    datas = _datas(rng, 16)
    sharded = ShardedMixer(_port_chain(datas), stream_mesh())
    state, mix, valid = sharded.emit(sharded.init_state(), 256)
    expected = sum(d[:, :256] for d in datas) / 16
    np.testing.assert_allclose(mix.numpy(), expected, atol=1e-6)
    assert int(valid) == 256
    jm = JMixer(_jax_chain(datas), jmesh)
    _, jmix, jvalid = jax.jit(lambda s: jm.emit(s, 256))(jm.init_state())
    np.testing.assert_allclose(mix.numpy(), np.asarray(jmix), atol=1e-6)
    assert int(jvalid) == int(valid)


def test_sharded_mixer_streams_stay_sharded(rng):
    """A rank's state holds its S/n streams; blocks continue from it."""
    sharded = ShardedMixer(_port_chain(_datas(rng, 16)), stream_mesh())
    state = sharded.init_state()
    mesh = sharded.mesh
    leaf = state["in"]["data"]
    assert leaf.shape[0] == 16 // mesh.size and mesh.streams_of(16) == range(16)
    state, mix1, _ = sharded.emit(state, 128)
    state, mix2, _ = sharded.emit(state, 128)
    assert int(state["in"]["pos"][0]) == 256 and not torch.equal(mix1, mix2)


def test_batched_mixer_matches_wide_layout(rng):
    """The vmapped batch and the wide-channel layout agree, and with JAX's."""
    from rodio_tpu.parallel.batch import BatchedMixer as JBatched

    datas = _datas(rng, 4, 1000)
    template = SamplesBuffer(2, 48000, datas[0], device="cpu")
    states = [SamplesBuffer(2, 48000, d, device="cpu").init_state() for d in datas]
    vm = BatchedMixer(BatchedChain(template, stack_states(states), 4))
    _, out_vm, _ = vm.emit(vm.init_state(), 256)
    wnode = WideMixer(SamplesBuffer(8, 48000, np.concatenate(datas, 0), device="cpu"), 4)
    _, out_w, _ = wnode.emit(wnode.init_state(), 256)
    np.testing.assert_allclose(out_vm.numpy(), out_w.numpy(), atol=1e-6)
    jvm = JBatched(_jax_chain(datas))
    _, jout, _ = jax.jit(lambda s: jvm.emit(s, 256))(jvm.init_state())
    np.testing.assert_allclose(out_vm.numpy(), np.asarray(jout) * 4, atol=1e-6)


def test_batched_chain_refuses_what_vmap_cannot_run():
    """A node whose emit keeps a host value that changes (the fused
    pipeline's block offset) cannot be vmapped: BatchedChain raises naming
    it; the resampler's chain maps, equal to each stream's own render."""
    from rodio_tpu_torch.conversions.resample import Resample
    from rodio_tpu_torch.flagship import FusedWidePipeline

    pcm = np.zeros((4, 3000), np.float32)
    node = FusedWidePipeline(SamplesBuffer(4, 44100, pcm, device="cpu"), 48000,
                             [0.5, 0.5], 2)
    ch = BatchedChain.from_states(node, [node.init_state(), node.init_state()])
    with pytest.raises(NotImplementedError, match="FusedWidePipeline.emit cannot run"):
        ch.emit(ch.state, 320)
    rng = np.random.default_rng(2)
    nodes = [Resample(SamplesBuffer(2, 44100, rng.standard_normal((2, 3000)).astype(
        np.float32), device="cpu"), 48000) for _ in range(3)]
    ch = BatchedChain.from_states(nodes[0], [n.init_state() for n in nodes])
    _, blocks, _ = ch.emit(ch.state, 512)
    for b, n in zip(blocks, nodes):
        torch.testing.assert_close(b, n.emit(n.init_state(), 512)[1], rtol=0, atol=0)


def _wide_builder(frames, rng_seed=7, jax_side=False):
    """The full stateful chain's builder (test_parallel.py:87-117) in
    either package: every per-stream quantity in the state."""
    if jax_side:
        from rodio_tpu.conversions.resample import Resample
        from rodio_tpu.effects.agc import AgcSettings, AutomaticGainControl
        from rodio_tpu.effects.basic import Amplify as A
        from rodio_tpu.effects.blt import BltFilter
        from rodio_tpu.effects.limit import Limit, LimitSettings
        from rodio_tpu.parallel.batch import WideMixer as W
        from rodio_tpu.sources.generators import SamplesBuffer as B
        dev = {}
    else:
        from rodio_tpu_torch.conversions.resample import Resample
        from rodio_tpu_torch.effects.agc import AgcSettings, AutomaticGainControl
        from rodio_tpu_torch.effects.basic import Amplify as A
        from rodio_tpu_torch.effects.blt import BltFilter
        from rodio_tpu_torch.effects.limit import Limit, LimitSettings
        from rodio_tpu_torch.parallel.batch import WideMixer as W
        from rodio_tpu_torch.sources.generators import SamplesBuffer as B
        dev = {"device": "cpu"}
    r = np.random.default_rng(rng_seed)

    def build(S):
        pcm = r.standard_normal((S * 2, frames)).astype(np.float32) * 0.4
        gains = np.repeat(r.uniform(0.5, 1.5, S).astype(np.float32) / max(S, 1), 2)
        n = B(S * 2, 44100, pcm, **dev)
        n = Resample(n, 48000, max_block=512)
        n = BltFilter(n, "low_pass", 2000.0, 0.5, mode="exact")
        n = AutomaticGainControl(n, AgcSettings(), mode="exact", streams=S)
        n = A(n, gains)
        n = Limit(n, LimitSettings(), mode="exact", streams=S)
        return W(n, S)

    return build


def _dense_master(chain):
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings

    class _Feed:
        def __init__(self, node):
            self.node, self.spec, self.device = node, node.spec, node.device

        def init_state(self):
            return self.node.init_state()

        def emit(self, st, n):
            return self.node.emit(st, n)

    return Limit(_Feed(chain), LimitSettings(), mode="exact")


def test_sharded_wide_pipeline_full_chain(jmesh):
    """The full stateful chain sharded (a group of one here), the master
    limiter on the all-reduced mix, 12 blocks: equal to the dense render,
    and to the JAX package's over 8 devices."""
    from rodio_tpu.parallel.sharding import ShardedWidePipeline as JWide

    S, T, blocks, frames = 16, 512, 12, 9000
    sharded = ShardedWidePipeline(_wide_builder(frames), S, stream_mesh())
    sstate = sharded.init_state()
    master = _dense_master(_wide_builder(frames)(S))
    dstate = master.init_state()
    jp = JWide(_wide_builder(frames, jax_side=True), S, jmesh)
    jstate = jp.init_state()
    for k in range(blocks):
        sstate, smix, sv = sharded.emit(sstate, T)
        dstate, dmix, dv = master.emit(dstate, T)
        jstate, jmix, jv = jp.emit(jstate, T)
        assert int(sv) == int(dv) == int(jv) == T
        np.testing.assert_allclose(smix.numpy(), dmix.numpy(), atol=2e-6, err_msg=str(k))
        np.testing.assert_allclose(smix.numpy(), np.asarray(jmix), atol=2e-5, err_msg=str(k))


def test_sharded_wide_pipeline_builds_once():
    """emit builds nothing: the builder runs twice (the global chain and
    the local template) however many blocks follow."""
    calls = []
    inner = _wide_builder(4000)

    def build(S):
        calls.append(S)
        return inner(S)

    sharded = ShardedWidePipeline(build, 16, stream_mesh())
    state = sharded.init_state()
    for _ in range(4):
        state, _, _ = sharded.emit(state, 256)
    assert calls == [16, 16 // sharded.mesh.size]


def test_hybrid_mesh_wide_pipeline(jmesh):
    """The hybrid layout's code path (a group of one spans one host) equals
    the dense render and the JAX 2 x 4 hybrid mesh."""
    from rodio_tpu.parallel.sharding import (
        ShardedWidePipeline as JWide, hybrid_stream_mesh as jhybrid)

    S, T, blocks, frames = 16, 512, 6, 6000
    mesh = hybrid_stream_mesh(1)
    assert mesh.shape == {"dcn": 1, "streams": 1}
    with pytest.raises(ValueError):
        hybrid_stream_mesh(2)
    sharded = ShardedWidePipeline(_wide_builder(frames), S, mesh)
    sstate = sharded.init_state()
    master = _dense_master(_wide_builder(frames)(S))
    dstate = master.init_state()
    jp = JWide(_wide_builder(frames, jax_side=True), S, jhybrid(2, jax.devices()[:8]),
               axis=("dcn", "streams"))
    jstate = jp.init_state()
    for k in range(blocks):
        sstate, smix, _ = sharded.emit(sstate, T)
        dstate, dmix, _ = master.emit(dstate, T)
        jstate, jmix, _ = jp.emit(jstate, T)
        np.testing.assert_allclose(smix.numpy(), dmix.numpy(), atol=2e-6, err_msg=str(k))
        np.testing.assert_allclose(smix.numpy(), np.asarray(jmix), atol=2e-5, err_msg=str(k))


def _fused_shard_builder(frames, n_streams, n_dev, seed=11, freqs=None):
    """Per-shard FusedWidePipeline builder: every shard its own PCM and
    gains (and, with ``freqs``, its own low-pass)."""
    from rodio_tpu_torch.flagship import FusedWidePipeline

    r = np.random.default_rng(seed)
    s_local = n_streams // n_dev
    pcms = [r.standard_normal((s_local * 2, frames)).astype(np.float32) * 0.3
            for _ in range(n_dev)]
    gains = [r.uniform(0.5, 1.5, s_local).astype(np.float32) / n_streams
             for _ in range(n_dev)]

    def build(S_local, shard):
        assert S_local == s_local
        node = SamplesBuffer(S_local * 2, 44100, pcms[shard], device="cpu")
        freq = 2000.0 if freqs is None else freqs[shard]
        return FusedWidePipeline(node, 48000, gains[shard], S_local, freq=freq)

    return build, pcms, gains


def test_sharded_fused_pipeline_equals_dense_and_jax():
    """The fused pipeline sharded (a group of one), the master limiter on
    the all-reduced mix: equal to the dense fused render plus the same
    limiter, and to the JAX FusedWidePipeline (interpret mode) + Limit."""
    from rodio_tpu.effects.limit import Limit as JLimit, LimitSettings as JSettings
    from rodio_tpu.flagship import FusedWidePipeline as JFused
    from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings

    S, T, blocks, frames = 8, 320, 2, 2200
    build, pcms, gains = _fused_shard_builder(frames, S, 1)
    sharded = ShardedFusedPipeline(build, S, stream_mesh(), master_mode="exact")
    sstate = sharded.init_state()
    dense = Limit(build(S, 0), LimitSettings(), mode="exact")
    dstate = dense.init_state()
    jfused = JLimit(JFused(JBuffer(S * 2, 44100, pcms[0]), 48000, gains[0], S),
                    JSettings(), mode="exact")
    jstate = jfused.init_state()
    for k in range(blocks):
        sstate, smix, sv = sharded.emit(sstate, T)
        dstate, dmix, dv = dense.emit(dstate, T)
        jstate, jmix, _ = jfused.emit(jstate, T)
        assert int(sv) == int(dv) == T
        np.testing.assert_allclose(smix.numpy(), dmix.numpy(), atol=2e-6, err_msg=str(k))
        np.testing.assert_allclose(smix.numpy(), np.asarray(jmix), atol=2e-6, err_msg=str(k))


def test_sharded_fused_retune_matches_dense():
    """A live retune broadcast into every rank's state mid-run: the
    coefficients swap in the state (nothing rebuilt) and the render equals
    the dense pipeline retuned the same way."""
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings

    S, T, frames = 16, 320, 2200
    build, _, _ = _fused_shard_builder(frames, S, 1, seed=23)
    sharded = ShardedFusedPipeline(build, S, stream_mesh(), master_mode="exact")
    sstate = sharded.init_state()
    dense = Limit(build(S, 0), LimitSettings(), mode="exact")
    dstate = dense.init_state()
    sstate, s1, _ = sharded.emit(sstate, T)
    dstate, d1, _ = dense.emit(dstate, T)
    np.testing.assert_allclose(s1.numpy(), d1.numpy(), atol=2e-6)
    template = sharded.template
    sstate = sharded.retune(sstate, kind="high_pass", freq=900.0, q=0.6)
    dstate = {**dstate, "in": dense.input.retune(dstate["in"], kind="high_pass",
                                                  freq=900.0, q=0.6)}
    assert sharded.template is template
    sstate, s2, _ = sharded.emit(sstate, T)
    dstate, d2, _ = dense.emit(dstate, T)
    np.testing.assert_allclose(s2.numpy(), d2.numpy(), atol=2e-6)
    assert not np.allclose(s2.numpy(), 0.0)


def test_sharded_batch_caches_step(jmesh):
    from rodio_tpu.parallel.sharding import ShardedBatch as JBatch

    datas = _datas(np.random.default_rng(3), 16)
    sb = ShardedBatch(_port_chain(datas), stream_mesh())
    st = sb.init_state()
    st, blocks, valids = sb.emit(st, 128)
    step = sb._steps[128]
    st, blocks, valids = sb.emit(st, 128)
    assert sb._steps[128] is step
    assert tuple(blocks.shape) == (16, 2, 128) and valids.tolist() == [128] * 16
    jb = JBatch(_jax_chain(datas), jmesh)
    jst, jblocks, _ = jb.emit(jb.init_state(), 128)
    jst, jblocks, _ = jb.emit(jst, 128)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(jblocks), atol=1e-6)


def test_batched_buffers_ends_in_state():
    """Per-stream lengths ride the stacked state's ``end``: a shorter
    stream's block is valid up to its end, as the JAX package's."""
    from rodio_tpu.parallel.batch import (
        BatchedChain as JChain, BatchedMixer as JMixer, batched_buffers as jbb)
    from rodio_tpu_torch.parallel.batch import batched_buffers

    rng = np.random.default_rng(5)
    bufs = [rng.uniform(-1, 1, (2, f)).astype(np.float32) for f in (700, 1000, 400)]
    template, st = batched_buffers(2, 48000, bufs, device="cpu")
    assert st["end"].tolist() == [700, 1000, 400]
    ch = BatchedChain(template, st, 3)
    st2, blocks, valids = ch.emit(st, 512)
    st2, blocks, valids = ch.emit(st2, 512)
    assert valids.tolist() == [188, 488, 0]
    jt, jst = jbb(2, 48000, bufs)
    jm = JMixer(JChain(jt, jst, 3))
    _, jo, _ = jm.emit(jm.init_state(), 512)
    _, po, _ = BatchedMixer(ch).emit(st, 512)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-6)
