"""The port's seek and checkpoints, on the CPU.

The cases of ``tests/test_seek.py`` that need no decoded asset (its asset
cases skip without ``/root/reference/assets``, ``test_seek.py:26``, and
need ``io``, which is not ported yet), with their own bounds; the O(pre-roll)
case is ``slow`` as in the original. Beside them:

- ``test_baseline_configs.py::test_checkpoint_resume_exact``, ported: the
  continuation from a loaded checkpoint is bit-equal to the uninterrupted
  one; a checkpoint of another structure or shape is refused;
- a mid-stream JAX state carried across by ``state_from_jax`` continues
  bit-equal in the port (a chain whose ops are exact in both packages);
- ``seek_state`` against the JAX package's on the same chain, and its cost
  counted in replayed blocks.
"""
import jax
import numpy as np
import pytest
import torch

from rodio_tpu_torch import render
from rodio_tpu_torch.conversions import VariSpeed
from rodio_tpu_torch.control import Player, mixer
from rodio_tpu_torch.core.errors import SeekNotSupported
from rodio_tpu_torch.effects import AgcSettings, AutomaticGainControl, BltFilter, Limit, LimitSettings
from rodio_tpu_torch.graph import seek
from rodio_tpu_torch.graph.checkpoint import checkpoint_metadata, load_state, save_state
from rodio_tpu_torch.graph.seek import _chain_pre_roll, _innermost, seek_state
from rodio_tpu_torch.sources import SamplesBuffer, SineWave

CPU = dict(device="cpu")


def test_channel_order_preserved_after_seek():
    frames = 10000
    left = np.linspace(0, 1, frames, dtype=np.float32)
    buf = SamplesBuffer(2, 48000, np.stack([left, -left]), **CPU)
    state = buf.seek_state(buf.init_state(), 0.1)
    _, block, _ = buf.emit(state, 64)
    block = block.numpy()
    assert np.all(block[0] >= 0) and np.all(block[1] <= 0)
    np.testing.assert_array_equal(block[0], -block[1])


def test_generic_seek_through_effect_chain():
    """seek_state() fast-forwards a stateful chain: the filter tail at the
    target matches a straight play-through."""
    data = np.random.default_rng(5).uniform(-1, 1, (2, 12000)).astype(np.float32)
    node = SamplesBuffer(2, 48000, data, **CPU).low_pass(1000.0).amplify(0.9)
    full = render(node)
    st = seek_state(node, 0.1, step_frames=1024)
    _, block, _ = node.emit(st, 256)
    np.testing.assert_allclose(block.numpy(), full[:, 4800:4800 + 256], atol=1e-7)


def test_player_try_seek():
    data = np.random.default_rng(6).uniform(-1, 1, 48000).astype(np.float32)
    tx, rx = mixer(1, 48000, **CPU)
    player = Player.connect_new(tx, block_frames=128)
    player.append(SamplesBuffer(1, 48000, data, **CPU))
    rx.next_block(128)
    player.try_seek(0.5)
    block, _ = rx.next_block(128)
    np.testing.assert_allclose(block[0].numpy(), data[24000:24128], atol=1e-7)


def test_seek_pure_filter_chain_tight_parity(rng):
    """Seek with a 0.25 s pre-roll through a biquad matches the full replay
    (the filter's memory decays in milliseconds)."""
    rate = 48000
    data = (rng.standard_normal((2, rate * 3)) * 0.3).astype(np.float32)
    node = BltFilter(SamplesBuffer(2, rate, data, **CPU), "low_pass", 1500.0, 0.5, mode="exact")
    s_fast = seek_state(node, 2.0)
    assert seek.replayed_blocks == -(-int(0.25 * rate) // 8192)  # O(pre-roll)
    s_full = seek_state(node, 2.0, pre_roll=1e9)
    assert seek.replayed_blocks == -(-2 * rate // 8192)
    _, oa, va = node.emit(s_fast, 2048)
    _, ob, vb = node.emit(s_full, 2048)
    assert int(va) == int(vb) == 2048
    np.testing.assert_allclose(oa.numpy(), ob.numpy(), atol=1e-5)


def test_seek_varispeed_live_ratio_override(rng):
    """seek_state(varispeed_ratio=) maps the target through the live ratio
    and seeds the rebuilt state with it; ratio0 is restored."""
    rate = 48000
    data = (rng.standard_normal((1, rate * 4)) * 0.3).astype(np.float32)
    node = VariSpeed(SamplesBuffer(1, rate, data, **CPU), ratio=1.0, max_block=2048)
    st = seek_state(node, 1.0, varispeed_ratio=2.0)
    assert float(st["ratio"]) == 2.0
    assert node.ratio0 == 1.0
    _, out, _ = node.emit(st, 512)
    ref = data[0, 2 * rate: 2 * rate + 1024: 2]
    err = np.abs(out[0, :512].numpy() - ref[:512]).mean()
    assert err < 0.05, f"seek landed at the wrong source position: {err}"


def test_seek_pre_roll_scales_to_chain_time_constants():
    """The default pre-roll is 10 of the chain's slowest time constants, so
    an AGC chain lands within 1e-4 of the full replay (the original's
    attack of 0.5 s asks for a 5 s pre-roll; the seek runs with 0.05 s, a
    0.5 s pre-roll, to keep the per-sample exact AGC short on the CPU)."""
    rate = 48000
    t = np.arange(rate * 2, dtype=np.float32)
    data = np.stack([np.sin(2 * np.pi * 220 * t / rate),
                     np.sin(2 * np.pi * 331 * t / rate)]).astype(np.float32) * 0.5

    def build(attack, release):
        return AutomaticGainControl(SamplesBuffer(2, rate, data, **CPU),
                                    AgcSettings(attack_time=attack, release_time=release),
                                    mode="exact")

    chain, _ = _innermost(build(0.5, 0.2))
    assert _chain_pre_roll(chain) == pytest.approx(5.0)
    node = build(0.05, 0.02)
    chain, _ = _innermost(node)
    assert _chain_pre_roll(chain) == pytest.approx(0.5)
    s_auto = seek_state(node, 1.2)
    ref = build(0.05, 0.02)
    s_full = seek_state(ref, 1.2, pre_roll=1e9)
    _, out_a, va = node.emit(s_auto, 2048)
    _, out_f, vf = ref.emit(s_full, 2048)
    assert int(va) == int(vf) == 2048
    np.testing.assert_allclose(out_a.numpy(), out_f.numpy(), atol=1e-4)


def test_seek_matches_jax_seek_state():
    """The port's seek_state and the JAX package's land on the same state:
    the source position and a filter warmed by the same pre-roll."""
    from rodio_tpu.graph.seek import seek_state as jseek
    from rodio_tpu.sources.generators import SamplesBuffer as JBuffer

    data = (np.random.default_rng(2).integers(-2048, 2049, (2, 30000)) / 4096.0).astype(
        np.float32)
    jnode = JBuffer(2, 48000, data).amplify(0.5)
    pnode = SamplesBuffer(2, 48000, data, **CPU).amplify(0.5)
    js = jseek(jnode, 0.4, step_frames=1024)
    ps = seek_state(pnode, 0.4, step_frames=1024)
    assert int(js["in"]["pos"]) == int(ps["in"]["pos"]) == int(0.4 * 48000)
    _, jb, _ = jnode.emit(js, 512)
    _, pb, _ = pnode.emit(ps, 512)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


def test_seek_refuses_live_source():
    class Live(SamplesBuffer):
        LIVE = True

    node = Live(1, 48000, np.zeros(4800, np.float32), **CPU).amplify(2.0)
    with pytest.raises(SeekNotSupported) as e:
        seek_state(node, 0.05)
    assert e.value.source_intact


@pytest.mark.slow
def test_seek_stateful_chain_is_o_preroll():
    """Seeking deep into a stateful chain costs O(pre_roll), not
    O(position): the same blocks are replayed at 60 s as at 1 s."""
    rate = 48000
    frames = rate * 120
    t = np.arange(frames, dtype=np.float32)
    data = np.stack([np.sin(2 * np.pi * 220 * t / rate),
                     np.sin(2 * np.pi * 331 * t / rate)]).astype(np.float32) * 0.3

    def build():
        node = BltFilter(SamplesBuffer(2, rate, data, **CPU), "low_pass", 2000.0, 0.5,
                         mode="exact")
        return AutomaticGainControl(node, AgcSettings(attack_time=0.05, release_time=0.02),
                                    mode="exact")

    node = build()
    seek_state(node, 1.0)
    near = seek.replayed_blocks
    state = seek_state(node, 60.0)
    assert seek.replayed_blocks == near
    state, out, valid = node.emit(state, 4096)
    ref = build()
    rstate = seek_state(ref, 60.0, pre_roll=2.0)
    rstate, rout, rvalid = ref.emit(rstate, 4096)
    assert int(valid) == int(rvalid) == 4096
    np.testing.assert_allclose(out.numpy(), rout.numpy(), atol=2e-3)


# -- checkpoints -----------------------------------------------------------

def _ckpt_node():
    return Limit(SineWave(440.0, **CPU).amplify(1.5).low_pass(3000.0), LimitSettings())


def test_checkpoint_resume_exact(tmp_path):
    """Save and resume mid-stream: the identical continuation."""
    node = _ckpt_node()
    state = node.init_state()
    for _ in range(5):
        state, _, _ = node.emit(state, 256)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state, metadata={"pos_blocks": 5})
    state2 = load_state(path, node.init_state())
    assert checkpoint_metadata(path)["pos_blocks"] == 5
    for _ in range(3):
        state, out_a, _ = node.emit(state, 256)
        state2, out_b, _ = node.emit(state2, 256)
        np.testing.assert_array_equal(out_a.numpy(), out_b.numpy())


def test_checkpoint_refuses_other_graph(tmp_path):
    node = _ckpt_node()
    path = str(tmp_path / "ckpt.npz")
    save_state(path, node.init_state())
    other = Limit(SineWave(440.0, **CPU).amplify(1.5), LimitSettings())  # no filter
    with pytest.raises(ValueError, match="leaves|structure"):
        load_state(path, other.init_state())
    buf = SamplesBuffer(2, 48000, np.zeros((2, 100), np.float32), **CPU).amplify([0.5, 0.25])
    save_state(path, buf.init_state())
    wider = SamplesBuffer(2, 48000, np.zeros((2, 300), np.float32), **CPU).amplify([0.5, 0.25])
    with pytest.raises(ValueError, match="shape"):
        load_state(path, wider.init_state())


def test_checkpoint_of_control_and_noise_states(tmp_path):
    """States with bool, int64 and key leaves (VariSpeed, Dither, a
    Player's control node) round-trip with their dtypes."""
    from rodio_tpu_torch.control import PlayerControl

    data = np.random.default_rng(1).uniform(-1, 1, (2, 5000)).astype(np.float32)
    node = PlayerControl(VariSpeed(SamplesBuffer(2, 48000, data, **CPU), ratio=1.5,
                                   max_block=512).dither(16, "highpass"), volume=0.5)
    state = node.init_state()
    for _ in range(3):
        state, _, _ = node.emit(state, 512)
    path = str(tmp_path / "c.npz")
    save_state(path, state)
    state2 = load_state(path, node.init_state())
    assert state2["paused"].dtype == torch.bool and state2["in"]["key"].dtype == torch.int64
    for _ in range(3):
        state, a, _ = node.emit(state, 512)
        state2, b, _ = node.emit(state2, 512)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_state_from_jax_mid_stream_continues():
    """A JAX render stopped mid-stream continues in the port: a VariSpeed
    (at ratio 1.5 its lerp fractions are 0 and 1/2, exact in both
    packages) into an Amplify and a TPDF Dither."""
    import jax.numpy as jnp

    from rodio_tpu.conversions.varispeed import VariSpeed as JVariSpeed
    from rodio_tpu.effects.dither import Dither as JDither
    from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
    from rodio_tpu_torch.convert import state_from_jax
    from rodio_tpu_torch.effects import Dither

    data = (np.random.default_rng(7).integers(-4096, 4097, (2, 9000)) / 8192.0).astype(
        np.float32)
    jnode = JDither(JVariSpeed(JBuffer(2, 48000, data), ratio=1.5, max_block=512)
                    .amplify(0.5), 16, "tpdf", seed=5)
    pnode = Dither(VariSpeed(SamplesBuffer(2, 48000, data, **CPU), ratio=1.5, max_block=512)
                   .amplify(0.5), 16, "tpdf", seed=5)
    js = jnode.init_state()
    step = jax.jit(lambda s: jnode.emit(s, 512))
    for _ in range(4):
        js, _, _ = step(js)
    jstate = jax.tree_util.tree_map(
        lambda x: jax.random.key_data(x) if jnp.issubdtype(x.dtype, jax.dtypes.prng_key)
        else x, js)
    ps = state_from_jax(pnode, jax.device_get(jstate))
    for _ in range(4):
        js, jb, jv = step(js)
        ps, pb, pv = pnode.emit(ps, 512)
        assert int(jv) == int(pv)
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
