"""The group-rate fused AGC (``agc_group``, K2's group branch, K2g) against
the JAX package's, on the CPU.

Both packages build ``make_flagship(8, seconds=2.0, ..., agc_group=AG)``
from the same seed and render 9 blocks of 640 (5760 frames, past the
4096-frame window: the group sums leave the window sum). Bounds:

- 2e-5 against the JAX package, the AGC kernel bound under ROADMAP F4 (the
  JAX package on XLA:CPU contracts the smoother's mul-adds into FMAs);
- 2e-3 relative against the port's own serial plan: the JAX package's
  budget for the group mode's deviation (tests/test_fused.py:783-804);
- 0.0 for the plain version against itself through ``state_from_jax``: a
  JAX state carried across continues as the port's own state does, to the
  F4 bound.
"""
import jax
import numpy as np
import pytest
import torch

from rodio_tpu.flagship import make_flagship as j_make_flagship
from rodio_tpu_torch import make_flagship, render_blocks
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.flagship import FusedWidePipeline
from rodio_tpu_torch.utils import trace
from rodio_tpu_torch.sources.generators import SamplesBuffer

KW = dict(seconds=2.0, seed=3, scan_mode="fused", with_agc=True, max_block=1920)


def _jax_blocks(node, state, n_blocks, T=640):
    emit = jax.jit(lambda s: node.emit(s, T))
    outs = []
    for _ in range(n_blocks):
        state, o, v = emit(state)
        assert int(v) == T
        outs.append(np.asarray(o))
    return state, np.concatenate(outs, axis=1)


@pytest.mark.parametrize("ag", [8, 16])
def test_group_agc_matches_jax_and_tracks_the_serial_plan(ag):
    jn, js = j_make_flagship(8, agc_group=ag, **KW)
    tn, ts = make_flagship(8, agc_group=ag, device="cpu", **KW)
    assert ts["in"]["ring"].shape == (4096 // ag, 8)
    js, oj = _jax_blocks(jn, js, 9)
    ts, ot, vt = render_blocks(tn, ts, 9, 640)
    assert vt.tolist() == [640] * 9
    np.testing.assert_allclose(ot.numpy(), oj, atol=2e-5, rtol=0)
    jagc = np.asarray(js["in"]["agc"]).reshape(3, 512)[:, :8]
    # the gain carry drifts with F4 (1e-4, the JAX package's CPU bound)
    np.testing.assert_allclose(ts["in"]["agc"].numpy(), jagc, rtol=1e-4, atol=1e-6)
    # the port's serial plan, per sample: the group mode's documented budget
    sn, ss = make_flagship(8, device="cpu", **KW)
    _, os_, _ = render_blocks(sn, ss, 9, 640)
    rel = np.abs(ot.numpy() - os_.numpy()) / (np.abs(os_.numpy()) + 1e-6)
    assert rel.max() < 2e-3


def test_group_agc_longer_than_a_tile_matches_jax():
    """At 22.05 -> 48 kHz (m*to = 640) a group of 128 frames spans two of
    the card kernel's 64-frame tiles; the bound against the JAX package
    as above (the 2e-3 budget against the serial plan is the JAX package's
    for groups of 16)."""
    kw = dict(KW, in_rate=22050)
    jn, js = j_make_flagship(8, agc_group=128, **kw)
    tn, ts = make_flagship(8, agc_group=128, device="cpu", **kw)
    assert ts["in"]["ring"].shape == (32, 8)
    _, oj = _jax_blocks(jn, js, 9)
    _, ot, vt = render_blocks(tn, ts, 9, 640)
    assert vt.tolist() == [640] * 9
    np.testing.assert_allclose(ot.numpy(), oj, atol=2e-5, rtol=0)


@pytest.mark.parametrize("ag", [1, 7, 3])
def test_group_agc_refuses_what_jax_refuses(ag):
    with pytest.raises(ValueError, match="agc_group"):
        make_flagship(4, seconds=0.2, scan_mode="fused", with_agc=True,
                      agc_group=ag, device="cpu")
    with pytest.raises(AssertionError, match="agc_group"):
        j_make_flagship(4, seconds=0.2, scan_mode="fused", with_agc=True,
                        agc_group=ag)


def test_group_agc_admits_what_jax_admits():
    """m*to = 320 at 44.1 -> 48 kHz: groups of 2 .. 64 frames; 128 divides
    4096 but not 320. At 22.05 kHz m*to = 640 admits 128; at 11.025 kHz
    (to = 640) m is 1 with an int-piece precision (640: up to 128) and 2
    with "highest" (1280: up to 256)."""
    def pipe(rate, ag, precision="auto"):
        buf = SamplesBuffer(4, rate, np.zeros((4, 100), np.float32), device="cpu")
        return FusedWidePipeline(buf, 48000, np.ones(2, np.float32), 2,
                                 with_agc=True, agc_group=ag, precision=precision)

    for rate, ag, precision in ((44100, 2, "auto"), (44100, 4, "auto"),
                                (44100, 32, "auto"), (44100, 64, "auto"),
                                (22050, 128, "auto"), (11025, 128, "int3"),
                                (11025, 256, "highest")):
        pipe(rate, ag, precision)
    for rate, ag, precision in ((44100, 128, "auto"), (22050, 256, "auto"),
                                (11025, 256, "int3")):
        with pytest.raises(ValueError, match="agc_group"):
            pipe(rate, ag, precision)


def test_group_agc_block_of_partial_groups_raises():
    tn, ts = make_flagship(4, seconds=0.2, scan_mode="fused", with_agc=True,
                           agc_group=16, device="cpu")
    with pytest.raises(ValueError, match="agc_group"):
        tn.emit(ts, 600)


def test_group_agc_live_params_match_jax():
    kw = dict(seconds=0.5, seed=9, scan_mode="fused", with_agc=True, agc_group=8)
    jn, js = j_make_flagship(4, **kw)
    tn, ts = make_flagship(4, device="cpu", **kw)
    js, o1 = _jax_blocks(jn, js, 2)
    ts, t1, _ = render_blocks(tn, ts, 2, 640)
    knobs = dict(attack=0.1, release=0.05)
    js = {**js, "in": jn.input.set_agc_params(js["in"], **knobs)}
    ts = {**ts, "in": tn.input.set_agc_params(ts["in"], **knobs)}
    np.testing.assert_array_equal(ts["in"]["agc_par"].numpy(),
                                  np.asarray(js["in"]["agc_par"]))
    _, o2 = _jax_blocks(jn, js, 3)
    _, t2, _ = render_blocks(tn, ts, 3, 640)
    np.testing.assert_allclose(np.concatenate([t1.numpy(), t2.numpy()], 1),
                               np.concatenate([o1, o2], 1), atol=2e-5, rtol=0)


def test_group_agc_state_carried_from_jax_into_the_port():
    """8 blocks (5120 frames, past the window and over the JAX ring's slot
    wrap) in JAX, the state carried across, 3 more in the port, against 11
    blocks in JAX; and the carried ring continues as the port's own."""
    kw = dict(seconds=0.5, seed=4, scan_mode="fused", with_agc=True, agc_group=16)
    jn, js = j_make_flagship(8, **kw)
    tn, _ = make_flagship(8, device="cpu", **kw)
    js8, _ = _jax_blocks(jn, js, 8)
    _, o3 = _jax_blocks(jn, js8, 3)
    ts = state_from_jax(tn, jax.device_get(js8))
    assert ts["in"]["ring"].shape == (256, 8)
    ts, ot, _ = render_blocks(tn, ts, 3, 640)
    np.testing.assert_allclose(ot.numpy(), o3, atol=2e-5, rtol=0)
    tn2, ts2 = make_flagship(8, device="cpu", **kw)
    ts2, _, _ = render_blocks(tn2, ts2, 11, 640)
    # group sums of the same frames, rounded to bf16 from F4-close values
    np.testing.assert_allclose(ts["in"]["ring"].float().numpy(),
                               ts2["in"]["ring"].float().numpy(),
                               rtol=2e-2, atol=1e-9)


def test_group_plain_reads_its_own_sums_past_the_window():
    """A block longer than the window (n > 4096) takes the sums leaving
    the window from the block itself, as the serial plan does: the same
    output as the same frames in blocks of 640."""
    a, sa = make_flagship(4, seconds=0.5, seed=5, scan_mode="fused",
                          with_agc=True, agc_group=32, max_block=5120, device="cpu")
    b, sb = make_flagship(4, seconds=0.5, seed=5, scan_mode="fused",
                          with_agc=True, agc_group=32, max_block=5120, device="cpu")
    sa, oa, _ = render_blocks(a, sa, 1, 5120)
    sb, ob, _ = render_blocks(b, sb, 8, 640)
    np.testing.assert_array_equal(oa.numpy(), ob.numpy())
    assert torch.equal(sa["in"]["ring"], sb["in"]["ring"])
    # the plain version, on the CPU
    assert trace.counts["rt_fused_resample_biquad_agc_group_mix"] == 0
