"""K2's rel0 plans (``agc_plan="rel0" | "rel0f" | "rel0b*" | "rel0c*"``) in
the port against the JAX package's, on the CPU (the plain versions of K2r
and K2b; JAX runs its Pallas kernel in interpret mode).

The input is ``tests/test_fused.py``'s quick-parity data (seed 21, 4 stereo
streams, 26460 frames at 44.1 kHz, resampled to 48 kHz), in blocks of 640
frames (two of the JAX pipeline's 320-frame grid steps). Bounds and why:

- 2e-5 against the JAX package, output and (relative) the rs and gain
  carries: the AGC kernel bound under ROADMAP F4 (XLA:CPU contracts the
  smoother's mul-adds into FMAs); rel0's and rel0f's gain carries equal the
  port's serial plan's bit for bit, and are held to JAX at 1e-4, the
  serial smoother's F4 drift;
- against the port's own serial plan over 9 blocks (past the 4096-frame
  window): 5e-7 for rel0 (tests/test_fused.py:690), 1e-6 for rel0f (its
  packed ring and folded desired gain), 5e-6 for the blocked plans (their
  reassociated composition, tests/test_fused.py:758-761);
- 2e-5 against the port's unfused exact chain (tests/test_fused.py:777);
- the packed ring bit for bit: it holds the rounded square of channel 0 and
  the rounded f32 sum of both channels' squares.
"""
import jax
import numpy as np
import pytest
import torch

from rodio_tpu.flagship import FusedWidePipeline as JFused
from rodio_tpu.flagship import make_flagship as j_make_flagship
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
from rodio_tpu_torch import make_flagship, render_blocks
from rodio_tpu_torch.conversions.resample import Resample
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.effects import AgcSettings, AutomaticGainControl
from rodio_tpu_torch.effects.basic import Amplify
from rodio_tpu_torch.effects.blt import BltFilter
from rodio_tpu_torch.flagship import FusedWidePipeline
from rodio_tpu_torch.ops import fused
from rodio_tpu_torch.utils import trace
from rodio_tpu_torch.parallel.batch import WideMixer
from rodio_tpu_torch.sources.generators import SamplesBuffer

S, T = 4, 640
_rng = np.random.default_rng(21)
WIDE = (_rng.standard_normal((S * 2, 26460)) * 0.2).astype(np.float32)
GAINS = _rng.uniform(0.5, 1.5, S).astype(np.float32) / S
PEAK0 = 0.25  # a peak carry the rel0 plans must leave as it is


def _port(plan, wide=WIDE, rate=44100):
    return FusedWidePipeline(SamplesBuffer(S * 2, rate, wide, device="cpu"),
                             48000, GAINS, S, with_agc=True, agc_plan=plan)


def _port_blocks(node, n_blocks, state=None):
    state = node.init_state() if state is None else state
    state, out, valid = render_blocks(node, state, n_blocks, T)
    assert valid.tolist() == [T] * n_blocks
    return state, out.numpy()


def _jax_blocks(node, state, n_blocks):
    emit = jax.jit(lambda s: node.emit(s, T))
    outs = []
    for _ in range(n_blocks):
        state, o, v = emit(state)
        assert int(v) == T
        outs.append(np.asarray(o))
    return state, np.concatenate(outs, axis=1)


@pytest.mark.parametrize("plan", ["rel0", "rel0f", "rel0b", "rel0b16",
                                  "rel0b64", "rel0c8", "rel0c32"])
def test_plan_matches_jax(plan):
    jn = JFused(JBuffer(S * 2, 44100, WIDE), 48000, GAINS, S, with_agc=True,
                agc_plan=plan)
    js = jn.init_state()
    js = {**js, "agc": js["agc"].at[4:8].set(PEAK0)}  # rows 4-7: the peaks
    js, oj = _jax_blocks(jn, js, 3)
    tn = _port(plan)
    ts = tn.init_state()
    ts["agc"][1] = PEAK0
    ts, ot = _port_blocks(tn, 3, ts)
    np.testing.assert_allclose(ot, oj, atol=2e-5, rtol=0)
    jagc = np.asarray(js["agc"]).reshape(3, 512)[:, :S]
    tagc = ts["agc"].numpy()
    np.testing.assert_allclose(tagc[0], jagc[0], rtol=2e-5, atol=0)
    assert (tagc[1] == PEAK0).all() and (jagc[1] == PEAK0).all()
    if plan in ("rel0", "rel0f"):
        # the sample-by-sample smoother gives the serial plan's gain bit for
        # bit, in each package; the packages differ by the serial smoother's
        # F4 drift (4.06e-5 here), held to 1e-4 as for the group mode
        ss, _ = _port_blocks(_port("serial"), 3)
        np.testing.assert_array_equal(tagc[2], ss["agc"][2].numpy())
        np.testing.assert_allclose(tagc[2], jagc[2], rtol=1e-4, atol=0)
    else:
        np.testing.assert_allclose(tagc[2], jagc[2], rtol=2e-5, atol=0)


@pytest.fixture(scope="module")
def serial9():
    return _port_blocks(_port("serial"), 9)[1]


@pytest.mark.parametrize("plan", fused.AGC_REL0_PLANS)
def test_plan_tracks_the_serial_plan(plan, serial9):
    """9 blocks (5760 frames): the squares leave the window, the ring
    wraps."""
    bound = {"rel0": 5e-7, "rel0f": 1e-6}.get(plan, 5e-6)
    _, out = _port_blocks(_port(plan), 9)
    np.testing.assert_allclose(out, serial9, atol=bound, rtol=0)


@pytest.fixture(scope="module")
def exact3():
    ch = Resample(SamplesBuffer(S * 2, 44100, WIDE, device="cpu"), 48000)
    ch = BltFilter(ch, "low_pass", 2000.0, 0.5, mode="exact")
    ch = AutomaticGainControl(ch, AgcSettings(), mode="exact", streams=S)
    ch = WideMixer(Amplify(ch, np.repeat(GAINS, 2)), S)
    return _port_blocks(ch, 3)[1]


@pytest.mark.parametrize("plan", fused.AGC_REL0_PLANS)
def test_plan_tracks_the_exact_chain(plan, exact3):
    _, out = _port_blocks(_port(plan), 3)
    np.testing.assert_allclose(out, exact3, atol=2e-5, rtol=0)


@pytest.mark.parametrize("plan", ["rel0", "rel0f", "rel0b16", "rel0c16"])
def test_ring_basis_is_the_plans(plan):
    """The ring after one block against the port's own biquad output (the
    unfused Resample -> BltFilter, which the fused plain version equals)."""
    ts, _ = _port_blocks(_port(plan), 1)
    ch = BltFilter(Resample(SamplesBuffer(S * 2, 44100, WIDE, device="cpu"), 48000),
                   "low_pass", 2000.0, 0.5, mode="exact")
    _, y, _ = ch.emit(ch.init_state(), T)
    sq = (y * y).reshape(S, 2, T)
    if plan == "rel0":
        want = sq
    else:
        want = torch.stack([sq[:, 0], sq[:, 0] + sq[:, 1]], 1)
    want = want.reshape(2 * S, T).to(torch.bfloat16).T
    assert torch.equal(ts["ring"][:T], want)
    assert not ts["ring"][T:].any()
    if plan != "rel0":  # not the sum of the rounded squares
        lo_hi = sq.to(torch.bfloat16).float()
        assert not torch.equal(ts["ring"][:T, 1::2].float(), (lo_hi[:, 0] + lo_hi[:, 1]).T)


def test_rel0b16_state_carried_from_jax_into_the_port():
    """2 blocks in JAX, the state carried across, block 3 in the port,
    against JAX's block 3; the carried ring holds JAX's packed lanes."""
    kw = dict(seconds=0.5, seed=4, scan_mode="fused", with_agc=True,
              agc_plan="rel0b16", precision="int2")
    jn, js = j_make_flagship(S, **kw)
    tn, _ = make_flagship(S, device="cpu", **kw)
    js2, _ = _jax_blocks(jn, js, 2)
    _, oj3 = _jax_blocks(jn, js2, 1)
    ts = state_from_jax(tn, jax.device_get(js2))
    # JAX's ring: [slots, m*to, 8, 128], frame f at slot (f // m*to) % slots,
    # row f % m*to; lane c*512 + s holds the packed value c of stream s
    jring = np.asarray(js2["in"]["ring"]).astype(np.float32)
    slots, mto = jring.shape[:2]
    jring = jring.reshape(slots, mto, 2, 512)[:, :, :, :S]
    f = np.arange(2 * T)
    want = jring[(f // mto) % slots, f % mto].transpose(0, 2, 1).reshape(2 * T, 2 * S)
    got = ts["in"]["ring"].float().numpy()
    np.testing.assert_array_equal(got[:2 * T], want)
    assert not got[2 * T:].any()
    np.testing.assert_array_equal(ts["in"]["agc"].numpy()[1], 0.0)
    ts, ot, _ = render_blocks(tn, ts, 1, T)
    np.testing.assert_allclose(ot.numpy(), oj3, atol=2e-5, rtol=0)


def test_blocked_plan_refuses_blocks_off_the_step_grid():
    node = _port("rel0b16")
    st = node.init_state()
    with pytest.raises(ValueError, match="m\\*to = 320"):
        node.emit(st, 600)
    left, wts = node._taps(320, 320)  # the second grid step
    kw = dict(gains=st["gains"], coeffs=st["coeffs"], bq=st["bq"],
              agc=st["agc"], agc_params=st["agc_par"], ring=st["ring"],
              ring_row=320, agc_plan="rel0b16", step_frames=320)
    fused.fused_resample_biquad_agc_mix(st["pcm"], left, wts, **kw)
    for bad in (dict(ring_row=32), dict(step_frames=300), dict(agc_group=16)):
        with pytest.raises(ValueError, match="rel0b16"):
            fused.fused_resample_biquad_agc_mix(st["pcm"], left, wts, **{**kw, **bad})
    assert trace.counts["rt_fused_resample_biquad_agc_blocked_mix"] == 0
    assert trace.counts["rt_fused_resample_biquad_agc_rel0_mix"] == 0


def test_plans_at_22050_match_jax():
    """22.05 -> 48 kHz: m*to = 640, so rel0b's chunks are 80 frames (longer
    than the card kernel's 64-frame tile), rel0c32's 20."""
    wide = WIDE[:, :13230]
    for plan in ("rel0b", "rel0c32"):
        jn = JFused(JBuffer(S * 2, 22050, wide), 48000, GAINS, S,
                    with_agc=True, agc_plan=plan)
        _, oj = _jax_blocks(jn, jn.init_state(), 2)
        _, ot = _port_blocks(_port(plan, wide, 22050), 2)
        np.testing.assert_allclose(ot, oj, atol=2e-5, rtol=0)
