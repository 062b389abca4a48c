"""The port's flagship slice against the JAX package's, on the CPU.

Both packages build ``make_flagship(8, seconds=0.5, ...)`` from the same
seed (identical numpy PCM and gains) and render blocks of 640. Bounds:
1e-6 against the JAX fused path (another lerp and mix summation order, the
gain before the biquad), 1e-5 against the JAX unfused chain away from the
drain frame (the JAX package's own fused-vs-unfused bound).

With the AGC on: 2e-5 against the JAX package (the AGC kernel bound). The
JAX package on XLA:CPU contracts the smoother's ``g*att + des*(1-att)``
into an FMA (ROADMAP F4); through the default attack coefficient, 1 - 5e-6,
that drifts ~1e-5 from the port within a few blocks, where the port's own
fused, "exact" and "pallas" chains agree to 0 and its exact AGC equals the
scalar oracle bit for bit (``tests/test_torch_agc.py``). So the port's
fused AGC is held to its unfused exact chain at 5e-7, the JAX package's
own fused-vs-exact bound.
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rodio_tpu.flagship import make_flagship as j_make_flagship
from rodio_tpu_torch import make_flagship, render_blocks
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.effects import AgcSettings
from rodio_tpu_torch.flagship import FusedWidePipeline
from rodio_tpu_torch.sources.generators import SamplesBuffer


def _jax_blocks(node, state, n_blocks, T=640):
    emit = jax.jit(lambda s: node.emit(s, T))
    outs, valids = [], []
    for _ in range(n_blocks):
        state, o, v = emit(state)
        outs.append(np.asarray(o))
        valids.append(int(v))
    return state, np.concatenate(outs, axis=1), valids


def test_fused_slice_matches_jax_fused_and_unfused():
    jf, jfs = j_make_flagship(8, seconds=0.5, scan_mode="fused")
    je, jes = j_make_flagship(8, seconds=0.5, scan_mode="exact")
    tn, ts = make_flagship(8, seconds=0.5, scan_mode="fused", device="cpu")
    assert tn.input.precision == jf.input.precision
    _, of, vf = _jax_blocks(jf, jfs, 5)
    _, oe, ve = _jax_blocks(je, jes, 5)
    _, ot, vt = render_blocks(tn, ts, 5, 640)
    assert vt.tolist() == vf == ve == [640] * 5
    np.testing.assert_allclose(ot.numpy(), of, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ot.numpy(), oe, atol=1e-5, rtol=0)


def test_unfused_slice_matches_jax_exact():
    je, jes = j_make_flagship(8, seconds=0.5, scan_mode="exact")
    tn, ts = make_flagship(8, seconds=0.5, scan_mode="exact", device="cpu")
    assert tn.total_frames() == je.total_frames()
    _, oe, ve = _jax_blocks(je, jes, 5)
    _, ot, vt = render_blocks(tn, ts, 5, 640)
    assert vt.tolist() == ve
    np.testing.assert_allclose(ot.numpy(), oe, atol=1e-6, rtol=0)


def test_fused_slice_through_the_drain():
    """0.3 s of input: the render runs past the end; valid counts and
    outputs match the JAX fused path, and the unfused chain away from the
    one drain frame."""
    jf, jfs = j_make_flagship(4, seconds=0.3, seed=2, scan_mode="fused")
    je, jes = j_make_flagship(4, seconds=0.3, seed=2, scan_mode="exact")
    tn, ts = make_flagship(4, seconds=0.3, seed=2, scan_mode="fused", device="cpu")
    _, of, vf = _jax_blocks(jf, jfs, 24)
    _, oe, ve = _jax_blocks(je, jes, 24)
    _, ot, vt = render_blocks(tn, ts, 24, 640)
    assert vt.tolist() == vf == ve
    assert vf[-1] == 0 and 0 < min(v for v in vf if v) < 640
    np.testing.assert_allclose(ot.numpy(), of, atol=1e-6, rtol=0)
    drain = sum(vf) - 1
    keep = np.ones(ot.shape[1], bool)
    keep[drain] = False
    np.testing.assert_allclose(ot.numpy()[:, keep], oe[:, keep], atol=1e-5, rtol=0)


@pytest.mark.parametrize("scan_mode", ["fused", "exact"])
def test_state_carried_from_jax_into_the_port(scan_mode):
    """Render 3 blocks in JAX, carry the state across, render 3 more in the
    port; compare with 6 blocks in JAX."""
    jn, js = j_make_flagship(8, seconds=0.5, seed=4, scan_mode=scan_mode)
    tn, _ = make_flagship(8, seconds=0.5, seed=4, scan_mode=scan_mode, device="cpu")
    js3, o3, _ = _jax_blocks(jn, js, 3)
    _, o6, v6 = _jax_blocks(jn, js3, 3)
    ts = state_from_jax(tn, jax.device_get(js3))
    ts, ot, vt = render_blocks(tn, ts, 3, 640)
    assert vt.tolist() == v6
    np.testing.assert_allclose(ot.numpy(), o6, atol=1e-6, rtol=0)
    assert np.abs(o3).max() > 0


def test_fused_retune_matches_jax():
    jf, jfs = j_make_flagship(8, seconds=0.5, seed=1, scan_mode="fused")
    tn, ts = make_flagship(8, seconds=0.5, seed=1, scan_mode="fused", device="cpu")
    jfs, _, _ = _jax_blocks(jf, jfs, 2)
    ts, _, _ = render_blocks(tn, ts, 2, 640)
    jfs = {**jfs, "in": jf.input.retune(jfs["in"], freq=900.0, q=0.8)}
    ts = {**ts, "in": tn.input.retune(ts["in"], freq=900.0, q=0.8)}
    np.testing.assert_array_equal(ts["in"]["coeffs"].numpy(),
                                  np.asarray(jfs["in"]["coeffs"]))
    _, of, _ = _jax_blocks(jf, jfs, 3)
    _, ot, _ = render_blocks(tn, ts, 3, 640)
    np.testing.assert_allclose(ot.numpy(), of, atol=1e-6, rtol=0)


def _grid_pcm(bits, frames=4000, seed=3):
    k = np.random.default_rng(seed).integers(-2 ** (bits - 3), 2 ** (bits - 3),
                                             size=(2, frames))
    return (k / 2.0 ** (bits - 1)).astype(np.float32)


@pytest.mark.parametrize("bits,label", [(16, "i8"), (24, "i24")])
def test_precision_probe_matches_jax(bits, label):
    pcm = _grid_pcm(bits)
    jn, _ = j_make_flagship(4, seconds=0.1, scan_mode="fused", source_pcm=pcm)
    tn, _ = make_flagship(4, seconds=0.1, scan_mode="fused", source_pcm=pcm, device="cpu")
    assert tn.input.precision == jn.input.precision == label
    tn2, _ = make_flagship(4, seconds=0.1, scan_mode="fused", source_pcm=pcm,
                           precision=label, device="cpu")
    assert tn2.input.precision == label


@pytest.mark.parametrize("precision", ["i8", "i24"])
def test_precision_off_grid_raises(precision):
    with pytest.raises(ValueError, match="grid"):
        make_flagship(4, seconds=0.1, scan_mode="fused", precision=precision, device="cpu")
    with pytest.raises(AssertionError):
        j_make_flagship(4, seconds=0.1, scan_mode="fused", precision=precision)


def test_refused_configurations():
    buf = SamplesBuffer(4, 44100, np.zeros((4, 100), np.float32), device="cpu")
    with pytest.raises(ValueError, match="agc_group"):  # 7 divides no m*to
        FusedWidePipeline(buf, 48000, np.ones(2, np.float32), 2, with_agc=True,
                          agc_group=7)
    # the JAX package's refusals of a rel0 plan: a nonzero release, a group,
    # RPC not dividing m*to (48 -> 44.1 kHz: m*to = 294, 8 does not divide it)
    for kw in (dict(agc_settings=AgcSettings(release_time=0.05)), dict(agc_group=16)):
        with pytest.raises(ValueError, match="rel0b16"):
            FusedWidePipeline(buf, 48000, np.ones(2, np.float32), 2, with_agc=True,
                              agc_plan="rel0b16", **kw)
    buf48 = SamplesBuffer(4, 48000, np.zeros((4, 100), np.float32), device="cpu")
    with pytest.raises(ValueError, match="294"):
        FusedWidePipeline(buf48, 44100, np.ones(2, np.float32), 2, with_agc=True,
                          agc_plan="rel0b")
    rel0 = FusedWidePipeline(buf, 48000, np.ones(2, np.float32), 2, with_agc=True,
                             agc_plan="rel0b16")
    st = rel0.init_state()
    with pytest.raises(ValueError, match="rel0"):
        rel0.set_agc_params(st, release=0.05)
    rel0.set_agc_params(st, release=0.0, attack=0.1)
    with pytest.raises(ValueError, match="stereo"):
        FusedWidePipeline(buf, 48000, np.ones(4, np.float32), 4, with_agc=True)
    with pytest.raises(ValueError, match="identity"):
        FusedWidePipeline(SamplesBuffer(4, 48000, np.zeros((4, 100), np.float32), device="cpu"),
                          48000, np.ones(2, np.float32), 2)
    with pytest.raises(ValueError):
        make_flagship(4, seconds=0.1, scan_mode="fused", precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="parallel"):
        make_flagship(4, seconds=0.1, scan_mode="assoc", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        make_flagship(4, seconds=0.1, scan_mode="bogus", device="cpu")
    # the associative modes (M10) build
    for mode in ("auto", "parallel"):
        node, st = make_flagship(4, seconds=0.1, scan_mode=mode, with_agc=True,
                                 device="cpu")
        assert node.emit(st, 640)[1].shape == (2, 640)


def test_agc_flagship_builds_in_every_ported_mode():
    for mode in ("fused", "exact", "pallas"):
        node, st = make_flagship(4, seconds=0.1, scan_mode=mode, with_agc=True, device="cpu")
        _, out, valid = node.emit(st, 640)
        assert out.shape == (2, 640) and int(valid) == 640
        assert float(out.abs().max()) > 0


def test_fused_agc_matches_jax_fused():
    jf, jfs = j_make_flagship(4, seconds=0.5, seed=7, scan_mode="fused",
                              with_agc=True)
    tn, ts = make_flagship(4, seconds=0.5, seed=7, scan_mode="fused",
                           with_agc=True, device="cpu")
    assert tn.input.precision == jf.input.precision
    jfs, of, vf = _jax_blocks(jf, jfs, 4)
    ts, ot, vt = render_blocks(tn, ts, 4, 640)
    assert vt.tolist() == vf == [640] * 4
    np.testing.assert_allclose(ot.numpy(), of, atol=2e-5, rtol=0)
    jagc = np.asarray(jfs["in"]["agc"]).reshape(3, 512)[:, :4]
    # the gain carry drifts with F4 (1e-4, the JAX package's CPU bound)
    np.testing.assert_allclose(ts["in"]["agc"].numpy(), jagc, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["exact", "pallas"])
def test_fused_agc_matches_the_ports_unfused_chain(mode):
    """9 blocks of 640 = 5760 frames > the 4096-frame window: the ring's
    old squares leave the window sum (the JAX package's own test)."""
    tf, tfs = make_flagship(8, seconds=2.0, seed=3, scan_mode="fused",
                            with_agc=True, max_block=1920, device="cpu")
    tu, tus = make_flagship(8, seconds=2.0, seed=3, scan_mode=mode,
                            with_agc=True, max_block=1920, device="cpu")
    _, of, vf = render_blocks(tf, tfs, 9, 640)
    _, ou, vu = render_blocks(tu, tus, 9, 640)
    assert vf.tolist() == vu.tolist() == [640] * 9
    np.testing.assert_allclose(of.numpy(), ou.numpy(), atol=5e-7, rtol=0)


@pytest.mark.parametrize("case", ["drain", "f32_ring", "live_params"])
def test_fused_agc_cases_match_jax(case):
    """Through the stream's drain (0.3 s, 24 blocks), with an f32 ring, and
    with set_agc_params between blocks."""
    kw = dict(seed=2, scan_mode="fused", with_agc=True)
    seconds, blocks = (0.3, 24) if case == "drain" else (0.5, 5)
    if case == "f32_ring":
        kw["agc_ring"] = "f32"
    jf, jfs = j_make_flagship(4, seconds=seconds, **kw)
    tn, ts = make_flagship(4, seconds=seconds, **kw, device="cpu")
    if case == "f32_ring":
        assert ts["in"]["ring"].dtype == torch.float32
    if case == "live_params":
        jfs, o1, _ = _jax_blocks(jf, jfs, 2)
        ts, t1, _ = render_blocks(tn, ts, 2, 640)
        knobs = dict(attack=0.01, release=0.05, target_level=0.5,
                     absolute_max_gain=3.0)
        jfs = {**jfs, "in": jf.input.set_agc_params(jfs["in"], **knobs)}
        ts = {**ts, "in": tn.input.set_agc_params(ts["in"], **knobs)}
        np.testing.assert_array_equal(ts["in"]["agc_par"].numpy(),
                                      np.asarray(jfs["in"]["agc_par"]))
        np.testing.assert_allclose(t1.numpy(), o1, atol=2e-5, rtol=0)
    jfs, of, vf = _jax_blocks(jf, jfs, blocks)
    ts, ot, vt = render_blocks(tn, ts, blocks, 640)
    assert vt.tolist() == vf
    if case == "drain":
        assert vf[-1] == 0 and 0 < min(v for v in vf if v) < 640
    np.testing.assert_allclose(ot.numpy(), of, atol=2e-5, rtol=0)
    jagc = np.asarray(jfs["in"]["agc"]).reshape(3, 512)[:, :4]
    # the gain carry drifts with F4 (1e-4, the JAX package's CPU bound)
    np.testing.assert_allclose(ts["in"]["agc"].numpy(), jagc, rtol=1e-4, atol=1e-6)


def test_fused_agc_state_carried_from_jax_into_the_port():
    """8 blocks (5120 frames, past the 4096-frame window, over the JAX
    ring's slot wrap) in JAX, the state carried across, 3 more in the port;
    against 11 blocks in JAX."""
    jn, js = j_make_flagship(8, seconds=0.5, seed=4, scan_mode="fused",
                             with_agc=True)
    tn, _ = make_flagship(8, seconds=0.5, seed=4, scan_mode="fused",
                          with_agc=True, device="cpu")
    js8, _, _ = _jax_blocks(jn, js, 8)
    _, o3, v3 = _jax_blocks(jn, js8, 3)
    ts = state_from_jax(tn, jax.device_get(js8))
    ts, ot, vt = render_blocks(tn, ts, 3, 640)
    assert vt.tolist() == v3
    np.testing.assert_allclose(ot.numpy(), o3, atol=2e-5, rtol=0)
    # the ring carried across holds the JAX kernel's last 4096 squares:
    # the port, continuing from it, matches the port continuing from its
    # own render of the same 8 blocks
    tn2, ts2 = make_flagship(8, seconds=0.5, seed=4, scan_mode="fused",
                             with_agc=True, device="cpu")
    ts2, _, _ = render_blocks(tn2, ts2, 8, 640)
    ring_j = ts["in"]["ring"]  # after the 3 port blocks
    ts2, _, _ = render_blocks(tn2, ts2, 3, 640)
    np.testing.assert_allclose(ring_j.float().numpy(),
                               ts2["in"]["ring"].float().numpy(),
                               rtol=2e-2, atol=1e-9)


def test_import_loads_no_jax():
    code = ("import sys, rodio_tpu_torch, rodio_tpu_torch.convert, "
            "rodio_tpu_torch.ops.fused, rodio_tpu_torch.ops.cuda_scan, "
            "rodio_tpu_torch.ops.limiter_block, rodio_tpu_torch.effects, "
            "rodio_tpu_torch.effects.agc, rodio_tpu_torch.profile_slice, "
            "rodio_tpu_torch.benches.dma_roofline, rodio_tpu_torch.io, "
            "rodio_tpu_torch.io.alsa, rodio_tpu_torch.io.decoder, "
            "rodio_tpu_torch.io.device, rodio_tpu_torch.io.microphone, "
            "rodio_tpu_torch.io.mp3, rodio_tpu_torch.io.native, "
            "rodio_tpu_torch.io.pulse, rodio_tpu_torch.io.sample_convert, "
            "rodio_tpu_torch.io.streaming, rodio_tpu_torch.io.uniform_host, "
            "rodio_tpu_torch.io.vorbis, rodio_tpu_torch.io.wav, "
            "rodio_tpu_torch.utils.trace, rodio_tpu_torch.__main__; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'rodio_tpu' or m.startswith('rodio_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
