"""``c5agc_render_jobs`` driven on the CPU at a small size, as
``test_gpubench_cells.py`` drives the other cells: the port's plain versions
against the plain reference. A sound run is correct; the bfloat16 control is
not, nor the program's own bf16 ring of squares; nor is a run with the
timed path broken underneath (a step that returns its state unchanged, half
of the streams left out of the mix, an answer altered where it is
produced). Then K2's roofline arithmetic at the flagship block, and its
readers on hand-made readings."""
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gpubench import harness, measure  # noqa: E402
from gpubench.kernels import k2  # noqa: E402

CELL = "c5agc_render_jobs"
SMALL = {"cfg": {"streams": 4, "block_frames": 1280},
         "mix": {"corpus_seconds": 3, "offset_max_seconds": 1, "blocks_per_job": 3,
                 "check_jobs": 2, "profile_jobs": 1}}
SEED = 2**31 + 12345


def run(*, control=False):
    cell = harness.make_cell(CELL, SEED, 0.4, False, torch.device("cpu"), overrides=SMALL,
                             control=control, start=time.perf_counter())
    result, _, _ = harness.run_cell(cell)
    return result


def reader(name):
    return harness.load_module(os.path.join(harness.BENCH_DIR, "metrics", name + ".py"),
                               "test_metric_" + name)


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # f32 blocks against the f64 reference, AGC gains up to 7 on unit-scale
    # streams: ~1e-7 here
    assert r["checks"]["max_abs_err"]["value"] < 1e-5
    assert list(r)[-1] == "checks"
    assert {"realtime_x", "setup_s"} <= set(r["metrics"])


def test_the_bfloat16_control_is_not_correct():
    r = run(control=True)
    assert not r["correct"]
    assert r["checks"]["max_abs_err"]["value"] > r["checks"]["max_abs_err"]["limit"]


def test_the_bfloat16_ring_of_squares_is_not_correct():
    """The program's own bf16 ring of squares (the port's default) in place
    of the f32 ring the configuration states: one job of 64 streams x 20
    blocks of the cell's 12800 (5.3 s, so the smoother's 4 s attack has
    brought the gains most of the way to what the window asks) against the
    plain reference, over the cell's limit (~3.9e-6 here). The f32 ring on
    the same job reads ~3e-7, under it."""
    from gpubench import signals

    seed, nb = 2**31 + 12345, 20
    cell = harness.make_cell(CELL, seed, 0.4, False, torch.device("cpu"),
                             overrides={"cfg": {"streams": 64, "agc_ring": "bf16"}})
    cfg, S, T = cell.cfg, cell.cfg["streams"], cell.cfg["block_frames"]
    fr, to = cell.config.ratio(cfg)
    n_out = nb * T
    rng = np.random.default_rng([seed, 0])
    pcm = signals.corpus(signals.generator(seed, cell.device), rng, S, 2,
                         n_out * fr // to + fr, cfg["in_rate"], cell.device)
    gains = rng.uniform(cfg["gain_low"], cfg["gain_high"], S).astype(np.float32) / np.float32(S)
    chain = cell.config.job_chain(pcm, gains, cfg, cell.device)
    state = chain.init_state()
    assert state["in"]["ring"].dtype == torch.bfloat16
    blocks = []
    for _ in range(nb):
        state, y, _ = chain.emit(state, T)
        blocks.append(y)
    err = float((torch.cat(blocks, 1).double() - cell.reference.render(pcm, gains, cfg, n_out))
                .abs().max())
    assert err > cell.limits["max_abs_err"]["limit"]


def _stuck_agc(monkeypatch):
    from rodio_tpu_torch.flagship import FusedWidePipeline

    emit = FusedWidePipeline.emit

    def stuck(self, state, n):
        new, y, valid = emit(self, state, n)
        return {**new, "agc": state["agc"], "ring": state["ring"]}, y, valid

    monkeypatch.setattr(FusedWidePipeline, "emit", stuck)


def _stuck_limit(monkeypatch):
    from rodio_tpu_torch.effects.limit import Limit

    emit = Limit.emit

    def stuck(self, state, n):
        _, y, valid = emit(self, state, n)
        return state, y, valid

    monkeypatch.setattr(Limit, "emit", stuck)


def _half_the_streams(monkeypatch):
    import rodio_tpu_torch.flagship as flagship

    op = flagship.fused_resample_biquad_agc_mix

    def half(pcm, left, wts, *, gains, **kw):
        keep = torch.zeros_like(gains).view(-1, 2)
        keep[::2] = 2.0
        return op(pcm, left, wts, gains=gains * keep.view(-1), **kw)

    monkeypatch.setattr(flagship, "fused_resample_biquad_agc_mix", half)


def _altered_answer(monkeypatch):
    from rodio_tpu_torch.effects.limit import Limit

    emit = Limit.emit

    def altered(self, state, n):
        new, y, valid = emit(self, state, n)
        y = y.clone()
        y[0, n // 3] += 1e-3  # one sample of every block
        return new, y, valid

    monkeypatch.setattr(Limit, "emit", altered)


FAULTS = [_stuck_agc, _stuck_limit, _half_the_streams, _altered_answer]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = run()
    assert not r["correct"], r["checks"]


def test_k2_roofline_at_the_flagship_block():
    """512 stereo streams, a block of 12800 at 44.1 -> 48 kHz: 153.3 MB of
    PCM rows, taps, the f32 ring's read and write and the mix (0.0458 ms at
    3.35 TB/s); the smoother's 25,600 steps bound it: at release time 0, 4
    dependent operations a step at 2.02 ns, 0.2068 ms (the serial plan's
    general step of 5 would take 0.2586)."""
    shape = (1024, 12800, 147, 160, 2)
    nbytes, ops = k2.bytes_ops(*shape)
    assert nbytes == 11761 * 1024 * 4 + 12800 * 16 + 2 * 12800 * 1024 * 4 + 2 * 12800 * 4
    assert ops == 40 * 1024 * 12800
    assert k2.chain_ops(*shape) == 25600 * 4
    assert round(measure.roofline_ms(nbytes, ops), 4) == 0.0458
    assert round(measure.roofline_ms(nbytes, ops, chain=k2.chain_ops(*shape)), 4) == 0.2068
    assert round(measure.roofline_ms(nbytes, ops, chain=25600 * 5), 4) == 0.2586


SERIAL_F32 = "void (anonymous namespace)::fused_agc_kernel<float, 0>(float const*, long long)"
OTHERS = ["void (anonymous namespace)::fused_agc_kernel<__nv_bfloat16, 0>(float const*)",
          "void (anonymous namespace)::fused_agc_kernel<float, 2>(float const*)",
          "void (anonymous namespace)::fused_agc_blocked_kernel<float>(float const*)",
          "void (anonymous namespace)::fused_agc_group_kernel<float>(float const*)",
          "void (anonymous namespace)::fused_kernel<false>(float const*)"]


def _readings(kernels):
    r = measure.Readings(shapes={"lanes": 1024, "channels": 2, "block": 12800, "fr": 147,
                                 "to": 160}, kernels=kernels, span_us=2000.0, units=1)
    r.shapes["span_start_us"], r.shapes["span_end_us"] = 0.0, 2000.0
    return r


def test_k2_readers_read_only_the_serial_f32_instance():
    ms, roof = reader("k2_ms").read, reader("k2_roofline").read
    r = _readings([(SERIAL_F32, 0.0, 413.696), (SERIAL_F32, 600.0, 1013.696),
                   ("limiter_master_kernel", 1013.696, 1200.0)]
                  + [(n, 1300.0, 1400.0) for n in OTHERS])
    assert roof(r) == pytest.approx(50.0)  # 0.206848 ms over 0.413696
    assert ms(r) == pytest.approx(0.413696)
    mangled = "_ZN12_GLOBAL__N_116fused_agc_kernelIfLi0EEEvPKfxiPKx"
    assert roof(_readings([(mangled, 0.0, 206.848)])) == pytest.approx(100.0)
    for r in (None, _readings([]), _readings([(n, 0.0, 10.0) for n in OTHERS])):
        assert ms(r) is None and roof(r) is None
