"""``c5strip_render_jobs`` driven on the CPU at a small size, as
``test_gpubench_agc512.py`` drives its cell: the port's plain versions
against the plain reference. A sound run is correct; the bfloat16 control is
not; nor is a run with the timed path broken underneath (a step that
returns its state unchanged, half of the streams left out of the mix, an
answer altered where it is produced). Then K6's and K5's roofline
arithmetic at the cell's block, and the new readers on hand-made
readings."""
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gpubench import harness, measure  # noqa: E402
from gpubench.kernels import k5, k6  # noqa: E402

CELL = "c5strip_render_jobs"
#: every job starts at the corpus's frame 0, where each stream's kick falls
#: (a stream is the master rotated by whole beats and a jitter of at most 16
#: frames): the AGC's output there passes the strip limiter's knee, so the
#: strip's limiter works in every compared job; a job of 3 blocks (80 ms)
#: from a start drawn in [0, 1] s may hold no kick, and the limiter no work
SMALL = {"cfg": {"streams": 4, "block_frames": 1280},
         "mix": {"corpus_seconds": 3, "offset_max_seconds": 0, "blocks_per_job": 3,
                 "check_jobs": 2, "profile_jobs": 1}}
SEED = 2**31 + 12345


def run(*, control=False, trace=False):
    cell = harness.make_cell(CELL, SEED, 0.4, trace, torch.device("cpu"), overrides=SMALL,
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
    # streams, then two limiters: ~5e-7 here
    assert r["checks"]["max_abs_err"]["value"] < 1e-5
    assert list(r)[-1] == "checks"
    assert {"realtime_x", "setup_s"} <= set(r["metrics"])


def test_the_bfloat16_control_is_not_correct():
    r = run(control=True)
    assert not r["correct"]
    assert r["checks"]["max_abs_err"]["value"] > r["checks"]["max_abs_err"]["limit"]


def test_a_traced_run_reads_the_resampler_span():
    """On the CPU the profiler sees the program's spans but no device
    intervals: the span's reader reads, the kernels' do not."""
    r = run(trace=True)
    assert r["correct"]
    assert r["metrics"]["resample_emit_ms"]["value"] > 0
    assert r["metrics"]["host_enqueue_ms.render"]["value"] > 0
    assert "k6_roofline" not in r["metrics"] and "k5_roofline" not in r["metrics"]


def _stuck_agc(monkeypatch):
    from rodio_tpu_torch.effects import AutomaticGainControl

    emit = AutomaticGainControl.emit

    def stuck(self, state, n):
        new, y, valid = emit(self, state, n)
        return {**new, **{k: state[k] for k in ("peak", "gain", "rms_sum", "window")}}, y, valid

    monkeypatch.setattr(AutomaticGainControl, "emit", stuck)


def _stuck_strip_limit(monkeypatch):
    from rodio_tpu_torch.effects.limit import Limit

    emit = Limit.emit

    def stuck(self, state, n):
        new, y, valid = emit(self, state, n)
        if self.streams > 1:
            new = {**new, "integ": state["integ"], "peak": state["peak"]}
        return new, y, valid

    monkeypatch.setattr(Limit, "emit", stuck)


def _half_the_streams(monkeypatch):
    from rodio_tpu_torch.effects import Amplify

    emit = Amplify.emit

    def half(self, state, n):
        keep = torch.zeros_like(state["factor"]).view(-1, 2)  # a row a stream
        keep[::2] = 2.0
        new, y, valid = emit(self, {**state, "factor": state["factor"] * keep.view(-1, 1)}, n)
        return {**new, "factor": state["factor"]}, y, valid

    monkeypatch.setattr(Amplify, "emit", half)


def _altered_answer(monkeypatch):
    from rodio_tpu_torch.effects.limit import Limit

    emit = Limit.emit

    def altered(self, state, n):
        new, y, valid = emit(self, state, n)
        if self.streams == 1:
            y = y.clone()
            y[0, n // 3] += 1e-3  # one sample of every block
        return new, y, valid

    monkeypatch.setattr(Limit, "emit", altered)


FAULTS = [_stuck_agc, _stuck_strip_limit, _half_the_streams, _altered_answer]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = run()
    assert not r["correct"], r["checks"]


SHAPE = (1024, 12800, 147, 160, 2)


def test_k6_roofline_at_the_cell_block():
    """512 stereo streams, a block of 12800: |x|, the squares' difference and
    the gains at [512, 25600] f32 and the carries, 157.3 MB (0.0470 ms at
    3.35 TB/s); the smoother's 25,600 steps bound it: at release time 0, 4
    dependent operations a step at 2.02 ns, 0.2068 ms."""
    nbytes, ops = k6.bytes_ops(*SHAPE)
    assert nbytes == 3 * 512 * 25600 * 4 + 6 * 512 * 4
    assert ops == 23 * 512 * 25600
    assert k6.chain_ops(*SHAPE) == 25600 * 4
    assert round(measure.roofline_ms(nbytes, ops), 4) == 0.0470
    assert round(measure.roofline_ms(nbytes, ops, chain=k6.chain_ops(*SHAPE)), 4) == 0.2068


def test_k5_roofline_at_the_cell_block():
    """1024 lanes, a block of 12800: x read and y written, f32, and the
    envelope carries, 104.9 MB (0.0313 ms); the integrator's 12,800 steps
    bound it: 3 dependent operations a step at 2.02 ns, 0.0776 ms (0.0777 at
    the 2.024 ns of op_latency's reading)."""
    nbytes, ops = k5.bytes_ops(*SHAPE)
    assert nbytes == 2 * 1024 * 12800 * 4 + 4 * 1024 * 4
    assert ops == 30 * 1024 * 12800
    assert k5.chain_ops(*SHAPE) == 12800 * 3
    assert round(measure.roofline_ms(nbytes, ops), 4) == 0.0313
    assert round(measure.roofline_ms(nbytes, ops, chain=k5.chain_ops(*SHAPE)), 4) == 0.0776


K6_F32 = "void (anonymous namespace)::agc_kernel<float>(float const*, float const*, int, long long)"
K5_F32 = ("void (anonymous namespace)::limiter_kernel<true, float>(float const*, float const*, "
          "int, long long)")
OTHERS = ["void (anonymous namespace)::agc_kernel<double>(double const*)",
          "void (anonymous namespace)::fused_agc_kernel<float, 0>(float const*, long long)",
          "void (anonymous namespace)::limiter_kernel<false, float>(float const*)",
          "void (anonymous namespace)::limiter_kernel<true, double>(double const*)",
          "void (anonymous namespace)::limiter_master_kernel<float>(float const*)",
          "void (anonymous namespace)::biquad_df1_kernel<float>(float const*)"]


def _readings(kernels, cpu_events=()):
    r = measure.Readings(shapes={"lanes": 1024, "channels": 2, "block": 12800, "fr": 147,
                                 "to": 160}, kernels=kernels, span_us=2000.0, units=1,
                         cpu_events=list(cpu_events))
    r.shapes["span_start_us"], r.shapes["span_end_us"] = 0.0, 2000.0
    return r


def test_the_kernel_readers_read_only_their_f32_instances():
    k6r, k5r = reader("k6_roofline").read, reader("k5_roofline").read
    others = [(n, 1300.0, 1400.0) for n in OTHERS]
    r = _readings([(K6_F32, 0.0, 413.696), (K6_F32, 500.0, 913.696),
                   (K5_F32, 913.696, 1068.832)] + others)
    assert k6r(r) == pytest.approx(50.0)  # 0.206848 ms over 0.413696
    assert k5r(r) == pytest.approx(50.0)  # 0.077568 ms over 0.155136
    assert k6r(_readings([("_ZN12_GLOBAL__N_110agc_kernelIfEEvPKT_S3_", 0.0, 206.848)])) \
        == pytest.approx(100.0)
    assert k5r(_readings([("_ZN12_GLOBAL__N_114limiter_kernelILb1EfEEvPKT0_", 0.0, 77.568)])) \
        == pytest.approx(100.0)
    for r in (None, _readings([]), _readings(others)):
        assert k6r(r) is None and k5r(r) is None


def test_resample_emit_ms_reads_only_the_resampler_spans():
    read = reader("resample_emit_ms").read
    spans = [("rodio.emit.Limit", 0.0, 900.0), ("rodio.emit.Resample", 100.0, 300.0),
             ("rodio.emit.Resample", 1100.0, 1500.0), ("rodio.emit.AutomaticGainControl",
                                                       50.0, 800.0)]
    assert read(_readings([], spans)) == pytest.approx(0.3)
    assert read(_readings([], spans[:1])) is None
    assert read(None) is None
