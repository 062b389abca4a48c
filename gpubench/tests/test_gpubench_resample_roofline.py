"""``resample_roofline``: the resampler's pass (``kernels/resample_lerp.py``)
at ``c5strip_render_jobs``' block, and its reader on hand-made readings: it
reads only the f32 pass, by either form of its name, and nothing where no
such kernel ran (the parent of the pass)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gpubench import harness, measure  # noqa: E402
from gpubench.kernels import resample_lerp  # noqa: E402

#: (lanes, block, from, to, channels) of c5strip_render_jobs
SHAPE = (1024, 12800, 147, 160, 2)
F32 = "void (anonymous namespace)::resample_lerp_kernel<float>((anonymous namespace)::Args)"
F32_MANGLED = "_ZN12_GLOBAL__N_120resample_lerp_kernelIfEEvNS_4ArgsE"
OTHERS = ["void (anonymous namespace)::resample_lerp_kernel<double>((anonymous namespace)::Args)",
          "void (anonymous namespace)::agc_kernel<float>(float const*)",
          "void (anonymous namespace)::limiter_kernel<true, float>(float const*)",
          "void (anonymous namespace)::biquad_df1_kernel<float>(float const*)",
          "at::native::index_elementwise_kernel<128, 4>(int)"]


def test_resample_roofline_at_the_cell_block():
    """1024 lanes, a block of 12800 at 147/160: the frames each lane's taps
    span, 12799 * 147 // 160 + 2 = 11,761, read and the block written, f32,
    100.6 MB (0.0300 ms at 3.35 TB/s); 3 operations a sample, no chain: the
    bytes bound it."""
    nbytes, ops = resample_lerp.bytes_ops(*SHAPE)
    assert nbytes == 1024 * 11761 * 4 + 1024 * 12800 * 4 == 100_601_856
    assert ops == 3 * 1024 * 12800 and resample_lerp.chain_ops(*SHAPE) == 0
    assert round(measure.roofline_ms(nbytes, ops), 4) == 0.0300


def test_resample_roofline_counts_the_taps_span():
    """The byte count is the span of a block's taps, left(out_o + n - 1) -
    left(out_o) + 2 with left(o) = o * 147 // 160, at every block of the
    cell's job (each starts on a whole period: 12800 = 80 * 160)."""
    lanes, n, fr, to, channels = SHAPE
    nbytes, _ = resample_lerp.bytes_ops(*SHAPE)
    for k in range(40):
        o0 = k * n
        span = (o0 + n - 1) * fr // to - o0 * fr // to + 2
        assert nbytes == lanes * span * 4 + lanes * n * 4


def _readings(kernels):
    lanes, block, fr, to, channels = SHAPE
    return measure.Readings(shapes={"lanes": lanes, "channels": channels, "block": block,
                                    "fr": fr, "to": to},
                            kernels=kernels, span_us=2000.0, units=1)


def test_resample_roofline_reads_only_the_f32_pass():
    read = harness.load_module(os.path.join(harness.BENCH_DIR, "metrics", "resample_roofline.py"),
                               "test_metric_resample_roofline").read
    least_us = measure.roofline_ms(*resample_lerp.bytes_ops(*SHAPE)) * 1e3
    others = [(n, 1300.0, 1400.0) for n in OTHERS]
    r = _readings([(F32, 0.0, 2 * least_us), (F32, 100.0, 100.0 + 2 * least_us)] + others)
    assert read(r) == pytest.approx(50.0)
    assert read(_readings([(F32_MANGLED, 0.0, least_us)])) == pytest.approx(100.0)
    for r in (None, _readings([]), _readings(others)):
        assert read(r) is None
