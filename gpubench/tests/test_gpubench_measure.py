"""The yardstick's arithmetic on known inputs (CPU only)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gpubench import measure  # noqa: E402
from gpubench.kernels import k1, k7  # noqa: E402


def test_rate_is_audio_seconds_over_wall_seconds():
    # 3 jobs of 512 streams x 512,000 frames at 48 kHz in 0.2 s
    audio = 3 * 512 * 512_000 / 48_000
    assert measure.rate(audio, 0.2) == pytest.approx(81920.0)
    with pytest.raises(ValueError):
        measure.rate(1.0, 0.0)


def test_p95_on_known_lists():
    assert measure.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert measure.p95([7.0]) == 7.0
    assert measure.p95([1.0, 2.0]) == pytest.approx(1.95)
    with pytest.raises(ValueError):
        measure.p95([])


@pytest.mark.parametrize("intervals, union", [
    ([], 0.0),
    ([("a", 0, 10)], 10.0),
    ([("a", 0, 10), ("b", 5, 15)], 15.0),
    ([("a", 0, 10), ("b", 2, 3), ("c", 20, 25)], 15.0),
    ([("b", 20, 25), ("a", 0, 10)], 15.0),
])
def test_union_of_intervals(intervals, union):
    assert measure.union_us(intervals) == union


def test_idle_gaps_cover_what_the_union_leaves():
    iv = [("a", 2, 4), ("b", 3, 6), ("c", 8, 9)]
    gaps = measure.idle_gaps(iv, (0, 10))
    assert gaps == [(0, 2), (6, 8), (9, 10)]
    assert sum(e - s for s, e in gaps) + measure.union_us(iv) == 10


def test_k1_roofline_at_the_flagship_block():
    """512 stereo streams, a block of 12800 at 44.1 -> 48 kHz: 48.5 MB of
    PCM rows, taps and mix, 0.0145 ms at 3.35 TB/s (bytes bound)."""
    nbytes, ops = k1.bytes_ops(1024, 12800, 147, 160, 2)
    assert k1.rows_read(12800, 147, 160) == 11761
    assert nbytes == 11761 * 1024 * 4 + 12800 * 16 + 2 * 12800 * 4
    assert round(measure.roofline_ms(nbytes, ops), 4) == 0.0145


def test_k7_roofline_at_a_block_of_4096_stereo_frames():
    nbytes, ops = k7.bytes_ops(8192)
    assert measure.roofline_ms(nbytes, ops) == pytest.approx(8192 * 8 / 3.35e12 * 1e3)


@pytest.mark.parametrize("kernel, shape, floor_ms", [
    (k1, (1024, 12800, 147, 160, 2), 0.0776),  # 12800 frames x 3 dependent operations
    (k7, (8192,), 0.0827),  # 8192 steps x 5
])
def test_the_serial_chain_bounds_the_recurrences(kernel, shape, floor_ms):
    """K1's and K7's floors are their chains (2.02 ns a dependent f32
    operation), far above their bytes and operations."""
    nbytes, ops = kernel.bytes_ops(*shape)
    least = measure.roofline_ms(nbytes, ops, chain=kernel.chain_ops(*shape))
    assert round(least, 4) == floor_ms
    assert least > 5 * measure.roofline_ms(nbytes, ops)


def test_breakdown_names_gaps_by_the_innermost_host_event():
    r = measure.Readings(shapes={"span_start_us": 0.0, "span_end_us": 100.0},
                         kernels=[("k(int)", 10.0, 30.0), ("k(int)", 60.0, 70.0)],
                         span_us=100.0, units=1,
                         cpu_events=[("outer", 0.0, 100.0), ("inner", 35.0, 55.0)])
    b = measure.breakdown(r)
    assert b["device_ops"] == [["k(int)", pytest.approx(30e-6)]]
    assert b["idle_gaps"][0] == ["inner", pytest.approx(30e-6)]
    assert len(b["idle_gaps"]) == 3
    assert np.isclose(sum(g[1] for g in b["idle_gaps"]) + 30e-6, 100e-6)


def _reader(name):
    from gpubench import harness

    return harness.load_module(os.path.join(os.path.dirname(measure.__file__), "metrics",
                                            name + ".py"), "t_" + name.replace(".", "_"))


def test_the_readers_on_a_known_trace():
    """One job of two K1 launches of 0.1 ms and a 0.05 ms copy in a 1 ms
    stretch; 40 host emits of 0.5 ms."""
    r = measure.Readings(shapes={"lanes": 1024, "channels": 2, "block": 12800, "fr": 147,
                                 "to": 160, "agc_samples": 8192},
                         host={"emit": [5e-4] * 40},
                         kernels=[("void (anonymous namespace)::fused_kernel<false>(float const*)",
                                   0.0, 100.0),
                                  ("void (anonymous namespace)::fused_kernel<false>(float const*)",
                                   500.0, 600.0),
                                  ("Memcpy DtoH", 550.0, 650.0)],
                         span_us=1000.0, units=1)
    assert _reader("host_enqueue_ms.render").read(r) == pytest.approx(0.5)
    assert _reader("device_idle_share").read(r) == pytest.approx(75.0)
    assert _reader("device_busy_ms").read(r) == pytest.approx(0.25)
    assert _reader("launches_per_buffer.sink").read(r) == 3
    assert _reader("k1_roofline").read(r) == pytest.approx(100 * 12800 * 3 * 2.02e-6 / 0.1)
    assert _reader("k1r_roofline").read(r) is None  # no ring-mode launch in the trace
    assert _reader("k7_roofline").read(r) is None
    assert _reader("farm_assemble_ms").read(r) is None
    for name in ("host_enqueue_ms.farm", "device_idle_share.farm", "k1_roofline"):
        assert _reader(name).read(None) is None
    ring = measure.Readings(shapes=r.shapes, span_us=1000.0, units=1,
                            kernels=[("void fused_kernel<true>(float const*)", 0.0, 125.0)])
    assert _reader("k1r_roofline").read(ring) == pytest.approx(100 * 12800 * 3 * 2.02e-6 / 0.125)
    assert _reader("k7_roofline").read(
        measure.Readings(shapes=r.shapes, kernels=[("first_order_kernel<1>", 0.0, 117.0)])
    ) == pytest.approx(100 * 8192 * 5 * 2.02e-6 / 0.117)
