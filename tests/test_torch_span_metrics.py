"""The benchmark's readers of the port's spans (``gpubench/metrics/``:
``emit_ms.render``, ``emit_ms.file``, ``job_setup_ms.render``,
``idle_in_emit_share``) on hand-made readings, and a traced run of each
cell on the CPU at a small size, which reports them."""
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpubench import harness, measure  # noqa: E402

NAMES = ("emit_ms.render", "emit_ms.file", "job_setup_ms.render", "idle_in_emit_share")


def reader(name):
    return harness.load_module(os.path.join(ROOT, "gpubench", "metrics", name + ".py"),
                               "test_metric_" + name.replace(".", "_"))


READ = {name: reader(name).read for name in NAMES}


def readings(cpu_events=(), kernels=(), span=(0.0, 100.0), units=1):
    r = measure.Readings(kernels=list(kernels), span_us=span[1] - span[0], units=units,
                         cpu_events=list(cpu_events))
    r.shapes["span_start_us"], r.shapes["span_end_us"] = span
    return r


def emit(cls, s, e):
    return ("rodio.emit." + cls, s, e)


def test_only_the_outermost_emit_counts():
    r = readings([emit("Limit", 0, 10), emit("AutomaticGainControl", 1, 9),
                  emit("BltFilter", 2, 8), emit("LoopedDecoder", 3, 4),
                  ("aten::add", 0, 30), emit("Limit", 20, 24),
                  emit("FusedWidePipeline", 21, 23)])
    assert READ["emit_ms.render"](r) == pytest.approx(7e-3)  # (10 + 4) / 2 us
    assert READ["emit_ms.file"](r) == READ["emit_ms.render"](r)


def test_a_gap_half_inside_a_span_counts_half():
    r = readings([emit("Limit", 15, 25), emit("BltFilter", 16, 24)],
                 kernels=[("k", 0, 10), ("k", 20, 30)], span=(0, 30))
    assert READ["idle_in_emit_share"](r) == pytest.approx(100 * 5 / 30)
    assert measure.idle_pct(r) == pytest.approx(100 * 10 / 30)


def test_spans_are_clipped_to_the_stretch():
    r = readings([emit("Limit", -10, 10), emit("Limit", 90, 130)],
                 kernels=[("k", 40, 60)], span=(0, 100))
    assert READ["idle_in_emit_share"](r) == pytest.approx(20.0)
    assert READ["emit_ms.render"](r) == pytest.approx(10e-3)


def test_job_setup_is_the_union_of_its_spans_over_the_jobs():
    r = readings([("rodio.setup.buffer", 0, 10), ("rodio.setup.probe", 12, 20),
                  ("rodio.setup.time_major", 18, 25), ("rodio.setup.decode", 30, 90),
                  ("rodio.setup.buffer", 50, 55), emit("Limit", 60, 70)], units=2)
    assert READ["job_setup_ms.render"](r) == pytest.approx((10 + 13 + 5) / 2 * 1e-3)


@pytest.mark.parametrize("seed", range(8))
def test_idle_in_emit_is_a_part_of_device_idle(seed):
    rng = np.random.default_rng(seed)
    kernels = [("k", s, s + d) for s, d in zip(rng.uniform(0, 980, 60),
                                               rng.uniform(0, 20, 60))]
    starts = np.sort(rng.uniform(0, 1000, 12))
    spans = []
    for s in starts:
        e = s + rng.uniform(5, 80)
        spans += [emit("Limit", s, e), emit("BltFilter", s + 1, e - 1)]
    r = readings(spans, kernels, span=(0, 1000))
    share = READ["idle_in_emit_share"](r)
    assert 0 <= share <= measure.idle_pct(r) + 1e-9
    everywhere = readings([emit("Limit", 0, 1000)], kernels, span=(0, 1000))
    assert READ["idle_in_emit_share"](everywhere) == pytest.approx(measure.idle_pct(r))


@pytest.mark.parametrize("r", [
    None, readings(), readings([emit("Limit", 0, 10)]),
    readings(kernels=[("k", 0, 10)]),
    readings([("rodio.setup.decode", 0, 10), ("gpubench.readback", 10, 20)],
             kernels=[("k", 0, 10)]),
    readings([emit("Limit", 0, 10), ("rodio.setup.buffer", 0, 5)],
             kernels=[("k", 0, 10)], span=(0, 0), units=0),
], ids=["none", "empty", "no_kernels", "no_spans", "other_spans", "empty_stretch"])
def test_nothing_to_read_is_none_never_nan(r):
    values = {name: READ[name](r) for name in NAMES}
    for v in values.values():
        assert v is None or (isinstance(v, float) and not math.isnan(v))
    if r is None or not r.kernels or r.span_us <= 0:
        assert values["idle_in_emit_share"] is None
    if r is not None and not any(n.startswith("rodio.emit.") for n, _, _ in r.cpu_events):
        assert values["emit_ms.render"] is None and values["idle_in_emit_share"] is None


SMALL = {
    "c5_render_jobs": {"cfg": {"streams": 4, "block_frames": 1280},
                       "mix": {"corpus_seconds": 3, "offset_max_seconds": 1,
                               "blocks_per_job": 3, "check_jobs": 1, "profile_jobs": 1}},
    "c2_file_render": {"cfg": {"track_seconds": 2},
                       "mix": {"block_frames": 512, "section_seconds": 0.5, "warm_blocks": 2,
                               "profile_blocks": 2}},
}


@pytest.mark.parametrize("name, metrics", [
    ("c5_render_jobs", ("emit_ms.render", "job_setup_ms.render")),
    ("c2_file_render", ("emit_ms.file",)),
])
def test_a_traced_run_on_the_cpu_reports_the_span_metrics(name, metrics):
    cell = harness.make_cell(name, 2**31 + 777, 0.3, True, torch.device("cpu"),
                             overrides=SMALL[name], start=time.perf_counter())
    result, _, _ = harness.run_cell(cell)
    assert result["correct"], result["checks"]
    for m in metrics:
        assert result["metrics"][m]["value"] > 0, result["metrics"]
    assert "idle_in_emit_share" not in result["metrics"]  # no device intervals here
