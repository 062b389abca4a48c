"""Each cell driven on the CPU at a small size, the harness's look for a
card skipped: the port's plain versions against the plain reference.

A sound run is correct; the lower-precision control (the reference with
every block between stages stored in bfloat16, put in the program's place)
is not; and neither is a run with the timed path broken underneath, once
for each fault the cell can have: a step that returns its state unchanged,
half of the streams left out of the mix with the mean taken over the rest
(the two cells that mix streams), and an answer altered where it is
produced. The cells run on one card, so no exchange between cards can be
left out."""
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gpubench import harness  # noqa: E402

#: the cells whose files are here but whose entries are not yet in
#: BENCHMARK.json (their runs on the card spread too widely for a bound),
#: as BENCHMARK.json would hold them
PENDING = {
    "workloads": [
        {"name": "c5_farm_live", "config": "config5_mix512", "traffic": "farm_live",
         "chips": 1},
        {"name": "c2_sink_play", "config": "config2_listener", "traffic": "sink_play",
         "chips": 1},
    ],
    "end_to_end": [
        {"name": "live_realtime_x", "unit": "audio-s/s", "workloads": ["c5_farm_live"]},
        {"name": "buffer_ms_p95", "unit": "ms", "workloads": ["c2_sink_play"]},
        {"name": "realtime_x", "unit": "audio-s/s", "workloads": ["c2_sink_play"]},
    ],
    "per_layer": [
        {"name": "host_enqueue_ms.farm", "unit": "ms", "workloads": ["c5_farm_live"]},
        {"name": "farm_assemble_ms", "unit": "ms", "workloads": ["c5_farm_live"]},
        {"name": "device_idle_share.farm", "unit": "%", "workloads": ["c5_farm_live"]},
        {"name": "k1r_roofline", "unit": "%", "workloads": ["c5_farm_live"]},
        {"name": "launches_per_buffer.sink", "unit": "launches",
         "workloads": ["c2_sink_play"]},
        {"name": "device_idle_share", "unit": "%", "workloads": ["c2_sink_play"]},
        {"name": "device_busy_ms", "unit": "ms", "workloads": ["c2_sink_play"]},
    ],
}


def bench():
    b = harness.benchmark()
    for key, entries in PENDING.items():
        b[key] = b[key] + entries
    return b


SMALL = {
    "c5_render_jobs": {"cfg": {"streams": 4, "block_frames": 1280},
                       "mix": {"corpus_seconds": 3, "offset_max_seconds": 1,
                               "blocks_per_job": 3, "check_jobs": 2, "profile_jobs": 1}},
    "c5_farm_live": {"cfg": {"streams": 4, "block_frames": 1280},
                     "mix": {"files": 3, "file_seconds": 2, "offset_max_seconds": 1,
                             "decode_workers": 2, "profile_blocks": 2}},
    "c2_file_render": {"cfg": {"track_seconds": 2},
                       "mix": {"block_frames": 512, "section_seconds": 0.5, "warm_blocks": 2,
                               "profile_blocks": 2}},
    "c2_sink_play": {"cfg": {"track_seconds": 2},
                     "mix": {"section_seconds": 0.5, "warm_buffers": 2, "profile_buffers": 2}},
}
CELLS = sorted(SMALL)
SEED = 2**31 + 12345


def run(name, *, trace=False, control=False, seconds=0.4):
    b = bench()
    cell = harness.make_cell(name, SEED, seconds, trace, torch.device("cpu"),
                             overrides=SMALL[name], control=control,
                             start=time.perf_counter(), bench=b)
    result, samples, lines = harness.run_cell(cell, b)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["max_abs_err"]["value"] < 1e-5
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_is_not_correct(name):
    r = run(name, control=True)
    assert not r["correct"]
    assert r["checks"]["max_abs_err"]["value"] > r["checks"]["max_abs_err"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_host_metrics(name):
    r = run(name, trace=True)
    assert r["correct"]
    host = {"c5_render_jobs": "host_enqueue_ms.render", "c5_farm_live": "farm_assemble_ms",
            "c2_file_render": "host_enqueue_ms.file"}.get(name)
    if host:
        assert r["metrics"][host]["value"] > 0
    for m in r["metrics"].values():
        assert m["value"] == m["value"]


def test_the_pending_cells_are_not_in_benchmark_json():
    cells = {w["name"] for w in harness.benchmark()["workloads"]}
    assert not cells & {w["name"] for w in PENDING["workloads"]}


def _stuck_limit(monkeypatch):
    from rodio_tpu_torch.effects.limit import Limit

    emit = Limit.emit

    def stuck(self, state, n):
        _, y, valid = emit(self, state, n)
        return state, y, valid

    monkeypatch.setattr(Limit, "emit", stuck)


def _stuck_farm_filter(monkeypatch):
    from rodio_tpu_torch.flagship import FusedFarmPipeline

    emit = FusedFarmPipeline.emit

    def stuck(self, state, n):
        new, y, valid = emit(self, state, n)
        return {**new, "bq": state["bq"]}, y, valid

    monkeypatch.setattr(FusedFarmPipeline, "emit", stuck)


def _half_the_streams(monkeypatch):
    import rodio_tpu_torch.flagship as flagship

    op = flagship.fused_resample_biquad_mix

    def half(pcm, left, wts, *, gains, channels, **kw):
        keep = torch.zeros_like(gains).view(-1, channels)
        keep[::2] = 2.0
        return op(pcm, left, wts, gains=gains * keep.view(-1), channels=channels, **kw)

    monkeypatch.setattr(flagship, "fused_resample_biquad_mix", half)


def _altered_answer(monkeypatch):
    from rodio_tpu_torch.effects.limit import Limit

    emit = Limit.emit

    def altered(self, state, n):
        new, y, valid = emit(self, state, n)
        y = y.clone()
        y[0, n // 3] += 1e-3  # one sample of every block
        return new, y, valid

    monkeypatch.setattr(Limit, "emit", altered)


FAULTS = [
    ("c5_render_jobs", _stuck_limit), ("c5_render_jobs", _half_the_streams),
    ("c5_render_jobs", _altered_answer),
    ("c5_farm_live", _stuck_farm_filter), ("c5_farm_live", _half_the_streams),
    ("c5_farm_live", _altered_answer),
    ("c2_file_render", _stuck_limit), ("c2_file_render", _altered_answer),
    ("c2_sink_play", _stuck_limit), ("c2_sink_play", _altered_answer),
]


@pytest.mark.parametrize("name, fault", FAULTS, ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = run(name)
    assert not r["correct"], r["checks"]
