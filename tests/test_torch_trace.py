"""The port's spans (``rodio_tpu_torch/utils/trace.py``) on the CPU: no
``record_function`` with nothing running, the node ``emit`` spans nested as
the chain is under ``torch.profiler``, a render job's set-up spans, a
recorder installed with :func:`trace.recording`, the build and load spans,
and the Chrome trace."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from rodio_tpu_torch.utils import trace
from test_torch_io_fixtures import pcm16_master, write_pcm_wav

RATE = 44100
BLOCK = 512
SETUP = ("rodio.setup.buffer", "rodio.setup.probe", "rodio.setup.time_major")


@pytest.fixture
def track(tmp_path):
    path = str(tmp_path / "track.wav")
    write_pcm_wav(path, pcm16_master(7, 2, RATE // 4)[0], RATE, 16)
    return path


def config2(path):
    """BASELINE config 2's chain over a looped decode of ``path``."""
    from rodio_tpu_torch.io.decoder import LoopedDecoder
    from rodio_tpu_torch.profile_slice import config2_chain

    return config2_chain(LoopedDecoder(path, device="cpu"))


def render(chain, blocks):
    state = chain.init_state()
    for _ in range(blocks):
        state, _, _ = chain.emit(state, BLOCK)


def config5_job(streams=4, frames=6000):
    """A small render job of config 5: SamplesBuffer -> FusedWidePipeline
    (the content probe at precision "auto") -> Limit, and its state."""
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.flagship import FusedWidePipeline
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    pcm = torch.from_numpy(pcm16_master(3, 2 * streams, frames)[1])
    buf = SamplesBuffer(2 * streams, RATE, pcm, device="cpu")
    gains = np.full(streams, 1.0 / streams, np.float32)
    fused = FusedWidePipeline(buf, 48000, gains, streams, "low_pass", 2000.0, 0.5)
    chain = Limit(fused, LimitSettings(), mode="auto")
    return buf, chain, chain.init_state()


def spans_of(prof, prefix="rodio."):
    """(name, start, end) of the profile's host ranges named ``prefix``..."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda x: (x[1], -x[2]))


def counts(spans):
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def test_nothing_running_enters_no_record_function(track, monkeypatch):
    entered = []
    enter = record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(record_function, "__enter__", counted)
    chain = config2(track)
    assert trace.span("rodio.emit.Limit") is trace.NULL
    render(chain, 10)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        render(chain, 1)
    assert "rodio.emit.Limit" in entered  # the counter sees a range when one opens


def test_emit_spans_nest_as_the_chain_does(track):
    chain = config2(track)
    state = chain.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            state, _, _ = chain.emit(state, BLOCK)
    spans = spans_of(prof, "rodio.emit.")
    outer = [s for s in spans
             if not any(o is not s and o[1] <= s[1] and s[2] <= o[2] for o in spans)]
    assert [s[0] for s in outer] == ["rodio.emit.Limit"] * 3
    nest = ["rodio.emit.AutomaticGainControl", "rodio.emit.BltFilter",
            "rodio.emit.LoopedDecoder"]
    for _, s0, e0 in outer:
        for name in nest:
            inside = [s for s in spans if s[0] == name and s0 <= s[1] and s[2] <= e0]
            assert len(inside) == 1, (name, spans)
            _, s0, e0 = inside[0]
    assert counts(spans) == {"rodio.emit.Limit": 3, **{n: 3 for n in nest}}


def test_a_job_gives_each_setup_span_once_and_a_cached_probe_none():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        buf, chain, state = config5_job()
        chain.emit(state, 1280)
    found = counts(spans_of(prof, "rodio."))
    assert {n: found.get(n) for n in SETUP} == {n: 1 for n in SETUP}
    assert found["rodio.emit.Limit"] == found["rodio.emit.FusedWidePipeline"] == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert buf.content_flags() is buf.content_flags()
    assert counts(spans_of(prof)) == {}


def test_an_installed_recorder_sees_the_same_names_and_counts(track):
    rec = trace.Spans("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording(rec):
        assert trace._recorder is rec
        render(config2(track), 3)
        config5_job()
    assert trace._recorder is None
    s = rec.summary()
    assert {k: v["n"] for k, v in s.items()} == counts(spans_of(prof))
    assert {"rodio.setup.decode", "rodio.emit.LoopedDecoder", *SETUP} <= set(s)
    assert all(v["device_ms"] is None for v in s.values())
    assert all(v["cpu_ms"] >= 0 and v["host_ms"] >= 0 for v in s.values())


def test_a_recorder_alone_records_and_the_one_before_comes_back(track):
    outer, inner = trace.Spans(), trace.Spans()
    with trace.recording(outer):
        with trace.recording(inner):
            render(config2(track), 2)
        assert trace._recorder is outer
        with trace.span("rodio.setup.build"):
            pass
    assert trace._recorder is None
    assert inner.summary()["rodio.emit.Limit"]["n"] == 2
    assert {k: v["n"] for k, v in outer.summary().items()} == {"rodio.setup.build": 1}


def test_the_kernel_build_span_only_when_nvcc_runs(tmp_path, monkeypatch):
    from rodio_tpu_torch.ops import _build

    out = tmp_path / "librodio_tpu_torch_test.so"
    monkeypatch.setattr(_build, "library_path", lambda: out)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def compile_all(cmds):
        for c in cmds:
            Path(c[c.index("-o") + 1]).write_bytes(b"")
        return ""

    monkeypatch.setattr(_build, "_run_all", compile_all)
    rec = trace.Spans()
    with trace.recording(rec):
        assert _build.build() == out
        assert _build.build() == out  # found: no compiler runs
    assert {k: v["n"] for k, v in rec.summary().items()} == {"rodio.setup.build": 1}


def test_the_library_load_span(tmp_path, monkeypatch):
    import ctypes
    import types

    from rodio_tpu_torch.ops import _build

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda verbose=False: tmp_path / "found.so")
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    rec = trace.Spans()
    with trace.recording(rec):
        _build.load_library()
        _build.load_library()  # bound already
    assert {k: v["n"] for k, v in rec.summary().items()} == {"rodio.setup.load": 1}


def test_the_host_library_build_span_only_when_gxx_runs(tmp_path, monkeypatch):
    import subprocess

    from rodio_tpu_torch.io import native

    out = tmp_path / "librodio_tpu_torch_core_test.so"
    monkeypatch.setattr(native, "library_path", lambda name: out)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)

    def gxx(cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native.subprocess, "run", gxx)
    rec = trace.Spans()
    with trace.recording(rec):
        assert native.build("core") == out
        assert native.build("core") == out
    assert {k: v["n"] for k, v in rec.summary().items()} == {"rodio.setup.build": 1}


def test_device_trace_holds_the_emit_spans(tmp_path, track):
    chain = config2(track)
    with trace.device_trace(str(tmp_path / "tr")):
        render(chain, 2)
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rodio.emit.Limit", "rodio.emit.AutomaticGainControl", "rodio.emit.BltFilter",
            "rodio.emit.LoopedDecoder"} <= names
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
