"""Tracing of the port: the program's spans, the recorder that times them,
the Chrome-trace exporter, and the control plane's events.

- :func:`span` (and :func:`spanned`, the same around a whole method) is
  the program's span. With no profiler active and no recorder installed
  it returns :data:`NULL`, one shared no-op context, after one check of
  the profiler's own state; under ``torch.profiler`` it opens a
  ``record_function`` range of its name, so the span lies on the clock of
  the device trace; with a recorder installed (:func:`recording`) it
  records into it; with both it does both. The spans the port opens:

  - ``rodio.emit.<Class>`` around the whole ``emit`` of ``Limit``,
    ``FusedWidePipeline``, ``AutomaticGainControl``, ``BltFilter``,
    ``LoopedDecoder``, ``Resample``, ``Amplify`` and ``WideMixer``, nested
    as the chain is: a node's self time is its span less its input's. The
    benchmark's ``emit_ms.render``, ``emit_ms.file`` and
    ``idle_in_emit_share`` read the outermost ones, ``resample_emit_ms``
    the ``Resample`` ones (``gpubench/metrics/``);
  - a job's set-up on the card: ``rodio.setup.buffer`` (``SamplesBuffer``'s
    one pass: the zero-padded time-major copy and the probe's flags,
    ``ops/pack.py``), ``rodio.setup.probe`` (the read-back of the flags, at
    the buffer's first ``content_flags()``), ``rodio.setup.time_major``
    (``FusedWidePipeline.init_state`` taking the buffer's time-major view):
    read by ``job_setup_ms.render``; ``rodio.setup.agc_state`` (the fused AGC's
    per-job carries and its ring of squares, ``with_agc=True``) and
    ``rodio.setup.channel_major`` (``SamplesBuffer.channel_major``'s copy
    for the unfused consumers, once a buffer): named in a traced run's idle
    gaps;
  - a process's set-up: ``rodio.setup.decode`` (``LoopedDecoder``'s
    whole-file decode), ``rodio.setup.build`` (a compiler run for the
    kernels or the host C++), ``rodio.setup.load`` (loading a library from
    ``build/``): read by an operator with a recorder installed, to split a
    run's set-up time; which of them happen says whether a library was
    built again.

- :class:`Spans`: the recorder. A span by the host clock, the thread's CPU
  time (``time.thread_time``) and, when ``device`` is a card, a pair of
  CUDA events on the current stream; :meth:`Spans.summary` reads them
  after the run. ``StreamFarm.run(spans=)`` and
  ``ShardedStreamFarm.run(spans=)`` take one directly for their ``push``,
  ``emit``, ``step`` and ``assemble`` (``chip_smoke.py``'s path P prints
  them); :data:`NO_SPANS` is what they use without one.
- :func:`device_trace`: ``torch.profiler`` with CUDA activity, writing a
  Chrome trace (the JAX module's ``jax.profiler`` trace), the program's
  spans among its events.
- :class:`BlockTimer`: per-block wall times of a render or playback loop
  against the block's realtime deadline (the sink's tests).
- :func:`log_event`: a structured control-plane event on stdlib logging
  under the ``rodio_tpu_torch`` namespace (the sink's error event).
- :data:`counts`: the port's one record of what ran, a ``Counter`` that
  :func:`count` adds to, by name:

  - every kernel launch, under its C entry point's name, counted by
    ``ops._build.launch`` after the launch returned no error: K1
    ``rt_fused_resample_biquad_mix`` (``..._ring`` in ring mode), K2
    ``rt_fused_resample_biquad_agc_mix`` (K2g ``..._agc_group_mix``, K2r
    ``..._agc_rel0_mix``, K2b ``..._agc_blocked_mix``), K3
    ``rt_limiter_master``, K4 ``rt_biquad_df1`` (``..._bf16``), K5
    ``rt_limiter_env`` and ``rt_limiter_stream``, K6 ``rt_agc``, K7
    ``rt_first_order``, K8 ``rt_blocked_max_affine``, ``rt_threefry``,
    ``rt_phase_accumulate``, ``rt_pack_time_major``, each f64 instance
    under the same name with ``_f64`` at the end; K9 ``rt_dma_ring``,
    ``rt_stream_max``, ``rt_op_chain`` (``_f64``) and ``rt_smooth_chain``
    (the benches);
  - ``host_valid_block`` and ``device_masked_block``: the blocks
    ``core.node.mask_unless_full`` passed on unmasked on its input's host
    count, and those it masked on the card;
  - ``channel_major_copy``: the channel-major copies a ``SamplesBuffer``
    made of its time-major PCM (one a buffer, at its first
    ``init_state``; the fused pipeline makes none).

  A reader takes a difference across a run, or clears the table first
  (``counts.clear()``); no metric of the benchmark reads it.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch.autograd.profiler import record_function

logger = logging.getLogger("rodio_tpu_torch")


def log_event(event: str, **fields) -> None:
    """Structured control-plane event (the tracing::debug! analog)."""
    logger.debug("%s %s", event, fields)


#: launches and blocks counted by name (the module's docstring lists them)
counts: Counter = Counter()


def count(name: str) -> None:
    """Add one to ``counts[name]``."""
    counts[name] += 1


@dataclass
class BlockTimer:
    """Collects per-block wall times (host clock) of a render or playback
    loop: the host-visible cadence a realtime delivery deadline is about."""

    sample_rate: int = 48000
    block_frames: int = 4096
    times: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def block(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def stats(self) -> dict:
        if not self.times:
            return {}
        import numpy as np

        arr = np.asarray(self.times)
        deadline = self.block_frames / self.sample_rate
        return {
            "blocks": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "max_ms": float(arr.max() * 1e3),
            "deadline_ms": deadline * 1e3,
            "xruns": int((arr > deadline).sum()),
            "realtime_multiple": float(deadline / arr.mean()),
        }


#: whether a ``torch.profiler`` is active (the profiler's own state)
_profiler_enabled = torch._C._autograd._profiler_enabled
#: the one no-op context a span is when nothing is running
NULL = contextlib.nullcontext()
#: the recorder :func:`recording` installed, if any
_recorder: Optional["Spans"] = None


def span(name: str):
    """The program's span ``name`` (a context): :data:`NULL` when no
    profiler is active and no recorder installed."""
    if _recorder is None and not _profiler_enabled():
        return NULL
    return _open(name)


def spanned(name: str):
    """Decorate a method so that its whole call is the span ``name``; with
    nothing running the call costs one check more."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _recorder is None and not _profiler_enabled():
                return fn(*args, **kwargs)
            with _open(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def _open(name: str):
    rec = _recorder
    if not _profiler_enabled():
        return rec.span(name)
    if rec is None:
        return record_function(name)
    return _both(name, rec)


@contextlib.contextmanager
def _both(name: str, rec: "Spans"):
    with record_function(name), rec.span(name):
        yield


@contextlib.contextmanager
def recording(rec: "Spans"):
    """Install ``rec`` as the recorder of every :func:`span` inside the
    block (the one before it comes back after)."""
    global _recorder
    prev, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = prev


class Spans:
    """A recorder of named spans: :meth:`span` times a stretch by the host
    clock, the thread's CPU time and, when ``device`` is a card, CUDA
    events recorded on the current stream before and after it (the device
    time between them); :meth:`host` by the two clocks only. Events are
    read in :meth:`summary`, after the run, which waits for the card
    once."""

    def __init__(self, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._host = defaultdict(list)
        self._cpu = defaultdict(list)
        self._events = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        e0 = None
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0, c0 = time.perf_counter(), time.thread_time()
        yield
        self._note(name, t0, c0)
        if e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self._events[name].append((e0, e1))

    @contextlib.contextmanager
    def host(self, name: str):
        t0, c0 = time.perf_counter(), time.thread_time()
        yield
        self._note(name, t0, c0)

    def _note(self, name: str, t0: float, c0: float) -> None:
        self._host[name].append(time.perf_counter() - t0)
        self._cpu[name].append(time.thread_time() - c0)

    def summary(self) -> dict:
        """{name: {"n", "host_ms", "cpu_ms", "device_ms" (None off the
        card)}}, means over the spans."""
        import numpy as np

        if self._events:
            torch.cuda.synchronize()
        out = {}
        for name, times in self._host.items():
            ev = self._events.get(name)
            out[name] = {
                "n": len(times), "host_ms": float(np.mean(times) * 1e3),
                "cpu_ms": float(np.mean(self._cpu[name]) * 1e3),
                "device_ms": (float(np.mean([a.elapsed_time(b) for a, b in ev]))
                              if ev else None)}
        return out


class _NoRecorder:
    """A recorder that records nothing: its spans are :data:`NULL`."""

    def span(self, name: str):
        return NULL

    host = span


#: what a loop that takes a recorder uses without one
NO_SPANS = _NoRecorder()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` over the block (CPU and CUDA activity where a card
    is present), its Chrome trace written to ``log_dir/trace.json``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
