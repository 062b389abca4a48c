"""Host-side tracing for the control plane (the port's part of
rodio_tpu/utils/trace.py).

- :func:`log_event`: a structured control-plane event, on stdlib logging
  under the ``rodio_tpu_torch`` namespace (the reference's optional
  ``tracing`` events: stream errors, sink drops);
- :class:`BlockTimer`: per-block wall times of a render or playback loop
  against the realtime deadline of a block;
- :class:`FarmSpans`: named spans of a loop (the farm's host assembly,
  push and emit), each by the host clock and, on the card, by a pair of
  CUDA events on the current stream;
- :func:`device_trace`: ``torch.profiler`` with CUDA activity, writing a
  Chrome trace (the JAX module's ``jax.profiler`` trace).
"""
from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from collections import defaultdict
from typing import List

logger = logging.getLogger("rodio_tpu_torch")


def log_event(event: str, **fields) -> None:
    """Structured control-plane event (the tracing::debug! analog)."""
    logger.debug("%s %s", event, fields)


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


class FarmSpans:
    """Named spans of a loop: :meth:`span` times a stretch by the host
    clock and, when ``device`` is a card, by CUDA events recorded on the
    current stream before and after it (the device time between them);
    :meth:`host` by the host clock only. Events are read in
    :meth:`summary`, after the run, which waits for the card once."""

    def __init__(self, device=None):
        import torch

        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._host = defaultdict(list)
        self._events = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        e0 = None
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        yield
        self._host[name].append(time.perf_counter() - t0)
        if e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self._events[name].append((e0, e1))

    @contextlib.contextmanager
    def host(self, name: str):
        t0 = time.perf_counter()
        yield
        self._host[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        """{name: {"n", "host_ms", "device_ms" (None off the card)}}, means
        over the spans."""
        import numpy as np
        import torch

        if self._events:
            torch.cuda.synchronize()
        out = {}
        for name, times in self._host.items():
            ev = self._events.get(name)
            out[name] = {
                "n": len(times), "host_ms": float(np.mean(times) * 1e3),
                "device_ms": (float(np.mean([a.elapsed_time(b) for a, b in ev]))
                              if ev else None)}
        return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` over the block (CPU and CUDA activity where a card
    is present), its Chrome trace written to ``log_dir/trace.json``."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
