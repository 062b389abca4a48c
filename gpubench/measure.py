"""The yardstick's arithmetic: rates, percentiles, the union of device
intervals, and the profiled stretch of a traced run.

``union_us`` is a copy of ``rodio_tpu_torch.profile_slice._union_us`` and
``device_intervals`` of its ``_kernel_intervals``: device busy time is the
union of the device's kernel, copy and fill intervals; the idle share is
1 - busy / span.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the record_function range around a profiled stretch
SPAN = "gpubench.stretch"
PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def rate(amount: float, seconds: float) -> float:
    """``amount`` per wall second (audio seconds per second for realtime_x)."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return amount / seconds


def per_second(times: Sequence[float], t0: float) -> List[int]:
    """How many of the units delivered at ``times`` (perf_counter) fall in
    each whole second after ``t0``: how steady a window ran."""
    counts: List[int] = []
    for t in times:
        k = int(t - t0)
        counts.extend([0] * (k + 1 - len(counts)))
        counts[k] += 1
    return counts


def p95(values: Sequence[float]) -> float:
    """The 95th percentile, linearly interpolated between order statistics
    (numpy's default)."""
    if len(values) == 0:
        raise ValueError("p95 of no values")
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def union_us(intervals: Sequence[Tuple[str, float, float]]) -> float:
    """Length of the union of (name, start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def idle_gaps(intervals, span: Tuple[float, float]) -> List[Tuple[float, float]]:
    """(start, end) of the stretches of ``span`` no interval covers."""
    gaps, cur = [], span[0]
    for s, e in sorted((s, e) for _, s, e in intervals):
        if s > cur:
            gaps.append((cur, min(s, span[1])))
        cur = max(cur, e)
    if cur < span[1]:
        gaps.append((cur, span[1]))
    return [(s, e) for s, e in gaps if e > s]


def host_mean_ms(r: Optional["Readings"], name: str) -> Optional[float]:
    """The mean of a traced run's host times under ``name``, in ms."""
    times = r.host.get(name) if r is not None else None
    return float(np.mean(times) * 1e3) if times else None


def idle_pct(r: Optional["Readings"]) -> Optional[float]:
    """1 - (union of the device's intervals / the stretch's span), in %."""
    if r is None or not r.kernels or r.span_us <= 0:
        return None
    return 100.0 * (1.0 - union_us(r.kernels) / r.span_us)


def roofline_pct(r: Optional["Readings"], kernel, *shape) -> Optional[float]:
    """A kernel's roofline time at ``shape`` (``kernel.bytes_ops`` and
    ``kernel.chain_ops``) over its mean time by name (``kernel.NAME``) in
    the stretch, in %."""
    import re

    times = [e - s for n, s, e in (r.kernels if r is not None else [])
             if re.search(kernel.NAME, n)]
    if not times:
        return None
    least = roofline_ms(*kernel.bytes_ops(*shape), chain=kernel.chain_ops(*shape))
    return 100.0 * least / (sum(times) / len(times) * 1e-3)


def peaks() -> dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def roofline_ms(nbytes: float, ops: float, chain: float = 0) -> float:
    """The least time the card could take, in ms: the largest of the bytes
    over the memory rate, the operations over the f32 rate, and the
    dependent operations of the longest serial chain (a recurrence's steps)
    one after another (``peaks.json``)."""
    p = peaks()
    return max(nbytes / p["hbm_bytes_per_s"], ops / p["f32_flops_per_s"],
               chain * p["dependent_f32_op_s"]) * 1e3


@dataclass
class Readings:
    """What a traced run hands the per-layer metrics' readers."""

    shapes: dict = field(default_factory=dict)
    #: host seconds by name, over the window's units (not profiled)
    host: Dict[str, List[float]] = field(default_factory=dict)
    #: the profiled stretch: device intervals (name, start_us, end_us)
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    span_us: float = 0.0
    units: int = 0
    cpu_events: list = field(default_factory=list)


def device_intervals(prof):
    """(name, start_us, end_us) of every device event of a profile that is
    device work: kernels, copies and fills, not the device side of a
    ``record_function`` range."""
    from torch.autograd import DeviceType

    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name != SPAN]


class Stretch:
    """A profiled stretch of units: ``torch.profiler`` with CPU and CUDA
    activity between two synchronises, inside one ``record_function`` range
    whose host span is the stretch's length. :meth:`fill` puts what it saw
    into a :class:`Readings`."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        if self._cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._range = record_function(SPAN)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if self._cuda:
            torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def fill(self, r: Readings, units: int) -> None:
        from torch.autograd import DeviceType

        events = self._prof.events()
        span = [ev for ev in events if ev.name == SPAN and ev.device_type == DeviceType.CPU]
        if not span:
            raise RuntimeError("the profile holds no span of its stretch")
        s0, s1 = span[0].time_range.start, span[0].time_range.end
        r.kernels = device_intervals(self._prof)
        r.span_us = s1 - s0
        r.units = units
        r.cpu_events = [(ev.name, ev.time_range.start, ev.time_range.end)
                        for ev in events if ev.device_type == DeviceType.CPU
                        and ev.name != SPAN]
        r.shapes["span_start_us"], r.shapes["span_end_us"] = s0, s1


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and anonymous namespace,
    cut to ``limit`` characters."""
    return name.replace("(anonymous namespace)::", "").removeprefix("void ")[:limit]


def breakdown(r: Readings) -> Optional[dict]:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by the innermost host event over its middle."""
    if not r.kernels:
        return None
    by_name: Dict[str, float] = {}
    for name, s, e in r.kernels:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    span = (r.shapes["span_start_us"], r.shapes["span_end_us"])
    gaps = sorted(idle_gaps(r.kernels, span), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        over = [(ce - cs, n) for n, cs, ce in r.cpu_events if cs <= mid <= ce]
        named.append([min(over)[1] if over else "host, no profiled call", (e - s) * 1e-6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
