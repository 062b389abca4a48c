"""One run of one cell, driven by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The harness finds everything else by those names, so that a later change
adds files and entries and edits none:

- ``gpubench/configs/<config>.json``: the configuration as it is run, and
  ``configs/<config>.py``, which builds it through the port's constructors;
- ``gpubench/reference/<config>.py``: its plain reference;
- ``gpubench/traffic/<traffic>.json``: the mix's parameters, among them the
  ``generator`` that makes it, ``gpubench/generators/<generator>.py``;
- ``gpubench/limits/<workload>.json``: the limit of each number the cell's
  comparison with the reference prints, and the readings it was set from;
- ``gpubench/metrics/<metric>.py``: the reader of each per-layer metric;
- ``gpubench/kernels/<kernel>.py``: a kernel's bytes and operations.

A generator's ``run(cell)`` sets up, measures its window and returns an
:class:`Outcome`; the harness reads the peak device memory, lets the
program's state go, runs the comparison, and assembles the result line.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from gpubench import measure

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level module names that may not be loaded in a run
FOREIGN = ("jax", "jaxlib", "flax", "rodio_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Outcome:
    """What a generator's ``run`` returns."""

    attempted: int
    failed: int
    #: end-to-end values by metric name
    metrics: Dict[str, float]
    #: a line for each number: the samples behind it
    samples: List[str]
    #: perf_counter() at the start of the window (set-up ends there)
    window_start: float
    #: control -> {check name: value}; runs the plain reference
    compare: Callable[[bool], Dict[str, float]]
    readings: Optional[measure.Readings] = None


@dataclass
class Cell:
    """A cell as a generator sees it."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: object
    cfg: dict
    mix: dict
    config: object
    reference: object
    limits: dict
    control: bool = False
    start: float = 0.0
    _tmp: Optional[str] = field(default=None, repr=False)

    def tmpdir(self) -> str:
        """A directory of this run's own under the environment's TMPDIR,
        removed when the run ends."""
        if self._tmp is None:
            self._tmp = tempfile.mkdtemp(prefix="gpubench-")
        return self._tmp

    def cleanup(self) -> None:
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None


def make_cell(workload: str, seed: int, seconds: float, trace: bool, device,
              *, overrides: Optional[dict] = None, control: bool = False,
              start: float = 0.0, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if work is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "traffic", work["traffic"] + ".json"))
    overrides = overrides or {}
    cfg.update(overrides.get("cfg", {}))
    mix.update(overrides.get("mix", {}))
    stem = os.path.splitext(os.path.basename(conf["file"]))[0]
    return Cell(
        name=workload, seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=device, cfg=cfg, mix=mix,
        config=load_module(os.path.join(BENCH_DIR, "configs", stem + ".py"),
                           f"gpubench_config_{stem}"),
        reference=load_module(os.path.join(BENCH_DIR, "reference", stem + ".py"),
                              f"gpubench_reference_{stem}"),
        limits=load_json(os.path.join(BENCH_DIR, "limits", workload + ".json")),
        control=control, start=start)


def generator(cell: Cell):
    name = cell.mix["generator"]
    return load_module(os.path.join(BENCH_DIR, "generators", name + ".py"),
                       f"gpubench_generator_{name}")


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    (``trace`` off) or its per-layer ones (``trace`` on). Every per-layer
    metric lists its cells under ``workloads``."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FOREIGN`."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FOREIGN))


def run_cell(cell: Cell, bench: Optional[dict] = None):
    """Run the cell once; returns (result dict, sample lines, check lines)."""
    import time

    import torch

    bench = bench or benchmark()
    try:
        out = generator(cell).run(cell)
        on_card = torch.device(cell.device).type == "cuda"
        device = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": 1,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        values = out.compare(cell.control)
        ref_s = time.perf_counter() - t_ref
    finally:
        cell.cleanup()
    checks = {}
    for name, value in values.items():
        limit = cell.limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    wanted = cell_metrics(bench, cell.name, cell.trace)
    for m in wanted:
        if not cell.trace:
            value = (out.window_start - cell.start if m["name"] == "setup_s"
                     else out.metrics[m["name"]])
        else:
            reader = load_module(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"),
                                 "gpubench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.readings)
            if value is None:
                continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if cell.trace and out.readings is not None and out.readings.kernels:
        r = out.readings
        device["busy_s"] = measure.union_us(r.kernels) * 1e-6
        device["window_s"] = r.span_us * 1e-6
        result["breakdown"] = measure.breakdown(r)
    result["checks"] = checks
    samples = list(out.samples) + [f"# reference: {ref_s:.3f} s"]
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}"
             for name, c in checks.items()]
    return result, samples, lines
