"""Host-side tracing for the control plane (the port's part of
rodio_tpu/utils/trace.py).

- :func:`log_event`: a structured control-plane event, on stdlib logging
  under the ``rodio_tpu_torch`` namespace (the reference's optional
  ``tracing`` events: stream errors, sink drops);
- :class:`BlockTimer`: per-block wall times of a render or playback loop
  against the realtime deadline of a block.

The JAX module's device trace (``jax.profiler``) has no counterpart here;
``profile_slice`` profiles the card with ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
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
