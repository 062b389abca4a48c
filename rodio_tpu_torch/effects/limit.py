"""Feedforward peak limiter (rodio_tpu/effects/limit.py; Giannoulis 2012).

Per channel: the soft-knee dB gain computer, the max-affine integrator
``integ = max(db, rel*integ + (1-rel)*db)``, the linear peak envelope
``peak = att*peak + (1-att)*integ``, and the coupled gain
``x * db_to_linear(-max_c peak_c)``. The reference processes interleaved
samples, so at frame t channel c's gain sees fresh peaks for channels <= c
and the previous frame's peaks for channels > c; that staleness is kept.

Dispatch. A 1-stream stereo input whose block allows P = min(128, n & -n)
>= 8 chunks, under ``mode="auto"`` or ``"pallas"``, runs K3, the blocked
limiter, on a CUDA tensor; on a CPU tensor ``"pallas"`` runs K3's plain
version (the blocked order), as the JAX node's interpret run does, and
``"auto"`` the sequential envelopes, as the JAX package does off the TPU.
Every other case (``streams`` > 1, mono or multichannel input, a block
with P < 8, and ``mode="exact"`` on any input) runs the sequential
envelopes through :func:`ops.cuda_scan.limiter_env`: kernel K5 on a CUDA
tensor, which is the same recurrence in the same op order, so ``"exact"``
runs it too, as ``BltFilter`` runs K4; its plain version, the sequential
scans, on a CPU tensor. The coupling within each group of channels and the
gain stay torch ops, as in the JAX node.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.math import db_to_linear, duration_to_coefficient
from ..core.node import Node, State, mask_block
from ..core.types import duration_to_nanos
from ..ops.cuda_scan import limiter_env
from ..ops.limiter_block import limiter_gain_db, limiter_master


@dataclasses.dataclass(frozen=True)
class LimitSettings:
    """(src/source/limit.rs:209-245); durations in seconds."""

    threshold: float = -1.0
    knee_width: float = 4.0
    attack: float = 0.005
    release: float = 0.100

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def dynamic_content(cls):
        return cls(threshold=-3.0, knee_width=6.0)

    @classmethod
    def broadcast(cls):
        return cls(knee_width=2.0, attack=0.003, release=0.050)

    @classmethod
    def mastering(cls):
        return cls(threshold=-0.5, knee_width=1.0, attack=0.001, release=0.200)

    @classmethod
    def live_performance(cls):
        return cls(threshold=-2.0, knee_width=3.0, attack=0.0005, release=0.030)

    @classmethod
    def gaming(cls):
        return cls(threshold=-3.0, knee_width=3.0, attack=0.002, release=0.075)

    def with_threshold(self, v):
        return dataclasses.replace(self, threshold=v)

    def with_knee_width(self, v):
        return dataclasses.replace(self, knee_width=v)

    def with_attack(self, v):
        return dataclasses.replace(self, attack=v)

    def with_release(self, v):
        return dataclasses.replace(self, release=v)


class Limit(Node):
    """``streams`` > 1 limits S independent groups of channels/S channels
    (the wide-channel batch layout): envelopes per channel, gain coupled
    within each group only."""

    def __init__(self, input_node: Node, settings: LimitSettings = None,
                 *, mode: str = "auto", streams: int = 1):
        if mode not in ("auto", "exact", "pallas"):
            raise ValueError(f"Limit mode {mode!r} is not ported")
        settings = settings or LimitSettings()
        self.input = input_node
        self.spec = input_node.spec
        self.device = input_node.device
        self.settings = settings
        self.mode = mode
        if input_node.spec.channels % streams:
            raise ValueError("channels not divisible by stream count")
        self.streams = streams
        rate = self.spec.sample_rate
        self.attack = float(duration_to_coefficient(
            0, rate, nanos=duration_to_nanos(settings.attack)))
        self.release = float(duration_to_coefficient(
            0, rate, nanos=duration_to_nanos(settings.release)))
        self.threshold = float(np.float32(settings.threshold))
        self.knee_width = float(np.float32(settings.knee_width))
        self.inv_knee_8 = float(
            np.float32(1.0) / (np.float32(8.0) * np.float32(settings.knee_width))
        )

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        z = torch.zeros(self.spec.channels, dtype=torch.float32, device=self.device)
        return {"in": self.input.init_state(), "integ": z, "peak": z}

    def emit(self, state: State, n: int):
        s, x, valid = self.input.emit(state["in"], n)
        P = min(128, n & -n)
        blocked = (self.mode in ("auto", "pallas") and self.streams == 1
                   and self.spec.channels == 2 and P >= 8)
        if blocked and (x.device.type == "cuda" or self.mode == "pallas"):
            y, (integ, peak) = limiter_master(
                x, state["integ"], state["peak"],
                att=self.attack, rel=self.release, threshold=self.threshold,
                knee_width=self.knee_width, inv_knee_8=self.inv_knee_8, P=P)
            return {"in": s, "integ": integ, "peak": peak}, mask_block(y, valid), valid
        db = limiter_gain_db(x, self.threshold, self.knee_width, self.inv_knee_8)
        peak, (integ_c, peak_c) = limiter_env(
            db, state["integ"], state["peak"], att=self.attack, rel=self.release)

        c = self.spec.channels
        cg = c // self.streams
        if cg == 1:
            max_peak = peak  # per-channel groups: no coupling
        else:
            # within each group: fresh peaks for channels <= c, previous-
            # frame peaks for channels > c
            peak_prev = torch.cat([state["peak"][:, None], peak[:, :-1]], dim=1)
            pg = peak.reshape(self.streams, cg, n)
            sg = peak_prev.reshape(self.streams, cg, n)
            fresh_cummax = torch.cummax(pg, dim=1).values
            stale_sufmax = torch.flip(
                torch.cummax(torch.flip(sg, [1]), dim=1).values, [1])
            stale_above = torch.cat(
                [stale_sufmax[:, 1:],
                 torch.full((self.streams, 1, n), -float("inf"),
                            dtype=x.dtype, device=x.device)], dim=1)
            max_peak = torch.maximum(fresh_cummax, stale_above).reshape(c, n)

        y = mask_block(x * db_to_linear(-max_peak), valid)
        return {"in": s, "integ": integ_c, "peak": peak_c}, y, valid
