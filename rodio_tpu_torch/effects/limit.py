"""Feedforward peak limiter (rodio_tpu/effects/limit.py; Giannoulis 2012).

Per channel: the soft-knee dB gain computer, the max-affine integrator
``integ = max(db, rel*integ + (1-rel)*db)``, the linear peak envelope
``peak = att*peak + (1-att)*integ``, and the coupled gain
``x * db_to_linear(-max_c peak_c)``. The reference processes interleaved
samples, so at frame t channel c's gain sees fresh peaks for channels <= c
and the previous frame's peaks for channels > c; that staleness is kept.

Dispatch (``mode="auto"`` or ``"pallas"``): a 1-stream stereo input whose
block allows P = min(128, n & -n) >= 8 chunks runs K3, the blocked
limiter, on a CUDA tensor. On a CPU tensor ``"auto"`` runs the sequential
envelopes, as the JAX package does off the TPU, and ``"pallas"`` runs K3's
plain version (the blocked order), as the JAX node's interpret run does.
On a CUDA tensor the sequential envelopes are kernel K5, which is not
ported yet: such an input raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.math import db_to_linear, duration_to_coefficient
from ..core.node import Node, State, mask_block
from ..core.types import duration_to_nanos
from ..ops.limiter_block import limiter_gain_db, limiter_master
from ..ops.scan import linear_scan, max_affine_scan


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
        if x.device.type == "cuda" or (blocked and self.mode == "pallas"):
            if not blocked:
                raise NotImplementedError(
                    "the sequential limiter envelopes on CUDA are kernel K5 "
                    "(rodio_tpu/ops/pallas_scan.py limiter_env_pallas), not "
                    "ported yet; use mode='auto' or 'pallas' on a 1-stream "
                    "stereo input with n divisible by 8")
            y, (integ, peak) = limiter_master(
                x, state["integ"], state["peak"],
                att=self.attack, rel=self.release, threshold=self.threshold,
                knee_width=self.knee_width, inv_knee_8=self.inv_knee_8, P=P)
            return {"in": s, "integ": integ, "peak": peak}, mask_block(y, valid), valid
        return self._emit_sequential(state, s, x, valid, n)

    def _emit_sequential(self, state, s, x, valid, n):
        rel, att = self.release, self.attack
        db = limiter_gain_db(x, self.threshold, self.knee_width, self.inv_knee_8)
        integ = max_affine_scan(
            db, db * float(np.float32(1.0 - rel)), torch.full_like(db, rel),
            state["integ"])
        peak = linear_scan(
            torch.full_like(integ, att), integ * float(np.float32(1.0 - att)),
            state["peak"])  # [C, T]

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
        return ({"in": s, "integ": integ[:, -1], "peak": peak[:, -1]}, y, valid)
