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
with P < 8, and ``mode="exact"`` on any input) runs the whole limiter
through :func:`ops.cuda_scan.limiter_stream`: on a CUDA tensor kernel K5,
which computes the gain in dB, runs the sequential envelopes in the same
recurrence and op order as the scans of ``"exact"`` (so ``"exact"`` runs
it too, as ``BltFilter`` runs K4), couples the gain within each group of
channels and applies it, in one pass; on a CPU tensor its plain version,
the JAX node's torch ops and sequential scans. On the card a group wider
than 32 channels runs its envelopes alone on K5 (``limiter_env``), the
rest in torch.

``mode="parallel"`` runs the JAX node's associative path on any device and
input (rodio_tpu/effects/limit.py:166-212): the gain computer, both
envelopes through the associative scans of ``ops/scan.py`` and the coupled
gain, in torch ops. Any other name raises ``ValueError`` (the JAX node's
scans take an unknown name as "exact": ROADMAP F9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.math import duration_to_coefficient
from ..core.node import Node, State, mask_unless_full
from ..core.types import duration_to_nanos
from ..ops.cuda_scan import limiter_couple_gain, limiter_env_plain, limiter_stream
from ..ops.limiter_block import limiter_gain_db, limiter_master
from ..ops.scan import check_mode
from ..utils.trace import spanned


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
        check_mode(mode, ("auto", "exact", "pallas", "parallel"), who="Limit")
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
        z = torch.zeros(self.spec.channels, dtype=self.dtype, device=self.device)
        return {"in": self.input.init_state(), "integ": z, "peak": z}

    @spanned("rodio.emit.Limit")
    def emit(self, state: State, n: int):
        s, x, valid = self.input.emit(state["in"], n)
        known = self._input_host_valid(s, n)
        if self.mode == "parallel":
            y, (integ, peak) = self._parallel(x, state)
        else:
            P = min(128, n & -n)
            blocked = (self.mode in ("auto", "pallas") and self.streams == 1
                       and self.spec.channels == 2 and P >= 8)
            if blocked and (x.device.type == "cuda" or self.mode == "pallas"):
                y, (integ, peak) = limiter_master(
                    x, state["integ"], state["peak"],
                    att=self.attack, rel=self.release, threshold=self.threshold,
                    knee_width=self.knee_width, inv_knee_8=self.inv_knee_8, P=P)
            else:
                y, (integ, peak) = limiter_stream(
                    x, state["integ"], state["peak"], att=self.attack,
                    rel=self.release, threshold=self.threshold,
                    knee_width=self.knee_width, inv_knee_8=self.inv_knee_8,
                    group_channels=self.spec.channels // self.streams)
        return ({"in": s, "integ": integ, "peak": peak},
                mask_unless_full(y, valid, known, n), valid)

    def host_valid(self, state: State, n: int) -> Optional[int]:
        """The input's host count: the limiter passes its ``valid`` on."""
        return self._input_host_valid(state["in"], n)

    def _input_host_valid(self, in_state: State, n: int) -> Optional[int]:
        # a source outside the Node hierarchy (a PushPort, the sharded
        # master bus's block feed) gives no host count
        known = getattr(self.input, "host_valid", None)
        return None if known is None else known(in_state, n)

    def _parallel(self, x, state):
        """Both envelopes through the associative scans, then the coupled
        gain: the JAX node's ``mode="parallel"`` path."""
        db = limiter_gain_db(x, self.threshold, self.knee_width, self.inv_knee_8)
        peak, carries = limiter_env_plain(db, state["integ"], state["peak"],
                                          att=self.attack, rel=self.release,
                                          mode="parallel")
        y = limiter_couple_gain(x, peak, state["peak"],
                                self.spec.channels // self.streams)
        return y, carries
