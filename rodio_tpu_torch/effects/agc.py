"""Automatic Gain Control (rodio_tpu/effects/agc.py; src/source/agc.rs).

One AGC state per stream, shared across its channels: the interleaved
samples (column-major flatten of the [C, T] block) feed one peak detector
(instant attack, slow release), one 8192-sample RMS window and one smoothed
gain. ``streams`` > 1 runs S independent AGCs over the wide-channel batch
layout.

Modes, as the JAX node's:

- ``"exact"``: the reference's operation order, sequential (peak, then
  ``sum = (sum - old) + new``, ``sqrt``, ``target / rms``), plain PyTorch
  on any device.
- ``"pallas"``: the kernels. With S <= 8 streams and P = min(128, m & -m)
  >= 8 (m = interleaved samples per stream), the decomposed path: the RMS
  sum as a cumulative sum, the peak detector as the blocked max-affine scan
  (K8), the desired gain elementwise, the gain smoother as K7
  (``op="agc_gain"``); with ``group`` > 0 the smoother advances once per
  group of frames (the AgcGroup contract of the JAX node's docstring).
  Otherwise the whole per-sample loop as K6.
- ``"auto"`` and ``"parallel"``: the JAX node's third branch
  (rodio_tpu/effects/agc.py:357-366), on any device: the peak detector as
  the associative max-affine scan (``ops/scan.py``, torch ops), the RMS
  sum as a cumulative sum (taken in f64 and rounded back, so the card and
  the CPU agree; JAX's f32 ``cumsum`` is its own associative scan), the
  desired gain as ``"exact"`` computes it, and the gain smoother, which is
  sequential, as K7's ``agc_gain`` op (``ops/cuda_scan.first_order``: the
  kernel on a CUDA tensor, its plain loop on a CPU tensor).

Any other mode name raises ``ValueError`` (the JAX node takes an unknown
name as its third branch: ROADMAP F9).

The live knobs (``set_enabled``, ``set_attack_time``,
``set_release_time``) are state updates: the kernels read the
coefficients as data. A disabled AGC passes its input through and freezes
its state. The window position ``widx`` stays on the card, so ``emit``
never reads the device back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.math import duration_to_coefficient, sqrt_rn
from ..core.node import Node, State, mask_block
from ..core.types import duration_to_nanos
from ..ops.cuda_scan import agc, desired_gain, first_order, ipow, smooth_gains
from ..ops.limiter_block import blocked_max_affine_const
from ..ops.scan import check_mode, max_affine_scan
from ..utils.trace import spanned

RMS_WINDOW_SIZE = 8192
_MAX_NANOS = 10_000_000_000  # times clamped to 10 s (src/source/mod.rs:432-433)


@dataclasses.dataclass(frozen=True)
class AgcSettings:
    """(src/source/agc.rs:57-82); durations in seconds."""

    target_level: float = 1.0
    attack_time: float = 4.0
    release_time: float = 0.0
    absolute_max_gain: float = 7.0


def _coefficient(seconds: float, rate: int, dtype: torch.dtype) -> float:
    nanos = min(duration_to_nanos(seconds), _MAX_NANOS)
    return float(duration_to_coefficient(0, rate, nanos=nanos, dtype=dtype))


def _window_sums(rms_sum: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The running window sums ``rms_sum + cumsum(delta)`` [S, m], the
    cumulative sum taken in float64 and rounded back: the same result on
    every device."""
    return rms_sum[:, None] + torch.cumsum(delta.to(torch.float64), dim=1).to(delta.dtype)


class AutomaticGainControl(Node):
    """``streams`` > 1 runs S independent AGCs over the wide-channel batch
    layout: the input's channels split into S groups of channels/S, each
    with its own peak/window/gain state."""

    def __init__(self, input_node: Node, settings: AgcSettings = None,
                 *, mode: str = "exact", streams: int = 1, group: int = 0):
        check_mode(mode, ("exact", "pallas", "auto", "parallel"),
                   who="AutomaticGainControl")
        settings = settings or AgcSettings()
        self.input = input_node
        self.spec = input_node.spec
        self.device = input_node.device
        self.settings = settings
        self.mode = mode
        if input_node.spec.channels % streams:
            raise ValueError("channels not divisible by stream count")
        self.streams = streams
        rate = self.spec.sample_rate
        self.attack_coeff = _coefficient(settings.attack_time, rate, self.dtype)
        self.release_coeff = _coefficient(settings.release_time, rate, self.dtype)
        self.target_level = float(np.float32(settings.target_level))
        self.absolute_max_gain = float(np.float32(settings.absolute_max_gain))
        self.floor = 0.0
        self.enabled = True
        if group and mode != "pallas":
            raise ValueError("group-rate AGC requires mode='pallas'")
        if group and group < 2:
            raise ValueError("group must be >= 2 (or 0 = per-sample)")
        self.group = int(group)

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        S, dev, dt = self.streams, self.device, self.dtype

        def scalar(v):
            return torch.tensor(v, dtype=dt, device=dev)

        return {
            "in": self.input.init_state(),
            "peak": torch.zeros(S, dtype=dt, device=dev),
            "gain": torch.ones(S, dtype=dt, device=dev),
            "rms_sum": torch.zeros(S, dtype=dt, device=dev),
            "window": torch.zeros((S, RMS_WINDOW_SIZE), dtype=dt, device=dev),
            "widx": torch.zeros((), dtype=torch.int64, device=dev),
            # the live control surface (src/source/agc.rs:302-361)
            "enabled": torch.tensor(self.enabled, device=dev),
            "att": scalar(self.attack_coeff),
            "rel": scalar(self.release_coeff),
            "consts": self.consts(),
        }

    def consts(self) -> torch.Tensor:
        """(target, max_gain, floor, 1/window): the kernels' parameters
        besides the knobs, a state tensor so that they reach the card once."""
        return torch.tensor([self.target_level, self.absolute_max_gain,
                             self.floor, 1.0 / RMS_WINDOW_SIZE],
                            dtype=self.dtype, device=self.device)

    # -- live control handles (src/source/agc.rs:302-361) --
    def set_enabled(self, state: State, on: bool) -> State:
        """Bypass from the next block on: audio passes through unchanged
        and the detector state freezes."""
        return {**state, "enabled": torch.tensor(bool(on), device=self.device)}

    def set_attack_time(self, state: State, seconds: float) -> State:
        c = _coefficient(seconds, self.spec.sample_rate, self.dtype)
        return {**state, "att": torch.tensor(c, dtype=state["att"].dtype,
                                             device=self.device)}

    def set_release_time(self, state: State, seconds: float) -> State:
        c = _coefficient(seconds, self.spec.sample_rate, self.dtype)
        return {**state, "rel": torch.tensor(c, dtype=state["rel"].dtype,
                                             device=self.device)}

    def _finish(self, state, s_in, new_fields, y, x_thru, valid):
        # live-enable gate: when disabled, the output passes through and
        # the detector state freezes (agc.rs early return)
        en = state["enabled"]
        out = torch.where(en, y, x_thru)
        merged = {k: torch.where(en, v, state[k]) for k, v in new_fields.items()}
        return {**state, "in": s_in, **merged}, out, valid

    @spanned("rodio.emit.AutomaticGainControl")
    def emit(self, state: State, n: int):
        s, x, valid = self.input.emit(state["in"], n)
        if not self.enabled:
            return {**state, "in": s}, x, valid

        S = self.streams
        c_total, t = x.shape
        cg = c_total // S
        m = cg * t  # interleaved samples per stream
        # interleaved order = column-major flatten of [Cg, T]
        xg = x.reshape(S, cg, t).transpose(1, 2).reshape(S, m)
        xs = torch.abs(xg)
        sq = xs * xs

        # the squares leaving the window at each step
        widx = state["widx"]
        window = state["window"]
        steps = torch.arange(m, device=x.device)
        if m >= RMS_WINDOW_SIZE:
            ring_old = window[:, (widx + steps[:RMS_WINDOW_SIZE]) % RMS_WINDOW_SIZE]
            old = torch.cat([ring_old, sq[:, : m - RMS_WINDOW_SIZE]], dim=1)
            keep = steps[m - RMS_WINDOW_SIZE:]
        else:
            old = window[:, (widx + steps) % RMS_WINDOW_SIZE]
            keep = steps
        window_new = window.index_copy(1, (widx + keep) % RMS_WINDOW_SIZE,
                                       sq[:, keep])

        P = min(128, m & -m)
        if self.mode == "pallas" and S <= 8 and P >= 8:
            gain_seq, carries = self._decomposed(state, xs, sq - old, P, m)
        elif self.mode == "pallas":
            params = torch.cat([state["att"][None], state["rel"][None],
                                state["consts"]])
            gain_seq, carries = agc(xs, sq - old, state["peak"],
                                    state["rms_sum"], state["gain"], params)
        elif self.mode == "exact":
            gain_seq, carries = self._exact(state, xs, sq, old)
        else:
            gain_seq, carries = self._associative(state, xs, sq - old)
        peak_c, sum_c, gain_c = carries
        y = (xg * gain_seq).reshape(S, t, cg).transpose(1, 2)
        y = mask_block(y.reshape(c_total, t), valid)
        return self._finish(
            state, s,
            {"peak": peak_c, "gain": gain_c, "rms_sum": sum_c,
             "window": window_new, "widx": (widx + m) % RMS_WINDOW_SIZE},
            y, mask_block(x, valid), valid)

    def _decomposed(self, state, xs, delta, P: int, m: int):
        """The RMS sum as a cumulative sum, the peak detector as K8, the
        desired gain elementwise, the smoother as K7."""
        rel, att = state["rel"], state["att"]
        target, max_gain, floor, inv_window = state["consts"]
        S = self.streams
        rsum_seq = _window_sums(state["rms_sum"], delta)
        peak_seq = blocked_max_affine_const(xs, state["peak"], rel, P=P)
        if self.group:
            cg = self.spec.channels // S
            stepn = self.group * cg
            if m % stepn:
                raise ValueError(f"group {self.group} (x{cg} ch) must divide "
                                 f"the {m}-sample block")
            G = m // stepn
            # group-END window sums, group-MAX peaks (the peak detector
            # still sees every sample), speed^(group*cg)
            des_g = desired_gain(
                rsum_seq[:, stepn - 1::stepn],
                peak_seq.reshape(S, G, stepn).amax(dim=2),
                target, max_gain, floor, inv_window)
            params = torch.stack([ipow(att, stepn), ipow(rel, stepn), max_gain])
            gain_g = first_order(des_g, des_g, state["gain"], op="agc_gain",
                                 params=params)
            gain_seq = gain_g.repeat_interleave(stepn, dim=1)
        else:
            des = desired_gain(rsum_seq, peak_seq, target, max_gain, floor,
                               inv_window)
            gain_seq = first_order(des, des, state["gain"], op="agc_gain",
                                   params=torch.stack([att, rel, max_gain]))
        return gain_seq, (peak_seq[:, m - 1], rsum_seq[:, m - 1],
                          gain_seq[:, m - 1])

    def _associative(self, state, xs, delta):
        """The JAX node's third branch: the peak detector as the associative
        max-affine scan, the RMS sum as a cumulative sum, the desired gain
        elementwise, the smoother as K7's ``agc_gain``."""
        rel, att = state["rel"], state["att"]
        max_gain = state["consts"][1]
        peak_seq = max_affine_scan(xs, (1.0 - rel) * xs, rel.expand_as(xs),
                                   state["peak"], mode="parallel")
        sum_seq = _window_sums(state["rms_sum"], delta)
        desired = self._desired(state, sum_seq, peak_seq)
        gain_seq = first_order(desired, desired, state["gain"], op="agc_gain",
                               params=torch.stack([att, rel, max_gain]))
        return gain_seq, (peak_seq[:, -1], sum_seq[:, -1], gain_seq[:, -1])

    def _desired(self, state, sum_seq, peak_seq):
        """The desired gain as the reference computes it: rms = sqrt(sum /
        W), target / rms and target / peak, each capped at max_gain."""
        target, max_gain, floor, _ = state["consts"]
        rms = sqrt_rn(sum_seq / float(RMS_WINDOW_SIZE))
        rms_gain = torch.where(rms > 0.0, target / rms, max_gain)
        peak_gain = torch.where(peak_seq > 0.0,
                                torch.minimum(target / peak_seq, max_gain),
                                max_gain)
        return torch.maximum(torch.minimum(rms_gain, peak_gain), floor)

    def _exact(self, state, xs, sq, old):
        """The reference's order, step by step: peak, then
        ``sum = (sum - old) + new``; rms = sqrt(sum / W), target / rms."""
        rel, att = state["rel"], state["att"]
        max_gain = state["consts"][1]
        peak, rsum = state["peak"], state["rms_sum"]
        zero = torch.zeros_like(peak)
        pks, rss = [], []
        for i in range(xs.shape[1]):
            xv = xs[:, i]
            coeff = torch.where(xv > peak, zero, rel)
            peak = peak * coeff + xv * (1.0 - coeff)
            rsum = (rsum - old[:, i]) + sq[:, i]
            pks.append(peak)
            rss.append(rsum)
        peak_seq, sum_seq = torch.stack(pks, 1), torch.stack(rss, 1)
        desired = self._desired(state, sum_seq, peak_seq)
        gain_seq = smooth_gains(desired, state["gain"], att, rel, max_gain)
        return gain_seq, (peak, rsum, gain_seq[:, -1])
