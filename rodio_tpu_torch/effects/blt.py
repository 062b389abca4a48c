"""Biquad (BLT) filters — low/high pass (rodio_tpu/effects/blt.py).

The coefficients live in the STATE as a [5] tensor on the device, so a live
retune (``to_low_pass`` / ``to_high_pass`` / ``*_with_q``,
src/source/blt.rs:68-91) is a pure state update: the kernel reads them as
data, and the filter history carries over.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State, mask_block
from ..ops.cuda_scan import biquad_df1
from ..ops.scan import biquad_df1 as biquad_scan, check_mode
from ..utils.trace import spanned

F = np.float32


class BiquadCoefficients:
    __slots__ = ("b0", "b1", "b2", "a1", "a2")

    def __init__(self, b0, b1, b2, a1, a2):
        self.b0, self.b1, self.b2, self.a1, self.a2 = (
            F(b0), F(b1), F(b2), F(a1), F(a2),
        )

    def as_tuple(self):
        return tuple(float(v) for v in (self.b0, self.b1, self.b2, self.a1, self.a2))

    def apply(self, x, x1, x2, y1, y2):
        """One DF-I step on f32 host scalars (the oracle's
        ``rodio_tpu_torch.refimpl.BltFilter``)."""
        return F(self.b0 * x + self.b1 * x1 + self.b2 * x2 - self.a1 * y1 - self.a2 * y2)


def blt_coefficients(kind: str, sample_rate: int, freq: float,
                     q: float) -> BiquadCoefficients:
    """Audio-EQ-Cookbook biquad synthesis in f32 (src/source/blt.rs:502-545),
    on the host (rodio_tpu/refimpl/effects.py blt_coefficients)."""
    w0 = F(F(2.0) * F(np.pi) * F(freq) / F(sample_rate))
    alpha = F(F(np.sin(w0)) / F(2.0 * F(q)))
    cos_w0 = F(np.cos(w0))
    if kind == "low_pass":
        b1 = F(1.0) - cos_w0
        b0 = F(b1 / F(2.0))
        b2 = b0
    elif kind == "high_pass":
        b0 = F((F(1.0) + cos_w0) / F(2.0))
        b1 = F(-1.0) - cos_w0
        b2 = b0
    else:
        raise ValueError(kind)
    a0 = F(1.0) + alpha
    a1 = F(-2.0) * cos_w0
    a2 = F(1.0) - alpha
    return BiquadCoefficients(
        F(b0 / a0), F(b1 / a0), F(b2 / a0), F(a1 / a0), F(a2 / a0)
    )


class BltFilter(Node):
    """Low-pass / high-pass biquad (Audio-EQ-Cookbook), per-channel state.

    ``mode``: "auto", "exact" and "pallas" all run the sequential order,
    which is the order K4 runs: the kernel on a CUDA tensor, the plain scan
    on a CPU tensor. "parallel" runs the associative scan of the 2x2
    companion maps in torch ops (``ops/scan.biquad_df1``), on any device.
    Any other name raises ``ValueError`` (the JAX node takes an unknown
    name as "parallel": ROADMAP F9)."""

    def __init__(self, input_node: Node, kind: str, freq: float, q: float = 0.5,
                 *, mode: str = "auto"):
        check_mode(mode, ("auto", "exact", "pallas", "parallel"), who="BltFilter")
        self.input = input_node
        self.spec = input_node.spec
        self.device = input_node.device
        self.kind = kind
        self.freq = float(freq)
        self.q = float(q)
        self.mode = mode
        self.coeffs = blt_coefficients(kind, self.spec.sample_rate, freq, q).as_tuple()

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        dt = self.dtype
        z = torch.zeros(self.spec.channels, dtype=dt, device=self.device)
        return {"in": self.input.init_state(),
                "coef": torch.tensor(self.coeffs, dtype=dt, device=self.device),
                "x1": z, "x2": z, "y1": z, "y2": z}

    def retune(self, state: State, kind: Optional[str] = None,
               freq: Optional[float] = None, q: Optional[float] = None) -> State:
        """Live retune: new f32 coefficients swapped into the state, the
        history (x1/x2/y1/y2) kept, as the reference keeps it across
        ``set_to``."""
        kind = kind or self.kind
        freq = self.freq if freq is None else float(freq)
        q = self.q if q is None else float(q)
        co = blt_coefficients(kind, self.spec.sample_rate, freq, q).as_tuple()
        return {**state, "coef": torch.tensor(co, dtype=state["coef"].dtype,
                                              device=self.device)}

    @spanned("rodio.emit.BltFilter")
    def emit(self, state: State, n: int):
        s, x, valid = self.input.emit(state["in"], n)
        st = (state["x1"], state["x2"], state["y1"], state["y2"])
        if self.mode == "parallel":
            y, (x1, x2, y1, y2) = biquad_scan(x, state["coef"], st, mode="parallel")
        else:
            y, (x1, x2, y1, y2) = biquad_df1(x, state["coef"], st)
        return (
            {"in": s, "coef": state["coef"], "x1": x1, "x2": x2, "y1": y1, "y2": y2},
            mask_block(y, valid),
            valid,
        )
