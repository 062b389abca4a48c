"""Plain reference of ``config2_listener``: the low-pass, the AGC and the
limiter on one stereo stream at its own rate; ``play`` adds the lerp
resampler that the mixer's Uniform stage applies on the way to the sink."""
from __future__ import annotations

import torch

from gpubench.reference.common import (F64, agc, biquad, lerp_resample, limiter, low_pass,
                                       ratio, stage)


def render(x: torch.Tensor, cfg: dict, store: torch.dtype = F64) -> torch.Tensor:
    """x [2, frames] -> the chain's output [2, frames], float64."""
    rate = cfg["in_rate"]
    y = stage(x.to(F64), store)
    y = stage(biquad(y, low_pass(rate, cfg["low_pass_hz"], cfg["low_pass_q"])), store)
    y = stage(agc(y, rate), store)
    return stage(limiter(y, rate), store)


def play(x: torch.Tensor, cfg: dict, out_rate: int, n_out: int,
         store: torch.dtype = F64) -> torch.Tensor:
    """The chain's output resampled to ``out_rate``: [2, n_out], float64.
    x holds the frames up to the last right tap."""
    fr, to = ratio(cfg["in_rate"], out_rate)
    y = render(x, cfg, store)
    return stage(lerp_resample(y, fr, to, n_out), store)
