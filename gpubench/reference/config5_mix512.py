"""Plain reference of ``config5_mix512``: per lane the lerp resampler and
the low-pass, each stream's gain, the sum over streams, the master limiter.
Lanes run in chunks, so that a job of 1024 lanes x 512,000 frames fits."""
from __future__ import annotations

import torch

from gpubench.reference.common import F64, biquad, lerp_resample, limiter, low_pass, ratio, stage


def render(lanes: torch.Tensor, gains, cfg: dict, n_out: int,
           store: torch.dtype = F64, chunk: int = 128) -> torch.Tensor:
    """lanes [streams * channels, frames] (stream-major rows, any float
    type, frames past the last right tap), gains [streams] -> the limited
    mix [channels, n_out], float64."""
    C = cfg["channels"]
    fr, to = ratio(cfg["in_rate"], cfg["out_rate"])
    coef = low_pass(cfg["out_rate"], cfg["low_pass_hz"], cfg["low_pass_q"])
    per_lane = torch.as_tensor(gains, dtype=F64).repeat_interleave(C).to(lanes.device)
    mix = torch.zeros((C, n_out), dtype=F64, device=lanes.device)
    for l0 in range(0, lanes.shape[0], chunk):
        x = stage(lanes[l0:l0 + chunk].to(F64), store)
        y = stage(lerp_resample(x, fr, to, n_out), store)
        y = stage(biquad(y, coef), store)
        y = y * per_lane[l0:l0 + chunk, None]
        mix += y.reshape(-1, C, n_out).sum(0)
        del x, y
    mix = stage(mix, store)
    return stage(limiter(mix, cfg["out_rate"]), store)
