"""BASELINE config 5 with config 2's AGC on every stream, through the port's
public constructors: 512 stereo streams at 44.1 kHz, resampled to 48 kHz,
low-passed (2 kHz, Q 0.5), each stream levelled by rodio's automatic gain
control (``AutomaticGainControlSettings::default()``), gained, mixed to
stereo and limited, on the fused path (K2's serial plan with an f32 ring of
squares, then K3).

``job_chain`` builds the chain over a slice of PCM the benchmark made, as
``config5_mix512.job_chain`` does, with the AGC on.
"""
from __future__ import annotations

from gpubench.configs.config5_mix512 import ratio  # noqa: F401  (the generators call it)


def job_chain(pcm, gains, cfg, device):
    """SamplesBuffer -> FusedWidePipeline(with_agc=True) -> Limit over pcm
    [streams * channels, frames] (a tensor on ``device``), the zero padding
    as ``make_flagship`` sizes it for a block."""
    from rodio_tpu_torch.effects import AgcSettings
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.flagship import FusedWidePipeline
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    fr, to = ratio(cfg)
    pad = (cfg["block_frames"] // to + 2) * fr
    buf = SamplesBuffer(cfg["streams"] * cfg["channels"], cfg["in_rate"], pcm,
                        pad_frames=max(8192, -(-pad // 256) * 256), device=device)
    agc = AgcSettings(target_level=cfg["agc_target_level"], attack_time=cfg["agc_attack_time"],
                      release_time=cfg["agc_release_time"],
                      absolute_max_gain=cfg["agc_absolute_max_gain"])
    fused = FusedWidePipeline(buf, cfg["out_rate"], gains, cfg["streams"], "low_pass",
                              cfg["low_pass_hz"], cfg["low_pass_q"],
                              precision=cfg["precision"], with_agc=True, agc_settings=agc,
                              agc_ring=cfg["agc_ring"], agc_plan=cfg["agc_plan"])
    return Limit(fused, LimitSettings(), mode=cfg["limit_mode"])
