"""BASELINE config 5 as 512 channel strips, through the port's public node
graph: each stereo stream at 44.1 kHz resampled to 48 kHz, low-passed
(2 kHz, Q 0.5), levelled by its own automatic gain control
(``AutomaticGainControlSettings::default()``), limited by its own limiter
(``LimitSettings::default()``) and faded by its gain; the 512 strips mixed
to stereo and the mix limited on the master bus. At 512 streams the nodes
run K4, K6, K5 and K3, with the node graph's torch ops between them.

``job_chain`` builds the chain over a slice of PCM the benchmark made, with
the zero padding ``config5_mix512.job_chain`` gives its buffer, so that every
block of a job is full.
"""
from __future__ import annotations

from gpubench.configs.config5_mix512 import ratio  # noqa: F401  (the generators call it)


def job_chain(pcm, gains, cfg, device):
    """SamplesBuffer -> Resample -> BltFilter -> AutomaticGainControl(streams)
    -> Limit(streams) -> Amplify -> WideMixer -> Limit over pcm [streams *
    channels, frames] (a tensor on ``device``), gains [streams]."""
    import numpy as np

    from rodio_tpu_torch.conversions.resample import Resample
    from rodio_tpu_torch.effects import (AgcSettings, Amplify, AutomaticGainControl, BltFilter,
                                         Limit, LimitSettings)
    from rodio_tpu_torch.parallel.batch import WideMixer
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    S, C = cfg["streams"], cfg["channels"]
    fr, to = ratio(cfg)
    pad = (cfg["block_frames"] // to + 2) * fr
    node = SamplesBuffer(S * C, cfg["in_rate"], pcm,
                         pad_frames=max(8192, -(-pad // 256) * 256), device=device)
    node = Resample(node, cfg["out_rate"])
    node = BltFilter(node, "low_pass", cfg["low_pass_hz"], cfg["low_pass_q"],
                     mode=cfg["low_pass_mode"])
    agc = AgcSettings(target_level=cfg["agc_target_level"], attack_time=cfg["agc_attack_time"],
                      release_time=cfg["agc_release_time"],
                      absolute_max_gain=cfg["agc_absolute_max_gain"])
    node = AutomaticGainControl(node, agc, mode=cfg["agc_mode"], streams=S)
    node = Limit(node, LimitSettings(), mode=cfg["strip_limit_mode"], streams=S)
    node = Amplify(node, np.repeat(np.asarray(gains, np.float32), C))
    return Limit(WideMixer(node, S), LimitSettings(), mode=cfg["limit_mode"])
