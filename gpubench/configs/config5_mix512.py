"""BASELINE config 5 through the port's public constructors: 512 stereo
streams at 44.1 kHz, resampled to 48 kHz, low-passed (2 kHz, Q 0.5), gained,
mixed to stereo and limited, on the fused path (K1, then K3).

``job_chain`` builds the chain over a slice of PCM the benchmark made, as
``make_flagship`` builds it over its own; ``farm`` builds the live farm over
files, as ``chip_smoke.py``'s path P does.
"""
from __future__ import annotations


def ratio(cfg):
    import math

    g = math.gcd(cfg["in_rate"], cfg["out_rate"])
    return cfg["in_rate"] // g, cfg["out_rate"] // g


def job_chain(pcm, gains, cfg, device):
    """SamplesBuffer -> FusedWidePipeline -> Limit over pcm [streams *
    channels, frames] (a tensor on ``device``), the zero padding as
    ``make_flagship`` sizes it for a block."""
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.flagship import FusedWidePipeline
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    fr, to = ratio(cfg)
    pad = (cfg["block_frames"] // to + 2) * fr
    buf = SamplesBuffer(cfg["streams"] * cfg["channels"], cfg["in_rate"], pcm,
                        pad_frames=max(8192, -(-pad // 256) * 256), device=device)
    fused = FusedWidePipeline(buf, cfg["out_rate"], gains, cfg["streams"], "low_pass",
                              cfg["low_pass_hz"], cfg["low_pass_q"],
                              precision=cfg["precision"])
    return Limit(fused, LimitSettings(), mode=cfg["limit_mode"])


def farm(paths, offsets_s, gains, cfg, mix, device):
    """The live farm: one decode stream a path, K1's ring mode and K3."""
    from rodio_tpu_torch.parallel.farm import StreamFarm

    return StreamFarm(paths, out_rate=cfg["out_rate"], block_frames=cfg["block_frames"],
                      gains=gains, low_pass=cfg["low_pass_hz"], start_offsets=offsets_s,
                      loop=True, chunk_frames=mix["chunk_frames"],
                      decode_workers=mix["decode_workers"], wire=mix["wire"],
                      fused=True, device=device)
