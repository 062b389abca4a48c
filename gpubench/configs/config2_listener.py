"""BASELINE config 2 through the port's public nodes: one stereo 44.1 kHz
track through low_pass(2 kHz, Q 0.5), the automatic gain control and the
limiter, both with rodio's default settings (``profile_slice.config2_chain``:
K4, then K8 and K7, or K6, then K3, or K5, as the block sizes select)."""
from __future__ import annotations


def chain(source, cfg):
    from rodio_tpu_torch.effects import AgcSettings, AutomaticGainControl, BltFilter
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings

    node = BltFilter(source, "low_pass", cfg["low_pass_hz"], cfg["low_pass_q"])
    node = AutomaticGainControl(node, AgcSettings(), mode=cfg["agc_mode"])
    return Limit(node, LimitSettings(), mode=cfg["limit_mode"])
