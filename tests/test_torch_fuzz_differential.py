"""Differential fuzz of the port's effect graphs against the refimpl oracle:
the port of ``tests/test_fuzz_differential.py``'s engine-against-refimpl
case (``test_fuzz_engine_vs_refimpl``).

The cases are the original's (its ``_build_case``: random 3-8 stage
graphs of amplify, biquad, AGC, limiter, distortion, take, ramp, delay,
skip and channel volume over random PCM, loaded from that file), rendered
through the port's nodes on the CPU (the sequential scans, ``exact``) with
a random block schedule and through ``rodio_tpu.refimpl``, held to the
original's ``_tolerance``. The whole file is ``slow``, as the original's
``pytestmark`` makes it.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

_spec = importlib.util.spec_from_file_location(
    "_fuzz_differential_cases", Path(__file__).with_name("test_fuzz_differential.py"))
_orig = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = _orig
_spec.loader.exec_module(_orig)

pytestmark = pytest.mark.slow


def _port_stage(name, p, node):
    from rodio_tpu_torch.effects import (
        AgcSettings, Amplify, AutomaticGainControl, BltFilter, ChannelVolume, Delay,
        Distortion, Limit, LimitSettings, LinearGainRamp, SkipDuration, TakeDuration)

    if name == "amplify":
        return Amplify(node, p["gain"])
    if name == "blt":
        return BltFilter(node, p["kind"], p["freq"], p["q"], mode=p["mode"])
    if name == "agc":
        return AutomaticGainControl(
            node, AgcSettings(attack_time=p["att"], release_time=p["rel"]), mode=p["mode"])
    if name == "limit":
        return Limit(node, LimitSettings(), mode=p["mode"])
    if name == "dist":
        return Distortion(node, p["drive"], p["thresh"])
    if name == "take":
        return TakeDuration(node, p["sec"], fadeout=p["fadeout"])
    if name == "ramp":
        return LinearGainRamp(node, p["sec"], p["g0"], p["g1"], p["clamp"])
    if name == "delay":
        return Delay(node, p["sec"])
    if name == "skip":
        return SkipDuration(node, p["sec"])
    if name == "chvol":
        return ChannelVolume(node, p["vols"])
    raise KeyError(name)


def _port_render(recipe, data, blocks_rng):
    from rodio_tpu_torch.sources import SamplesBuffer

    node = SamplesBuffer(data.shape[0], _orig.RATE, data, device="cpu")
    for nm, p in recipe:
        node = _port_stage(nm, p, node)
    state = node.init_state()
    sizes = list(blocks_rng.choice([64, 127, 256, 509, 997, 1024, 2048], size=3,
                                   replace=False))
    out = []
    while True:
        n = int(blocks_rng.choice(sizes))
        state, block, valid = node.emit(state, n)
        v = int(valid)
        out.append(block[:, :v].numpy())
        if v < n:
            break
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("seed", range(60))
def test_fuzz_port_vs_refimpl(seed):
    recipe, data, rng = _orig._build_case(seed, mode="exact")
    tol = _orig._tolerance(recipe)
    got = _orig.interleave(_port_render(recipe, data, rng))
    exp = _orig._ref_render(recipe, data)
    n = min(len(got), len(exp))
    assert n > 1000
    err = float(np.abs(got[:n] - exp[:n]).max())
    assert err <= tol, f"seed={seed} err={err:.3g} > {tol:g}; chain {[nm for nm, _ in recipe]}"
