"""Seeded inputs, made on the device from ``--seed`` in a few large calls.

``music`` is a 16-bit-grid stereo master: a kick on every beat (120 bpm),
partials on a 2 Hz grid under a beat-locked tremolo, and noise. A shift by
whole beats keeps the kick and the partials in phase, so stems that are
rotations of one master by whole beats (plus a jitter under a millisecond)
add up coherently, as the stems of one song do in a mixdown: the mix of 512
such streams reaches the master limiter's knee, where rotations by arbitrary
shifts would cancel to a few hundredths. The noise differs from stem to stem.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BEATS_PER_SECOND = 2
#: the largest jitter of a stem against the beat, in frames
JITTER = 16


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device, dtype=torch.float64)


def music(gen: torch.Generator, channels: int, frames: int, rate: int, device,
          *, variants: int = 1, sections: float = 0.0):
    """(f32 [variants, channels, frames] on the 16-bit grid, the same as
    int16). The variants share the kick and the partials and differ in
    their noise. ``sections`` > 0 gives the master a level per section of
    that many seconds, drawn from U(0.2, 1), for the AGC to follow."""
    t_idx = torch.arange(frames, device=device)
    period = rate // BEATS_PER_SECOND
    tb = (t_idx % period).to(torch.float64) / rate
    t = t_idx.to(torch.float64) / rate
    f_kick = float(_uniform(gen, 1, 50.0, 70.0, device))
    kick = torch.sin(2 * math.pi * f_kick * tb) * torch.exp(-tb / 0.08)
    n_part = 6
    freqs = 2.0 * torch.randint(40, 500, (n_part,), generator=gen, device=device).to(torch.float64)
    amps = _uniform(gen, n_part, 0.2, 1.0, device)
    amps = amps / amps.sum()
    phases = _uniform(gen, n_part, 0.0, 2 * math.pi, device)
    tremolo = 0.7 + 0.3 * torch.cos(2 * math.pi * BEATS_PER_SECOND * t)
    out = torch.empty((variants, channels, frames), dtype=torch.float32, device=device)
    level = None
    if sections:
        n_sec = -(-frames // int(sections * rate))
        level = _uniform(gen, n_sec, 0.2, 1.0, device)[t_idx // int(sections * rate)]
    for c in range(channels):
        tonal = (amps[:, None] * torch.sin(2 * math.pi * freqs[:, None] * t[None, :]
                                           + phases[:, None] + 0.3 * c)).sum(0) * tremolo
        common = 0.95 * kick + 0.25 * tonal
        for v in range(variants):
            noise = torch.randn(frames, generator=gen, device=device, dtype=torch.float64)
            x = common + 0.05 * noise
            if level is not None:
                x = x * level
            out[v, c] = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.float32)
    ints = out.to(torch.int16)
    return out / 32768.0, ints


def beat_shifts(rng: np.random.Generator, n: int, max_frames: int, rate: int) -> np.ndarray:
    """n shifts in [0, max_frames]: whole beats plus a jitter of up to
    :data:`JITTER` frames."""
    period = rate // BEATS_PER_SECOND
    beats = rng.integers(0, max(1, (max_frames - JITTER) // period + 1), size=n)
    return np.minimum(beats * period + rng.integers(0, JITTER, size=n), max_frames)


def corpus(gen: torch.Generator, rng: np.random.Generator, streams: int, channels: int,
           frames: int, rate: int, device, chunk: int = 16) -> torch.Tensor:
    """[streams * channels, frames] f32, stream-major rows: stream s is the
    master rotated by a shift of whole beats and a jitter."""
    base, _ = music(gen, channels, frames, rate, device)
    base = base[0]
    shifts = torch.as_tensor(beat_shifts(rng, streams, frames - 1, rate), device=device)
    out = torch.empty((streams * channels, frames), dtype=torch.float32, device=device)
    t = torch.arange(frames, device=device)
    for s0 in range(0, streams, chunk):
        sh = shifts[s0:s0 + chunk]
        idx = (t[None, :] - sh[:, None]) % frames
        rows = base[:, idx].transpose(0, 1).reshape(-1, frames)
        out[s0 * channels:s0 * channels + rows.shape[0]] = rows
    return out
