"""The noise family (rodio_tpu/sources/noise.py, src/source/noise.rs).

Counter-based draws as in the JAX package: a block's randomness is a pure
function of (key, sample counter), drawn by ``ops/threefry.py`` bit for bit
as ``jax.random`` (threefry2x32) draws it; one kernel launch a block on the
card. The state holds the key (an int64 ``[2]`` of two uint32 words) and
the counter ``i``, an int32 value that wraps as JAX's does. Mono and
infinite, as in the reference.

- WhiteUniform  — U[-1, 1] (RPDF), variance 1/3
- WhiteTriangular — Triangular(-1, 1, 0) (TPDF)
- WhiteGaussian — Normal(0, 0.6) (GPDF); its draws go through XLA's
  ``erf_inv`` polynomial, within 3 ulp of JAX's (``ops/threefry.erf_inv``)
- Velvet — one +-1 impulse per grid cell, default density 2000/s
- Pink — Voss-McCartney's 16 octave generators in closed form
- Blue, Violet — differentiated white and blue
- Brownian, Red — leaky-integrated Gaussian and uniform white, 5 Hz leak
  centre frequency, variance-normalised; the integration is K7's
  ``linear`` op on the card (``ops/cuda_scan.first_order``), the
  sequential ``linear_scan`` on the CPU
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State, full_valid
from ..core.types import StreamSpec
from ..ops import threefry
from ..ops.cuda_scan import first_order
from ..utils.device import DeviceLike, resolve_device

PINK_NOISE_GENERATORS = threefry.PINK_OCTAVES
VELVET_DEFAULT_DENSITY = 2000
UNIFORM_STD = float(np.sqrt(1.0 / 3.0))
TRIANGULAR_STD = float(2.0 / np.sqrt(6.0))
GAUSSIAN_STD = 0.6


def _f32(v: float, device) -> torch.Tensor:
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=device)


class _NoiseBase(Node):
    def __init__(self, sample_rate: int, seed: int = 0, *, device: DeviceLike = None):
        self.spec = StreamSpec(1, sample_rate)
        self.seed = seed
        self.device = resolve_device(device)

    def total_frames(self) -> Optional[int]:
        return None

    def init_state(self) -> State:
        return {"key": threefry.seed_key(self.seed, self.device),
                "i": torch.zeros((), dtype=torch.int64, device=self.device)}

    def _advance(self, state: State, n: int) -> State:
        return {"key": state["key"], "i": threefry.wrap_i32(state["i"] + n)}

    def _uniform(self, state: State, n: int, lo: float = -1.0, hi: float = 1.0):
        return threefry.uniform(state["key"], state["i"], n, lo, hi)


class WhiteUniform(_NoiseBase):
    def std_dev(self):
        return UNIFORM_STD

    def emit(self, state: State, n: int):
        block = self._uniform(state, n)[None, :]
        return self._advance(state, n), block, full_valid(n, self.device)


class WhiteTriangular(_NoiseBase):
    def std_dev(self):
        return TRIANGULAR_STD

    def emit(self, state: State, n: int):
        u = self._uniform(state, 2 * n, 0.0, 1.0)  # the JAX shape (2, 1, n)
        block = (u[:n] - u[n:])[None, :]  # Triangular(-1, 1, mode 0)
        return self._advance(state, n), block, full_valid(n, self.device)


class WhiteGaussian(_NoiseBase):
    def mean(self):
        return 0.0

    def std_dev(self):
        return GAUSSIAN_STD

    def emit(self, state: State, n: int):
        g = threefry.normal(state["key"], state["i"], n)
        block = (g * _f32(GAUSSIAN_STD, self.device))[None, :]
        return self._advance(state, n), block, full_valid(n, self.device)


class Velvet(_NoiseBase):
    """Sparse +-1 impulses, one per grid cell (src/source/noise.rs:359-457):
    cell c's impulse offset and sign are drawn under fold_in(key, c)."""

    def __init__(self, sample_rate: int, density: int = VELVET_DEFAULT_DENSITY,
                 seed: int = 0, *, device: DeviceLike = None):
        super().__init__(sample_rate, seed, device=device)
        if density <= 0:
            raise ValueError("density must be positive")
        self.grid_size = int(np.ceil(sample_rate / density))

    def emit(self, state: State, n: int):
        block = threefry.threefry(state["key"], state["i"], n, "velvet",
                                  grid=self.grid_size)[None, :]
        return self._advance(state, n), block, full_valid(n, self.device)


class Pink(_NoiseBase):
    """Voss-McCartney pink noise (src/source/noise.rs:427-514 semantics):
    octave generator o holds uniform(fold_in(fold_in(key, o), t >> o)) for
    2^o samples; the 16 values of a sample are summed in octave order."""

    def emit(self, state: State, n: int):
        acc = threefry.threefry(state["key"], state["i"], n, "pink")
        block = (acc / _f32(PINK_NOISE_GENERATORS, self.device))[None, :]
        return self._advance(state, n), block, full_valid(n, self.device)


class Blue(_NoiseBase):
    """Differentiated white (src/source/noise.rs:546-608)."""

    def init_state(self) -> State:
        st = super().init_state()
        st["prev"] = torch.zeros((), dtype=torch.float32, device=self.device)
        return st

    def emit(self, state: State, n: int):
        white = self._uniform(state, n)
        prev = torch.cat([state["prev"][None], white[:-1]])
        new = self._advance(state, n)
        new["prev"] = white[-1]
        return new, (white - prev)[None, :], full_valid(n, self.device)


class Violet(_NoiseBase):
    """Differentiated blue (src/source/noise.rs:614-695)."""

    def init_state(self) -> State:
        st = super().init_state()
        st["prev_white"] = torch.zeros((), dtype=torch.float32, device=self.device)
        st["prev_blue"] = torch.zeros((), dtype=torch.float32, device=self.device)
        return st

    def emit(self, state: State, n: int):
        white = self._uniform(state, n)
        blue = white - torch.cat([state["prev_white"][None], white[:-1]])
        violet = blue - torch.cat([state["prev_blue"][None], blue[:-1]])
        new = self._advance(state, n)
        new["prev_white"] = white[-1]
        new["prev_blue"] = blue[-1]
        return new, violet[None, :], full_valid(n, self.device)


class _Integrated(_NoiseBase):
    """Leaky integrator over a white source (src/source/noise.rs:701-716):
    acc' = leak*acc + white; output acc*scale."""

    white_std = 1.0

    def __init__(self, sample_rate: int, seed: int = 0, *, device: DeviceLike = None):
        super().__init__(sample_rate, seed, device=device)
        leak = 1.0 - (2.0 * np.pi * 5.0) / sample_rate  # 5 Hz centre frequency
        variance = (self.white_std ** 2) / (1.0 - leak * leak)
        self.leak = float(leak)
        self.scale = float(1.0 / np.sqrt(variance))

    def init_state(self) -> State:
        st = super().init_state()
        st["acc"] = torch.zeros((1,), dtype=torch.float32, device=self.device)
        return st

    def _white(self, state: State, n: int) -> torch.Tensor:
        raise NotImplementedError

    def emit(self, state: State, n: int):
        white = self._white(state, n)[None, :]
        leak = torch.full_like(white, float(np.float32(self.leak)))
        acc = first_order(leak, white, state["acc"], op="linear")
        new = self._advance(state, n)
        new["acc"] = acc[:, -1]
        return new, acc * _f32(self.scale, self.device), full_valid(n, self.device)


class Brownian(_Integrated):
    """Leaky-integrated Gaussian white (src/source/noise.rs:738)."""

    white_std = GAUSSIAN_STD

    def _white(self, state: State, n: int) -> torch.Tensor:
        return threefry.normal(state["key"], state["i"], n) * _f32(GAUSSIAN_STD, self.device)


class Red(_Integrated):
    """Leaky-integrated uniform white (src/source/noise.rs:821)."""

    white_std = UNIFORM_STD

    def _white(self, state: State, n: int) -> torch.Tensor:
        return self._uniform(state, n)
