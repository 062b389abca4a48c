"""Dither: subtractive dither at a target bit depth
(rodio_tpu/effects/dither.py, src/source/dither.rs).

output = x - noise * lsb, lsb = 1 / 2^(bits-1), the noise one of TPDF
(default, triangular), RPDF (uniform), GPDF (Gaussian) or HighPass (blue,
independent per channel). One [C, T] noise block per emit, drawn by
``ops/threefry.py`` as the JAX package draws it with ``jax.random``, so
every algorithm but GPDF (XLA's ``erf_inv``, within 3 ulp) is bit-equal to
the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State, mask_block
from ..core.types import check_bit_depth
from ..ops import threefry
from ..sources.noise import GAUSSIAN_STD

ALGORITHMS = ("tpdf", "rpdf", "gpdf", "highpass")


class Dither(Node):
    def __init__(self, input_node: Node, target_bits: int,
                 algorithm: str = "tpdf", seed: int = 0):
        algorithm = algorithm.lower()
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown dither algorithm {algorithm!r}")
        self.input = input_node
        self.spec = input_node.spec
        self.device = input_node.device
        self.algorithm = algorithm
        bits = check_bit_depth(target_bits)
        self.lsb_amplitude = float(1.0 / (1 << (bits - 1)))
        self.seed = seed

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        st = {"in": self.input.init_state(),
              "key": threefry.seed_key(self.seed, self.device),
              "i": torch.zeros((), dtype=torch.int64, device=self.device)}
        if self.algorithm == "highpass":
            # the last white sample per channel, carried across blocks so the
            # differentiated noise is continuous at block boundaries
            st["prev"] = torch.zeros((self.spec.channels,), dtype=torch.float32,
                                     device=self.device)
        return st

    def _noise(self, state: State, c: int, n: int):
        key, i = state["key"], state["i"]
        if self.algorithm == "tpdf":
            u = threefry.uniform(key, i, 2 * c * n).view(2, c, n)
            return u[0] - u[1], None
        if self.algorithm == "rpdf":
            return threefry.uniform(key, i, c * n, -1.0, 1.0).view(c, n), None
        if self.algorithm == "gpdf":
            std = torch.full((), float(np.float32(GAUSSIAN_STD)), dtype=torch.float32,
                             device=self.device)
            return threefry.normal(key, i, c * n).view(c, n) * std, None
        u = threefry.uniform(key, i, c * n, -1.0, 1.0).view(c, n)
        shifted = torch.cat([state["prev"][:, None], u[:, :-1]], dim=1)
        return u - shifted, u[:, -1]

    def emit(self, state: State, n: int):
        s, block, valid = self.input.emit(state["in"], n)
        noise, new_prev = self._noise(state, self.spec.channels, n)
        lsb = torch.full((), self.lsb_amplitude, dtype=torch.float32, device=self.device)
        out = mask_block(block - noise * lsb, valid)
        new = {"in": s, "key": state["key"], "i": threefry.wrap_i32(state["i"] + n)}
        if self.algorithm == "highpass":
            new["prev"] = new_prev
        return new, out, valid
