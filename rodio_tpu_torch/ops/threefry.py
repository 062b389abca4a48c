"""Counter-based random bits: JAX's threefry2x32 (``csrc/threefry.cu``).

The noise sources and ``Dither`` of the JAX package draw ``jax.random``
bits (threefry2x32, ``jax_threefry_partitionable`` True, the default of JAX
0.9). The port draws the same bits, so a noise block equals JAX's bit for
bit: everything here is integer arithmetic, and the float conversions are
exact.

- A key is an int64 tensor ``[2]`` of two uint32 words (``key_data``).
  ``seed_key(s)`` is ``[s >> 32, s & 0xFFFFFFFF]`` for an int32 seed
  (``jax/_src/prng.py`` ``_threefry_seed``).
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under the key; the
  two output words are the new key (``_threefry_fold_in``).
- ``random_bits(key, N)``: flat counter ``j`` of the shape, split into its
  high and low words, hashed; the 32-bit draw is ``bits1 ^ bits2``
  (``_threefry_random_bits_partitionable``).
- ``uniform``: the draw's top 23 bits as the mantissa of a float in [1, 2),
  minus 1, times ``max - min``, plus ``min``, then ``max(min, .)``
  (``jax/_src/random.py`` ``_uniform``).
- ``randint``: two draws under the keys of a 2-way split, reduced modulo
  the span in uint32 arithmetic (``_randint``).

The plain versions run on int64 tensors with ``& 0xFFFFFFFF`` after every
add and shift, on any device; the wrappers launch the kernel on a CUDA
tensor and run the plain version on a CPU one. Three fused shapes serve the
noise module: a block's draws under ``fold_in(key, i)`` (raw bits or the
uniform conversion), Velvet's per-sample cell draws and Pink's 16 octave
draws a sample. ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import sqrt_rn
from . import _build

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: Pink's octave generators (src/source/noise.rs:427)
PINK_OCTAVES = 16
#: the kernel's modes (csrc/threefry.cu)
MODES = ("bits", "uniform", "velvet", "pink")

#: kernel launches made by the wrappers below
launches = 0


def _i64(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def seed_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for an int32 seed."""
    s = int(seed)
    if not -2 ** 31 <= s < 2 ** 31:
        raise ValueError(f"seed {s} does not fit int32")
    return _i64([0, s & M32], device)


def wrap_i32(x):
    """An int64 value or tensor wrapped to int32, as JAX's int32 counter
    wraps."""
    return ((x + 2 ** 31) & M32) - 2 ** 31


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32_plain(k1, k2, x1, x2):
    """Threefry2x32, 20 rounds, on int64 tensors of uint32 words
    (broadcast): ``jax/_src/prng.py`` ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + k1) & M32
    x2 = (x2 + k2) & M32
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(g + 1) % 3]) & M32
        x2 = (x2 + ks[(g + 2) % 3] + (g + 1)) & M32
    return x1, x2


def fold_in_plain(key: torch.Tensor, data):
    """``fold_in(key, data)`` for a scalar key [2]; ``data`` an int or an
    int64 tensor (one key per element: the result is [..., 2])."""
    d = _i64(data, key.device) & M32
    y1, y2 = threefry2x32_plain(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split2_plain(key: torch.Tensor):
    """The two keys of ``jax.random.split(key, 2)`` (the fold-like split):
    the counter pairs (0, 0) and (0, 1)."""
    lo = torch.tensor([0, 1], dtype=torch.int64, device=key.device)
    if key.dim() > 1:
        lo = lo.expand(*key.shape[:-1], 2)
    y1, y2 = threefry2x32_plain(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo), lo)
    return torch.stack([y1[..., 0], y2[..., 0]], -1), torch.stack([y1[..., 1], y2[..., 1]], -1)


def random_bits_plain(key: torch.Tensor, n: int):
    """The 32-bit draws of a shape of ``n`` elements (flattened), as int64."""
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32_plain(key[0], key[1], j >> 32, j & M32)
    return b1 ^ b2


def bits_to_uniform(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """JAX's ``_uniform`` conversion of 32-bit draws to f32 in [lo, hi)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo_t = torch.full((), lo, dtype=torch.float32, device=bits.device)
    span = torch.full((), float(np.float32(hi) - np.float32(lo)), dtype=torch.float32,
                      device=bits.device)
    return torch.maximum(lo_t, (f - 1.0) * span + lo_t)


def randint_plain(key: torch.Tensor, n: int, lo: int, hi: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), lo, hi)`` (int32 values as int64);
    ``key`` is [2] or a batch [..., 2] (the result is [..., n])."""
    k1, k2 = split2_plain(key)
    j = torch.arange(n, dtype=torch.int64, device=key.device)

    def bits(k):
        b1, b2 = threefry2x32_plain(k[..., 0:1], k[..., 1:2], j >> 32, j & M32)
        return b1 ^ b2

    higher, lower = bits(k1), bits(k2)
    span = (hi - lo) & M32 if hi > lo else 1
    mult = (((2 ** 16 % span) ** 2) & M32) % span
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    return lo + off % span


def _velvet_plain(key, i, n: int, grid: int) -> torch.Tensor:
    t = wrap_i32(i + torch.arange(n, dtype=torch.int64, device=key.device))
    cell, pos = torch.div(t, grid, rounding_mode="floor"), torch.remainder(t, grid)
    draws = randint_plain(fold_in_plain(key, cell), 2, 0, 2 * grid)  # [n, 2]
    sign = torch.where(draws[:, 1] % 2 == 0, 1.0, -1.0)
    return torch.where(pos == draws[:, 0] % grid, sign, 0.0).to(torch.float32)


def _pink_plain(key, i, n: int) -> torch.Tensor:
    t = wrap_i32(i + torch.arange(n, dtype=torch.int64, device=key.device))
    acc = None
    for octave in range(PINK_OCTAVES):
        k = fold_in_plain(fold_in_plain(key, octave), t >> octave)  # [n, 2]
        b1, b2 = threefry2x32_plain(k[:, 0], k[:, 1], torch.zeros_like(t),
                                    torch.zeros_like(t))
        v = bits_to_uniform(b1 ^ b2, -1.0, 1.0)
        acc = v if acc is None else acc + v  # the sum in the octaves' order
    return acc


def threefry_plain(key: torch.Tensor, i, n: int, mode: str, lo: float = 0.0,
                   hi: float = 1.0, grid: int = 1) -> torch.Tensor:
    """The plain version of the kernel, on any device. ``i`` is the block
    counter (an int or a 0-dim int64 tensor): ``bits`` and ``uniform`` draw
    ``n`` values under ``fold_in(key, i)``, ``velvet`` and ``pink`` the
    samples ``t = i + j`` of their sources (int32, wrapping). Returns [n]:
    int64 words for ``bits``, f32 otherwise (Pink's octave sum before its
    division by 16)."""
    if mode in ("bits", "uniform"):
        bits = random_bits_plain(fold_in_plain(key, i), n)
        return bits if mode == "bits" else bits_to_uniform(bits, lo, hi)
    i = _i64(i, key.device)
    if mode == "velvet":
        return _velvet_plain(key, i, n, grid)
    if mode == "pink":
        return _pink_plain(key, i, n)
    raise ValueError(f"unknown threefry mode {mode!r}")


def threefry(key: torch.Tensor, i, n: int, mode: str, lo: float = 0.0,
             hi: float = 1.0, grid: int = 1) -> torch.Tensor:
    """:func:`threefry_plain` as one kernel launch on a CUDA key; ``i`` is
    then a 0-dim int64 tensor on the card, and ``bits`` come back as int32
    words (the uint32 bits)."""
    if key.device.type == "cpu":
        return threefry_plain(key, i, n, mode, lo, hi, grid)
    if key.device.type != "cuda":
        raise ValueError(f"threefry: unsupported device {key.device}")
    if mode not in MODES:
        raise ValueError(f"unknown threefry mode {mode!r}")
    if n < 0 or grid < 1:
        raise ValueError(f"threefry: n={n}, grid={grid} invalid for {mode}")
    dev = key.device
    key = _build.i64_arg("key", key, dev, (2,))
    ctr = _build.i64_arg("i", i, dev, ())
    out = torch.empty(n, dtype=torch.int32 if mode == "bits" else torch.float32,
                      device=dev)
    err = _build.load_library().rt_threefry(
        key.data_ptr(), ctr.data_ptr(), MODES.index(mode), n,
        float(np.float32(lo)), float(np.float32(hi)), grid, out.data_ptr(),
        _build.stream_handle(dev))
    _build.check(err, "rt_threefry")
    global launches
    launches += 1
    return out


# erf_inv's f32 polynomials (M. Giles, "Approximating the erfinv function"),
# as XLA lowers jax.lax.erf_inv: w = -log1p(-x*x); below w = 5 a degree-8
# polynomial in w - 2.5, above it one in sqrt(w) - 3; erf_inv(x) = p * x
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)
#: jax.random.normal's lower bound for its uniform: nextafter(-1, 0) in f32
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` in PyTorch ops, each rounded alone (the square
    root correctly rounded, as XLA's is: ``sqrt_rn``). XLA's own ``log1p``
    and its FMA contraction of the Horner steps differ from PyTorch's by an
    ulp here and there, so a normal draw lands within 3 ulp of JAX's (not
    bit-equal); ``torch.erfinv`` is up to 91 ulp away."""
    def c(v):
        return torch.full((), float(np.float32(v)), dtype=torch.float32, device=x.device)

    w = -torch.log1p(x * (-x))
    lt = w < c(5.0)
    w = torch.where(lt, w - c(2.5), sqrt_rn(w) - c(3.0))
    p = torch.where(lt, c(_ERFINV_LT5[0]), c(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c(a), c(b)) + p * w
    return torch.where(x.abs() == c(1.0), x * c(float("inf")), p * x)


def uniform(key: torch.Tensor, i, n: int, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(fold_in(key, i), (n,), minval=lo, maxval=hi)``."""
    return threefry(key, i, n, "uniform", lo, hi)


def normal(key: torch.Tensor, i, n: int) -> torch.Tensor:
    """``jax.random.normal(fold_in(key, i), (n,))``: sqrt(2) * erf_inv of a
    uniform draw on [nextafter(-1, 0), 1)."""
    u = threefry(key, i, n, "uniform", NORMAL_LO, 1.0)
    return torch.full((), SQRT2, dtype=torch.float32, device=u.device) * erf_inv(u)
