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

The f64 draws (``set_float64``, JAX with x64 on) follow JAX 0.9.0 as well:

- a seed is an int64: ``seed_key(s, x64=True)`` is ``[(s >> 32) & M32, s &
  M32]`` (a negative seed's high word is 0xFFFFFFFF);
- a 64-bit draw is ``bits1 << 32 | bits2`` of the same hash
  (``jax/_src/prng.py:1193-1196``);
- ``uniform``: the draw's top 52 bits as the mantissa of a double in [1,
  2), minus 1, times ``hi - lo``, plus ``lo``, then ``max(lo, .)``
  (``jax/_src/random.py:435-470``). JAX's f64 ``uniform`` on XLA:CPU
  contracts ``f * span + lo`` into an FMA; for the spans the noise sources
  and ``Dither`` use (1, 2, and ``normal``'s, which rounds to 2) the
  product is exact, so the port's separately rounded ops give JAX's draws
  bit for bit. An odd span can land 1 ulp from JAX's (ROADMAP F4);
- ``randint``'s default type under x64 is int64: two 64-bit draws a value,
  reduced modulo the span in uint64 arithmetic, the multiplier ``(2^32 %
  span)^2 % span``; Velvet draws so;
- ``normal``: ``sqrt(2) * erf_inv(u)``, u on ``[nextafter(-1, 0), 1)`` in
  f64, through XLA's f64 ``erf_inv`` (Giles' double-precision polynomials,
  :func:`erf_inv`).

The plain versions run on int64 tensors with ``& 0xFFFFFFFF`` after every
add and shift, on any device; the wrappers launch the kernel on a CUDA
tensor and run the plain version on a CPU one. Three fused shapes serve the
noise module: a block's draws under ``fold_in(key, i)`` (raw bits or the
uniform conversion), Velvet's per-sample cell draws and Pink's 16 octave
draws a sample. ``launches`` counts the kernel's f32 launches,
``f64_launches`` those of its f64 instance (``dtype=torch.float64``).
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

#: kernel launches made by the wrappers below (f32 draws)
launches = 0
#: kernel launches of the f64 instance (``dtype=torch.float64``)
f64_launches = 0


def _i64(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def seed_key(seed: int, device=None, x64: bool = False) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for an int32 seed, or
    (``x64``: JAX with x64 on, where a seed is an int64) an int64 seed."""
    s = int(seed)
    bits = 64 if x64 else 32
    if not -2 ** (bits - 1) <= s < 2 ** (bits - 1):
        raise ValueError(f"seed {s} does not fit int{bits}")
    return _i64([(s >> 32) & M32 if x64 else 0, s & M32], device)


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
    b1, b2 = random_words_plain(key, n)
    return b1 ^ b2


def random_words_plain(key: torch.Tensor, n: int):
    """Both words (bits1, bits2) of the hashes of a shape of ``n`` elements
    (flattened): a 64-bit draw is ``bits1 << 32 | bits2``."""
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32_plain(key[0], key[1], j >> 32, j & M32)


def words_to_bits64(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The 64-bit draws ``b1 << 32 | b2`` as int64 (two's complement)."""
    return (wrap_i32(b1) << 32) | b2


def bits_to_uniform(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """JAX's ``_uniform`` conversion of 32-bit draws to f32 in [lo, hi)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo_t = torch.full((), lo, dtype=torch.float32, device=bits.device)
    span = torch.full((), float(np.float32(hi) - np.float32(lo)), dtype=torch.float32,
                      device=bits.device)
    return torch.maximum(lo_t, (f - 1.0) * span + lo_t)


def words_to_uniform64(b1: torch.Tensor, b2: torch.Tensor, lo: float,
                       hi: float) -> torch.Tensor:
    """JAX's f64 ``_uniform`` conversion of 64-bit draws (their words b1,
    b2) to f64 in [lo, hi): the top 52 bits as the mantissa of a double in
    [1, 2), minus 1, times (hi - lo), plus lo, then max(lo, .); each op
    rounded alone."""
    mant = (b1 << 20) | (b2 >> 12)
    f = (mant | 0x3FF0000000000000).view(torch.float64)
    lo_t = torch.full((), lo, dtype=torch.float64, device=b1.device)
    span = torch.full((), hi - lo, dtype=torch.float64, device=b1.device)
    return torch.maximum(lo_t, (f - 1.0) * span + lo_t)


def randint_plain(key: torch.Tensor, n: int, lo: int, hi: int,
                  x64: bool = False) -> torch.Tensor:
    """``jax.random.randint(key, (n,), lo, hi)`` (int32 values as int64;
    ``x64``: JAX's int64 default under x64, from 64-bit draws); ``key`` is
    [2] or a batch [..., 2] (the result is [..., n])."""
    k1, k2 = split2_plain(key)
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    if x64:
        span = hi - lo if hi > lo else 1
        if not 0 < span < 2 ** 31:
            raise ValueError(f"randint: span {span} out of the port's range")
        w32 = 2 ** 32 % span
        mult = w32 * w32 % span

        def rem(k):  # the 64-bit draw b1 * 2^32 + b2 modulo the span
            b1, b2 = threefry2x32_plain(k[..., 0:1], k[..., 1:2], j >> 32, j & M32)
            return (b1 % span * w32 + b2 % span) % span

        return lo + (rem(k1) * mult + rem(k2)) % span

    def bits(k):
        b1, b2 = threefry2x32_plain(k[..., 0:1], k[..., 1:2], j >> 32, j & M32)
        return b1 ^ b2

    higher, lower = bits(k1), bits(k2)
    span = (hi - lo) & M32 if hi > lo else 1
    mult = (((2 ** 16 % span) ** 2) & M32) % span
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    return lo + off % span


def _velvet_plain(key, i, n: int, grid: int, dtype: torch.dtype) -> torch.Tensor:
    t = wrap_i32(i + torch.arange(n, dtype=torch.int64, device=key.device))
    cell, pos = torch.div(t, grid, rounding_mode="floor"), torch.remainder(t, grid)
    draws = randint_plain(fold_in_plain(key, cell), 2, 0, 2 * grid,
                          x64=dtype == torch.float64)  # [n, 2]
    sign = torch.where(draws[:, 1] % 2 == 0, 1.0, -1.0)
    return torch.where(pos == draws[:, 0] % grid, sign, 0.0).to(dtype)


def _pink_plain(key, i, n: int, dtype: torch.dtype) -> torch.Tensor:
    t = wrap_i32(i + torch.arange(n, dtype=torch.int64, device=key.device))
    acc = None
    for octave in range(PINK_OCTAVES):
        k = fold_in_plain(fold_in_plain(key, octave), t >> octave)  # [n, 2]
        b1, b2 = threefry2x32_plain(k[:, 0], k[:, 1], torch.zeros_like(t),
                                    torch.zeros_like(t))
        v = (words_to_uniform64(b1, b2, -1.0, 1.0) if dtype == torch.float64
             else bits_to_uniform(b1 ^ b2, -1.0, 1.0))
        acc = v if acc is None else acc + v  # the sum in the octaves' order
    return acc


def _check_dtype(dtype: torch.dtype) -> bool:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"threefry: dtype must be float32 or float64, got {dtype}")
    return dtype == torch.float64


def threefry_plain(key: torch.Tensor, i, n: int, mode: str, lo: float = 0.0,
                   hi: float = 1.0, grid: int = 1,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of the kernel, on any device. ``i`` is the block
    counter (an int or a 0-dim int64 tensor): ``bits`` and ``uniform`` draw
    ``n`` values under ``fold_in(key, i)``, ``velvet`` and ``pink`` the
    samples ``t = i + j`` of their sources (int32, wrapping). Returns [n]:
    int64 words for ``bits`` (the 32-bit draws, or for f64 the 64-bit ones
    in two's complement), ``dtype`` otherwise (Pink's octave sum before its
    division by 16). ``dtype=torch.float64`` draws as JAX does under x64."""
    f64 = _check_dtype(dtype)
    if mode in ("bits", "uniform"):
        b1, b2 = random_words_plain(fold_in_plain(key, i), n)
        if f64:
            return (words_to_bits64(b1, b2) if mode == "bits"
                    else words_to_uniform64(b1, b2, lo, hi))
        return b1 ^ b2 if mode == "bits" else bits_to_uniform(b1 ^ b2, lo, hi)
    i = _i64(i, key.device)
    if mode == "velvet":
        return _velvet_plain(key, i, n, grid, dtype)
    if mode == "pink":
        return _pink_plain(key, i, n, dtype)
    raise ValueError(f"unknown threefry mode {mode!r}")


def threefry(key: torch.Tensor, i, n: int, mode: str, lo: float = 0.0,
             hi: float = 1.0, grid: int = 1,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`threefry_plain` as one kernel launch on a CUDA key; ``i`` is
    then a 0-dim int64 tensor on the card, and ``bits`` come back as int32
    words (the uint32 bits; for f64 int64 words, the uint64 bits). An f64
    ``dtype`` launches the kernel's f64 instance."""
    f64 = _check_dtype(dtype)
    if key.device.type == "cpu":
        return threefry_plain(key, i, n, mode, lo, hi, grid, dtype)
    if key.device.type != "cuda":
        raise ValueError(f"threefry: unsupported device {key.device}")
    if mode not in MODES:
        raise ValueError(f"unknown threefry mode {mode!r}")
    if n < 0 or grid < 1:
        raise ValueError(f"threefry: n={n}, grid={grid} invalid for {mode}")
    dev = key.device
    key = _build.i64_arg("key", key, dev, (2,))
    ctr = _build.i64_arg("i", i, dev, ())
    words = torch.int64 if f64 else torch.int32
    out = torch.empty(n, dtype=words if mode == "bits" else dtype, device=dev)
    if f64:
        name, bounds = "rt_threefry_f64", (float(lo), float(hi))
    else:
        name, bounds = "rt_threefry", (float(np.float32(lo)), float(np.float32(hi)))
    err = getattr(_build.load_library(), name)(
        key.data_ptr(), ctr.data_ptr(), MODES.index(mode), n, *bounds, grid,
        out.data_ptr(), _build.stream_handle(dev))
    _build.check(err, name)
    global launches, f64_launches
    if f64:
        f64_launches += 1
    else:
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
# erf_inv's f64 polynomials (M. Giles' double-precision branches), as XLA
# lowers jax.lax.erf_inv on f64 (the constants of its compiled HLO, JAX
# 0.9.0): w = -log1p(-x*x); below w = 6.25 degree 22 in w - 3.125, below 16
# degree 18 in sqrt(w) - 3.25, otherwise degree 16 in sqrt(w) - 5; the
# three lists are aligned at their leading coefficient, as XLA selects them
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221)
#: jax.random.normal's lower bound for its uniform: nextafter(-1, 0) in f32
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
#: ... and in f64 (its span 1 - lo rounds to 2.0, so the draws are exact)
NORMAL_LO64 = float(np.nextafter(-1.0, 0.0))
#: the f64 erf_inv (and normal draw) against JAX's, in ulp of the result:
#: XLA:CPU's own f64 log1p lies up to 128 ulp from PyTorch's (and numpy's)
#: near w = 0.5, which the polynomial carries to 31 ulp of a normal draw
#: at |z| = 0.92 (measured on 5e6 draws; 21 on a dense grid of erf_inv);
#: with XLA's log1p substituted the rest (its FMA contraction of the
#: Horner steps) is within 2 ulp (ROADMAP F4)
ERFINV64_ULPS = 48
SQRT2 = float(np.float32(np.sqrt(2.0)))


def _erf_inv64(x: torch.Tensor) -> torch.Tensor:
    """XLA's f64 ``erf_inv``: its three Horner polynomials, each mul and
    add rounded alone (XLA:CPU may contract them into FMAs, and its
    ``log1p`` is its own: ROADMAP F4)."""
    def c(v):
        return torch.full((), v, dtype=torch.float64, device=x.device)

    w = -torch.log1p(x * (-x))
    lt625, lt16 = w < c(6.25), w < c(16.0)
    sw = sqrt_rn(w)
    w = torch.where(lt625, w - c(3.125), sw - torch.where(lt16, c(3.25), c(5.0)))

    def coef(i):
        v = c(_ERFINV64_LT625[i])
        if i < len(_ERFINV64_LT16):
            v = torch.where(lt625, v, c(_ERFINV64_LT16[i]))
        if i < len(_ERFINV64_GE16):
            v = torch.where(lt16, v, c(_ERFINV64_GE16[i]))
        return v

    p = coef(0)
    for i in range(1, len(_ERFINV64_LT625)):
        q = coef(i) + p * w
        if i < len(_ERFINV64_GE16):
            p = q
        else:  # past a shorter polynomial's end, its branch keeps p
            p = torch.where(lt16 if i < len(_ERFINV64_LT16) else lt625, q, p)
    return torch.where(x.abs() == c(1.0), x * c(float("inf")), p * x)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 (or, on an f64 ``x``, f64) ``erf_inv`` in PyTorch ops,
    each rounded alone (the square root correctly rounded, as XLA's is:
    ``sqrt_rn``). XLA's own ``log1p`` and its FMA contraction of the Horner
    steps differ from PyTorch's by an ulp here and there, so an f32 normal
    draw lands within 3 ulp of JAX's (not bit-equal); ``torch.erfinv`` is
    up to 91 ulp away. The f64 polynomials amplify a ``log1p`` ulp near
    |x| = 1 (:data:`ERFINV64_ULPS`)."""
    if x.dtype == torch.float64:
        return _erf_inv64(x)

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
            hi: float = 1.0, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(fold_in(key, i), (n,), dtype, lo, hi)``."""
    return threefry(key, i, n, "uniform", lo, hi, dtype=dtype)


def normal(key: torch.Tensor, i, n: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(fold_in(key, i), (n,), dtype)``: sqrt(2) *
    erf_inv of a uniform draw on [nextafter(-1, 0), 1)."""
    if dtype == torch.float64:
        u = threefry(key, i, n, "uniform", NORMAL_LO64, 1.0, dtype=dtype)
        return torch.full((), float(np.sqrt(2.0)), dtype=dtype, device=u.device) * erf_inv(u)
    u = threefry(key, i, n, "uniform", NORMAL_LO, 1.0)
    return torch.full((), SQRT2, dtype=torch.float32, device=u.device) * erf_inv(u)
