"""Math utilities: the slice's part of rodio_tpu/core/math.py, on tensors.

``exp2_precise``/``log2_precise`` use the same range reduction and the same
f32 Horner polynomials as the JAX package (``rodio_tpu/core/math.py:58-103``),
so the limiter's dB path lands within ~2 ulp of correctly rounded on every
device. The exponent-field tricks use ``Tensor.view(torch.int32)`` where JAX
uses ``bitcast_convert_type``, and ``torch.round`` where JAX uses
``jnp.rint`` (both round half to even). Every constant is rounded to f32
once, here, so a scalar operand means the same number whether an op
computes in f32 or promotes. The CUDA kernels carry the same constants
(``csrc/precise_math.cuh``).

Each mul and add is its own PyTorch op, so nothing is contracted into an
FMA: the plain versions of the kernels round exactly as the kernels do.

On f64 tensors (``set_float64``) the functions keep the JAX package's f64
contract as it is (rodio_tpu/core/math.py:56-175 under float64): the
polynomials run in f64 on the unrounded coefficients, but ``exp2_precise``
assembles 2^k from f32 exponent bits and ``log2_precise`` reads the
exponent and the mantissa of x rounded to f32, so its result carries an f32
mantissa (upstream rodio's ``64bit`` feature takes f64's own log2:
ROADMAP queue 3). ``duration_to_coefficient`` takes its f64 branch.
"""
from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from .types import nanos_to_secs_f32, np_float_dtype

#: log2(10) and log10(2), the reference's constants (src/math.rs).
LOG2_10 = 3.321928094887362
LOG10_2 = 0.30102999566398120


def _f32(v: float) -> float:
    return float(np.float32(v))


# Taylor coefficients of 2^r = sum (r ln2)^n / n!, |r| <= 0.5.
EXP2_C = tuple(
    _f32(np.float64(np.log(2.0)) ** n / _pymath.factorial(n)) for n in range(8)
)
# log2(m) = s*(K0 + K1 z + ... + K4 z^4), s = (m-1)/(m+1), z = s^2.
LOG2_K = tuple(_f32(2.0 / ((2 * n + 1) * np.log(2.0))) for n in range(5))
SQRT2_F32 = _f32(1.4142135623730951)
TINY = float(np.finfo(np.float32).tiny)  # Sample::MIN_POSITIVE
#: f32 scales of the dB conversions (src/math.rs:52-90)
DB_TO_LOG2 = _f32(0.05 * LOG2_10)
LOG2_TO_DB = _f32(LOG10_2 * 20.0)

# the same constants unrounded, for f64 tensors
EXP2_C64 = tuple(
    float(np.float64(np.log(2.0)) ** n / _pymath.factorial(n)) for n in range(8)
)
LOG2_K64 = tuple(float(2.0 / ((2 * n + 1) * np.log(2.0))) for n in range(5))
SQRT2_F64 = 1.4142135623730951
DB_TO_LOG2_F64 = 0.05 * LOG2_10
LOG2_TO_DB_F64 = LOG10_2 * 20.0


def db_to_log2_scale(dtype: torch.dtype) -> float:
    """The dB -> log2 scale as a tensor of ``dtype`` takes it."""
    return DB_TO_LOG2_F64 if dtype == torch.float64 else DB_TO_LOG2


def log2_to_db_scale(dtype: torch.dtype) -> float:
    """The log2 -> dB scale as a tensor of ``dtype`` takes it."""
    return LOG2_TO_DB_F64 if dtype == torch.float64 else LOG2_TO_DB


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of f32 ``x``, on any device.

    PyTorch's f32 ``sqrt`` on the CPU (MKL's) can be an ulp off, on a set
    of elements that is not the same from one process to the next; CUDA's
    and XLA's are correctly rounded, so off the CPU this is ``torch.sqrt``.
    On the CPU the root is taken in f64, rounded to f32 and corrected by an
    exact test: the midpoints between f32 neighbours have 25 bits, so their
    squares are exact in f64. An f64 ``x`` on the CPU is rooted by numpy,
    whose sqrt is correctly rounded (PyTorch's f64 one on the CPU is not
    either)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    if x.dtype == torch.float64:
        return torch.from_numpy(np.sqrt(x.detach().numpy()))
    s = torch.sqrt(x.double()).float()
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    dn = torch.nextafter(s, torch.zeros_like(s))
    xd, sd = x.double(), s.double()
    hi = (sd + up.double()) * 0.5
    lo = (sd + dn.double()) * 0.5
    return torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, dn, s))


def _pow2i(e: torch.Tensor) -> torch.Tensor:
    """2^e for int32 e, by assembling the exponent field."""
    e = torch.clamp(e, -126, 127)
    return ((e + 127) << 23).view(torch.float32)


def exp2_precise(x: torch.Tensor) -> torch.Tensor:
    """f32 2^x within ~2 ulp (f64: the JAX package's f64 contract)."""
    c = EXP2_C64 if x.dtype == torch.float64 else EXP2_C
    k = torch.round(x)
    r = x - k  # exact: |r| <= 0.5 (Sterbenz)
    p = r * c[7] + c[6]
    for i in range(5, -1, -1):
        p = p * r + c[i]
    # 2^k in two factors, so gradual underflow/overflow behave
    ki = torch.clamp(k, -300.0, 300.0).to(torch.int32)
    k1 = torch.div(ki, 2, rounding_mode="floor")
    k2 = ki - k1
    return p * _pow2i(k1).to(x.dtype) * _pow2i(k2).to(x.dtype)


def log2_precise(x: torch.Tensor) -> torch.Tensor:
    """f32 log2(x) within ~2 ulp for normal x > 0; -inf at x <= 0, and
    denormals flushed to 2^-126. On f64 x, the JAX package's f64 contract:
    the exponent and mantissa of x rounded to f32, the series in f64."""
    f64 = x.dtype == torch.float64
    k, sqrt2 = (LOG2_K64, SQRT2_F64) if f64 else (LOG2_K, SQRT2_F32)
    xs = torch.clamp(x, min=TINY)
    bits = xs.to(torch.float32).view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32).to(x.dtype)
    # renormalise m into [1/sqrt(2), sqrt(2)) so |log2(m)| <= 0.5
    big = m >= sqrt2
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int32)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    p = z * k[4] + k[3]
    for i in range(2, -1, -1):
        p = p * z + k[i]
    res = e.to(x.dtype) + s * p
    return torch.where(x > 0, res, torch.full_like(res, -float("inf")))


def db_to_linear(decibels: torch.Tensor) -> torch.Tensor:
    """dB -> linear amplitude via 2^(db*0.05*log2 10) (src/math.rs:52-56)."""
    return exp2_precise(decibels * db_to_log2_scale(decibels.dtype))


def linear_to_db(linear: torch.Tensor) -> torch.Tensor:
    """Linear amplitude -> dB via log2(x)*log10(2)*20 (src/math.rs:87-90)."""
    return log2_precise(linear) * log2_to_db_scale(linear.dtype)


def duration_to_coefficient(duration_secs: float, sample_rate: int,
                            *, nanos: int | None = None, dtype: torch.dtype = None):
    """Smoothing coefficient e^(-1/(secs*rate)) (src/math.rs:111-113), on
    the host in the sample type ``dtype`` (by default f32, or f64 under
    ``set_float64``). With ``nanos`` the f32 truncation of Rust's
    ``Duration::as_secs_f32`` is reproduced exactly."""
    dt = np_float_dtype(dtype)
    secs = dt(nanos_to_secs_f32(nanos) if nanos is not None else duration_secs)
    denom = dt(secs * dt(sample_rate))
    with np.errstate(divide="ignore"):
        return dt(np.exp(dt(-1.0) / denom)) if denom != 0 else dt(0.0)


def db_to_linear_host(decibels: float) -> float:
    """dB -> linear amplitude on the host in the sample type, as the JAX
    package's ``db_to_linear`` takes a host scalar (``amplify_decibel``)."""
    dt = np_float_dtype()
    return float(dt(2.0) ** dt(dt(decibels) * dt(dt(0.05) * dt(LOG2_10))))


def amplify_normalized_factor(value: float) -> float:
    """Perceptual volume curve of ``amplify_normalized``
    (src/source/mod.rs:332-349): exp(6.9077554*v)/1000, linearly tapered
    below v=0.1; input clamped to [0, 1]. On the host in the sample type."""
    dt = np_float_dtype()
    v = min(max(float(value), 0.0), 1.0)
    amplitude = dt(_pymath.exp(6.907_755_4 * v)) / dt(1000.0)
    if v < 0.1:
        amplitude = dt(amplitude * dt(v * 10.0))
    return float(dt(amplitude))


def nearest_multiple_of_two(n: int) -> int:
    """Round to the nearest power of two, preferring the smaller
    (src/math.rs:130-141); the device sinks' buffer size."""
    if n <= 1:
        return 1
    nxt = 1 << (n - 1).bit_length()
    prv = nxt >> 1
    return prv if n - prv <= nxt - n else nxt
