"""Content cases of the job set-up's content probe (``ops/probe.py``), shared
by its CPU test (``test_torch_probe.py``) and its card test
(``test_torch_cuda.py``). Imports no JAX.

Each case is a 2-D f32 array and the flags it must give:
(int16_grid_exact, int24_grid_exact, two_piece_exact).
"""
import functools

import numpy as np

SEED = 0x5EED
#: the smallest f32 subnormal, and one that bf16 holds exactly (0x00010000)
SUBNORMAL_MIN = np.float32(2.0**-149)
SUBNORMAL_BF16 = np.float32(2.0**-133)
#: the largest f32 (0x7F7FFFFF): its bf16 rounds up to inf, so r = -inf,
#: which bf16 keeps, and the two-piece flag holds for it
FLT_MAX = np.finfo(np.float32).max
#: elements that fail one flag and not the others where they can:
#: g16 alone (on the 24-bit grid, one bf16 piece), g16 and g24 (one bf16
#: piece), g16 and the two-piece flag (on the 24-bit grid, its bits 2^-1,
#: 2^-12 and 2^-23 more than two bf16 pieces hold)
FAIL_ONE = {
    "g16": (np.float32(2.0**-23), (False, True, True)),
    "g24": (np.float32(2.0**-24), (False, False, True)),
    "tp": (np.float32((2**22 + 2**11 + 1) / 2.0**23), (False, True, False)),
}


def corpus(streams: int = 4, frames: int = 6000, pad: int = 256) -> np.ndarray:
    """The benchmark's seeded 16-bit-grid corpus (``gpubench/signals.py``)
    at a small size, with zero padding as ``SamplesBuffer`` appends."""
    from gpubench import signals

    gen = signals.generator(SEED, "cpu")
    rng = np.random.default_rng([SEED, 0])
    pcm = signals.corpus(gen, rng, streams, 2, frames, 44100, "cpu").numpy()
    return np.concatenate([pcm, np.zeros((2 * streams, pad), np.float32)], axis=1)


def _with(base: np.ndarray, value, index) -> np.ndarray:
    out = base.copy()
    out.reshape(-1)[index] = value
    return out


@functools.lru_cache(maxsize=None)
def cases() -> dict:
    """name -> (f32 [rows, cols], expected flags)."""
    rng = np.random.default_rng(SEED)
    base = corpus()
    on24 = (rng.integers(-2**23, 2**23, size=(6, 700)) / 2.0**23).astype(np.float32)
    # 16 significant bits below the 24-bit grid: two bf16 pieces hold them
    pieces2 = (rng.integers(2**15, 2**16, size=(6, 700)) * rng.choice([-1, 1], (6, 700))
               * 2.0**-30).astype(np.float32)
    out = {
        "corpus16": (base, (True, True, True)),
        "grid24_only": (on24, (False, True, False)),
        "two_piece_only": (pieces2, (False, False, True)),
        "off_grid": ((rng.standard_normal((6, 700)) * 0.3).astype(np.float32),
                     (False, False, False)),
        "minus_one": (_with(base, -1.0, 17), (True, True, True)),
        "plus_one": (_with(base, 1.0, 17), (False, False, True)),
        "nan": (_with(base, np.nan, 1001), (False, False, False)),
        "plus_inf": (_with(base, np.inf, 1001), (False, False, False)),
        "minus_inf": (_with(base, -np.inf, 1001), (False, False, False)),
        "minus_zero": (_with(np.zeros_like(base), -0.0, slice(None, None, 3)),
                       (True, True, True)),
        "subnormal_min": (_with(base, SUBNORMAL_MIN, 5), (False, False, False)),
        "subnormal_bf16": (_with(base, SUBNORMAL_BF16, 5), (False, False, True)),
        "near_flt_max": (_with(base, [FLT_MAX, -FLT_MAX], [3, 9]), (False, False, True)),
        "pad_zeros": (np.zeros((8, 1000), np.float32), (True, True, True)),
    }
    for flag, (value, want) in FAIL_ONE.items():
        out[f"fail_{flag}_first"] = (_with(base, value, 0), want)
        out[f"fail_{flag}_last"] = (_with(base, value, -1), want)
    return out


#: cases whose flags the JAX package's probe is not held to on the CPU
#: (XLA's CPU may flush subnormals; the port follows torch)
SUBNORMAL_CASES = ("subnormal_min", "subnormal_bf16")
NAMES = ("corpus16", "grid24_only", "two_piece_only", "off_grid", "minus_one",
         "plus_one", "nan", "plus_inf", "minus_inf", "minus_zero", "subnormal_min",
         "subnormal_bf16", "near_flt_max", "pad_zeros") + tuple(
    f"fail_{flag}_{where}" for flag in FAIL_ONE for where in ("first", "last"))


def case(name: str):
    """(a fresh copy of the case's array, its expected flags)."""
    arr, want = cases()[name]
    return arr.copy(), want
