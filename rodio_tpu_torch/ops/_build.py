"""Build and bind the port's CUDA kernels.

``rodio_tpu_torch/csrc/*.cu`` compile with ``nvcc``, one process per source
started together, and link into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first
use, into ``build/rodio_tpu_torch/`` at the root of the checkout, and again
whenever a source or a flag changes (the library's name carries their hash).

Rounding is part of the contract: ``-fmad=false`` keeps every mul and add
rounded on its own, as the sequential scans of the JAX package and the plain
PyTorch versions round; no fast math, IEEE division, no flush to zero.

Each C entry point launches on the stream it is given and returns the
``cudaGetLastError()`` after its launch. :func:`launch` is the one way the
port calls one: it passes the current stream, raises through :func:`check`
on a nonzero code and counts the launch in ``utils.trace.counts`` under the
entry point's name. The entry points that return a value (the lanes,
scratch and group-size queries) are called directly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from ..utils.trace import count, span

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rodio_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
D = ctypes.c_double

#: argument types of each C entry point (all return a cudaError_t as int)
SIGNATURES = {
    # x, y, coef, x1, x2, y1, y2 (in), x1, x2, y1, y2 (out), L, T, stream
    "rt_biquad_df1": (P, P, P, P, P, P, P, P, P, P, P, I, LL, P),
    # x, y, integ0, peak0, integ_out, peak_out, relpow, attpow, scratch
    # (or null), T, P, att, rel, ca, cr, att^Lc, rel^Lc, threshold, knee_width,
    # inv_knee_8, log2->dB scale, dB->log2 scale, stream
    "rt_limiter_master": (P, P, P, P, P, P, P, P, P, I, I,
                          F, F, F, F, F, F, F, F, F, F, F, P),
    # pcm, F, L, left, wts, gains, coef, bq_in, bq_out, partial, out, n,
    # C, stream
    "rt_fused_resample_biquad_mix": (P, LL, I, P, P, P, P, P, P, P, P, I, I,
                                     P),
    # the same with a ring of R rows in place of F (K1's ring mode)
    "rt_fused_resample_biquad_mix_ring": (P, LL, I, P, P, P, P, P, P, P, P, I,
                                          I, P),
    # db, integ0, peak0, peak_out, carry_out, L, T, att, rel, 1-att, 1-rel,
    # stream
    "rt_limiter_env": (P, P, P, P, P, I, LL, F, F, F, F, P),
    # the same with every array and coefficient f64 (K5's f64 instance)
    "rt_limiter_env_f64": (P, P, P, P, P, I, LL, D, D, D, D, P),
    # the same with x and y bf16
    "rt_biquad_df1_bf16": (P, P, P, P, P, P, P, P, P, P, P, I, LL, P),
    # the same with every array f64 (K4's f64 instance)
    "rt_biquad_df1_f64": (P, P, P, P, P, P, P, P, P, P, P, I, LL, P),
    # rt_limiter_master's arguments with every array and scalar f64 (K3's
    # f64 instance)
    "rt_limiter_master_f64": (P, P, P, P, P, P, P, P, P, I, I,
                              D, D, D, D, D, D, D, D, D, D, D, P),
    # phase0, step, phases, phase_out, G, n, stream
    "rt_phase_accumulate": (P, P, P, P, I, LL, P),
    # the same on f64 phases and steps (its f64 instance)
    "rt_phase_accumulate_f64": (P, P, P, P, I, LL, P),
    # key, counter (or null), mode, n, lo, hi, grid, out, stream
    "rt_threefry": (P, P, I, LL, F, F, I, P, P),
    # the same with lo and hi f64 (its f64 instance: 64-bit draws, f64 out)
    "rt_threefry_f64": (P, P, I, LL, D, D, I, P, P),
    # x, integ0, peak0, y, carry_out, L, T, channels per group, att, rel,
    # 1-att, 1-rel, threshold, knee_width, inv_knee_8, log2->dB scale,
    # dB->log2 scale, stream
    "rt_limiter_stream": (P, P, P, P, P, I, LL, I, F, F, F, F, F, F, F, F, F,
                          P),
    # the same with every array and parameter f64 (K5's f64 instance)
    "rt_limiter_stream_f64": (P, P, P, P, P, I, LL, I, D, D, D, D, D, D, D, D,
                              D, P),
    # xs, d, params, peak0, sum0, gain0, gain_out, carry_out, L, T, stream
    "rt_agc": (P, P, P, P, P, P, P, P, I, LL, P),
    # the same with every array and the parameters f64 (K6's f64 instance)
    "rt_agc_f64": (P, P, P, P, P, P, P, P, I, LL, P),
    # a, b, c, init, params, y, L, T, op, stream
    "rt_first_order": (P, P, P, P, P, P, I, LL, I, P),
    # the same on f64 arrays and parameters (K7's f64 instance)
    "rt_first_order_f64": (P, P, P, P, P, P, I, LL, I, P),
    # x, v0, power table, y, scratch (or null), rows, M, P, stream
    "rt_blocked_max_affine": (P, P, P, P, P, I, I, I, P),
    # the same on f64 rows, carries and power table (K8's f64 instance)
    "rt_blocked_max_affine_f64": (P, P, P, P, P, I, I, I, P),
    # pcm, F, L, left, wts, gains, coef, bq_in, bq_out, agc_in, agc_out,
    # params, ring, ring_bf16, ring_row, partial, out, n, stream
    "rt_fused_resample_biquad_agc_mix": (P, LL, I, P, P, P, P, P, P, P, P, P,
                                         P, I, I, P, P, I, P),
    # the same with agc_group after ring_row
    "rt_fused_resample_biquad_agc_group_mix": (P, LL, I, P, P, P, P, P, P, P,
                                               P, P, P, I, I, I, P, P, I, P),
    # the same with packed (rel0f) after ring_row
    "rt_fused_resample_biquad_agc_rel0_mix": (P, LL, I, P, P, P, P, P, P, P,
                                              P, P, P, I, I, I, P, P, I, P),
    # the same with chunk and tiled (rel0c) after ring_row
    "rt_fused_resample_biquad_agc_blocked_mix": (P, LL, I, P, P, P, P, P, P,
                                                 P, P, P, P, I, I, I, I, P, P,
                                                 I, P),
    # x, R, L, rows per tile, depth, lanes per block, route (0 TMA, 1
    # cp.async), out, stream
    "rt_dma_ring": (P, LL, I, I, I, I, I, P, P),
    # x, float4 count, blocks, out, stream
    "rt_stream_max": (P, LL, I, P, P),
    # src, C, frames, lane stride, frame stride, rows, out, fails (int32
    # [3]), the card's SM count, stream
    "rt_pack_time_major": (P, I, LL, LL, LL, LL, P, P, I, P),
    # the same on doubles, without fails
    "rt_pack_time_major_f64": (P, I, LL, LL, LL, LL, P, I, P),
    # data, C, W, row stride, out, n, from, to, w0, w1, out_o, start, in_end,
    # drained, out_o', valid, drained' (the scalars 0-dim), stream
    "rt_resample_lerp": (P, I, LL, LL, P, I, I, I, P, P, P, P, P, P, P, P, P, P),
    # the same on doubles
    "rt_resample_lerp_f64": (P, I, LL, LL, P, I, I, I, P, P, P, P, P, P, P, P, P, P),
    # (x0, a, b), out, iterations, stream
    "rt_op_chain": (P, P, LL, P),
    # the same with x, a, b and out f64 (DMUL and DADD)
    "rt_op_chain_f64": (P, P, LL, P),
    # (g0, att, rel, max_gain, lo, hi), out (g, cycles), iterations, stream
    "rt_smooth_chain": (P, P, LL, P),
    # no arguments; returns K2's lanes per block (its partials' row count
    # is ceil(L / that)), not an error code
    "rt_fused_agc_block_lanes": (),
    # C; returns K1's lanes per block for C channels (its partials' row
    # count is ceil(L / that)), not an error code
    "rt_fused_block_lanes": (I,),
    # no arguments; returns the most channels a group of rt_limiter_stream
    # may have, not an error code
    "rt_limiter_stream_max_group": (),
    # ... and of rt_limiter_stream_f64
    "rt_limiter_stream_f64_max_group": (),
    # T, P; returns the floats of global scratch K3 needs (0: none, it
    # stages [2, T] in shared memory), not an error code
    "rt_limiter_master_scratch_floats": (I, I),
    # rows, M, P; returns the floats of global scratch K8 needs (0: none, it
    # stages each row in shared memory), not an error code
    "rt_blocked_max_affine_scratch_floats": (I, I, I),
    # T, P; the doubles of global scratch K3's f64 instance needs, not an
    # error code
    "rt_limiter_master_f64_scratch": (I, I),
    # rows, M, P; the doubles of global scratch K8's f64 instance needs, not
    # an error code
    "rt_blocked_max_affine_f64_scratch": (I, I, I),
}

_lib: Optional[ctypes.CDLL] = None
#: seconds the last nvcc compile in this process took (0.0 if none ran)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librodio_tpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands side by side; raise on the first that fails. Returns
    their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of the same sources exists: one
    nvcc per source, all started together, then one link."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        with span("rodio.setup.build"):
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                            for s, o in zip(srcs, objs)])
            log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                              "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print(log, flush=True)
    os.replace(tmp, out)
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        path = build(verbose)
        with span("rodio.setup.load"):
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err != 0:
        msg = load_library().rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, *args, device) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``device``; raise on a nonzero return, else count it in
    ``utils.trace.counts[name]``."""
    check(getattr(load_library(), name)(*args, stream_handle(device)), name)
    count(name)


def _typed_arg(name: str, t: torch.Tensor, dtype: torch.dtype,
               device: torch.device, shape) -> torch.Tensor:
    if t.dtype != dtype or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must be {dtype} {tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def f32_arg(name: str, t: torch.Tensor, device: torch.device,
            shape) -> torch.Tensor:
    """``t`` as a contiguous f32 tensor; raises unless it is f32 of
    ``shape`` on ``device``, which is all a kernel takes."""
    return _typed_arg(name, t, torch.float32, device, shape)


def refuse_f64(name: str, t: torch.Tensor, row: str) -> None:
    """Raise ``NotImplementedError`` for an f64 CUDA tensor given to a
    kernel that has no f64 instance (K1 and K2: ROADMAP F8): it neither
    casts to f32 nor falls back to its plain version. ``row`` names its
    item in ROADMAP."""
    if t.dtype == torch.float64 and t.device.type == "cuda":
        raise NotImplementedError(
            f"{name}: no float64 instance of this kernel ({row})")


def i64_arg(name: str, t: torch.Tensor, device: torch.device,
            shape) -> torch.Tensor:
    """``t`` as a contiguous int64 tensor, checked as :func:`f32_arg`."""
    return _typed_arg(name, t, torch.int64, device, shape)
