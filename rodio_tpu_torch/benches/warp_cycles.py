"""Where the cycles of the port's tile pipelines go, warp by warp, on one
CUDA card; and the kernels' times, for an A/B of two versions.

    python -m rodio_tpu_torch.benches.warp_cycles [--csrc DIR] [--kernels K2g,K5]
        [--out FILE]

K1 (``csrc/fused.cu``), K2, K2r, K2b and K2g (``csrc/fused_agc.cu``,
``fused_agc_blocked.cu``, ``fused_agc_group.cu``), K4 (``csrc/biquad.cu``),
K5 (``csrc/limiter_env.cu``), K6 (``csrc/agc.cu``) and K7
(``csrc/first_order.cu``) run every warp's share of a tile between two
barriers, so the slowest warp sets each iteration's length. This copies
those sources into ``build/warp_cycles/``, adds a ``clock64()`` read at the
start of each iteration and another before its barrier, builds them,
``limiter_block.cu`` (K3, not instrumented), ``bma.cu`` (K8, its phases
timed where it marks them with ``RT_PHASE``) and ``dma_roofline.cu`` (K9
and the contiguous stream, timed only) with the library's nvcc flags
into a shared library of their own, and runs K1 at
the main path's shape (512 stereo streams, one block of 12800 frames at
44.1 -> 48 kHz), each K2 plan at path E's (the same, bf16 ring; K2g at AG =
16, path D's, and 128), K3 at the master bus's ([2, 12800], P = 128), K4 at
the unfused chain's and path C's ([1024, 12800]) and path B's ([2, 4096]),
K5 at path C's (``limiter_stream``, the Limit node's per-stream pass, on
[1024, 12800] in stereo groups, and ``limiter_env``), K6 at path C's ([512,
25600]), K7's ``agc_gain`` at path B's ([1, 8192], and [1, 512] with
``group=8``), K8 at path B's ([1, 8192], P = 128) and K9 at K1's block
([11761, 1024] f32, L2-cold: the calls rotate through copies of it; its TMA
ring and K1's cp.async route at K1's geometry, or a version before the TMA
ring at its own, and ``stream_max``: ``--kernels K9,stream_max``). It
first prints the card's one-thread latencies of a dependent FMUL/FADD and of a smoother step
(``benches/op_latency.py``), the floors of the chains. For each tile
pipeline it prints the card's first block's busy cycles per iteration by
warp (lane 0's view) beside the iteration's whole length (kernel cycles
over iterations) and every block's (the least, the median and the most:
the slowest block sets the kernel's time), K8's block 0 cycles in each of
its phases (the loads, pass 1, the combine, pass 2, the stores), and for
every kernel its time by CUDA events (the mean of 20 calls after one; K3, K7
and K8 of 50; K4 at [2, 4096] of 50) and the mean of as many calls
captured in one CUDA graph (the card's time without the host's between
launches: K3, K8 and K4 at [2, 4096] run shorter than their calls take on
the host), and
K1's mix against its plain version at gains of unit scale (no 1/S), where
the mix is largest against the rounding of its sum over blocks. The reads
cost a few cycles an iteration; the library itself is not changed.
``--kernels`` runs only those kernels' cases and builds only their sources
(the other entry points are the library's). ``--csrc`` takes the sources
from another directory (another version of the
kernels, for an A/B in one call): a source whose tile loop is not where
this expects it is built as it is and timed only, and an entry point it
lacks is taken from the library; a version without ``rt_limiter_stream``
times the Limit node's pass as that version ran it (the gain computer and
the coupling in torch around ``limiter_env``). Without a card it fails.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..conversions.resample import lerp_weights, output_positions
from ..core.math import DB_TO_LOG2, LOG2_TO_DB
from ..effects.blt import blt_coefficients
from ..effects.limit import Limit, LimitSettings
from ..ops import _build, cuda_scan, fused, limiter_block
from . import dma_roofline, op_latency
from .dma_roofline import graph_ms
from ..sources.generators import SamplesBuffer

OUT_ROOT = _build.BUILD_DIR.parent / "warp_cycles"
SOURCES = ("fused_agc.cu", "fused_agc_blocked.cu", "fused_agc_group.cu", "fused.cu",
           "agc.cu", "first_order.cu", "limiter_env.cu", "biquad.cu")
TIMED = ("limiter_block.cu", "bma.cu", "dma_roofline.cu")  # built as they are, timed only
PHASED = ("bma.cu",)  # ... but for the phases marked with RT_PHASE(k)
PHASES = ("loads", "pass 1", "combine", "pass 2", "stores")
#: the source of each kernel's cases (``--kernels`` builds only these)
KERNEL_SOURCES = {"K1": "fused.cu", "K2": "fused_agc.cu", "K2r": "fused_agc.cu",
                  "K2b": "fused_agc_blocked.cu", "K2g": "fused_agc_group.cu",
                  "K3": "limiter_block.cu", "K4": "biquad.cu", "K5": "limiter_env.cu",
                  "K6": "agc.cu", "K7": "first_order.cu", "K8": "bma.cu",
                  "K9": "dma_roofline.cu", "stream_max": "dma_roofline.cu"}
WARPS = 16  # per-warp totals for up to 16 warps, then the iterations and the
SLOTS = WARPS + 2  # kernel's cycles
BLOCKS = 1024  # each block's own cycles, for the first 1024 blocks

_LOOP = re.compile(r"( *)for \(int it = 0; it < ([^;]+); \+\+it\) \{\n")
# the tile loop's barrier and closing brace
_END = re.compile(r"    (?:__syncthreads|pair_sync)\(\);\n  \}\n")
_INCLUDE = re.compile(r'#include "[^"]+"\n')


def instrument(src: str, tag: str):
    """The source with each tile loop's warps timed (block 0, lane 0), or
    None where its tile loop is not where this expects it."""
    m = _LOOP.search(src)
    ends = _END.findall(src)
    includes = list(_INCLUDE.finditer(src))
    if m is None or len(ends) != 1 or not includes:
        return None
    iters, end = m.group(2), ends[0]
    src = src.replace(
        m.group(0),
        f"{m.group(1)}long long busy_ = 0;\n{m.group(1)}const long long start_ = clock64();\n"
        f"{m.group(0)}    const long long t0_ = clock64();\n", 1)
    src = src.replace(end, "    busy_ += clock64() - t0_;\n" + end + (
        "  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)\n"
        "    g_warp_cycles[threadIdx.x >> 5] = busy_;\n"
        "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
        f"    g_warp_cycles[{WARPS}] = {iters};\n"
        f"    g_warp_cycles[{WARPS + 1}] = clock64() - start_;\n  }}\n"
        f"  if (threadIdx.x == 0 && blockIdx.x < {BLOCKS})\n"
        "    g_block_cycles[blockIdx.x] = clock64() - start_;\n"))
    at = includes[-1].end()  # after the last include
    return src[:at] + (
        f"static __device__ long long g_warp_cycles[{SLOTS}];\n"
        f"static __device__ long long g_block_cycles[{BLOCKS}];\n"
        f"extern \"C\" int rt_warp_cycles_{tag}(long long* out) {{\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_warp_cycles,\n"
        "                                   sizeof(g_warp_cycles));\n}\n"
        f"extern \"C\" int rt_block_cycles_{tag}(long long* out) {{\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_block_cycles,\n"
        "                                   sizeof(g_block_cycles));\n}\n"
        f"extern \"C\" int rt_block_cycles_clear_{tag}() {{\n"
        "  void* p = nullptr;\n"
        "  const cudaError_t e = cudaGetSymbolAddress(&p, g_block_cycles);\n"
        "  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_block_cycles)));\n"
        "}\n") + src[at:]


def instrument_phases(src: str, tag: str):
    """The source with its RT_PHASE(k) marks reading ``clock64()`` (block
    0, thread 0) into an array of its own, and the read-back entry point;
    None where it marks no phase."""
    if "RT_PHASE(" not in src:
        return None
    n = len(PHASES) + 1
    return (f"static __device__ long long g_phase_cycles[{n}];\n"
            "#define RT_PHASE(k) \\\n"
            "  if (blockIdx.x == 0 && threadIdx.x == 0) g_phase_cycles[k] = clock64()\n"
            + src +
            f"extern \"C\" int rt_phase_cycles_{tag}(long long* out) {{\n"
            "  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles,\n"
            "                                   sizeof(g_phase_cycles));\n}\n")


def k9_before_tma(src: str) -> bool:
    """Whether a version of ``dma_roofline.cu`` predates K9's TMA ring (32
    lanes a block, the cp.async route alone, no lanes or route argument)."""
    return "CUtensorMap" not in src


def build(csrc: Path, names=SOURCES + TIMED):
    """The instrumented kernels of ``csrc``, built once per version of
    their sources (``names``: those the cases need), the names of the
    sources that were instrumented, and the entry points taken from the
    library (the version lacks them, or its sources were not built)."""
    texts = {name: (csrc / name).read_text() for name in names}
    timed = {name: instrument(texts[name], name[:-3]) for name in SOURCES if name in texts}
    timed.update({name: instrument_phases(texts[name], name[:-3])
                  for name in PHASED if name in texts})
    texts.update({k: v for k, v in timed.items() if v is not None})
    instrumented = tuple(k for k, v in timed.items() if v is not None)
    h = hashlib.sha256(" ".join([*_build.NVCC_FLAGS, *sorted(texts)]).encode())
    for name in sorted(p.name for p in csrc.glob("*.cu*")):
        h.update(texts.get(name, (csrc / name).read_text()).encode())
    out_dir = OUT_ROOT / h.hexdigest()[:16]
    so = out_dir / "libwarp_cycles.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, text in texts.items():
            (out_dir / name).write_text(text)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_build._nvcc(), *flags, "-I", str(csrc), "-shared",
                        "-o", str(so), *(str(out_dir / n) for n in texts)],
                       check=True)
    lib = ctypes.CDLL(str(so))
    main_lib = _build.load_library()
    borrowed = set()
    for name, argtypes in _build.SIGNATURES.items():
        if not name.startswith(("rt_fused", "rt_limiter", "rt_agc", "rt_biquad",
                                "rt_first_order", "rt_blocked_max_affine", "rt_dma_ring",
                                "rt_stream_max")):
            continue
        try:
            fn = getattr(lib, name)
        except AttributeError:  # an older version: the library's own rule
            setattr(lib, name, getattr(main_lib, name))
            borrowed.add(name)
            continue
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    for name in instrumented:
        if name in PHASED:
            fn = getattr(lib, f"rt_phase_cycles_{name[:-3]}")
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            continue
        for what in ("warp", "block"):
            fn = getattr(lib, f"rt_{what}_cycles_{name[:-3]}")
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        fn = getattr(lib, f"rt_block_cycles_clear_{name[:-3]}")
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if k9_before_tma((csrc / "dma_roofline.cu").read_text()):  # x, R, L, tr, depth, out, stream
        lib.rt_dma_ring.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.rt_error_string = main_lib.rt_error_string
    return lib, instrumented, borrowed


def _time_ms(call, reps: int) -> float:
    """Mean ms per call by CUDA events, after one call."""
    call()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        call()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=str(_build.CSRC),
                    help="the kernels' sources (default: the package's)")
    ap.add_argument("--kernels", default=None,
                    help="run only these kernels' cases, e.g. K2g,K5 (default: all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("warp_cycles: needs a CUDA device")
    dev = torch.device("cuda", 0)
    names = SOURCES + TIMED
    if args.kernels:
        names = tuple(sorted({KERNEL_SOURCES[k] for k in args.kernels.split(",")}))
    lib, instrumented, borrowed = build(Path(args.csrc), names)
    S, T, fr, to = 512, 12800, 147, 160
    L = 2 * S
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    pcm = f32(rng.standard_normal(((T // to + 8) * fr, L)) * 0.1)
    left, phase = output_positions(4 * to, T, fr, to, dev)
    wts = f32(np.stack(lerp_weights(fr, to), axis=1))[phase]
    params = (0.9999948, 0.0, 1.0, 7.0, 0.0, 1.0 / 8192)
    kw = dict(gains=f32(np.repeat(rng.uniform(0.5, 1.5, S) / S, 2)),
              coeffs=f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple()),
              bq=f32(np.zeros((4, L))))
    ring = f32(rng.uniform(0.0, 0.01, (4096, L))).to(torch.bfloat16)
    agc = torch.stack([ring.float().reshape(4096, S, 2)[:, :, 1].sum(0),
                       torch.zeros(S, device=dev), torch.ones(S, device=dev)])

    def agc_call(plan, ag):
        ring_c = ring if not ag else f32(rng.uniform(0, 0.16, (4096 // ag, S))).to(
            torch.bfloat16)
        p = f32(params if plan != "serial" else (params[0], 0.9995834) + params[2:])
        return lambda: fused.fused_resample_biquad_agc_mix(
            pcm, left, wts, agc=agc, agc_params=p, ring=ring_c, agc_plan=plan,
            agc_group=ag, ring_row=640 // ag if ag else 640, step_frames=2 * to, **kw)

    # K3 at the master bus's shape (LimitSettings() at 48 kHz), through the
    # library's entry point with a scratch that any version's layout fits
    # (3 rows of Lc x 2P floats)
    P3, Lc = 128, T // 128
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32), device="cpu"),
                LimitSettings())
    att, rel = lim.attack, lim.release
    xm = f32(rng.standard_normal((2, T)) * 0.7)
    y3, c3 = torch.empty_like(xm), torch.empty((2, 2), device=dev)
    i0, p0 = f32([0.5, 1.0]), f32([0.8, 0.3])
    relpow, attpow = limiter_block._power_tables(att, rel, Lc, dev)
    scratch = torch.empty(3 * Lc * 2 * P3, device=dev)

    def k3_call():
        _build.check(lib.rt_limiter_master(
            xm.data_ptr(), y3.data_ptr(), i0.data_ptr(), p0.data_ptr(), c3[0].data_ptr(),
            c3[1].data_ptr(), relpow.data_ptr(), attpow.data_ptr(), scratch.data_ptr(),
            T, P3, att, rel, 1.0 - att, 1.0 - rel, att ** Lc, rel ** Lc, lim.threshold,
            lim.knee_width, lim.inv_knee_8, LOG2_TO_DB, DB_TO_LOG2,
            _build.stream_handle(dev)), "rt_limiter_master")

    # K6 at path C's shape: |x| of 512 streams' 25600 interleaved samples,
    # d = sq - old with the window's squares 4096 samples back; K7's
    # agc_gain at path B's ([1, 8192]; [1, 512] with group=8)
    xs6 = f32(np.abs(rng.standard_normal((S, 2 * T)) * 0.05))
    d6 = xs6 * xs6 - (xs6 * xs6).roll(4096, 1)
    c6 = tuple(f32(rng.uniform(lo, hi, S)) for lo, hi in ((0, 0.2), (1, 50), (1, 3)))
    p6 = f32((0.9999948, 0.9995834) + params[2:])
    p7, g7 = p6[[0, 1, 3]], c6[2][:1]

    def k7_call(n):
        des = f32(rng.uniform(0.5, 7.0, (1, n)))
        return lambda: cuda_scan.first_order(des, des, g7, op="agc_gain", params=p7)

    # K5 at path C's shape: Limit(streams=512)'s pass over [1024, 12800]
    # (a version without limiter_stream: its gain computer and coupling in
    # torch around limiter_env, as the node ran it then), and limiter_env
    x5 = f32(rng.uniform(-1, 1, (L, T)) * rng.choice([0.05, 0.6, 2.5], (L, 1)))
    i5, q5 = f32(rng.uniform(0, 6, L)), f32(rng.uniform(0, 6, L))
    db5 = limiter_block.limiter_gain_db(x5, lim.threshold, lim.knee_width, lim.inv_knee_8)
    kw5 = dict(att=att, rel=rel, threshold=lim.threshold, knee_width=lim.knee_width,
               inv_knee_8=lim.inv_knee_8, group_channels=2)

    def k5_stream():
        if "rt_limiter_stream" not in borrowed:
            return cuda_scan.limiter_stream(x5, i5, q5, **kw5)
        db = limiter_block.limiter_gain_db(x5, lim.threshold, lim.knee_width,
                                           lim.inv_knee_8)
        peak, _ = cuda_scan.limiter_env(db, i5, q5, att=att, rel=rel)
        return cuda_scan.limiter_couple_gain(x5, peak, q5, 2)

    # K8, the AGC's peak detector, at path B's shape, its coefficient on the
    # card (as the node passes it), through the library's entry point with a
    # scratch that any version's layout fits (2 rows of Lc x P floats)
    P8, M8 = 128, 8192
    x8 = f32(np.abs(rng.standard_normal((1, M8)) * 0.3))
    v8, y8 = f32([0.4]), torch.empty_like(x8)
    pw8 = limiter_block.bma_power_table(p6[1], M8 // P8, dev)
    scratch8 = torch.empty(2 * M8, device=dev)

    def k8_call():
        _build.check(lib.rt_blocked_max_affine(
            x8.data_ptr(), v8.data_ptr(), pw8.data_ptr(), y8.data_ptr(),
            scratch8.data_ptr(), 1, M8, P8, _build.stream_handle(dev)),
            "rt_blocked_max_affine")

    # K4 at the unfused chain's and path C's shape, [1024, 12800], and at
    # path B's, [2, 4096] (one block of 2 lanes)
    coef4 = kw["coeffs"]

    def k4_call(lanes, steps):
        x4 = f32(rng.standard_normal((lanes, steps)) * 0.1)
        st4 = tuple(f32(rng.standard_normal(lanes) * 0.01) for _ in range(4))
        return lambda: cuda_scan.biquad_df1(x4, coef4, st4)

    # K9 at K1's block ([11761, 1024] f32), L2-cold: each call reads the next
    # of the rotating copies of the buffer (a graph captures each call with
    # its own), through the version's entry points: its TMA ring at K1's
    # geometry and depth K9_DEPTH and K1's cp.async route at depth 3; a
    # version before the TMA ring (32 lanes a block, cp.async only) at its
    # own geometry (tiles of 59 rows, depth 4) and at K1's tile and depth.
    # Then the contiguous stream at the version's own grid
    rows9, tr9 = dma_roofline.k1_stream(T, fr, to)
    xs9 = dma_roofline.cold_copies(f32(rng.standard_normal((rows9, L))))
    out9 = torch.empty(L, device=dev)
    old9 = k9_before_tma((Path(args.csrc) / "dma_roofline.cu").read_text())

    def k9_call(route, tr, depth):
        def run(x):
            geo = ((tr, depth) if old9 else
                   (tr, depth, dma_roofline.K1_LANES, dma_roofline.ROUTES[route]))
            _build.check(lib.rt_dma_ring(x.data_ptr(), rows9, L, *geo, out9.data_ptr(),
                                         _build.stream_handle(dev)), "rt_dma_ring")
        return dma_roofline.rotating(run, xs9)

    blocks9 = (-(-rows9 * L // 4 // 1024) if old9 else dma_roofline.stream_blocks(xs9[0]))
    out9s = torch.empty(blocks9, device=dev)

    def k9_stream(x):
        _build.check(lib.rt_stream_max(x.data_ptr(), x.numel() // 4, blocks9,
                                       out9s.data_ptr(), _build.stream_handle(dev)),
                     "rt_stream_max")

    k9_cases = ([("K9", "32 lanes, cp.async, tiles of 59, depth 4 (its own)",
                  k9_call("cp.async", 59, 4), None, 20),
                 ("K9", f"32 lanes, cp.async, tiles of {tr9}, depth 3",
                  k9_call("cp.async", tr9, 3), None, 20)] if old9 else
                [("K9", f"TMA ring, 8 lanes, tiles of {tr9}, depth {dma_roofline.K9_DEPTH}",
                  k9_call("tma", tr9, dma_roofline.K9_DEPTH), None, 20),
                 ("K9", f"K1's cp.async route, 8 lanes, tiles of {tr9}, depth 3",
                  k9_call("cp.async", tr9, dma_roofline.K1_DEPTH), None, 20)])
    k9_cases.append(("stream_max", f"[{rows9}, {L}] in {blocks9} chunks",
                     dma_roofline.rotating(k9_stream, xs9), None, 20))

    # (kernel, label, call, instrumented source or None, reps)
    cases = [("K1", "C=2", lambda: fused.fused_resample_biquad_mix(
                  pcm, left, wts, channels=2, **kw), "fused", 20),
             ("K2", "serial", agc_call("serial", 0), "fused_agc", 20),
             ("K2r", "rel0f", agc_call("rel0f", 0), "fused_agc", 20),
             ("K2r", "rel0", agc_call("rel0", 0), "fused_agc", 20),
             ("K2b", "rel0b16", agc_call("rel0b16", 0), "fused_agc_blocked", 20),
             ("K2b", "rel0c16", agc_call("rel0c16", 0), "fused_agc_blocked", 20),
             ("K2g", "agc_group=16", agc_call("serial", 16), "fused_agc_group", 20),
             ("K3", f"[2, {T}] P={P3}", k3_call, None, 50),
             ("K6", f"[{S}, {2 * T}]", lambda: cuda_scan.agc(xs6, d6, *c6, p6), "agc", 20),
             ("K7", "agc_gain [1, 8192]", k7_call(8192), "first_order", 50),
             ("K7", "agc_gain [1, 512]", k7_call(512), "first_order", 50),
             ("K5", f"limiter_stream [{L}, {T}] stereo groups", k5_stream, "limiter_env",
              20),
             ("K5", f"limiter_env [{L}, {T}]",
              lambda: cuda_scan.limiter_env(db5, i5, q5, att=att, rel=rel), "limiter_env", 20),
             ("K2g", "agc_group=128", agc_call("serial", 128), "fused_agc_group", 20),
             ("K8", f"[1, {M8}] P={P8}", k8_call, "bma", 50),
             ("K4", f"[{L}, {T}]", k4_call(L, T), "biquad", 20),
             ("K4", "[2, 4096]", k4_call(2, 4096), "biquad", 50)] + k9_cases
    if args.kernels:
        cases = [c for c in cases if c[0] in args.kernels.split(",")]
    # K1 at gains of unit scale, n = 1280
    kw_unit = dict(kw, gains=f32(rng.uniform(0.1, 1.0, L)), channels=2)
    left_u, phase_u = output_positions(4 * to, 1280, fr, to, dev)
    wts_u = f32(np.stack(lerp_weights(fr, to), axis=1))[phase_u]
    main_lib = _build.load_library()
    res = {"device": torch.cuda.get_device_name(0), "csrc": args.csrc, "cases": []}
    # the chains' own latencies on one thread (the card's, whatever --csrc)
    sec_op = op_latency.seconds_per_op(dev)
    sec_sm, cyc_sm = op_latency.smooth_step(dev)
    res.update(op_ns=sec_op * 1e9, smooth_step_ns=sec_sm * 1e9, smooth_step_cycles=cyc_sm)
    print(f"one thread: a dependent FMUL/FADD {sec_op * 1e9:.4f} ns; a smoother step "
          f"(smooth_gain) {sec_sm * 1e9:.4f} ns, {cyc_sm:.2f} SM cycles", flush=True)
    try:
        _build._lib = lib  # the wrappers launch the instrumented copies
        for kid, label, call, src, reps in cases:
            if (src is not None and f"{src}.cu" in instrumented
                    and f"{src}.cu" not in PHASED):  # this case's blocks only
                _build.check(getattr(lib, f"rt_block_cycles_clear_{src}")(), "cudaMemset")
            row = {"kernel": kid, "case": label, "ms": _time_ms(call, reps)}
            line = f"{kid} ({label}): {row['ms']:.4f} ms"
            if src is not None and f"{src}.cu" in instrumented and f"{src}.cu" in PHASED:
                cyc = np.zeros(len(PHASES) + 1, np.int64)
                _build.check(getattr(lib, f"rt_phase_cycles_{src}")(cyc.ctypes.data),
                             "cudaMemcpyFromSymbol")
                row["phase_cycles"] = dict(zip(PHASES, np.diff(cyc).tolist()))
                line += ", block 0's cycles by phase: " + ", ".join(
                    f"{k} {v}" for k, v in row["phase_cycles"].items())
            elif src is not None and f"{src}.cu" in instrumented:
                cyc = np.zeros(SLOTS, np.int64)
                _build.check(getattr(lib, f"rt_warp_cycles_{src}")(cyc.ctypes.data),
                             "cudaMemcpyFromSymbol")
                blk = np.zeros(BLOCKS, np.int64)
                _build.check(getattr(lib, f"rt_block_cycles_{src}")(blk.ctypes.data),
                             "cudaMemcpyFromSymbol")
                blk = blk[blk > 0]
                iters = int(cyc[WARPS])
                row.update(iterations=iters, cycles_per_iteration=cyc[WARPS + 1] / iters,
                           warp_busy_per_iteration={w: cyc[w] / iters for w in range(WARPS)
                                                    if cyc[w]},
                           block_cycles_per_iteration={
                               "min": blk.min() / iters, "median": np.median(blk) / iters,
                               "max": blk.max() / iters})
                line += (f", {iters} iterations of {row['cycles_per_iteration']:.0f} "
                         "cycles (blocks: min {min:.0f}, median {median:.0f}, max {max:.0f}); "
                         "busy cycles per iteration by warp: ".format(
                             **row["block_cycles_per_iteration"]) + ", ".join(
                             f"{w}: {v:.0f}"
                             for w, v in row["warp_busy_per_iteration"].items()))
            row["graph_ms"] = graph_ms(call, reps)
            line += f"; in a CUDA graph {row['graph_ms']:.4f} ms"
            res["cases"].append(row)
            print(line, flush=True)
        mk, _ = fused.fused_resample_biquad_mix(pcm, left_u, wts_u, **kw_unit)
        mp, _ = fused.fused_resample_biquad_mix_plain(pcm, left_u, wts_u, **kw_unit)
        res["k1_unit_gain_max_abs_err"] = (mk - mp).abs().max().item()
        print(f"K1 at gains of unit scale (n=1280): mix max|d| "
              f"{res['k1_unit_gain_max_abs_err']:.3e} from the plain version, "
              f"peak |mix| {mp.abs().max().item():.3f}", flush=True)
    finally:
        _build._lib = main_lib
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
