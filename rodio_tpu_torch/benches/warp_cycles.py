"""Where the cycles of K2's tile pipeline go, warp by warp, on one CUDA card.

    python -m rodio_tpu_torch.benches.warp_cycles [--csrc DIR] [--out FILE]

K2, K2r, K2b and K2g (``csrc/fused_agc.cu``, ``fused_agc_blocked.cu``,
``fused_agc_group.cu``) run every warp's share of a tile between two
barriers, so the slowest warp sets each iteration's length. This copies
the three sources into ``build/warp_cycles/``, adds a ``clock64()`` read at
the start of each iteration and another before its barrier, builds them
with the library's nvcc flags into a shared library of their own, runs each
plan once at path E's shape (512 stereo streams, one block of 12800 frames
at 44.1 -> 48 kHz, bf16 ring) and prints, for the card's first block of
lanes, each warp's busy cycles per iteration (lane 0's view) beside the
iteration's whole length (kernel cycles over iterations), and the kernel's
time by CUDA events (the mean of 20 calls after one). The reads cost a few
cycles an iteration; the library itself is not changed. ``--csrc`` takes
the sources from another directory (another version of the kernels, for an
A/B in one process). Without a card it fails.
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
from ..effects.blt import blt_coefficients
from ..ops import _build, fused

OUT_ROOT = _build.BUILD_DIR.parent / "warp_cycles"
SOURCES = ("fused_agc.cu", "fused_agc_blocked.cu", "fused_agc_group.cu")
SLOTS = 16  # per-warp totals; slot 14 the iterations, 15 the kernel's cycles

_LOOP = re.compile(r"( *)for \(int it = 0; it < ([^;]+); \+\+it\) \{\n")
_END = "    __syncthreads();\n  }\n"
_CARRIES = "  if (warp == 0 && wl < nl) {\n    bq_out[0 * L"


def instrument(src: str, tag: str) -> str:
    """The source with each tile loop's warps timed (block 0, lane 0)."""
    m = _LOOP.search(src)
    if m is None or src.count(_END) != 1 or src.count(_CARRIES) != 1:
        raise RuntimeError(f"{tag}: the tile loop is not where it was")
    iters = m.group(2)
    src = src.replace(
        m.group(0),
        f"{m.group(1)}long long busy_ = 0;\n{m.group(1)}const long long start_ = clock64();\n"
        f"{m.group(0)}    const long long t0_ = clock64();\n", 1)
    src = src.replace(_END, "    busy_ += clock64() - t0_;\n" + _END)
    src = src.replace(
        _CARRIES,
        "  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)\n"
        "    g_warp_cycles[threadIdx.x >> 5] = busy_;\n"
        "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
        f"    g_warp_cycles[14] = {iters};\n"
        "    g_warp_cycles[15] = clock64() - start_;\n  }\n" + _CARRIES)
    head = '#include "fused_agc_common.cuh"\n'
    return src.replace(head, head + (
        f"static __device__ long long g_warp_cycles[{SLOTS}];\n"
        f"extern \"C\" int rt_warp_cycles_{tag}(long long* out) {{\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_warp_cycles,\n"
        "                                   sizeof(g_warp_cycles));\n}\n"), 1)


def build(csrc: Path) -> ctypes.CDLL:
    """The instrumented kernels of ``csrc``, built once per version of
    their sources."""
    texts = {name: instrument((csrc / name).read_text(), name[:-3])
             for name in SOURCES}
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
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
                        "-o", str(so), *(str(out_dir / n) for n in SOURCES)],
                       check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("rt_fused_resample_biquad_agc") or name == "rt_fused_agc_block_lanes":
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = ctypes.c_int
    for name in SOURCES:
        fn = getattr(lib, f"rt_warp_cycles_{name[:-3]}")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.rt_error_string = _build.load_library().rt_error_string
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=str(_build.CSRC),
                    help="the kernels' sources (default: the package's)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("warp_cycles: needs a CUDA device")
    dev = torch.device("cuda", 0)
    lib = build(Path(args.csrc))
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
              bq=f32(np.zeros((4, L))), ring_row=640, step_frames=2 * to)
    ring = f32(rng.uniform(0.0, 0.01, (4096, L))).to(torch.bfloat16)
    agc = torch.stack([ring.float().reshape(4096, S, 2)[:, :, 1].sum(0),
                       torch.zeros(S, device=dev), torch.ones(S, device=dev)])
    cases = (("K2", "serial", 0, "fused_agc"), ("K2r", "rel0f", 0, "fused_agc"),
             ("K2b", "rel0b16", 0, "fused_agc_blocked"),
             ("K2b", "rel0c16", 0, "fused_agc_blocked"),
             ("K2g", "serial", 16, "fused_agc_group"))
    main_lib = _build.load_library()
    res = {"device": torch.cuda.get_device_name(0), "csrc": args.csrc, "cases": []}
    try:
        _build._lib = lib  # the wrappers launch the instrumented copies
        for kid, plan, ag, src in cases:
            ring_c = ring if not ag else f32(rng.uniform(0, 0.16, (4096 // ag, S))).to(
                torch.bfloat16)
            p = f32(params if plan != "serial" else (params[0], 0.9995834) + params[2:])
            call = lambda: fused.fused_resample_biquad_agc_mix(  # noqa: E731
                pcm, left, wts, agc=agc, agc_params=p, ring=ring_c, agc_plan=plan,
                agc_group=ag, **{**kw, "ring_row": 640 // ag if ag else 640})
            call()
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            for _ in range(20):
                call()
            e.record()
            torch.cuda.synchronize()
            cyc = np.zeros(SLOTS, np.int64)
            _build.check(getattr(lib, f"rt_warp_cycles_{src}")(cyc.ctypes.data),
                         "cudaMemcpyFromSymbol")
            iters = int(cyc[14])
            row = {"kernel": kid, "plan": plan, "agc_group": ag, "ms": s.elapsed_time(e) / 20,
                   "iterations": iters, "cycles_per_iteration": cyc[15] / iters,
                   "warp_busy_per_iteration": {w: cyc[w] / iters for w in range(12)
                                               if cyc[w]}}
            res["cases"].append(row)
            print(f"{kid} ({plan}{f', agc_group={ag}' if ag else ''}): {row['ms']:.4f} ms, "
                  f"{iters} iterations of {row['cycles_per_iteration']:.0f} cycles; busy "
                  "cycles per iteration by warp: " + ", ".join(
                      f"{w}: {v:.0f}" for w, v in row["warp_busy_per_iteration"].items()))
    finally:
        _build._lib = main_lib
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
