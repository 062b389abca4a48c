#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the kernels compiled from rodio_tpu_torch/csrc with nvcc;
3. kernels: K4, K3 and K1 against their plain PyTorch versions on the card,
   at the shapes of the main path, with their times;
4. the slice: make_flagship(512, scan_mode="fused") rendered for 12 blocks
   of 12800 frames (finite output, K1 and K3 launched once per block), and
   its first 2 blocks against the port's unfused chain (K4 + K3), each
   render's kernel launches counted on their own;
5. times: ms per block and the aggregate realtime factor of the slice.

It prints one JSON line of per-kernel results (each kernel's launches are
those of the render whose path runs it), then, as the last line,
{"ok": true, "device": {...}}. Without CUDA, or without the repository
beside it, it fails before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

N_STREAMS = 512
T = 12800
N_BLOCKS = 12
SEED = 0

# bounds against the plain versions, and fused vs unfused chain
BOUND_K4 = 0.0     # same op order, every op rounded alone
BOUND_K3 = 1e-6    # same blocked order; aim 0
BOUND_K1 = 1e-6    # same order except the mix's summation order
BOUND_SLICE = 1e-5  # the JAX package's fused-vs-unfused bound


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b) -> float:
    return float((a - b).abs().max().item())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import numpy as np

    import rodio_tpu_torch as rtt
    from rodio_tpu_torch.effects.blt import blt_coefficients
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.conversions.resample import lerp_weights, output_positions
    from rodio_tpu_torch.ops import _build, cuda_scan, fused, limiter_block
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    # -- 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}")
    print(f"nvidia-smi: {smi}")
    tag = f"[{smi}]"

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)")

    # -- 3. kernels against their plain versions, main-path shapes ----------
    rng = np.random.default_rng(SEED)

    def dev_f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    L = N_STREAMS * 2
    coef = dev_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple())
    results = []

    # K4: biquad over [1024, 12800]
    x = dev_f32(rng.standard_normal((L, T)) * 0.1)
    st = tuple(dev_f32(rng.standard_normal(L) * 0.01) for _ in range(4))
    yk, sk = cuda_scan.biquad_df1(x, coef, st)
    yp, sp = cuda_scan.biquad_df1_plain(x, coef, st)
    err4 = max(_max_err(yk, yp), *(_max_err(a, b) for a, b in zip(sk, sp)))
    ms4 = _time_ms(lambda: cuda_scan.biquad_df1(x, coef, st), 20)
    pms4 = _time_ms(lambda: cuda_scan.biquad_df1_plain(x, coef, st), 2)
    print(f"K4 biquad_df1 [{L}, {T}]: max|d| {err4:.3e} (bound {BOUND_K4}); "
          f"kernel {ms4:.4f} ms, plain {pms4:.2f} ms {tag}")
    results.append(("biquad_df1", "rodio_tpu_torch/csrc/biquad.cu",
                    "rodio_tpu/ops/pallas_scan.py:82", err4, ms4, pms4, BOUND_K4))

    # K3: the master limiter over [2, 12800], P = 128, loud enough to limit
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32)),
                LimitSettings())  # the master bus's coefficients at 48 kHz
    kw = dict(att=lim.attack, rel=lim.release, threshold=lim.threshold,
              knee_width=lim.knee_width, inv_knee_8=lim.inv_knee_8, P=128)
    xm = dev_f32(rng.standard_normal((2, T)) * 0.7)
    i0, p0 = dev_f32([0.5, 1.0]), dev_f32([0.8, 0.3])
    yk, ck = limiter_block.limiter_master(xm, i0, p0, **kw)
    yp, cp = limiter_block.limiter_master_plain(xm, i0, p0, **kw)
    err3 = max(_max_err(yk, yp), *(_max_err(a, b) for a, b in zip(ck, cp)))
    ms3 = _time_ms(lambda: limiter_block.limiter_master(xm, i0, p0, **kw), 50)
    pms3 = _time_ms(lambda: limiter_block.limiter_master_plain(xm, i0, p0, **kw), 5)
    print(f"K3 limiter_master [2, {T}] P=128: max|d| {err3:.3e} (bound {BOUND_K3}); "
          f"kernel {ms3:.4f} ms, plain {pms3:.2f} ms {tag}")
    results.append(("limiter_master", "rodio_tpu_torch/csrc/limiter_block.cu",
                    "rodio_tpu/ops/limiter_block.py:175", err3, ms3, pms3, BOUND_K3))

    # K1: 512 stereo streams, one block of 12800 frames at 44.1 -> 48 kHz
    fr, to = 147, 160
    F = (T // to + 4) * fr * 3
    pcm = dev_f32(rng.standard_normal((F, L)) * 0.1)
    gains = dev_f32(np.repeat(rng.uniform(0.5, 1.5, N_STREAMS) / N_STREAMS, 2))
    bq = dev_f32(rng.standard_normal((4, L)) * 0.001)
    kw1 = dict(gains=gains, coeffs=coef, bq=bq, channels=2)
    left, phase = output_positions(3 * to, T, fr, to, dev)
    wts = dev_f32(np.stack(lerp_weights(fr, to), axis=1))[phase]
    mk, bk = fused.fused_resample_biquad_mix(pcm, left, wts, **kw1)
    mp, bp = fused.fused_resample_biquad_mix_plain(pcm, left, wts, **kw1)
    err1 = max(_max_err(mk, mp), _max_err(bk, bp))
    ms1 = _time_ms(lambda: fused.fused_resample_biquad_mix(pcm, left, wts, **kw1), 20)
    pms1 = _time_ms(lambda: fused.fused_resample_biquad_mix_plain(pcm, left, wts, **kw1), 2)
    print(f"K1 fused_resample_biquad_mix 512x2 streams, n={T}: max|d| {err1:.3e} "
          f"(bound {BOUND_K1}); kernel {ms1:.4f} ms, plain {pms1:.2f} ms {tag}")
    results.append(("fused_resample_biquad_mix", "rodio_tpu_torch/csrc/fused.cu",
                    "rodio_tpu/ops/fused.py:1841", err1, ms1, pms1, BOUND_K1))
    del x, pcm
    for name, _, _, err, _, _, bound in results:
        if not err <= bound:
            raise AssertionError(f"{name}: max|d| {err} exceeds {bound}")

    # -- 4. the slice ------------------------------------------------------
    # Each render's launch counts are its own: every counter is set to 0
    # just before the render and read just after it.
    counters = {"K1": fused, "K3": limiter_block, "K4": cuda_scan}

    def reset():
        for mod in counters.values():
            mod.launches = 0

    def counts():
        return {k: mod.launches for k, mod in counters.items()}

    master, state = rtt.make_flagship(N_STREAMS, seconds=4.0, scan_mode="fused",
                                      device="cuda", max_block=T, seed=SEED)
    reset()
    torch.cuda.set_sync_debug_mode("error")  # emit must never wait for the card
    state, out, valids = rtt.render_blocks(master, state, N_BLOCKS, T)
    torch.cuda.set_sync_debug_mode("default")
    fused_run = counts()
    torch.cuda.synchronize()
    print(f"slice: fused render of {N_BLOCKS} x {T}: launches {fused_run}")
    if tuple(out.shape) != (2, N_BLOCKS * T) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"slice output {tuple(out.shape)} not finite [2, {N_BLOCKS * T}]")
    if fused_run != {"K1": N_BLOCKS, "K3": N_BLOCKS, "K4": 0}:
        raise AssertionError(f"fused render launches {fused_run}, expected "
                             f"{N_BLOCKS} each of K1 and K3")
    if not bool((valids == T).all()):
        raise AssertionError(f"valid counts {valids.tolist()}")
    peak = float(out.abs().max().item())
    if not 0.0 < peak < 1.0:
        raise AssertionError(f"slice output peak {peak} outside (0, 1)")

    unfused, ustate = rtt.make_flagship(N_STREAMS, seconds=4.0, scan_mode="auto",
                                        device="cuda", max_block=T, seed=SEED)
    reset()
    _, uout, uvalids = rtt.render_blocks(unfused, ustate, 2, T)
    unfused_run = counts()
    torch.cuda.synchronize()
    print(f"slice: unfused chain render of 2 x {T}: launches {unfused_run}")
    if unfused_run != {"K1": 0, "K3": 2, "K4": 2}:
        raise AssertionError(f"unfused chain launches {unfused_run}, expected "
                             f"2 each of K3 and K4")
    nv = int(uvalids.sum().item())  # no drain frame inside the first blocks
    err_slice = _max_err(out[:, :nv], uout[:, :nv])
    print(f"slice: fused vs unfused chain (K4 + K3), 2 blocks: max|d| "
          f"{err_slice:.3e} (bound {BOUND_SLICE}); output peak {peak:.4f}")
    if not err_slice <= BOUND_SLICE:
        raise AssertionError(f"fused vs unfused {err_slice} exceeds {BOUND_SLICE}")
    del uout, unfused, ustate

    # -- 5. times ----------------------------------------------------------
    state = master.init_state()
    state, _, _ = rtt.render_blocks(master, state, 1, T)  # warm-up block
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, out, _ = rtt.render_blocks(master, state, N_BLOCKS, T)
    end.record()
    torch.cuda.synchronize()
    sec_per_block = start.elapsed_time(end) / 1e3 / N_BLOCKS
    rt_factor = (N_STREAMS * T / 48000) / sec_per_block
    print(f"slice: {sec_per_block * 1e3:.3f} ms per block of {T} frames x "
          f"{N_STREAMS} streams; aggregate realtime factor {rt_factor:.1f}x {tag}")

    # launches: from the render of the path that runs the kernel (K1 and K3
    # the fused main path, K4 the unfused chain); launches_by_run keeps both
    # renders' counts apart
    runs = {"fused": fused_run, "unfused": unfused_run}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": runs[path][kid], "path": path,
         "launches_by_run": {r: c[kid] for r, c in runs.items()},
         "max_abs_err": err, "ms": ms, "plain_ms": pms}
        for (name, src, rep, err, ms, pms, _), kid, path in zip(
            results, ("K4", "K3", "K1"), ("unfused", "fused", "fused"))
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
