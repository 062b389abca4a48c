#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the kernels compiled from rodio_tpu_torch/csrc with nvcc;
3. kernels: K4, K3, K1, K2, K6, K7 and K8 against their plain PyTorch
   versions on the card, at the shapes of the paths below, with their times;
4. the paths, each render's kernel launches counted on their own:
   - the slice: make_flagship(512, scan_mode="fused") rendered for 12
     blocks of 12800 frames (finite output, K1 and K3 launched once per
     block), and its first 2 blocks against the port's unfused chain (K4 +
     K3);
   - path A, the AGC slice: the same with with_agc=True (K2 and K3 once per
     block, under sync-debug "error"), and its first 2 blocks against
     path A', the unfused AGC chain (K4, K6, K3);
   - path B, BASELINE config 2: low_pass -> AGC -> Limit on 10 s of seeded
     stereo PCM in blocks of 4096 (K4, K8, K7, K3 once per block), per
     sample and with group=8, its first 2 blocks against the CPU;
5. times: ms per block and the aggregate realtime factor of the slice, of
   path A and of path B.

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
BOUND_K2 = 1e-6    # as K1; its carries and ring the same order
BOUND_K6 = BOUND_K7 = BOUND_K8 = 0.0  # same op order (K8: same blocked order)
BOUND_SLICE = 1e-5  # the JAX package's fused-vs-unfused bound
BOUND_B = 1e-6     # path B on the card against the CPU

PATH_B_RATE, PATH_B_BLOCK = 44100, 4096
PATH_B_BLOCKS = -(-10 * PATH_B_RATE // PATH_B_BLOCK)  # 10 s of audio
#: (att, rel, target, max_gain, floor, 1/8192) of AgcSettings() at 48 kHz,
#: with a 50 ms release so the peak detector has memory
AGC_PARAMS = (0.99999480, 0.99958340, 1.0, 7.0, 0.0, 1.0 / 8192)


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
    from rodio_tpu_torch.effects import AgcSettings, AutomaticGainControl
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

    # K2: the same block with the AGC, the ring warm: every row holds a
    # square that leaves the window, and each stream's window sum is theirs
    params = dev_f32(AGC_PARAMS)
    ring = (dev_f32(rng.uniform(0.0, 0.01, (4096, L)))).to(torch.bfloat16)
    rs0 = ring.float().reshape(4096, N_STREAMS, 2).sum((0, 2))
    agc0 = torch.stack([rs0, dev_f32(rng.uniform(0, 0.3, N_STREAMS)),
                        dev_f32(rng.uniform(1, 3, N_STREAMS))])
    kw2 = dict(gains=gains, coeffs=coef, bq=bq, agc=agc0, agc_params=params,
               ring=ring, ring_row=1234)
    outk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw2)
    outp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw2)
    err2 = max(_max_err(a.float(), b.float()) for a, b in zip(outk, outp))
    ms2 = _time_ms(lambda: fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kw2), 20)
    pms2 = _time_ms(lambda: fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kw2), 1)
    print(f"K2 fused_resample_biquad_agc_mix 512x2 streams, n={T}, bf16 ring: "
          f"max|d| {err2:.3e} (bound {BOUND_K2}); kernel {ms2:.4f} ms, plain "
          f"{pms2:.2f} ms {tag}")
    results.append(("fused_resample_biquad_agc_mix", "rodio_tpu_torch/csrc/fused_agc.cu",
                    "rodio_tpu/ops/fused.py:1957", err2, ms2, pms2, BOUND_K2))
    del x, pcm, ring, outk, outp

    # K6: the AGC loop over [512, 25600] interleaved samples
    M6 = 2 * T
    xs = dev_f32(np.abs(rng.standard_normal((N_STREAMS, M6)) * 0.05))
    sq = xs * xs
    d6 = sq - sq.roll(4096, 1)
    c6 = (dev_f32(rng.uniform(0, 0.2, N_STREAMS)), dev_f32(rng.uniform(1, 50, N_STREAMS)),
          dev_f32(rng.uniform(1, 3, N_STREAMS)))
    gk, ck = cuda_scan.agc(xs, d6, *c6, params)
    gp, cp = cuda_scan.agc_plain(xs, d6, *c6, params)
    err6 = max(_max_err(gk, gp), *(_max_err(a, b) for a, b in zip(ck, cp)))
    ms6 = _time_ms(lambda: cuda_scan.agc(xs, d6, *c6, params), 20)
    pms6 = _time_ms(lambda: cuda_scan.agc_plain(xs, d6, *c6, params), 1)
    print(f"K6 agc [{N_STREAMS}, {M6}]: max|d| {err6:.3e} (bound {BOUND_K6}); "
          f"kernel {ms6:.4f} ms, plain {pms6:.2f} ms {tag}")
    results.append(("agc", "rodio_tpu_torch/csrc/agc.cu",
                    "rodio_tpu/ops/pallas_scan.py:330", err6, ms6, pms6, BOUND_K6))
    del xs, sq, d6, gk, gp

    # K7: the smoother over [1, 8192] (path B's block), and the linear and
    # max-affine ops at a small shape
    des = dev_f32(rng.uniform(0.5, 7.0, (1, 8192)))
    g0 = dev_f32([1.0])
    p7 = params[[0, 1, 3]]
    err7 = _max_err(cuda_scan.first_order(des, des, g0, op="agc_gain", params=p7),
                    cuda_scan.first_order_plain(des, des, g0, op="agc_gain", params=p7))
    a7 = dev_f32(rng.uniform(0.9, 1.0, (8, 512)))
    b7 = dev_f32(rng.standard_normal((8, 512)))
    i7 = dev_f32(rng.standard_normal(8))
    for op in ("linear", "max_affine"):
        err7 = max(err7, _max_err(cuda_scan.first_order(a7, b7, i7, a7, op=op),
                                  cuda_scan.first_order_plain(a7, b7, i7, a7, op=op)))
    ms7 = _time_ms(lambda: cuda_scan.first_order(des, des, g0, op="agc_gain", params=p7), 50)
    pms7 = _time_ms(lambda: cuda_scan.first_order_plain(des, des, g0, op="agc_gain",
                                                        params=p7), 1)
    print(f"K7 first_order agc_gain [1, 8192] (+ linear, max_affine [8, 512]): "
          f"max|d| {err7:.3e} (bound {BOUND_K7}); kernel {ms7:.4f} ms, plain "
          f"{pms7:.2f} ms {tag}")
    results.append(("first_order", "rodio_tpu_torch/csrc/first_order.cu",
                    "rodio_tpu/ops/pallas_scan.py:433", err7, ms7, pms7, BOUND_K7))

    # K8: the peak detector over [1, 8192], P = 128, release as data
    x8 = dev_f32(np.abs(rng.standard_normal((1, 8192)) * 0.3))
    v8, a8 = dev_f32([0.4]), params[1]
    err8 = _max_err(limiter_block.blocked_max_affine_const(x8, v8, a8, P=128),
                    limiter_block.blocked_max_affine_const_plain(x8, v8, a8, P=128))
    ms8 = _time_ms(lambda: limiter_block.blocked_max_affine_const(x8, v8, a8, P=128), 50)
    pms8 = _time_ms(lambda: limiter_block.blocked_max_affine_const_plain(x8, v8, a8, P=128), 5)
    print(f"K8 blocked_max_affine_const [1, 8192] P=128: max|d| {err8:.3e} "
          f"(bound {BOUND_K8}); kernel {ms8:.4f} ms, plain {pms8:.2f} ms {tag}")
    results.append(("blocked_max_affine_const", "rodio_tpu_torch/csrc/bma.cu",
                    "rodio_tpu/ops/limiter_block.py:293", err8, ms8, pms8, BOUND_K8))
    for name, _, _, err, _, _, bound in results:
        if not err <= bound:
            raise AssertionError(f"{name}: max|d| {err} exceeds {bound}")

    # -- 4. the slice ------------------------------------------------------
    # Each render's launch counts are its own: every counter is set to 0
    # just before the render and read just after it.
    counters = {"K1": (fused, "launches"), "K2": (fused, "agc_launches"),
                "K3": (limiter_block, "launches"), "K4": (cuda_scan, "launches"),
                "K6": (cuda_scan, "agc_launches"),
                "K7": (cuda_scan, "first_order_launches"),
                "K8": (limiter_block, "bma_launches")}

    def reset():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    def expect(run, name, **want):
        got = {k: v for k, v in run.items() if v}
        if got != want:
            raise AssertionError(f"{name} launches {run}, expected {want}")

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
    expect(fused_run, "fused render", K1=N_BLOCKS, K3=N_BLOCKS)
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
    expect(unfused_run, "unfused chain", K3=2, K4=2)
    nv = int(uvalids.sum().item())  # no drain frame inside the first blocks
    err_slice = _max_err(out[:, :nv], uout[:, :nv])
    print(f"slice: fused vs unfused chain (K4 + K3), 2 blocks: max|d| "
          f"{err_slice:.3e} (bound {BOUND_SLICE}); output peak {peak:.4f}")
    if not err_slice <= BOUND_SLICE:
        raise AssertionError(f"fused vs unfused {err_slice} exceeds {BOUND_SLICE}")
    del uout, unfused, ustate

    # path A: the AGC slice, K2 then K3 per block, no host sync
    agc_master, astate = rtt.make_flagship(
        N_STREAMS, seconds=4.0, scan_mode="fused", with_agc=True, device="cuda",
        max_block=T, seed=SEED)
    reset()
    torch.cuda.set_sync_debug_mode("error")
    astate, aout, avalids = rtt.render_blocks(agc_master, astate, N_BLOCKS, T)
    torch.cuda.set_sync_debug_mode("default")
    agc_run = counts()
    torch.cuda.synchronize()
    print(f"path A: fused AGC render of {N_BLOCKS} x {T}: launches {agc_run}")
    expect(agc_run, "path A", K2=N_BLOCKS, K3=N_BLOCKS)
    if tuple(aout.shape) != (2, N_BLOCKS * T) or not bool(torch.isfinite(aout).all()):
        raise AssertionError(f"path A output {tuple(aout.shape)} not finite [2, {N_BLOCKS * T}]")
    if not bool((avalids == T).all()):
        raise AssertionError(f"path A valid counts {avalids.tolist()}")
    apeak = float(aout.abs().max().item())
    if not 0.0 < apeak < 1.0:
        raise AssertionError(f"path A output peak {apeak} outside (0, 1)")
    del astate

    # path A': the unfused AGC chain (K4, K6, K3), 2 blocks
    agc_unfused, austate = rtt.make_flagship(
        N_STREAMS, seconds=4.0, scan_mode="pallas", with_agc=True, device="cuda",
        max_block=T, seed=SEED)
    reset()
    _, auout, auvalids = rtt.render_blocks(agc_unfused, austate, 2, T)
    agc_unfused_run = counts()
    torch.cuda.synchronize()
    print(f"path A': unfused AGC chain render of 2 x {T}: launches {agc_unfused_run}")
    expect(agc_unfused_run, "path A'", K3=2, K4=2, K6=2)
    nv = int(auvalids.sum().item())
    err_a = _max_err(aout[:, :nv], auout[:, :nv])
    print(f"path A: fused (K2, bf16 ring) vs unfused AGC chain (K4 + K6 + K3), "
          f"2 blocks: max|d| {err_a:.3e} (bound {BOUND_SLICE}); output peak {apeak:.4f}")
    if not err_a <= BOUND_SLICE:
        raise AssertionError(f"path A fused vs unfused {err_a} exceeds {BOUND_SLICE}")
    del auout, agc_unfused, austate, aout

    # path B: BASELINE config 2 on 10 s of seeded stereo PCM at 44.1 kHz,
    # per-sample and group-rate smoother
    pcm_b = np.random.default_rng(SEED + 2).standard_normal(
        (2, 10 * PATH_B_RATE)).astype(np.float32) * 0.3

    def config2(device, group):
        node = SamplesBuffer(2, PATH_B_RATE, pcm_b, device=device).low_pass(2000.0)
        node = AutomaticGainControl(node, AgcSettings(), mode="pallas", group=group)
        return Limit(node, LimitSettings(), mode="pallas")

    path_b_runs = {}
    for group in (0, 8):
        node = config2("cuda", group)
        reset()
        _, bout, bvalids = rtt.render_blocks(node, node.init_state(),
                                             PATH_B_BLOCKS, PATH_B_BLOCK)
        run = counts()
        torch.cuda.synchronize()
        print(f"path B (group={group}): {PATH_B_BLOCKS} x {PATH_B_BLOCK}: launches {run}")
        nb = PATH_B_BLOCKS
        expect(run, f"path B (group={group})", K3=nb, K4=nb, K7=nb, K8=nb)
        if int(bvalids.sum().item()) != 10 * PATH_B_RATE or not bool(torch.isfinite(bout).all()):
            raise AssertionError(f"path B output: valid {int(bvalids.sum())}, finite "
                                 f"{bool(torch.isfinite(bout).all())}")
        cnode = config2(None, group)
        _, cout, _ = rtt.render_blocks(cnode, cnode.init_state(), 2, PATH_B_BLOCK)
        err_b = _max_err(bout[:, :2 * PATH_B_BLOCK].cpu(), cout)
        print(f"path B (group={group}): card vs CPU, 2 blocks: max|d| {err_b:.3e} "
              f"(bound {BOUND_B})")
        if not err_b <= BOUND_B:
            raise AssertionError(f"path B card vs CPU {err_b} exceeds {BOUND_B}")
        path_b_runs[group] = run

    # -- 5. times ----------------------------------------------------------
    def time_render(node, n_blocks, block):
        st = node.init_state()
        st, _, _ = rtt.render_blocks(node, st, 1, block)  # warm-up block
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        rtt.render_blocks(node, st, n_blocks, block)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / n_blocks

    for label, node in (("slice", master), ("path A (AGC)", agc_master)):
        sec_per_block = time_render(node, N_BLOCKS, T)
        rt_factor = (N_STREAMS * T / 48000) / sec_per_block
        print(f"{label}: {sec_per_block * 1e3:.3f} ms per block of {T} frames x "
              f"{N_STREAMS} streams; aggregate realtime factor {rt_factor:.1f}x {tag}")
    sec_per_block = time_render(config2("cuda", 0), 24, PATH_B_BLOCK)
    print(f"path B (config 2): {sec_per_block * 1e3:.3f} ms per block of "
          f"{PATH_B_BLOCK} frames x 1 stream; realtime factor "
          f"{PATH_B_BLOCK / PATH_B_RATE / sec_per_block:.1f}x {tag}")

    # launches: from the render of the path that runs the kernel;
    # launches_by_run keeps every render's counts apart
    runs = {"fused": fused_run, "unfused": unfused_run, "agc_fused": agc_run,
            "agc_unfused": agc_unfused_run, "config2": path_b_runs[0],
            "config2_group8": path_b_runs[8]}
    kernel_paths = (("K4", "unfused"), ("K3", "fused"), ("K1", "fused"),
                    ("K2", "agc_fused"), ("K6", "agc_unfused"),
                    ("K7", "config2"), ("K8", "config2"))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": runs[path][kid], "path": path,
         "launches_by_run": {r: c[kid] for r, c in runs.items()},
         "max_abs_err": err, "ms": ms, "plain_ms": pms}
        for (name, src, rep, err, ms, pms, _), (kid, path) in zip(
            results, kernel_paths)
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
