#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the kernels compiled from rodio_tpu_torch/csrc with nvcc;
3. kernels: the latency of a dependent rounded f32 op and of one step of
   the AGC's gain smoother, measured on one thread (benches/op_latency.py);
   then K4 (at [1024, 12800] and at path B's [2, 4096], on f32 blocks and,
   its bf16 instance, on bf16 blocks), the generators' phase accumulator
   (a ported lax.scan, at path H's [1, 1024]), K3, K1, K2, K2r
   and K2b (K2's serial and blocked rel0 plans),
   K2g (K2's group branch), K6, K7, K8, K5 (limiter_stream, the Limit
   node's whole per-stream pass, and limiter_env, its envelopes alone) and
   K9 and K1's ring mode (the farm's ring of (4 Kp + 1) * fr rows, read
   modulo its rows, at a start whose last tile and last right tap cross
   the seam) against their plain PyTorch versions on the card, at the shapes of
   the paths below, with
   their times, their roofline bounds (bytes over 3.35 TB/s or operations
   over 67 TFLOP/s f32, the larger: ``bound_ms``), the chain floor of a
   recurrence (its serial steps times the dependent ops of a step times
   that latency: ``chain_ms``) and, where one PyTorch call computes the
   same function, its time; K1 once more at gains of unit scale, where its
   mix is largest against the rounding of its sum over blocks; threefry
   (jax.random's threefry2x32, no pallas_call: csrc/threefry.cu) at path
   K's block (uniform, Velvet's and Pink's fused shapes) and at 2^24 draws,
   its bits and draws equal to the plain version, with torch.rand of the
   same count as a yardstick; K7's linear op at Brownian's shape;
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
   - path C, the per-stream chain of BASELINE config 5's 512 streams:
     Resample -> BltFilter (K4) -> AutomaticGainControl(streams=512) (K6)
     -> Amplify -> Limit(streams=512) (K5's limiter_stream) -> WideMixer
     -> master Limit (K3), 12 blocks of 12800, each node with
     mode="pallas"; its first 2 blocks at 16 streams against the CPU; Limit
     on a mono input and on blocks of 4410 frames (K5) against the CPU;
   - path D, the group-rate fused AGC: path A with agc_group=16 (K2g and
     K3 once per block), its first 2 blocks against path A's;
   - path E, the JAX package's AGC-on bench leg: path A with
     agc_plan="rel0b16" and precision="int2" (K2b and K3 once per block,
     under sync-debug "error"), its first 2 blocks against path A's; path
     E', the same with agc_plan="rel0f" (K2r), 2 blocks against path A's;
   - path F, BASELINE config 1: Uniform(SamplesBuffer(...), 2, 48000,
     rodio_compat=True) over 180 s of seeded 16-bit stereo at 44.1 kHz in
     blocks of 4096 (the resampler's span path; no kernel of ours), the
     whole render against the CPU's, under sync-debug "error";
   - path G, config 5's unfused chain with the per-channel gains before
     the resampler, so it takes its streaming ring path: Amplify ->
     Resample(max_block=12800) -> BltFilter (K4) -> WideMixer -> Limit (K3),
     512 streams, 12 blocks of 12800 under sync-debug "error", its first 2
     blocks against the CPU;
   - path G', make_flagship(512, scan_mode="pallas", block_bf16=True): K4's
     bf16 instance and K3 once a block, its first 2 blocks against the CPU
     (the bf16 rounding flips counted) and against the f32 chain (1e-2
     relative);
   - path H, BASELINE config 4: the parity case of tools/parity_tpu.py and
     the scene of tests/test_baseline_configs.py (sine with rodio_compat:
     the phase kernel once a branch a block), each whole against the CPU;
   - path I, BASELINE config 3: 64 sources (60 generators with
     rodio_compat, 4 seeded buffers) into mixer(2, 48000), taken for 10 s
     and pulled in blocks of 2048 to the end (the phase kernel 60 times a
     pull), the whole render against the CPU's, with its time, device-busy
     share and launches a pull;
   - path K: path I's render dithered to 16 bits by the four algorithms
     (threefry once a block), and the nine noise sources for 10 s each in
     blocks of 4096 (threefry; Brownian and Red also K7), against the CPU:
     bit-equal but the erf_inv sources, at their bounds;
   - path J: profile_slice.player_script, a Player with a queue of three
     sounds and a from_iter beside it in blocks of 256, with volume, pause,
     live speed, seek and skip, the whole output against the CPU's;
   - path L: seek_state on path B's chain over 600 s to 300 s and to 60 s
     (the same replayed blocks: O(pre-roll)), timed, the 8 blocks after
     the seek against the CPU's, then save_state mid-render, load_state on
     the card and the continuation bit-equal;
   the CPU references of paths I, J, K and L render in three child
   processes, started after phase 3's timings and all finished before any
   later timing;
   then the io layer (no kernel of its own; K4, K8, K7, K3 run under it):
   - path M, BASELINE config 2 from a file: a seeded 180 s 16-bit stereo
     master at 44.1 kHz written as WAV and as FLAC (tests/
     test_torch_io_fixtures.py), each decoded whole onto the card by
     Decoder, through config 2's chain in 1938 blocks of 4096 (K4, K8, K7,
     K3 once a block), then to_file: the decoded PCM, the whole render and
     the WAV read back each bit-equal (to the master, to the chain on
     SamplesBuffer(master) on the card, to that render), the first 2
     blocks against the CPU; decode seconds, ms a block, device busy and
     idle share;
   - path N, the same track streamed: StreamingWav (and StreamingDecoder
     on the FLAC where libav is present) -> DeviceFeeder (pinned buffers,
     a side stream) -> PushPort -> the chain, the feed loop under
     sync-debug "error", bit-equal to path M's render; Resample(PushPort)
     44.1 -> 48 kHz against Resample(Decoder); a LoopedDecoder over three
     wraps against the CPU;
   - path O, the device side: a file sink on the card with play(FLAC) and
     a Microphone fed by a host thread, 10 s in buffers of 2048, against
     the CPU's run; the threaded start()/close() with a CallbackDevice;
     python -m rodio_tpu_torch render ... --agc --limit --seconds 30 in
     process, against the same graph built by hand; probe and devices;
     ms a buffer and the read-back's ms;
   then the farm (M8), BASELINE config 5 fed live:
   - path P: StreamFarm over 8 seeded 20 s 16-bit stereo WAVs at 44.1 kHz
     (written to a temporary directory) for 512 streams, blocks of 12800,
     gains U(0.5, 1.5)/512, offsets U(0, 9) s, looping, the i16 wire,
     fused=True (K1's ring mode and K3 once a block), 48 blocks, every
     step but the first under sync-debug "error" (the 32-block read-backs
     aside): ms a block and the aggregate realtime multiple (host clock),
     the host assembly, push and emit split (FarmSpans), device memory
     after block 8 and at the end (equal), host RSS growth; then 12
     profiled blocks of a fresh farm: device busy, idle share;
   - path Q: the same farm with fused=False (K4 and K3 once a block),
     within 2e-6 of P over all 48 blocks;
   - path R: ShardedStreamFarm over a NCCL group of one initialised here,
     bit-equal to P; then dryrun_multichip(1) on the card;
5. times: ms per block and the aggregate realtime factor of the slice and
   of paths A, B, C, D, E, E', F, G, G', H, I, J and K, the seek's time, and
   the device-busy share of I, J, K and L (paths M, N and O print theirs
   with their checks).

It prints one JSON line of per-kernel results (each kernel's launches are
those of the render whose path runs it; K9's, a tool on no render path,
those of its bandwidth probe, counted as a render's are), then, as the
last line,
{"ok": true, "device": {...}}. Without CUDA, or without the repository
beside it, it fails before printing any result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

N_STREAMS = 512
T = 12800
N_BLOCKS = 12
SEED = 0
AGC_GROUP = 16

# bounds against the plain versions, and between paths
BOUND_K4 = 0.0     # same op order, every op rounded alone
BOUND_K3 = 1e-6    # same blocked order; aim 0
BOUND_K1 = 1e-6    # same order except the mix's summation order
BOUND_K2 = 1e-6    # as K1; its carries and ring the same order
BOUND_K6 = BOUND_K7 = BOUND_K8 = 0.0  # same op order (K8: same blocked order)
BOUND_K5 = BOUND_K9 = 0.0  # same op order (K9: the same sum order; K5's
# limiter_stream: its gain computer, coupling and gain too)
BOUND_SLICE = 1e-5  # the JAX package's fused-vs-unfused bound
BOUND_B = 1e-6     # a path on the card against the CPU
BOUND_D_REL = 2e-3  # the group AGC against the serial plan, relative
# the rel0 plans against the serial plan (tests/test_fused.py:757-761)
BOUND_E = 5e-6     # rel0b16: the blocked composition reassociates
BOUND_E2 = 1e-6    # rel0f: the packed ring and the folded desired gain

BOUND_K4BF = BOUND_PHASE = 0.0  # same op order, the same rounding to bf16
BOUND_BF16_REL = 1e-2  # the bf16 block contract against the f32 chain

PATH_B_RATE, PATH_B_BLOCK = 44100, 4096
#: path F: BASELINE config 1, 180 s of 16-bit stereo at 44.1 kHz
PATH_F_SECONDS, PATH_F_BLOCK = 180, 4096
#: path H: BASELINE config 4's graphs, in the parity tool's blocks
PATH_H_BLOCK = 1024
#: path I: BASELINE config 3, 64 sources taken for 10 s (the test's 0.25 s
#: would give the timing 6 blocks), pulled in blocks of 2048
PATH_I_SECONDS, PATH_I_BLOCK = 10.0, 2048
#: path J: the player script's blocks of 256 (profile_slice.player_script)
PATH_J_BLOCKS = 700
#: path K: each noise source for 10 s in blocks of 4096
PATH_K_SECONDS, PATH_K_BLOCK = 10, 4096
#: path L: path B's chain over 600 s, sought to 300 s (and to 60 s: the same
#: replay, O(pre-roll)); blocks of 4096 after it
PATH_L_SECONDS, PATH_L_TARGETS, PATH_L_BLOCK = 600, (300.0, 60.0), 4096
#: path L: blocks rendered after the seek (a checkpoint after the third)
PATH_L_CONT = 8
#: path M: BASELINE config 2 from a 180 s 16-bit stereo file at 44.1 kHz, in
#: blocks of 4096 (1938 blocks), timed over 24 blocks
PATH_M_SECONDS, PATH_M_RATE, PATH_M_BLOCK, PATH_M_TIMED = 180, 44100, 4096, 24
PATH_M_BLOCKS = -(-PATH_M_SECONDS * PATH_M_RATE // PATH_M_BLOCK)
#: path N: Resample(PushPort) against Resample(Decoder) over 60 blocks; the
#: LoopedDecoder over a 10 s file, three wraps
PATH_N_RESAMPLE_BLOCKS, PATH_N_LOOP_SECONDS = 60, 10
#: path O: the file sink's 10 s in buffers of 2048; the CLI's 30 s render
PATH_O_BUFFER, PATH_O_CLI_SECONDS = 2048, 30
PATH_O_BUFFERS = -(-10 * 48000 // PATH_O_BUFFER)
#: paths P, Q, R: BASELINE config 5 fed live, 512 streams over 8 seeded 20 s
#: WAVs, 48 blocks of 12800 (12.8 s a stream: an offset past 7.2 s loops)
PATH_P_FILES, PATH_P_SECONDS, PATH_P_BLOCK, PATH_P_BLOCKS = 8, 20, 12800, 48
#: the JAX package's fused-vs-unfused farm bound (tests/test_streaming_farm.py:255-283)
BOUND_FARM = 2e-6
BOUND_THREEFRY = 0.0  # integer arithmetic, exact float conversions
#: the erf_inv sources on the card against the CPU: PyTorch's log1p and
#: sqrt may round an ulp apart on the two devices; a normal draw is then
#: within 4 ulp (|x| < 6: 4 * 2^-21), Brownian's integrator carries it
BOUND_GAUSS, BOUND_BROWN = 2e-6, 1e-5
PATH_B_BLOCKS = -(-10 * PATH_B_RATE // PATH_B_BLOCK)  # 10 s of audio
PATH_C_CHECK_STREAMS = 16
#: (att, rel, target, max_gain, floor, 1/8192) of AgcSettings() at 48 kHz,
#: with a 50 ms release so the peak detector has memory
AGC_PARAMS = (0.99999480, 0.99958340, 1.0, 7.0, 0.0, 1.0 / 8192)
#: the rel0 plans' chunks per 320-frame grid step (path E: rel0b16)
REL0_RPC = 16

# the card's peaks (H100 SXM data sheet)
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12


#: INT32 operations a second: 132 SMs x 64 INT32 lanes x 1.98 GHz (the
#: Hopper white paper's SM; the data sheet gives no INT32 rate)
INT32_OPS_S = 132 * 64 * 1.98e9
#: INT32 instructions of one threefry2x32 hash at the fewest: the low
#: word's key add (the high word is 0: its add is hoisted), 20 rounds of an
#: add, a funnel-shift rotate and an xor, 5 key injections of 2 adds (a
#: key word plus its round constant is one value for every hash of the
#: key), of which 4 of the first word's merge with the next round's add
#: into one 3-input add (IADD3)
THREEFRY_OPS = 1 + 20 * 3 + 5 * 2 - 4


def _threefry_ops(mode: str, i: int, n: int, grid: int = 1) -> int:
    """INT32 instructions that ``n`` draws of ``mode`` from counter ``i``
    need at the fewest, counted on this run's counters: a hash per value
    the function depends on, once, and the bits around it. uniform: the
    block's fold_in and a hash a draw, +3 a draw (the xor, the shift and
    the or). Velvet: 7 hashes a distinct cell t // grid (its fold_in,
    randint's split into 2 keys and 4 draws), +26 a cell (4 xors; 2
    elements of 3 modulos by an invariant, a mul-hi, a mul and a sub each,
    a mul and an add), +6 a sample (the counter's add, its modulo by the
    grid, the compare and the select). Pink: the 16 octave keys, 2 hashes
    a distinct (octave, t >> octave) (its fold_in and its draw), +3 each
    (the xor, the shift, the or); a sample's 15 float adds issue on the
    FP32 pipe, below the INT32 time here."""
    import numpy as np

    t = (i + np.arange(n, dtype=np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31
    if mode == "uniform":
        return (n + 1) * THREEFRY_OPS + 3 * n
    if mode == "velvet":
        cells = len(np.unique(t // grid))
        return cells * (7 * THREEFRY_OPS + 26) + 6 * n
    pairs = sum(len(np.unique(t >> o)) for o in range(16))
    return 16 * THREEFRY_OPS + pairs * (2 * THREEFRY_OPS + 3)


def _bound(nbytes: float, flops: float, ops_per_s: float = F32_FLOPS_S):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type (f32 by default)."""
    tb, tf = nbytes / HBM_BYTES_S, flops / ops_per_s
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


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


def _host_ms(fn, reps: int) -> float:
    """Mean host ms per call of ``fn`` (a call that waits for the card)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _max_err(a, b) -> float:
    return float((a - b).abs().max().item())


def _tensors(state):
    """Every tensor of a nested state."""
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        return [t for v in state for t in _tensors(v)]
    return [state] if hasattr(state, "device") else []


def _cpu_reference(task: str):
    """A path's render on the CPU, run in a child process while the card
    works (path I's 60 phase accumulators and path L's replay are serial
    loops on the CPU)."""
    import torch

    torch.set_num_threads(1)
    import rodio_tpu_torch as rtt
    from rodio_tpu_torch.graph import seek
    from rodio_tpu_torch.profile_slice import (
        NOISE, config2, config3, noise_source, player_script, pull_to_end)

    if task == "L":
        node = config2("cpu", 0, seconds=PATH_L_SECONDS)
        st = seek.seek_state(node, PATH_L_TARGETS[0])
        _, out, _ = rtt.render_blocks(node, st, PATH_L_CONT, PATH_L_BLOCK)
        return out.numpy(), seek.replayed_blocks
    if task == "I":
        _, rx = config3("cpu", PATH_I_SECONDS)
        blocks, pulls = pull_to_end(rx, PATH_I_BLOCK)
        return torch.cat(blocks, dim=1).numpy(), pulls
    if task == "J":
        return player_script("cpu", PATH_J_BLOCKS).numpy()
    n = -(-PATH_K_SECONDS * 48000 // PATH_K_BLOCK)
    out = {}
    for name in NOISE:
        node = noise_source(name, "cpu")
        out[name] = rtt.render_blocks(node, node.init_state(), n, PATH_K_BLOCK)[1].numpy()
    return out


def _with_port(state, fn):
    """``state`` with ``fn`` applied to the PushPort state at its bottom."""
    if "buf" in state:
        return fn(state)
    return {**state, "in": _with_port(state["in"], fn)}


def _codecs() -> str:
    """Which codec libraries this host has."""
    import ctypes.util

    from rodio_tpu_torch.io.native import missing_libav_headers

    missing = missing_libav_headers()
    libav = "libav: yes" if not missing else f"libav: no (missing {', '.join(missing)})"
    libs = [f"lib{n}: {'yes' if ctypes.util.find_library(n) else 'no'}"
            for n in ("mpg123", "vorbisfile")]
    return ", ".join(["wav, flac: native", libav, *libs])


def _io_paths(io_dir: str, h) -> dict:
    """Paths M, N and O (the io layer), their checks and their times;
    returns each render's launch counts. ``h``: the script's counters
    (``reset``, ``counts``, ``expect``) and the card's ``tag``."""
    import contextlib
    import io as pyio
    import threading

    import numpy as np
    import torch

    import rodio_tpu_torch as rtt
    from rodio_tpu_torch.__main__ import main as cli_main
    from rodio_tpu_torch.conversions.resample import Resample
    from rodio_tpu_torch.effects import AgcSettings, AutomaticGainControl
    from rodio_tpu_torch.effects.blt import BltFilter
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.io.decoder import Decoder, LoopedDecoder
    from rodio_tpu_torch.io.device import DeviceSinkBuilder, play
    from rodio_tpu_torch.io.microphone import Microphone, MicrophoneConfig
    from rodio_tpu_torch.io.native import missing_libav_headers
    from rodio_tpu_torch.io.streaming import (
        DeviceFeeder, PushPort, StreamingDecoder, StreamingWav)
    from rodio_tpu_torch.io.wav import read_wav
    from rodio_tpu_torch.profile_slice import config2_chain, profile_pulls
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_io_fixtures import (
        pcm16_master, resampled_feed, write_flac, write_pcm_wav)

    reset, counts, expect, tag = h["reset"], h["counts"], h["expect"], h["tag"]
    rate, n, blocks = PATH_M_RATE, PATH_M_BLOCK, PATH_M_BLOCKS
    total = PATH_M_SECONDS * rate
    k16, master = pcm16_master(SEED + 13, 2, total)
    paths = {"wav": os.path.join(io_dir, "master.wav"),
             "flac": os.path.join(io_dir, "master.flac")}
    t0 = time.perf_counter()
    write_pcm_wav(paths["wav"], k16, rate, 16)
    write_flac(paths["flac"], k16, rate)
    print(f"path M: a {PATH_M_SECONDS} s 16-bit stereo master at {rate} Hz ({total} "
          f"frames) written as WAV ({os.path.getsize(paths['wav'])} B) and FLAC "
          f"({os.path.getsize(paths['flac'])} B) in {time.perf_counter() - t0:.2f} s")
    master_t = torch.from_numpy(master)
    runs = {}

    # path M: each file decoded whole onto the card, config 2 in blocks of 4096
    ref = config2_chain(SamplesBuffer(2, rate, master, device="cuda"))
    _, ref_out, ref_valid = rtt.render_blocks(ref, ref.init_state(), blocks, n)
    ref_out = ref_out[:, :total]
    if int(ref_valid.sum().item()) != total or not bool(torch.isfinite(ref_out).all()):
        raise AssertionError("path M: the SamplesBuffer render is short or not finite")
    decode_s, m_nodes = {}, {}
    for fmt, path in paths.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = Decoder(path, device="cuda")
        torch.cuda.synchronize()
        decode_s[fmt] = time.perf_counter() - t0
        pcm_eq = torch.equal(dec.init_state()["data"][:, :total].cpu(), master_t)
        node = config2_chain(dec)
        reset()
        _, out, valid = rtt.render_blocks(node, node.init_state(), blocks, n)
        torch.cuda.synchronize()
        run = runs[f"config2_{fmt}"] = counts()
        expect(run, f"path M ({fmt})", K3=blocks, K4=blocks, K7=blocks, K8=blocks)
        out_eq = (int(valid.sum().item()) == total
                  and torch.equal(out[:, :total], ref_out))
        wav_out = os.path.join(io_dir, f"out_{fmt}.wav")
        node.to_file(wav_out)
        back, back_rate = read_wav(wav_out)
        file_eq = back_rate == rate and torch.equal(torch.from_numpy(back), ref_out.cpu())
        cnode = config2_chain(Decoder(path, device="cpu"))
        _, cout, _ = rtt.render_blocks(cnode, cnode.init_state(), 2, n)
        err = _max_err(out[:, :2 * n].cpu(), cout)
        print(f"path M ({fmt}): decoded in {decode_s[fmt]:.3f} s (host), PCM bit-equal to "
              f"the master {pcm_eq}; {blocks} x {n}: launches {run}; the whole render "
              f"bit-equal to the SamplesBuffer render {out_eq}, its WAV read back "
              f"bit-equal {file_eq}; card vs CPU, 2 blocks: max|d| {err:.3e} "
              f"(bound {BOUND_B})")
        if not (pcm_eq and out_eq and file_eq and err <= BOUND_B):
            raise AssertionError(f"path M ({fmt}): PCM {pcm_eq}, render {out_eq}, WAV "
                                 f"{file_eq}, card vs CPU {err}")
        m_nodes[fmt] = node
        del out, dec

    # path N: the same track streamed: a host feed -> DeviceFeeder (pinned
    # buffers, a side stream) -> PushPort -> the same chain, the feed loop
    # under sync-debug "error"; the whole output bit-equal to path M's
    def stream(feed):
        port = PushPort(2, rate, 2 * n, n, device="cuda")
        node = config2_chain(port)
        feeder = DeviceFeeder(feed, n, device="cuda")
        st, outs, pushed = node.init_state(), [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(blocks):
                blk, _ = feeder.next_device_block()
                count = min(n, total - pushed)
                pushed += count
                st = _with_port(st, lambda ps: port.push(ps, blk, count))
                if pushed == total:
                    st = _with_port(st, port.end)
                st, out, _ = node.emit(st, n)
                outs.append(out)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return torch.cat(outs, dim=1), (time.perf_counter() - t0) / blocks

    feeds = {"StreamingWav": lambda: StreamingWav(paths["wav"], chunk_frames=8192)}
    if not missing_libav_headers():
        feeds["StreamingDecoder (FLAC)"] = lambda: StreamingDecoder(paths["flac"],
                                                                    chunk_frames=8192)
    n_sec = {}
    for label, make in feeds.items():
        feed = make()
        reset()
        out, n_sec[label] = stream(feed)
        run = runs[f"config2_stream_{'wav' if 'Wav' in label else 'flac'}"] = counts()
        feed.close()
        expect(run, f"path N ({label})", K3=blocks, K4=blocks, K7=blocks, K8=blocks)
        eq = torch.equal(out[:, :total], ref_out)
        print(f"path N ({label}): {blocks} x {n} under sync-debug \"error\": launches {run}; "
              f"the whole output bit-equal to path M's {eq}")
        if not eq:
            raise AssertionError(f"path N ({label}): the streamed render differs from path M's")
        del out
    port_node, rp = resampled_feed(master[:, :PATH_N_RESAMPLE_BLOCKS * n], rate, 48000, n,
                                   PATH_N_RESAMPLE_BLOCKS, device="cuda")
    rd = Resample(Decoder(paths["wav"], device="cuda"), 48000)
    _, rdo, _ = rtt.render_blocks(rd, rd.init_state(), PATH_N_RESAMPLE_BLOCKS, n)
    err_rs = _max_err(rp, rdo)
    form = "weight" if port_node.uses_weight_form(n) else "lerp"
    print(f"path N: Resample(PushPort) 44.1 -> 48 kHz, {PATH_N_RESAMPLE_BLOCKS} x {n}, the "
          f"{form} form (Resample(Decoder): "
          f"{'weight' if rd.uses_weight_form(n) else 'lerp'}): max|d| {err_rs:.3e} "
          f"against Resample(Decoder) (bound {BOUND_B})")
    if not err_rs <= BOUND_B:
        raise AssertionError(f"path N: Resample(PushPort) vs Resample(Decoder) {err_rs}")
    loop_path = os.path.join(io_dir, "loop.wav")
    write_pcm_wav(loop_path, k16[:, :PATH_N_LOOP_SECONDS * rate], rate, 16)
    nl = -(-3 * PATH_N_LOOP_SECONDS * rate // n) + 1  # three wraps and into a fourth
    louts = []
    for d in ("cuda", "cpu"):
        node = LoopedDecoder(loop_path, device=d)
        _, o, _ = rtt.render_blocks(node, node.init_state(), nl, n)
        louts.append(o.cpu())
    loop_eq = torch.equal(louts[0], louts[1]) and torch.equal(
        louts[0][:, 2 * PATH_N_LOOP_SECONDS * rate:3 * PATH_N_LOOP_SECONDS * rate],
        master_t[:, :PATH_N_LOOP_SECONDS * rate])
    print(f"path N: LoopedDecoder over {PATH_N_LOOP_SECONDS} s, {nl} x {n} (three wraps): "
          f"card bit-equal to the CPU and to the master {loop_eq}; codecs: {_codecs()}")
    if not loop_eq:
        raise AssertionError("path N: LoopedDecoder on the card differs")

    # path O, the device side: a file sink on the card with play(flac) (a
    # Player through the mixer's Uniform to 48 kHz) and a Microphone fed
    # from a host thread, 10 s in buffers of 2048, against the CPU's run
    voice = (np.random.default_rng(SEED + 14).uniform(-0.1, 0.1, (2, PATH_O_BUFFERS * 2048))
             .astype(np.float32))

    def sink_run(device):
        path = os.path.join(io_dir, f"sink_{device}.wav")
        sink = (DeviceSinkBuilder(device=device).to_file(path)
                .prefer_buffer_frames(PATH_O_BUFFER).open())
        play(sink, paths["flac"])
        mic = Microphone(MicrophoneConfig(channels=2, sample_rate=48000,
                                          buffer_duration=0.5))
        sink.mixer().add(mic)
        inter = np.ascontiguousarray(voice.T).reshape(-1)
        stop = threading.Event()

        def talk():
            off = 0
            while off < len(inter) and not stop.is_set():
                off += mic.feed(inter[off:off + 9600])
                time.sleep(0.0005)

        thread = threading.Thread(target=talk, daemon=True)
        thread.start()
        t0 = time.perf_counter()
        try:
            sink.render_blocks(PATH_O_BUFFERS)
            if device == "cuda":
                torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / PATH_O_BUFFERS
        finally:
            stop.set()
            thread.join(timeout=10)
            sink.close()
        return read_wav(path)[0], sec

    reset()
    sink_card, sec_o = sink_run("cuda")
    runs["sink"] = counts()
    sink_cpu, _ = sink_run("cpu")
    err_o = _max_err(torch.from_numpy(sink_card), torch.from_numpy(sink_cpu))
    x = torch.zeros((2, PATH_O_BUFFER), device="cuda")
    readback_ms = _host_ms(lambda: x.cpu(), 200)
    print(f"path O: file sink, play(FLAC) + a Microphone fed by a host thread, "
          f"{PATH_O_BUFFERS} buffers of {PATH_O_BUFFER} ({sink_card.shape[1]} frames): card vs "
          f"CPU max|d| {err_o:.3e} (bound {BOUND_B}); {sec_o * 1e3:.3f} ms a buffer (host "
          f"clock), realtime factor {PATH_O_BUFFER / 48000 / sec_o:.2f}x; the read-back of "
          f"a buffer {readback_ms:.4f} ms; launches {runs['sink']} {tag}")
    if not (err_o <= BOUND_B and sink_card.shape == (2, PATH_O_BUFFERS * PATH_O_BUFFER)
            and float(np.abs(sink_card).max()) > 0.01):
        raise AssertionError(f"path O: the sink's WAV, card vs CPU {err_o}")
    got = []
    sink = (DeviceSinkBuilder().with_callback(lambda b: got.append(len(b)))
            .prefer_buffer_frames(PATH_O_BUFFER).open())
    sink.mixer().add(SamplesBuffer(2, 48000, voice, device="cuda"))
    sink.start()
    time.sleep(1.0)
    sink.close()
    alive = sink._thread is not None
    print(f"path O: threaded start()/close() with a CallbackDevice: {len(got)} buffers in "
          f"~1 s, the thread stopped {not alive}")
    if not got or alive or any(g != 2 * PATH_O_BUFFER for g in got):
        raise AssertionError(f"path O: the threaded sink wrote {got}")

    # path O: the CLI in-process, on the card, against the same graph by hand
    cli_out = os.path.join(io_dir, "cli.wav")
    argv = ["render", paths["flac"], cli_out, "--rate", "48000", "--low-pass", "2000",
            "--agc", "--limit", "--seconds", str(PATH_O_CLI_SECONDS)]
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(pyio.StringIO()):
        rc = cli_main(argv)
    sec_cli = time.perf_counter() - t0
    runs["cli_render"] = counts()
    node = Resample(Decoder(paths["flac"], device="cuda").take_duration(PATH_O_CLI_SECONDS),
                    48000)
    node = BltFilter(node, "low_pass", 2000.0, 0.5, mode="auto")
    node = AutomaticGainControl(node, AgcSettings(), mode="pallas")
    want = Limit(node, LimitSettings(), mode="auto").render()
    got_cli, cli_rate = read_wav(cli_out)
    err_cli = (_max_err(torch.from_numpy(got_cli), torch.from_numpy(want))
               if got_cli.shape == want.shape else float("inf"))
    nb_cli = -(-want.shape[1] // 4096)
    print(f"path O: python -m rodio_tpu_torch {' '.join(argv[:1])} <flac> <out> "
          f"{' '.join(argv[3:])}: rc {rc}, {got_cli.shape[1]} frames at {cli_rate} Hz in "
          f"{sec_cli:.2f} s; against the graph by hand on the card max|d| {err_cli:.3e} "
          f"(bound {BOUND_B}); launches {runs['cli_render']}")
    if not (rc == 0 and cli_rate == 48000 and err_cli <= BOUND_B):
        raise AssertionError(f"path O: the CLI's render, rc {rc}, vs by hand {err_cli}")
    if runs["cli_render"]["K8"] < nb_cli or runs["cli_render"]["K3"] < nb_cli:
        raise AssertionError(f"path O: the CLI's AGC and limiter ran {runs['cli_render']}")
    for argv in (["probe", paths["flac"]], ["devices"]):
        text = pyio.StringIO()
        with contextlib.redirect_stdout(text):
            cli_main(argv)
        print(f"path O: {argv[0]}: " + "; ".join(
            " ".join(line.split()) for line in text.getvalue().splitlines()
            if not line.startswith("file:")))

    # times: paths M and N on the card (the CPU references have finished)
    for fmt, node in m_nodes.items():
        st = node.init_state()
        st, _, _ = rtt.render_blocks(node, st, 1, n)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        rtt.render_blocks(node, st, PATH_M_TIMED, n)
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 1e3 / PATH_M_TIMED
        st_p = [node.init_state()]

        def pull(node=node, st_p=st_p):
            st_p[0], _, _ = node.emit(st_p[0], n)

        prof = profile_pulls(pull, 40)
        print(f"path M ({fmt}): decode {decode_s[fmt]:.3f} s (host); {sec * 1e3:.3f} ms a "
              f"block of {n} (CUDA events, {PATH_M_TIMED} blocks), realtime factor "
              f"{n / rate / sec:.1f}x; over 40 blocks: device busy "
              f"{prof['device_busy_ms']:.4f} ms a block, idle share {prof['idle_share']:.3f}, "
              f"{prof['launches_per_block']:.1f} device events a block {tag}")
    for label, sec in n_sec.items():
        feed = feeds[label]()
        port = PushPort(2, rate, 2 * n, n, device="cuda")
        node = config2_chain(port)
        feeder = DeviceFeeder(feed, n, device="cuda")
        st_p = [node.init_state()]

        def step(node=node, st_p=st_p, feeder=feeder, port=port):
            blk, _ = feeder.next_device_block()
            st = _with_port(st_p[0], lambda ps: port.push(ps, blk, n))
            st_p[0], _, _ = node.emit(st, n)

        for _ in range(4):
            step()
        prof = profile_pulls(step, 40)
        feed.close()
        print(f"path N ({label}): {sec * 1e3:.3f} ms a block of {n} (host clock over the "
              f"whole track, decode thread beside it), realtime factor "
              f"{n / rate / sec:.1f}x; over 40 blocks: device busy "
              f"{prof['device_busy_ms']:.4f} ms a block, idle share {prof['idle_share']:.3f}, "
              f"{prof['launches_per_block']:.1f} device events a block {tag}")
    return runs


def _farm_paths(farm_dir: str, h) -> dict:
    """Paths P, Q and R (BASELINE config 5 fed live: the farm and the
    sharded farm), their checks and their times; returns each run's launch
    counts. ``h`` as for :func:`_io_paths`."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from rodio_tpu_torch.dryrun import dryrun_multichip
    from rodio_tpu_torch.parallel.farm import StreamFarm
    from rodio_tpu_torch.parallel.sharded_farm import ShardedStreamFarm
    from rodio_tpu_torch.parallel.sharding import stream_mesh
    from rodio_tpu_torch.profile_slice import _kernel_intervals, _union_us
    from rodio_tpu_torch.utils.trace import FarmSpans

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_io_fixtures import pcm16_master, write_pcm_wav

    reset, counts, expect, tag = h["reset"], h["counts"], h["expect"], h["tag"]
    n, blocks, S = PATH_P_BLOCK, PATH_P_BLOCKS, N_STREAMS
    t0 = time.perf_counter()
    files = []
    for i in range(PATH_P_FILES):
        k16, _ = pcm16_master(SEED + 40 + i, 2, PATH_P_SECONDS * 44100)
        files.append(os.path.join(farm_dir, f"stream{i}.wav"))
        write_pcm_wav(files[-1], k16, 44100, 16)
    corpus_b = sum(os.path.getsize(f) for f in files)
    rng = np.random.default_rng(SEED)
    kw = dict(block_frames=n, loop=True, wire="i16", decode_workers=8,
              gains=(rng.uniform(0.5, 1.5, S) / S).astype(np.float32),
              start_offsets=rng.uniform(0.0, 9.0, S))
    paths = [files[i % PATH_P_FILES] for i in range(S)]
    print(f"path P: {PATH_P_FILES} seeded {PATH_P_SECONDS} s 16-bit stereo WAVs at 44.1 kHz "
          f"({corpus_b} B) written in {time.perf_counter() - t0:.2f} s; {S} streams over "
          f"them, offsets U(0, 9) s, looping, the i16 wire, blocks of {n}")

    def rss_kb():
        with open("/proc/self/status") as f:
            return int(next(line for line in f if line.startswith("VmRSS")).split()[1])

    def run_farm(farm, label, sync_debug=True, spans=None):
        """Drive ``blocks`` blocks into a buffer on the card (no host read
        inside the loop); the memory, RSS and host clock at block 8 and at
        the end."""
        out = torch.empty((2, blocks * n), dtype=torch.float32, device="cuda")
        marks = {}

        def on_block(k, o, v):
            out[:, k * n:(k + 1) * n].copy_(o)
            if k in (8, blocks - 1):
                marks[k] = (torch.cuda.memory_allocated(), rss_kb(), time.perf_counter())

        reset()
        res = farm.run(blocks, on_block=on_block, spans=spans, sync_debug=sync_debug)
        t_end = time.perf_counter()
        farm.close()
        run = counts()
        (mem8, rss8, t8), (mem_end, rss_end, _) = marks[8], marks[blocks - 1]
        sec = (t_end - t8) / (blocks - 1 - 8)
        if not (res[0] == blocks * n and res[2] is False and res[1] > 0.0
                and bool(torch.isfinite(out).all())):
            raise AssertionError(f"{label}: valid, energy, overflow {res}")
        if mem8 != mem_end:
            raise AssertionError(f"{label}: device memory {mem8} B after block 8, {mem_end} "
                                 "B at the end")
        return out, run, sec, (mem8, mem_end, rss_end - rss8)

    runs = {}
    # path P: the fused farm, K1's ring mode + K3 a block, every step under
    # sync-debug "error" but the 32-block read-backs
    spans = FarmSpans("cuda")
    farm_p = StreamFarm(paths, fused=True, device="cuda", **kw)
    out_p, runs["farm_fused"], sec_p, mem_p = run_farm(farm_p, "path P", spans=spans)
    expect(runs["farm_fused"], "path P", K1r=blocks, K3=blocks)
    sp = spans.summary()
    peak = float(out_p.abs().max())
    print(f"path P (config 5 fed live, fused, {S} streams, {blocks} blocks of {n}): "
          f"{sec_p * 1e3:.3f} ms a block (host clock, blocks 9-{blocks - 1} and the last "
          f"block's device work), aggregate realtime multiple "
          f"{S * n / 48000 / sec_p:.1f}x; host assembly {sp['assemble']['host_ms']:.3f} ms a "
          f"block, push {sp['push']['host_ms']:.3f} ms host / {sp['push']['device_ms']:.4f} "
          f"ms device, emit {sp['emit']['host_ms']:.3f} ms host / "
          f"{sp['emit']['device_ms']:.4f} ms device (CUDA events); device memory "
          f"{mem_p[0]} B after block 8, {mem_p[1]} B at the end; host RSS "
          f"{mem_p[2]:+d} kB from block 8 to the end; launches {runs['farm_fused']}; "
          f"peak {peak:.4f} {tag}")

    # path Q: the unfused farm (PushPort -> Resample -> K4 -> Amplify ->
    # WideMixer -> K3) on the same files and offsets, held to P
    farm_q = StreamFarm(paths, fused=False, device="cuda", **kw)
    out_q, runs["farm_unfused"], sec_q, mem_q = run_farm(farm_q, "path Q")
    expect(runs["farm_unfused"], "path Q", K4=blocks, K3=blocks)
    err_q = _max_err(out_p, out_q)
    print(f"path Q (the unfused farm): {sec_q * 1e3:.3f} ms a block, "
          f"{S * n / 48000 / sec_q:.1f}x; against path P over all {blocks} blocks: max|d| "
          f"{err_q:.3e} (bound {BOUND_FARM}); device memory {mem_q[0]} B, {mem_q[1]} B; "
          f"launches {runs['farm_unfused']} {tag}")
    if not err_q <= BOUND_FARM:
        raise AssertionError(f"path Q against P: {err_q} exceeds {BOUND_FARM}")
    del out_q

    # the device's busy and idle share over 12 blocks of a fused farm's
    # steady state (blocks 4-15 of a 20-block run, profiled)
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_block(k, o, v):
        if k == 3:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif k == 15:
            torch.cuda.synchronize()
            window["t1"] = time.perf_counter()
            prof.stop()

    farm_pp = StreamFarm(paths, fused=True, device="cuda", **kw)
    farm_pp.run(20, on_block=on_block)
    farm_pp.close()
    kern = _kernel_intervals(prof)
    busy_us, span_us = _union_us(kern), (window["t1"] - window["t0"]) * 1e6
    print(f"path P over 12 profiled blocks: device busy {busy_us / 1e3 / 12:.4f} ms a block, "
          f"host span {span_us / 1e3 / 12:.3f} ms a block, idle share "
          f"{1.0 - busy_us / span_us:.3f}, {len(kern) / 12:.1f} device events a block {tag}")

    # path R: ShardedStreamFarm over a NCCL group of one (initialised here on
    # a free localhost port), bit-equal to path P; then the multi-card dry
    # run on this card in the same group
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        farm_r = ShardedStreamFarm(paths, stream_mesh(), device="cuda", **kw)
        out_r, runs["farm_sharded"], sec_r, _ = run_farm(farm_r, "path R")
        expect(runs["farm_sharded"], "path R", K1r=blocks, K3=blocks)
        eq_r = torch.equal(out_r, out_p)
        print(f"path R (ShardedStreamFarm, NCCL group of one): {sec_r * 1e3:.3f} ms a block, "
              f"{S * n / 48000 / sec_r:.1f}x; bit-equal to path P {eq_r}; launches "
              f"{runs['farm_sharded']} {tag}")
        if not eq_r:
            raise AssertionError(f"path R differs from P: max|d| {_max_err(out_r, out_p)}")
        reset()
        dryrun_multichip(1, device="cuda")
        runs["dryrun"] = counts()
    finally:
        dist.destroy_process_group()
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import multiprocessing

    import rodio_tpu_torch  # noqa: F401  (fails here without the repository)

    # the CPU references of paths I, J, K and L render in three child
    # processes, started after the kernels' timings (phase 3) and waited for
    # before any later timing; they are stopped however the run ends
    pools = []

    def start_references():
        pools.append(multiprocessing.get_context("spawn").Pool(3))
        return {t: pools[0].apply_async(_cpu_reference, (t,)) for t in ("L", "I", "K", "J")}

    try:
        return _main(start_references)
    finally:
        for pool in pools:
            pool.terminate()
            pool.join()


def _main(start_references) -> int:
    import torch

    import numpy as np

    import rodio_tpu_torch as rtt
    from rodio_tpu_torch.benches import dma_roofline, op_latency, warp_cycles
    from rodio_tpu_torch.conversions.resample import lerp_weights, output_positions
    from rodio_tpu_torch.effects import AgcSettings, AutomaticGainControl
    from rodio_tpu_torch.effects.blt import blt_coefficients
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.effects import Dither
    from rodio_tpu_torch.graph import seek
    from rodio_tpu_torch.graph.seek import seek_state
    from rodio_tpu_torch.graph.checkpoint import load_state, save_state
    from rodio_tpu_torch.ops import _build, cuda_scan, fused, limiter_block, phase, threefry
    from rodio_tpu_torch.profile_slice import (
        NOISE, config1, config2, config3, config4_parity, config4_scene, noise_source,
        player_script, profile_pulls, pull_to_end, ring_chain)
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
    op_s = op_latency.seconds_per_op(dev)
    print(f"chain: a dependent rounded f32 op (FMUL, FADD) takes {op_s * 1e9:.4f} ns "
          f"on one thread {tag}")
    smooth_s, smooth_cyc = op_latency.smooth_step(dev)
    print(f"chain: a step of the AGC's gain smoother (5 dependent ops) takes "
          f"{smooth_s * 1e9:.4f} ns, {smooth_cyc:.2f} SM cycles, on one thread {tag}")

    def _chain_ms(steps: int, ops: int) -> float:
        """The dependency-chain floor: serial steps times the dependent
        rounded ops of a step, at the latency just measured."""
        return steps * ops * op_s * 1e3

    # Each run's launch counts are its own: every counter is set to 0 just
    # before the run (a render, or K9's probe) and read just after it.
    counters = {"K1": (fused, "launches"), "K1r": (fused, "ring_launches"),
                "K2": (fused, "agc_launches"),
                "K2r": (fused, "agc_rel0_launches"),
                "K2b": (fused, "agc_blocked_launches"),
                "K2g": (fused, "agc_group_launches"),
                "K3": (limiter_block, "launches"), "K4": (cuda_scan, "launches"),
                "K4bf": (cuda_scan, "bf16_launches"), "phase": (phase, "launches"),
                "K5": (cuda_scan, "limiter_stream_launches"),
                "K6": (cuda_scan, "agc_launches"),
                "K7": (cuda_scan, "first_order_launches"),
                "K8": (limiter_block, "bma_launches"),
                "K9": (dma_roofline, "launches"), "threefry": (threefry, "launches")}

    def reset():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    def expect(run, name, **want):
        got = {k: v for k, v in run.items() if v}
        if got != want:
            raise AssertionError(f"{name} launches {run}, expected {want}")

    rng = np.random.default_rng(SEED)

    def dev_f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    L = N_STREAMS * 2
    coef = dev_f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple())
    results = []

    def record(kid, name, src, rep, err, bound_err, ms, pms, nbytes, flops,
               chain_ms, library_ms=None, note="", path=None, ops_per_s=F32_FLOPS_S):
        bound_ms, bound_by = _bound(nbytes, flops, ops_per_s)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{kid} {name}{note}: max|d| {err:.3e} (bound {bound_err}); kernel "
              f"{ms:.4f} ms, plain {pms:.2f} ms; roofline {bound_ms:.4f} ms "
              f"({bound_by}), chain floor {chain_ms:.4f} ms, library {lib} {tag}")
        results.append(dict(kid=kid, name=name, source=src, replaces=rep,
                            max_abs_err=err, bound_err=bound_err, ms=ms,
                            plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by,
                            chain_ms=chain_ms, library_ms=library_ms, path=path))

    # K4: biquad over [1024, 12800]; per sample 5 mul + 4 add, and its
    # chain y1 -> mul, sub, sub
    x = dev_f32(rng.standard_normal((L, T)) * 0.1)
    st = tuple(dev_f32(rng.standard_normal(L) * 0.01) for _ in range(4))
    yk, sk = cuda_scan.biquad_df1(x, coef, st)
    yp, sp = cuda_scan.biquad_df1_plain(x, coef, st)
    err4 = max(_max_err(yk, yp), *(_max_err(a, b) for a, b in zip(sk, sp)))
    ms4 = _time_ms(lambda: cuda_scan.biquad_df1(x, coef, st), 20)
    pms4 = _time_ms(lambda: cuda_scan.biquad_df1_plain(x, coef, st), 2)
    record("K4", "biquad_df1", "rodio_tpu_torch/csrc/biquad.cu",
           "rodio_tpu/ops/pallas_scan.py:82", err4, BOUND_K4, ms4, pms4,
           2 * L * T * 4, 9 * L * T, _chain_ms(T, 3), note=f" [{L}, {T}]")
    # ... and at path B's shape, [2, 4096]: one block of 2 lanes, where the
    # chain and the pipeline's fill and drain are all there is
    xb = dev_f32(rng.standard_normal((2, PATH_B_BLOCK)) * 0.1)
    stb = tuple(dev_f32(rng.standard_normal(2) * 0.01) for _ in range(4))
    yk, sk = cuda_scan.biquad_df1(xb, coef, stb)
    yp, sp = cuda_scan.biquad_df1_plain(xb, coef, stb)
    err4b = max(_max_err(yk, yp), *(_max_err(a, b) for a, b in zip(sk, sp)))
    ms4b = _time_ms(lambda: cuda_scan.biquad_df1(xb, coef, stb), 50)
    pms4b = _time_ms(lambda: cuda_scan.biquad_df1_plain(xb, coef, stb), 2)
    record("K4", "biquad_df1", "rodio_tpu_torch/csrc/biquad.cu",
           "rodio_tpu/ops/pallas_scan.py:82", err4b, BOUND_K4, ms4b, pms4b,
           2 * 2 * PATH_B_BLOCK * 4, 9 * 2 * PATH_B_BLOCK, _chain_ms(PATH_B_BLOCK, 3),
           note=f" [2, {PATH_B_BLOCK}] (path B)", path="config2")
    del xb, stb

    # K4's bf16 instance (the block behind a Bf16Boundary, path G'): the same
    # shapes, x and y bf16: 2 bytes in and 2 out a sample, the same chain
    for Lb, Tb, note, reps in ((L, T, f" [{L}, {T}] bf16", 20),
                               (2, PATH_B_BLOCK, f" [2, {PATH_B_BLOCK}] bf16 (path B's shape)",
                                50)):
        xh = dev_f32(rng.standard_normal((Lb, Tb)) * 0.1).to(torch.bfloat16)
        sth = tuple(dev_f32(rng.standard_normal(Lb) * 0.01) for _ in range(4))
        yk, sk = cuda_scan.biquad_df1(xh, coef, sth)
        yp, sp = cuda_scan.biquad_df1_plain(xh, coef, sth)
        errh = max(_max_err(yk.float(), yp.float()), *(_max_err(a, b) for a, b in zip(sk, sp)))
        msh = _time_ms(lambda: cuda_scan.biquad_df1(xh, coef, sth), reps)
        note += (f"; in a CUDA graph "
                 f"{warp_cycles.graph_ms(lambda: cuda_scan.biquad_df1(xh, coef, sth), reps):.4f} ms")
        pmsh = _time_ms(lambda: cuda_scan.biquad_df1_plain(xh, coef, sth), 2)
        record("K4bf", "biquad_df1 (bf16 block)", "rodio_tpu_torch/csrc/biquad.cu",
               "rodio_tpu/ops/pallas_scan.py:82", errh, BOUND_K4BF, msh, pmsh,
               2 * Lb * Tb * 2, 9 * Lb * Tb, _chain_ms(Tb, 3), note=note,
               path="flagship_bf16")
    del xh, sth

    # the generators' phase accumulator (rodio_compat=True) at path H's
    # block: one generator, 1024 steps of FADD, FRND, FADD on one thread
    p0h, steph = dev_f32([0.25]), dev_f32([np.float32(440.0) / np.float32(48000.0)])
    pk, ck = phase.phase_accumulate(p0h, steph, PATH_H_BLOCK)
    pp, cp = phase.phase_accumulate_plain(p0h, steph, PATH_H_BLOCK)
    errp = max(_max_err(pk, pp), _max_err(ck, cp))
    msp = _time_ms(lambda: phase.phase_accumulate(p0h, steph, PATH_H_BLOCK), 50)
    gmsp = warp_cycles.graph_ms(lambda: phase.phase_accumulate(p0h, steph, PATH_H_BLOCK), 50)
    pmsp = _time_ms(lambda: phase.phase_accumulate_plain(p0h, steph, PATH_H_BLOCK), 2)
    record("phase", "phase_accumulate", "rodio_tpu_torch/csrc/phase.cu",
           "rodio_tpu/sources/generators.py:106", errp, BOUND_PHASE, msp, pmsp,
           PATH_H_BLOCK * 4 + 12, 3 * PATH_H_BLOCK, _chain_ms(PATH_H_BLOCK, 3),
           note=f" [1, {PATH_H_BLOCK}] (a lax.scan, no pallas_call); in a CUDA graph "
                f"{gmsp:.4f} ms (eager: the wrapper's host time)", path="config4_scene")

    # K3: the master limiter over [2, 12800], P = 128, loud enough to limit;
    # per sample ~60 ops (the dB gain computer, two envelopes, exp2); its
    # chain: n/P + log2 P steps of the integrator (3 ops) then the peak (2)
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32), device=dev),
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
    record("K3", "limiter_master", "rodio_tpu_torch/csrc/limiter_block.cu",
           "rodio_tpu/ops/limiter_block.py:175", err3, BOUND_K3, ms3, pms3,
           2 * 2 * T * 4, 60 * 2 * T, _chain_ms(T // 128 + 7, 5),
           note=f" [2, {T}] P=128")

    # K1: 512 stereo streams, one block of 12800 frames at 44.1 -> 48 kHz;
    # it reads the block's PCM rows once (K9's stream); per sample the lerp
    # (3), the gain, the biquad (9) and the mix; chain: the biquad's
    fr, to = 147, 160
    F = (T // to + 4) * fr * 3
    pcm = dev_f32(rng.standard_normal((F, L)) * 0.1)
    gains = dev_f32(np.repeat(rng.uniform(0.5, 1.5, N_STREAMS) / N_STREAMS, 2))
    bq = dev_f32(rng.standard_normal((4, L)) * 0.001)
    kw1 = dict(gains=gains, coeffs=coef, bq=bq, channels=2)
    left, phase = output_positions(3 * to, T, fr, to, dev)
    wts = dev_f32(np.stack(lerp_weights(fr, to), axis=1))[phase]
    rows_read, tile_rows = dma_roofline.k1_stream(T, fr, to)
    pcm_bytes = rows_read * L * 4 + T * (8 + 8)  # rows, left, weights
    mk, bk = fused.fused_resample_biquad_mix(pcm, left, wts, **kw1)
    mp, bp = fused.fused_resample_biquad_mix_plain(pcm, left, wts, **kw1)
    err1 = max(_max_err(mk, mp), _max_err(bk, bp))
    ms1 = _time_ms(lambda: fused.fused_resample_biquad_mix(pcm, left, wts, **kw1), 20)
    pms1 = _time_ms(lambda: fused.fused_resample_biquad_mix_plain(pcm, left, wts, **kw1), 2)
    record("K1", "fused_resample_biquad_mix", "rodio_tpu_torch/csrc/fused.cu",
           "rodio_tpu/ops/fused.py:1841", err1, BOUND_K1, ms1, pms1,
           pcm_bytes + 2 * T * 4, 14 * L * T, _chain_ms(T, 3),
           note=f" 512x2 streams, n={T}")
    # the mix where it is largest against its rounding: gains of unit scale
    # (U(0.1, 1) a lane, no 1/S), so 512 streams sum to a mix of ~0.3 rms;
    # the sum over blocks is where the kernel's order differs from the plain
    rng_u = np.random.default_rng(SEED + 1)
    kw1u = dict(kw1, gains=dev_f32(rng_u.uniform(0.1, 1.0, L)))
    left_u, phase_u = output_positions(to, 1280, fr, to, dev)
    wts_u = dev_f32(np.stack(lerp_weights(fr, to), axis=1))[phase_u]
    mku, bku = fused.fused_resample_biquad_mix(pcm, left_u, wts_u, **kw1u)
    mpu, bpu = fused.fused_resample_biquad_mix_plain(pcm, left_u, wts_u, **kw1u)
    err1u = _max_err(mku, mpu)
    print(f"K1 at gains of unit scale (512x2 streams, n=1280): mix max|d| {err1u:.3e}, "
          f"peak |mix| {mpu.abs().max().item():.3f} (bound {BOUND_K1}) {tag}")
    if not (err1u <= BOUND_K1 and torch.equal(bku, bpu)):
        raise AssertionError(f"K1 at unit-scale gains: mix max|d| {err1u}, carries "
                             f"equal {torch.equal(bku, bpu)}")

    # K1's ring mode (the farm's FusedFarmPipeline, path P): the same block
    # over the farm's ring of (4 Kp + 1) * fr rows, read modulo its rows, at
    # a start (chunk 241) whose last tile's staged rows and last right tap
    # cross the seam; the bytes and operations are K1's
    ring_rows = (4 * (T // to) + 1) * fr
    ring = dev_f32(rng.standard_normal((ring_rows, L)) * 0.1)
    c0r = ring_rows // fr - T // to
    left_r, phase_r = output_positions(c0r * to, T, fr, to, dev)
    wts_r = dev_f32(np.stack(lerp_weights(fr, to), axis=1))[phase_r]
    if not int(left_r[-1]) + 1 == ring_rows:
        raise AssertionError("K1 ring mode: the block's last right tap does not cross the seam")
    kw1r = dict(kw1, ring=True)
    mk, bk = fused.fused_resample_biquad_mix(ring, left_r, wts_r, **kw1r)
    mp, bp = fused.fused_resample_biquad_mix_plain(ring, left_r, wts_r, **kw1r)
    err1r = max(_max_err(mk, mp), _max_err(bk, bp))
    ms1r = _time_ms(lambda: fused.fused_resample_biquad_mix(ring, left_r, wts_r, **kw1r), 20)
    gms1r = warp_cycles.graph_ms(
        lambda: fused.fused_resample_biquad_mix(ring, left_r, wts_r, **kw1r), 20)
    pms1r = _time_ms(lambda: fused.fused_resample_biquad_mix_plain(ring, left_r, wts_r,
                                                                   **kw1r), 2)
    record("K1r", "fused_resample_biquad_mix (ring mode)", "rodio_tpu_torch/csrc/fused.cu",
           "rodio_tpu/ops/fused.py:1912", err1r, BOUND_K1, ms1r, pms1r,
           pcm_bytes + 2 * T * 4, 14 * L * T, _chain_ms(T, 3),
           note=f" 512x2 streams, n={T}, a ring of {ring_rows} rows, chunk {c0r} (the "
                f"seam in its last tile); in a CUDA graph {gms1r:.4f} ms", path="farm_fused")
    del ring

    # K2: the same block with the AGC, the ring warm: every row holds a
    # square that leaves the window, and each stream's window sum is theirs;
    # ~40 ops a sample; chain: the smoother's 5 ops per interleaved sample
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
    record("K2", "fused_resample_biquad_agc_mix", "rodio_tpu_torch/csrc/fused_agc.cu",
           "rodio_tpu/ops/fused.py:1957", err2, BOUND_K2, ms2, pms2,
           pcm_bytes + 2 * ring.numel() * 2 + 2 * T * 4, 40 * L * T,
           _chain_ms(2 * T, 5), note=f" 512x2 streams, n={T}, bf16 ring")

    # K2r and K2b: K2's rel0 plans at path E's shape, with AgcSettings()'s
    # parameters at 48 kHz (release coefficient 0.0), a block starting on
    # the 320-frame grid step (o0 = 640), the ring warm in the plan's basis
    # (rel0: one square per lane; else the packed basis, whose hi lane the
    # window sum follows); bytes as K2's; ~35 ops a sample (K2r), ~45 (K2b)
    st0 = AutomaticGainControl(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32),
                                             device="cpu"), AgcSettings())
    params0 = dev_f32((st0.attack_coeff, st0.release_coeff) + AGC_PARAMS[2:])
    if st0.release_coeff != 0.0:
        raise AssertionError(f"AgcSettings() release coefficient {st0.release_coeff}")
    left0, phase0 = output_positions(4 * to, T, fr, to, dev)
    wts0 = dev_f32(np.stack(lerp_weights(fr, to), axis=1))[phase0]
    lo = rng.uniform(0.0, 0.01, (4096, N_STREAMS))
    packed = np.stack([lo, lo + rng.uniform(0.0, 0.01, (4096, N_STREAMS))], 2)
    rel0_rings = {"rel0": dev_f32(rng.uniform(0.0, 0.01, (4096, L))).to(torch.bfloat16),
                  "packed": dev_f32(packed.reshape(4096, L)).to(torch.bfloat16)}
    rel0_res = {}
    for plan in ("rel0", "rel0f", "rel0b16", "rel0c16"):
        ring0 = rel0_rings["rel0" if plan == "rel0" else "packed"]
        r3 = ring0.float().reshape(4096, N_STREAMS, 2)
        rs0 = r3.sum((0, 2)) if plan == "rel0" else r3[:, :, 1].sum(0)
        agc0r = torch.stack([rs0, dev_f32(rng.uniform(0, 0.3, N_STREAMS)),
                             dev_f32(rng.uniform(1, 3, N_STREAMS))])
        kwr = dict(kw2, agc=agc0r, agc_params=params0, ring=ring0, ring_row=640,
                   agc_plan=plan, step_frames=2 * to)
        outk = fused.fused_resample_biquad_agc_mix(pcm, left0, wts0, **kwr)
        outp = fused.fused_resample_biquad_agc_mix_plain(pcm, left0, wts0, **kwr)
        state_err = max(_max_err(a.float(), b.float()) for a, b in zip(outk[1:], outp[1:]))
        if state_err != 0.0:
            raise AssertionError(f"{plan}: carries and ring differ from the plain version "
                                 f"by {state_err}")
        ms_r = _time_ms(lambda: fused.fused_resample_biquad_agc_mix(pcm, left0, wts0, **kwr), 20)
        rel0_res[plan] = (_max_err(outk[0], outp[0]), ms_r, kwr)
    for kid, plan, other, src, ops, chain in (
            ("K2r", "rel0f", "rel0", "rodio_tpu_torch/csrc/fused_agc.cu", 35,
             _chain_ms(2 * T, 4)),
            ("K2b", "rel0b16", "rel0c16", "rodio_tpu_torch/csrc/fused_agc_blocked.cu", 45,
             _chain_ms(T, 3))):
        err_r, ms_r, kwr = rel0_res[plan]
        pms_r = _time_ms(lambda: fused.fused_resample_biquad_agc_mix_plain(
            pcm, left0, wts0, **kwr), 1)
        record(kid, f"fused_resample_biquad_agc_mix (agc_plan={plan})", src,
               "rodio_tpu/ops/fused.py:1957", max(err_r, rel0_res[other][0]), BOUND_K2,
               ms_r, pms_r, pcm_bytes + 2 * ring.numel() * 2 + 2 * T * 4, ops * L * T,
               chain, note=f" 512x2 streams, n={T}, bf16 ring; carries and ring "
                           f"max|d| 0.0; {other}: kernel {rel0_res[other][1]:.4f} ms, "
                           f"the same checks")
    del left0, wts0, rel0_rings, rel0_res, kwr, outk, outp

    # K2g: K2's group branch at path D's shape, the group ring warm; ~19
    # ops a sample; chains: the biquad's per frame, rs/pk and the smoother
    # per group
    grows = 4096 // AGC_GROUP
    gring = dev_f32(rng.uniform(0.0, 0.01 * AGC_GROUP, (grows, N_STREAMS))).to(torch.bfloat16)
    agcg = torch.stack([gring.float().sum(0), dev_f32(rng.uniform(0, 0.3, N_STREAMS)),
                        dev_f32(rng.uniform(1, 3, N_STREAMS))])
    kwg = dict(kw2, agc=agcg, ring=gring, ring_row=77, agc_group=AGC_GROUP)
    outk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kwg)
    outp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kwg)
    errg_state = max(_max_err(a.float(), b.float()) for a, b in zip(outk[1:], outp[1:]))
    if errg_state != 0.0:
        raise AssertionError(f"K2g: carries and ring differ from the plain version "
                             f"by {errg_state}")
    errg = _max_err(outk[0], outp[0])
    # and a group of 128 frames, over two of the kernel's tiles (the JAX
    # package admits it at 22.05 -> 48 kHz), its ring cold
    zeros = torch.zeros(N_STREAMS, device=dev)
    kwl = dict(kwg, agc=torch.stack([zeros, zeros, zeros + 1.0]), agc_group=128,
               ring=torch.zeros((32, N_STREAMS), dtype=torch.bfloat16, device=dev),
               ring_row=5)
    outk = fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kwl)
    outp = fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kwl)
    errl_state = max(_max_err(a.float(), b.float()) for a, b in zip(outk[1:], outp[1:]))
    if errl_state != 0.0:
        raise AssertionError(f"K2g (agc_group=128): carries and ring differ from the "
                             f"plain version by {errl_state}")
    errg = max(errg, _max_err(outk[0], outp[0]))
    msg = _time_ms(lambda: fused.fused_resample_biquad_agc_mix(pcm, left, wts, **kwg), 20)
    pmsg = _time_ms(lambda: fused.fused_resample_biquad_agc_mix_plain(pcm, left, wts, **kwg), 2)
    record("K2g", "fused_resample_biquad_agc_mix (agc_group)",
           "rodio_tpu_torch/csrc/fused_agc_group.cu", "rodio_tpu/ops/fused.py:1957",
           errg, BOUND_K2, msg, pmsg, pcm_bytes + 2 * gring.numel() * 2 + 2 * T * 4,
           19 * L * T, max(_chain_ms(T, 3), _chain_ms(T // AGC_GROUP, 5)),
           note=f" 512x2 streams, n={T}, agc_group={AGC_GROUP}, bf16 ring; "
                f"carries and ring max|d| {errg_state}; the mix's max|d| and "
                f"carries and ring at agc_group=128 too")
    del x, ring, outk, outp, gring

    # K6: the AGC loop over [512, 25600] interleaved samples; ~24 ops a
    # step; chain: the smoother's 5
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
    record("K6", "agc", "rodio_tpu_torch/csrc/agc.cu", "rodio_tpu/ops/pallas_scan.py:330",
           err6, BOUND_K6, ms6, pms6, 3 * N_STREAMS * M6 * 4, 24 * N_STREAMS * M6,
           _chain_ms(M6, 5), note=f" [{N_STREAMS}, {M6}]; the smoother's own chain "
                                   f"{M6 * smooth_s * 1e3:.4f} ms")
    del xs, sq, d6, gk, gp

    # K7: the smoother over [1, 8192] (path B's block) and [1, 512] (path B
    # with group=8), and the linear and max-affine ops at a small shape; ~10
    # ops a step, 5 on the chain
    des = dev_f32(rng.uniform(0.5, 7.0, (1, 8192)))
    des_g = dev_f32(np.random.default_rng(SEED + 5).uniform(0.5, 7.0, (1, 512)))
    g0 = dev_f32([1.0])
    p7 = params[[0, 1, 3]]
    err7 = max(_max_err(cuda_scan.first_order(d, d, g0, op="agc_gain", params=p7),
                        cuda_scan.first_order_plain(d, d, g0, op="agc_gain", params=p7))
               for d in (des, des_g))
    a7 = dev_f32(rng.uniform(0.9, 1.0, (8, 512)))
    b7 = dev_f32(rng.standard_normal((8, 512)))
    i7 = dev_f32(rng.standard_normal(8))
    for op in ("linear", "max_affine"):
        err7 = max(err7, _max_err(cuda_scan.first_order(a7, b7, i7, a7, op=op),
                                  cuda_scan.first_order_plain(a7, b7, i7, a7, op=op)))
    ms7 = _time_ms(lambda: cuda_scan.first_order(des, des, g0, op="agc_gain", params=p7), 50)
    ms7g = _time_ms(lambda: cuda_scan.first_order(des_g, des_g, g0, op="agc_gain",
                                                  params=p7), 50)
    pms7 = _time_ms(lambda: cuda_scan.first_order_plain(des, des, g0, op="agc_gain",
                                                        params=p7), 1)
    record("K7", "first_order", "rodio_tpu_torch/csrc/first_order.cu",
           "rodio_tpu/ops/pallas_scan.py:433", err7, BOUND_K7, ms7, pms7,
           2 * 8192 * 4, 10 * 8192, _chain_ms(8192, 5),
           note=f" agc_gain [1, 8192] (+ linear, max_affine [8, 512]), the smoother's own "
                f"chain {8192 * smooth_s * 1e3:.4f} ms; agc_gain [1, 512] (group=8): "
                f"{ms7g:.4f} ms, chain floor {_chain_ms(512, 5):.4f} ms")

    # K8: the peak detector over [1, 8192], P = 128, release as data; chain:
    # n/P + log2 P steps of 3 ops
    x8 = dev_f32(np.abs(rng.standard_normal((1, 8192)) * 0.3))
    v8, a8 = dev_f32([0.4]), params[1]
    err8 = _max_err(limiter_block.blocked_max_affine_const(x8, v8, a8, P=128),
                    limiter_block.blocked_max_affine_const_plain(x8, v8, a8, P=128))
    ms8 = _time_ms(lambda: limiter_block.blocked_max_affine_const(x8, v8, a8, P=128), 50)
    gms8 = warp_cycles.graph_ms(
        lambda: limiter_block.blocked_max_affine_const(x8, v8, a8, P=128), 50)
    pms8 = _time_ms(lambda: limiter_block.blocked_max_affine_const_plain(x8, v8, a8, P=128), 5)
    record("K8", "blocked_max_affine_const", "rodio_tpu_torch/csrc/bma.cu",
           "rodio_tpu/ops/limiter_block.py:293", err8, BOUND_K8, ms8, pms8,
           2 * 8192 * 4, 4 * 8192, _chain_ms(8192 // 128 + 7, 3),
           note=f" [1, 8192] P=128; in a CUDA graph {gms8:.4f} ms (eager: the "
                f"wrapper's host time)")

    # K5: the Limit node's per-stream pass (limiter_stream) at path C's
    # shape [1024, 12800] in stereo groups, and at ragged shapes in groups
    # of 1, 2 and 6 (lanes at quiet, limited and loud levels, carries in
    # dB); ~65 ops a sample (the gain computer's log2, the envelopes, the
    # coupling, the exp2), the integrator's chain mul, add, max. Beside it
    # limiter_env, the envelopes alone (7 ops a sample), at the same shapes
    lkw = dict(att=lim.attack, rel=lim.release)
    skw = dict(lkw, threshold=lim.threshold, knee_width=lim.knee_width,
               inv_knee_8=lim.inv_knee_8)
    err5 = err5e = 0.0
    for shape, cg in (((6, 700), 1), ((12, 129), 6), ((L, T), 2)):
        level = rng.choice([0.05, 0.6, 2.5], (shape[0], 1))
        x5 = dev_f32(rng.uniform(-1, 1, shape) * level)
        e0, q0 = dev_f32(rng.uniform(0, 6, shape[0])), dev_f32(rng.uniform(0, 6, shape[0]))
        yk5, ck5 = cuda_scan.limiter_stream(x5, e0, q0, group_channels=cg, **skw)
        yp5, cp5 = cuda_scan.limiter_stream_plain(x5, e0, q0, group_channels=cg, **skw)
        err5 = max(err5, _max_err(yk5, yp5), *(_max_err(a, b) for a, b in zip(ck5, cp5)))
        db = limiter_block.limiter_gain_db(x5, lim.threshold, lim.knee_width, lim.inv_knee_8)
        pk5, ck5 = cuda_scan.limiter_env(db, e0, q0, **lkw)
        pp5, cp5 = cuda_scan.limiter_env_plain(db, e0, q0, **lkw)
        err5e = max(err5e, _max_err(pk5, pp5), *(_max_err(a, b) for a, b in zip(ck5, cp5)))
    if not err5e <= BOUND_K5:
        raise AssertionError(f"K5 limiter_env: max|d| {err5e} exceeds {BOUND_K5}")
    ms5 = _time_ms(lambda: cuda_scan.limiter_stream(x5, e0, q0, group_channels=2, **skw), 20)
    ms5e = _time_ms(lambda: cuda_scan.limiter_env(db, e0, q0, **lkw), 20)
    pms5 = _time_ms(lambda: cuda_scan.limiter_stream_plain(x5, e0, q0, group_channels=2,
                                                           **skw), 1)
    record("K5", "limiter_stream", "rodio_tpu_torch/csrc/limiter_env.cu",
           "rodio_tpu/ops/pallas_scan.py:389", err5, BOUND_K5, ms5, pms5,
           2 * L * T * 4, 65 * L * T, _chain_ms(T, 3),
           note=f" [{L}, {T}] stereo groups (+ [6, 700] mono, [12, 129] groups of 6); "
                f"limiter_env (the envelopes alone) {ms5e:.4f} ms, max|d| {err5e:.3e}, "
                f"roofline {_bound(2 * L * T * 4, 7 * L * T)[0]:.4f} ms")
    del x5, db, yk5, yp5, pk5, pp5

    # K9: K1's block of PCM rows read at K1's geometry (8 lanes a block,
    # 128-frame tiles) through K9's TMA ring, L2-cold in a CUDA graph (the
    # calls rotate through copies of the buffer); beside it K1's own
    # cp.async route at depth 3, the contiguous stream (the card's read
    # ceiling) and clone() of the same buffer, timed the same way
    xk9 = dev_f32(rng.standard_normal((rows_read, L)))
    xs9 = dma_roofline.cold_copies(xk9)
    d9 = dma_roofline.K9_DEPTH
    want9 = dma_roofline.dma_ring_plain(xk9, tr=tile_rows)
    err9 = max(_max_err(dma_roofline.dma_ring(xk9, tr=tile_rows, depth=d9), want9),
               _max_err(dma_roofline.dma_ring(xk9, tr=tile_rows, depth=dma_roofline.K1_DEPTH,
                                              route="cp.async"), want9),
               _max_err(dma_roofline.stream_max(xk9), dma_roofline.stream_max_plain(
                   xk9, blocks=dma_roofline.stream_blocks(xk9))))
    pms9 = _time_ms(lambda: dma_roofline.dma_ring_plain(xk9, tr=tile_rows), 5)
    reset()
    ms9 = dma_roofline.time_ms_cold(
        lambda t: dma_roofline.dma_ring(t, tr=tile_rows, depth=d9), xk9, reps=20, copies=xs9)
    dma_run = counts()
    expect(dma_run, "K9 probe", K9=21)  # a call before the graph and 20 captured in it
    ms9k1 = dma_roofline.time_ms_cold(
        lambda t: dma_roofline.dma_ring(t, tr=tile_rows, depth=dma_roofline.K1_DEPTH,
                                        route="cp.async"), xk9, copies=xs9)
    ms9s = dma_roofline.time_ms_cold(dma_roofline.stream_max, xk9, copies=xs9)
    ms9c = dma_roofline.time_ms_cold(torch.clone, xk9, copies=xs9)
    nb9 = xk9.numel() * 4
    n_tiles9 = -(-rows_read // tile_rows)
    record("K9", "dma_ring", "rodio_tpu_torch/csrc/dma_roofline.cu",
           "benches/dma_roofline.py:83", err9, BOUND_K9, ms9, pms9, nb9 + L * 4,
           n_tiles9 * L, _chain_ms(n_tiles9, 1),
           note=f" [{rows_read}, {L}] f32, {dma_roofline.K1_LANES} lanes a block, tiles of "
           f"{tile_rows} rows, TMA ring depth {d9}, L2-cold in a CUDA graph: "
           f"{nb9 / ms9 / 1e6:.1f} GB/s; K1's cp.async route at depth "
           f"{dma_roofline.K1_DEPTH} {ms9k1:.4f} ms, {nb9 / ms9k1 / 1e6:.1f} GB/s; "
           f"contiguous stream {ms9s:.4f} ms, {nb9 / ms9s / 1e6:.1f} GB/s; clone "
           f"{ms9c:.4f} ms, {nb9 / ms9c / 1e6:.1f} GB/s read, {2 * nb9 / ms9c / 1e6:.1f} "
           f"GB/s moved")
    del xs9, xk9

    # threefry (no pallas_call: jax.random's threefry2x32, which XLA lowers
    # to integer ops; its bound counts the INT32 instructions the function
    # needs on this run's counters, _threefry_ops) at path K's block: a
    # block's uniform draws under fold_in(key, i), Velvet's cells and Pink's
    # 16 octaves; then 2^24 draws.
    # Bits and uniform draws equal to the plain version on the card, the
    # counter across the int32 wrap. Library: torch.rand of the same count
    # (Philox, not this function): a yardstick of a generator's rate
    key_t = threefry.seed_key(12, dev)
    i_t = 2 ** 31 - 1000
    ctr_t = torch.full((), i_t, dtype=torch.int64, device=dev)
    nbig = 1 << 24
    bits_k = threefry.threefry(key_t, ctr_t, nbig, "bits")
    bits_p = threefry.threefry_plain(key_t, ctr_t, nbig, "bits")
    if not torch.equal(bits_k.to(torch.int64) & threefry.M32, bits_p):
        raise AssertionError("threefry bits differ from the plain version")
    del bits_k, bits_p
    for label, n, kw in (("uniform", PATH_K_BLOCK, dict(lo=-1.0, hi=1.0)),
                         ("velvet", PATH_K_BLOCK, dict(grid=24)),
                         ("pink", PATH_K_BLOCK, {}),
                         ("uniform", nbig, dict(lo=-1.0, hi=1.0))):
        mode = label

        def call(mode=mode, n=n, kw=kw):
            return threefry.threefry(key_t, ctr_t, n, mode, **kw)

        errt = _max_err(call(), threefry.threefry_plain(key_t, ctr_t, n, mode, **kw))
        reps = 50 if n < nbig else 20
        mst = _time_ms(call, reps)
        gmst = warp_cycles.graph_ms(call, reps)
        pmst = _time_ms(lambda: threefry.threefry_plain(key_t, ctr_t, n, mode, **kw), 2)
        libt = _time_ms(lambda: torch.rand(n, device=dev), reps)
        record("threefry", f"threefry ({label}, {n} draws)", "rodio_tpu_torch/csrc/threefry.cu",
               "rodio_tpu/sources/noise.py:40 (jax.random, no pallas_call)", errt,
               BOUND_THREEFRY, mst, pmst, 4 * n + 24,
               _threefry_ops(mode, i_t, n, kw.get("grid", 1)), 0.0,
               library_ms=libt, path="noise", ops_per_s=INT32_OPS_S,
               note=f"; in a CUDA graph {gmst:.4f} ms; bits of {nbig} draws equal; library: "
                    f"torch.rand({n}) (Philox), a yardstick only")

    # K7's linear op at Brownian's and Red's shape, [1, 4096]: their leaky
    # integrator, 2 ops a step, both on the chain
    w7 = dev_f32(rng.uniform(-1, 1, (1, PATH_K_BLOCK)))
    leak7 = torch.full_like(w7, float(np.float32(1.0 - 2.0 * np.pi * 5.0 / 48000)))
    a07 = dev_f32([0.3])
    err7l = _max_err(cuda_scan.first_order(leak7, w7, a07, op="linear"),
                     cuda_scan.first_order_plain(leak7, w7, a07, op="linear"))
    ms7l = _time_ms(lambda: cuda_scan.first_order(leak7, w7, a07, op="linear"), 50)
    gms7l = warp_cycles.graph_ms(lambda: cuda_scan.first_order(leak7, w7, a07, op="linear"), 50)
    pms7l = _time_ms(lambda: cuda_scan.first_order_plain(leak7, w7, a07, op="linear"), 1)
    record("K7", "first_order (linear, Brownian/Red)", "rodio_tpu_torch/csrc/first_order.cu",
           "rodio_tpu/ops/pallas_scan.py:433", err7l, BOUND_K7, ms7l, pms7l,
           3 * PATH_K_BLOCK * 4, 2 * PATH_K_BLOCK, _chain_ms(PATH_K_BLOCK, 2), path="noise",
           note=f" linear [1, {PATH_K_BLOCK}]; in a CUDA graph {gms7l:.4f} ms")
    for r in results:
        if not r["max_abs_err"] <= r["bound_err"]:
            raise AssertionError(f"{r['kid']}: max|d| {r['max_abs_err']} exceeds "
                                 f"{r['bound_err']}")
    refs = start_references()

    # -- 4. the paths --------------------------------------------------------
    def check_output(out, valids, name, n_blocks, block):
        if tuple(out.shape) != (2, n_blocks * block) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} output {tuple(out.shape)} not finite "
                                 f"[2, {n_blocks * block}]")
        if not bool((valids == block).all()):
            raise AssertionError(f"{name} valid counts {valids.tolist()}")
        peak = float(out.abs().max().item())
        if not 0.0 < peak < 1.0:
            raise AssertionError(f"{name} output peak {peak} outside (0, 1)")
        return peak

    master, state = rtt.make_flagship(N_STREAMS, seconds=4.0, scan_mode="fused",
                                      device="cuda", max_block=T, seed=SEED)
    reset()
    torch.cuda.set_sync_debug_mode("error")  # emit must never wait for the card
    state, out, valids = rtt.render_blocks(master, state, N_BLOCKS, T)
    torch.cuda.set_sync_debug_mode("default")
    fused_run = counts()
    torch.cuda.synchronize()
    print(f"slice: fused render of {N_BLOCKS} x {T}: launches {fused_run}")
    expect(fused_run, "fused render", K1=N_BLOCKS, K3=N_BLOCKS)
    peak = check_output(out, valids, "slice", N_BLOCKS, T)

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
    apeak = check_output(aout, avalids, "path A", N_BLOCKS, T)
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
    aout2 = aout[:, :2 * T].clone()  # path D is held to these blocks
    del auout, agc_unfused, austate, aout

    # path B: BASELINE config 2 on 10 s of seeded stereo PCM at 44.1 kHz,
    # per-sample and group-rate smoother (profile_slice.config2)
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
        cnode = config2("cpu", group)
        _, cout, _ = rtt.render_blocks(cnode, cnode.init_state(), 2, PATH_B_BLOCK)
        err_b = _max_err(bout[:, :2 * PATH_B_BLOCK].cpu(), cout)
        print(f"path B (group={group}): card vs CPU, 2 blocks: max|d| {err_b:.3e} "
              f"(bound {BOUND_B})")
        if not err_b <= BOUND_B:
            raise AssertionError(f"path B card vs CPU {err_b} exceeds {BOUND_B}")
        path_b_runs[group] = run

    # path C: the per-stream chain of tests/test_parallel.py:106-117 with
    # the TPU dispatch of each node ("pallas"), BASELINE config 5's 512
    # streams on 4 s of seeded PCM, then the master limiter
    def path_c(device, S):
        return rtt.make_per_stream_chain(S, seed=SEED + 3, device=device)[0]

    path_c_node = path_c("cuda", N_STREAMS)
    reset()
    _, cout, cvalids = rtt.render_blocks(path_c_node, path_c_node.init_state(), N_BLOCKS, T)
    path_c_run = counts()
    torch.cuda.synchronize()
    print(f"path C: per-stream chain render of {N_BLOCKS} x {T}: launches {path_c_run}")
    expect(path_c_run, "path C", K3=N_BLOCKS, K4=N_BLOCKS, K5=N_BLOCKS, K6=N_BLOCKS)
    cpeak = check_output(cout, cvalids, "path C", N_BLOCKS, T)
    del cout
    S16 = PATH_C_CHECK_STREAMS
    outs = []
    for device in ("cuda", "cpu"):
        node = path_c(device, S16)
        _, o, _ = rtt.render_blocks(node, node.init_state(), 2, T)
        outs.append(o.cpu())
    err_c = _max_err(*outs)
    print(f"path C: {S16} streams, card vs CPU, 2 blocks: max|d| {err_c:.3e} "
          f"(bound {BOUND_B}); output peak {cpeak:.4f}")
    if not err_c <= BOUND_B:
        raise AssertionError(f"path C card vs CPU {err_c} exceeds {BOUND_B}")
    path_c_limits = {}
    for label, channels, n in (("mono", 1, T), ("P=2", 2, 4410)):
        data = (np.random.default_rng(SEED + 4).uniform(-1, 1, (channels, 3 * n))
                * 2.0).astype(np.float32)
        res = []
        reset()
        for device in ("cuda", "cpu"):
            node = Limit(SamplesBuffer(channels, 48000, data, device=device),
                         LimitSettings(), mode="pallas")
            st, o, _ = rtt.render_blocks(node, node.init_state(), 3, n)
            res.append((o.cpu(), st["integ"].cpu(), st["peak"].cpu()))
        run = counts()
        expect(run, f"Limit ({label})", K5=3)
        err_o = _max_err(res[0][0], res[1][0])
        err_e = max(_max_err(res[0][1], res[1][1]), _max_err(res[0][2], res[1][2]))
        print(f"path C: Limit ({label}, blocks of {n}): card vs CPU, 3 blocks: output "
              f"max|d| {err_o:.3e} (bound {BOUND_B}), envelope carries {err_e:.3e} "
              f"(bound 0.0); launches {run}")
        if not (err_o <= BOUND_B and err_e == 0.0):
            raise AssertionError(f"Limit ({label}) card vs CPU {err_o}, {err_e}")
        path_c_limits[label] = run

    # path D: the group-rate fused AGC, K2g then K3 per block
    grp_master, gstate = rtt.make_flagship(
        N_STREAMS, seconds=4.0, scan_mode="fused", with_agc=True,
        agc_group=AGC_GROUP, device="cuda", max_block=T, seed=SEED)
    reset()
    torch.cuda.set_sync_debug_mode("error")
    _, dout, dvalids = rtt.render_blocks(grp_master, gstate, N_BLOCKS, T)
    torch.cuda.set_sync_debug_mode("default")
    path_d_run = counts()
    torch.cuda.synchronize()
    print(f"path D: fused group AGC (agc_group={AGC_GROUP}) render of {N_BLOCKS} x {T}: "
          f"launches {path_d_run}")
    expect(path_d_run, "path D", K2g=N_BLOCKS, K3=N_BLOCKS)
    dpeak = check_output(dout, dvalids, "path D", N_BLOCKS, T)
    rel_d = float(((dout[:, :2 * T] - aout2).abs() / (aout2.abs() + 1e-6)).max().item())
    print(f"path D vs path A, 2 blocks: max relative |d| {rel_d:.3e} "
          f"(bound {BOUND_D_REL}); output peak {dpeak:.4f}")
    if not rel_d < BOUND_D_REL:
        raise AssertionError(f"path D vs path A {rel_d} exceeds {BOUND_D_REL}")
    del dout

    # path E: the JAX package's AGC-on bench leg (bench.py's agc_on), K2b
    # then K3 per block; path E': the same with rel0f (K2r)
    def rel0_master(plan):
        return rtt.make_flagship(
            N_STREAMS, seconds=4.0, scan_mode="fused", with_agc=True, agc_plan=plan,
            precision="int2", device="cuda", max_block=T, seed=SEED)

    rel0_masters, rel0_runs = {}, {}
    for label, plan, n_blocks, kid, bound in (("path E", "rel0b16", N_BLOCKS, "K2b", BOUND_E),
                                              ("path E'", "rel0f", 2, "K2r", BOUND_E2)):
        node, est = rel0_master(plan)
        reset()
        torch.cuda.set_sync_debug_mode("error")
        _, eout, evalids = rtt.render_blocks(node, est, n_blocks, T)
        torch.cuda.set_sync_debug_mode("default")
        run = counts()
        torch.cuda.synchronize()
        print(f"{label}: fused AGC (agc_plan={plan}, precision=int2) render of {n_blocks} "
              f"x {T}: launches {run}")
        expect(run, label, **{kid: n_blocks, "K3": n_blocks})
        epeak = check_output(eout, evalids, label, n_blocks, T)
        err_e = _max_err(eout[:, :2 * T], aout2)
        print(f"{label} vs path A, 2 blocks: max|d| {err_e:.3e} (bound {bound}); output "
              f"peak {epeak:.4f}")
        if not err_e <= bound:
            raise AssertionError(f"{label} vs path A {err_e} exceeds {bound}")
        rel0_masters[label], rel0_runs[plan] = node, run
        del eout
    del aout2

    # path F: BASELINE config 1 at a real length, 180 s of seeded 16-bit
    # stereo at 44.1 kHz through Uniform(rodio_compat=True): the span path
    # (the phase re-bootstraps every 16384 frames); no kernel of ours runs
    def path_f_node(device):
        return config1(device, PATH_F_SECONDS, seed=SEED + 6)

    path_f = path_f_node("cuda")
    nf = -(-path_f.total_frames() // PATH_F_BLOCK) + 1  # through the end
    fstate = path_f.init_state()
    reset()
    torch.cuda.set_sync_debug_mode("error")
    _, fout, fvalids = rtt.render_blocks(path_f, fstate, nf, PATH_F_BLOCK)
    torch.cuda.set_sync_debug_mode("default")
    path_f_run = counts()
    expect(path_f_run, "path F")
    cnode = path_f_node("cpu")
    _, fcpu, fcvalids = rtt.render_blocks(cnode, cnode.init_state(), nf, PATH_F_BLOCK)
    nvf = int(fvalids.sum().item())
    err_f = _max_err(fout.cpu(), fcpu)
    print(f"path F (config 1, {PATH_F_SECONDS} s, Uniform rodio_compat, span path): "
          f"{nf} x {PATH_F_BLOCK}, {nvf} valid frames; card vs CPU, the whole render: "
          f"max|d| {err_f:.3e} (bound {BOUND_B}); launches {path_f_run}")
    if not (nvf == path_f.total_frames() and torch.equal(fvalids.cpu(), fcvalids)
            and bool(torch.isfinite(fout).all()) and err_f <= BOUND_B):
        raise AssertionError(f"path F: valid {nvf} of {path_f.total_frames()}, "
                             f"card vs CPU {err_f}")
    del fout, fcpu, cnode

    # path G: config 5's unfused chain with the per-channel gains applied
    # before the resampler, so its upstream is not random-access (a
    # decoder's will not be): the streaming ring path, then K4, the mix and
    # K3, at full width, under sync-debug "error"
    def path_g_node(device):
        return ring_chain(device, N_STREAMS, T, seed=SEED + 7)

    path_g = path_g_node("cuda")
    gstate = path_g.init_state()
    reset()
    torch.cuda.set_sync_debug_mode("error")
    _, gout, gvalids = rtt.render_blocks(path_g, gstate, N_BLOCKS, T)
    torch.cuda.set_sync_debug_mode("default")
    path_g_run = counts()
    torch.cuda.synchronize()
    print(f"path G: the ring resampler's chain, {N_BLOCKS} x {T}: launches {path_g_run}")
    expect(path_g_run, "path G", K3=N_BLOCKS, K4=N_BLOCKS)
    gpeak = check_output(gout, gvalids, "path G", N_BLOCKS, T)
    cnode = path_g_node("cpu")
    _, gcpu, _ = rtt.render_blocks(cnode, cnode.init_state(), 2, T)
    err_g = _max_err(gout[:, :2 * T].cpu(), gcpu)
    print(f"path G: card vs CPU, 2 blocks: max|d| {err_g:.3e} (bound {BOUND_B}); output "
          f"peak {gpeak:.4f}")
    if not err_g <= BOUND_B:
        raise AssertionError(f"path G card vs CPU {err_g} exceeds {BOUND_B}")
    del gout, gcpu, cnode

    # path G': the unfused chain with bf16 blocks (make_flagship's
    # block_bf16): K4's bf16 instance and K3 once a block
    def bf16_chain(device):
        return rtt.make_flagship(N_STREAMS, seconds=4.0, scan_mode="pallas",
                                 block_bf16=True, device=device, max_block=T, seed=SEED)[0]

    path_gb = bf16_chain("cuda")
    reset()
    _, hout, hvalids = rtt.render_blocks(path_gb, path_gb.init_state(), N_BLOCKS, T)
    path_gb_run = counts()
    torch.cuda.synchronize()
    print(f"path G': the bf16-block chain, {N_BLOCKS} x {T}: launches {path_gb_run}")
    expect(path_gb_run, "path G'", K3=N_BLOCKS, K4bf=N_BLOCKS)
    hpeak = check_output(hout, hvalids, "path G'", N_BLOCKS, T)
    cnode = bf16_chain("cpu")
    _, hcpu, _ = rtt.render_blocks(cnode, cnode.init_state(), 2, T)
    dh = (hout[:, :2 * T].cpu() - hcpu).abs()
    flips = int((dh > BOUND_B).sum().item())
    err_gb = float(dh.max().item())
    f32_chain = rtt.make_flagship(N_STREAMS, seconds=4.0, scan_mode="pallas",
                                  device="cuda", max_block=T, seed=SEED)[0]
    _, f32out, _ = rtt.render_blocks(f32_chain, f32_chain.init_state(), 2, T)
    rel_gb = _max_err(hout[:, :2 * T], f32out) / float(f32out.abs().max().item())
    print(f"path G': card vs CPU, 2 blocks: max|d| {err_gb:.3e}, {flips} samples past "
          f"{BOUND_B} (bf16 rounding flips); against the f32 chain: max relative |d| "
          f"{rel_gb:.3e} (bound {BOUND_BF16_REL}); output peak {hpeak:.4f}")
    if not (rel_gb < BOUND_BF16_REL and err_gb <= 2 ** -7 * hpeak):
        raise AssertionError(f"path G': card vs CPU {err_gb}, vs f32 {rel_gb}")
    del hout, hcpu, cnode, f32_chain, f32out

    # path H: BASELINE config 4: the parity case of tools/parity_tpu.py
    # (config4) and the scene of tests/test_baseline_configs.py without the
    # control plane, each a whole render on the card against the CPU
    path_h_runs, path_h_nodes = {}, {}
    for label, build, emits in (("config4_parity", config4_parity, 1),
                                ("config4_scene", config4_scene, 2)):
        node = build("cuda")
        nh = -(-node.total_frames() // PATH_H_BLOCK)
        reset()
        _, hcard, hv = rtt.render_blocks(node, node.init_state(), nh, PATH_H_BLOCK)
        run = counts()
        torch.cuda.synchronize()
        expect(run, label, phase=emits * nh)  # the sine emits once a branch a block
        cnode = build("cpu")
        _, hc, hcv = rtt.render_blocks(cnode, cnode.init_state(), nh, PATH_H_BLOCK)
        err_h = _max_err(hcard.cpu(), hc)
        ok = (int(hv.sum().item()) == node.total_frames() and torch.equal(hv.cpu(), hcv)
              and bool(torch.isfinite(hcard).all()) and float(hcard.abs().max()) > 0.0)
        print(f"path H ({label}): {nh} x {PATH_H_BLOCK}, {int(hv.sum().item())} frames; "
              f"card vs CPU: max|d| {err_h:.3e} (bound {BOUND_B}); launches {run}")
        if not (ok and err_h <= BOUND_B):
            raise AssertionError(f"path H ({label}): card vs CPU {err_h}, valid ok {ok}")
        path_h_runs[label], path_h_nodes[label] = run, (node, nh)

    # path I: BASELINE config 3 at full width, 64 sources into mixer(2,
    # 48000), taken for 10 s and pulled in blocks of 2048 to the end (the
    # mixer reads its members' valids back once a block); 60 generators with
    # rodio_compat, so the phase kernel runs once a generator a pull
    _, rx3 = config3("cuda", PATH_I_SECONDS)
    reset()
    blocks3, pulls3 = pull_to_end(rx3, PATH_I_BLOCK)
    torch.cuda.synchronize()
    path_i_run = counts()
    expect(path_i_run, "path I", phase=60 * pulls3)
    out3 = torch.cat(blocks3, dim=1)
    want3, cpu_pulls3 = refs["I"].get()
    err_i = _max_err(out3.cpu(), torch.from_numpy(want3))
    n3 = out3.shape[1]
    print(f"path I (config 3, 64 sources, {PATH_I_SECONDS} s, blocks of {PATH_I_BLOCK}): "
          f"{pulls3} pulls, {n3} frames; card vs CPU, the whole render: max|d| {err_i:.3e} "
          f"(bound {BOUND_B}); peak {float(out3.abs().max()):.4f}; launches {path_i_run}")
    if not (pulls3 == cpu_pulls3 and tuple(want3.shape) == tuple(out3.shape)
            and n3 >= PATH_I_SECONDS * 48000 and bool(torch.isfinite(out3).all())
            and err_i <= BOUND_B):
        raise AssertionError(f"path I: {pulls3} vs {cpu_pulls3} pulls, shapes "
                             f"{tuple(out3.shape)} {want3.shape}, card vs CPU {err_i}")
    del blocks3

    # path K, dither: path I's CPU render dithered to 16 bits by each
    # algorithm, on the card and on the CPU (the same input): threefry once
    # a block
    dither_runs = {}
    for algo in ("tpdf", "rpdf", "gpdf", "highpass"):
        outs = []
        for device in ("cuda", "cpu"):
            node = Dither(SamplesBuffer(2, 48000, want3, device=device), 16, algo, seed=3)
            nd = -(-want3.shape[1] // PATH_I_BLOCK)
            reset()
            _, o, _ = rtt.render_blocks(node, node.init_state(), nd, PATH_I_BLOCK)
            if device == "cuda":
                torch.cuda.synchronize()
                dither_runs[algo] = counts()
                expect(dither_runs[algo], f"dither {algo}", threefry=nd)
            outs.append(o.cpu())
        err_d = _max_err(*outs)
        bound_d = 4 * 2.0 ** -21 * 2.0 ** -15 + 2.0 ** -24 if algo == "gpdf" else 0.0
        print(f"path K: Dither({algo}, 16 bits) of path I's render, card vs CPU: max|d| "
              f"{err_d:.3e} (bound {bound_d:.3e}); launches {dither_runs[algo]}")
        if not err_d <= bound_d:
            raise AssertionError(f"dither {algo}: card vs CPU {err_d} exceeds {bound_d}")
    del out3

    # path K: the nine noise sources, 10 s each in blocks of 4096, card
    # against CPU; threefry once a block (Brownian and Red: and K7)
    nk = -(-PATH_K_SECONDS * 48000 // PATH_K_BLOCK)
    want_k = refs["K"].get()
    noise_runs = {}
    for name in NOISE:
        node = noise_source(name, "cuda")
        reset()
        _, ok_, vk = rtt.render_blocks(node, node.init_state(), nk, PATH_K_BLOCK)
        torch.cuda.synchronize()
        noise_runs[name] = counts()
        integrated = name in ("Brownian", "Red")
        expect(noise_runs[name], name, threefry=nk, **({"K7": nk} if integrated else {}))
        err_k = _max_err(ok_.cpu(), torch.from_numpy(want_k[name]))
        bound_k = {"WhiteGaussian": BOUND_GAUSS, "Brownian": BOUND_BROWN}.get(name, 0.0)
        print(f"path K: {name}, {nk} x {PATH_K_BLOCK}: card vs CPU max|d| {err_k:.3e} "
              f"(bound {bound_k}); launches {noise_runs[name]}")
        if not (err_k <= bound_k and int(vk.sum()) == nk * PATH_K_BLOCK):
            raise AssertionError(f"path K {name}: card vs CPU {err_k} exceeds {bound_k}")
    path_k_run = {k: sum(r[k] for r in noise_runs.values()) for k in noise_runs["Pink"]}

    # path J: the player script (profile_slice.player_script) in blocks of
    # 256: volume, pause and play, live speed (VariSpeed), seek to 20 s,
    # skip to the sine; the whole output against the CPU's
    reset()
    out_j = player_script("cuda", PATH_J_BLOCKS)
    torch.cuda.synchronize()
    path_j_run = counts()
    want_j = refs["J"].get()
    err_j = _max_err(out_j.cpu(), torch.from_numpy(want_j))
    print(f"path J (the player, {PATH_J_BLOCKS} x 256): card vs CPU, the whole output: "
          f"max|d| {err_j:.3e} (bound {BOUND_B}); peak {float(out_j.abs().max()):.4f}; "
          f"launches {path_j_run}")
    if not (err_j <= BOUND_B and path_j_run["phase"] > 0
            and float(out_j.abs().max()) > 0.1):
        raise AssertionError(f"path J: card vs CPU {err_j}, launches {path_j_run}")
    del out_j

    # path L: seek on path B's chain over 600 s: to 300 s and to 60 s, the
    # same replayed blocks (O(pre-roll)); the render after the seek against
    # the CPU's (the replay runs K4 at [2, 8192], K7 and K8 at [1, 16384]);
    # then a checkpoint mid-render, loaded back on the card, continues
    # bit-equal. The CPU references are all in before the seek is timed
    want_l, cpu_replay_l = refs["L"].get()
    node_l = config2("cuda", 0, seconds=PATH_L_SECONDS)
    seek_state(node_l, 1.0)  # warm-up
    seeks = {}
    for target in PATH_L_TARGETS:
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_l = seek_state(node_l, target)
        torch.cuda.synchronize()
        seeks[target] = (time.perf_counter() - t0, seek.replayed_blocks, counts())
    sec_l, replay_l, path_l_run = seeks[PATH_L_TARGETS[0]]
    st_l = seek_state(node_l, PATH_L_TARGETS[0])
    expect(path_l_run, "path L", **{k: replay_l for k in ("K3", "K4", "K7", "K8")})
    if seeks[PATH_L_TARGETS[1]][1] != replay_l:
        raise AssertionError(f"path L: replayed blocks {seeks}")
    st_l, head_l, _ = rtt.render_blocks(node_l, st_l, 3, PATH_L_BLOCK)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "path_l.npz")
        save_state(ckpt, st_l, metadata={"seconds": PATH_L_TARGETS[0]})
        st_l2 = load_state(ckpt, node_l.init_state())
    on_card = all(t.device.type == "cuda" for t in _tensors(st_l2))
    _, cont_a, _ = rtt.render_blocks(node_l, st_l, PATH_L_CONT - 3, PATH_L_BLOCK)
    _, cont_b, _ = rtt.render_blocks(node_l, st_l2, PATH_L_CONT - 3, PATH_L_BLOCK)
    eq_l = torch.equal(cont_a, cont_b)
    out_l = torch.cat([head_l, cont_a], dim=1)
    err_l = _max_err(out_l.cpu(), torch.from_numpy(want_l))
    print(f"path L (config 2 over {PATH_L_SECONDS} s): seek to {PATH_L_TARGETS[0]} s in "
          f"{sec_l * 1e3:.2f} ms (host clock), {replay_l} blocks replayed (to "
          f"{PATH_L_TARGETS[1]} s: {seeks[PATH_L_TARGETS[1]][1]} blocks, "
          f"{seeks[PATH_L_TARGETS[1]][0] * 1e3:.2f} ms; on the CPU {cpu_replay_l}); launches "
          f"{path_l_run}; the {PATH_L_CONT} blocks after the seek, card vs CPU: max|d| "
          f"{err_l:.3e} (bound {BOUND_B}); checkpoint loaded on the card {on_card}, "
          f"continuation bit-equal {eq_l} {tag}")
    if not (eq_l and on_card and bool(torch.isfinite(out_l).all())):
        raise AssertionError("path L: the checkpoint's continuation differs")
    if not (err_l <= BOUND_B and cpu_replay_l == replay_l
            and tuple(want_l.shape) == tuple(out_l.shape)):
        raise AssertionError(f"path L: card vs CPU {err_l}, replayed {replay_l} vs "
                             f"{cpu_replay_l}, shapes {tuple(out_l.shape)} {want_l.shape}")
    del node_l, st_l, st_l2, cont_a, cont_b, out_l

    # -- the io layer (M7): paths M, N and O ----------------------------------
    # path M: BASELINE config 2 from a file, decoded whole: a seeded 180 s
    # 16-bit-grid stereo master at 44.1 kHz written as WAV and as FLAC, each
    # decoded onto the card, through profile_slice.config2's chain in blocks
    # of 4096, then to_file as f32 WAV
    io_dir = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        io_res = _io_paths(io_dir, dict(reset=reset, counts=counts, expect=expect, tag=tag))
    finally:
        shutil.rmtree(io_dir, ignore_errors=True)

    # -- the farm (M8): paths P, Q and R ------------------------------------
    farm_dir = tempfile.mkdtemp(prefix="chip_smoke_farm_")
    try:
        farm_res = _farm_paths(farm_dir, dict(reset=reset, counts=counts, expect=expect,
                                              tag=tag))
    finally:
        shutil.rmtree(farm_dir, ignore_errors=True)

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

    for label, node in (("slice", master), ("path A (AGC)", agc_master),
                        ("path C (per-stream chain)", path_c_node),
                        (f"path D (agc_group={AGC_GROUP})", grp_master),
                        ("path E (rel0b16)", rel0_masters["path E"]),
                        ("path E' (rel0f)", rel0_masters["path E'"])):
        sec_per_block = time_render(node, N_BLOCKS, T)
        rt_factor = (N_STREAMS * T / 48000) / sec_per_block
        print(f"{label}: {sec_per_block * 1e3:.3f} ms per block of {T} frames x "
              f"{N_STREAMS} streams; aggregate realtime factor {rt_factor:.1f}x {tag}")
    for label, node, n_streams in (("path G (ring resampler chain)", path_g, N_STREAMS),
                                   ("path G' (bf16 blocks)", path_gb, N_STREAMS)):
        sec_per_block = time_render(node, N_BLOCKS, T)
        print(f"{label}: {sec_per_block * 1e3:.3f} ms per block of {T} frames x "
              f"{n_streams} streams; aggregate realtime factor "
              f"{n_streams * T / 48000 / sec_per_block:.1f}x {tag}")
    sec_per_block = time_render(path_f, 400, PATH_F_BLOCK)
    print(f"path F (config 1): {sec_per_block * 1e3:.4f} ms per block of {PATH_F_BLOCK} "
          f"frames x 1 stream; realtime factor "
          f"{PATH_F_BLOCK / 48000 / sec_per_block:.1f}x {tag}")
    for label, (node, nh) in path_h_nodes.items():
        sec_per_block = time_render(node, nh - 1, PATH_H_BLOCK)
        print(f"path H ({label}): {sec_per_block * 1e3:.4f} ms per block of "
              f"{PATH_H_BLOCK} frames x 1 stream; realtime factor "
              f"{PATH_H_BLOCK / 48000 / sec_per_block:.1f}x {tag}")
    sec_per_block = time_render(config2("cuda", 0), 24, PATH_B_BLOCK)
    print(f"path B (config 2): {sec_per_block * 1e3:.3f} ms per block of "
          f"{PATH_B_BLOCK} frames x 1 stream; realtime factor "
          f"{PATH_B_BLOCK / PATH_B_RATE / sec_per_block:.1f}x {tag}")
    # paths I and J are host-driven pulls (each block's valids read back):
    # timed by the host clock over the whole render (the CPU references'
    # child processes have finished)
    _, rx3 = config3("cuda", PATH_I_SECONDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, pulls3 = pull_to_end(rx3, PATH_I_BLOCK)
    torch.cuda.synchronize()
    sec3 = (time.perf_counter() - t0) / pulls3
    _, rx3 = config3("cuda", PATH_I_SECONDS)
    prof_i = profile_pulls(lambda: rx3.next_block(PATH_I_BLOCK), 40)
    print(f"path I (config 3, 64 sources, taken for {PATH_I_SECONDS} s): {sec3 * 1e3:.3f} ms "
          f"a pull of {PATH_I_BLOCK} frames (host clock, {pulls3} pulls), realtime factor "
          f"{PATH_I_BLOCK / 48000 / sec3:.2f}x; phase launches a pull "
          f"{path_i_run['phase'] / pulls3:.1f}; over 40 pulls: device busy "
          f"{prof_i['device_busy_ms']:.4f} ms a pull, idle share {prof_i['idle_share']:.3f}, "
          f"{prof_i['launches_per_block']:.1f} device events a pull {tag}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    player_script("cuda", PATH_J_BLOCKS)
    torch.cuda.synchronize()
    sec_j = (time.perf_counter() - t0) / PATH_J_BLOCKS
    prof_j = profile_pulls(lambda: player_script("cuda", PATH_J_BLOCKS), 1)
    print(f"path J (the player): {sec_j * 1e3:.3f} ms a block of 256 frames (host clock, "
          f"building the graph, the knob changes and the seek included), realtime factor "
          f"{256 / 48000 / sec_j:.2f}x; phase launches {path_j_run['phase']} in "
          f"{PATH_J_BLOCKS} blocks; device busy "
          f"{prof_j['device_busy_ms'] / PATH_J_BLOCKS:.4f} ms a block, idle share "
          f"{prof_j['idle_share']:.3f}, {prof_j['launches_per_block'] / PATH_J_BLOCKS:.1f} "
          f"device events a block {tag}")
    for name in NOISE:
        sec_per_block = time_render(noise_source(name, "cuda"), nk - 1, PATH_K_BLOCK)
        print(f"path K ({name}): {sec_per_block * 1e3:.4f} ms per block of {PATH_K_BLOCK} "
              f"frames (CUDA events) {tag}")
    for name in ("Pink", "Brownian"):
        node = noise_source(name, "cuda")
        st_k = [node.init_state()]

        def pull_k(node=node, st_k=st_k):
            st_k[0], _, _ = node.emit(st_k[0], PATH_K_BLOCK)

        prof_k = profile_pulls(pull_k, 20)
        print(f"path K: {name} over 20 blocks: device busy {prof_k['device_busy_ms']:.4f} ms "
              f"a block, idle share {prof_k['idle_share']:.3f}, "
              f"{prof_k['launches_per_block']:.1f} device events a block {tag}")
    node_l = config2("cuda", 0, seconds=PATH_L_SECONDS)
    prof_l = profile_pulls(lambda: seek_state(node_l, PATH_L_TARGETS[0]), 1)
    print(f"path L (seek to {PATH_L_TARGETS[0]} s): profiled {prof_l['span_ms']:.2f} ms, "
          f"device busy {prof_l['device_busy_ms']:.3f} ms, idle share "
          f"{prof_l['idle_share']:.3f}, {prof_l['launches_per_block'] / replay_l:.1f} device "
          f"events a replayed block {tag}")
    del node_l

    # launches: from the render of the path that runs the kernel (K9: its
    # probe); launches_by_run keeps every render's counts apart
    runs = {"fused": fused_run, "unfused": unfused_run, "agc_fused": agc_run,
            "agc_unfused": agc_unfused_run, "config2": path_b_runs[0],
            "config2_group8": path_b_runs[8], "per_stream": path_c_run,
            "limit_mono": path_c_limits["mono"], "limit_p2": path_c_limits["P=2"],
            "agc_group": path_d_run, "agc_rel0b16": rel0_runs["rel0b16"],
            "agc_rel0f": rel0_runs["rel0f"], "dma_probe": dma_run,
            "config1": path_f_run, "ring_chain": path_g_run, "flagship_bf16": path_gb_run,
            **path_h_runs, "config3": path_i_run, "player": path_j_run, "noise": path_k_run,
            **{f"dither_{a}": r for a, r in dither_runs.items()}, "seek": path_l_run,
            **io_res, **farm_res}
    kernel_paths = {"K4": "unfused", "K3": "fused", "K1": "fused", "K1r": "farm_fused",
                    "K2": "agc_fused",
                    "K2r": "agc_rel0f", "K2b": "agc_rel0b16",
                    "K2g": "agc_group", "K6": "agc_unfused", "K7": "config2",
                    "K8": "config2", "K5": "per_stream", "K9": "dma_probe"}
    print(json.dumps({"kernels": [
        {"name": r["name"], "id": r["kid"], "route": "cuda", "source": r["source"],
         "replaces": r["replaces"],
         "launches": runs[r["path"] or kernel_paths[r["kid"]]][r["kid"]],
         "path": r["path"] or kernel_paths[r["kid"]],
         "launches_by_run": {k: c[r["kid"]] for k, c in runs.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "chain_ms": r["chain_ms"],
         "library_ms": r["library_ms"]}
        for r in results
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
