"""Where the time goes in the flagship slice on one CUDA card.

    python -m rodio_tpu_torch.profile_slice [--streams 512] [--block N]
        [--blocks 12] [--with-agc | --path B | C | D | E | F | G | H]
        [--out FILE]

For each cell (``fused``: K1 then K3 per block; ``unfused``: Resample ->
K4 -> Amplify -> WideMixer -> K3; with ``--with-agc``, the AGC slice
instead: ``agc_fused``, K2 then K3, and ``agc_unfused``, Resample -> K4 ->
AutomaticGainControl (K6) -> Amplify -> WideMixer -> K3; with ``--path
B``, BASELINE config 2 on 10 s of seeded stereo PCM at 44.1 kHz:
``config2``, low_pass (K4) -> AutomaticGainControl(mode="pallas") (K8,
the cumulative sum, K7) -> Limit(mode="pallas") (K3), and
``config2_group8``, the same with ``group=8``; with ``--path C``,
``per_stream``, the per-stream chain of ``make_per_stream_chain``:
Resample -> K4 -> AGC (K6) -> Amplify -> Limit(streams=S) (K5) ->
WideMixer -> K3; with ``--path D``, ``agc_group``, the fused AGC slice with
``agc_group=16``: K2g then K3; with ``--path E``, ``agc_rel0b16``, the JAX
package's AGC-on bench leg, the fused AGC slice with ``agc_plan="rel0b16"``
and ``precision="int2"``: K2b then K3, and ``agc_rel0f``, the same with
``agc_plan="rel0f"``: K2r then K3; with ``--path F``, ``config1``,
BASELINE config 1: Uniform(rodio_compat=True) over 180 s of stereo, the
resampler's span path; with ``--path G``, ``ring_chain``, the unfused
chain with the resampler on its streaming ring (K4, K3), and
``flagship_bf16``, ``make_flagship(block_bf16=True)`` (K4's bf16 instance,
K3); with ``--path H``, ``config4_parity`` and ``config4_scene``,
BASELINE config 4's graphs (the phase kernel)) it prints, per block of
``--block`` frames (default 12800; paths B and F 4096, path H 1024):

- ``wall_ms``: CUDA-event time of a render of ``--blocks`` blocks, 3 runs,
  no profiler;
- ``host_enqueue_ms``: host time of the same calls up to the return of
  ``render_blocks``, before the synchronize;
- from one ``torch.profiler`` run: ``kernels`` (device ms per kernel name,
  kernel rows only, so no op is counted twice), ``launches_per_block``
  (device events, kernels and copies, per block), ``device_busy_ms`` (the
  union of the kernels' intervals) and ``idle_share`` (1 - busy / the
  render's host span, synchronize included).

The result is one JSON object on stdout, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

_SPAN = "slice.render"


def _kernel_intervals(prof):
    """(name, start_us, end_us) of every device event of a profile that is
    device work: kernels, copies and fills, not the device side of a
    ``record_function`` range."""
    from torch.autograd import DeviceType

    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name != _SPAN]


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def config2(device, group: int = 0, seconds: int = 10, rate: int = 44100):
    """BASELINE config 2 (``BASELINE.json`` ``configs[1]``) on ``seconds``
    of seeded stereo PCM: low_pass(2 kHz) -> AutomaticGainControl(mode=
    "pallas", group) -> Limit(mode="pallas")."""
    import numpy as np

    from .effects import AgcSettings, AutomaticGainControl
    from .effects.limit import Limit, LimitSettings
    from .sources.generators import SamplesBuffer

    pcm = np.random.default_rng(2).standard_normal(
        (2, seconds * rate)).astype(np.float32) * 0.3
    node = SamplesBuffer(2, rate, pcm, device=device).low_pass(2000.0)
    node = AutomaticGainControl(node, AgcSettings(), mode="pallas", group=group)
    return Limit(node, LimitSettings(), mode="pallas")


def config1(device, seconds: int = 180, seed: int = 6):
    """BASELINE config 1 (``configs[0]``): ``seconds`` of seeded 16-bit-grid
    stereo PCM at 44.1 kHz through ``Uniform(..., 2, 48000,
    rodio_compat=True)``, the resampler's span path."""
    import numpy as np

    from .conversions import Uniform
    from .sources.generators import SamplesBuffer

    pcm = (np.random.default_rng(seed).integers(-32768, 32768, (2, seconds * 44100))
           / 32768.0).astype(np.float32)
    return Uniform(SamplesBuffer(2, 44100, pcm, device=device), 2, 48000,
                   rodio_compat=True)


def ring_chain(device, streams: int = 512, max_block: int = 12800, seed: int = 7):
    """BASELINE config 5's unfused chain with the per-channel gains applied
    before the resampler, so its upstream is not random-access (as a
    decoder's is not) and it takes its streaming ring path: Amplify ->
    Resample -> BltFilter(mode="pallas") (K4) -> WideMixer ->
    Limit(mode="pallas") (K3), on 4 s of seeded PCM."""
    import numpy as np

    from .conversions import Resample
    from .effects import Amplify, BltFilter
    from .effects.limit import Limit, LimitSettings
    from .parallel.batch import WideMixer
    from .sources.generators import SamplesBuffer

    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((2 * streams, 4 * 44100)) * 0.1).astype(np.float32)
    gains = np.repeat(rng.uniform(0.5, 1.5, streams) / streams, 2)
    node = Amplify(SamplesBuffer(2 * streams, 44100, pcm, device=device), gains)
    node = Resample(node, 48000, max_block=max_block)
    node = BltFilter(node, "low_pass", 2000.0, 0.5, mode="pallas")
    return Limit(WideMixer(node, streams), LimitSettings(), mode="pallas")


#: BASELINE config 4's ears (tools/parity_tpu.py:174-191)
EARS = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0))


def config4_parity(device):
    """BASELINE config 4's parity case (tools/parity_tpu.py:174-191): a
    440 Hz sine with the reference's phase accumulator, 0.3 s, panned."""
    from .effects import Spatial, TakeDuration
    from .sources import SineWave

    return Spatial(TakeDuration(SineWave(440.0, rodio_compat=True, device=device), 0.3),
                   (-0.7, 0.2, 0.0), *EARS)


def config4_scene(device):
    """The scene of tests/test_baseline_configs.py:130-158 without the
    control plane: a 330 Hz sine, 1 s, faded in, with an echo, panned."""
    from .sources import SineWave

    return (SineWave(330.0, rodio_compat=True, device=device).take_duration(1.0)
            .fade_in(0.1).reverb(0.03, 0.4).spatial((-2.0, 0.0, 0.0), *EARS))


def grid_pcm(channels: int, frames: int, seed: int):
    """Seeded 16-bit-grid PCM, [channels, frames] f32: a decoded asset's
    values."""
    import numpy as np

    k = np.random.default_rng(seed).integers(-20000, 20001, (channels, frames))
    return (k / 32768.0).astype(np.float32)


#: BASELINE config 3's decoded assets, synthesized: (channels, rate) of
#: music.wav, music.flac, beep.wav and beep2.wav
CONFIG3_BUFFERS = ((2, 44100), (2, 44100), (1, 48000), (1, 48000))


def config3(device, seconds: float = 10.0, seed: int = 10):
    """BASELINE config 3 (``configs[2]``), the shape of
    tests/test_baseline_configs.py:105-127: 60 SineWave / SquareWave /
    TriangleWave sources at 110 (1 + i % 16) Hz with ``rodio_compat`` (the
    phase kernel, as tools/parity_tpu.py:155 builds its sines) and 4
    buffers of seeded 16-bit-grid PCM in place of the decoded assets, each
    amplified by 1/64 and taken for ``seconds``, into mixer(2, 48000).
    Returns (Mixer, MixerSource)."""
    from .control import mixer
    from .sources import SamplesBuffer, SineWave, SquareWave, TriangleWave

    tx, rx = mixer(2, 48000, device=device)
    for i in range(60):
        cls = (SineWave, SquareWave, TriangleWave)[i % 3]
        tx.add(cls(110.0 * (1 + i % 16), rodio_compat=True, device=device)
               .amplify(1 / 64).take_duration(seconds))
    for j, (ch, rate) in enumerate(CONFIG3_BUFFERS):
        pcm = grid_pcm(ch, int(seconds * rate) + 100, seed + j)
        tx.add(SamplesBuffer(ch, rate, pcm, device=device).amplify(1 / 64)
               .take_duration(seconds))
    return tx, rx


def pull_to_end(rx, block: int):
    """Pull a host-driven source to its end: (the blocks on its device, the
    pulls, the last of which yields nothing)."""
    blocks = []
    while True:
        out, alive = rx.next_block(block)
        if not alive:
            return blocks, len(blocks) + 1
        blocks.append(out)


#: the player script's knob changes: block index -> (method, arguments)
PLAYER_EVENTS = {40: ("set_volume", (0.5,)), 80: ("pause", ()), 100: ("play", ()),
                 150: ("set_speed", (1.25,)), 300: ("try_seek", (20.0,)),
                 420: ("skip_one", ())}


def player_script(device, blocks: int = 700, seed: int = 8):
    """A Player on mixer(2, 48000) in blocks of 256 (its default): a queue of
    a 30 s seeded stereo buffer at 44.1 kHz and a 1 s SineWave take (with
    ``rodio_compat``), and beside it in the mixer a ``from_iter`` of two
    0.5 s buffers (a host-driven queue joins a mixer as a Player's does);
    PLAYER_EVENTS change the volume, pause and play, set the speed live
    (VariSpeed), seek to 20 s and skip to the sine. Returns the [2, blocks
    * 256] output on the device."""
    import torch

    from .control import Player, mixer
    from .control.player import _QueueNode
    from .sources import SamplesBuffer, SineWave, from_iter

    tx, rx = mixer(2, 48000, device=device)
    player = Player.connect_new(tx)
    player.append(SamplesBuffer(2, 44100, grid_pcm(2, 30 * 44100, seed), device=device))
    player.append(SineWave(440.0, rodio_compat=True, device=device).take_duration(1.0))
    parts = [SamplesBuffer(2, 48000, grid_pcm(2, 24000, seed + 1 + k), device=device)
             for k in range(2)]
    tx.add(_QueueNode(from_iter(parts, block_frames=player.block_frames, device=device),
                      tx.spec))
    out = []
    for k in range(blocks):
        if k in PLAYER_EVENTS:
            name, args = PLAYER_EVENTS[k]
            getattr(player, name)(*args)
        out.append(rx.next_block(player.block_frames)[0])
    return torch.cat(out, dim=1)


#: the noise family of sources/noise.py, by class name
NOISE = ("WhiteUniform", "WhiteTriangular", "WhiteGaussian", "Velvet", "Pink", "Blue",
         "Violet", "Brownian", "Red")


def noise_source(name: str, device, seed: int = 12):
    from .sources import noise

    return getattr(noise, name)(48000, seed=seed, device=device)


def profile_pulls(pull, n: int) -> dict:
    """Profile ``n`` calls of ``pull()`` (one block each, host-driven):
    device busy time a block, the host span a block, the idle share and
    the device events a block, as profile_cell reports them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(_SPAN):
            for _ in range(n):
                pull()
            torch.cuda.synchronize()
    span = [ev for ev in prof.events()
            if ev.name == _SPAN and ev.device_type == DeviceType.CPU][0]
    span_us = span.time_range.end - span.time_range.start
    kern = _kernel_intervals(prof)
    if not kern:
        raise RuntimeError("the profile holds no device events")
    busy_us = _union_us(kern)
    return {"device_busy_ms": busy_us / 1e3 / n, "span_ms": span_us / 1e3 / n,
            "idle_share": 1.0 - busy_us / span_us, "launches_per_block": len(kern) / n}


def _with_state(node):
    return node, node.init_state()


def profile_cell(build, block: int, blocks: int) -> dict:
    """Profile the render of ``build()`` = (node, state) in blocks of
    ``block`` frames."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import rodio_tpu_torch as rtt

    node, st = build()
    st, _, _ = rtt.render_blocks(node, st, 2, block)  # warm-up
    torch.cuda.synchronize()
    walls, hosts = [], []
    for _ in range(3):
        st = node.init_state()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        s.record()
        st, _, _ = rtt.render_blocks(node, st, blocks, block)
        t1 = time.perf_counter()
        e.record()
        torch.cuda.synchronize()
        walls.append(s.elapsed_time(e) / blocks)
        hosts.append((t1 - t0) * 1e3 / blocks)
    st = node.init_state()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(_SPAN):
            st, _, _ = rtt.render_blocks(node, st, blocks, block)
            torch.cuda.synchronize()
    span = [ev for ev in prof.events()
            if ev.name == _SPAN and ev.device_type == DeviceType.CPU][0]
    span_us = span.time_range.end - span.time_range.start
    kern = _kernel_intervals(prof)
    if not kern:
        raise RuntimeError("the profile holds no device events")
    per_name: dict = {}
    for name, s, e in kern:
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 1e3 / blocks
    busy_us = _union_us(kern)
    return {
        "wall_ms": walls,
        "host_enqueue_ms": hosts,
        "kernels": dict(sorted(per_name.items(), key=lambda kv: -kv[1])),
        "launches_per_block": len(kern) / blocks,
        "device_busy_ms": busy_us / 1e3 / blocks,
        "span_ms": span_us / 1e3 / blocks,
        "idle_share": 1.0 - busy_us / span_us,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--block", type=int, default=None,
                    help="frames a block (default 12800; path B 4096)")
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--with-agc", action="store_true",
                    help="profile the AGC slice (K2; unfused: K6)")
    ap.add_argument("--path", choices=("B", "C", "D", "E", "F", "G", "H"), default=None,
                    help="profile path B (BASELINE config 2: K4, K8, K7, K3), "
                         "path C (the per-stream chain: K4, K6, K5, "
                         "K3), path D (the group-rate fused AGC: K2g, K3), "
                         "path E (the rel0b16 and rel0f AGC plans: K2b or "
                         "K2r, K3), path F (BASELINE config 1: the span "
                         "path), path G (the ring resampler's chain: K4, K3; "
                         "and block_bf16: K4's bf16 instance, K3) or path H "
                         "(BASELINE config 4: the phase kernel)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import rodio_tpu_torch as rtt

    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = {"device": smi, "streams": args.streams, "block": args.block,
           "blocks": args.blocks, "with_agc": args.with_agc, "path": args.path}
    if args.block is None:
        args.block = {"B": 4096, "F": 4096, "H": 1024}.get(args.path, 12800)
    res["block"] = args.block
    kw = dict(seconds=4.0, device="cuda", max_block=args.block)
    if args.path == "B":
        cells = {name: (lambda group=group: _with_state(config2("cuda", group)))
                 for name, group in (("config2", 0), ("config2_group8", 8))}
    elif args.path == "C":
        cells = {"per_stream": lambda: rtt.make_per_stream_chain(
            args.streams, seconds=4.0, device="cuda")}
    elif args.path == "D":
        cells = {"agc_group": lambda: rtt.make_flagship(
            args.streams, scan_mode="fused", with_agc=True,
            agc_group=16, **kw)}
    elif args.path == "F":
        cells = {"config1": lambda: _with_state(config1("cuda"))}
    elif args.path == "G":
        cells = {"ring_chain": lambda: _with_state(ring_chain(
                     "cuda", args.streams, args.block)),
                 "flagship_bf16": lambda: rtt.make_flagship(
                     args.streams, scan_mode="pallas", block_bf16=True, **kw)}
    elif args.path == "H":
        cells = {"config4_parity": lambda: _with_state(config4_parity("cuda")),
                 "config4_scene": lambda: _with_state(config4_scene("cuda"))}
    elif args.path == "E":
        cells = {f"agc_{plan}": (lambda plan=plan: rtt.make_flagship(
            args.streams, scan_mode="fused", with_agc=True, agc_plan=plan,
            precision="int2", **kw)) for plan in ("rel0b16", "rel0f")}
    else:
        cells = {("agc_" if args.with_agc else "") + cell: (
            lambda mode=mode: rtt.make_flagship(args.streams, scan_mode=mode,
                                                with_agc=args.with_agc, **kw))
                 for cell, mode in (("fused", "fused"),
                                    ("unfused", "pallas" if args.with_agc else "auto"))}
    for cell, build in cells.items():
        res[cell] = profile_cell(build, args.block, args.blocks)
        torch.cuda.empty_cache()
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
