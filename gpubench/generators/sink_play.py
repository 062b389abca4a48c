"""A file played the way a rodio user plays it (a closed loop): a sink on
the card with a callback backend, ``play`` of the chain over a looped
decoder, and the sink's ``render_blocks(1)`` called back to back.

Set-up writes the configuration's track as FLAC (as ``file_render`` does),
opens ``MixerDeviceSink(CallbackDevice(...), DeviceConfig(channels,
out_rate))`` (its default buffer: ~50 ms, a power of two), plays the chain
over ``LoopedDecoder`` into it and pulls ``warm_buffers`` buffers. A unit is
one buffer: the mixer's pull (the Player's queue, ``Uniform`` to the sink's
rate, the chain), the read-back and the backend's write; it counts once the
callback holds it.

Mix keys: ``out_rate``, ``section_seconds``, ``warm_buffers``,
``profile_buffers``, ``check_buffers`` (the window's buffers compared with
the reference, drawn from the seed).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from gpubench import audiofiles, measure, signals
from gpubench.harness import Outcome


def run(cell) -> Outcome:
    from rodio_tpu_torch.io.decoder import LoopedDecoder
    from rodio_tpu_torch.io.device import CallbackDevice, DeviceConfig, MixerDeviceSink, play

    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    rin, C = cfg["in_rate"], cfg["channels"]
    F = int(cfg["track_seconds"] * rin)
    gen = signals.generator(cell.seed, dev)
    song, ints = signals.music(gen, C, F, rin, dev, sections=mix["section_seconds"])
    song = song[0]
    path = os.path.join(cell.tmpdir(), "track.flac")
    audiofiles.write_flac(path, ints[0].cpu().numpy(), rin)
    got = []
    sink = MixerDeviceSink(CallbackDevice(got.append), DeviceConfig(C, mix["out_rate"]),
                           device=dev)
    nbuf = sink.config.buffer_frames
    play(sink, cell.config.chain(LoopedDecoder(path, device=dev), cfg))
    sink.render_blocks(mix["warm_buffers"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first = len(got)
    times = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        t = time.perf_counter()
        sink.render_blocks(1)
        times.append(time.perf_counter() - t)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(got) - first
    audio_s = n * nbuf / mix["out_rate"]
    readings = None
    if cell.trace:
        readings = measure.Readings(host={"buffer": times})
        with measure.Stretch() as stretch:
            sink.render_blocks(mix["profile_buffers"])
        stretch.fill(readings, mix["profile_buffers"])
    sink.close()
    del sink
    oks = [b.size == nbuf * C and bool(np.isfinite(b).all()) for b in got]
    # the buffers to compare: a sample of the window's, drawn from the seed
    pick = np.random.default_rng([cell.seed, 1]).choice(
        n, size=min(n, mix["check_buffers"]), replace=False) + first
    spans = [(int(k) * nbuf, (int(k) + 1) * nbuf) for k in sorted(pick)]

    def compare(control: bool):
        out = np.concatenate(got).reshape(-1, C).T
        n_out = spans[-1][1]
        fr, to = cell.reference.ratio(rin, mix["out_rate"])
        x = song[:, torch.arange(n_out * fr // to + 2, device=song.device) % F]
        want = cell.reference.play(x, cfg, mix["out_rate"], n_out)
        if control:
            have = cell.reference.play(x, cfg, mix["out_rate"], n_out, store=torch.bfloat16)
        else:
            have = torch.from_numpy(np.ascontiguousarray(out[:, :n_out])).to(
                want.device, torch.float64)
        err = max(float((have[:, a:b] - want[:, a:b]).abs().max()) for a, b in spans)
        return {"max_abs_err": err, "bad_units": float(oks.count(False))}

    return Outcome(
        attempted=n, failed=oks[first:first + n].count(False),
        metrics={"realtime_x": measure.rate(audio_s, wall),
                 "buffer_ms_p95": measure.p95(times) * 1e3},
        samples=[f"# realtime_x: {n} buffers of {nbuf} frames, {audio_s!r} audio-s in "
                 f"{wall!r} s",
                 f"# buffers a second: {measure.per_second(np.cumsum(times) + t0, t0)}",
                 f"# buffer_ms_p95: over {len(times)} buffers",
                 f"# compared: {len(spans)} buffers of the window's, drawn from the seed"],
        window_start=t0, compare=compare, readings=readings)
