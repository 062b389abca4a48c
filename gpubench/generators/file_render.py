"""A node chain rendered to host memory, block after block (a closed loop):
rodio's ``into_file`` / ``wav_to_file`` users.

Set-up writes the configuration's track (``track_seconds`` of a seeded
16-bit stereo master with a level a section, ``signals.music``) as FLAC
to the run's temporary directory, decodes it whole through the port's
``LoopedDecoder`` and builds the chain over it (``config.chain``). A unit
is one block of ``block_frames``: ``emit``, then the copy to the host that
a file writer consumes. ``warm_blocks`` blocks are set-up.

Mix keys: ``block_frames``, ``section_seconds``, ``warm_blocks``,
``profile_blocks``, ``check_blocks`` (the window's blocks compared with the
reference, drawn from the seed).
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
    from torch.profiler import record_function

    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    rin = cfg["in_rate"]
    F = int(cfg["track_seconds"] * rin)
    B = mix["block_frames"]
    gen = signals.generator(cell.seed, dev)
    song, ints = signals.music(gen, cfg["channels"], F, rin, dev,
                               sections=mix["section_seconds"])
    song = song[0]
    path = os.path.join(cell.tmpdir(), "track.flac")
    audiofiles.write_flac(path, ints[0].cpu().numpy(), rin)
    chain = cell.config.chain(LoopedDecoder(path, device=dev), cfg)
    st = {"state": chain.init_state()}
    delivered, oks, emit_s, done = [], [], [], []

    def unit(timer):
        t = time.perf_counter()
        st["state"], blk, valid = chain.emit(st["state"], B)
        timer.append(time.perf_counter() - t)
        with record_function("gpubench.readback"):
            host = blk.cpu().numpy()
        delivered.append(host)
        done.append(time.perf_counter())
        oks.append(int(valid) == B and bool(np.isfinite(host).all()))

    for _ in range(mix["warm_blocks"]):
        unit([])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first = len(delivered)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        unit(emit_s)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(delivered) - first
    audio_s = n * B / rin
    readings = None
    if cell.trace:
        readings = measure.Readings(shapes={"agc_samples": 2 * B},
                                    host={"emit": emit_s})
        with measure.Stretch() as stretch:
            for _ in range(mix["profile_blocks"]):
                unit([])
        stretch.fill(readings, mix["profile_blocks"])
    del chain, st

    # the blocks to compare: a sample of the window's, drawn from the seed
    pick = np.random.default_rng([cell.seed, 1]).choice(
        n, size=min(n, mix["check_blocks"]), replace=False) + first
    spans = [(int(k) * B, (int(k) + 1) * B) for k in sorted(pick)]

    def compare(control: bool):
        end = spans[-1][1]
        x = song[:, torch.arange(end, device=song.device) % F]
        want = cell.reference.render(x, cfg)
        if control:
            have = cell.reference.render(x, cfg, store=torch.bfloat16)
        else:
            have = torch.from_numpy(np.concatenate(delivered, axis=1)[:, :end]).to(
                want.device, torch.float64)
        err = max(float((have[:, a:b] - want[:, a:b]).abs().max()) for a, b in spans)
        return {"max_abs_err": err, "bad_units": float(oks.count(False))}

    return Outcome(
        attempted=n, failed=oks[first:first + n].count(False),
        metrics={"realtime_x": measure.rate(audio_s, wall)},
        samples=[f"# realtime_x: {n} blocks of {B} frames, {audio_s!r} audio-s in {wall!r} s",
                 f"# blocks a second: {measure.per_second(done[first:first + n], t0)}",
                 f"# compared: {len(spans)} blocks of the window's, drawn from the seed"],
        window_start=t0, compare=compare, readings=readings)
