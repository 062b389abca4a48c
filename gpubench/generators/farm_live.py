"""The live farm, fed from files as it decodes them: a live mixing server.

Set-up writes ``files`` seeded WAVs of ``file_seconds`` (16-bit stereo) to
the run's temporary directory; stream s reads file s mod ``files`` from an
offset of whole beats in [0, ``offset_max_seconds``], looping, with its own
gain. A first farm over the same files runs ``warm_blocks`` blocks and is
closed (set-up: the kernels, K3's tables); the median time between its
blocks after the first sizes the timed run, which ``StreamFarm.run`` takes
as a block count: ``block_margin`` times the blocks the window would hold
at that pace, and ``profile_blocks`` more with ``--trace 1``. The timed farm
is a new one, built exactly so (``config.farm``), and runs to its end. The
window opens when block 0 is on the host and closes ``--seconds`` later;
a block counts once ``on_block`` holds it on the host inside the window.
With ``--trace 1`` the first ``profile_blocks`` blocks after the window are
profiled, and the farm's ``assemble``, ``push`` and ``emit`` spans are taken
through ``StreamFarm.run(spans=)`` by a recorder of the benchmark's own (the
host clock only), so that the window's blocks read apart from the profiled
ones. A run whose ring overflowed fails every block of its window.

Mix keys: ``files``, ``file_seconds``, ``offset_max_seconds``, ``wire``,
``decode_workers``, ``chunk_frames``, ``warm_blocks``, ``block_margin``,
``profile_blocks``.
"""
from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from gpubench import audiofiles, measure, signals
from gpubench.harness import Outcome


class _HostSpans:
    """The interface of ``FarmSpans`` (``span``, ``host``), by the host
    clock, one list of seconds a name; each span is also a
    ``record_function`` range, so that a profile names what the host did."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def span(self, name):
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function("farm." + name):
            yield
        self.times.setdefault("farm." + name, []).append(time.perf_counter() - t)

    host = span


def run(cell) -> Outcome:
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    S, C, T = cfg["streams"], cfg["channels"], cfg["block_frames"]
    rin = cfg["in_rate"]
    fr, to = cell.config.ratio(cfg)
    n_files = mix["files"]
    ff = int(mix["file_seconds"] * rin)
    gen = signals.generator(cell.seed, dev)
    rng = np.random.default_rng([cell.seed, 0])
    songs, ints = signals.music(gen, C, ff, rin, dev, variants=n_files)
    ints = ints.cpu().numpy()
    tmp = cell.tmpdir()
    files = []
    for i in range(n_files):
        path = os.path.join(tmp, f"stem{i}.wav")
        audiofiles.write_pcm_wav(path, ints[i], rin, 16)
        files.append(path)
    paths = [files[s % n_files] for s in range(S)]
    offsets = signals.beat_shifts(rng, S, int(mix["offset_max_seconds"] * rin), rin)
    gains = (rng.uniform(cfg["gain_low"], cfg["gain_high"], S).astype(np.float32)
             / np.float32(S))
    offsets_s = [int(k) / rin for k in offsets]

    warm = cell.config.farm(paths, offsets_s, gains, cfg, mix, dev)
    warm_times = []

    def on_warm_block(k, out, valid):
        out.cpu()
        warm_times.append(time.perf_counter())

    try:
        warm.run(mix["warm_blocks"], on_block=on_warm_block)
    finally:
        warm.close()
    del warm
    t_block = float(np.median(np.diff(warm_times[1:])))
    n_blocks = (math.ceil(mix["block_margin"] * cell.seconds / t_block) + 1
                + (mix["profile_blocks"] if cell.trace else 0))

    delivered, times, oks = [], [], []
    spans = _HostSpans() if cell.trace else None
    st = {"t0": None, "stretch": None, "profiled": 0}

    def on_block(k, out, valid):
        host = out.cpu().numpy()
        t = time.perf_counter()
        delivered.append(host)
        oks.append(int(valid) == T and bool(np.isfinite(host).all()))
        times.append(t)
        if k == 0:
            st["t0"] = t
        elif (cell.trace and t - st["t0"] > cell.seconds
              and st["profiled"] < mix["profile_blocks"]):
            if st["stretch"] is None:
                st["stretch"] = measure.Stretch().__enter__()
            else:
                st["profiled"] += 1
                if st["profiled"] == mix["profile_blocks"]:
                    st["stretch"].__exit__(None, None, None)

    farm = cell.config.farm(paths, offsets_s, gains, cfg, mix, dev)
    try:
        _, _, overflow = farm.run(n_blocks, on_block=on_block, spans=spans)
    finally:
        farm.close()
        if st["stretch"] is not None and st["profiled"] < mix["profile_blocks"]:
            st["stretch"].__exit__(None, None, None)
    del farm
    # the blocks after block 0 that reached the host inside the window
    K = sum(1 for t in times[1:] if t - st["t0"] <= cell.seconds)
    if K == 0:
        raise RuntimeError("no block after block 0 reached the host inside the window")
    wall = times[K] - st["t0"]
    audio_s = K * S * T / cfg["out_rate"]
    failed = K if overflow else oks[1:K + 1].count(False)
    readings = None
    if cell.trace:
        host = {name: v[1:K + 1] for name, v in spans.times.items()}
        readings = measure.Readings(shapes={
            "lanes": S * C, "channels": C, "block": T, "fr": fr, "to": to}, host=host)
        if st["profiled"] < mix["profile_blocks"]:
            raise RuntimeError(f"{st['profiled']} of {mix['profile_blocks']} blocks profiled "
                               "after the window")
        st["stretch"].fill(readings, st["profiled"])

    def compare(control: bool):
        got = np.concatenate(delivered, axis=1)
        n_out = got.shape[1]
        n_in = n_out * fr // to + 2
        idx = torch.arange(n_in, device=songs.device)
        lanes = torch.empty((S * C, n_in), dtype=torch.float32, device=songs.device)
        for s in range(S):
            lanes[s * C:(s + 1) * C] = songs[s % n_files][:, (int(offsets[s]) + idx) % ff]
        want = cell.reference.render(lanes, gains, cfg, n_out)
        have = (cell.reference.render(lanes, gains, cfg, n_out, store=torch.bfloat16)
                if control else torch.from_numpy(got).to(want.device, torch.float64))
        return {"max_abs_err": float((have - want).abs().max()),
                "bad_units": float(oks.count(False) + overflow)}

    return Outcome(
        attempted=K, failed=failed,
        metrics={"live_realtime_x": measure.rate(audio_s, wall)},
        samples=[f"# live_realtime_x: {K} blocks of {S} streams x {T} frames after block 0, "
                 f"{audio_s!r} audio-s in {wall!r} s",
                 f"# blocks a second: {measure.per_second(times[1:K + 1], st['t0'])}",
                 f"# run: {len(times)} blocks, sized at {t_block!r} s a block by the warm-up; "
                 f"ring overflow: {bool(overflow)}",
                 f"# compared: {len(delivered)} blocks from the streams' start"],
        window_start=st["t0"], compare=compare, readings=readings)
