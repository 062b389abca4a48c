"""Offline render jobs, back to back (a closed loop): the render farm's
traffic.

Set-up makes a corpus on the device from the seed, ``corpus_seconds`` of
every stream (``signals.corpus``). Each job draws from the seed a start in
[0, ``offset_max_seconds``] (whole input frames) and the streams' gains,
builds the configuration's chain over its slice of the corpus
(``config.job_chain``), renders ``blocks_per_job`` blocks, and reads the
mix back to the host, as a render to a file does. A job counts once its
mix is on the host. The first job is set-up: it builds and warms every
shape the window uses.

Mix keys: ``corpus_seconds``, ``offset_max_seconds``, ``blocks_per_job``,
``check_jobs`` (jobs compared with the reference, drawn from the seed),
``profile_jobs`` (the traced run's profiled stretch).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import measure, signals
from gpubench.harness import Outcome


def run(cell) -> Outcome:
    from torch.profiler import record_function

    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    S, C, T = cfg["streams"], cfg["channels"], cfg["block_frames"]
    fr, to = cell.config.ratio(cfg)
    nb = mix["blocks_per_job"]
    n_out = nb * T
    n_in = n_out * fr // to + fr  # every output frame a full lerp, no drain frame
    frames = int(mix["corpus_seconds"] * cfg["in_rate"])
    off_max = int(mix["offset_max_seconds"] * cfg["in_rate"])
    if off_max + n_in > frames:
        raise ValueError("a job's slice runs past the corpus")
    gen = signals.generator(cell.seed, dev)
    rng = np.random.default_rng([cell.seed, 0])
    corpus = signals.corpus(gen, rng, S, C, frames, cfg["in_rate"], dev)

    def draw():
        off = int(rng.integers(0, off_max + 1))
        gains = (rng.uniform(cfg["gain_low"], cfg["gain_high"], S).astype(np.float32)
                 / np.float32(S))
        return off, gains

    emit_s = []

    def job(off, gains, timer):
        with record_function("gpubench.job_setup"):
            chain = cell.config.job_chain(corpus[:, off:off + n_in], gains, cfg, dev)
            state = chain.init_state()
        blocks, valids = [], []
        for _ in range(nb):
            t = time.perf_counter()
            state, blk, valid = chain.emit(state, T)
            timer.append(time.perf_counter() - t)
            blocks.append(blk)
            valids.append(valid)
        with record_function("gpubench.readback"):
            out = torch.cat(blocks, 1).cpu().numpy()
            vals = torch.stack(valids).cpu().numpy()
        ok = bool((vals == T).all() and np.isfinite(out).all())
        return out, ok

    t = time.perf_counter()
    job(*draw(), [])  # set-up: builds the kernels, warms every shape
    t_job = time.perf_counter() - t
    t = time.perf_counter()
    job(*draw(), [])
    t_job = min(t_job, time.perf_counter() - t)
    # the jobs to compare, drawn from the seed among those the window will
    # likely finish (from the warm job's time)
    expect = max(1, int(0.8 * cell.seconds / t_job))
    rng_check = np.random.default_rng([cell.seed, 1])
    check = set(rng_check.choice(expect, size=min(expect, mix["check_jobs"]),
                                 replace=False).tolist())
    kept, done = [], []
    jobs = failed = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        off, gains = draw()
        out, ok = job(off, gains, emit_s)
        done.append(time.perf_counter())
        failed += not ok
        if jobs in check:
            kept.append((off, gains, out))
        jobs += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not kept:
        kept.append((off, gains, out))  # the window was short of every drawn job
    audio_s = jobs * S * n_out / cfg["out_rate"]
    readings = None
    if cell.trace:
        readings = measure.Readings(shapes={
            "lanes": S * C, "channels": C, "block": T, "fr": fr, "to": to},
            host={"emit": emit_s})
        with measure.Stretch() as st:
            for _ in range(mix["profile_jobs"]):
                job(*draw(), [])
        st.fill(readings, mix["profile_jobs"])

    def compare(control: bool):
        err = 0.0
        for off, gains, out in kept:
            lanes = corpus[:, off:off + n_in]
            want = cell.reference.render(lanes, gains, cfg, n_out)
            got = (cell.reference.render(lanes, gains, cfg, n_out, store=torch.bfloat16)
                   if control else torch.from_numpy(out).to(want.device, torch.float64))
            err = max(err, float((got - want).abs().max()))
        return {"max_abs_err": err, "bad_units": float(failed)}

    return Outcome(
        attempted=jobs, failed=failed,
        metrics={"realtime_x": measure.rate(audio_s, wall)},
        samples=[f"# realtime_x: {jobs} jobs of {S} streams x {n_out} frames, "
                 f"{audio_s!r} audio-s in {wall!r} s",
                 f"# jobs a second: {measure.per_second(done, t0)}",
                 f"# compared: {len(kept)} jobs (indices {sorted(check)} drawn)"],
        window_start=t0, compare=compare, readings=readings)
