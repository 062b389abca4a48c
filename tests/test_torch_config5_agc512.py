"""The benchmark's ``config5_agc512`` on the CPU: its job chain
(``gpubench/configs/config5_agc512.py``: ``SamplesBuffer`` ->
``FusedWidePipeline(with_agc=True, agc_ring="f32")`` -> ``Limit``) on the
port's plain versions against its plain reference
(``gpubench/reference/config5_agc512.py``), the reference's batched gain
smoother and AGC against ``reference/common.py``'s one-stream versions, and
the AGC's set-up span."""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpubench import harness, signals  # noqa: E402
from gpubench.reference import common  # noqa: E402
from rodio_tpu_torch.utils import trace  # noqa: E402

BENCH = os.path.join(ROOT, "gpubench")
CFG = {**json.load(open(os.path.join(BENCH, "configs", "config5_agc512.json"))),
       "streams": 4, "block_frames": 1280}
BLOCKS = 3
SEED = 2**31 + 4242
#: the job's mix against the reference: the port's f32 blocks against the
#: f64 reference read 4e-7 to 6e-7 here (each stage's f32 rounding, AGC
#: gains up to 7); a single stage stored in bfloat16 reads 4.8e-4 or more
TOL = 2e-6


def module(kind, name):
    return harness.load_module(os.path.join(BENCH, kind, name + ".py"),
                               f"test_{kind}_{name}")


CONFIG = module("configs", "config5_agc512")
REF = module("reference", "config5_agc512")


def job_inputs(seed=SEED):
    fr, to = CONFIG.ratio(CFG)
    n_out = BLOCKS * CFG["block_frames"]
    n_in = n_out * fr // to + fr
    gen = signals.generator(seed, "cpu")
    rng = np.random.default_rng([seed, 0])
    corpus = signals.corpus(gen, rng, CFG["streams"], 2, n_in + 200, CFG["in_rate"], "cpu")
    gains = (rng.uniform(0.5, 1.5, CFG["streams"]).astype(np.float32)
             / np.float32(CFG["streams"]))
    return corpus[:, 100:100 + n_in], gains, n_out


def render_job(pcm, gains):
    chain = CONFIG.job_chain(pcm, gains, CFG, torch.device("cpu"))
    state = chain.init_state()
    blocks = []
    for _ in range(BLOCKS):
        state, y, valid = chain.emit(state, CFG["block_frames"])
        assert int(valid) == CFG["block_frames"]
        blocks.append(y)
    return torch.cat(blocks, 1).to(torch.float64)


@pytest.fixture(scope="module")
def job():
    pcm, gains, n_out = job_inputs()
    return pcm, gains, n_out, render_job(pcm, gains), REF.render(pcm, gains, CFG, n_out)


def test_the_job_chain_matches_the_reference(job):
    _, _, _, got, want = job
    assert float((got - want).abs().max()) <= TOL
    assert float(want.abs().max()) > 0.5  # the mix is at unit scale


#: the reference's stages, in the order it stores them: input, resampler,
#: low-pass, AGC, mix, limiter
STAGES = ["input", "resample", "low_pass", "agc", "mix", "limiter"]


@pytest.mark.parametrize("k", range(len(STAGES)), ids=STAGES)
def test_one_stage_stored_in_bfloat16_fails_the_tolerance(job, k, monkeypatch):
    pcm, gains, n_out, got, _ = job
    calls = []

    def stage(x, store):
        calls.append(len(calls))
        return common.stage(x, torch.bfloat16 if len(calls) - 1 == k else store)

    monkeypatch.setattr(REF, "stage", stage)
    low = REF.render(pcm, gains, CFG, n_out)
    assert len(calls) == len(STAGES)
    assert float((got - low).abs().max()) > TOL


def _sequential(des, att, rel, max_gain):
    """The smoother's recurrence, one step at a time (agc.rs:486-496)."""
    f = np.float32
    a, r, mg = f(att), f(rel), f(max_gain)
    g, out = f(1.0), np.empty_like(des)
    for t, d in enumerate(des):
        s = a if d > g else r
        g = min(max(f(f(g * s) + f(d * f(f(1.0) - s))), f(0.1)), mg)
        out[t] = g
    return out


@pytest.mark.parametrize("release", [0.0, 0.05])
def test_the_batched_smoother_equals_smooth_f32(release):
    att = common.coefficient(4.0, 48000)
    rel = common.coefficient(release, 48000)
    rng = np.random.default_rng(7)
    m = 24000
    des = rng.uniform(1.0, 1.5, (3, m)).astype(np.float32)
    # a stretch of 12,000 steps above every gain reached: no step resets
    # the smoother there, so its chunks (1024 steps) wait on their
    # predecessors pass after pass
    des[:, 3000:15000] = rng.uniform(6.0, 6.5, (3, 12000)).astype(np.float32)
    got = REF.smooth_streams(torch.from_numpy(des), att, rel, 7.0, chunk=1024).numpy()
    for s in range(3):
        want = common.smooth_f32(des[s], att, rel, 7.0)
        assert np.array_equal(got[s], want)
        prev = np.concatenate([[np.float32(1.0)], want[:-1]])
        assert (des[s, 3000:15000] > prev[3000:15000]).all()  # reset-free
    assert np.array_equal(got[1, :4000], _sequential(des[1, :4000], att, rel, 7.0))


def test_the_reference_agc_equals_common_agc_on_one_stream():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9000)) * 0.3)
    x[:, 4000:6000] *= 3.0  # a loud stretch: peaks and the window both bind
    got = REF.agc(x[None], CFG)[0]
    want = common.agc(x, CFG["out_rate"])
    assert torch.equal(got, want)


def test_the_agc_state_span_is_recorded_once_a_job():
    pcm, gains, _ = job_inputs()
    rec = trace.Spans("cpu")
    with trace.recording(rec):
        for _ in range(2):
            CONFIG.job_chain(pcm, gains, CFG, torch.device("cpu")).init_state()
        mix = module("configs", "config5_mix512")
        mix.job_chain(pcm, gains, CFG, torch.device("cpu")).init_state()  # no AGC
    assert rec.summary()["rodio.setup.agc_state"]["n"] == 2
