"""The benchmark's ``config5_strip512`` on the CPU: its job chain
(``gpubench/configs/config5_strip512.py``: ``SamplesBuffer`` -> ``Resample``
-> ``BltFilter`` -> ``AutomaticGainControl(streams)`` -> ``Limit(streams)``
-> ``Amplify`` -> ``WideMixer`` -> ``Limit``) on the port's plain versions
against its plain reference (``gpubench/reference/config5_strip512.py``),
the reference's batched per-stream limiter against ``reference/common.py``'s
one-stream limiter, and the spans the chain opens."""
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
BASE = json.load(open(os.path.join(BENCH, "configs", "config5_strip512.json")))
BLOCKS = 3
SEED = 2**31 + 4242
#: the job's mix against the reference: the port's f32 blocks against the
#: f64 reference read 3.7e-7 to 4.6e-7 here (each stage's f32 rounding, AGC
#: gains up to 7, the K6 route's running f32 window sum); a single stage
#: stored in bfloat16 reads 4.1e-4 or more
TOL = 2e-6


def module(kind, name):
    return harness.load_module(os.path.join(BENCH, kind, name + ".py"),
                               f"test_strip_{kind}_{name}")


CONFIG = module("configs", "config5_strip512")
REF = module("reference", "config5_strip512")


def cfg_at(streams):
    return {**BASE, "streams": streams, "block_frames": 1280}


def job_inputs(cfg, seed=SEED):
    fr, to = CONFIG.ratio(cfg)
    n_out = BLOCKS * cfg["block_frames"]
    n_in = n_out * fr // to + fr
    gen = signals.generator(seed, "cpu")
    rng = np.random.default_rng([seed, 0])
    S = cfg["streams"]
    corpus = signals.corpus(gen, rng, S, 2, n_in + 200, cfg["in_rate"], "cpu")
    gains = rng.uniform(0.5, 1.5, S).astype(np.float32) / np.float32(S)
    return corpus[:, 100:100 + n_in], gains, n_out


def render_job(pcm, gains, cfg):
    chain = CONFIG.job_chain(pcm, gains, cfg, torch.device("cpu"))
    state = chain.init_state()
    blocks = []
    for _ in range(BLOCKS):
        state, y, valid = chain.emit(state, cfg["block_frames"])
        assert int(valid) == cfg["block_frames"]
        blocks.append(y)
    return torch.cat(blocks, 1).to(torch.float64)


@pytest.fixture(scope="module")
def job():
    cfg = cfg_at(4)
    pcm, gains, n_out = job_inputs(cfg)
    return (cfg, pcm, gains, n_out, render_job(pcm, gains, cfg),
            REF.render(pcm, gains, cfg, n_out))


def test_the_job_chain_matches_the_reference(job):
    """4 streams: the AGC node's decomposed route (K8, the window's cumulative
    sum, K7's plain versions)."""
    _, _, _, _, got, want = job
    assert float((got - want).abs().max()) <= TOL
    assert float(want.abs().max()) > 0.5  # the mix is at unit scale


def test_the_job_chain_on_the_k6_route_matches_the_reference():
    """12 streams, past the decomposed route's 8: the AGC node runs K6's
    plain version, its running f32 window sum as on the card."""
    cfg = cfg_at(12)
    pcm, gains, n_out = job_inputs(cfg, SEED + 1)
    got = render_job(pcm, gains, cfg)
    assert float((got - REF.render(pcm, gains, cfg, n_out)).abs().max()) <= TOL


def test_the_strip_limiter_limits_this_input(job, monkeypatch):
    """The per-stream limiter's gain falls below 1 in the compared job, so
    the comparison holds it: the AGC brings each stream's peaks near full
    scale, over the limiter's -1 dB threshold and 4 dB knee."""
    cfg, pcm, gains, n_out, _, _ = job
    seen, gain = [], REF.strip_gain

    def kept(x, rate):
        seen.append(gain(x, rate))
        return seen[-1]

    monkeypatch.setattr(REF, "strip_gain", kept)
    REF.render(pcm, gains, cfg, n_out)
    g = torch.cat(seen)
    assert float(g.min()) < 0.95
    assert float((g < 0.99).double().mean()) > 0.5


#: the reference's stages, in the order it stores them: input, resampler,
#: low-pass, AGC, the strip's limiter, mix, master limiter
STAGES = ["input", "resample", "low_pass", "agc", "strip_limit", "mix", "limiter"]


@pytest.mark.parametrize("k", range(len(STAGES)), ids=STAGES)
def test_one_stage_stored_in_bfloat16_fails_the_tolerance(job, k, monkeypatch):
    cfg, pcm, gains, n_out, got, _ = job
    calls = []

    def stage(x, store):
        calls.append(len(calls))
        return common.stage(x, torch.bfloat16 if len(calls) - 1 == k else store)

    monkeypatch.setattr(REF, "stage", stage)
    low = REF.render(pcm, gains, cfg, n_out)
    assert len(calls) == len(STAGES)
    assert float((got - low).abs().max()) > TOL


@pytest.mark.parametrize("loud", [0.3, 1.5])
def test_the_batched_strip_limiter_equals_common_limiter(loud):
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((5, 2, 6000)) * loud)
    x[:, 1, 2000:2600] *= 4.0  # one channel alone over the knee: the coupling binds
    y = x * REF.strip_gain(x, 48000)
    for s in range(x.shape[0]):
        assert torch.equal(y[s], common.limiter(x[s], 48000))


@pytest.fixture(scope="module")
def span_counts():
    """Two jobs of the chain under a recorder: each span's count."""
    cfg = cfg_at(4)
    pcm, gains, _ = job_inputs(cfg)
    rec = trace.Spans("cpu")
    with trace.recording(rec):
        for _ in range(2):
            chain = CONFIG.job_chain(pcm, gains, cfg, torch.device("cpu"))
            state = chain.init_state()
            for _ in range(BLOCKS):
                state, _, _ = chain.emit(state, cfg["block_frames"])
    return {k: v["n"] for k, v in rec.summary().items()}


#: the spans the chain opens, and how many in two jobs of BLOCKS blocks:
#: the new ones (the resampler, the faders and the mixer once a block; the
#: buffer's one channel-major copy, for the resampler's gathers, once a job)
#: and those that were there (two limiters a block: the strip's, the master's)
SPANS = {"rodio.emit.Resample": 2 * BLOCKS, "rodio.emit.Amplify": 2 * BLOCKS,
         "rodio.emit.WideMixer": 2 * BLOCKS, "rodio.setup.channel_major": 2,
         "rodio.emit.BltFilter": 2 * BLOCKS, "rodio.emit.AutomaticGainControl": 2 * BLOCKS,
         "rodio.emit.Limit": 2 * 2 * BLOCKS}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_the_chain_opens_each_span_as_often_as_it_runs(span_counts, name):
    assert span_counts.get(name) == SPANS[name]
