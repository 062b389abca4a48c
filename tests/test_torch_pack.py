"""The buffer's one pass onto the device (``rodio_tpu_torch/ops/pack.py``) on
the CPU: its plain version against the construction it replaced (a zero
fill, the copy of the data into it, then the fused pipeline's transposed
copy from the start frame; kept below as it was), the buffer's value
semantics, which consumers make the channel-major copy, and a render job of
the benchmark's configurations bit-equal to one over the old construction.
The kernel is held to the plain version on the card in
``test_torch_cuda.py``; its flags are tested in ``test_torch_probe.py``.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from rodio_tpu_torch.flagship import FusedWidePipeline
from rodio_tpu_torch.io.decoder import Decoder, LoopedDecoder, decode_bytes
from rodio_tpu_torch.ops import pack
from rodio_tpu_torch.sources.generators import SamplesBuffer
from rodio_tpu_torch.utils import trace
from test_torch_io_fixtures import pcm16_master, write_pcm_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD = 40


def old_buffer(arr: torch.Tensor, pad: int) -> torch.Tensor:
    """SamplesBuffer's channel-major buffer as it was built: zeros, then the
    data copied in."""
    data_t = torch.zeros((arr.shape[0], arr.shape[1] + pad), dtype=arr.dtype)
    data_t[:, : arr.shape[1]] = arr
    return data_t


def old_time_major(arr: torch.Tensor, pad: int, start: int = 0) -> torch.Tensor:
    """FusedWidePipeline's time-major PCM as ``init_state`` copied it."""
    return old_buffer(arr, pad)[:, start:].T.contiguous()


def source(C: int, frames: int, offset: int, layout: str, seed: int = 0):
    """(the source as the buffer takes it, its [C, frames] view): a slice
    at ``offset`` of a wider [C, ...] corpus, or 1-D interleaved PCM from
    ``offset`` of a longer array."""
    rng = np.random.default_rng(seed + C * 16 + offset)
    if layout == "slice":
        corpus = torch.from_numpy(
            (rng.integers(-32768, 32768, (C, frames + 9)) / 32768.0).astype(np.float32))
        src = corpus[:, offset:offset + frames]
        return src, src
    flat = torch.from_numpy(
        (rng.standard_normal(offset + frames * C + 3) * 0.3).astype(np.float32))
    data = flat[offset:offset + frames * C]
    return data, data.reshape(frames, C).T


@pytest.mark.parametrize("layout", ["slice", "interleaved"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("C", [1, 2, 1024])
def test_plain_pack_equals_the_old_construction(C, offset, layout):
    """The pack of a strided slice (an offset 0-3 mod 4 into a wider
    corpus) or of 1-D interleaved PCM, bit-equal to the old construction,
    its flags those of the old buffer; through ``SamplesBuffer`` with a
    start frame, its time-major view and its channel-major ``"data"``
    too."""
    frames = 21 if C == 1024 else 333
    data, view = source(C, frames, offset, layout)
    assert layout == "interleaved" or view.stride() == (frames + 9, 1)
    tm, fails = pack.pack_time_major(view, frames + PAD)
    assert tm.shape == (frames + PAD, C) and tm.is_contiguous()
    assert torch.equal(tm, old_time_major(view, PAD))
    assert torch.equal(fails, pack.probe_fails_plain(old_buffer(view, PAD)))
    for start in (0, 5):
        buf = SamplesBuffer(C, 44100, data, start_frame=start, pad_frames=PAD, device="cpu")
        assert torch.equal(buf.time_major(), old_time_major(view, PAD, start))
        assert buf.time_major().data_ptr() == buf.time_major().data_ptr()
        assert torch.equal(buf.init_state()["data"], old_buffer(view, PAD))
        assert buf.content_flags() == pack.content_flags(fails)


def test_plain_pack_f64_has_no_flags():
    """A float64 source packs as a float32 one does, without the flags; a
    buffer built under ``set_float64`` refuses to give them."""
    from rodio_tpu_torch.core import types

    arr = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 50)))
    tm, fails = pack.pack_time_major(arr[:, 1:], 60)
    assert fails is None and torch.equal(tm, old_time_major(arr[:, 1:], 11))
    was = types.float64_enabled()
    types.set_float64(True)
    try:
        buf = SamplesBuffer(3, 44100, arr, start_frame=2, pad_frames=PAD, device="cpu")
    finally:
        types.set_float64(was)
    assert buf.time_major().dtype == torch.float64
    assert torch.equal(buf.time_major(), old_time_major(arr, PAD, 2))
    with pytest.raises(ValueError, match="float32"):
        buf.content_flags()


@pytest.mark.parametrize("kind", ["tensor", "numpy", "interleaved"])
def test_writing_into_the_callers_data_changes_nothing_rendered(kind):
    """The buffer owns its PCM: a write into the caller's tensor or array
    after ``SamplesBuffer(...)`` changes neither the fused render nor the
    unfused one."""
    rng = np.random.default_rng(5)
    arr = (rng.integers(-32768, 32768, (4, 3000)) / 32768.0).astype(np.float32)

    def build():
        if kind == "tensor":
            data = torch.from_numpy(arr.copy())
        elif kind == "numpy":
            data = arr.copy()
        else:
            data = np.ascontiguousarray(arr.T).reshape(-1)
        return data, SamplesBuffer(4, 44100, data, device="cpu")

    def render(buf):
        fused = FusedWidePipeline(buf, 48000, np.full(2, 0.5, np.float32), 2)
        _, y, _ = fused.emit(fused.init_state(), 640)
        _, blk, _ = buf.emit(buf.init_state(), 640)
        return y, blk

    _, want = build()
    want = render(want)
    data, buf = build()
    data[...] = 0.25  # after the buffer was built
    for got, ref in zip(render(buf), want):
        assert torch.equal(got, ref)


def test_fused_job_never_makes_the_channel_major_copy():
    """A fused job reads the time-major buffer in place: no channel-major
    copy, and the pipeline's ``"pcm"`` is the buffer's own view. An unfused
    chain's first ``init_state`` makes the copy, its later ones reuse it."""
    arr = np.random.default_rng(2).standard_normal((4, 2000)).astype(np.float32)
    buf = SamplesBuffer(4, 44100, arr, start_frame=7, device="cpu")
    before = trace.counts["channel_major_copy"]
    fused = FusedWidePipeline(buf, 48000, np.full(2, 0.5, np.float32), 2)
    state = fused.init_state()
    state, _, _ = fused.emit(state, 640)
    assert trace.counts["channel_major_copy"] == before
    assert state["pcm"].data_ptr() == buf.time_major().data_ptr()
    assert "in" not in state
    buf.init_state()
    buf.init_state()
    assert trace.counts["channel_major_copy"] == before + 1


def test_decoders_give_todays_buffers_and_blocks(tmp_path):
    """``Decoder`` and ``LoopedDecoder`` over a WAV: the channel-major PCM
    bit-equal to the old construction (the looped one with its head in the
    zero tail), and their blocks gathered from it."""
    path = str(tmp_path / "t.wav")
    write_pcm_wav(path, pcm16_master(4, 2, 5000)[0], 44100, 16)
    with open(path, "rb") as f:
        pcm, _ = decode_bytes(f.read())
    old = old_buffer(torch.from_numpy(np.asarray(pcm, np.float32)), Decoder.PAD_FRAMES)
    dec = Decoder(path, device="cpu")
    assert torch.equal(dec.init_state()["data"], old)
    _, blk, _ = dec.emit(dec.init_state(), 512)
    assert torch.equal(blk, old[:, :512])
    looped = LoopedDecoder(path, device="cpu")
    frames = pcm.shape[1]
    old_looped = old.clone()
    old_looped[:, frames:2 * frames] = old[:, :frames]
    assert torch.equal(looped.init_state()["data"], old_looped)
    st = looped.init_state()
    for _ in range(12):
        st, blk, _ = looped.emit(st, 512)
    idx = (np.arange(11 * 512, 12 * 512)) % frames
    assert torch.equal(blk, old[:, idx])


def _config(name, streams):
    sys.path.insert(0, ROOT)
    from gpubench import harness

    bench = os.path.join(ROOT, "gpubench")
    cfg = json.load(open(os.path.join(bench, "configs", f"{name}.json")))
    cfg["streams"] = streams
    cfg["block_frames"] = 1280
    return harness.load_module(os.path.join(bench, "configs", f"{name}.py"),
                               f"pack_test_{name}"), cfg


@pytest.mark.parametrize("name", ["config5_mix512", "config5_agc512"])
def test_bench_job_renders_bit_equal_to_the_old_construction(name):
    """A job built as the benchmark builds it (``job_chain`` over a slice
    of a wider corpus at an odd offset): its PCM and its blocks bit-equal to
    the same chain over the PCM the old construction made."""
    config, cfg = _config(name, 4)
    fr, to = config.ratio(cfg)
    n_in = 3 * cfg["block_frames"] * fr // to + fr
    rng = np.random.default_rng(9)
    corpus = torch.from_numpy(
        (rng.integers(-32768, 32768, (8, n_in + 50)) / 32768.0).astype(np.float32))
    gains = rng.uniform(0.5, 1.5, 4).astype(np.float32) / np.float32(4)
    chain = config.job_chain(corpus[:, 13:13 + n_in], gains, cfg, "cpu")
    state = chain.init_state()
    pad = chain.input.input.PAD_FRAMES
    old = old_time_major(corpus[:, 13:13 + n_in], pad)
    assert torch.equal(state["in"]["pcm"], old)
    old_state = {**state, "in": {**state["in"], "pcm": old}}
    for _ in range(3):
        state, y, v = chain.emit(state, cfg["block_frames"])
        old_state, y_old, v_old = chain.emit(old_state, cfg["block_frames"])
        assert torch.equal(y, y_old) and int(v) == int(v_old)
