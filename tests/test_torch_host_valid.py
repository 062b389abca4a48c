"""Block validity counted on the host (``Node.host_valid``), on the CPU.

``FusedWidePipeline`` computes each block's ``valid`` and drain flag from
host ints and zeroes only a partial block; ``Limit`` forwards its input's
host count and skips its mask on a block the host knows is full. These
tests hold both to the device path they replace: ``drain_bookkeeping`` on
the block's left taps and ``mask_block`` on the kernel's unmasked output,
bit for bit, through the end of the stream; and count which blocks skipped
the mask (``trace.counts["host_valid_block"]`` and
``["device_masked_block"]``).
"""
import numpy as np
import pytest
import torch

from rodio_tpu_torch import flagship
from rodio_tpu_torch.conversions.resample import (
    _resample_counts, host_drain_bookkeeping, lerp_left)
from rodio_tpu_torch.core.node import Node, mask_block
from rodio_tpu_torch.effects.blt import BltFilter
from rodio_tpu_torch.effects.limit import Limit, LimitSettings
from rodio_tpu_torch.flagship import FusedWidePipeline
from rodio_tpu_torch.ops.limiter_block import limiter_master
from rodio_tpu_torch.ops.resample import drain_bookkeeping
from rodio_tpu_torch.sources.generators import SamplesBuffer
from rodio_tpu_torch.utils import trace

FR, TO = 147, 160  # 44.1 -> 48 kHz
T = 640


class _HideCount(Node):
    """Its input as it is, but with no host count: the device path."""

    def __init__(self, inner):
        self.input, self.spec, self.device = inner, inner.spec, inner.device

    def init_state(self):
        return self.input.init_state()

    def emit(self, state, n):
        return self.input.emit(state, n)


def _pcm(S, frames, seed=7):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((2 * S, frames)) * 0.3).astype(np.float32)
    gains = rng.uniform(0.5, 1.5, S).astype(np.float32) / S
    return pcm, gains


def _fused(pcm, gains, S, start_frame=0, with_agc=False):
    buf = SamplesBuffer(2 * S, 44100, pcm, start_frame=start_frame, device="cpu")
    return FusedWidePipeline(buf, 48000, gains, S, with_agc=with_agc)


def _drain_len(lo):
    """An input length >= lo whose stream ends in a drain frame."""
    return next(k for k in range(lo, lo + 400) if _resample_counts(k, FR, TO)[1])


def _raw_emit(fused, state, n, monkeypatch):
    """The kernel's block before any validity is applied to it."""
    with monkeypatch.context() as m:
        m.setattr(flagship, "host_drain_bookkeeping",
                  lambda o0, n, n_in, drained, *a: (n, drained))
        return fused.emit(state, n)[1]


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_states_equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_host_bookkeeping_is_the_device_bookkeeping():
    """Every (o0, n, input length, drained) around a stream's end, at the
    config-5 ratio and a few others."""
    for fr, to in ((FR, TO), (TO, FR), (1, 2), (3, 7)):
        for n_in in (0, 1, 2, 5, 147, 1000, 1001):
            end = n_in * to // fr
            for o0 in sorted({*range(0, 12), *range(max(0, end - 20), end + 12)}):
                for n in (1, 3, 64, 160):
                    for drained in (False, True):
                        left = lerp_left(o0 + torch.arange(n), fr, to)
                        _, _, v, d = drain_bookkeeping(
                            left, torch.tensor(n_in), torch.tensor(drained), n)
                        assert host_drain_bookkeeping(
                            o0, n, n_in, drained, fr, to) == (int(v), bool(d))


@pytest.mark.parametrize("with_agc", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("start_frame", [0, 1001])
def test_fused_limit_through_the_drain(with_agc, start_frame, monkeypatch):
    """Through the end of the stream (full blocks, the partial block with
    its drain frame, blocks at valid 0): each block's valid and drain flag
    are drain_bookkeeping's, the fused block is mask_block of the kernel's
    output, and the Limit's blocks and states equal those of a Limit that
    masks on the device."""
    S = 4
    n_in = _drain_len(9000)
    pcm, gains = _pcm(S, n_in + start_frame)
    fused = _fused(pcm, gains, S, start_frame, with_agc)
    ours = Limit(fused, LimitSettings(), mode="pallas")
    theirs = Limit(_HideCount(_fused(pcm, gains, S, start_frame, with_agc)),
                   LimitSettings(), mode="pallas")
    s_ours, s_theirs = ours.init_state(), theirs.init_state()
    drained = torch.tensor(False)
    valids = []
    n_blocks = -(-fused.total_frames() // T) + 2
    for _ in range(n_blocks):
        fs = s_ours["in"]
        o0 = fs["out_o"]
        raw = _raw_emit(fused, fs, T, monkeypatch)
        left = lerp_left(o0 + torch.arange(T), FR, TO)
        _, _, v_dev, drained = drain_bookkeeping(
            left, torch.tensor(n_in), drained, T)
        _, blk, v = fused.emit(fs, T)
        assert torch.equal(blk, mask_block(raw, v_dev))

        s_ours, y, v = ours.emit(s_ours, T)
        s_theirs, y_dev, v_theirs = theirs.emit(s_theirs, T)
        assert v.dtype == torch.int64 and v.dim() == 0
        assert int(v) == int(v_dev) == int(v_theirs) == ours.host_valid(s_ours, T)
        assert s_ours["in"]["drained"] is bool(drained)
        assert torch.equal(y, y_dev)
        _assert_states_equal({**s_ours["in"], "drained": None, "n_valid": None},
                             {**s_theirs["in"], "drained": None, "n_valid": None})
        for k in ("integ", "peak"):
            assert torch.equal(s_ours[k], s_theirs[k])
        valids.append(int(v))
    partial = [v for v in valids if 0 < v < T]
    assert valids[0] == T and valids[-1] == 0 and len(partial) == 1
    assert sum(valids) == fused.total_frames()


def test_every_block_of_a_job_is_known_on_the_host():
    """A render job's shape (the jobs cell's: every output a full lerp, no
    drain frame) at 4 streams: the Limit skips its mask on all 40 blocks."""
    S, nb = 4, 40
    n_in = nb * T * FR // TO + FR
    pcm, gains = _pcm(S, n_in, seed=3)
    chain = Limit(_fused(pcm, gains, S), LimitSettings(), mode="pallas")
    state = chain.init_state()
    before = (trace.counts["host_valid_block"],
              trace.counts["device_masked_block"])
    valids = []
    for _ in range(nb):
        state, _, v = chain.emit(state, T)
        valids.append(v)
    after = (trace.counts["host_valid_block"],
             trace.counts["device_masked_block"])
    assert (after[0] - before[0], after[1] - before[1]) == (nb, 0)
    assert torch.stack(valids).tolist() == [T] * nb


def test_a_chain_with_no_host_count_masks_on_the_device():
    """Limit over BltFilter over a SamplesBuffer, past the buffer's end: no
    host count, so every block is masked on the device, and the blocks are
    the limiter's output masked against the filter's device valid."""
    frames, nb = 3 * T + 200, 5
    pcm = (np.random.default_rng(5).standard_normal((2, frames)) * 0.5).astype(np.float32)
    blt = BltFilter(SamplesBuffer(2, 48000, pcm, device="cpu"), "low_pass", 2000.0, 0.5)
    chain = Limit(blt, LimitSettings(), mode="pallas")
    state, bstate = chain.init_state(), blt.init_state()
    integ = peak = torch.zeros(2)
    before = (trace.counts["host_valid_block"],
              trace.counts["device_masked_block"])
    valids = []
    for _ in range(nb):
        state, y, v = chain.emit(state, T)
        assert chain.host_valid(state, T) is None
        bstate, x, bv = blt.emit(bstate, T)
        want, (integ, peak) = limiter_master(
            x, integ, peak, att=chain.attack, rel=chain.release,
            threshold=chain.threshold, knee_width=chain.knee_width,
            inv_knee_8=chain.inv_knee_8, P=min(128, T & -T))
        assert torch.equal(y, mask_block(want, bv))
        valids.append(int(v))
    after = (trace.counts["host_valid_block"],
             trace.counts["device_masked_block"])
    assert (after[0] - before[0], after[1] - before[1]) == (0, nb)
    assert valids == [T, T, T, 200, 0]
