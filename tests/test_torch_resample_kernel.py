"""The resampler's weight form over a buffer's PCM in one pass
(``rodio_tpu_torch/ops/resample.py``, ``csrc/resample_lerp.cu``).

On the CPU: the plain version against the weight form written out here in
numpy (each product and the sum rounded alone in the sample type) and the
drain rule in host ints (``host_drain_bookkeeping``), over a sweep of
positions, output offsets and block lengths across the drain frame; and the
route: a ``SamplesBuffer`` takes the pass, a ``PushPort`` keeps the torch
weight form, and the lerp form, the span form and the streaming ring never
reach it.

On the card (marker ``cuda``, skipped without one): the kernel bit-equal to
the plain version run on the same card, f32 and f64, at 2, 16 and 1024
lanes, for a first block, a block at an odd position after ``seek_state``,
a block not a multiple of the phase count, the block of the drain frame and
the blocks after it, and a window that runs past the end of the padding;
its ``valid``, ``drained`` and ``out_o`` those of ``drain_bookkeeping``; a
saved state emitted again gives the same block; one launch a block, none
for a ``PushPort``.
"""
import numpy as np
import pytest
import torch

from rodio_tpu_torch.conversions import resample as resample_mod
from rodio_tpu_torch.conversions import Resample, Uniform
from rodio_tpu_torch.conversions.resample import host_drain_bookkeeping, lerp_weights
from rodio_tpu_torch.ops import resample as ops_resample
from rodio_tpu_torch.sources.generators import SamplesBuffer
from rodio_tpu_torch.utils import trace
from test_torch_io_fixtures import resampled_feed

FR, TO = 147, 160  # 44.1 -> 48 kHz
#: 147 * 10 + 1 input frames end on a drain frame (output 1600 lands on the
#: last input frame); 147 * 10 do not
FRAMES = (147 * 10 + 1, 147 * 10)
PAD = 600


def _i64(v, dev="cpu"):
    return torch.tensor(v, dtype=torch.int64, device=dev)


def _bool(v, dev="cpu"):
    return torch.tensor(v, dtype=torch.bool, device=dev)


def numpy_weight_form(data, start, in_end, out_o, drained, n, fr, to):
    """The weight form over ``data`` [C, W] in numpy, each op rounded in the
    sample type, with the drain rule in host ints: (block, valid,
    drained')."""
    dt = data.dtype.type
    w0, w1 = lerp_weights(fr, to, dt)
    o = out_o + np.arange(n)
    left = (o // to) * fr + (fr * (o % to)) // to
    padded = np.pad(data, ((0, 0), (0, 2 * n + 4)))  # zero past the buffer, as its gathers
    lval, rval = padded[:, start + left], padded[:, start + left + 1]
    out = lval * w0[o % to][None, :] + rval * w1[o % to][None, :]
    valid, drained_new = host_drain_bookkeeping(out_o, n, in_end, drained, fr, to)
    n_full, _ = host_drain_bookkeeping(out_o, n, in_end, False, fr, to)
    if n_full > 0 and left[n_full - 1] == in_end - 1:  # the block's drain frame
        out[:, n_full - 1] = lval[:, n_full - 1]
    out[:, valid:] = 0
    return out, valid, drained_new


@pytest.mark.parametrize("drained", [False, True])
@pytest.mark.parametrize("n", [1, 7, 160, 333])
@pytest.mark.parametrize("out_o", [0, 1596, 1600, 1700])
@pytest.mark.parametrize("frames,pos", [(f, p) for f in FRAMES for p in (0, 3)])
def test_plain_matches_the_weight_form_and_host_bookkeeping(frames, pos, out_o, n, drained):
    """The plain version against the weight form in numpy and
    ``host_drain_bookkeeping``: the block bit for bit, ``valid``,
    ``drained`` and the new ``out_o``, at output offsets before, on and past
    the drain frame."""
    rng = np.random.default_rng([frames, pos, out_o, n])
    data = np.zeros((3, frames + PAD), np.float32)
    data[:, :frames] = rng.uniform(-1, 1, (3, frames))
    in_end = frames - pos
    w0, w1 = (torch.from_numpy(w) for w in lerp_weights(FR, TO, np.float32))
    block, out_o_new, valid, drained_new = ops_resample.resample_lerp_plain(
        torch.from_numpy(data), _i64(pos), _i64(in_end), _i64(out_o), _bool(drained), w0, w1,
        n, FR, TO)
    want, want_valid, want_drained = numpy_weight_form(data, pos, in_end, out_o, drained, n,
                                                       FR, TO)
    assert block.dtype == torch.float32 and block.shape == (3, n)
    np.testing.assert_array_equal(block.numpy().view(np.uint32), want.view(np.uint32))
    assert (int(valid), bool(drained_new), int(out_o_new)) == (want_valid, want_drained,
                                                               out_o + n)


def _record(monkeypatch, name):
    """Count the calls of ``conversions.resample.<name>``."""
    calls = []
    fn = getattr(resample_mod, name)

    def wrapped(*args, **kw):
        calls.append(args)
        return fn(*args, **kw)

    monkeypatch.setattr(resample_mod, name, wrapped)
    return calls


def _refuse(monkeypatch, *names):
    def refused(*args, **kw):
        raise AssertionError("this route must not run")

    for name in names:
        monkeypatch.setattr(resample_mod, name, refused)


def test_a_buffer_takes_the_pass(monkeypatch):
    """A ``SamplesBuffer`` input: every block of the weight form through
    ``resample_lerp`` on the buffer's PCM, nothing through the lerp form,
    the ring or the torch weight form; the render equals the plain
    version's, block by block."""
    rng = np.random.default_rng(5)
    data = rng.uniform(-1, 1, (2, 2000)).astype(np.float32)
    buf = SamplesBuffer(2, 44100, data, device="cpu")
    node = Resample(buf, 48000)
    assert node.uses_weight_form(640)
    calls = _record(monkeypatch, "resample_lerp")
    _refuse(monkeypatch, "lerp_block_plain")
    monkeypatch.setattr(Resample, "_lerp", lambda *a: pytest.fail("the lerp form ran"))
    monkeypatch.setattr(Resample, "_emit_ring", lambda *a: pytest.fail("the ring ran"))
    state = node.init_state()
    for _ in range(5):
        want = ops_resample.resample_lerp_plain(
            buf.pcm(state["in"]), state["in"]["pos"], state["in"]["end"] - state["in"]["pos"],
            state["out_o"], state["drained"], node._w0, node._w1, 640, FR, TO)
        state, block, valid = node.emit(state, 640)
        assert torch.equal(block, want[0]) and int(valid) == int(want[2])
        assert int(state["out_o"]) == int(want[1]) and bool(state["drained"]) == bool(want[3])
    assert len(calls) == 5 and all(c[0] is buf.pcm(state["in"]) for c in calls)
    assert int(valid) == 0 and bool(state["drained"])


@pytest.mark.parametrize("route", ["push_port", "lerp_form", "span_form", "ring"])
def test_other_inputs_do_not_take_the_pass(monkeypatch, route):
    """A ``PushPort`` keeps the torch weight form (``lerp_block_plain``
    through its wrapped gathers); the lerp form (a window past the
    buffer's padding), the span form (``Uniform``'s segments) and the
    streaming ring (an upstream that is not random-access) never reach the
    pass."""
    rng = np.random.default_rng(7)
    data = rng.uniform(-1, 1, (2, 3000)).astype(np.float32)
    _refuse(monkeypatch, "resample_lerp")
    plain = _record(monkeypatch, "lerp_block_plain")
    if route == "push_port":
        node, out = resampled_feed(data, 44100, 48000, 640, 3)
        assert len(plain) == 3 and out.shape == (2, 3 * 640)
        return
    if route == "lerp_form":
        node = Resample(SamplesBuffer(2, 44100, data, pad_frames=64, device="cpu"), 48000)
    elif route == "span_form":
        node = Uniform(SamplesBuffer(2, 44100, data.T.reshape(-1), device="cpu"), 2, 48000,
                       rodio_compat=True)
    else:
        node = Resample(SamplesBuffer(2, 44100, data, device="cpu").amplify(0.5), 48000,
                        max_block=640)
    state = node.init_state()
    for _ in range(3):
        state, block, _ = node.emit(state, 640)
        assert block.shape == (2, 640)
    assert plain == []


def test_the_pass_refuses_other_devices():
    """A tensor on neither the CPU nor a card is refused, not resampled."""
    data = torch.zeros((2, 64), device="meta")
    scalar = torch.zeros((), dtype=torch.int64, device="meta")
    w = torch.zeros(TO, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops_resample.resample_lerp(data, scalar, scalar, scalar, scalar.bool(), w, w, 16, FR, TO)


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _entry(dtype):
    return "rt_resample_lerp" + ("_f64" if dtype == torch.float64 else "")


def _check_kernel(data, start, in_end, out_o, drained, n, fr=FR, to=TO):
    """The kernel against the plain version on the same card, bit for bit,
    in one launch; its scalars against ``drain_bookkeeping``'s."""
    dev, dt = data.device, data.dtype
    w0, w1 = (torch.from_numpy(w).to(dev) for w in lerp_weights(fr, to, np.float64
                                                                 if dt == torch.float64
                                                                 else np.float32))
    args = (_i64(start, dev), _i64(in_end, dev), _i64(out_o, dev), _bool(drained, dev), w0, w1,
            n, fr, to)
    before = trace.counts[_entry(dt)]
    got = ops_resample.resample_lerp(data, *args)
    assert trace.counts[_entry(dt)] == before + 1
    want = ops_resample.resample_lerp_plain(data, *args)
    torch.cuda.synchronize()
    assert got[0].dtype == dt and got[0].shape == want[0].shape
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    o = args[2] + torch.arange(n, device=dev)
    left = (o // to) * fr + (fr * (o % to)) // to
    _, _, valid, drained_new = ops_resample.drain_bookkeeping(left, args[1], args[3], n)
    assert int(got[2]) == int(valid) == int(want[2])
    assert bool(got[3]) == bool(drained_new) == bool(want[3])
    assert int(got[1]) == out_o + n == int(want[1])
    for g in got[1:]:
        assert g.dim() == 0 and g.device == dev
    return got


#: (start, in_end, out_o, n) over a [lanes, 1471 + PAD] buffer of 1471
#: frames: a first block; a block at an odd position (seek_state's frame
#: 301); n not a multiple of the phase count; the block of the drain frame
#: (output 1600 lands on frame 1470); the blocks after it; a window that
#: runs past the end of the padding (taps read as zeros)
CARD_CASES = {
    "first_block": (0, 1471, 0, 1280),
    "odd_position": (301, 1170, 0, 640),
    "ragged_n": (0, 1471, 160, 333),
    "drain_block": (0, 1471, 1280, 640),
    "after_drain": (0, 1471, 1920, 640),
    "past_the_padding": (1471 + PAD - 300, 10**6, 0, 641),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes", [2, 16, 1024])
def test_kernel_matches_plain_on_card(dev, lanes, dtype, case):
    start, in_end, out_o, n = CARD_CASES[case]
    rng = np.random.default_rng([lanes, n, out_o])
    data = torch.zeros((lanes, 1471 + PAD), dtype=dtype, device=dev)
    data[:, :1471] = torch.from_numpy(rng.uniform(-1, 1, (lanes, 1471))).to(dev, dtype)
    got = _check_kernel(data, start, in_end, out_o, False, n)
    if case == "drain_block":
        valid = int(got[2])
        assert valid == 1600 - 1280 + 1 and torch.equal(got[0][:, valid - 1], data[:, 1470])
    if case == "after_drain":
        assert int(got[2]) == 0 and not got[0].any()
    got = _check_kernel(data, start, in_end, out_o, True, n)
    assert int(got[2]) == 0 and not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_at_the_cell_block(dev, dtype):
    """The strip cell's block: 1024 lanes of a [1024, 482835] buffer (odd
    rows: every lane starts off a 16-byte boundary its own way), n = 12800,
    at a start deep in the buffer and an odd output offset."""
    rng = np.random.default_rng(12800)
    data = torch.from_numpy(rng.uniform(-1, 1, (1024, 482835))).to(dev, dtype)
    _check_kernel(data, 1001, 470547 - 1001, 12800 * 7 + 3, False, 12800)


@pytest.mark.cuda
def test_resample_node_on_card(dev):
    """``Resample(SamplesBuffer)`` on the card: one launch a block and no
    other route; each block bit-equal to the plain version over the same
    state; a saved state emitted again gives the same block (nothing
    written in place); blocks past the drain are zero; a ``PushPort`` input
    launches nothing."""
    rng = np.random.default_rng(11)
    data = rng.uniform(-1, 1, (4, 1471)).astype(np.float32)
    buf = SamplesBuffer(4, 44100, data, device=dev)
    node = Resample(buf, 48000)
    state = node.init_state()
    state = {**state, "in": buf.seek_state(state["in"], 37 / 44100 + 1e-9)}
    assert int(state["in"]["pos"]) == 37
    saved, blocks = [], []
    for _ in range(5):
        before = trace.counts["rt_resample_lerp"]
        want = ops_resample.resample_lerp_plain(
            buf.pcm(state["in"]), state["in"]["pos"], state["in"]["end"] - state["in"]["pos"],
            state["out_o"], state["drained"], node._w0, node._w1, 500, FR, TO)
        saved.append(state)
        state, block, valid = node.emit(state, 500)
        blocks.append(block)
        assert trace.counts["rt_resample_lerp"] == before + 1
        assert torch.equal(_bits(block), _bits(want[0])) and int(valid) == int(want[2])
        assert bool(state["drained"]) == bool(want[3])
    assert int(valid) == 0 and bool(state["drained"])
    for s, block in zip(saved, blocks):
        assert torch.equal(_bits(node.emit(s, 500)[1]), _bits(block))
    before = trace.counts["rt_resample_lerp"]
    resampled_feed(data, 44100, 48000, 640, 3, device=dev)
    assert trace.counts["rt_resample_lerp"] == before
