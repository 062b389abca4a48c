"""The port's streaming farm (M8) against the JAX package on the CPU.

Every file is written in-process (16-bit-grid WAV from seeded noise). The
JAX farms open them through a WAV reader local to this file with
``FfStream``'s interface, patched over ``rodio_tpu.io.native.FfStream``
(the JAX pool opens every path with it); the port's farms through its
own ``io.streaming.WavStream``. The JAX fused farm runs its Pallas K1 in
interpret mode, as its ``FusedFarmPipeline.emit`` chooses off the TPU.

Bounds: port against JAX 2e-6 on the fused farm (the JAX kernel's
bf16-piece MXU lerp and its push-time gain fold are rounded apart from the
port's f32 lerp with the gain after it), 1e-6 on the unfused chain; fused
against unfused 2e-6 (tests/test_streaming_farm.py:255-283); the i16 and
i24 wires as there.
"""
import os
import wave

import jax
import numpy as np
import pytest
import torch

from rodio_tpu_torch.parallel.farm import StreamFarm, _wire_decode, _wire_encode
from test_torch_io_fixtures import bounded, pcm16_master, write_pcm_wav

RATE = 44100


class _JaxWav:
    """A 16-bit PCM WAV file with FfStream's interface, read whole at open
    with the standard library's ``wave`` (the JAX side's reader)."""

    def __init__(self, path):
        with wave.open(str(path), "rb") as w:
            assert w.getsampwidth() == 2
            self.channels, self.sample_rate = w.getnchannels(), w.getframerate()
            raw = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        self._pcm = (raw.reshape(-1, self.channels).T.astype(np.float32)
                     / np.float32(32768.0))
        self.duration = self._pcm.shape[1] / self.sample_rate
        self._pos = 0

    def read(self, n):
        out = self._pcm[:, self._pos:self._pos + n]
        self._pos += out.shape[1]
        return np.ascontiguousarray(out)

    def take_param_change(self):
        return None

    def seek(self, seconds):
        self.seek_accurate(seconds)

    def seek_accurate(self, seconds=None, *, frames=None):
        t = int(frames) if frames is not None else int(round(seconds * self.sample_rate))
        self._pos = min(max(t, 0), self._pcm.shape[1])
        return self._pos

    def close(self):
        pass


@pytest.fixture
def jax_wav(monkeypatch):
    from rodio_tpu.io import native

    monkeypatch.setattr(native, "FfStream", _JaxWav)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four seeded 2 s 16-bit stereo WAVs at 44.1 kHz."""
    d = tmp_path_factory.mktemp("farm")
    paths = []
    for i in range(4):
        k, _ = pcm16_master(40 + i, 2, 2 * RATE)
        p = str(d / f"s{i}.wav")
        write_pcm_wav(p, k, RATE, 16)
        paths.append(p)
    return paths


def _run(farm, blocks):
    outs = []
    res = farm.run(blocks, on_block=lambda k, o, v: outs.append(
        np.asarray(o)[:, :int(v)] if isinstance(o, jax.Array) else o[:, :int(v)].numpy()))
    farm.close()
    return np.concatenate(outs, axis=1), res


def _jax_farm(paths, **kw):
    from rodio_tpu.parallel.farm import StreamFarm as JaxFarm

    return JaxFarm(paths, **kw)


def test_wav_stream_reads_and_seeks_like_the_whole_file(corpus):
    from rodio_tpu_torch.io.streaming import WavStream

    whole = _JaxWav(corpus[0])._pcm
    s = WavStream(corpus[0])
    assert (s.channels, s.sample_rate) == (2, RATE)
    parts = [s.read(10000) for _ in range(10)]
    np.testing.assert_array_equal(np.concatenate(parts, 1), whole)
    assert s.read(5).shape == (2, 0)
    assert s.seek_accurate(1.25) == int(round(1.25 * RATE))
    np.testing.assert_array_equal(s.read(300), whole[:, 55125:55425])
    assert s.take_param_change() is None
    s.close()


def test_host_pool_opens_other_formats_through_libav(tmp_path):
    """A non-WAV path goes to FfStream; without libav it raises by name."""
    from rodio_tpu_torch.io import native
    from rodio_tpu_torch.parallel.farm import HostDecodePool
    from test_torch_io_fixtures import write_flac

    k, _ = pcm16_master(3, 2, 4410)
    p = str(tmp_path / "a.flac")
    write_flac(p, k, RATE)
    if native.missing_libav_headers():
        with pytest.raises(native.LibavUnavailable):
            HostDecodePool([p], out_rate=48000)
    else:
        pool = HostDecodePool([p], out_rate=48000)
        assert pool.spec_in.channels == 2
        pool.close()


@bounded(60)
def test_stream_farm_matches_whole_file_chain_and_jax(corpus, jax_wav):
    """The unfused farm (PushPort -> Resample -> BltFilter -> Amplify ->
    WideMixer -> Limit) equals the whole-file chain and the JAX farm."""
    from rodio_tpu_torch.conversions.resample import Resample
    from rodio_tpu_torch.effects.basic import Amplify
    from rodio_tpu_torch.effects.blt import BltFilter
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.graph.render import render_blocks
    from rodio_tpu_torch.parallel.batch import WideMixer
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    S, n, blocks = 4, 1024, 12
    got, (valid, energy, overflow) = _run(StreamFarm(
        corpus, block_frames=n, loop=False, decode_workers=4, device="cpu"), blocks)
    assert not overflow and valid == blocks * n and energy > 0
    want, (jv, je, jo) = _run(_jax_farm(corpus, block_frames=n, loop=False,
                                        decode_workers=4), blocks)
    assert (jv, jo) == (valid, overflow)
    np.testing.assert_allclose(got, want, atol=1e-6)

    pcm = np.concatenate([_JaxWav(p)._pcm for p in corpus], 0)
    chain = Resample(SamplesBuffer(S * 2, RATE, pcm, device="cpu"), 48000, max_block=n)
    chain = BltFilter(chain, "low_pass", 2000.0, 0.5)
    chain = Amplify(chain, np.repeat(np.full(S, 1.0 / S, np.float32), 2))
    master = Limit(WideMixer(chain, S), LimitSettings(), mode="auto")
    _, exp, _ = render_blocks(master, master.init_state(), blocks, n)
    np.testing.assert_allclose(got, exp.numpy(), atol=1e-6)


@bounded(60)
def test_stream_farm_loop_and_offsets_run(corpus):
    farm = StreamFarm(corpus[:3], block_frames=1024, loop=True,
                      start_offsets=[0.0, 0.7, 1.5], decode_workers=3, device="cpu")
    out, (valid, energy, overflow) = _run(farm, 6)
    assert valid == 6 * 1024 and not overflow and energy > 0
    assert np.isfinite(out).all()


@bounded(90)
def test_stream_farm_fused_matches_unfused_and_jax(corpus, jax_wav):
    """The fused farm (K1's ring mode's plain version) against the unfused
    one at 2e-6, and against the JAX fused farm at 2e-6, with staggered
    offsets that loop and uneven gains."""
    kw = dict(block_frames=1280, loop=True, decode_workers=4,
              start_offsets=[0.0, 0.4, 1.3, 1.9],
              gains=np.array([0.1, 0.3, 0.2, 0.25], np.float32))
    outs = {}
    for fused in (False, True):
        outs[fused], (v, e, o) = _run(StreamFarm(corpus, fused=fused, device="cpu", **kw), 6)
        assert v == 6 * 1280 and not o and e > 0
    np.testing.assert_allclose(outs[True], outs[False], atol=2e-6)
    want, (jv, _, jo) = _run(_jax_farm(corpus, fused=True, **kw), 6)
    assert (jv, jo) == (6 * 1280, False)
    np.testing.assert_allclose(outs[True], want, atol=2e-6)


@bounded(60)
def test_stream_farm_heterogeneous_corpus(tmp_path, corpus, jax_wav):
    """44.1 kHz stereo, 48 kHz mono and 22.05 kHz stereo WAVs: each stream
    uniformized on the host (_UniformStream), as the JAX farm does."""
    rng = np.random.default_rng(11)
    p48, p22 = str(tmp_path / "mono48.wav"), str(tmp_path / "st22.wav")
    write_pcm_wav(p48, np.round(rng.standard_normal((1, 48000)) * 8000).astype(np.int16),
                  48000, 16)
    write_pcm_wav(p22, np.round(rng.standard_normal((2, 22050)) * 8000).astype(np.int16),
                  22050, 16)
    paths = [corpus[0], p48, p22]
    farm = StreamFarm(paths, block_frames=1024, loop=False, decode_workers=3, device="cpu")
    assert (farm.spec_in.channels, farm.spec_in.sample_rate) == (2, 48000)
    got, (v, e, o) = _run(farm, 12)
    want, (jv, _, jo) = _run(_jax_farm(paths, block_frames=1024, loop=False,
                                       decode_workers=3), 12)
    assert (v, o) == (jv, jo) and e > 0
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("fused", [False, True])
@bounded(60)
def test_stream_farm_i24_wire(corpus, fused):
    """The i24 wire against the f32 wire: 16-bit content is exact on it."""
    n = 1280 if fused else 1024
    outs = {}
    for wire in ("f32", "i24"):
        outs[wire], (v, e, o) = _run(StreamFarm(
            corpus[:3], block_frames=n, loop=False, decode_workers=3, wire=wire,
            fused=fused, device="cpu"), 6)
        assert v == 6 * n and not o and e > 0
    np.testing.assert_allclose(outs["i24"], outs["f32"], atol=4e-7)


@bounded(60)
def test_stream_farm_fused_i16_wire(corpus):
    """The i16 wire on the fused farm: the JAX feed's lossless int2 layout
    with the gains after the lerp; here f32 either way, 16-bit content
    exact on the wire."""
    outs = {}
    for wire in ("f32", "i16"):
        farm = StreamFarm(corpus, block_frames=1280, loop=False, decode_workers=4,
                          fused=True, wire=wire, device="cpu")
        assert (farm.feed.npc, farm.feed.gain_post) == ((2, True) if wire == "i16"
                                                        else (3, False))
        outs[wire], (v, e, o) = _run(farm, 8)
        assert v == 8 * 1280 and not o and e > 0
    np.testing.assert_allclose(outs["i16"], outs["f32"], atol=5e-7)


def test_wire_codecs_match_jax():
    """Host encode -> device decode: exact to 2^-24 (i24) and exact on the
    16-bit grid, equal to the JAX package's codec."""
    from rodio_tpu.parallel import farm as jfarm

    rng = np.random.default_rng(7)
    x = rng.uniform(-1.0, 1.0, (4, 256)).astype(np.float32)
    x[0, :64] = np.round(x[0, :64] * 32768.0) / 32768.0
    x[0, 64], x[0, 65] = -1.0, 1.0 - 2.0 ** -23
    for wire in ("f32", "i16", "i24"):
        enc = _wire_encode(x, wire)
        np.testing.assert_array_equal(enc, jfarm._wire_encode(x, wire))
        dec = _wire_decode(torch.from_numpy(np.ascontiguousarray(enc)), wire).numpy()
        np.testing.assert_array_equal(dec, np.asarray(jfarm._wire_decode(enc, wire)))
        if wire == "i24":
            assert enc.dtype == np.uint8 and enc.shape == (4, 256, 3)
            np.testing.assert_allclose(dec, x, atol=2.0 ** -24)
            np.testing.assert_array_equal(dec[0, :66], x[0, :66])


def test_farm_for_the_card_raises_without_one(corpus):
    """device=None means the card: with none, the farm raises (no fallback
    to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        StreamFarm(corpus[:1], block_frames=1280, fused=True)


def test_fused_farm_refuses_the_identity_ratio(tmp_path):
    """ROADMAP F3: a 48 kHz corpus cannot take the fused path, as in JAX."""
    k, _ = pcm16_master(1, 2, 4800)
    p = str(tmp_path / "a48.wav")
    write_pcm_wav(p, k, 48000, 16)
    with pytest.raises(ValueError, match="non-identity"):
        StreamFarm([p], block_frames=640, fused=True, device="cpu")


@bounded(60)
def test_farm_try_seek_equals_start_offsets(corpus, jax_wav):
    """try_seek before the first block == start_offsets; the frame reached
    equals the JAX farm's."""
    t = 1.25
    a, _ = _run(StreamFarm(corpus[:2], block_frames=1024, start_offsets=[0.0, t],
                           loop=False, device="cpu"), 3)
    fb = StreamFarm(corpus[:2], block_frames=1024, loop=False, device="cpu")
    got = fb.try_seek(1, t)
    jf = _jax_farm(corpus[:2], block_frames=1024, loop=False)
    assert got == jf.try_seek(1, t) == int(round(t * RATE))
    jf.close()
    b, _ = _run(fb, 3)
    np.testing.assert_array_equal(a, b)


@bounded(60)
def test_farm_try_seek_live_keeps_producing(corpus):
    """A seek mid-run: full-valid blocks go on, audio keeps flowing."""
    farm = StreamFarm(corpus[:1], block_frames=1024, loop=True, device="cpu")
    seen = []

    def on_block(k, out, v):
        seen.append((int(v), float(out.abs().max())))
        if k == 1:
            farm.try_seek(0, 1.6)

    farm.run(6, on_block=on_block)
    farm.close()
    assert len(seen) == 6 and all(v == 1024 for v, _ in seen)
    assert all(m > 0.0 for _, m in seen[2:])


# -- K1's ring mode (ChunkRingFeed, FusedFarmPipeline) against JAX -------------

def _ring_pair(S=4, n=640, gain_post=True, seed=5):
    """The same feed and pipeline in both packages (i16-wire layout when
    gain_post: int2 pieces, raw ring)."""
    from rodio_tpu import flagship as jflag
    from rodio_tpu.effects.limit import Limit as JLimit, LimitSettings as JSettings
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.flagship import ChunkRingFeed, FusedFarmPipeline

    rng = np.random.default_rng(seed)
    gains = np.repeat(rng.uniform(0.5, 1.5, S).astype(np.float32) / S, 2)
    fr, Kp = 147, n // 160
    prec = "int2" if gain_post else "int3"
    jfeed = jflag.ChunkRingFeed(S * 2, RATE, fr, Kp, 4 * Kp, prec, gains, gain_post=gain_post)
    jm = JLimit(jflag.FusedFarmPipeline(jfeed, 48000, S), JSettings(), mode="auto")
    feed = ChunkRingFeed(S * 2, RATE, fr, Kp, 4 * Kp, prec, gains, gain_post=gain_post,
                         device="cpu")
    pm = Limit(FusedFarmPipeline(feed, 48000, S), LimitSettings(), mode="auto")

    def block(T):  # 16-bit-grid content: exact in the int2 pieces
        return (np.round(rng.standard_normal((S * 2, T)) * 6000) / 32768).astype(np.float32)

    return jfeed, jm, feed, pm, block


def _push_both(jfeed, jm, feed, pm, js, ps, blk, prime=False):
    import jax.numpy as jnp

    js = {**js, "in": {**js["in"], "in": jfeed.push(js["in"]["in"], jnp.asarray(blk),
                                                      prime=prime)}}
    ps = {**ps, "in": {**ps["in"], "in": feed.push(ps["in"]["in"], torch.from_numpy(blk),
                                                     prime=prime)}}
    return js, ps


@pytest.mark.parametrize("gain_post", [True, False])
def test_k1_ring_mode_matches_jax_ring_chunks(gain_post):
    """K1's ring mode (plain version) against JAX's ring_chunks K1 over 7
    blocks, past a wrap of the ring (the seam inside a block's reads),
    with the overflow flag off; then pushes with no emit run past the ring
    and the next emit sets it in both."""
    n = 640
    jfeed, jm, feed, pm, block = _ring_pair(n=n, gain_post=gain_post)
    assert feed.rows == (4 * feed.Kp + 1) * 147
    js, ps = jm.init_state(), pm.init_state()
    js, ps = _push_both(jfeed, jm, feed, pm, js, ps, block((feed.Kp + 1) * 147), prime=True)
    for k in range(7):
        js, ps = _push_both(jfeed, jm, feed, pm, js, ps, block(feed.Kp * 147))
        js, jo, _ = jm.emit(js, n)
        ps, po, pv = pm.emit(ps, n)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-6, err_msg=str(k))
        assert int(pv) == n
        assert bool(ps["in"]["in"]["overflow"]) is bool(js["in"]["in"]["overflow"]) is False
    # three pushes ahead of the emits fill the ring to its edge (c0 = w -
    # Nc still fits); a fourth overwrites the next block's first chunk
    for extra in range(4):
        js, ps = _push_both(jfeed, jm, feed, pm, js, ps, block(feed.Kp * 147))
        if extra == 2:
            _, _, ovf = _emit_flags(jm, pm, js, ps, n)
            assert ovf == (False, False)
    js, ps, ovf = _emit_flags(jm, pm, js, ps, n)
    assert ovf == (True, True)
    assert ps["in"]["in"]["w"] == int(js["in"]["in"]["w"])


def _emit_flags(jm, pm, js, ps, n):
    js, _, _ = jm.emit(js, n)
    ps, _, _ = pm.emit(ps, n)
    return js, ps, (bool(js["in"]["in"]["overflow"]), bool(ps["in"]["in"]["overflow"]))


def test_k1_ring_mode_plain_reads_rows_mod_r():
    """The plain ring lerp equals the linear lerp over the unrolled rows."""
    from rodio_tpu_torch.conversions.resample import lerp_weights, output_positions
    from rodio_tpu_torch.ops import fused

    rng = np.random.default_rng(3)
    R, L, n = 300, 6, 200
    ring = torch.from_numpy(rng.standard_normal((R, L)).astype(np.float32))
    o0 = 5 * 160 + 7  # left rows run across the seam at R
    left, ph = output_positions(o0, n, 147, 160, "cpu")
    wts = torch.from_numpy(np.stack(lerp_weights(147, 160), 1))[ph]
    unrolled = torch.cat([ring] * 4)
    kw = dict(gains=torch.ones(L), coeffs=torch.tensor([1.0, 0, 0, 0, 0]),
              bq=torch.zeros(4, L), channels=2)
    a, _ = fused.fused_resample_biquad_mix(ring, left, wts, ring=True, **kw)
    b, _ = fused.fused_resample_biquad_mix(unrolled, left, wts, **kw)
    assert int(left.max()) + 1 >= R
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="ring mode"):
        fused.fused_resample_biquad_mix(ring[:100], left, wts, ring=True, **kw)


def test_fused_farm_state_from_jax_continues():
    """A JAX fused farm pipeline's state after 3 blocks, converted, goes on
    in the port: 3 more blocks within 2e-6 of JAX's continuation."""
    from rodio_tpu_torch.convert import state_from_jax

    n = 640
    jfeed, jm, feed, pm, block = _ring_pair(n=n, seed=9)
    js = jm.init_state()
    import jax.numpy as jnp

    js = {**js, "in": {**js["in"], "in": jfeed.push(js["in"]["in"], jnp.asarray(
        block((feed.Kp + 1) * 147)), prime=True)}}
    blocks = [block(feed.Kp * 147) for _ in range(6)]
    for b in blocks[:3]:
        js = {**js, "in": {**js["in"], "in": jfeed.push(js["in"]["in"], jnp.asarray(b))}}
        js, _, _ = jm.emit(js, n)
    ps = state_from_jax(pm, jax.device_get(js))
    assert ps["in"]["out_o"] == 3 * n and ps["in"]["in"]["w"] == 4 * feed.Kp
    for b in blocks[3:]:
        js, ps = _push_both(jfeed, jm, feed, pm, js, ps, b)
        js, jo, _ = jm.emit(js, n)
        ps, po, _ = pm.emit(ps, n)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-6)


def test_fused_farm_retune_keeps_state_and_matches_jax():
    """A live retune swaps the coefficients in the state (nothing rebuilt)
    and the next blocks match JAX's retuned pipeline."""
    n = 640
    jfeed, jm, feed, pm, block = _ring_pair(n=n, seed=12)
    js, ps = jm.init_state(), pm.init_state()
    js, ps = _push_both(jfeed, jm, feed, pm, js, ps, block((feed.Kp + 1) * 147), prime=True)
    for k in range(4):
        if k == 2:
            js = {**js, "in": jm.input.retune(js["in"], kind="high_pass", freq=900.0)}
            ps = {**ps, "in": pm.input.retune(ps["in"], kind="high_pass", freq=900.0)}
        js, ps = _push_both(jfeed, jm, feed, pm, js, ps, block(feed.Kp * 147))
        js, jo, _ = jm.emit(js, n)
        ps, po, _ = pm.emit(ps, n)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-6, err_msg=str(k))


@bounded(60)
def test_sharded_stream_farm_group_of_one_equals_stream_farm(corpus):
    """ShardedStreamFarm over a group of one (no launcher) is the single
    farm: the same output, valid count and overflow flag, with a seek."""
    from rodio_tpu_torch.parallel.sharded_farm import ShardedStreamFarm
    from rodio_tpu_torch.parallel.sharding import stream_mesh

    kw = dict(block_frames=1280, loop=False, decode_workers=4, wire="i16",
              start_offsets=[0.0, 0.25, 0.5, 0.75])
    farm = StreamFarm(corpus, fused=True, device="cpu", **kw)
    sfarm = ShardedStreamFarm(corpus, stream_mesh(), device="cpu", **kw)
    assert farm.try_seek(2, 1.5) == sfarm.try_seek(2, 1.5) == int(round(1.5 * RATE))
    a, ra = _run(farm, 4)
    b, rb = _run(sfarm, 4)
    assert ra == rb
    np.testing.assert_array_equal(a, b)


def test_device_trace_and_spans(tmp_path, corpus):
    """device_trace writes a Chrome trace; the farm's spans time its host
    assembly, push and emit."""
    from rodio_tpu_torch.utils.trace import Spans, device_trace

    spans = Spans("cpu")
    with device_trace(str(tmp_path / "tr")):
        _run(StreamFarm(corpus[:2], block_frames=1280, fused=True, loop=False,
                        device="cpu"), 3)
    farm = StreamFarm(corpus[:2], block_frames=1280, fused=True, loop=False, device="cpu")
    farm.run(3, spans=spans)
    farm.close()
    s = spans.summary()
    assert {k: v["n"] for k, v in s.items()} == {"push": 3, "emit": 3, "assemble": 2}
    assert all(v["device_ms"] is None for v in s.values())
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
