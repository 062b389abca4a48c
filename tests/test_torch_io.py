"""The port's io layer (decoders, WAV, native libraries, streaming ingest,
PushPort) against the JAX package's, on the CPU, on files made here.

Every file is written in-process from a seed (``test_torch_io_fixtures``):
WAV at 8, 16, 24 and 32-bit int and 32-bit float, FLAC from a verbatim
encoder with real CRCs and the STREAMINFO MD5, and FLAC-in-Ogg through
``encode_ogg`` where libav is present (those cases skip, naming the
missing headers, where it is not). So the cases of ``test_decoders.py``,
``test_streaming_seek.py`` (not the farm's, which are M8's),
``test_streaming_farm.py:57-110`` and the asset-free ones of
``test_robustness.py`` run here on real files.

Tests that wait on a thread run under ``bounded``: each fails after its
own time limit instead of hanging the run.

Bounds: host code copied from the JAX package (WAV read and write,
``flac_decode``, sample conversion, the host uniformizer, the native ring)
and the device buffers' renders (``Decoder``, ``LoopedDecoder``,
``PushPort``) are bit-equal to the JAX package's; a decoded chain without
the AGC 1e-6; config 2 from a decoded file (the AGC in kernel mode) 2e-5,
the bound of ``tests/test_torch_agc.py``: XLA:CPU contracts the AGC's
mul-adds into FMAs (ROADMAP F4).
"""
import hashlib
import io as pyio
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodio_tpu.graph import render as jrender
from rodio_tpu.io import decoder as jdec
from rodio_tpu.io import native as jnative
from rodio_tpu.io import sample_convert as jsc
from rodio_tpu.io import streaming as jstream
from rodio_tpu.io import uniform_host as juh
from rodio_tpu.io import wav as jwav
from rodio_tpu_torch import render, render_blocks
from rodio_tpu_torch.convert import state_from_jax
from rodio_tpu_torch.io import native, sample_convert, streaming, uniform_host, wav
from rodio_tpu_torch.io.decoder import (
    Decoder, DecoderBuilder, DecoderError, LoopedDecoder, register_codec)
from rodio_tpu_torch.io.streaming import PushPort, StreamingDecoder, StreamingWav
from test_torch_io_fixtures import (
    bounded, pcm16_master, resampled_feed, write_flac, write_pcm_wav)

CPU = dict(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 44100
MUSIC_SECONDS = 4


def _need_libav():
    missing = native.missing_libav_headers()
    if missing:
        pytest.skip(f"libav headers not found: {', '.join(missing)}")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """name -> path of the in-process corpus: ``music.*`` is 4 s of seeded
    16-bit-grid stereo at 44.1 kHz as WAV, FLAC and (with libav) Ogg;
    ``beep.wav`` 1 s of a mono sine; ``pcm{8,16,24,32}.wav`` and
    ``float32.wav`` 0.25 s of stereo at each depth; ``flac24.flac``."""
    d = tmp_path_factory.mktemp("io_assets")
    k, master = pcm16_master(11, 2, MUSIC_SECONDS * RATE)
    out = {"master": master}

    def path(name):
        out[name] = str(d / name)
        return out[name]

    write_pcm_wav(path("music.wav"), k, RATE, 16)
    write_flac(path("music.flac"), k, RATE, 16)
    t = np.arange(RATE) / RATE
    beep = np.round(np.sin(2 * np.pi * 440.0 * t) * 16000).astype(np.int64)[None, :]
    write_pcm_wav(path("beep.wav"), beep, RATE, 16)
    rng = np.random.default_rng(12)
    for bits in (8, 16, 24, 32):
        ints = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (2, RATE // 4))
        write_pcm_wav(path(f"pcm{bits}.wav"), ints, 48000, bits)
    jwav.write_wav(path("float32.wav"), rng.uniform(-1, 1, (2, RATE // 4)).astype(np.float32),
                   48000)
    write_flac(path("flac24.flac"), rng.integers(-(1 << 23), 1 << 23, (2, 9000)), 48000, 24)
    if not native.missing_libav_headers():
        native.encode_ogg(path("music.ogg"), master, RATE)
    return out


def _asset(assets, name):
    if name not in assets:
        _need_libav()
    return assets[name]


def _read_all(s, chunk=65536):
    parts = []
    while True:
        blk = s.read(chunk)
        if blk.shape[1] == 0:
            return (np.concatenate(parts, axis=1) if parts
                    else np.zeros((s.channels, 0), np.float32))
        parts.append(blk)


# -- the native sources and libraries --------------------------------------

@pytest.mark.parametrize("name", ["flac.cpp", "ring.cpp", "ffdec.cpp"])
def test_native_sources_are_byte_equal_to_the_jax_package(name):
    """Byte for byte, but for two comments of ffdec.cpp that cite the
    reference's source by a checkout's absolute path, where the port's
    copy cites it as ``src/...``, as every other comment does."""
    with open(os.path.join(REPO, "rodio_tpu", "native", name), "rb") as a, \
            open(native.NATIVE_DIR / name, "rb") as b:
        want = re.sub(rb"\(/\S*?/src/", b"(src/", a.read())
        assert b.read() == want


def test_native_libraries_build_outside_the_package():
    core = native.build("core")
    assert native.BUILD_DIR in core.parents
    assert not list((native.NATIVE_DIR.parent).rglob("*.so"))
    assert core.name != native.library_path("ffdec").name


def test_spsc_ring_matches_jax():
    rng = np.random.default_rng(3)
    a, b = jnative.SpscRing(1000), native.SpscRing(1000)
    assert a.capacity == b.capacity
    for n_push, n_pop in ((300, 120), (900, 500), (50, 1000), (10, 0)):
        x = rng.standard_normal(n_push).astype(np.float32)
        assert a.push(x) == b.push(x)
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.pop(n_pop), b.pop(n_pop))


# -- WAV, FLAC, sample conversion -------------------------------------------

@pytest.mark.parametrize("name", ["pcm8.wav", "pcm16.wav", "pcm24.wav", "pcm32.wav",
                                  "float32.wav", "music.wav"])
def test_read_wav_matches_jax(assets, name):
    got, rate = wav.read_wav(assets[name])
    want, jrate = jwav.read_wav(assets[name])
    assert rate == jrate
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with open(assets[name], "rb") as f:  # a file object and bytes too
        np.testing.assert_array_equal(wav.read_wav(pyio.BytesIO(f.read()))[0], want)


def test_read_wav_is_the_master(assets):
    np.testing.assert_array_equal(wav.read_wav(assets["music.wav"])[0], assets["master"])


@pytest.mark.parametrize("fmt,bits", [("float", 32), ("int", 16), ("int", 24), ("int", 32)])
def test_write_wav_bytes_match_jax(fmt, bits):
    x = np.random.default_rng(bits).uniform(-1.2, 1.2, (2, 777)).astype(np.float32)
    a, b = pyio.BytesIO(), pyio.BytesIO()
    wav.write_wav(a, x, 44100, bits=bits, fmt=fmt)
    jwav.write_wav(b, x, 44100, bits=bits, fmt=fmt)
    assert a.getvalue() == b.getvalue()
    back, rate = wav.read_wav(pyio.BytesIO(a.getvalue()))
    assert rate == 44100 and back.shape == x.shape


@pytest.mark.parametrize("name", ["music.flac", "flac24.flac"])
def test_flac_decode_matches_jax(assets, name):
    data = open(assets[name], "rb").read()
    got, rate = native.flac_decode(data)
    want, jrate = jnative.flac_decode(data)
    assert rate == jrate
    np.testing.assert_array_equal(got, want)


def test_flac_bit_exact_md5(assets):
    """Lossless: the STREAMINFO MD5 of the decoded PCM matches
    (test_decoders.py's test_flac_bit_exact_md5)."""
    data = open(assets["music.flac"], "rb").read()
    pcm, _ = native.flac_decode(data)
    np.testing.assert_array_equal(pcm, assets["master"])
    ints = np.round(pcm.T.reshape(-1) * 32768.0).astype("<i2")
    assert hashlib.md5(ints.tobytes()).digest() == data[8 + 18: 8 + 34]


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "uint8", "uint16", "uint32"])
def test_sample_convert_matches_jax(dtype):
    rng = np.random.default_rng(5)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, 1000, endpoint=True).astype(dtype)
    np.testing.assert_array_equal(sample_convert.to_f32(x), jsc.to_f32(x))
    f = rng.uniform(-1.5, 1.5, 1000).astype(np.float32)
    if dtype != "uint32":
        np.testing.assert_array_equal(sample_convert.from_f32(f, dtype), jsc.from_f32(f, dtype))


def test_sample_convert_roundtrip(rng):
    """(test_control_device.py's test_sample_convert_roundtrip)"""
    x = rng.uniform(-1, 1, 1000).astype(np.float32)
    for dt in (np.int16, np.int32, np.uint8, np.uint16, np.int8):
        y = sample_convert.to_f32(sample_convert.from_f32(x, dt))
        tol = {np.int16: 1e-4, np.int32: 1e-8, np.uint8: 1.2e-2,
               np.uint16: 1e-4, np.int8: 1.2e-2}[dt]
        np.testing.assert_allclose(y, x, atol=tol, rtol=0)
    loud = np.array([2.0, -2.0], np.float32)
    assert sample_convert.from_f32(loud, np.int16).tolist() == [32767, -32767]


# -- the host uniformizer ----------------------------------------------------

@pytest.mark.parametrize("fc,to", [(1, 2), (2, 1), (1, 4), (3, 2), (2, 2)])
def test_rechannel_np_matches_jax(fc, to):
    x = np.random.default_rng(fc * 10 + to).standard_normal((fc, 100)).astype(np.float32)
    np.testing.assert_array_equal(uniform_host._rechannel_np(x, to),
                                  juh._rechannel_np(x, to))


class _ArrayStream:
    """The FfStream read surface over an array (reads of a fixed size)."""

    def __init__(self, pcm, rate):
        self.pcm, self.sample_rate, self.channels, self.pos = pcm, rate, pcm.shape[0], 0

    def read(self, n):
        blk = self.pcm[:, self.pos:self.pos + n]
        self.pos += blk.shape[1]
        return blk

    def seek(self, seconds):
        self.pos = int(seconds * self.sample_rate)

    def close(self):
        pass


@pytest.mark.parametrize("fr,to,ch", [(44100, 48000, 2), (48000, 44100, 2),
                                      (22050, 48000, 1), (48000, 48000, 1)])
def test_uniform_stream_matches_jax(fr, to, ch):
    pcm = np.random.default_rng(fr % 97).standard_normal((1, 30000)).astype(np.float32)
    outs = []
    for mod in (uniform_host, juh):
        s = mod._UniformStream(_ArrayStream(pcm, fr), ch, to)
        outs.append(np.concatenate([s.read(n) for n in (1000, 4096, 7, 20000, 20000)], axis=1))
    assert outs[0].shape[0] == ch
    np.testing.assert_array_equal(outs[0], outs[1])


def test_span_uniform_stream_over_a_chained_ogg_matches_jax(assets, tmp_path):
    """A chained Ogg (two links at 44.1 and 22.05 kHz) is pinned to its first
    link's spec, as the JAX package's host re-bootstrap does it."""
    _need_libav()
    a, b = tmp_path / "a.ogg", tmp_path / "b.ogg"
    master = assets["master"][:, :20000]
    native.encode_ogg(str(a), master, 44100)
    native.encode_ogg(str(b), master[:1, :9000], 22050)
    chained = tmp_path / "chained.ogg"
    chained.write_bytes(a.read_bytes() + b.read_bytes())
    outs = []
    for nat, uh in ((native, uniform_host), (jnative, juh)):
        s = uh.SpanUniformStream(nat.FfStream(str(chained)))
        outs.append(_read_all(s, 5000))
        s.close()
    assert outs[0].shape[0] == 2 and outs[0].shape[1] > 20000
    np.testing.assert_array_equal(outs[0], outs[1])


# -- decoders ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["music.wav", "music.flac", "music.ogg", "pcm24.wav",
                                  "flac24.flac"])
def test_decoder_render_matches_jax(assets, name):
    path = _asset(assets, name)
    d, jd = Decoder(path, **CPU), jdec.Decoder(path)
    assert d.spec == type(d.spec)(jd.spec.channels, jd.spec.sample_rate)
    assert d.total_frames() == jd.total_frames()
    np.testing.assert_array_equal(render(d, block_frames=4096),
                                  jrender(jd, block_frames=4096))


@pytest.mark.parametrize("name", ["pcm8.wav", "pcm16.wav", "pcm24.wav", "pcm32.wav",
                                  "float32.wav", "beep.wav"])
def test_wav_assets_decode(assets, name):
    """(test_decoders.py's test_wav_assets_decode)"""
    out = render(Decoder(assets[name], **CPU), max_frames=48000)
    assert out.shape[1] > 0
    assert 0.001 < np.abs(out).max() <= 4.0


@pytest.mark.parametrize("name", ["music.flac", "flac24.flac", "music.ogg"])
def test_compressed_assets_decode(assets, name):
    """(test_decoders.py's flac and vorbis cases; the Ogg is FLAC-in-Ogg,
    which the vorbis route hands to the libav shim)"""
    out = render(Decoder(_asset(assets, name), **CPU))
    assert np.abs(out).max() > 0.001


@pytest.mark.parametrize("name", ["music.wav", "music.flac"])
def test_total_duration(assets, name):
    assert Decoder(assets[name], **CPU).total_duration() == pytest.approx(MUSIC_SECONDS,
                                                                          abs=1e-9)


def test_decoder_seek_frame_accurate(assets):
    d = Decoder(assets["music.wav"], **CPU)
    full = render(d)
    state = d.seek_state(d.init_state(), 2.0)
    _, block, valid = d.emit(state, 1024)
    target = int(2.0 * d.spec.sample_rate)
    assert int(valid) == 1024
    np.testing.assert_array_equal(block.numpy()[:, :100], full[:, target:target + 100])


def test_seek_beyond_end_saturates(assets):
    d = Decoder(assets["music.wav"], **CPU)
    _, _, valid = d.emit(d.seek_state(d.init_state(), 9999.0), 64)
    assert int(valid) == 0


def test_decoder_builder(assets):
    with open(assets["music.flac"], "rb") as f:
        d = (DecoderBuilder(**CPU).with_data(f.read()).with_gapless(False)
             .with_hint("flac").build())
    assert d.spec.sample_rate == 44100 and d.spec.channels == 2
    assert d.settings.gapless is False
    looped = DecoderBuilder(**CPU).with_data(assets["beep.wav"]).looped().build()
    assert isinstance(looped, LoopedDecoder)


def test_looped_decoder_wraps(assets):
    d = LoopedDecoder(assets["beep.wav"], **CPU)
    frames = d._frames
    out = render(d, max_frames=frames + 100, block_frames=4096)
    np.testing.assert_array_equal(out[:, frames:frames + 100], out[:, :100])


def test_looped_decoder_gather_fallback_matches_slice(assets):
    """Blocks wider than the pre-filled tail gather modulo the length; both
    paths agree."""
    d = LoopedDecoder(assets["beep.wav"], **CPU)
    frames = d._frames
    assert d._pad < 9000 <= frames
    a = render(d, max_frames=2 * frames + 64, block_frames=4096)
    b = render(d, max_frames=2 * frames + 64, block_frames=9000)
    np.testing.assert_array_equal(a[:, : b.shape[1]], b)


@pytest.mark.parametrize("block", [4096, 9000])
def test_looped_decoder_matches_jax(assets, block):
    d, jd = LoopedDecoder(assets["beep.wav"], **CPU), jdec.LoopedDecoder(assets["beep.wav"])
    np.testing.assert_array_equal(d.init_state()["data"].numpy(),
                                  np.asarray(jd.init_state()["data"]))
    n = 3 * d._frames + 17
    np.testing.assert_array_equal(render(d, max_frames=n, block_frames=block),
                                  jrender(jd, max_frames=n, block_frames=block))


def test_unrecognized_format_errors(tmp_path):
    p = tmp_path / "garbage.bin"
    p.write_bytes(b"\x00\x01\x02\x03" * 100)
    with pytest.raises(DecoderError):
        Decoder(str(p), **CPU)


def test_mixed_format_graph(assets):
    """Decoded sources of different formats mix to one stream."""
    from rodio_tpu_torch.control import mixer

    tx, rx = mixer(2, 48000, **CPU)
    for name in ("music.wav", "music.flac", "beep.wav"):
        tx.add(Decoder(assets[name], **CPU).take_duration(0.2))
    block, alive = rx.next_block(4096)
    assert alive and float(block.abs().max()) > 0.001


def test_register_custom_codec():
    from rodio_tpu_torch.io.decoder import _CUSTOM_CODECS

    def probe(data):
        return data[:4] == b"MYFM"

    def decode(data):
        n = (len(data) - 4) // 4
        return np.frombuffer(data[4:4 + n * 4], dtype="<f4").reshape(1, -1), 8000

    register_codec("myfmt", probe, decode, extensions=("myf",))
    try:
        d = Decoder(b"MYFM" + np.arange(64, dtype="<f4").tobytes(), **CPU)
        assert d.spec.sample_rate == 8000
        np.testing.assert_array_equal(render(d)[0], np.arange(64, dtype=np.float32))
    finally:
        _CUSTOM_CODECS.clear()


def test_mp3_and_vorbis_bindings_refuse_other_data(assets):
    """No MP3 or Vorbis encoder is at hand to make a file, so their
    bindings are held to the JAX package's on what they must refuse (the
    libraries where the host lacks them: Mp3Unavailable,
    VorbisUnavailable)."""
    from rodio_tpu.io import mp3 as jmp3
    from rodio_tpu.io import vorbis as jvorbis
    from rodio_tpu_torch.io import mp3, vorbis

    assert mp3.mp3_probe(b"ID3\x03") and mp3.mp3_probe(b"\xff\xfb\x90")
    assert not mp3.mp3_probe(b"RIFF")
    data = open(assets["music.wav"], "rb").read()[:20000]
    for mod, jmod, fn in ((mp3, jmp3, "mp3_decode"), (vorbis, jvorbis, "vorbis_decode")):
        errs = []
        for m in (mod, jmod):
            with pytest.raises((ValueError, RuntimeError)) as e:
                getattr(m, fn)(data)
            errs.append(type(e.value).__name__)
        assert errs[0] == errs[1]


# -- streaming: FfStream, StreamingWav, StreamingDecoder ----------------------

@pytest.mark.parametrize("name", ["music.flac", "music.ogg"])
def test_ffstream_chunked_equals_whole_decode(assets, name):
    _need_libav()
    path = _asset(assets, name)
    whole, rate = native.ff_decode(open(path, "rb").read())
    s = native.FfStream(path)
    assert s.sample_rate == rate and s.channels == whole.shape[0]
    got = np.concatenate(list(s.chunks(10000)), axis=1)
    s.close()
    np.testing.assert_array_equal(got, whole)
    jwhole, _ = jnative.ff_decode(open(path, "rb").read())
    np.testing.assert_array_equal(whole, jwhole)


def test_ffstream_flac_lossless_vs_native_decoder(assets):
    """libav's streaming FLAC (which checks the frames' CRCs) equals the
    in-repo decoder (which skips them)."""
    _need_libav()
    ref, _ = native.flac_decode(open(assets["music.flac"], "rb").read())
    s = native.FfStream(assets["music.flac"])
    got = np.concatenate(list(s.chunks(65536)), axis=1)
    s.close()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["music.flac", "music.ogg"])
def test_ffstream_seek_accurate_matches_full_decode_tail(assets, name):
    _need_libav()
    path = _asset(assets, name)
    s = native.FfStream(path)
    full = _read_all(s)
    s.close()
    for t in (2.345678, 0.013) + ((3.9,) if name.endswith(".flac") else ()):
        s = native.FfStream(path)
        k = int(round(t * s.sample_rate))
        assert s.seek_accurate(t) == k
        tail = _read_all(s)
        s.close()
        np.testing.assert_array_equal(tail, full[:, k:], err_msg=f"{name}@{t}")


def test_ffstream_seek_near_the_end_of_an_ogg_matches_jax(assets):
    """0.1 s before the end of a FLAC-in-Ogg, ``seek_accurate`` reports the
    target but the stream resumes earlier (13626 frames left where 4410
    are due), in the JAX package as in the port (the same C++): held
    equal to the JAX package's, a fault of the reference (ROADMAP queue
    3)."""
    path = _asset(assets, "music.ogg")
    tails = []
    for nat in (native, jnative):
        s = nat.FfStream(path)
        got = s.seek_accurate(3.9)
        tails.append((got, _read_all(s)))
        s.close()
    assert tails[0][0] == tails[1][0] == int(round(3.9 * RATE))
    np.testing.assert_array_equal(tails[0][1], tails[1][1])


def test_ffstream_seek_accurate_by_frames(assets):
    _need_libav()
    s = native.FfStream(assets["music.flac"])
    full = _read_all(s)
    s.close()
    s = native.FfStream(assets["music.flac"])
    assert s.seek_accurate(frames=100_001) == 100_001
    blk = s.read(4096)
    s.close()
    np.testing.assert_array_equal(blk, full[:, 100_001:100_001 + 4096])


def test_ffstream_seek_accurate_past_end(assets):
    _need_libav()
    s = native.FfStream(assets["music.flac"])
    s.seek_accurate(10_000.0)
    assert s.read(1024).shape[1] == 0
    s.close()


def test_ffstream_seek_remaining_duration(assets):
    _need_libav()
    s = native.FfStream(assets["music.flac"])
    total = _read_all(s).shape[1]
    s.close()
    s = native.FfStream(assets["music.flac"])
    s.seek_accurate(1.5)
    rest = _read_all(s).shape[1]
    s.close()
    assert abs(rest - (total - round(1.5 * s.sample_rate))) <= 0.25 * s.sample_rate


def _pull(feed, frames, block=4096):
    got = np.zeros((feed.spec.channels, 0), np.float32)
    while got.shape[1] < frames:
        blk, alive = feed.next_block(block)
        if not alive:
            break
        got = np.concatenate([got, blk], axis=1)
    return got


@pytest.mark.parametrize("name", ["music.wav", "music.flac"])
@bounded(60)
def test_streaming_decoder_start_at_matches_whole_decoder_seek(assets, name):
    """StreamingDecoder(start_at=t) equals the whole-file Decoder's exact
    seek, sample for sample."""
    if name.endswith(".flac"):
        _need_libav()
    path, t = assets[name], 3.21
    d = Decoder(path, **CPU)
    st = d.seek_state(d.init_state(), t)
    assert int(st["pos"]) == int(round(t * d.spec.sample_rate))
    _, want, v = d.emit(st, 8192)
    want = want.numpy()[:, : int(v)]
    sd = StreamingDecoder(path, start_at=t, chunk_frames=4096)
    got = _pull(sd, want.shape[1])
    sd.close()
    np.testing.assert_array_equal(got[:, : want.shape[1]], want)


@bounded(60)
def test_streaming_decoder_start_at_ogg_self_consistent(assets):
    """(test_streaming_seek.py's mp3 case, on the Ogg): the streamed tail
    equals the same FfStream's full decode from the target."""
    path = _asset(assets, "music.ogg")
    s = native.FfStream(path)
    full, rate = _read_all(s), s.sample_rate
    s.close()
    t = 1.4321
    k = int(round(t * rate))
    sd = StreamingDecoder(path, start_at=t, chunk_frames=4096)
    got = _pull(sd, 30000)
    sd.close()
    n = min(got.shape[1], full.shape[1] - k, 30000)
    np.testing.assert_array_equal(got[:, :n], full[:, k:k + n])


@bounded(60)
def test_streaming_wav_start_at_byte_exact(assets):
    pcm = assets["master"]
    k = int(round(1.007 * RATE))
    sd = StreamingDecoder(assets["music.wav"], start_at=1.007, chunk_frames=4096)
    blk, alive = sd.next_block(4096)
    sd.close()
    assert alive
    np.testing.assert_array_equal(blk, pcm[:, k:k + 4096])


@pytest.mark.parametrize("name", ["music.wav", "pcm24.wav", "pcm32.wav", "float32.wav"])
@bounded(60)
def test_streaming_wav_matches_full_decode_and_jax(assets, name):
    """(test_control_device.py's test_streaming_wav_matches_full_decode, on
    a file made here) and the JAX package's stream of the same file."""
    full, rate = wav.read_wav(assets[name])
    outs = []
    for mod in (streaming, jstream):
        sw = mod.StreamingWav(assets[name], chunk_frames=4000, buffer_seconds=0.2)
        assert sw.spec.sample_rate == rate and sw.spec.channels == full.shape[0]
        outs.append(_pull(sw, full.shape[1] + 4096))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][:, :full.shape[1]], full)
    feeder = streaming.DeviceFeeder(StreamingWav(assets[name], chunk_frames=4000), 4096, **CPU)
    b1, _ = feeder.next_device_block()
    b2, _ = feeder.next_device_block()
    np.testing.assert_array_equal(b1.numpy(), full[:, :4096])
    np.testing.assert_array_equal(b2.numpy(), outs[0][:, 4096:8192])


@bounded(60)
def test_wav_spec_from_two_threads_at_once(assets):
    """F2: the JAX package hands the spec out through a function attribute,
    which races; the port's header helper returns it. Streams on two files
    of different specs, opened from two threads many times over, each get
    their own."""
    names = ("music.wav", "pcm24.wav")  # 2 ch at 44.1 kHz, 2 ch at 48 kHz
    mono = os.path.join(os.path.dirname(assets["beep.wav"]), "beep.wav")  # 1 ch
    paths = (assets[names[0]], assets[names[1]], mono)
    want = [wav.read_wav(p)[0].shape[0] * 100000 + wav.read_wav(p)[1] for p in paths]
    errors = []

    def worker(i):
        try:
            for _ in range(200):
                spec = streaming.wav_stream_spec(paths[i])
                if spec.channels * 100000 + spec.sample_rate != want[i]:
                    errors.append((i, spec))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i % 3,), daemon=True) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


@bounded(60)
def test_streaming_feed_close_stops_its_thread(assets):
    sw = StreamingWav(assets["music.wav"], chunk_frames=1000, buffer_seconds=0.05)
    sw.next_block(256)
    sw.close(timeout=5.0)
    assert not sw._thread.is_alive()


# -- PushPort ----------------------------------------------------------------

def test_push_port_fifo_semantics():
    port = PushPort(2, 48000, capacity=64, push_frames=16, **CPU)
    st = port.init_state()
    blk = np.arange(32, dtype=np.float32).reshape(2, 16)
    st = port.push(st, torch.from_numpy(blk), 16)
    st = port.push(st, torch.from_numpy(blk + 100), 10)
    st, out, valid = port.emit(st, 20)
    assert int(valid) == 20
    np.testing.assert_array_equal(out[:, :16].numpy(), blk)
    np.testing.assert_array_equal(out[:, 16:20].numpy(), blk[:, :4] + 100)
    assert int(st["level"]) == 6
    st = port.end(st)
    st, out, valid = port.emit(st, 20)
    assert int(valid) == 6
    assert not bool(st["overflow"])


def test_push_port_overflow_flag():
    port = PushPort(1, 48000, capacity=32, push_frames=16, **CPU)
    st = port.init_state()
    for _ in range(3):
        st = port.push(st, torch.ones((1, 16)), 16)
    assert bool(st["overflow"])


def test_push_port_underflow_flag():
    port = PushPort(1, 48000, capacity=64, push_frames=16, **CPU)
    st = port.push(port.init_state(), torch.ones((1, 16)), 16)
    st, out, valid = port.emit(st, 8)
    assert not bool(st["underflow"])
    st, out, valid = port.emit(st, 20)
    assert int(valid) == 20 and bool(st["underflow"])
    np.testing.assert_array_equal(out[:, 8:].numpy(), np.zeros((1, 12), np.float32))
    st2 = port.push(port.init_state(), torch.ones((1, 16)), 16)
    st2, _, v2 = port.emit(port.end(st2), 20)
    assert int(v2) == 16 and not bool(st2["underflow"])


def _push_script(port, push, emit, end, retire_fn):
    """Run a push/emit script; returns the outputs and the states."""
    rng = np.random.default_rng(21)
    st, outs, states = port.init_state(), [], []
    pf = port.push_frames
    for step in range(9):
        blk = rng.standard_normal((port.spec.channels, pf)).astype(np.float32)
        count = [pf, pf // 2, pf, 3, pf, 0, pf, pf - 1, 5][step]
        st = push(st, blk, count, retire_fn(step))
        if step == 7:
            st = end(st)
        st, out, valid = emit(st, [7, 16, 5, 20, 9, 1, 16, 30, 12][step])
        outs.append((np.asarray(out), int(valid)))
        states.append({k: np.asarray(v) for k, v in st.items()})
    return outs, states


def test_push_port_script_matches_jax():
    """Pushes with counts and retires (some past the level: the overflow
    flag), emits past the level (underflow) and after the end: outputs and
    every state field bit-equal to the JAX package's."""
    tp = PushPort(2, 48000, capacity=48, push_frames=16, **CPU)
    jp = jstream.PushPort(2, 48000, capacity=48, push_frames=16)
    retire = lambda step: [0, 0, 2, 0, 1, 0, 20, 0, 3][step]  # noqa: E731
    got = _push_script(tp, lambda s, b, c, r: tp.push(s, torch.from_numpy(b), c, r),
                       tp.emit, tp.end, retire)
    want = _push_script(jp, lambda s, b, c, r: jp.push(s, jnp.asarray(b), c, r),
                        jp.emit, jp.end, retire)
    for (o, v), (jo, jv) in zip(got[0], want[0]):
        assert v == jv
        np.testing.assert_array_equal(o, jo)
    for a, b in zip(got[1], want[1]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got[1][-1]["overflow"] and got[1][-1]["underflow"]


def test_push_port_random_access_surface_matches_jax():
    tp = PushPort(2, 48000, capacity=48, push_frames=16, **CPU)
    jp = jstream.PushPort(2, 48000, capacity=48, push_frames=16)
    blk = np.random.default_rng(2).standard_normal((2, 16)).astype(np.float32)
    ts = tp.push(tp.push(tp.init_state(), torch.from_numpy(blk), 16), torch.from_numpy(-blk), 16, 5)
    js = jp.push(jp.push(jp.init_state(), jnp.asarray(blk), 16), jnp.asarray(-blk), 16, 5)
    idx = np.arange(-3, 60)
    np.testing.assert_array_equal(tp.gather_frames(ts, torch.from_numpy(idx)).numpy(),
                                  np.asarray(jp.gather_frames(js, jnp.asarray(idx))))
    for start in (0, 5, 17, 40):
        np.testing.assert_array_equal(
            tp.slice_frames(ts, torch.tensor(start), 8).numpy(),
            np.asarray(jp.slice_frames(js, jnp.int32(start), 8)))
    assert int(tp.access_window(ts)[1]) == int(jp.access_window(js)[1]) == 2 ** 30
    ended = tp.access_window(tp.end(ts))[1]
    assert int(ended) == int(jp.access_window(jp.end(js))[1]) == 5 + 27  # base + level


def test_resample_push_port_matches_resample_decoder(assets):
    """Resample(PushPort) 44.1 -> 48 kHz takes the weight form (its window
    fits the port's capacity, read as PAD_FRAMES), as Resample(Decoder)
    does: the two renders are bit-equal (bound 1e-6)."""
    from rodio_tpu_torch.conversions.resample import Resample

    node, got = resampled_feed(assets["master"], RATE, 48000, 4096, 12)
    assert node.uses_weight_form(4096)
    ref = Resample(Decoder(assets["music.wav"], **CPU), 48000)
    assert ref.uses_weight_form(4096)
    _, want, _ = render_blocks(ref, ref.init_state(), 12, 4096)
    assert float((got - want).abs().max()) <= 1e-6
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- a decoded file through a chain, to_file ----------------------------------

def _jax_chain(node, agc: bool):
    from rodio_tpu.effects.agc import AgcSettings, AutomaticGainControl
    from rodio_tpu.effects.limit import Limit, LimitSettings

    node = node.low_pass(2000.0)
    if agc:
        node = AutomaticGainControl(node, AgcSettings(), mode="pallas")
    return Limit(node, LimitSettings(), mode="pallas")


def _port_chain(node, agc: bool):
    from rodio_tpu_torch.effects import AgcSettings, AutomaticGainControl
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings

    node = node.low_pass(2000.0)
    if agc:
        node = AutomaticGainControl(node, AgcSettings(), mode="pallas")
    return Limit(node, LimitSettings(), mode="pallas")


@pytest.mark.parametrize("agc,seconds,bound", [(False, None, 1e-6), (True, 0.15, 2e-5)])
def test_decoded_chain_and_to_file_match_jax(assets, tmp_path, agc, seconds, bound):
    """BASELINE config 2 (agc) and its chain without the AGC, from the
    decoded FLAC, through ``to_file``: the port's WAV against the JAX
    package's, and against the port's own render bit for bit. With the AGC
    the JAX package on XLA:CPU drifts from the oracle as its FMAs add up
    (F4: 1.3e-3 after 4 s at this level, where the gain rises ~7x), so
    that case is held over 0.15 s, as ``tests/test_torch_agc.py`` holds
    the same chain."""
    path = assets["music.flac"]
    dec, jd = Decoder(path, **CPU), jdec.Decoder(path)
    if seconds:
        dec, jd = dec.take_duration(seconds), jd.take_duration(seconds)
    node, jnode = _port_chain(dec, agc), _jax_chain(jd, agc)
    node.to_file(str(tmp_path / "port.wav"))
    jnode.to_file(str(tmp_path / "jax.wav"))
    got, rate = wav.read_wav(str(tmp_path / "port.wav"))
    want, jrate = wav.read_wav(str(tmp_path / "jax.wav"))
    assert rate == jrate == RATE and got.shape == want.shape
    assert seconds or got.shape == assets["master"].shape
    assert np.abs(got - want).max() <= bound
    np.testing.assert_array_equal(got, render(node, block_frames=4096))


# -- state carried across from the JAX package --------------------------------

def _jax_blocks(node, state, k, n):
    step = jax.jit(lambda s: node.emit(s, n))
    outs = []
    for _ in range(k):
        state, out, _ = step(state)
        outs.append(np.asarray(out))
    return state, np.concatenate(outs, axis=1)


@pytest.mark.parametrize("kind", ["Decoder", "LoopedDecoder"])
def test_decoder_state_carried_from_jax(assets, kind):
    path = assets["beep.wav"]
    jnode = getattr(jdec, kind)(path)
    tnode = (Decoder if kind == "Decoder" else LoopedDecoder)(path, **CPU)
    js, _ = _jax_blocks(jnode, jnode.init_state(), 5, 4000)  # past the end once looped
    ts = state_from_jax(tnode, jax.device_get(js))
    np.testing.assert_array_equal(ts["data"].numpy(), np.asarray(js["data"]))
    _, want = _jax_blocks(jnode, js, 14, 4000)
    _, got, _ = render_blocks(tnode, ts, 14, 4000)
    np.testing.assert_array_equal(got.numpy(), want)


def test_push_port_state_carried_from_jax():
    tp = PushPort(2, 48000, capacity=48, push_frames=16, **CPU)
    jp = jstream.PushPort(2, 48000, capacity=48, push_frames=16)
    rng = np.random.default_rng(8)
    js = jp.init_state()
    for count in (16, 9, 16):
        js = jp.push(js, jnp.asarray(rng.standard_normal((2, 16)).astype(np.float32)), count)
        js, _, _ = jp.emit(js, 11)
    ts = state_from_jax(tp, jax.device_get(js))
    blk = rng.standard_normal((2, 16)).astype(np.float32)
    js, jo, jv = jp.emit(jp.push(js, jnp.asarray(blk), 12, 3), 14)
    ts, to, tv = tp.emit(tp.push(ts, torch.from_numpy(blk), 12, 3), 14)
    assert int(tv) == int(jv)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)


# -- robustness (test_robustness.py's cases on files made here) ---------------

@pytest.mark.parametrize("name", ["music.flac", "music.ogg", "music.wav"])
def test_truncated_files_fail_cleanly_or_decode_prefix(assets, name):
    data = open(_asset(assets, name), "rb").read()
    for cut in (10, 100, len(data) // 2):
        try:
            out = render(Decoder(data[:cut], **CPU), max_frames=1000)
            assert np.all(np.isfinite(out))
        except (DecoderError, ValueError):
            pass  # a clean typed failure is acceptable


def test_corrupt_middle_bytes_flac(assets):
    data = bytearray(open(assets["music.flac"], "rb").read())
    data[len(data) // 2: len(data) // 2 + 64] = b"\xff" * 64
    try:
        assert np.all(np.isfinite(render(Decoder(bytes(data), **CPU))))
    except (DecoderError, ValueError):
        pass


def test_garbage_wav_rejected(tmp_path):
    p = tmp_path / "fake.wav"
    p.write_bytes(b"RIFF\x10\x00\x00\x00WAVEjunkjunk")
    with pytest.raises(Exception):
        Decoder(str(p), **CPU)


def test_flac_frame_header_fuzz(assets):
    """Bit-flipped frame and subframe headers never write out of bounds."""
    base = bytearray(open(assets["music.flac"], "rb").read())
    rng = np.random.default_rng(7)
    for _ in range(8):
        data = bytearray(base)
        pos = hits = 0
        while pos + 1 < len(data) and hits < 40:
            if data[pos] == 0xFF and (data[pos + 1] & 0xFC) == 0xF8:
                off = int(rng.integers(2, 24))
                if pos + off < len(data):
                    data[pos + off] = int(rng.integers(0, 256))
                hits += 1
                pos += 64
            pos += 1
        try:
            assert np.all(np.isfinite(render(Decoder(bytes(data), **CPU), max_frames=48000)))
        except (DecoderError, ValueError):
            pass


def test_flac_malicious_partition_order():
    """A hand-built frame whose partition order makes part_len < order
    (once a heap overflow) is refused or decodes finitely."""
    def bits_to_bytes(bits):
        bits = bits + "0" * ((-len(bits)) % 8)
        return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))

    si = (format(4096, "016b") * 2 + "0" * 48 + format(48000, "020b") + format(0, "03b")
          + format(15, "05b") + format(0, "036b") + "0" * 128)
    header = b"fLaC" + bytes([0x80, 0, 0, 34]) + bits_to_bytes(si)
    fr = "11111111111110" + "0" + "0" + "0010" + "1010" + "0000" + "100" + "0"
    fr += "00000000" + "00000000"
    fr += "0" + format(63, "06b") + "0" + "0" * 16 * 32 + "0011" + "00000" + "0000" * 32
    fr += "00" + "0110" + ("0000" + "1" * 80) * 64
    try:
        assert np.all(np.isfinite(render(Decoder(header + bits_to_bytes(fr), **CPU),
                                         max_frames=4096)))
    except (DecoderError, ValueError):
        pass


def test_seek_error_taxonomy_live_source_intact():
    """Seeking a live input fails with SeekNotSupported, the source intact."""
    from rodio_tpu_torch.core.errors import SeekError, SeekNotSupported
    from rodio_tpu_torch.graph.seek import seek_state

    port = PushPort(2, 48000, capacity=64, push_frames=16, **CPU)
    with pytest.raises(SeekNotSupported) as exc:
        seek_state(port, 5.0)
    assert exc.value.source_intact is True and isinstance(exc.value, SeekError)
    st = port.push(port.init_state(), torch.ones((2, 16)), 16)
    _, _, valid = port.emit(st, 8)
    assert int(valid) == 8
