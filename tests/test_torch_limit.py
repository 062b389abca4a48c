"""K5 (the limiter envelopes) and the limiter's every non-K3 case, against
the JAX package, on the CPU; and the per-stream chain (path C).

Inputs are numpy arrays from fixed seeds fed to both packages. Bounds:

- K5's plain version against JAX ``limiter_env_pallas(interpret=True)``:
  1e-6 absolute plus 2e-6 relative (16 ulp of the dB envelopes), the F4
  allowance of ROADMAP queue 3: XLA:CPU contracts ``rel*integ +
  (1-rel)*db`` into an FMA, ~1 ulp a step, carried ~1/(1-rel) steps. Against
  the same recurrence written out step by step in torch: 0.0.
- ``Limit(mode="pallas")`` against the JAX node (which runs K5 in interpret
  mode there) over 4 blocks: 2e-6, the JAX node's own distance from the
  scalar oracle on loud input (tests/test_torch_nodes.py); the carries in
  dB at 2e-6 relative. The same bounds hold ``limiter_stream_plain`` (K5's
  whole per-stream limiter, the node's non-K3 path) against the JAX node
  over two calls, the second from the first's carries.
- The per-stream chain of tests/test_parallel.py (Resample -> BltFilter ->
  AGC -> Amplify -> Limit(streams=S) -> WideMixer) with the TPU dispatch of
  each node (``mode="pallas"``), then the master Limit: 2e-5 against the
  JAX chain, the AGC bound under F4; against the port's own ``"exact"``
  chain up to the mix: 0.0 (the same recurrences in the same order).
- K9's plain version against a numpy sum of the same rows in the same
  order: 0.0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodio_tpu.conversions.resample import Resample as JResample
from rodio_tpu.effects.agc import AgcSettings as JAgcSettings
from rodio_tpu.effects.agc import AutomaticGainControl as JAgc
from rodio_tpu.effects.basic import Amplify as JAmplify
from rodio_tpu.effects.blt import BltFilter as JBlt
from rodio_tpu.effects.limit import Limit as JLimit
from rodio_tpu.effects.limit import LimitSettings as JLimitSettings
from rodio_tpu.ops.pallas_scan import limiter_env_pallas
from rodio_tpu.parallel.batch import WideMixer as JWideMixer
from rodio_tpu.sources.generators import SamplesBuffer as JBuffer
import rodio_tpu_torch as rtt
from rodio_tpu_torch.benches import dma_roofline, op_latency
from rodio_tpu_torch.effects.limit import Limit, LimitSettings
from rodio_tpu_torch.ops import cuda_scan, limiter_block
from rodio_tpu_torch.sources.generators import SamplesBuffer


def _coefs(settings=None):
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32), device="cpu"),
                settings or LimitSettings())
    return lim.attack, lim.release


def _db(L, T, seed):
    """Soft-knee gains in dB: mostly below the knee (0), bursts above."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(0.0, 12.0, (L, T)) * (rng.uniform(size=(L, T)) < 0.3)
    return db.astype(np.float32)


@pytest.mark.parametrize("L,T", [(6, 700), (16, 1030)])
@pytest.mark.parametrize("preset", ["default", "live_performance"])
def test_k5_plain_matches_pallas_interpret(L, T, preset):
    att, rel = _coefs(getattr(LimitSettings, preset)())
    db = _db(L, T, L * T)
    rng = np.random.default_rng(L)
    i0 = rng.uniform(0, 6, L).astype(np.float32)
    p0 = rng.uniform(0, 6, L).astype(np.float32)
    pj, (ij, qj) = limiter_env_pallas(jnp.asarray(db), jnp.asarray(i0),
                                      jnp.asarray(p0), att=att, rel=rel,
                                      interpret=True)
    before = cuda_scan.limiter_env_launches
    pt, (it, qt) = cuda_scan.limiter_env(torch.from_numpy(db), torch.from_numpy(i0),
                                         torch.from_numpy(p0), att=att, rel=rel)
    assert cuda_scan.limiter_env_launches == before  # the plain version
    for a, b in ((pt, pj), (it, ij), (qt, qj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=2e-6)
    # the recurrence written out, one rounded op at a time: 0.0
    crel, catt = float(np.float32(1.0 - rel)), float(np.float32(1.0 - att))
    integ, peak = torch.from_numpy(i0), torch.from_numpy(p0)
    x = torch.from_numpy(db)
    for t in range(T):
        integ = torch.maximum(x[:, t], rel * integ + crel * x[:, t])
        peak = att * peak + catt * integ
        assert torch.equal(pt[:, t], peak)
    assert torch.equal(it, integ) and torch.equal(qt, peak)


@pytest.mark.parametrize("T", [1, 127, 129, 4410])
@pytest.mark.parametrize("cg,streams", [(1, 1), (1, 3), (2, 1), (2, 3), (4, 1),
                                        (4, 2), (6, 1), (6, 2)])
def test_limiter_stream_plain_matches_jax_node(cg, streams, T):
    """Groups of 1, 2, 4 and 6 channels, one stream and several, blocks
    around K5's 128-step tile; every T has P = T & -T < 8, so the JAX node
    (mode="pallas", interpret) takes K5's path, not K3's."""
    channels = cg * streams
    rng = np.random.default_rng(cg * 1000 + streams * 100 + T)
    data = (rng.uniform(-1, 1, (channels, 2 * T)) * 2.0).astype(np.float32)
    jn = JLimit(JBuffer(channels, 48000, data), JLimitSettings(), mode="pallas",
                streams=streams)
    tn = Limit(SamplesBuffer(channels, 48000, data, device="cpu"), LimitSettings())
    kw = dict(att=tn.attack, rel=tn.release, threshold=tn.threshold,
              knee_width=tn.knee_width, inv_knee_8=tn.inv_knee_8, group_channels=cg)
    js = jn.init_state()
    jemit = jax.jit(lambda s: jn.emit(s, T))
    integ = peak = torch.zeros(channels)
    for b in range(2):
        js, oj, vj = jemit(js)
        assert int(vj) == T
        x = torch.from_numpy(data[:, b * T:(b + 1) * T])
        y, (integ, peak) = cuda_scan.limiter_stream_plain(x, integ, peak, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(oj), atol=2e-6, rtol=0,
                                   err_msg=f"block {b}")
        np.testing.assert_allclose(integ.numpy(), np.asarray(js["integ"]), rtol=2e-6)
        np.testing.assert_allclose(peak.numpy(), np.asarray(js["peak"]), rtol=2e-6)
    assert np.abs(data).max() > 1.0  # loud enough that the limiter acts
    # the wrapper on a CPU tensor is the plain version
    before = cuda_scan.limiter_stream_launches
    y2, _ = cuda_scan.limiter_stream(x, integ, peak, **kw)
    assert cuda_scan.limiter_stream_launches == before
    assert torch.equal(y2, cuda_scan.limiter_stream_plain(x, integ, peak, **kw)[0])


def _limit_pair(channels, streams, frames, seed, mode="pallas"):
    rng = np.random.default_rng(seed)
    data = (rng.uniform(-1, 1, (channels, frames)) * 2.0).astype(np.float32)
    jn = JLimit(JBuffer(channels, 48000, data), JLimitSettings(), mode=mode,
                streams=streams)
    tn = Limit(SamplesBuffer(channels, 48000, data, device="cpu"), LimitSettings(),
               mode=mode, streams=streams)
    return jn, tn


@pytest.mark.parametrize("channels,streams,n", [
    (8, 4, 640),   # streams=4 stereo: the per-stream limiter
    (1, 1, 640),   # mono
    (2, 1, 4410),  # stereo, P = 2: below K3's 8 chunks
])
def test_limit_pallas_matches_jax(channels, streams, n):
    jn, tn = _limit_pair(channels, streams, 4 * n + 100, channels * n)
    js, ts = jn.init_state(), tn.init_state()
    jemit = jax.jit(lambda s: jn.emit(s, n))
    k3, k5 = limiter_block.launches, cuda_scan.limiter_stream_launches
    for b in range(4):
        js, oj, vj = jemit(js)
        ts, ot, vt = tn.emit(ts, n)
        assert int(vt) == int(vj) == n
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-6, rtol=0,
                                   err_msg=f"block {b}")
    assert (limiter_block.launches, cuda_scan.limiter_stream_launches) == (k3, k5)
    np.testing.assert_allclose(ts["integ"].numpy(), np.asarray(js["integ"]), rtol=2e-6)
    np.testing.assert_allclose(ts["peak"].numpy(), np.asarray(js["peak"]), rtol=2e-6)


@pytest.mark.parametrize("channels,streams,n", [(8, 4, 640), (1, 1, 640), (2, 1, 4410)])
def test_limit_pallas_equals_exact_on_the_cpu(channels, streams, n):
    """Off the blocked case, "pallas" is K5, whose plain version is the
    sequential scans of "exact": 0.0."""
    _, tp = _limit_pair(channels, streams, 2 * n, 7, mode="pallas")
    _, te = _limit_pair(channels, streams, 2 * n, 7, mode="exact")
    _, op, _ = rtt.render_blocks(tp, tp.init_state(), 2, n)
    _, oe, _ = rtt.render_blocks(te, te.init_state(), 2, n)
    assert torch.equal(op, oe)


def _jax_path_c(S, seconds, seed, mode):
    """The JAX package's per-stream chain (tests/test_parallel.py:106-117)
    with ``mode`` on every node and the master limiter, from the numpy
    draws of the port's ``make_per_stream_chain``."""
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((S * 2, int(seconds * 44100))) * 0.1).astype(np.float32)
    gains = np.repeat(rng.uniform(0.5, 1.5, S).astype(np.float32) / S, 2)
    n = JResample(JBuffer(S * 2, 44100, pcm), 48000, max_block=640)
    n = JBlt(n, "low_pass", 2000.0, 0.5, mode=mode)
    n = JAgc(n, JAgcSettings(), mode=mode, streams=S)
    n = JLimit(JAmplify(n, gains), JLimitSettings(), mode=mode, streams=S)
    return JLimit(JWideMixer(n, S), JLimitSettings(), mode=mode)


def test_path_c_matches_jax_and_the_exact_chain():
    S, blocks = 4, 5
    jn = _jax_path_c(S, 0.5, 3, "pallas")
    tn, ts = rtt.make_per_stream_chain(S, seconds=0.5, seed=3, mode="pallas",
                                       device="cpu")
    te, _ = rtt.make_per_stream_chain(S, seconds=0.5, seed=3, mode="exact",
                                      device="cpu")
    js = jn.init_state()
    jemit = jax.jit(lambda s: jn.emit(s, 640))
    outs = []
    for _ in range(blocks):
        js, o, v = jemit(js)
        assert int(v) == 640
        outs.append(np.asarray(o))
    _, ot, vt = rtt.render_blocks(tn, ts, blocks, 640)
    assert vt.tolist() == [640] * blocks
    assert np.abs(ot.numpy()).max() > 0.01
    np.testing.assert_allclose(ot.numpy(), np.concatenate(outs, 1), atol=2e-5, rtol=0)
    # the per-stream chain up to the mix (the master limiter aside, whose
    # "pallas" is the blocked order): the same recurrences, 0.0
    _, mp, _ = rtt.render_blocks(tn.input, tn.input.init_state(), blocks, 640)
    _, me, _ = rtt.render_blocks(te.input, te.input.init_state(), blocks, 640)
    assert torch.equal(mp, me)


def test_dma_ring_plain_is_the_tile_row_sum():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1000, 64)).astype(np.float32)
    want = np.zeros(64, np.float32)
    for i in range(0, 1000, 118):
        want = want + x[i]
    for lanes in (8, 32):
        for route in ("tma", "cp.async"):
            got = dma_roofline.dma_ring(torch.from_numpy(x), tr=118, depth=3,
                                        lanes=lanes, route=route)
            np.testing.assert_array_equal(got.numpy(), want)
    assert dma_roofline.launches == 0  # the plain version, on the CPU
    # K1's block at n = 12800: 11761 rows, its 128-frame tile ~128 * 147/160
    assert dma_roofline.k1_stream(12800) == (11761, 118)


@pytest.mark.parametrize("shape,kw", [
    ((100, 6), {}),                                   # L % 4 != 0
    ((100, 8), {"tr": 257}),                          # more rows than a TMA box
    ((100, 8), {"tr": 0}),
    ((100, 64), {"lanes": 32, "tr": 256, "depth": 8}),  # 8 x 32 KB > 227 KB
    ((100, 64), {"lanes": 32, "tr": 118, "depth": 16, "route": "cp.async"}),
    ((100, 64), {"lanes": 2}),                        # a box row under 16 bytes
    ((100, 64), {"lanes": 36}),                       # one warp holds <= 32 lanes
    ((100, 64), {"lanes": 6}),
    ((100, 64), {"depth": 5, "route": "cp.async"}),   # no such instance
    ((100, 64), {"depth": 1}),
    ((100, 64), {"depth": 65}),
    ((100, 64), {"route": "ldg"}),
])
def test_dma_ring_refuses_what_its_kernel_cannot_take(shape, kw):
    """The wrapper checks its arguments before it dispatches, on any device,
    so the refusals the card would give are raised here too."""
    x = torch.zeros(shape, dtype=torch.float32)
    kw = {"tr": 118, **kw}
    with pytest.raises(ValueError):
        dma_roofline.dma_ring(x, **kw)
    assert dma_roofline.launches == 0


def test_dma_ring_refuses_an_unaligned_base():
    x = torch.zeros(4 * 101 + 1, dtype=torch.float32)[1:].reshape(101, 4)
    with pytest.raises(ValueError, match="aligned"):
        dma_roofline.dma_ring(x, tr=7)


def test_dma_ring_bytes_at_k1_geometry():
    """K1's tile of 118 rows x 8 lanes is 3776 bytes, a 3840-byte slot; the
    TMA ring adds its barriers (a 128-byte multiple) and 128 bytes of
    alignment; 32 lanes at depth 16 do not fit a block."""
    assert dma_roofline.ring_bytes(118, 8, 16) == 128 + 256 + 16 * 3840
    assert dma_roofline.ring_bytes(118, 8, 3, "cp.async") == 3 * 3776
    assert dma_roofline.ring_bytes(118, 32, 16) > dma_roofline.SMEM_OPTIN
    assert dma_roofline.ring_bytes(118, 8, 32) <= dma_roofline.SMEM_OPTIN
    assert dma_roofline.in_flight_bytes(118, 8, 3, "cp.async") == 2 * 3776
    assert dma_roofline.in_flight_bytes(118, 8, 8, "tma") == 8 * 3776


def test_stream_blocks_is_two_an_sm():
    assert dma_roofline.stream_blocks(torch.zeros(11761, 1024)) == 264
    assert dma_roofline.stream_blocks(torch.zeros(5, 8)) == 1
    assert dma_roofline.stream_blocks(torch.zeros(3, 2048)) == 3
    n = 11761 * 1024
    got = dma_roofline.stream_max(torch.arange(n, dtype=torch.float32))
    # block b's last piece is the last p = b (mod 264) below 5881 pieces of 2048
    last = [max(p for p in range(b, -(-n // 2048), 264)) for b in range(264)]
    want = [min((p + 1) * 2048, n) - 1 for p in last]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


def test_stream_max_plain_is_the_chunk_max():
    """Block b's max is over the pieces (of 512 float4s) b, b + blocks, ..."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1000, 40)).astype(np.float32)
    got = dma_roofline.stream_max_plain(torch.from_numpy(x), blocks=7)
    flat = x.reshape(-1)
    pieces = [flat[i:i + 2048] for i in range(0, flat.size, 2048)]
    want = [max(pieces[p].max() for p in range(b, len(pieces), 7)) for b in range(7)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    got = dma_roofline.stream_max_plain(torch.from_numpy(x[:2]), blocks=3)
    np.testing.assert_array_equal(got.numpy(), [x[:2].max(), -np.inf, -np.inf])


def test_op_chain_plain_is_the_rounded_chain():
    xab = np.array([1.0, 0.999, 1e-3], np.float32)
    x = xab[0]
    for _ in range(3 * 16):
        x = np.float32(np.float32(x * xab[1]) + xab[2])
    got = op_latency.op_chain(torch.from_numpy(xab), 3)
    np.testing.assert_array_equal(got.numpy(), [x])


def test_smooth_chain_plain_is_the_smoother_run():
    """The smoother probe's plain version: 32 steps an iteration of the
    AGC's smoother toward lo, hi in turn, as smooth_gains runs it."""
    p = torch.tensor(op_latency.SMOOTH_PARAMS)
    des = torch.tensor([[p[4].item(), p[5].item()] * 48])
    want = cuda_scan.smooth_gains(des, p[0:1], p[1], p[2], p[3])[:, -1]
    assert torch.equal(op_latency.smooth_chain(p, 3), want)


def test_entry_points_default_to_the_card():
    """With no device the port runs on the card; on a host without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        rtt.make_flagship(4, seconds=0.1)
    with pytest.raises(RuntimeError, match="cuda"):
        SamplesBuffer(2, 44100, np.zeros((2, 10), np.float32))
    node, st = rtt.make_flagship(4, seconds=0.1, device="cpu")
    assert node.device == torch.device("cpu")
