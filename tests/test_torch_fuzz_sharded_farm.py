"""Differential fuzz of the port's sharded farm: ShardedStreamFarm on n
gloo ranks against the single-card fused StreamFarm over the same files
(the cases of tests/test_fuzz_sharded_farm.py: random rank counts, block
and chunk sizes, wires, loops, offsets, gains and a seek before the run),
at the mix-order bound 2e-6. The files are 16-bit WAVs written here; each
case's ranks run under a 120 s limit. ``slow``, as the original is: run
it with ``-m slow``.
"""
import numpy as np
import pytest

import torch_dist_ranks as R
from rodio_tpu_torch.parallel.farm import StreamFarm
from rodio_tpu_torch.parallel.launch import spawn_ranks
from test_torch_io_fixtures import pcm16_master, write_pcm_wav

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def asset(tmp_path_factory):
    """A 4 s 16-bit stereo WAV at 44.1 kHz in place of the reference's
    music.flac."""
    p = str(tmp_path_factory.mktemp("fuzz") / "music.wav")
    k, _ = pcm16_master(77, 2, 4 * 44100)
    write_pcm_wav(p, k, 44100, 16)
    return p


def _case(seed: int, asset: str):
    """tests/test_fuzz_sharded_farm.py's case of this seed, on ``asset``."""
    rng = np.random.default_rng(61000 + seed)
    n_dev = int(rng.choice([2, 4, 8]))
    mult = int(rng.choice([1, 2]))
    S = n_dev * mult
    return dict(
        n_dev=n_dev, paths=[asset] * S,
        common=dict(
            block_frames=int(rng.choice([640, 1280, 2560])),
            chunk_frames=int(rng.choice([4096, 8192])),
            wire=str(rng.choice(["f32", "i16", "i24"])),
            loop=bool(rng.random() < 0.3), decode_workers=4,
            start_offsets=[float(o) for o in rng.uniform(0.0, 2.0, S)],
            gains=(rng.uniform(0.3, 1.2, S).astype(np.float32) / S
                   if rng.random() < 0.5 else None)),
        seek=((int(rng.integers(S)), float(rng.uniform(0.2, 3.0)))
              if rng.random() < 0.5 else None),
        n_blocks=int(rng.integers(3, 7)),
    )


# seeds 0-7 and 11, as the original pins them (every wire, uneven gains,
# seeks, loops, 2/4/8 ranks)
@pytest.mark.parametrize("seed", list(range(8)) + [11])
def test_fuzz_sharded_farm(seed, asset, tmp_path):
    cfg = _case(seed, asset)
    farm = StreamFarm(cfg["paths"], fused=True, device="cpu", **cfg["common"])
    if cfg["seek"] is not None:
        farm.try_seek(*cfg["seek"])
    blocks = []
    va, ea, ova = farm.run(cfg["n_blocks"], on_block=lambda k, o, v: blocks.append(o.numpy()))
    farm.close()
    a = np.concatenate(blocks, 1)
    ranks = spawn_ranks(R.farm_rank, cfg["n_dev"], backend="gloo",
                        init_method=f"file://{tmp_path}/store",
                        args=(cfg["paths"], cfg), timeout=120.0)
    b, (vb, eb, ovb) = ranks[0]
    for other, _ in ranks[1:]:
        np.testing.assert_array_equal(other, b)
    assert not ova and not ovb, (cfg, ova, ovb)
    assert va == vb == cfg["n_blocks"] * cfg["common"]["block_frames"], (cfg, va, vb)
    assert ea > 0, cfg
    err = float(np.abs(a - b).max())
    assert err <= 2e-6, f"seed={seed}: max|sharded-single|={err:.3g} > 2e-6; cfg={cfg}"
