"""The port's CLI, ``python -m rodio_tpu_torch`` (test_cli.py's cases on a
file made here), against the JAX package's CLI, on the CPU.

``render --agc`` takes ``mode="exact"`` with ``--device cpu`` and
``"pallas"`` on the card; the two are held within 1e-6 here (the plain
versions of the card's kernels run on the CPU).
"""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rodio_tpu_torch.__main__ import main, render_chain
from rodio_tpu_torch.io.decoder import Decoder
from rodio_tpu_torch.io.wav import read_wav
from test_torch_io_fixtures import bounded, pcm16_master, write_flac, write_pcm_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def beep(tmp_path_factory):
    """1 s of seeded 16-bit-grid stereo at 44.1 kHz, as WAV and as FLAC."""
    d = tmp_path_factory.mktemp("cli")
    k, _ = pcm16_master(13, 2, 44100, scale=0.3)
    write_pcm_wav(str(d / "beep.wav"), k, 44100, 16)
    write_flac(str(d / "beep.flac"), k, 44100)
    return d


def _main(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def test_cli_probe(beep):
    rc, out = _main("probe", str(beep / "beep.flac"), "--device", "cpu")
    assert rc == 0
    assert "channels:  2" in out and "rate:      44100 Hz" in out
    assert "frames:    44100" in out and "duration:  1.000000 s" in out


def test_cli_render(beep, tmp_path):
    out = str(tmp_path / "out.wav")
    rc, text = _main("render", str(beep / "beep.wav"), out, "--rate", "48000", "--limit",
                     "--seconds", "0.25", "--device", "cpu")
    assert rc == 0 and f"wrote {out}" in text
    pcm, rate = read_wav(out)
    assert rate == 48000
    assert abs(pcm.shape[1] - 12000) < 32  # 0.25 s, give or take the resampler's tail
    assert np.isfinite(pcm).all()


def test_cli_devices_through_python_m():
    r = subprocess.run([sys.executable, "-m", "rodio_tpu_torch", "devices"],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "null/file/callback" in r.stdout


def test_cli_render_matches_the_jax_cli(beep, tmp_path):
    """The same command through both CLIs (no AGC: the JAX CLI's is the
    exact node, drifting on XLA:CPU, F4): within 1e-6."""
    args = [str(beep / "beep.flac"), "--rate", "48000", "--low-pass", "2000",
            "--limit", "--seconds", "0.5"]
    env = {**os.environ, "RODIO_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"}
    jax_out = str(tmp_path / "jax.wav")
    r = subprocess.run([sys.executable, "-m", "rodio_tpu", "render", args[0], jax_out,
                        *args[1:]], capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    port_out = str(tmp_path / "port.wav")
    assert _main("render", args[0], port_out, *args[1:], "--device", "cpu")[0] == 0
    got, rate = read_wav(port_out)
    want, jrate = read_wav(jax_out)
    assert rate == jrate == 48000 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_cli_agc_exact_on_the_cpu_matches_the_kernel_mode(beep, tmp_path):
    """``render --agc --device cpu`` runs the exact node; the card runs
    ``mode="pallas"`` (K8 and K7). The same graph in kernel mode, built by
    hand (the kernels' plain versions here): within 1e-6."""
    from rodio_tpu_torch.effects.agc import AgcSettings, AutomaticGainControl
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.conversions.resample import Resample

    out = str(tmp_path / "agc.wav")
    assert _main("render", str(beep / "beep.flac"), out, "--rate", "48000",
                 "--low-pass", "2000", "--agc", "--limit", "--seconds", "0.2",
                 "--device", "cpu")[0] == 0
    got, _ = read_wav(out)
    node = Resample(Decoder(str(beep / "beep.flac"), device="cpu").take_duration(0.2), 48000)
    node = node.low_pass(2000.0)
    node = AutomaticGainControl(node, AgcSettings(), mode="pallas")
    want = Limit(node, LimitSettings(), mode="auto").render()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_render_chain_picks_the_agc_mode_by_device():
    from rodio_tpu_torch.effects.agc import AutomaticGainControl
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    src = SamplesBuffer(2, 48000, np.zeros((2, 100), np.float32), device="cpu")
    node = render_chain(src, agc=True)
    assert isinstance(node, AutomaticGainControl) and node.mode == "exact"
    assert render_chain(src) is src


def test_cli_help_names_the_agc_modes():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["render", "--help"])
    text = " ".join(out.getvalue().split())
    assert "'pallas'" in text and "'exact' with --device cpu" in text


def test_cli_runs_on_the_card_by_default(beep):
    """Without ``--device`` the CLI asks for the card; with none it raises
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        rc, out = _main("probe", str(beep / "beep.wav"))
        assert rc == 0 and "device:    cuda" in out
        return
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["probe", str(beep / "beep.wav")])


@bounded(120)
def test_cli_play_to_the_null_sink(beep):
    """``play`` runs the threaded sink (the realtime null device here)
    until the player's queue is empty."""
    rc, _ = _main("play", str(beep / "beep.wav"), "--seconds", "0.2", "--volume", "0.5",
                  "--device", "cpu")
    assert rc == 0
