"""The job set-up's content probe (``rodio_tpu_torch/ops/pack.py``, the
flags of the buffer's one pass) on the CPU: its plain version against the
expression ``flagship._content_probe`` ran before the kernel (kept below as
it was) and the JAX package's probe, and the precision
``FusedWidePipeline`` resolves from it. The kernel is held to the plain
version on the card in ``test_torch_cuda.py``.

The JAX package is held to the same flags on every case but subnormals,
where XLA's CPU may flush them; the port follows torch there.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probe_cases import NAMES, SUBNORMAL_CASES, case
from rodio_tpu.flagship import _content_probe as j_content_probe
from rodio_tpu_torch.flagship import FusedWidePipeline
from rodio_tpu_torch.ops import pack
from rodio_tpu_torch.utils import trace
from rodio_tpu_torch.sources.generators import SamplesBuffer


def torch_expression(data: torch.Tensor) -> tuple:
    """The probe as ``flagship._content_probe`` ran it before the kernel."""
    s = data * 32768.0  # exact: a pure exponent shift in f32
    k = torch.round(s)
    g16 = ((s == k) & (k >= -32768.0) & (k <= 32767.0)).all()
    s24 = data * 8388608.0
    k24 = torch.round(s24)
    g24 = ((s24 == k24) & (k24 >= -8388608.0) & (k24 <= 8388607.0)).all()
    p1 = data.to(torch.bfloat16).to(data.dtype)
    r = data - p1
    tp = (r == r.to(torch.bfloat16).to(data.dtype)).all()
    res = torch.stack([g16, g24, tp]).cpu().tolist()  # one read-back
    return (bool(res[0]), bool(res[1]), bool(res[2]))


def ladder(flags) -> str:
    g16, g24, tp = flags
    return "i8" if g16 else "i24" if g24 else "int2" if tp else "int3"


@pytest.mark.parametrize("name", NAMES)
def test_plain_probe_matches_the_old_expression_and_jax(name):
    arr, want = case(name)
    data = torch.from_numpy(arr)
    assert torch_expression(data) == want
    assert pack.content_flags(pack.probe_fails_plain(data)) == want
    # the pack's flags, of the case as a [C, frames] source and of its
    # transposed view: a CPU tensor takes the plain version
    before = trace.counts["rt_pack_time_major"]
    for src in (data, data.T.contiguous().T):
        _, fails = pack.pack_time_major(src, arr.shape[1] + 5)
        assert pack.content_flags(fails) == want
    assert trace.counts["rt_pack_time_major"] == before
    if name not in SUBNORMAL_CASES:
        assert j_content_probe(types.SimpleNamespace(_data=jnp.asarray(arr))) == want
    # the precision the fused pipeline resolves from it, through the
    # buffer's flags, read back once and kept
    buf = SamplesBuffer(arr.shape[0], 44100, data, device="cpu")
    fused = FusedWidePipeline(buf, 48000, np.ones(arr.shape[0], np.float32),
                              arr.shape[0] // 2)
    assert buf.content_flags() == want and buf.content_flags() is buf.content_flags()
    assert fused.precision == ladder(want)
    for precision, flag in (("i8", want[0]), ("i24", want[1])):
        if flag:
            assert FusedWidePipeline(buf, 48000, np.ones(arr.shape[0], np.float32),
                                     arr.shape[0] // 2, precision=precision).precision == precision
        else:
            with pytest.raises(ValueError, match="needs content exactly on the"):
                FusedWidePipeline(buf, 48000, np.ones(arr.shape[0], np.float32),
                                  arr.shape[0] // 2, precision=precision)


def test_the_kernel_wrapper_takes_only_cuda_tensors():
    """The pack takes a CPU tensor (its plain version) or a CUDA one (the
    kernel), 2-D float32 or float64, into at least its frames' rows; it
    raises on anything else."""
    with pytest.raises(ValueError, match="unsupported device"):
        pack.pack_time_major(torch.zeros((2, 8), device="meta"), 8)
    for bad in (torch.zeros((2, 8), dtype=torch.bfloat16), torch.zeros(8),
                torch.zeros((1, 2, 8)), torch.zeros((2, 8), dtype=torch.int32)):
        with pytest.raises(ValueError, match="2-D float32 or float64"):
            pack.pack_time_major(bad, 8)
    with pytest.raises(ValueError, match="fewer than the 8 frames"):
        pack.pack_time_major(torch.zeros((2, 8)), 7)
