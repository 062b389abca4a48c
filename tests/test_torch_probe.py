"""The job set-up's content probe (``rodio_tpu_torch/ops/probe.py``) on the
CPU: its plain version against the expression it replaced in
``flagship._content_probe`` (kept below as it was) and the JAX package's
probe, and the precision ``FusedWidePipeline`` resolves from it. The kernel
is held to the plain version on the card in ``test_torch_cuda.py``.

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
from rodio_tpu_torch.flagship import FusedWidePipeline, _content_probe
from rodio_tpu_torch.ops import probe
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
    before = trace.counts["rt_content_probe"]
    assert torch_expression(data) == want
    assert probe.content_probe_plain(data) == want
    assert probe.content_probe(data) == want
    # a CPU tensor takes the plain version
    assert trace.counts["rt_content_probe"] == before
    if name not in SUBNORMAL_CASES:
        assert j_content_probe(types.SimpleNamespace(_data=jnp.asarray(arr))) == want
    # the precision the fused pipeline resolves from it, through the node's
    # cached probe
    buf = SamplesBuffer(arr.shape[0], 44100, data, device="cpu")
    fused = FusedWidePipeline(buf, 48000, np.ones(arr.shape[0], np.float32),
                              arr.shape[0] // 2)
    assert buf._content_probe_cache == want and _content_probe(buf) is buf._content_probe_cache
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
    with pytest.raises(ValueError, match="a CUDA tensor is needed"):
        probe.probe_fails(torch.zeros((2, 8)))
