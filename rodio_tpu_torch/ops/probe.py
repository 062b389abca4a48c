"""The job set-up's content probe (``csrc/content_probe.cu``).

Three flags of a 2-D f32 PCM buffer, each the AND over every element x:

- ``int16_grid_exact``: ``s = x * 2^15`` equals ``round(s)``, which lies in
  [-32768, 32767];
- ``int24_grid_exact``: the same at ``2^23``, in [-2^23, 2^23 - 1];
- ``two_piece_exact``: ``r = x - f32(bf16(x))`` equals ``f32(bf16(r))``.

They are the counterpart of the XLA-fused probe of
``rodio_tpu/flagship.py:91-121``. :func:`content_probe` launches the kernel
on a CUDA tensor (one pass over the buffer, then one read-back of three
words) and runs :func:`content_probe_plain`, the same expression in PyTorch
ops, on a CPU tensor; the two give the same flags, NaN, infinities, -0.0
and subnormals included. ``utils.trace.counts["rt_content_probe"]``
counts the kernel's launches.
"""
from __future__ import annotations

import torch

from . import _build


def content_probe_plain(data: torch.Tensor) -> tuple:
    """(int16_grid_exact, int24_grid_exact, two_piece_exact) in PyTorch ops,
    on any device, with one read-back."""
    s = data * 32768.0  # exact: a pure exponent shift in f32
    k = torch.round(s)
    g16 = ((s == k) & (k >= -32768.0) & (k <= 32767.0)).all()
    s24 = data * 8388608.0
    k24 = torch.round(s24)
    g24 = ((s24 == k24) & (k24 >= -8388608.0) & (k24 <= 8388607.0)).all()
    p1 = data.to(torch.bfloat16).to(data.dtype)
    r = data - p1
    tp = (r == r.to(torch.bfloat16).to(data.dtype)).all()
    res = torch.stack([g16, g24, tp]).cpu().tolist()
    return (bool(res[0]), bool(res[1]), bool(res[2]))


def probe_fails(data: torch.Tensor) -> torch.Tensor:
    """Launch the kernel over ``data`` (a contiguous 2-D f32 CUDA tensor)
    on the current stream: int32 [3] on the card, 0 where a flag holds and
    1 where it fails. No synchronisation."""
    if data.device.type != "cuda":
        raise ValueError(f"probe_fails: a CUDA tensor is needed, got {data.device}")
    if data.dtype != torch.float32 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError(
            f"probe_fails: data must be a contiguous 2-D float32 tensor, got "
            f"{data.dtype} {tuple(data.shape)}"
            f"{'' if data.is_contiguous() else ' (not contiguous)'}")
    fails = torch.empty(3, dtype=torch.int32, device=data.device)
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    _build.launch("rt_content_probe", data.data_ptr(), data.numel(), sms,
                  fails.data_ptr(), device=data.device)
    return fails


def content_probe(data: torch.Tensor) -> tuple:
    """(int16_grid_exact, int24_grid_exact, two_piece_exact) of ``data``:
    the kernel and one read-back on a CUDA tensor, the plain version on a
    CPU tensor."""
    if data.device.type == "cpu":
        return content_probe_plain(data)
    res = probe_fails(data).cpu().tolist()  # the one read-back
    return (not res[0], not res[1], not res[2])
