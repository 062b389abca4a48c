"""A buffer's PCM onto the device in one pass (``csrc/pack_time_major.cu``):
the time-major, zero-padded layout that K1 and K2 read, and the content
probe's three flags.

:func:`pack_time_major` reads a ``[C, frames]`` source of any strides once
and returns ``(tm, fails)``: ``tm`` is ``[rows, C]`` and contiguous, frame f
of lane l at ``tm[f, l]`` and the rows from ``frames`` on zero; ``fails`` is
an int32 ``[3]`` on the source's device, 0 where a flag holds over ``tm``
and 1 where it fails (``None`` for a float64 source: the fused pipelines
that read the flags refuse float64). The flags, each the AND over every
element x (the zero rows pass each):

- ``int16_grid_exact``: ``s = x * 2^15`` equals ``round(s)``, which lies in
  [-32768, 32767];
- ``int24_grid_exact``: the same at ``2^23``, in [-2^23, 2^23 - 1];
- ``two_piece_exact``: ``r = x - f32(bf16(x))`` equals ``f32(bf16(r))``.

They are the counterpart of the XLA-fused probe of
``rodio_tpu/flagship.py:91-121``, as the layout is of its XLA relayout
(``rodio_tpu/flagship.py:454-470``). On a CUDA tensor the kernel runs (an
f64 instance without the flags); on a CPU tensor
:func:`pack_time_major_plain`, the same function in PyTorch ops: the two
give the same ``tm`` and flags, NaN, infinities, -0.0 and subnormals
included. :func:`content_flags` reads ``fails`` back once.
``utils.trace.counts["rt_pack_time_major"]`` (``..._f64``) counts the
kernel's launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build


def probe_fails_plain(data: torch.Tensor) -> torch.Tensor:
    """The three flags' fail words (int32 [3]: 0 where a flag holds) over
    the f32 ``data``, in PyTorch ops, on any device."""
    s = data * 32768.0  # exact: a pure exponent shift in f32
    k = torch.round(s)
    g16 = ((s == k) & (k >= -32768.0) & (k <= 32767.0)).all()
    s24 = data * 8388608.0
    k24 = torch.round(s24)
    g24 = ((s24 == k24) & (k24 >= -8388608.0) & (k24 <= 8388607.0)).all()
    p1 = data.to(torch.bfloat16).to(data.dtype)
    r = data - p1
    tp = (r == r.to(torch.bfloat16).to(data.dtype)).all()
    return (~torch.stack([g16, g24, tp])).to(torch.int32)


def content_flags(fails: torch.Tensor) -> tuple:
    """(int16_grid_exact, int24_grid_exact, two_piece_exact) from the fail
    words: one read-back."""
    res = fails.cpu().tolist()
    return (not res[0], not res[1], not res[2])


def _check(src: torch.Tensor, rows: int) -> None:
    if src.dim() != 2 or src.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pack_time_major: src must be a 2-D float32 or float64 "
                         f"tensor, got {src.dtype} {tuple(src.shape)}")
    if rows < src.shape[1]:
        raise ValueError(f"pack_time_major: {rows} rows hold fewer than the "
                         f"{src.shape[1]} frames")


def pack_time_major_plain(src: torch.Tensor, rows: int
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(tm, fails) of :func:`pack_time_major` in PyTorch ops, on any
    device."""
    _check(src, rows)
    C, frames = src.shape
    tm = torch.zeros((rows, C), dtype=src.dtype, device=src.device)
    tm[:frames] = src.T
    return tm, probe_fails_plain(tm) if src.dtype == torch.float32 else None


def pack_time_major(src: torch.Tensor, rows: int
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(tm [rows, C], fails) of ``src`` [C, frames]: the kernel on a CUDA
    tensor, on the current stream and with no synchronisation; the plain
    version on a CPU tensor."""
    if src.device.type == "cpu":
        return pack_time_major_plain(src, rows)
    if src.device.type != "cuda":
        raise ValueError(f"pack_time_major: unsupported device {src.device}")
    _check(src, rows)
    C, frames = src.shape
    dev = src.device
    tm = torch.empty((rows, C), dtype=src.dtype, device=dev)
    ls, fs = src.stride()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if src.dtype == torch.float64:
        _build.launch("rt_pack_time_major_f64", src.data_ptr(), C, frames, ls, fs,
                      rows, tm.data_ptr(), sms, device=dev)
        return tm, None
    fails = torch.empty(3, dtype=torch.int32, device=dev)
    _build.launch("rt_pack_time_major", src.data_ptr(), C, frames, ls, fs, rows,
                  tm.data_ptr(), fails.data_ptr(), sms, device=dev)
    return tm, fails
