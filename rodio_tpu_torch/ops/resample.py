"""The resampler's weight form over a buffer's PCM in one pass
(``csrc/resample_lerp.cu``).

For the output frames ``out_o .. out_o + n - 1`` of a rational ratio
from/to, output frame o takes the taps ``left = (o // to) * from + (from *
(o % to)) // to`` and ``left + 1`` of the input stream that starts at frame
``start`` of a ``[C, W]`` tensor (zero outside ``[0, W)``), weighs them with
the phase's weights ``w0[o % to]`` and ``w1[o % to]`` (the nonzero entries
of the JAX package's lerp operator ``G0``/``g1``), and applies the drain
rule of :func:`drain_bookkeeping` against the ``in_end`` frames left from
``start``: the block's drain frame is its left tap unmodified, and frames
from ``valid`` on are zero.

:func:`lerp_block_plain` is that function in PyTorch ops over any gather
(``Resample``'s weight form, kept for every random-access input);
:func:`resample_lerp_plain` is it over a tensor. :func:`resample_lerp`
launches the kernel on a CUDA tensor and runs the plain version on a CPU
tensor: the two round each product and the sum alone, and agree bit for
bit. Each returns ``(block [C, n], out_o + n, valid, drained')``, the three
scalars fresh 0-dim tensors on the block's device: nothing is read back,
and no input is written. ``utils.trace.counts["rt_resample_lerp"]``
(``..._f64``) counts the kernel's launches.
"""
from __future__ import annotations

import torch

from ..core.node import clip_valid, mask_block, take_frames
from . import _build


def drain_bookkeeping(left: torch.Tensor, in_end: torch.Tensor,
                      drained: torch.Tensor, n: int, seg_drain=None):
    """Validity of a block of outputs whose left taps are ``left``
    (resample.py:326-345): returns (n_full, drain_ok, valid, drained').
    ``seg_drain`` marks a span's own drain frame, valid while its left
    frame exists."""
    full = left <= in_end - 2
    if seg_drain is not None:
        full = full | (seg_drain & (left <= in_end - 1))
    n_full = full.sum()
    # index_select, not left[n_full]: a 0-dim tensor index reads it back
    cand_left = left.index_select(0, torch.clamp(n_full, max=n - 1).view(1))[0]
    drain_ok = (n_full < n) & (cand_left == in_end - 1)
    valid = torch.where(drained, torch.zeros_like(n_full),
                        n_full + drain_ok.to(n_full.dtype))
    drained_new = drained | drain_ok | (valid < n)
    return n_full, drain_ok, clip_valid(valid, n), drained_new


def drain_and_mask(out, lval, left, in_end, drained, n: int, seg_drain=None):
    """A block's lerps ``out`` with the drain rule applied: the drain frame
    replaced by its left tap ``lval``, the frames from ``valid`` on zeroed.
    Returns (block, valid, drained')."""
    n_full, drain_ok, valid, drained = drain_bookkeeping(left, in_end, drained, n, seg_drain)
    i_idx = torch.arange(n, device=out.device)
    out = torch.where(((i_idx == n_full) & drain_ok)[None, :], lval, out)
    return mask_block(out, valid), valid, drained


def lerp_block_plain(gather, start, in_end, out_o, drained, w0, w1, n: int,
                     from_: int, to: int):
    """The weight form in PyTorch ops; ``gather(idx)`` returns the input
    frames at stream indices ``idx`` ([C, len(idx)])."""
    o = out_o + torch.arange(n, device=out_o.device)
    j = o % to
    left = (o // to) * from_ + (from_ * j) // to
    lval = gather(start + left)
    rval = gather(start + left + 1)
    out = lval * w0[j][None, :] + rval * w1[j][None, :]
    block, valid, drained = drain_and_mask(out, lval, left, in_end, drained, n)
    return block, out_o + n, valid, drained


def resample_lerp_plain(data, start, in_end, out_o, drained, w0, w1, n: int,
                        from_: int, to: int):
    """:func:`resample_lerp` in PyTorch ops, on any device."""
    return lerp_block_plain(lambda idx: take_frames(data, idx), start, in_end, out_o,
                            drained, w0, w1, n, from_, to)


def _scalar(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    return _build._typed_arg(name, t, dtype, device, ())


def resample_lerp(data, start, in_end, out_o, drained, w0, w1, n: int, from_: int, to: int):
    """The weight form of output frames ``out_o .. out_o + n - 1`` over
    ``data`` [C, W] (f32, or f64 with f64 weights) from input frame
    ``start``, ``in_end`` frames left from it: the kernel on a CUDA tensor,
    on the current stream and with no synchronisation, the plain version on
    a CPU tensor. ``start``, ``in_end``, ``out_o`` are 0-dim int64 and
    ``drained`` 0-dim bool tensors on ``data``'s device; ``w0``, ``w1``
    [to]."""
    if data.device.type == "cpu":
        return resample_lerp_plain(data, start, in_end, out_o, drained, w0, w1, n, from_, to)
    if data.device.type != "cuda":
        raise ValueError(f"resample_lerp: unsupported device {data.device}")
    if (data.dim() != 2 or data.dtype not in (torch.float32, torch.float64)
            or data.stride(-1) != 1 or n < 1):
        raise ValueError(f"resample_lerp: data must be a 2-D float32 or float64 tensor with "
                         f"contiguous frames and n >= 1, got {data.dtype} "
                         f"{tuple(data.shape)} at strides {data.stride()}, n={n}")
    dev, dt = data.device, data.dtype
    C, W = data.shape
    ls = data.stride(0) if C > 1 else W
    w0 = _build._typed_arg("w0", w0, dt, dev, (to,))
    w1 = _build._typed_arg("w1", w1, dt, dev, (to,))
    args = [_scalar(name, t, torch.int64, dev) for name, t in
            (("out_o", out_o), ("start", start), ("in_end", in_end))]
    drained = _scalar("drained", drained, torch.bool, dev)
    out = torch.empty((C, n), dtype=dt, device=dev)
    out_o_new = torch.empty((), dtype=torch.int64, device=dev)
    valid = torch.empty((), dtype=torch.int64, device=dev)
    drained_new = torch.empty((), dtype=torch.bool, device=dev)
    _build.launch("rt_resample_lerp_f64" if dt == torch.float64 else "rt_resample_lerp",
                  data.data_ptr(), C, W, ls, out.data_ptr(), n, from_, to, w0.data_ptr(),
                  w1.data_ptr(), *(t.data_ptr() for t in args), drained.data_ptr(),
                  out_o_new.data_ptr(), valid.data_ptr(), drained_new.data_ptr(), device=dev)
    return out, out_o_new, valid, drained_new
