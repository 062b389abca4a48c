"""The latency of one dependent rounded f32 op (FMUL or FADD) on the card.

A recurrence kernel (K1-K8) cannot finish sooner than its serial steps
times the dependent ops of a step times this latency: its chain floor.
:func:`seconds_per_op` times one thread's chain of FMUL and FADD in turn
(``csrc/op_latency.cu``) at two lengths, so that the launch cancels out;
``chip_smoke.py`` takes every kernel's chain floor from it. Without a
card the measurement fails.
"""
from __future__ import annotations

import torch

from ..ops import _build

#: dependent ops per iteration of the kernel's loop
OPS_PER_ITER = 32
#: iterations of the shorter timed chain: 8.4 M ops, ~17 ms on an H100
ITERS = 1 << 18


def op_chain_plain(xab: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of :func:`op_chain`: x = x*a, x = x + b, 16 times
    per iteration, each op rounded to f32."""
    x, a, b = xab[0:1], xab[1:2], xab[2:3]
    for _ in range(iters * OPS_PER_ITER // 2):
        x = x * a + b
    return x


def op_chain(xab: torch.Tensor, iters: int) -> torch.Tensor:
    """xab: f32 [3] (x0, a, b). Returns [1]: x after ``iters`` iterations
    of 32 dependent ops on one thread."""
    if xab.device.type == "cpu":
        return op_chain_plain(xab, iters)
    if xab.device.type != "cuda":
        raise ValueError(f"op_chain: unsupported device {xab.device}")
    xab = _build.f32_arg("xab", xab, xab.device, (3,))
    out = torch.empty(1, dtype=torch.float32, device=xab.device)
    err = _build.load_library().rt_op_chain(xab.data_ptr(), out.data_ptr(),
                                            iters, _build.stream_handle(xab.device))
    _build.check(err, "rt_op_chain")
    return out


def seconds_per_op(device) -> float:
    """Seconds per dependent op: the chain of 2*ITERS iterations less the
    chain of ITERS, each the least of 3 calls timed by CUDA events, over
    ITERS * 32 ops."""
    xab = torch.tensor([1.0, 0.999, 1e-3], dtype=torch.float32, device=device)

    def least_ms(k):
        best = float("inf")
        for _ in range(3):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = op_chain(xab, k)
            e.record()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"op_chain gave {out.item()}")
            best = min(best, s.elapsed_time(e))
        return best

    least_ms(1)  # the first launch loads the module
    return (least_ms(2 * ITERS) - least_ms(ITERS)) / 1e3 / (ITERS * OPS_PER_ITER)
