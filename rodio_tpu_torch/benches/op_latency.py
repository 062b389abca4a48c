"""The latency of one dependent rounded f32 op (FMUL or FADD) on the card,
of one f64 op (DMUL or DADD), and of one step of the AGC's gain smoother.

A recurrence kernel (K1-K8) cannot finish sooner than its serial steps
times the dependent ops of a step times this latency: its chain floor.
:func:`seconds_per_op` times one thread's chain of FMUL and FADD in turn
(``csrc/op_latency.cu``) at two lengths, so that the launch cancels out;
``chip_smoke.py`` takes every kernel's chain floor from it, and the f64
instances' (K3, K4, K7, K8) from :func:`seconds_per_dop`, the same chain
of DMUL and DADD (``rt_op_chain_f64``).
:func:`smooth_step` times one thread's chain of the smoother's steps
(``smooth_gain``, whose mul, add, max, min and select bind K6's and K7's
smoother warps) the same way, and reads its SM cycles a step from
``clock64()``. Without a card the measurements fail.
"""
from __future__ import annotations

import torch

from ..ops import _build
from ..ops.cuda_scan import smooth_gain

#: dependent ops per iteration of the kernel's loop
OPS_PER_ITER = 32
#: iterations of the shorter timed chain: 8.4 M ops, ~17 ms on an H100
ITERS = 1 << 18


def op_chain_plain(xab: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of :func:`op_chain`: x = x*a, x = x + b, 16 times
    per iteration, each op rounded to xab's type."""
    x, a, b = xab[0:1], xab[1:2], xab[2:3]
    for _ in range(iters * OPS_PER_ITER // 2):
        x = x * a + b
    return x


def op_chain(xab: torch.Tensor, iters: int) -> torch.Tensor:
    """xab: f32 [3] (x0, a, b), or f64 for the DMUL/DADD chain. Returns
    [1]: x after ``iters`` iterations of 32 dependent ops on one thread."""
    if xab.device.type == "cpu":
        return op_chain_plain(xab, iters)
    if xab.device.type != "cuda":
        raise ValueError(f"op_chain: unsupported device {xab.device}")
    f64 = xab.dtype == torch.float64
    dt = torch.float64 if f64 else torch.float32
    xab = _build._typed_arg("xab", xab, dt, xab.device, (3,))
    out = torch.empty(1, dtype=dt, device=xab.device)
    name = "rt_op_chain_f64" if f64 else "rt_op_chain"
    err = getattr(_build.load_library(), name)(xab.data_ptr(), out.data_ptr(),
                                               iters, _build.stream_handle(xab.device))
    _build.check(err, name)
    return out


def smooth_chain_plain(p: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of :func:`smooth_chain`'s gain: ``iters`` x 32
    smoother steps toward lo, hi in turn."""
    g, att, rel, max_gain, lo, hi = (p[i:i + 1] for i in range(6))
    for _ in range(iters * OPS_PER_ITER // 2):
        g = smooth_gain(smooth_gain(g, lo, att, rel, max_gain), hi, att, rel, max_gain)
    return g


def smooth_chain(p: torch.Tensor, iters: int) -> torch.Tensor:
    """p: f32 [6] (g0, att, rel, max_gain, lo, hi). Returns [2] on the card:
    the gain after ``iters`` x 32 dependent smoother steps on one thread,
    and the SM cycles they took; on the CPU the plain version's gain."""
    if p.device.type == "cpu":
        return smooth_chain_plain(p, iters)
    if p.device.type != "cuda":
        raise ValueError(f"smooth_chain: unsupported device {p.device}")
    p = _build.f32_arg("p", p, p.device, (6,))
    out = torch.empty(2, dtype=torch.float32, device=p.device)
    err = _build.load_library().rt_smooth_chain(p.data_ptr(), out.data_ptr(), iters,
                                                _build.stream_handle(p.device))
    _build.check(err, "rt_smooth_chain")
    return out


def _seconds_per_step(chain) -> float:
    """Seconds per step of ``chain(k)`` (k iterations of 32 dependent
    steps): the chain of 2*ITERS iterations less the chain of ITERS, each
    the least of 3 calls timed by CUDA events, over ITERS * 32 steps."""
    def least_ms(k):
        best = float("inf")
        for _ in range(3):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = chain(k)
            e.record()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"the chain gave {out.tolist()}")
            best = min(best, s.elapsed_time(e))
        return best

    least_ms(1)  # the first launch loads the module
    return (least_ms(2 * ITERS) - least_ms(ITERS)) / 1e3 / (ITERS * OPS_PER_ITER)


def seconds_per_op(device) -> float:
    """Seconds per dependent FMUL or FADD on one thread."""
    xab = torch.tensor([1.0, 0.999, 1e-3], dtype=torch.float32, device=device)
    return _seconds_per_step(lambda k: op_chain(xab, k))


def seconds_per_dop(device) -> float:
    """Seconds per dependent DMUL or DADD on one thread: the chain floor's
    latency for the f64 instances."""
    xab = torch.tensor([1.0, 0.999, 1e-3], dtype=torch.float64, device=device)
    return _seconds_per_step(lambda k: op_chain(xab, k))


#: (g0, att, rel, max_gain, lo, hi): AgcSettings()'s attack at 48 kHz, a 50
#: ms release, and desired gains on both sides of the gain
SMOOTH_PARAMS = (1.0, 0.9999948, 0.9995834, 7.0, 0.5, 3.0)


def smooth_step(device):
    """(seconds, SM cycles) per dependent smoother step on one thread."""
    p = torch.tensor(SMOOTH_PARAMS, dtype=torch.float32, device=device)
    seconds = _seconds_per_step(lambda k: smooth_chain(p, k))
    out = smooth_chain(p, ITERS)
    return seconds, float(out[1].item()) / (ITERS * OPS_PER_ITER)
