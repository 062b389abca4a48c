"""The generators' phase accumulator (``csrc/phase.cu``).

The counterpart of the ``lax.scan`` of ``SignalGenerator.emit`` with
``rodio_compat=True`` (rodio_tpu/sources/generators.py:96-112): the
reference's per-sample f32 recurrence ``p = (p + step) - floor(p + step)``
(src/source/signal_generator.rs:133), with its drift. It is serial, so on
the card it is one kernel launch a block, one thread a generator, and not
a host loop of per-sample launches.

:func:`phase_accumulate` launches the kernel on a CUDA tensor and runs
:func:`phase_accumulate_plain`, a loop of PyTorch ops, on a CPU tensor;
both round every op alone, so they agree bit for bit. On f64 tensors
(``set_float64``: JAX's f32 step widened to f64, then f64 adds) the
kernel's f64 instance runs. ``utils.trace.counts`` counts the launches
as ``rt_phase_accumulate`` and ``rt_phase_accumulate_f64``.
"""
from __future__ import annotations

import torch

from . import _build


def phase_accumulate_plain(phase0: torch.Tensor, step: torch.Tensor, n: int):
    """The plain PyTorch version, on any device."""
    p = phase0
    out = []
    for _ in range(n):
        out.append(p)
        s = p + step
        p = s - torch.floor(s)
    phases = torch.stack(out, dim=-1) if out else phase0.new_zeros((phase0.shape[0], 0))
    return phases, p


def phase_accumulate(phase0: torch.Tensor, step: torch.Tensor, n: int):
    """The phases of G generators over n samples from phase0 [G] with
    steps step [G] (f32, or both f64): returns (phases [G, n], the phase
    after them [G]); phases[:, k] is the phase sample k is computed from."""
    if phase0.device.type == "cpu":
        return phase_accumulate_plain(phase0, step, n)
    if phase0.device.type != "cuda":
        raise ValueError(f"phase_accumulate: unsupported device {phase0.device}")
    if phase0.dim() != 1 or n < 0:
        raise ValueError(f"phase_accumulate: phase0 must be [G] and n >= 0, got "
                         f"{tuple(phase0.shape)}, n={n}")
    G, dev = phase0.shape[0], phase0.device
    f64 = phase0.dtype == torch.float64
    dt = torch.float64 if f64 else torch.float32
    phase0 = _build._typed_arg("phase0", phase0, dt, dev, (G,))
    step = _build._typed_arg("step", step, dt, dev, (G,))
    phases = torch.empty((G, n), dtype=phase0.dtype, device=dev)
    out = torch.empty(G, dtype=phase0.dtype, device=dev)
    _build.launch("rt_phase_accumulate_f64" if f64 else "rt_phase_accumulate",
                  phase0.data_ptr(), step.data_ptr(), phases.data_ptr(),
                  out.data_ptr(), G, n, device=dev)
    return phases, out
