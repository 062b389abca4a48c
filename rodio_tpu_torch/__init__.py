"""rodio_tpu_torch — the PyTorch/CUDA port of rodio_tpu.

The same block-engine node protocol and numerics as :mod:`rodio_tpu`, written
in PyTorch, with every accelerator kernel on the ported path written by hand
in CUDA C++ for Hopper (``sm_90a``). This package never imports ``jax`` or
``rodio_tpu``; the JAX package stays beside it as the reference the port is
held against (``tests/test_torch_*.py``).

Layers (the counterparts of rodio_tpu's modules of the same names):

- :mod:`rodio_tpu_torch.core`        — sample model, precise math, Node
- :mod:`rodio_tpu_torch.sources`     — SamplesBuffer
- :mod:`rodio_tpu_torch.conversions` — the rational lerp resampler
- :mod:`rodio_tpu_torch.effects`     — BltFilter, Amplify, Limit
- :mod:`rodio_tpu_torch.parallel`    — WideMixer
- :mod:`rodio_tpu_torch.ops`         — plain scans, the CUDA kernels
  (K1 fused, K3 limiter, K4 biquad) and their build
- :mod:`rodio_tpu_torch.graph`       — render / render_blocks / record
- :mod:`rodio_tpu_torch.flagship`    — FusedWidePipeline, make_flagship
- :mod:`rodio_tpu_torch.convert`     — carry a JAX render's state across
"""

from .core.types import StreamSpec
from .flagship import FusedWidePipeline, make_flagship
from .graph.render import record, render, render_blocks
from .utils.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "FusedWidePipeline",
    "StreamSpec",
    "make_flagship",
    "record",
    "render",
    "render_blocks",
    "resolve_device",
]
