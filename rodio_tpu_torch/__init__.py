"""rodio_tpu_torch — the PyTorch/CUDA port of rodio_tpu.

The same block-engine node protocol and numerics as :mod:`rodio_tpu`, written
in PyTorch, with every accelerator kernel on the ported path written by hand
in CUDA C++ for Hopper (``sm_90a``). This package never imports ``jax`` or
``rodio_tpu``; the JAX package stays beside it as the reference the port is
held against (``tests/test_torch_*.py``).

Layers (the counterparts of rodio_tpu's modules of the same names):

- :mod:`rodio_tpu_torch.core`        — sample model, precise math, Node
  and its combinators, ``tree_select``, the error taxonomy
- :mod:`rodio_tpu_torch.sources`     — SamplesBuffer, SignalGenerator and
  its waves (SineWave, SquareWave, TriangleWave, SawtoothWave), Chirp,
  Zero, Empty
- :mod:`rodio_tpu_torch.conversions` — Resample (its weight form, lerp
  form with spans, and streaming ring), RechannelNode, Uniform,
  Bf16Boundary
- :mod:`rodio_tpu_torch.effects`     — BltFilter, Amplify, Limit,
  AutomaticGainControl, Distortion, LinearGainRamp, TakeDuration,
  SkipDuration, Delay, Speed, ChannelVolume, Spatial, Pausable,
  Stoppable, Skippable, TrackPosition, Repeat, Mix
- :mod:`rodio_tpu_torch.parallel`    — WideMixer
- :mod:`rodio_tpu_torch.ops`         — plain scans, the CUDA kernels
  (K1 fused, K2 fused AGC and K2g its group branch, K3 limiter, K4
  biquad and its bf16 instance, K5 limiter envelopes, K6 AGC loop, K7
  first-order scan, K8 blocked max-affine, the generators' phase
  accumulator) and their build
- :mod:`rodio_tpu_torch.graph`       — render / render_blocks / record
- :mod:`rodio_tpu_torch.flagship`    — FusedWidePipeline, make_flagship,
  make_per_stream_chain
- :mod:`rodio_tpu_torch.convert`     — carry a JAX render's state across
- :mod:`rodio_tpu_torch.benches`     — K9, the streaming-read probe of
  K1's input, and the dependent-op latency probe (chain floors)

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; without a card they raise.
"""

from .core.types import StreamSpec
from .effects import AgcSettings, AutomaticGainControl
from .flagship import FusedWidePipeline, make_flagship, make_per_stream_chain
from .graph.render import record, render, render_blocks
from .utils.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "AgcSettings",
    "AutomaticGainControl",
    "FusedWidePipeline",
    "StreamSpec",
    "make_flagship",
    "make_per_stream_chain",
    "record",
    "render",
    "render_blocks",
    "resolve_device",
]
