"""rodio_tpu_torch — the PyTorch/CUDA port of rodio_tpu.

The same block-engine node protocol and numerics as :mod:`rodio_tpu`, written
in PyTorch, with every accelerator kernel on the ported path written by hand
in CUDA C++ for Hopper (``sm_90a``). This package never imports ``jax`` or
``rodio_tpu``; the JAX package stays beside it as the reference the port is
held against (``tests/test_torch_*.py``).

Layers (the counterparts of rodio_tpu's modules of the same names):

- :mod:`rodio_tpu_torch.core`        — sample model (f32, or f64 after
  ``set_float64(True)``), precise math, Node
  and its combinators, ``tree_select``, the error taxonomy
- :mod:`rodio_tpu_torch.sources`     — SamplesBuffer, SignalGenerator and
  its waves (SineWave, SquareWave, TriangleWave, SawtoothWave), Chirp,
  Zero, Empty, the noise family (WhiteUniform, WhiteTriangular,
  WhiteGaussian, Velvet, Pink, Blue, Violet, Brownian, Red), Buffered,
  from_iter, from_factory, EmptyCallback
- :mod:`rodio_tpu_torch.conversions` — Resample (its weight form, lerp
  form with spans, and streaming ring), RechannelNode, Uniform,
  Bf16Boundary, VariSpeed
- :mod:`rodio_tpu_torch.effects`     — BltFilter, Amplify, Limit,
  AutomaticGainControl, Distortion, LinearGainRamp, TakeDuration,
  SkipDuration, Delay, Speed, ChannelVolume, Spatial, Pausable,
  Stoppable, Skippable, TrackPosition, Repeat, Mix, Dither
- :mod:`rodio_tpu_torch.control`     — mixer, queue, Player,
  SpatialPlayer: the host-driven control plane
- :mod:`rodio_tpu_torch.parallel`    — WideMixer, stream batches
  (stack_states, BatchedChain, BatchedMixer, batched_buffers), the stream
  farm (HostDecodePool, StreamFarm), the stream axis over the ranks of a
  torch.distributed group (stream_mesh, hybrid_stream_mesh, the sharded
  mixer, batch and pipelines) and the sharded farm
- :mod:`rodio_tpu_torch.ops`         — plain and associative scans
  (``mode="parallel"``), the CUDA kernels (K1 fused and its ring mode, K2
  fused AGC and K2g its group branch, K3 limiter, K4 biquad and its bf16
  instance, K5 limiter envelopes, K6 AGC loop, K7 first-order scan, K8
  blocked max-affine, f64 instances of K3, K4, K7 and K8, the generators'
  phase accumulator, threefry for the noise) and their build
- :mod:`rodio_tpu_torch.graph`       — render / render_blocks / record /
  compile_step, seek_state, save_state / load_state
- :mod:`rodio_tpu_torch.flagship`    — FusedWidePipeline, make_flagship,
  make_per_stream_chain, and the farm's ChunkRingFeed and
  FusedFarmPipeline
- :mod:`rodio_tpu_torch.dryrun`      — the multi-card dry run
- :mod:`rodio_tpu_torch.io`          — Decoder, LoopedDecoder, WAV in and
  out, streaming ingest (StreamingWav, StreamingDecoder, PushPort,
  DeviceFeeder, WavStream), device sinks, the microphone, and the host C++ it binds
  (``native/``); ``python -m rodio_tpu_torch`` is its CLI
- :mod:`rodio_tpu_torch.convert`     — carry a JAX render's state across
- :mod:`rodio_tpu_torch.benches`     — K9, the streaming-read probe of
  K1's input, and the dependent-op latency probe (chain floors)

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; without a card they raise.
"""

from .control import Player, SpatialPlayer, mixer, queue
from .core.types import StreamSpec, set_float64
from .effects import AgcSettings, AutomaticGainControl
from .flagship import FusedWidePipeline, make_flagship, make_per_stream_chain
from .graph.checkpoint import load_state, save_state
from .graph.render import compile_step, record, render, render_blocks
from .graph.seek import seek_state
from .utils.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "AgcSettings",
    "AutomaticGainControl",
    "FusedWidePipeline",
    "Player",
    "SpatialPlayer",
    "StreamSpec",
    "compile_step",
    "load_state",
    "make_flagship",
    "make_per_stream_chain",
    "mixer",
    "queue",
    "record",
    "render",
    "render_blocks",
    "resolve_device",
    "save_state",
    "seek_state",
    "set_float64",
]
