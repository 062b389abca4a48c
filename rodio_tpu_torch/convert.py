"""Carry a render's state from the JAX package into the port.

:func:`state_from_jax` takes a port node and the state of the JAX node that
mirrors it, as numpy arrays (``jax.device_get(state)``), and returns the
port's state: biquad coefficients and carries, per-lane gains, the limiter
carries, the AGC's carries, window and knobs, the resampler's output
offset, drain flag and ring, the generators' phases and counters, every
basic effect's counters, flags and delay line, the noise sources' and
Dither's keys, counters and carries, VariSpeed's ring, fill, phase and
ratio, PlayerControl's knobs, the input position (a ``Decoder``'s too, a
``LoopedDecoder``'s with its pre-filled tail) and a ``PushPort``'s buffer,
offsets and flags. A render can then
start in one package and continue in the other. A ``jax.random`` key is
taken as its key data, a uint32 pair: map the JAX state's keys through
``jax.random.key_data`` before passing it. The PCM itself is not copied:
the port node holds its own, made from the same numpy input.

The JAX fused AGC pipeline keeps its lanes channel-major (lane c*512 + s,
rodio_tpu/flagship.py:414-420), packs its per-stream carries as [12, 128]
(rows 0-3 rms_sum, 4-7 peak, 8-11 gain, stream s at (s // 128, s % 128))
and its square history as a ring of grid steps [slots, m*to, 8, 128] (slot =
step mod slots; in group mode [slots, m*to / AG, 8, 128], a group sum per
stream); the port's lanes are 2s + c, its carries [3, S] and its ring
[4096, lanes] by frame mod 4096 ([4096 / AG, S] by group in group mode).
Under the rel0 plans but ``rel0`` both rings hold the packed basis, the
rounded square of channel 0 where channel 0 sits and the rounded sum of
both channels' squares where channel 1 sits, so the same lane map carries
them across; their peak row, which those plans never update, is taken as
it stands.
"""
from __future__ import annotations

import numpy as np
import torch

from .conversions.blockdtype import Bf16Boundary
from .conversions.channels import RechannelNode
from .conversions.resample import Resample
from .conversions.uniform import Uniform
from .conversions.varispeed import VariSpeed
from .control.player import PlayerControl
from .core.node import Node, State
from .effects.agc import AutomaticGainControl
from .effects.basic import (
    Amplify, ChannelVolume, Delay, Distortion, LinearGainRamp, Pausable, Repeat,
    SkipDuration, Skippable, Speed, Stoppable, TakeDuration, TrackPosition)
from .effects.blt import BltFilter
from .effects.dither import Dither
from .effects.limit import Limit
from .effects.mix import Mix
from .flagship import ChunkRingFeed, FusedFarmPipeline, FusedWidePipeline
from .io.decoder import LoopedDecoder
from .io.streaming import PushPort
from .ops.fused import AGC_RING_FRAMES
from .parallel.batch import WideMixer
from .parallel.sharding import ShardedFusedPipeline, ShardedWidePipeline, _BlockFeed
from .sources.generators import Chirp, Empty, SamplesBuffer, SignalGenerator, Zero
from .sources.noise import _NoiseBase

_JAX_LANES = 1024  # the JAX fused kernel's lane count

#: nodes whose state is their input's (under "in") and tensors named as the
#: JAX node names them (TakeDuration's fade pair only with a fade-out)
_PLAIN_STATES = (
    (Resample, ("ring", "base_g", "fill", "out_o", "in_pulled", "in_end", "drained")),
    (SignalGenerator, ("phase",)),
    ((Chirp, Zero), ("i",)),
    (Empty, ()),
    (Distortion, ("gain", "threshold")),
    ((LinearGainRamp, TakeDuration), ("frame", "fade_ms", "fade_r")),
    (Delay, ("buf", "buffered_valid", "ended")),
    (ChannelVolume, ("volumes",)),
    (Pausable, ("paused",)),
    (Stoppable, ("stopped",)),
    (Skippable, ("skipped",)),
    (TrackPosition, ("frames",)),
    (_NoiseBase, ("key", "i", "prev", "prev_white", "prev_blue", "acc")),
    (Dither, ("key", "i", "prev")),
    (VariSpeed, ("ring", "fill", "frac", "ratio", "in_pulled", "in_end", "drained")),
    (PlayerControl, ("volume", "paused", "stopped", "frames")),
    (PushPort, ("buf", "base", "level", "overflow", "underflow", "ended")),
)


def _t(value, node: Node) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.kind == "f":  # f64 arrays (the JAX package under x64) stay f64
        dtype = torch.float64 if arr.dtype == np.float64 else torch.float32
    elif arr.dtype.kind == "b":
        dtype = torch.bool
    else:
        dtype, arr = torch.int64, arr.astype(np.int64)  # a key's uint32 words too
    return torch.as_tensor(arr.copy(), dtype=dtype, device=node.device)


def state_from_jax(node: Node, jstate) -> State:
    """The port's state for ``node``, from the mirroring JAX node's state."""
    if isinstance(node, Limit):
        return {"in": state_from_jax(node.input, jstate["in"]),
                "integ": _t(jstate["integ"], node),
                "peak": _t(jstate["peak"], node)}
    if isinstance(node, WideMixer):
        return state_from_jax(node.input, jstate)
    if isinstance(node, Amplify):
        return {"in": state_from_jax(node.input, jstate["in"]),
                "factor": _t(jstate["factor"], node)}
    if isinstance(node, BltFilter):
        st = {k: _t(jstate[k], node) for k in ("coef", "x1", "x2", "y1", "y2")}
        return {"in": state_from_jax(node.input, jstate["in"]), **st}
    if isinstance(node, (Bf16Boundary, RechannelNode, SkipDuration, Speed)):
        return state_from_jax(node.input, jstate)
    if isinstance(node, Uniform):
        return state_from_jax(node._pipeline, jstate)
    if isinstance(node, Mix):
        return {"a": state_from_jax(node.input1, jstate["a"]),
                "b": state_from_jax(node.input2, jstate["b"])}
    if isinstance(node, Repeat):
        return {"data": node._data, "pos": _t(jstate["pos"], node)}
    if isinstance(node, LoopedDecoder):
        # the node's own PCM with the head copied into its zero tail, as the
        # JAX node's init_state pre-fills it
        return {"data": node._data, "pos": _t(jstate["pos"], node),
                "end": _t(jstate["end"], node)}
    if isinstance(node, SamplesBuffer):
        st = {"pos": _t(jstate["pos"], node), "end": _t(jstate["end"], node)}
        if "data" in jstate:
            st["data"] = node._data
        return st
    for cls, keys in _PLAIN_STATES:
        if isinstance(node, cls):
            st = {k: _t(jstate[k], node) for k in keys if k in jstate}
            if "in" in jstate:
                st["in"] = state_from_jax(node.input, jstate["in"])
            return st
    if isinstance(node, AutomaticGainControl):
        keys = ("peak", "gain", "rms_sum", "window", "widx", "enabled", "att",
                "rel")
        return {"in": state_from_jax(node.input, jstate["in"]),
                **{k: _t(jstate[k], node) for k in keys},
                "consts": node.consts()}
    if isinstance(node, FusedFarmPipeline):
        L = node.input.spec.channels
        return {"in": state_from_jax(node.input, jstate["in"]),
                "out_o": int(jstate["out_o"]),
                "bq": _t(np.stack([np.asarray(b)[:L] for b in jstate["bq"]]), node),
                "coeffs": _t(jstate["coeffs"], node)}
    if isinstance(node, ChunkRingFeed):
        return _ring_from_jax(node, jstate)
    if isinstance(node, _BlockFeed):
        return {}
    if isinstance(node, FusedWidePipeline):
        L = node._wide
        st = node.init_state()  # the port's own PCM layout and gains
        # the JAX kernel pads its lanes to 1024, channel-major under AGC
        lanes = _channel_major(L) if node.with_agc else np.arange(L)
        st.update(
            {"in": state_from_jax(node.input, jstate["in"]),
             "out_o": int(jstate["out_o"]),
             "drained": _t(jstate["drained"], node),
             "bq": _t(np.stack([np.asarray(b)[lanes] for b in jstate["bq"]]),
                      node),
             "coeffs": _t(jstate["coeffs"], node)})
        if "gv" in jstate:  # gain_post layout: the gains ride the state
            st["gains"] = _t(np.asarray(jstate["gv"]).reshape(-1)[:L], node)
        if node.with_agc:
            st.update(_fused_agc_from_jax(node, jstate, st["ring"].dtype))
        return st
    raise NotImplementedError(f"no state conversion for {type(node).__name__}")


def _channel_major(L: int) -> np.ndarray:
    """The JAX fused AGC lane (c*512 + s) of each port lane 2s + c."""
    lane = np.arange(L)
    return (lane % 2) * (_JAX_LANES // 2) + lane // 2


def _fused_agc_from_jax(node: FusedWidePipeline, jstate, ring_dtype) -> State:
    S, L, R = node.n_streams, node._wide, AGC_RING_FRAMES
    agc = np.asarray(jstate["agc"]).reshape(3, _JAX_LANES // 2)[:, :S]
    jring = np.asarray(jstate["ring"]).astype(np.float32)
    slots, rr = jring.shape[:2]  # rr: ring rows per grid step
    jring = jring.reshape(slots, rr, _JAX_LANES)
    o0 = int(jstate["out_o"])
    ag = node._agc_group
    if ag:
        # group mode: a row per group of ag frames, each stream's group sum
        # in both halves of the lanes (the first half taken)
        jring, rows, now = jring[:, :, :S], R // ag, o0 // ag
    else:
        jring, rows, now = jring[:, :, _channel_major(L)], R, o0
    k = np.arange(now - rows, now)
    # unit k (frame or group) of the last window holds its value at slot
    # (k // rr) % slots, row k % rr; units before the stream's start are zero
    ring = np.zeros((rows, jring.shape[2]), np.float32)
    ring[k % rows] = np.where((k >= 0)[:, None], jring[(k // rr) % slots, k % rr], 0.0)
    return {"agc": _t(agc, node),
            "ring": _t(ring, node).to(ring_dtype),
            "agc_par": _t(jstate["agc_par"], node)}


def _ring_from_jax(node: ChunkRingFeed, jstate) -> State:
    """The JAX feed's chunk ring [Nc, pieces, fr_p, 1024] (bf16 pieces,
    summed here in f32) and its carry as the port's frame ring: chunk c's
    fr frames at rows (c*fr + i) mod R for the Nc chunks before w, the
    carry's frames after them. A JAX ring whose gains were folded in at
    push (``gain_post`` False) has them divided out again, which can leave
    a sample an ulp from the raw one."""
    wide, fr, Nc, R = node.spec.channels, node.fr, node.ring_chunks, node.rows
    pieces = np.asarray(jstate["chunks"]).astype(np.float32)
    vals = pieces[:, 0]
    for p in range(1, pieces.shape[1]):
        vals = vals + pieces[:, p]
    w = int(jstate["w"])
    ring = np.zeros((R, wide), np.float32)
    if w:
        for c in range(max(0, w - Nc), w):
            ring[(c * fr + np.arange(fr)) % R] = vals[c % Nc, :fr, :wide]
        ring[(w * fr + np.arange(fr)) % R] = np.asarray(jstate["carry"], np.float32)[:, :wide]
    gain = np.asarray(jstate["gain"], np.float32)[:wide]
    if not node.gain_post:
        ring = ring / gain
    return {"ring": _t(ring, node), "w": w, "overflow": _t(jstate["overflow"], node),
            "ended": _t(jstate["ended"], node), "gain": _t(gain, node)}


def sharded_state_from_jax(pipe, jstate, rank: int = None) -> State:
    """This rank's state of a sharded pipeline (a ShardedFusedPipeline, or
    the ``pipe`` of a ShardedFusedFarm, or a ShardedWidePipeline) from the
    JAX pipeline's: a ShardedFusedPipeline's chain leaves are stacked
    [n_dev, ...] (entry ``rank`` taken), a ShardedWidePipeline's are the
    global chain's state (this rank's rows of each per-stream leaf taken);
    the master limiter's state is replicated. ``rank``: the mesh's by
    default."""
    rank = pipe.mesh.rank if rank is None else rank
    master = state_from_jax(pipe.master, {**jstate["master"], "in": {}})
    master["in"] = {}
    if isinstance(pipe, ShardedFusedPipeline):
        def pick(x):
            if isinstance(x, dict):
                return {k: pick(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(pick(v) for v in x)
            return np.asarray(x)[rank]

        return {"chain": state_from_jax(pipe.template, pick(jstate["chain"])),
                "master": master}
    if isinstance(pipe, ShardedWidePipeline):
        if rank != pipe.mesh.rank:
            raise ValueError("a ShardedWidePipeline converts its own rank's state")
        return {"chain": pipe.local_state(state_from_jax(pipe.global_chain, jstate["chain"])),
                "master": master}
    raise NotImplementedError(f"no sharded state conversion for {type(pipe).__name__}")
