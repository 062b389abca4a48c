"""Offline rendering (rodio_tpu/graph/render.py).

``compile_step`` is the one-block step the host-driven control plane
(queue, buffered, seek, player) calls; ``render`` pulls to exhaustion and
reads each block's ``valid`` back to the host; ``render_blocks``, the
counterpart of ``render_scan``, runs a fixed number of blocks with no host
read-back at all (a plain Python loop over ``emit``; capturing it in a
CUDA graph is later work).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import Node, State

DEFAULT_BLOCK = 4096


def compile_step(node: Node, block_frames: int):
    """``state -> node.emit(state, block_frames)``: the counterpart of the
    JAX package's jitted block step. PyTorch runs eagerly, so it is a plain
    closure."""

    def step(state: State):
        return node.emit(state, block_frames)

    return step


def render(node: Node, *, max_frames: Optional[int] = None,
           block_frames: int = DEFAULT_BLOCK) -> np.ndarray:
    """Render a node to a [channels, frames] numpy array.

    Pulls until the stream reports an incomplete block (valid < block) or
    ``max_frames`` is reached. Infinite sources require ``max_frames``.
    """
    total = node.total_frames()
    if total is None and max_frames is None:
        raise ValueError("render() of an unbounded source requires max_frames")
    limit = max_frames if total is None else (
        total if max_frames is None else min(total, max_frames)
    )
    chunks = []
    produced = 0
    state = node.init_state() if limit > 0 else None
    while produced < limit:
        state, block, valid = node.emit(state, block_frames)
        v = int(valid)
        if v > 0:
            chunks.append(block[:, :v].cpu().numpy())
            produced += v
        if v < block_frames:
            break
    if not chunks:
        return np.zeros((node.spec.channels, 0), dtype=np.float32)
    return np.concatenate(chunks, axis=1)[:, :limit]


def render_blocks(node: Node, state: State, n_blocks: int, T: int):
    """Run ``n_blocks`` blocks of ``T`` frames from ``state``.

    Returns (state', out [channels, n_blocks*T] on the node's device,
    valids [n_blocks] int64). Nothing is read back to the host."""
    blocks, valids = [], []
    for _ in range(n_blocks):
        state, block, valid = node.emit(state, T)
        blocks.append(block)
        valids.append(valid)
    out = torch.cat(blocks, dim=1) if blocks else torch.zeros(
        (node.spec.channels, 0), dtype=torch.float32, device=node.device)
    vals = torch.stack(valids) if valids else torch.zeros(
        0, dtype=torch.int64, device=node.device)
    return state, out, vals


def record(node: Node):
    """Materialise a node into a SamplesBuffer on the node's device — the
    analog of ``.buffered()`` / ``.record()`` (src/buffer.rs:62)."""
    from ..sources.generators import SamplesBuffer

    data = render(node)
    return SamplesBuffer(node.spec.channels, node.spec.sample_rate, data,
                         device=node.device)
