"""Generic seek (rodio_tpu/graph/seek.py).

The reference threads try_seek through every wrapper down to the decoder
(src/source/mod.rs:754-809), and every stateful wrapper keeps its running
state across the jump. Here ``seek_state`` rebuilds the chain's state with
the SOURCE repositioned through its O(1) ``seek_state`` (buffers,
generators) and then replays only a short ``pre_roll`` window through the
chain, so the recurrences and rings hold the audio just before the target.
The cost is O(pre_roll), whatever the target. A source without an O(1)
seek is replayed from its start.

Seeking is host control: the replay reads each block's ``valid`` back to
stop at the stream's end.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from ..core.node import Node

_log = logging.getLogger("rodio_tpu_torch.seek")


def _innermost(node: Node):
    """(wrapper chain outer->inner, source node) via .input links."""
    chain = []
    cur = node
    while hasattr(cur, "input"):
        chain.append(cur)
        cur = cur.input
    return chain, cur


def _source_seconds(chain, seconds: float) -> float:
    """Map output seconds to source seconds through the rate-changing
    wrappers (the reference's per-wrapper try_seek scaling, e.g.
    src/source/speed.rs:141-144). VariSpeed's live ratio is a state field
    its ``ratio0`` does not follow; a caller that changed it passes it to
    ``seek_state(varispeed_ratio=...)``."""
    from ..conversions.varispeed import VariSpeed
    from ..effects.basic import Speed

    for w in chain:
        if isinstance(w, Speed):
            seconds *= w.factor
        elif isinstance(w, VariSpeed):
            seconds *= w.ratio0
    return seconds


def _chain_pre_roll(chain, default: float = 0.25, cap: float = 60.0) -> float:
    """The pre-roll scaled to the chain's slowest time constant: each
    stateful wrapper asks for 10 of its attack/release times (an
    exponential envelope settles to e^-10 of its gap), at least ``default``
    and at most ``cap`` seconds."""
    pre = default
    for w in chain:
        s = getattr(w, "settings", None)
        for attr in ("attack_time", "release_time",  # AGC (agc.rs)
                     "attack", "release"):           # Limit (limit.rs)
            v = getattr(s, attr, None)
            if isinstance(v, (int, float)) and v > 0:
                pre = max(pre, 10.0 * float(v))
    return min(pre, cap)


def _chain_block_cap(chain, source, step_frames: int) -> int:
    """The largest replay block every node in the chain accepts (ring
    nodes assert n <= max_block)."""
    cap = step_frames
    for w in list(chain) + [source]:
        mb = getattr(w, "max_block", None)
        if isinstance(mb, int) and 0 < mb < cap:
            cap = mb
    return cap


def _unfreeze_controls(state):
    """Release PlayerControl's pause and stop knobs for the replay: a
    paused chain emits silence without consuming its input, so a replay
    through it would never advance the source. The caller puts its live
    knobs back on the returned state (Player.try_seek)."""
    if not isinstance(state, dict):
        return state
    out = {k: _unfreeze_controls(v) for k, v in state.items()}
    if "paused" in out and "stopped" in out:
        for k in ("paused", "stopped"):
            if isinstance(out[k], torch.Tensor):
                out[k] = torch.zeros_like(out[k])
    return out


def _replace_deepest(state, keys, new_sub):
    """Depth-first replace of the deepest dict whose key set equals
    ``keys``; returns (new_state, replaced?)."""
    if not isinstance(state, dict):
        return state, False
    for k, v in state.items():
        nv, done = _replace_deepest(v, keys, new_sub)
        if done:
            return {**state, k: nv}, True
    if set(state.keys()) == keys:
        return new_sub, True
    return state, False


def seek_state(node: Node, seconds: float, *, step_frames: int = 8192,
               pre_roll: Optional[float] = None,
               varispeed_ratio: Optional[float] = None):
    """A state positioned at ``seconds`` (saturating at the end,
    src/source/mod.rs:739-742). O(pre_roll) when the chain's source has an
    O(1) ``seek_state``, O(position) otherwise. ``pre_roll``: the warm-up
    seconds (None: scaled to the chain's slowest attack/release, at least
    0.25 s). ``varispeed_ratio``: the live ratio of a VariSpeed stage in the
    chain, where it changed since the node was built. Raises
    ``SeekNotSupported`` on a live source."""
    rate = node.spec.sample_rate
    target = int(seconds * rate)
    total = node.total_frames()
    if total is not None:
        target = min(target, total)
    if target <= 0:
        return node.init_state()

    chain, source = _innermost(node)
    if pre_roll is None:
        pre_roll = _chain_pre_roll(chain)
    if varispeed_ratio is not None:
        # the live ratio over both the position mapping and the rebuilt
        # state (VariSpeed.init_state takes its ratio from ratio0)
        from ..conversions.varispeed import VariSpeed

        vs_nodes = [w for w in chain if isinstance(w, VariSpeed)]
        saved = [w.ratio0 for w in vs_nodes]
        for w in vs_nodes:
            w.ratio0 = float(varispeed_ratio)
        try:
            return seek_state(node, seconds, step_frames=step_frames, pre_roll=pre_roll)
        finally:
            for w, r in zip(vs_nodes, saved):
                w.ratio0 = r
    step_frames = _chain_block_cap(chain, source, step_frames)
    if getattr(source, "LIVE", False):
        from ..core.errors import SeekNotSupported

        # a live input has no past to seek into (src/source/mod.rs:797-809)
        raise SeekNotSupported(type(source).__name__)
    src_seek = getattr(source, "seek_state", None)
    if src_seek is not None:
        warm = min(int(pre_roll * rate), target)
        src_secs = _source_seconds(chain, (target - warm) / rate)
        try:
            try:
                sub = src_seek(source.init_state(), src_secs)
            except TypeError:
                sub = src_seek(src_secs)  # a generator's stateless signature
            state = node.init_state()
            done = False
            if isinstance(sub, dict):
                state, done = _replace_deepest(state, set(sub.keys()), sub)
            if done:
                return _replay(node, _unfreeze_controls(state), warm, step_frames)
            _log.warning("O(1) seek on %s produced a sub-state not found in the "
                         "chain state; falling back to O(position) full replay",
                         type(source).__name__)
        except Exception:
            _log.warning("O(1) seek on %s raised; falling back to O(position) "
                         "full replay", type(source).__name__, exc_info=True)
    return _replay(node, _unfreeze_controls(node.init_state()), target, step_frames)


#: blocks replayed by the last seek_state call (a seek's cost)
replayed_blocks = 0


def _replay(node: Node, state, frames: int, step_frames: int):
    global replayed_blocks
    replayed_blocks = 0
    if frames <= 0:
        return state
    from .render import compile_step

    step = compile_step(node, step_frames)
    remaining = frames
    while remaining >= step_frames:
        state, _, valid = step(state)
        replayed_blocks += 1
        remaining -= step_frames
        if int(valid) < step_frames:
            return state  # saturated at the stream's end
    if remaining > 0:
        state, _, _ = node.emit(state, int(remaining))
        replayed_blocks += 1
    return state
