"""Player, the user-facing playback control (rodio_tpu/control/player.py,
src/player.rs).

The reference wraps every appended source in a fixed control stack,
Done(speed -> track_position -> pausable -> amplify -> skippable ->
stoppable), and applies the shared knobs every 5 ms through PeriodicAccess
(src/player.rs:104-170). Here the six wrappers are one node,
:class:`PlayerControl`, whose knobs are state tensors the Player writes
between blocks: at the default block of 256 frames at 48 kHz the control
latency is ~5.3 ms, the reference's cadence.

Live speed: a sound whose speed is not 1 carries a VariSpeed stage whose
ratio is a state field, so ``set_speed`` is a state update (the first
change on a sound built without the stage rebuilds its chain once, at the
same position).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.node import Node, State, tree_select
from ..core.types import StreamSpec
from .mixer import Mixer
from .queue import queue


class PlayerControl(Node):
    """The fused control stack: pause, volume, stop, skip and position in
    one node, with the reference wrappers' semantics:

    - paused -> silence, input frozen (src/source/pausable.rs)
    - stopped or skipped -> the stream ends (stoppable.rs, skippable.rs)
    - volume multiplies the samples (amplify.rs)
    - position counts the frames played (position.rs)
    """

    def __init__(self, input_node: Node, *, initially_paused: bool = False,
                 volume: float = 1.0):
        self.input = input_node
        self.spec = input_node.spec
        self.device = input_node.device
        self.initially_paused = initially_paused
        self.volume = volume

    def total_frames(self) -> Optional[int]:
        return self.input.total_frames()

    def init_state(self) -> State:
        dev = self.device
        return {"in": self.input.init_state(),
                "volume": torch.full((), self.volume, dtype=torch.float32, device=dev),
                "paused": torch.full((), bool(self.initially_paused), device=dev),
                "stopped": torch.zeros((), dtype=torch.bool, device=dev),
                "frames": torch.zeros((), dtype=torch.int64, device=dev)}

    def emit(self, state: State, n: int):
        s2, block, valid = self.input.emit(state["in"], n)
        paused, stopped = state["paused"], state["stopped"]
        frozen = paused | stopped
        out = torch.where(frozen, torch.zeros_like(block), block * state["volume"])
        v = torch.where(stopped, torch.zeros_like(valid),
                        torch.where(paused, torch.full_like(valid, n), valid))
        frames = state["frames"] + torch.where(frozen, torch.zeros_like(valid), valid)
        return ({"in": tree_select(frozen, state["in"], s2), "volume": state["volume"],
                 "paused": paused, "stopped": stopped, "frames": frames}, out, v)


def _set_knobs(state: dict, updates) -> None:
    for k, v in updates:
        if k in state:
            old = state[k]
            state[k] = (torch.full((), v, dtype=old.dtype, device=old.device)
                        if isinstance(old, torch.Tensor) else v)


class Player:
    """Playback facade over a queue and a mixer (src/player.rs:20-362)."""

    def __init__(self, mixer_handle: Mixer, *, block_frames: int = 256):
        self.queue_tx, self.queue_rx = queue(True, block_frames=block_frames,
                                             device=mixer_handle.device)
        self.queue_rx.on_start = self._on_sound_start
        self.block_frames = block_frames
        self._mixer = mixer_handle
        self._volume = 1.0
        self._paused = False
        self._stopped = False
        self._speed = 1.0
        #: skip_one's marks on queued sounds not started yet: the reference's
        #: to_clear, consumed at each sound's first access (src/player.rs:144-151)
        self._pending_clear = 0
        self._signals: List[List[bool]] = []

    @classmethod
    def connect_new(cls, mixer_handle: Mixer, **kw) -> "Player":
        """(src/player.rs:73): a player attached to the mixer."""
        player = cls(mixer_handle, **kw)
        mixer_handle.add(_QueueNode(player.queue_rx, mixer_handle.spec))
        return player

    # append (src/player.rs:104-170)
    def append(self, node: Node, *, on_done=None) -> None:
        """Queue a sound; ``on_done`` fires when it finishes
        (src/source/done.rs)."""
        wrapped = self._wrap(node, self._speed)
        self._signals.append(self.queue_tx.append_with_signal(wrapped, callback=on_done))

    def periodic_access(self, period_seconds: float, fn) -> None:
        """A host hook every ``period_seconds`` of playback
        (src/source/periodic.rs)."""
        self.queue_rx.periodic_access(period_seconds, fn, self._mixer.spec.sample_rate)

    def _wrap(self, node: Node, speed: float,
              varispeed: Optional[bool] = None) -> PlayerControl:
        from ..conversions.uniform import Uniform
        from ..conversions.varispeed import VariSpeed

        original, vs = node, None
        if varispeed is None:
            varispeed = speed != 1.0
        if varispeed:
            # the live stage is inserted only where the speed changes: its
            # ring pre-buffers upstream audio, which would delay the other
            # live controls; max_block covers the downstream Uniform's pull
            vs = VariSpeed(node, ratio=speed, max_ratio=8.0, max_block=8 * self.block_frames)
            node = vs
        node = Uniform(node, self._mixer.spec.channels, self._mixer.spec.sample_rate)
        wrapped = PlayerControl(node, initially_paused=self._paused, volume=self._volume)
        wrapped.original = original  # for seek and the first speed change
        wrapped.varispeed = vs
        wrapped.speed = speed
        return wrapped

    # knobs
    @staticmethod
    def _control_state(state) -> Optional[dict]:
        """The PlayerControl sub-state inside a chain state (a rate stitch
        wraps the control node in one more Uniform, queue.py)."""
        if not isinstance(state, dict):
            return None
        if "paused" in state and "stopped" in state:
            return state
        for v in state.values():
            found = Player._control_state(v)
            if found is not None:
                return found
        return None

    def _apply(self, **updates):
        cur = self.queue_rx.current
        if cur is None:
            return
        state = self._control_state(cur["state"])
        if state is not None:
            _set_knobs(state, updates.items())

    def _on_sound_start(self, cur: dict) -> None:
        """Land the live knobs on a sound as it starts, as the reference
        applies its shared controls at a sound's first periodic access
        (src/player.rs:138-165)."""
        state = self._control_state(cur["state"])
        if state is not None:
            updates = [("volume", self._volume), ("paused", self._paused)]
            if self._pending_clear > 0:
                # a skip_one issued before this sound started ends it before
                # its first sample (src/player.rs:144-151)
                self._pending_clear -= 1
                cur["skip_marked"] = True
                updates.append(("stopped", True))
            _set_knobs(state, updates)
        if getattr(cur["node"], "speed", self._speed) != self._speed:
            self.set_speed(self._speed)

    def play(self):
        self._paused = False
        self._apply(paused=False)

    def pause(self):
        self._paused = True
        self._apply(paused=True)

    def is_paused(self) -> bool:
        return self._paused

    def set_volume(self, volume: float):
        self._volume = volume
        self._apply(volume=volume)

    def volume(self) -> float:
        return self._volume

    @staticmethod
    def _update_varispeed(state, vs, speed) -> bool:
        """Set the ratio in the VariSpeed sub-state (the dict holding both
        'ratio' and 'ring')."""
        if not isinstance(state, dict):
            return False
        if "ratio" in state and "ring" in state:
            state.update(vs.set_ratio(state, speed))
            return True
        return any(isinstance(v, dict) and Player._update_varispeed(v, vs, speed)
                   for v in state.values())

    def set_speed(self, speed: float):
        """Live speed (src/source/speed.rs:56-65): on a sound with a
        VariSpeed stage a state update that applies from the next block;
        the source keeps its position."""
        self._speed = speed
        cur = self.queue_rx.current
        if cur is None:
            return
        node = cur["node"]
        vs = getattr(node, "varispeed", None)
        if vs is not None and self._update_varispeed(cur["state"], vs, speed):
            node.speed = speed
            return
        # the first change on a chain built without the stage: rebuild it once
        # with the stage, at the same position
        original = getattr(node, "original", None)
        if original is None or getattr(node, "speed", 1.0) == speed:
            return
        from ..graph.render import compile_step
        from ..graph.seek import seek_state

        state = cur["state"]
        pos_secs = 0.0
        if isinstance(state, dict) and "frames" in state:
            pos_secs = float(state["frames"]) / node.spec.sample_rate
        pos_secs = pos_secs * getattr(node, "speed", 1.0) / speed
        wrapped = self._wrap(original, speed, varispeed=True)
        new_state = seek_state(wrapped, pos_secs)
        if isinstance(new_state, dict) and isinstance(state, dict):
            for k in ("volume", "paused", "stopped", "frames"):
                if k in state and k in new_state:
                    new_state[k] = state[k]
        cur.update(node=wrapped, state=new_state, leftover=None, ended=False,
                   step=compile_step(wrapped, self.queue_rx.block_frames))

    def speed(self) -> float:
        return self._speed

    def stop(self):
        self._stopped = True
        self._apply(stopped=True)
        self.queue_tx.clear()
        # dropped sounds never consume their clears: stale marks must not
        # end sounds appended after the stop
        self._pending_clear = 0

    def skip_one(self):
        """End one sound: the current one, or, when it is already marked,
        the next queued sound at its start. A clear is queued only while
        live sounds outnumber pending clears (src/player.rs:299-306)."""
        cur = self.queue_rx.current
        alive = len(self.queue_tx.next_sounds)
        marked = 0
        if cur is not None:
            if cur.get("skip_marked"):
                marked = 1
            else:
                alive += 1
        if alive <= self._pending_clear + marked:
            return  # nothing left to skip
        if cur is not None and not cur.get("skip_marked"):
            cur["skip_marked"] = True
            self._apply(stopped=True)
        else:
            self._pending_clear += 1

    def clear(self):
        """Drop every loaded sound and pause (src/player.rs:283-293)."""
        self.queue_tx.clear()
        self._pending_clear = 0
        self.skip_one()
        self._paused = True

    def get_pos(self) -> float:
        cur = self.queue_rx.current
        if cur is None:
            return 0.0
        state = cur["state"]
        if isinstance(state, dict) and "frames" in state:
            return float(state["frames"]) / cur["node"].spec.sample_rate
        return 0.0

    def try_seek(self, pos: float) -> None:
        """Seek within the current sound: its state is rebuilt at the target
        (O(pre-roll), graph/seek.py), through the live speed, and replaces
        the old one only once it is whole (src/source/mod.rs:797-809)."""
        cur = self.queue_rx.current
        if cur is None:
            return
        node = cur["node"]
        seek = getattr(node, "seek_state", None)
        if seek is None:
            from ..graph.seek import seek_state

            ratio = self._speed if getattr(node, "varispeed", None) is not None else None
            new_state = seek_state(node, pos, varispeed_ratio=ratio)
        else:
            new_state = seek(pos)
        # the live knobs carry over the rebuilt state
        old_state = cur["state"]
        if isinstance(new_state, dict) and isinstance(old_state, dict):
            for k in ("volume", "paused", "stopped"):
                if k in old_state and k in new_state:
                    new_state[k] = old_state[k]
        if isinstance(new_state, dict) and "frames" in new_state:
            # get_pos reports the seek target from here on
            # (src/source/position.rs:136-141)
            target = int(pos * node.spec.sample_rate)
            total = node.total_frames()
            if total is not None:
                target = min(target, total)
            new_state["frames"] = torch.full((), max(target, 0), dtype=torch.int64,
                                             device=node.device)
        cur.update(state=new_state, leftover=None, ended=False)

    def len(self) -> int:
        """The live sound count; a skipped sound leaves it at once
        (src/player.rs:299-306), though it drains a block later."""
        n = len(self.queue_tx.next_sounds)
        cur = self.queue_rx.current
        if cur is not None and not cur.get("skip_marked"):
            n += 1
        return max(0, n - self._pending_clear)

    def empty(self) -> bool:
        return self.len() == 0

    def sleep_until_end(self, *, max_blocks: int = 10 ** 7) -> None:
        """Drain the attached mixer until this player's queue is empty, the
        offline analog of src/player.rs:322."""
        src = self._mixer._source
        for _ in range(max_blocks):
            if self.empty():
                return
            if src is not None:
                _, alive = src.next_block(self.block_frames)
                if not alive:
                    return
            else:
                self.queue_rx.next_block()


class _QueueNode:
    """A host-driven queue output as a mixer member: the mixer sums its
    ``next_block`` beside the other members."""

    def __init__(self, queue_rx, spec: StreamSpec):
        self.queue_rx = queue_rx
        self.spec = spec
        self.device = queue_rx.device

    def total_frames(self) -> Optional[int]:
        return None

    def next_block(self, n: int):
        from ..conversions.channels import rechannel_block

        block, alive = self.queue_rx.next_block(n)
        return rechannel_block(block, block.shape[0], self.spec.channels), alive
