"""SpatialPlayer, positional playback control
(rodio_tpu/control/spatial_player.py, src/spatial_player.rs): a Player
whose sounds pass through a Spatial stage, repositioned at block
boundaries (the reference's 10 ms periodic repositioning,
src/spatial_player.rs:59-78).
"""
from __future__ import annotations

import torch

from ..core.node import Node
from ..effects.basic import Spatial, spatial_volumes
from .mixer import Mixer
from .player import Player, _QueueNode


class SpatialPlayer(Player):
    def __init__(self, mixer_handle: Mixer, emitter_position, left_ear, right_ear,
                 *, block_frames: int = 512):
        super().__init__(mixer_handle, block_frames=block_frames)
        self._emitter = list(emitter_position)
        self._left_ear = list(left_ear)
        self._right_ear = list(right_ear)

    @classmethod
    def connect_new(cls, mixer_handle: Mixer, emitter_position=(0, 0, 0),
                    left_ear=(-1, 0, 0), right_ear=(1, 0, 0), **kw):
        player = cls(mixer_handle, emitter_position, left_ear, right_ear, **kw)
        mixer_handle.add(_QueueNode(player.queue_rx, mixer_handle.spec))
        return player

    def append(self, node: Node) -> None:
        super().append(Spatial(node, self._emitter, self._left_ear, self._right_ear))

    def set_emitter_position(self, pos) -> None:
        self._emitter = list(pos)
        self._reposition()

    def set_left_ear_position(self, pos) -> None:
        self._left_ear = list(pos)
        self._reposition()

    def set_right_ear_position(self, pos) -> None:
        self._right_ear = list(pos)
        self._reposition()

    def _reposition(self) -> None:
        """Set the live Spatial stage's volumes (from the next block)."""
        cur = self.queue_rx.current
        if cur is None:
            return
        target = _find_volumes(cur["state"])
        if target is not None:
            lvol, rvol = spatial_volumes(self._emitter, self._left_ear, self._right_ear)
            vols = target["volumes"]
            target["volumes"] = torch.tensor([float(lvol), float(rvol)], dtype=vols.dtype,
                                             device=vols.device)


def _find_volumes(state):
    """The ChannelVolume sub-state (the dict holding "volumes")."""
    if isinstance(state, dict):
        if "volumes" in state:
            return state
        children = state.values()
    elif isinstance(state, (list, tuple)):
        children = state
    else:
        return None
    for v in children:
        found = _find_volumes(v)
        if found is not None:
            return found
    return None
