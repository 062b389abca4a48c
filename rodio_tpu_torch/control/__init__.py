"""The control plane: mixer, queue, Player and SpatialPlayer
(rodio_tpu/control)."""
from .mixer import Mixer, MixerSource, mixer
from .player import Player, PlayerControl
from .queue import SourcesQueueInput, SourcesQueueOutput, queue
from .spatial_player import SpatialPlayer

__all__ = ["Mixer", "MixerSource", "Player", "PlayerControl", "SourcesQueueInput",
           "SourcesQueueOutput", "SpatialPlayer", "mixer", "queue"]
