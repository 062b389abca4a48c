"""The port's effects: the counterparts of rodio_tpu.effects' nodes (all
but Dither)."""
from .agc import AgcSettings, AutomaticGainControl
from .basic import (
    Amplify,
    ChannelVolume,
    Delay,
    Distortion,
    LinearGainRamp,
    Pausable,
    Repeat,
    Skippable,
    SkipDuration,
    Spatial,
    Speed,
    Stoppable,
    TakeDuration,
    TrackPosition,
)
from .blt import BltFilter
from .limit import Limit, LimitSettings
from .mix import Mix

__all__ = ["AgcSettings", "Amplify", "AutomaticGainControl", "BltFilter",
           "ChannelVolume", "Delay", "Distortion", "Limit", "LimitSettings",
           "LinearGainRamp", "Mix", "Pausable", "Repeat", "SkipDuration",
           "Skippable", "Spatial", "Speed", "Stoppable", "TakeDuration",
           "TrackPosition"]
