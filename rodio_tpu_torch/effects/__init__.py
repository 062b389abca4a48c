"""The port's effects: the counterparts of rodio_tpu.effects' nodes."""
from .agc import AgcSettings, AutomaticGainControl
from .basic import Amplify
from .blt import BltFilter
from .limit import Limit, LimitSettings

__all__ = ["AgcSettings", "Amplify", "AutomaticGainControl", "BltFilter",
           "Limit", "LimitSettings"]
