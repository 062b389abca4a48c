"""The port's sources: the counterparts of rodio_tpu.sources' generators."""
from .generators import (
    Chirp,
    Empty,
    SamplesBuffer,
    SawtoothWave,
    SignalGenerator,
    SineWave,
    SquareWave,
    TriangleWave,
    Zero,
)

__all__ = ["Chirp", "Empty", "SamplesBuffer", "SawtoothWave", "SignalGenerator",
           "SineWave", "SquareWave", "TriangleWave", "Zero"]
