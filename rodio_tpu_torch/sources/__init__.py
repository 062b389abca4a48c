"""The port's sources: the counterparts of rodio_tpu.sources."""
from .buffered import Buffered
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
from .noise import (
    Blue,
    Brownian,
    Pink,
    Red,
    Velvet,
    Violet,
    WhiteGaussian,
    WhiteTriangular,
    WhiteUniform,
)
from .concat import EmptyCallback, from_factory, from_iter

__all__ = ["Blue", "Brownian", "Buffered", "Chirp", "Empty", "EmptyCallback", "Pink",
           "Red", "SamplesBuffer", "SawtoothWave", "SignalGenerator", "SineWave",
           "SquareWave", "TriangleWave", "Velvet", "Violet", "WhiteGaussian",
           "WhiteTriangular", "WhiteUniform", "Zero", "from_factory", "from_iter"]
