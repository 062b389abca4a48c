"""The io layer (rodio_tpu/io): decoders, WAV out, streaming ingest,
device sinks and the microphone.

Host-only code (the codecs' bindings, the WAV codec, sample conversion,
the host uniformizer, the OS backends) is the JAX package's, copied; the
device side (``Decoder``'s buffer, ``LoopedDecoder``, ``PushPort``,
``DeviceFeeder``, the sinks' mixer) runs on the card unless
``device="cpu"``. The C++ libraries build at first use under ``build/``
(:mod:`rodio_tpu_torch.io.native`).
"""
from .wav import read_wav, wav_to_file, write_wav
from .decoder import Decoder, DecoderBuilder, DecoderError, LoopedDecoder, Settings
from .native import SpscRing, flac_decode
from .device import (
    CallbackDevice,
    DeviceConfig,
    DeviceSinkBuilder,
    FileDevice,
    MixerDeviceSink,
    NullDevice,
    play,
)
from .microphone import Microphone, MicrophoneBuilder, MicrophoneConfig
from .sample_convert import from_f32, to_f32
from .streaming import DeviceFeeder, StreamingFeed, StreamingWav
