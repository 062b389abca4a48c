"""The resampler's weight form over a buffer's PCM (``csrc/resample_lerp.cu``,
``resample_lerp_kernel<float>``): each output frame's two taps, the lerp, the
drain frame and the mask of a block in one pass, as ``Resample`` runs it
over a ``SamplesBuffer`` on the card.

Bytes: the frames each lane's taps span, ``(n - 1) * from // to + 2`` (the
least a block reads: from the left tap of its first frame to the right tap
of its last, at a block that starts on a whole period of the ratio, as the
cell's do), read once, and the block [lanes, n] written once, f32.
Operations: 3 a sample (two products and a sum). At 1024 lanes, n = 12800
and 44.1 -> 48 kHz (from 147, to 160): 11,761 frames a lane, 48.2 MB read
and 52.4 MB written, 100.6 MB, 0.0300 ms. No serial chain.
"""

#: the f32 instance in a profiler trace, demangled or not (not the f64
#: instance)
NAME = r"\bresample_lerp_kernel<float>|20resample_lerp_kernelIfEE"


def bytes_ops(lanes: int, n: int, fr: int, to: int, channels: int):
    return lanes * ((n - 1) * fr // to + 2) * 4 + lanes * n * 4, 3 * lanes * n


def chain_ops(lanes: int, n: int, fr: int, to: int, channels: int) -> int:
    return 0
