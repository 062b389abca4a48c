"""K1 (``csrc/fused.cu``, ``fused_kernel<false>``): one block of the fused
resample + gain + biquad + stream mix.

Bytes: the PCM rows the block's lerp reads, once (its left rows 0 ..
(n-1)*fr//to and their right neighbours), the left taps (int64) and the two
f32 weights of each output frame, and the [channels, n] mix written once.
Operations: 14 a lane and frame (the lerp 3, the gain 1, the biquad 9, the
mix 1). At 512 stereo streams and n = 12800: 48.5 MB, 0.0145 ms.
Its chain: each lane's biquad runs its n frames in order, 3 dependent
operations a frame: 0.0776 ms at n = 12800, which bounds it.
"""

#: the kernel's name in a profiler trace, demangled or not
NAME = r"fused_kernel<false>|fused_kernelILb0E"


def rows_read(n: int, fr: int, to: int) -> int:
    return (n - 1) * fr // to + 2


def bytes_ops(lanes: int, n: int, fr: int, to: int, channels: int):
    nbytes = rows_read(n, fr, to) * lanes * 4 + n * (8 + 8) + channels * n * 4
    return nbytes, 14 * lanes * n


def chain_ops(lanes: int, n: int, fr: int, to: int, channels: int) -> int:
    return 3 * n
