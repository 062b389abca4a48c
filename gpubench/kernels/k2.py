"""K2 (``csrc/fused_agc.cu``, ``fused_agc_kernel<float, 0>``: the serial
plan with an f32 ring of squares): one block of the fused resample +
biquad + per-stream AGC + gain + stream mix.

Bytes: the PCM rows the block's lerp reads, once (as K1's,
``kernels/k1.py``), the left taps (int64) and the two f32 weights of each
output frame, the ring's read and write of one square a lane and frame at
the ring's width, and the [channels, n] mix written once. Operations: 40 a
lane and frame (the lerp 3, the biquad 9, the square, its difference with
the ring's and the window sum 3, the peak 4, the desired gain 8, the
smoother 10, y*g, the gain and the mix 3). At 512 stereo streams and
n = 12800: 153.3 MB, 0.0458 ms. Its chain: each stream's gain smoother
steps its 2n interleaved samples in order. At the configuration's release
time 0 the step is max(0.1, min(des, att*g + (1-att)*des)), 4 dependent
operations a sample (mul, add, min, max: K2r's step): 0.2068 ms at
n = 12800, which bounds it. The serial plan's general step, for any
release time, takes 5 (0.2586 ms); the share is taken against the floor
of the function the cell computes, not against that step.
"""
from gpubench.kernels.k1 import rows_read

#: the serial plan's instance with the f32 ring in a profiler trace,
#: demangled or not (not K2r's plans 1 and 2, K2b's or K2g's kernels)
NAME = r"fused_agc_kernel<float, 0>|fused_agc_kernelIfLi0EE"
#: bytes of one square in the ring
RING_BYTES = 4


def bytes_ops(lanes: int, n: int, fr: int, to: int, channels: int):
    nbytes = (rows_read(n, fr, to) * lanes * 4 + n * (8 + 8)
              + 2 * n * lanes * RING_BYTES + channels * n * 4)
    return nbytes, 40 * lanes * n


#: dependent operations of one smoother step at release time 0
STEP_OPS = 4


def chain_ops(lanes: int, n: int, fr: int, to: int, channels: int) -> int:
    return STEP_OPS * channels * n
