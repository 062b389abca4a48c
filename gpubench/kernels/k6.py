"""K6 (``csrc/agc.cu``, ``agc_kernel<float>``): the AGC's whole per-sample
loop over each stream's interleaved samples, as the ``AutomaticGainControl``
node runs it with more than 8 streams (``mode="pallas"``).

Bytes: |x| and the squares' difference read once, the gains written once,
f32, at [streams, channels * n], and the three carries of each stream read
and written. Operations: 23 a sample (the peak 4, the window sum 1, the
desired gain 8, the smoother 10). At 512 stereo streams and n = 12800:
157.3 MB, 0.0470 ms. Its chain: each stream's gain smoother steps its 2n
interleaved samples in order. At the configuration's release time 0 the
step is max(0.1, min(des, att*g + (1-att)*des)), 4 dependent operations a
sample, counted as ``kernels/k2.py`` counts K2's: 0.2068 ms at n = 12800,
which bounds it. The kernel's general step, for any release time, takes 5
(0.2586 ms); the share is taken against the floor of the function the cell
computes, not against that step.
"""
from gpubench.kernels.k2 import STEP_OPS

#: the f32 instance in a profiler trace, demangled or not (not K2's
#: ``fused_agc_kernel``, not the f64 instance)
NAME = r"\bagc_kernel<float>|10agc_kernelIfEE"


def bytes_ops(lanes: int, n: int, fr: int, to: int, channels: int):
    streams, m = lanes // channels, channels * n
    return 3 * streams * m * 4 + 2 * 3 * streams * 4, 23 * streams * m


def chain_ops(lanes: int, n: int, fr: int, to: int, channels: int) -> int:
    return STEP_OPS * channels * n
