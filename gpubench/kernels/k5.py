"""K5 (``csrc/limiter_env.cu``, ``limiter_kernel<true, float>``): the
``Limit`` node's whole per-stream limiter (``limiter_stream``) in one pass:
each sample's soft-knee gain in dB, the integrator and the peak envelope,
the gain coupled within each stream's channels, and y = x * gain.

Bytes: x [lanes, n] f32 read and y written once, and each lane's two
envelope carries read and written. Operations: 30 a lane and frame (the
gain computer's log2 and knee ~12, the envelopes 6, the coupling 2, the
gain's exp2 and product ~10). At 1024 lanes and n = 12800: 104.9 MB,
0.0313 ms. Its chain: each lane's integrator steps its n frames in order,
integ = max(db, rel*integ + (1-rel)*db) with (1-rel)*db off the chain:
3 dependent operations a frame (the peak follows it, 2 behind), 0.0776 ms
at n = 12800, which bounds it.
"""

#: the f32 ``limiter_stream`` instance in a profiler trace, demangled or not
#: (not ``limiter_env``'s ``limiter_kernel<false, float>``, not K3's
#: ``limiter_master_kernel``, not the f64 instances)
NAME = r"\blimiter_kernel<true, float>|14limiter_kernelILb1EfEE"


def bytes_ops(lanes: int, n: int, fr: int, to: int, channels: int):
    return 2 * lanes * n * 4 + 2 * 2 * lanes * 4, 30 * lanes * n


def chain_ops(lanes: int, n: int, fr: int, to: int, channels: int) -> int:
    return 3 * n
