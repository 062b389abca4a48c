"""K1's ring mode (``csrc/fused.cu``, ``fused_kernel<true>``): the same
block over the live farm's rolling ring, read modulo its rows. Its bytes,
operations and chain are K1's (``kernels/k1.py``)."""

from gpubench.kernels.k1 import bytes_ops, chain_ops, rows_read  # noqa: F401

NAME = r"fused_kernel<true>|fused_kernelILb1E"
