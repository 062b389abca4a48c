"""K7 (``csrc/first_order.cu``, ``first_order_kernel``) as the AGC's gain
smoother (``op="agc_gain"``) over [1, m] interleaved samples: it reads the
desired gains once and writes the gains once (4 bytes each), ~10
operations a step. At a block of 4096 stereo frames (m = 8192): 65.5 kB,
1.96e-05 ms. Its chain bounds it: the m steps run in order, 5 dependent
operations each, 0.0827 ms at m = 8192."""

NAME = r"first_order_kernel"


def bytes_ops(m: int):
    return 2 * m * 4, 10 * m


def chain_ops(m: int) -> int:
    return 5 * m
