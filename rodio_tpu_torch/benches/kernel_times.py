"""Times of the f32 instances of K4, K3, K7 and K8 on the card, at the
shapes of ``chip_smoke.py``'s phase 3, eagerly (CUDA events over a loop of
calls) and in a CUDA graph (the same calls captured once), and the host's
time to enqueue a call, for the ``rodio_tpu_torch`` of the checkout at
``--root``, built there. It prints one JSON line: ``{"label", "root",
"device", "times": {row: [eager_ms, graph_ms, enqueue_ms]}}``.

    python3 rodio_tpu_torch/benches/kernel_times.py [--root DIR] [--label NAME]

The file imports only the package it is pointed at, so it times another
checkout of the repository as it times this one. To compare two checkouts,
run them on one card in the order A, B, B, A and compare each row's times
across the four runs. The inputs are made from a seed with numpy.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

T = 12800
STREAMS = 512
SEED = 0


def _eager_ms(call, reps: int) -> float:
    """Mean ms a call over ``reps`` calls, after one warm-up call."""
    import torch

    call()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        call()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def _enqueue_ms(call, reps: int) -> float:
    """Mean host ms to enqueue a call (no wait for the card inside the
    loop), after one warm-up call."""
    import time

    import torch

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.getcwd(), help="the checkout to time")
    ap.add_argument("--label", default="", help="a name for the JSON line")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import rodio_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(rodio_tpu_torch.__file__))) != root:
        raise SystemExit(f"kernel_times: imported {rodio_tpu_torch.__file__}, not {root}")
    from rodio_tpu_torch.benches.dma_roofline import graph_ms
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings
    from rodio_tpu_torch.effects.blt import blt_coefficients
    from rodio_tpu_torch.ops import _build, cuda_scan, limiter_block
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    calls = {}
    # K4: the biquad at config 5's [1024, 12800] and path B's [2, 4096]
    coef = f32(blt_coefficients("low_pass", 48000, 2000.0, 0.5).as_tuple())
    for L, n in ((2 * STREAMS, T), (2, 4096)):
        x = f32(rng.standard_normal((L, n)) * 0.1)
        st = tuple(f32(rng.standard_normal(L) * 0.01) for _ in range(4))
        calls[f"K4 [{L}, {n}]"] = (lambda x=x, st=st: cuda_scan.biquad_df1(x, coef, st), 20)
    # K3: the master limiter over [2, 12800], P = 128
    lim = Limit(SamplesBuffer(2, 48000, np.zeros((2, 1), np.float32), device=dev),
                LimitSettings())
    kw = dict(att=lim.attack, rel=lim.release, threshold=lim.threshold,
              knee_width=lim.knee_width, inv_knee_8=lim.inv_knee_8, P=128)
    xm = f32(rng.standard_normal((2, T)) * 0.7)
    i0, p0 = f32([0.5, 1.0]), f32([0.8, 0.3])
    calls[f"K3 [2, {T}]"] = (lambda: limiter_block.limiter_master(xm, i0, p0, **kw), 50)
    # K7: agc_gain at path B's [1, 8192], path B with group=8's [1, 512] and
    # path S's [512, 25600]
    params = f32([0.99999480, 0.99958340, 7.0])
    for L, n, reps in ((1, 8192, 50), (1, 512, 50), (STREAMS, 2 * T, 20)):
        des = f32(rng.uniform(0.5, 7.0, (L, n)))
        g0 = f32(np.ones(L))
        calls[f"K7 agc_gain [{L}, {n}]"] = (
            lambda des=des, g0=g0: cuda_scan.first_order(des, des, g0, op="agc_gain",
                                                         params=params), reps)
    # K8: the peak detector over [1, 8192], P = 128
    x8 = f32(np.abs(rng.standard_normal((1, 8192)) * 0.3))
    v8, a8 = f32([0.4]), params[1]
    calls["K8 [1, 8192]"] = (
        lambda: limiter_block.blocked_max_affine_const(x8, v8, a8, P=128), 50)

    times = {name: [_eager_ms(call, reps), graph_ms(call, reps), _enqueue_ms(call, reps)]
             for name, (call, reps) in calls.items()}
    print(json.dumps({"label": args.label, "root": root,
                      "device": torch.cuda.get_device_name(0), "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
