"""K9: how fast the card streams K1's input (benches/dma_roofline.py).

    python -m rodio_tpu_torch.benches.dma_roofline [--streams 512]
        [--block 12800] [--depths 2,3,4,6] [--out FILE]

The JAX package's probe times its fused kernel's chunk DMA with the compute
taken out. Here the stream is what the port's K1 reads for one block of
``--block`` output frames of ``--streams`` stereo streams at 44.1 -> 48
kHz: the time-major PCM rows [R, lanes] f32, read by blocks of 32 lanes in
tiles of the ~59 input rows a 64-frame tile of K1 reads (csrc/fused.cu).

- :func:`dma_ring` (kernel ``csrc/dma_roofline.cu``): each tile copied by
  ``cp.async`` through a ring of ``depth`` tiles of shared memory, one row
  of each landed tile summed per lane, in tile order, so the wait is on the
  value path; :func:`dma_ring_plain` is the same sum in torch (bit-equal).
- :func:`stream_max`: the same bytes as one contiguous stream over every
  SM, the upper bound of a read; :func:`stream_max_plain` its torch version.

Each prints GB/s against the card's 3.35 TB/s, beside ``torch.clone`` of
the same buffer (which reads and writes it), timed over calls that rotate
through copies of the buffer, so that each reads it from memory, not from
the L2 cache (:func:`time_ms_cold`). ``launches`` counts K9's launches.
Without a card the measurement fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import _build

#: kernel launches made by :func:`dma_ring` (K9)
launches = 0

HBM_GBS = 3350.0  # the H100 SXM's memory rate, GB/s


def k1_stream(n: int = 12800, fr: int = 147, to: int = 160):
    """(rows, rows per tile) of the PCM that K1 reads for a block of n
    output frames from frame 0: left rows 0 .. (n-1)*fr//to and their right
    neighbours; a 64-frame tile advances 64*fr/to rows."""
    return (n - 1) * fr // to + 2, -(-64 * fr // to)


def dma_ring_plain(x: torch.Tensor, *, tr: int) -> torch.Tensor:
    """The plain version of :func:`dma_ring`: the first row of each tile of
    tr rows, summed in tile order from zero."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], tr):
        acc = acc + x[i]
    return acc


def dma_ring(x: torch.Tensor, *, tr: int, depth: int = 4) -> torch.Tensor:
    """x [R, L] f32 read through a cp.async ring of ``depth`` tiles of tr
    rows by blocks of 32 lanes; returns the per-lane sums [L] of each
    tile's first row."""
    if x.device.type == "cpu":
        return dma_ring_plain(x, tr=tr)
    if x.device.type != "cuda":
        raise ValueError(f"dma_ring: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] % 4:
        raise ValueError(f"dma_ring: x must be [R, L], L % 4 == 0; got {tuple(x.shape)}")
    R, L = x.shape
    x = _build.f32_arg("x", x, x.device, (R, L))
    out = torch.empty(L, dtype=torch.float32, device=x.device)
    err = _build.load_library().rt_dma_ring(x.data_ptr(), R, L, tr, depth,
                                            out.data_ptr(),
                                            _build.stream_handle(x.device))
    _build.check(err, "rt_dma_ring")
    global launches
    launches += 1
    return out


def stream_max_plain(x: torch.Tensor, *, blocks: int) -> torch.Tensor:
    """The plain version of :func:`stream_max`: the max of each of
    ``blocks`` contiguous chunks of ceil(n/4 / blocks) float4s (-inf for an
    empty chunk)."""
    flat = x.reshape(-1)
    chunk = -(-(flat.numel() // 4) // blocks) * 4
    pad = torch.full((chunk * blocks - flat.numel(),), -float("inf"),
                     dtype=flat.dtype, device=flat.device)
    return torch.cat([flat, pad]).reshape(blocks, chunk).amax(1)


def stream_blocks(x: torch.Tensor) -> int:
    """The contiguous stream's blocks for x: one per 16 KB (256 threads, 4
    loads of 16 bytes each), as an elementwise kernel reads."""
    return max(1, -(-(x.numel() // 4) // 1024))


def stream_max(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as one contiguous stream read by :func:`stream_blocks`
    blocks, each the max of its contiguous chunk; returns [blocks]."""
    blocks = stream_blocks(x)
    if x.device.type == "cpu":
        return stream_max_plain(x, blocks=blocks)
    if x.device.type != "cuda":
        raise ValueError(f"stream_max: unsupported device {x.device}")
    if x.numel() % 4 or x.dtype != torch.float32:
        raise ValueError("stream_max: x must be f32 with a multiple of 4 elements")
    x = x.contiguous()
    out = torch.empty(blocks, dtype=torch.float32, device=x.device)
    err = _build.load_library().rt_stream_max(x.data_ptr(), x.numel() // 4,
                                              blocks, out.data_ptr(),
                                              _build.stream_handle(x.device))
    _build.check(err, "rt_stream_max")
    return out


def time_ms_cold(fn, x: torch.Tensor, reps: int = 20) -> float:
    """Mean ms per call of ``fn(buffer)`` on the card: ``reps`` calls in a
    row between two CUDA events, rotating through copies of x, enough that
    each copy has left the 50 MB L2 cache before it is read again, as K1
    finds its block's rows (not read since the previous block)."""
    n = 2 + (150 << 20) // (x.numel() * x.element_size())
    xs = [x] + [x.clone() for _ in range(n - 1)]
    fn(xs[0])
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for i in range(reps):
        fn(xs[i % n])
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def measure(x: torch.Tensor, tr: int, depths) -> dict:
    """GB/s of the ring at each depth, of the contiguous stream and of
    ``clone``, each checked against its plain version (0.0)."""
    nbytes = x.numel() * 4
    res = {"bytes": nbytes, "rows": x.shape[0], "lanes": x.shape[1],
           "rows_per_tile": tr, "ring": {}}
    for d in depths:
        err = float((dma_ring(x, tr=tr, depth=d) - dma_ring_plain(x, tr=tr)).abs().max())
        if err != 0.0:
            raise AssertionError(f"dma_ring depth {d}: max|d| {err} against the plain sum")
        ms = time_ms_cold(lambda t: dma_ring(t, tr=tr, depth=d), x)
        res["ring"][str(d)] = {"ms": ms, "GB_s": nbytes / ms / 1e6}
    if not torch.equal(stream_max(x), stream_max_plain(x, blocks=stream_blocks(x))):
        raise AssertionError("stream_max disagrees with its plain version")
    ms = time_ms_cold(stream_max, x)
    res["stream"] = {"ms": ms, "GB_s": nbytes / ms / 1e6}
    ms = time_ms_cold(torch.clone, x)
    res["clone"] = {"ms": ms, "GB_s_read": nbytes / ms / 1e6,
                    "GB_s_moved": 2 * nbytes / ms / 1e6}
    res["hbm_GB_s"] = HBM_GBS
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--block", type=int, default=12800)
    ap.add_argument("--depths", default="2,3,4,6")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dma_roofline: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rows, tr = k1_stream(args.block)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn((rows, 2 * args.streams), generator=gen, device="cuda")
    res = {"device": smi, **measure(x, tr, [int(d) for d in args.depths.split(",")])}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
