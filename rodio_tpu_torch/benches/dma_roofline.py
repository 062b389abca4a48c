"""K9: how fast the card streams K1's input (benches/dma_roofline.py).

    python -m rodio_tpu_torch.benches.dma_roofline [--streams 512]
        [--block 12800] [--lanes 8,32] [--depths 2,3,4,6,8,12,16,24,32]
        [--out FILE]

The JAX package's probe times its fused kernel's chunk DMA with the compute
taken out. Here the stream is what the port's K1 reads for one block of
``--block`` output frames of ``--streams`` stereo streams at 44.1 -> 48
kHz: the time-major PCM rows [R, lanes] f32, read by blocks of 8 lanes (K1's
``kBL``, ``csrc/fused_front.cuh``) in tiles of the ~118 input rows a
128-frame tile of K1 reads (:func:`k1_stream`).

- :func:`dma_ring` (kernel ``csrc/dma_roofline.cu``): each tile copied into
  a ring of ``depth`` tiles of shared memory, one row of each landed tile
  summed per lane, in tile order, so the wait is on the value path;
  ``route="tma"`` (K9) keeps the ring full with TMA copies issued by one
  thread, ``route="cp.async"`` copies as K1's two copy warps do (K1 runs it
  at depth 3); :func:`dma_ring_plain` is the same sum in torch (bit-equal).
- :func:`stream_max`: the same bytes as one contiguous stream, swept in 8
  KB pieces by a persistent grid of two blocks an SM, the card's read
  ceiling; :func:`stream_max_plain` its torch version.

The sweep prints GB/s and the bytes each block keeps in flight for every
route, lanes and depth whose ring fits in a block's shared memory, beside
the contiguous stream and ``torch.clone`` of the same buffer (which reads
and writes it), each timed in a CUDA graph of calls that rotate through
copies of the buffer, so that each reads it from memory, not from the L2
cache (:func:`time_ms_cold`). ``utils.trace.counts["rt_dma_ring"]``
counts K9's launches where its wrapper enqueues them: a graph's replays
add none. Without a card the measurement fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import _build

HBM_GBS = 3350.0  # the H100 SXM's memory rate, GB/s
L2_BYTES = 50 << 20  # the H100's L2 cache
SMEM_OPTIN = 232448  # the H100's opt-in shared memory of a block, bytes
SMS = 132  # the H100 SXM's streaming multiprocessors

ROUTES = {"tma": 0, "cp.async": 1}
CP_DEPTHS = (2, 3, 4, 6, 8, 12, 16, 24, 32)  # the cp.async route's instances
MAX_TMA_DEPTH = 64
MAX_BOX_ROWS = 256  # a TMA box's rows: a tile is one box
MAX_LANES = 32  # one consumer warp holds a block's lanes
K1_LANES = 8  # K1's lanes a block (fused_front.cuh kBL)
K1_DEPTH = 3  # K1's PCM buffers (fused_front.cuh kPcmBufs): two tiles ahead
K9_DEPTH = 8  # K9's ring: the depth its row is timed at (the sweep's plateau starts there)
STREAM_BLOCKS = 2 * SMS  # the contiguous stream's persistent grid
STREAM_PIECE = 512  # float4s of one of its copies (8 KB)


def k1_stream(n: int = 12800, fr: int = 147, to: int = 160):
    """(rows, rows per tile) of the PCM that K1 reads for a block of n
    output frames from frame 0: left rows 0 .. (n-1)*fr//to and their right
    neighbours; a 128-frame tile advances 128*fr/to rows."""
    return (n - 1) * fr // to + 2, -(-128 * fr // to)


def ring_bytes(tr: int, lanes: int, depth: int, route: str = "tma") -> int:
    """Shared memory of a block of :func:`dma_ring`: ``depth`` tiles of tr
    rows x lanes f32 (TMA: each slot rounded up to 128 bytes, beside its
    two mbarriers a slot and 128 bytes to align the ring)."""
    if route == "cp.async":
        return depth * tr * lanes * 4
    slot = -(-tr * lanes * 4 // 128) * 128
    return 128 + -(-2 * depth * 8 // 128) * 128 + depth * slot


def check_ring(x: torch.Tensor, tr: int, depth: int, lanes: int, route: str) -> None:
    """Raise ValueError for what :func:`dma_ring`'s kernel does not take:
    x not [R, L] f32 with L % 4 == 0 and its base 16-byte aligned (the TMA
    map's row stride and address), lanes not a multiple of 4 in 4 .. 32,
    tr outside 1 .. 256 (one TMA box a tile), a depth the route lacks, a
    ring beyond a block's opt-in shared memory."""
    if route not in ROUTES:
        raise ValueError(f"dma_ring: route must be one of {sorted(ROUTES)}, got {route!r}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] % 4 or x.shape[1] < 4:
        raise ValueError(f"dma_ring: x must be [R, L], L % 4 == 0; got {tuple(x.shape)}")
    if x.dtype != torch.float32 or x.data_ptr() % 16:
        raise ValueError("dma_ring: x must be f32 with a 16-byte aligned base")
    if lanes % 4 or not 4 <= lanes <= MAX_LANES:
        raise ValueError(f"dma_ring: lanes must be a multiple of 4 in 4 .. {MAX_LANES}, "
                         f"got {lanes}")
    if not 1 <= tr <= MAX_BOX_ROWS:
        raise ValueError(f"dma_ring: tr must be in 1 .. {MAX_BOX_ROWS} (one TMA box a "
                         f"tile), got {tr}")
    if route == "cp.async" and depth not in CP_DEPTHS:
        raise ValueError(f"dma_ring: the cp.async route takes depth {CP_DEPTHS}, got {depth}")
    if not 2 <= depth <= MAX_TMA_DEPTH:
        raise ValueError(f"dma_ring: depth must be in 2 .. {MAX_TMA_DEPTH}, got {depth}")
    if ring_bytes(tr, lanes, depth, route) > SMEM_OPTIN:
        raise ValueError(f"dma_ring: a ring of {depth} tiles of {tr} x {lanes} f32 "
                         f"({ring_bytes(tr, lanes, depth, route)} bytes) exceeds a "
                         f"block's {SMEM_OPTIN} bytes of shared memory")


def dma_ring_plain(x: torch.Tensor, *, tr: int) -> torch.Tensor:
    """The plain version of :func:`dma_ring`: the first row of each tile of
    tr rows, summed in tile order from zero."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], tr):
        acc = acc + x[i]
    return acc


def dma_ring(x: torch.Tensor, *, tr: int, depth: int = K9_DEPTH, lanes: int = K1_LANES,
             route: str = "tma") -> torch.Tensor:
    """x [R, L] f32 read through a ring of ``depth`` tiles of tr rows by
    blocks of ``lanes`` lanes (``route``: "tma" or "cp.async"); returns the
    per-lane sums [L] of each tile's first row. The arguments are checked
    (:func:`check_ring`) before the dispatch, on any device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dma_ring: unsupported device {x.device}")
    check_ring(x, tr, depth, lanes, route)
    if x.device.type == "cpu":
        return dma_ring_plain(x, tr=tr)
    R, L = x.shape
    x = _build.f32_arg("x", x, x.device, (R, L))
    out = torch.empty(L, dtype=torch.float32, device=x.device)
    _build.launch("rt_dma_ring", x.data_ptr(), R, L, tr, depth, lanes,
                  ROUTES[route], out.data_ptr(), device=x.device)
    return out


def stream_max_plain(x: torch.Tensor, *, blocks: int) -> torch.Tensor:
    """The plain version of :func:`stream_max`: x's elements cut into
    pieces of STREAM_PIECE float4s, block b the max of pieces b, b +
    blocks, b + 2 blocks, ... (-inf for a block with none)."""
    flat = x.reshape(-1)
    piece = 4 * STREAM_PIECE
    rounds = -(-flat.numel() // (piece * blocks))
    pad = torch.full((rounds * blocks * piece - flat.numel(),), -float("inf"),
                     dtype=flat.dtype, device=flat.device)
    return torch.cat([flat, pad]).reshape(rounds, blocks, piece).amax((0, 2))


def stream_blocks(x: torch.Tensor) -> int:
    """The contiguous stream's blocks for x: two on each of the H100's 132
    SMs (fewer where x has fewer pieces)."""
    return max(1, min(STREAM_BLOCKS, -(-(x.numel() // 4) // STREAM_PIECE)))


def stream_max(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as one contiguous stream swept by :func:`stream_blocks`
    blocks, each the max of its pieces; returns [blocks]."""
    blocks = stream_blocks(x)
    if x.device.type == "cpu":
        return stream_max_plain(x, blocks=blocks)
    if x.device.type != "cuda":
        raise ValueError(f"stream_max: unsupported device {x.device}")
    if x.numel() % 4 or x.dtype != torch.float32:
        raise ValueError("stream_max: x must be f32 with a multiple of 4 elements")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("stream_max: x's base must be 16-byte aligned")
    out = torch.empty(blocks, dtype=torch.float32, device=x.device)
    _build.launch("rt_stream_max", x.data_ptr(), x.numel() // 4, blocks,
                  out.data_ptr(), device=x.device)
    return out


def graph_ms(call, reps: int, replays: int = 3) -> float:
    """Mean ms per call of ``reps`` calls captured in one CUDA graph: the
    card's time alone, where a call's host time exceeds its kernel's. One
    call runs first on a side stream, outside the graph; the graph is
    replayed once, then timed over ``replays`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            call()
    g.replay()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(replays):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (reps * replays)


def cold_copies(x: torch.Tensor) -> list:
    """x and enough copies of it that together they hold three times the L2
    cache and more (5 for K1's 48.2 MB block)."""
    n = 2 + 3 * L2_BYTES // (x.numel() * x.element_size())
    return [x] + [x.clone() for _ in range(n - 1)]


def rotating(fn, xs):
    """A call of ``fn`` on the next of ``xs`` each time it runs (each
    captured call of a graph keeps its own buffer)."""
    state = {"i": 0}

    def call():
        state["i"] += 1
        return fn(xs[state["i"] % len(xs)])
    return call


def time_ms_cold(fn, x: torch.Tensor, reps: int = 20, copies=None) -> float:
    """Mean ms per call of ``fn(buffer)`` on the card, in a CUDA graph
    (:func:`graph_ms`: one call outside it, ``reps`` captured), the calls
    rotating through ``copies`` of x (default :func:`cold_copies`), so that
    each copy has left the 50 MB L2 cache before it is read again, as K1
    finds its block's rows (not read since the previous block)."""
    return graph_ms(rotating(fn, copies if copies is not None else cold_copies(x)), reps)


def in_flight_bytes(tr: int, lanes: int, depth: int, route: str) -> int:
    """Bytes a block keeps in flight: the TMA ring every slot, K1's route
    depth - 1 tiles."""
    return (depth if route == "tma" else depth - 1) * tr * lanes * 4


def measure(x: torch.Tensor, tr: int, lanes_list, depths) -> dict:
    """GB/s of the ring for each route, lanes and depth that fit, of the
    contiguous stream and of ``clone``, each checked against its plain
    version (0.0), all L2-cold in CUDA graphs."""
    nbytes = x.numel() * 4
    R, L = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    xs = cold_copies(x)
    res = {"bytes": nbytes, "rows": R, "lanes_total": L, "rows_per_tile": tr,
           "copies": len(xs), "sms": sms, "ring": []}
    want = dma_ring_plain(x, tr=tr)
    for route in ROUTES:
        for lanes in lanes_list:
            for d in depths:
                try:
                    check_ring(x, tr, d, lanes, route)
                except ValueError:
                    continue  # a depth the route lacks, or a ring that does not fit
                err = float((dma_ring(x, tr=tr, depth=d, lanes=lanes, route=route)
                             - want).abs().max())
                if err != 0.0:
                    raise AssertionError(f"dma_ring {route} lanes {lanes} depth {d}: "
                                         f"max|d| {err} against the plain sum")
                ms = time_ms_cold(lambda t: dma_ring(t, tr=tr, depth=d, lanes=lanes,
                                                     route=route), x, copies=xs)
                blocks = -(-L // lanes)
                res["ring"].append({
                    "route": route, "lanes": lanes, "depth": d, "ms": ms,
                    "GB_s": nbytes / ms / 1e6, "blocks": blocks,
                    "in_flight_per_block": in_flight_bytes(tr, lanes, d, route),
                    "sms_used": min(blocks, sms)})
    if not torch.equal(stream_max(x), stream_max_plain(x, blocks=stream_blocks(x))):
        raise AssertionError("stream_max disagrees with its plain version")
    ms = time_ms_cold(stream_max, x, copies=xs)
    res["stream"] = {"ms": ms, "GB_s": nbytes / ms / 1e6, "blocks": stream_blocks(x)}
    ms = time_ms_cold(torch.clone, x, copies=xs)
    res["clone"] = {"ms": ms, "GB_s_read": nbytes / ms / 1e6,
                    "GB_s_moved": 2 * nbytes / ms / 1e6}
    res["hbm_GB_s"] = HBM_GBS
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--block", type=int, default=12800)
    ap.add_argument("--lanes", default="8,32")
    ap.add_argument("--depths", default="2,3,4,6,8,12,16,24,32")
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
    res = {"device": smi, **measure(x, tr, [int(v) for v in args.lanes.split(",")],
                                    [int(d) for d in args.depths.split(",")])}
    for r in res["ring"]:
        print(f"{r['route']:8s} lanes {r['lanes']:2d} depth {r['depth']:2d}: "
              f"{r['ms']:.5f} ms, {r['GB_s']:.1f} GB/s, {r['in_flight_per_block']} B in "
              f"flight a block on {r['sms_used']} SMs", flush=True)
    print(f"contiguous stream: {res['stream']['ms']:.5f} ms, {res['stream']['GB_s']:.1f} "
          f"GB/s; clone {res['clone']['ms']:.5f} ms, {res['clone']['GB_s_read']:.1f} GB/s "
          f"read, {res['clone']['GB_s_moved']:.1f} GB/s moved [{smi}]", flush=True)
    text = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
