"""Start n ranks of a ``torch.distributed`` group as processes on one host.

:func:`spawn_ranks` runs ``fn(rank, *args)`` in n spawned processes, each
joined to a group of n (gloo on the CPU, or NCCL with rank r on card r)
through a file store or a ``tcp://localhost`` address, and returns the
ranks' return values in rank order. A run that has not finished within
``timeout`` seconds kills every rank and raises ``TimeoutError``; a rank
that raises fails the run with its traceback.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Callable, List, Sequence


def _rank_main(fn, rank: int, n: int, backend: str, init_method: str, args, results):
    import torch
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # handed to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, n: int, *, backend: str = "gloo", init_method: str,
                args: Sequence = (), timeout: float = 60.0) -> List:
    """The return values of ``fn(rank, *args)`` on ranks 0 .. n-1. ``fn``
    must be importable by name from a fresh interpreter (a module-level
    function)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, backend, init_method, tuple(args), results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n} ranks did not finish within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.pid for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank processes {dead} died") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            if p.is_alive():
                p.join(timeout=2.0 if len(got) == n else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(n)]
