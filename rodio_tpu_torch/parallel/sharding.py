"""Scale-out of the stream axis over several cards (rodio_tpu/parallel/sharding.py).

Per-stream DSP is embarrassingly parallel, so the streams split across the
ranks of a ``torch.distributed`` group, one process a card (NCCL on the
card, gloo on the CPU): rank r holds streams [r*S/n, (r+1)*S/n), runs its
local chain, and the only collective is the sum of the [C, T] partial mix
(the cross-card analog of src/mixer.rs:185-198), after which the master
limiter runs on every rank on the replicated mix. One host thread a card
is the point: every path of the port is host-bound, so one process
enqueuing for several cards would divide each card's pace.

Shard-varying content (PCM, gains, offsets, coefficients a rank chose)
lives in each rank's state; :class:`ShardedWidePipeline` slices the
global chain's state by rank and runs it through a template built for
S/n streams, so a value kept on a node would apply the template's content
on every rank.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import torch
import torch.distributed as dist

from ..core.node import State
from ..core.types import StreamSpec
from .batch import BatchedChain, _tree_map


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class StreamMesh:
    """The stream axis over the ranks of a process group. ``shape`` names
    its axes as the JAX meshes do: {"streams": n}, or {"dcn": hosts,
    "streams": per host} for :func:`hybrid_stream_mesh`. Without an
    initialised default group it is a group of one and no collective runs
    (in an initialised group of one, NCCL's or gloo's, they do).

    ``device``: where this rank's collectives' tensors live (the card for
    NCCL, the CPU for gloo)."""

    def __init__(self, group=None, *, n_hosts: int = 1, intra=None, cross=None,
                 hybrid: bool = False, device=None):
        self.group = group
        self.distributed = _initialized()
        self.size = dist.get_world_size(group) if self.distributed else 1
        self.rank = dist.get_rank(group) if self.distributed else 0
        if self.size % n_hosts:
            raise ValueError(f"{self.size} ranks not divisible by {n_hosts} hosts")
        self.n_hosts = n_hosts
        self.per_host = self.size // n_hosts
        self.shape = ({"dcn": n_hosts, "streams": self.per_host}
                      if hybrid or intra is not None else {"streams": self.size})
        self._intra, self._cross = intra, cross
        if device is None:
            backend = dist.get_backend(group) if self.distributed else "gloo"
            device = (torch.device("cuda", torch.cuda.current_device())
                      if backend == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if not self.distributed:  # a group of one with no process group
            return t
        out = t.to(self.device).contiguous().clone()
        if self._intra is not None:
            # the hierarchy of the JAX hybrid mesh: the partials reduce
            # within a host first, then one block crosses hosts
            dist.all_reduce(out, op=op, group=self._intra)
            dist.all_reduce(out, op=op, group=self._cross)
        else:
            dist.all_reduce(out, op=op, group=self.group)
        return out.to(t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s value of ``t`` on every rank."""
        if not self.distributed:
            return t
        out = t.to(self.device).contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(self.group, src)
                       if self.group is not None else src, group=self.group)
        return out.to(t.device)

    def agree(self, value: int) -> bool:
        """Whether every rank passed the same int (one MAX and one MIN)."""
        t = torch.full((2,), 0, dtype=torch.int64, device=self.device)
        t[0], t[1] = value, -value
        t = self.all_reduce_max(t)
        return int(t[0]) == value and int(t[1]) == -value

    def streams_of(self, n_streams: int) -> range:
        """This rank's contiguous slice of the stream axis."""
        if n_streams % self.size:
            raise ValueError(f"{n_streams} streams not divisible by {self.size} ranks")
        s = n_streams // self.size
        return range(self.rank * s, (self.rank + 1) * s)


def stream_mesh(group=None, *, device=None) -> StreamMesh:
    """A 1-D stream mesh over the default group (or ``group``): a group of
    one when no group is initialised, which runs in one process with no
    launcher."""
    return StreamMesh(group, device=device)


def hybrid_stream_mesh(n_hosts: int, *, device=None) -> StreamMesh:
    """A 2-D mesh for multi-host farms: the ranks laid out [n_hosts,
    per_host] (rank = host * per_host + local), an intra-host group per
    host and a cross-host group per local index. The streams shard over
    both axes; the mix reduces within the host first, then across hosts,
    so one [C, T] block a step crosses hosts (the JAX docstring's
    hierarchy, rodio_tpu/parallel/sharding.py:33-65). Every rank calls
    this, in the same order (``new_group`` is collective)."""
    if not _initialized():
        if n_hosts != 1:
            raise ValueError(f"a group of one cannot span {n_hosts} hosts")
        return StreamMesh(n_hosts=1, hybrid=True, device=device)
    world = dist.get_world_size()
    if world % n_hosts:
        raise ValueError(f"{world} ranks not divisible by {n_hosts} hosts")
    per = world // n_hosts
    rank = dist.get_rank()
    intra = cross = None
    for h in range(n_hosts):
        g = dist.new_group(list(range(h * per, (h + 1) * per)))
        if rank // per == h:
            intra = g
    for j in range(per):
        g = dist.new_group(list(range(j, world, per)))
        if rank % per == j:
            cross = g
    return StreamMesh(n_hosts=n_hosts, intra=intra, cross=cross, device=device)


def shard_batched_state(state: State, mesh: StreamMesh) -> State:
    """Rank r's slice of a stacked per-stream state: every tensor leaf's
    dim 0 split evenly over the ranks."""
    def take(x):
        if not isinstance(x, torch.Tensor):
            return x
        rows = mesh.streams_of(x.shape[0])
        return x[rows.start:rows.stop]

    return _tree_map(take, state)


def _signature(state) -> int:
    """A hash of a state's structure: keys, leaf shapes and dtypes."""
    parts = []

    def visit(x):
        parts.append(repr((tuple(x.shape), str(x.dtype))) if isinstance(x, torch.Tensor)
                     else type(x).__name__)
        return x

    _tree_map(visit, state)
    keys = repr(_tree_map(lambda x: 0, state))
    return int.from_bytes(hashlib.sha1((keys + "".join(parts)).encode()).digest()[:7], "big")


class ShardedMixer:
    """Each rank emits its streams of a :class:`BatchedChain` (vmapped),
    sums them, and the ranks all-reduce the [C, T] sum; ``valid`` is the
    largest over every stream."""

    def __init__(self, chain: BatchedChain, mesh: StreamMesh):
        self.chain = chain
        self.mesh = mesh
        self.spec = chain.spec

    def total_frames(self) -> Optional[int]:
        return None

    def init_state(self) -> State:
        return shard_batched_state(self.chain.state, self.mesh)

    def emit(self, state: State, n: int):
        st, blocks, valids = self.chain.emit(state, n)
        total = self.mesh.all_reduce_sum(blocks.sum(0))
        return st, total, self.mesh.all_reduce_max(valids.max())


class ShardedBatch:
    """Each rank renders its streams; the outputs [S/n, C, T] stay local
    (no collective)."""

    def __init__(self, chain: BatchedChain, mesh: StreamMesh):
        self.chain = chain
        self.mesh = mesh
        self._steps = {}  # block size -> its step, built once

    def init_state(self) -> State:
        return shard_batched_state(self.chain.state, self.mesh)

    def emit(self, state: State, n: int):
        step = self._steps.get(n)
        if step is None:
            step = self._steps[n] = lambda st: self.chain.emit(st, n)
        return step(state)


class _BlockFeed:
    """A source whose block arrives through its state, so a stateful node
    (the master Limit) can process a block computed elsewhere."""

    def __init__(self, channels: int, sample_rate: int, device):
        self.spec = StreamSpec(channels, sample_rate)
        self.device = torch.device(device)

    def total_frames(self):
        return None

    def init_state(self) -> State:
        return {}

    def emit(self, state: State, n: int):
        return {}, state["blk"][:, :n], state["v"]


class _MasterBus:
    """The all-reduce of a rank's partial mix and the master limiter on the
    replicated sum, shared by the sharded pipelines."""

    def _init_master(self, spec, device, settings, mode):
        from ..effects.limit import Limit, LimitSettings

        self.master = Limit(_BlockFeed(spec.channels, spec.sample_rate, device),
                            settings or LimitSettings(), mode=mode)

    def _master_emit(self, state: State, part, valid, n: int):
        mix = self.mesh.all_reduce_sum(part)
        valid = self.mesh.all_reduce_max(valid)
        mst, out, v = self.master.emit({**state["master"], "in": {"blk": mix, "v": valid}}, n)
        return {**mst, "in": {}}, out, v


class ShardedWidePipeline(_MasterBus):
    """The full wide-channel chain sharded over the ranks.

    ``build(n_streams) -> Node`` builds the chain in the wide layout,
    ending in a stream-axis mix ([C, T]), with all per-stream variation in
    its state. Every rank builds the global chain (S streams) for its
    state and a local template (S/n streams); a state leaf whose shape
    differs between the two is per-stream and split by rank on dim 0, the
    rest is replicated. Each block: the local emit, the all-reduce of the
    partial mix, the master limiter (``mode="exact"``, as the JAX
    pipeline's) on every rank."""

    def __init__(self, build, n_streams: int, mesh: StreamMesh, master_settings=None):
        self.mesh = mesh
        n_dev = mesh.size
        if n_streams % n_dev:
            raise ValueError(f"{n_streams} streams not divisible by {n_dev} ranks")
        self.n_streams = n_streams
        self.global_chain = build(n_streams)
        self.local_chain = build(n_streams // n_dev)
        self.spec = self.global_chain.spec
        if self.local_chain.spec.channels != self.spec.channels:
            raise ValueError("the builder must end in a stream-axis mix (output [C, T])")
        self.device = self.local_chain.device
        self._init_master(self.spec, self.device, master_settings, "exact")

    def local_state(self, global_state: State) -> State:
        """This rank's chain state from the global chain's: its rows of each
        per-stream leaf, the rest as it is."""
        rank = self.mesh.rank

        def split(g, l):
            if not isinstance(g, torch.Tensor) or g.shape == l.shape:
                return g
            k = l.shape[0]
            return g[rank * k:(rank + 1) * k].clone()

        return _tree_map(split, global_state, self.local_chain.init_state())

    def init_state(self) -> State:
        return {"chain": self.local_state(self.global_chain.init_state()),
                "master": self.master.init_state()}

    def emit(self, state: State, n: int):
        st, part, valid = self.local_chain.emit(state["chain"], n)
        mst, out, v = self._master_emit(state, part, valid, n)
        return {"chain": st, "master": mst}, out, v


class ShardedFusedPipeline(_MasterBus):
    """The fused pipeline sharded over the ranks: rank r builds its own
    ``build(S/n, r)`` (a FusedWidePipeline, a FusedFarmPipeline, or any
    node whose emit gives that rank's partial [C, T] mix); the ranks'
    pipelines must be structurally identical (checked across ranks), only
    their state's content may differ. Each block: the local fused emit,
    the all-reduce, the master limiter on every rank."""

    def __init__(self, build, n_streams: int, mesh: StreamMesh,
                 master_settings=None, master_mode: str = "auto"):
        self.mesh = mesh
        n_dev = mesh.size
        if n_streams % n_dev:
            raise ValueError(f"{n_streams} streams not divisible by {n_dev} ranks")
        self.n_streams = n_streams
        self.n_dev = n_dev
        self.template = build(n_streams // n_dev, mesh.rank)
        self.spec = self.template.spec
        self.device = self.template.device
        self._init_state = self.template.init_state()
        if not mesh.agree(_signature(self._init_state)):
            raise ValueError("the ranks' pipelines must be structurally identical")
        self._init_master(self.spec, self.device, master_settings, master_mode)

    def init_state(self) -> State:
        chain, self._init_state = self._init_state, None
        if chain is None:
            chain = self.template.init_state()
        return {"chain": chain, "master": self.master.init_state()}

    def _replicate(self, state: State, update: State) -> State:
        """Rank 0's values of ``update`` swapped into every rank's state."""
        chain = dict(state["chain"])
        for k, v in update.items():
            chain[k] = self.mesh.broadcast(v, 0)
        return {**state, "chain": chain}

    def retune(self, state: State, **kw) -> State:
        """Live biquad retune on every rank (src/source/blt.rs:68-91): rank
        0's coefficients broadcast into every state; nothing is rebuilt."""
        one = self.template.retune(state["chain"], **kw)
        return self._replicate(state, {"coeffs": one["coeffs"]})

    def set_agc_params(self, state: State, **kw) -> State:
        if not getattr(self.template, "with_agc", False):
            raise ValueError("set_agc_params needs a pipeline with the AGC")
        one = self.template.set_agc_params(state["chain"], **kw)
        return self._replicate(state, {"agc_par": one["agc_par"]})

    def emit(self, state: State, n: int):
        cs, part, valid = self.template.emit(state["chain"], n)
        mst, out, v = self._master_emit(state, part, valid, n)
        return {"chain": cs, "master": mst}, out, v


