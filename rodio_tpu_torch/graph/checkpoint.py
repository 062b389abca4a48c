"""Checkpoint and resume of block-engine states
(rodio_tpu/graph/checkpoint.py).

A graph's whole playback position is its state, so a checkpoint is the
state saved: resume by building the same graph again and loading the state
into it, exactly at the saved block, every filter tail, envelope, ring and
phase included.

The port's states are nested dicts (and lists) of tensors and host
scalars. ``save_state`` writes their leaves to an ``.npz`` in a fixed order
(dict keys sorted) beside a structure signature of its own: the nesting,
keys and leaf kinds. ``load_state`` refuses a checkpoint whose signature,
leaf count or leaf shapes differ from the state of the graph it loads into
(``like``), and puts each leaf on that state's device with its dtype.
"""
from __future__ import annotations

import json
from typing import Any, List

import numpy as np
import torch


def _signature(state: Any):
    """The structure of a state: keys and nesting, and each leaf's kind."""
    if isinstance(state, dict):
        return {str(k): _signature(state[k]) for k in sorted(state)}
    if isinstance(state, (list, tuple)):
        return [type(state).__name__, [_signature(v) for v in state]]
    if isinstance(state, torch.Tensor):
        return "tensor"
    if isinstance(state, (bool, int, float, np.generic)):
        return type(state).__name__
    raise TypeError(f"unsupported state leaf {type(state).__name__}")


def _leaves(state: Any, out: List[Any]) -> List[Any]:
    if isinstance(state, dict):
        for k in sorted(state):
            _leaves(state[k], out)
    elif isinstance(state, (list, tuple)):
        for v in state:
            _leaves(v, out)
    else:
        out.append(state)
    return out


def _rebuild(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_state(path: str, state: Any, *, metadata: dict = None) -> None:
    """Save a state to an ``.npz`` with its structure signature."""
    leaves = _leaves(state, [])
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(json.dumps({
        "treedef": json.dumps(_signature(state), sort_keys=True),
        "n_leaves": len(leaves),
        "metadata": metadata or {},
    }).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, like: Any) -> Any:
    """Load a state saved by :func:`save_state` into the structure of
    ``like`` (the freshly initialised state of the same graph), on its
    device."""
    data = np.load(path)
    meta = json.loads(bytes(data["__treedef__"]).decode())
    like_leaves = _leaves(like, [])
    n = meta["n_leaves"]
    if n != len(like_leaves):
        raise ValueError(f"checkpoint has {n} leaves; graph state has "
                         f"{len(like_leaves)} (graph structure changed?)")
    sig = json.dumps(_signature(like), sort_keys=True)
    if meta.get("treedef") is not None and meta["treedef"] != sig:
        raise ValueError("checkpoint tree structure does not match graph state "
                         f"(graph restructured?):\n  saved:   {meta['treedef']}\n"
                         f"  current: {sig}")
    leaves = []
    for i, ref in enumerate(like_leaves):
        arr = data[f"leaf_{i}"]
        if isinstance(ref, torch.Tensor):
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i} shape mismatch: {arr.shape} vs "
                                 f"{tuple(ref.shape)}")
            leaves.append(torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype))
        else:
            if arr.shape != ():
                raise ValueError(f"leaf {i} shape mismatch: {arr.shape} vs ()")
            leaves.append(type(ref)(arr.item()))
    return _rebuild(like, iter(leaves))


def checkpoint_metadata(path: str) -> dict:
    data = np.load(path)
    return json.loads(bytes(data["__treedef__"]).decode())["metadata"]
