"""Carry a render's state from the JAX package into the port.

:func:`state_from_jax` takes a port node and the state of the JAX node that
mirrors it, as numpy arrays (``jax.device_get(state)``), and returns the
port's state: biquad coefficients and carries, per-lane gains, the limiter
carries, the output offset, the drain flag and the input position. A
render can then start in one package and continue in the other. The PCM
itself is not copied: the port node holds its own, made from the same
numpy input.
"""
from __future__ import annotations

import numpy as np
import torch

from .conversions.resample import Resample
from .core.node import Node, State
from .effects.basic import Amplify
from .effects.blt import BltFilter
from .effects.limit import Limit
from .flagship import FusedWidePipeline
from .parallel.batch import WideMixer
from .sources.generators import SamplesBuffer


def _t(value, node: Node) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        dtype = torch.float32
    elif arr.dtype.kind == "b":
        dtype = torch.bool
    else:
        dtype = torch.int64
    return torch.as_tensor(arr.copy(), dtype=dtype, device=node.device)


def state_from_jax(node: Node, jstate) -> State:
    """The port's state for ``node``, from the mirroring JAX node's state."""
    if isinstance(node, Limit):
        return {"in": state_from_jax(node.input, jstate["in"]),
                "integ": _t(jstate["integ"], node),
                "peak": _t(jstate["peak"], node)}
    if isinstance(node, WideMixer):
        return state_from_jax(node.input, jstate)
    if isinstance(node, Amplify):
        return {"in": state_from_jax(node.input, jstate["in"]),
                "factor": _t(jstate["factor"], node)}
    if isinstance(node, BltFilter):
        st = {k: _t(jstate[k], node) for k in ("coef", "x1", "x2", "y1", "y2")}
        return {"in": state_from_jax(node.input, jstate["in"]), **st}
    if isinstance(node, Resample):
        if node.identity:
            return {"in": state_from_jax(node.input, jstate["in"])}
        return {"in": state_from_jax(node.input, jstate["in"]),
                "out_o": int(jstate["out_o"]),
                "drained": _t(jstate["drained"], node)}
    if isinstance(node, FusedWidePipeline):
        L = node._wide
        st = node.init_state()  # the port's own PCM layout and gains
        st.update(
            {"in": state_from_jax(node.input, jstate["in"]),
             "out_o": int(jstate["out_o"]),
             "drained": _t(jstate["drained"], node),
             # the JAX kernel pads its lanes to 1024
             "bq": _t(np.stack([np.asarray(b)[:L] for b in jstate["bq"]]), node),
             "coeffs": _t(jstate["coeffs"], node)})
        if "gv" in jstate:  # gain_post layout: the gains ride the state
            st["gains"] = _t(np.asarray(jstate["gv"]).reshape(-1)[:L], node)
        return st
    if isinstance(node, SamplesBuffer):
        st = {"pos": _t(jstate["pos"], node), "end": _t(jstate["end"], node)}
        if "data" in jstate:
            st["data"] = node._data
        return st
    raise NotImplementedError(f"no state conversion for {type(node).__name__}")
