"""Weight conversion between the JAX package's parameter tree and the port's.

Both packages use the same nested layout (``embed``/``blocks``/
``final_norm``/``head``, block weights stacked on a leading axis), so the
conversion is leaf by leaf.  The JAX side is given as numpy leaves — what
``jax.tree.map(np.asarray, params)`` returns — so this module never
imports JAX.  bfloat16 leaves (``ml_dtypes.bfloat16`` in numpy) go through
float32, which is exact in both directions.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

_TORCH_OF = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16, "int32": torch.int32}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def from_jax(tree, *, device="cuda", dtype: torch.dtype | None = None) -> dict:
    """numpy-leaf JAX params -> torch params on ``device``.

    Each leaf keeps its dtype (bf16 stays bf16) unless ``dtype`` is given,
    in which case every floating leaf is cast to it.
    """
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        name = str(a.dtype)
        t = torch.from_numpy(np.array(
            a, dtype=np.float32 if name == "bfloat16" else a.dtype))
        t = t.to(_TORCH_OF.get(name, t.dtype))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)
    return _map(tree, leaf)


def to_jax(tree) -> dict:
    """torch params -> numpy leaves (float32 for bf16 tensors, which
    ``jnp.asarray(x, jnp.bfloat16)`` restores exactly)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return _map(tree, leaf)
