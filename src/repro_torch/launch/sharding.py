"""Sharding rules of the train and prefill cells, ZeRO-1 optimizer specs,
and the activation hook (port of ``repro/launch/sharding.py``).

A spec is a ``P``: a tuple with one entry per leading dim of its leaf, each
an axis name, a tuple of axis names or None (replicated), as
``jax.sharding.PartitionSpec``.  The port runs on one card, so a spec
places nothing: the dry run reads it for each leaf's per-device bytes, and
the tests hold it leaf for leaf against the reference's.  The decode
step's layout lives in ``core/dcp.py`` (the virtual (instance, tp) mesh).

The reference's ``to_named`` (spec tree -> ``NamedSharding`` tree) has no
counterpart: there is no device mesh to name.
"""
from __future__ import annotations

from ..configs.base import ModelConfig


class P(tuple):
    """A partition spec: ``P("model", None)``; ``P()`` is replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# leaf name -> rule kind for the TRAINING parameter tree
_COL = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",
        "wi", "wi_gate", "wi_up", "in_proj", "conv_w",
        "bq", "bk", "bv", "bi", "conv_b"}
_ROW = {"wo", "out_proj"}
_REPL = {"scale", "bias", "bo", "q_norm", "k_norm", "kv_norm", "router",
         "pos_dec"}
_VEC_COL = {"A_log", "D", "dt_bias", "norm"}   # per-head/channel SSM vectors


def map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and lists;
    ``path`` holds the dict keys and list indices (as strings) down to
    the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, *(r[i] for r in rest),
                              path=path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def train_param_specs(cfg: ModelConfig, params, *, fsdp: bool = True,
                      fsdp_size: int = 16, min_fsdp_bytes: int = 2 ** 20):
    """Spec tree for ``models.init_params``' output: TP over `model` (MoE
    experts TP on d_ff for training); with ``fsdp`` every large weight also
    shards its largest free dim that ``fsdp_size`` divides over `data`."""

    def add_fsdp(spec, leaf):
        if not fsdp or leaf.numel() * 2 < min_fsdp_bytes:
            return spec
        dims = list(spec) + [None] * (leaf.dim() - len(spec))
        cand = [d for d in range(leaf.dim())
                if dims[d] is None and leaf.shape[d] % fsdp_size == 0
                and leaf.shape[d] >= fsdp_size]
        if not cand:
            return spec
        d = max(cand, key=lambda d: leaf.shape[d])
        dims[d] = "data"
        return P(*dims)

    def spec_of(names, leaf):
        name = names[-1]
        nd = leaf.dim()
        if name == "tok":
            return P("model", None)
        if name == "w" and "head" in names:
            return P(None, "model")
        if name in _REPL:
            return P()
        if name in _ROW:
            if "ffn" in names and nd == 4:          # MoE wo [nb, E, F, D]
                return P(None, None, "model", None)
            return P(*([None] * (nd - 2)), "model", None)
        if name in _COL:
            if "ffn" in names and nd == 4:          # MoE wi [nb, E, D, F]
                return P(None, None, None, "model")
            return P(*([None] * (nd - 1)), "model")
        if name in _VEC_COL:
            return P(*([None] * (nd - 1)), "model")
        raise KeyError(f"no train sharding rule for {'/'.join(names)}")

    return map_with_path(lambda path, leaf: add_fsdp(spec_of(path, leaf), leaf),
                         params)


def zero_opt_specs(param_specs, params, data_size: int, dp_axes=("data",)):
    """ZeRO-1: each moment leaf also shards over the data axes on its
    largest dim that is still free and divisible; leaves under 65,536
    values, or already sharded over `data`, keep the parameter's spec."""
    dp = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]

    def z(path, spec, leaf):
        dims = list(spec) + [None] * (leaf.dim() - len(spec))
        flat = [a for d in dims if d
                for a in (d if isinstance(d, tuple) else (d,))]
        if "data" in flat:              # already FSDP-sharded over data
            return P(*dims)
        cand = [(d, leaf.shape[d]) for d in range(leaf.dim())
                if dims[d] is None and leaf.shape[d] % data_size == 0
                and leaf.shape[d] >= data_size]
        if not cand or leaf.numel() < 65_536:
            return P(*dims)
        d = max(cand, key=lambda t: t[1])[0]
        dims[d] = dp
        return P(*dims)

    moments = map_with_path(z, param_specs, params)
    return {"mu": moments, "nu": moments, "step": P()}


def batch_specs(cfg: ModelConfig, dp_axes=("data",)) -> dict:
    dp = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]
    out = {"tokens": P(dp, None), "targets": P(dp, None)}
    if cfg.is_encoder_decoder:
        out["frames"] = P(dp, None, None)
    return out


def make_shard_fn(mesh, dp_axes=("data",)):
    """The activation hook for ``models.*.forward``: hidden states [B, S,
    D] (batch over the data axes) x (sequence over `model`) between layers,
    logits [B, S, V] vocab over `model`, the SSD scan's chunks over
    `model`.  It returns ``x`` itself; each constraint the reference would
    place is appended to ``mesh.log`` as ``(name, shape, spec)``."""
    dp = (None if not dp_axes
          else tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0])

    def shard(x, name):
        if name == "hidden" and x.dim() == 3:
            spec = P(dp, "model", None)
        elif name == "logits" and x.dim() == 3:
            spec = P(dp, None, "model")
        elif name == "ssm_chunk":
            spec = P(dp, "model", *([None] * (x.dim() - 2)))
        else:
            return x
        mesh.log.append((name, tuple(x.shape), spec))
        return x
    return shard


def per_device_bytes(mesh, specs, tree) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs``: each leaf's
    bytes over the product of its spec's axis sizes (ceil per dim)."""
    sizes = mesh.shape
    total = 0

    def add(path, spec, leaf):
        nonlocal total
        dims = list(spec) + [None] * (leaf.dim() - len(spec))
        n = 1
        for d, ax in zip(leaf.shape, dims):
            axes = (() if ax is None
                    else ax if isinstance(ax, tuple) else (ax,))
            parts = 1
            for a in axes:
                parts *= sizes.get(a, 1)
            n *= -(-d // parts)
        total += n * leaf.element_size()
        return spec

    map_with_path(add, specs, tree)
    return total
