"""What every part of the benchmark shares: where its files are, how a cell,
a configuration and a traffic mix are found by name, the port's
``ModelConfig`` built from a configuration file, and the weights made from
the seed.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<traffic>.json``).
Nothing here is specific to one of them: a later cell or configuration is a
new data file.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SRC = ROOT / "src"

# the published keys that are widths: a configuration may never change them
WIDTH_KEYS = ("hidden_size", "num_attention_heads", "num_key_value_heads",
              "head_dim", "intermediate_size", "moe_intermediate_size",
              "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "num_experts_per_tok",
              "n_routed_experts", "num_local_experts", "n_shared_experts",
              "vocab_size")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell file, with its configuration and traffic files under
    ``"model"`` and ``"mix"``."""
    path = BENCH / "workloads" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no cell file {path.relative_to(ROOT)}")
    cell = load_json(path)
    cell["name"] = name
    cell["model"] = load_json(BENCH / "configs" / f"{cell['config']}.json")
    cell["mix"] = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell


def use_program_path() -> None:
    """Put the program's package (``src/``) on the import path."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


# --------------------------------------------------------------------------- #
# the port's ModelConfig from a configuration file
# --------------------------------------------------------------------------- #
def layer_is_moe(model: dict, layer: int) -> bool:
    """The published layer pattern: dense below ``first_k_dense_replace``,
    then an MoE layer every ``moe_layer_freq``."""
    if not (model.get("n_routed_experts") or model.get("num_local_experts")):
        return False
    first = model.get("first_k_dense_replace", 0)
    return layer >= first and (layer - first) % model.get("moe_layer_freq",
                                                          1) == 0


def port_fields(model: dict) -> dict:
    """The ``ModelConfig`` fields that the file's published numbers set."""
    H = model["num_attention_heads"]
    f = dict(num_layers=model["num_hidden_layers"],
             d_model=model["hidden_size"], num_heads=H,
             num_kv_heads=model["num_key_value_heads"],
             d_ff=model["intermediate_size"], vocab_size=model["vocab_size"],
             rope_theta=float(model["rope_theta"]))
    if "kv_lora_rank" in model:
        f.update(q_lora_rank=model["q_lora_rank"],
                 kv_lora_rank=model["kv_lora_rank"],
                 qk_nope_head_dim=model["qk_nope_head_dim"],
                 qk_rope_head_dim=model["qk_rope_head_dim"],
                 v_head_dim=model["v_head_dim"])
    else:
        f["head_dim"] = model.get("head_dim", model["hidden_size"] // H)
    experts = model.get("n_routed_experts") or model.get("num_local_experts")
    if experts:
        f.update(num_experts=experts,
                 num_experts_per_tok=model["num_experts_per_tok"],
                 moe_d_ff=model.get("moe_intermediate_size",
                                    model["intermediate_size"]),
                 num_shared_experts=model.get("n_shared_experts", 0))
        kinds = [layer_is_moe(model, i) for i in range(f["num_layers"])]
        # the port's pattern is periodic: MoE where i % every == offset
        every = next((p for p in range(1, len(kinds) + 1)
                      if all(kinds[i] == (i % p == kinds.index(True))
                             for i in range(len(kinds)))), None)
        if every is None:
            raise ValueError("the layer pattern is not periodic in the port's "
                             "moe_every / moe_offset terms")
        f.update(moe_every=every, moe_offset=kinds.index(True))
    return f


def build_model_config(model: dict):
    """The port's registered config for ``model["port"]["arch"]`` with the
    file's depth, layer pattern and capacity factor.  Every width must
    already be the port's: a configuration file that would change one is
    refused."""
    use_program_path()
    from repro_torch.configs import get_config
    base = get_config(model["port"]["arch"])
    fields = port_fields(model)
    for k, v in fields.items():
        if k in ("num_layers", "moe_every", "moe_offset", "rope_theta"):
            continue
        have = getattr(base, k)
        if k == "head_dim":
            have = base.head_dim_
        if have != v:
            raise ValueError(f"{model['port']['arch']}: the port's {k} is "
                             f"{have}, the configuration file gives {v}")
    return dataclasses.replace(
        base, **fields, capacity_factor=float(model["port"]["capacity_factor"]))


# --------------------------------------------------------------------------- #
# weights from the seed
# --------------------------------------------------------------------------- #
NORM_LEAVES = ("scale", "q_norm", "k_norm", "kv_norm")
BIAS_LEAVES = ("bias", "bq", "bk", "bv", "bi", "bo")
CHUNK = 1 << 28          # numbers drawn per generator call (1 GiB of f32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


def make_weights(cfg, seed: int, device):
    """Float32 weights in the layout ``NanoCPEngine`` takes, drawn on
    ``device`` from ``seed``: one flat buffer filled by a generator on the
    device in 1 GiB calls, carved into the leaves.  Matrices are
    N(0, 1/fan_in) (fan-in: the second-last dim), token embeddings N(0, 1),
    norm scales 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1), so that a dropped
    norm or bias shows; the head's columns past the vocabulary are 0, so no
    padded id can win the argmax.  The same tensors go to the program and
    to the reference."""
    import torch
    use_program_path()
    from repro_torch.models import transformer
    shapes = transformer.init_params(cfg, device="meta", dtype=torch.float32)
    leaves = list(_leaves(shapes))
    total = sum(t.numel() for _, t in leaves)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for c in flat.split(CHUNK):
        c.normal_(generator=gen)
    params = {}
    off = 0
    with torch.no_grad():
        for path, meta in leaves:
            n = meta.numel()
            t = flat[off:off + n].view(meta.shape)
            off += n
            name = path[-1]
            if name in NORM_LEAVES:
                t.mul_(0.1).add_(1.0)
            elif name in BIAS_LEAVES:
                t.mul_(0.1)
            elif name != "tok":
                t.mul_(meta.shape[-2] ** -0.5)
            _set_path(params, path, t)
        head = params.get("head", {}).get("w")
        if head is not None:
            head[..., cfg.vocab_size:] = 0.0
    return params


def _set_path(tree, path, value):
    for i, k in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(tree, dict):
            tree = tree.setdefault(k, [] if isinstance(nxt, int) else {})
        else:
            while len(tree) <= k:
                tree.append([] if isinstance(nxt, int) else {})
            tree = tree[k]
    if isinstance(tree, list):
        while len(tree) <= path[-1]:
            tree.append(None)
    tree[path[-1]] = value

