"""What every part of the benchmark shares: where its files are, how a cell,
a configuration and a traffic mix are found by name, the port's
``ModelConfig`` built from a configuration file, and the weights made from
the seed.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<traffic>.json``).
A configuration may name its plain reference (``"reference": "<module>"``,
``reference/<module>.py``; ``moe_transformer`` where it names none).
Nothing here is specific to one of them: a later cell or configuration is a
new data file.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import re
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
              "vocab_size", "shared_intermediate_size", "mamba_d_state",
              "mamba_d_head", "mamba_n_heads", "mamba_expand",
              "mamba_n_groups", "mamba_d_conv")


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


def load_reference(model: dict):
    """The plain reference module that the configuration file names under
    ``"reference"`` (``reference/<name>.py``), ``moe_transformer`` where it
    names none.  Every one offers ``set_precision(tf32)`` and
    ``gaps(model, params, prompt, served, *, router_tie, router_flip,
    tf32_control)``."""
    name = model.get("reference", "moe_transformer")
    if not (re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name)
            and (BENCH / "reference" / f"{name}.py").is_file()):
        raise ValueError(f"no reference module bench/reference/{name}.py")
    return importlib.import_module(f"bench.reference.{name}")


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


# the ``layer_types`` spellings of the mixers the port runs: plain causal
# attention (GQA or MLA) and Mamba-2; sliding-window, linear and conv
# mixers it does not run
MIXERS = {"attention": "attention", "full_attention": "attention",
          "mamba": "mamba"}


def layer_kinds(model: dict) -> list:
    """Each layer's mixer (``"attention"`` or ``"mamba"``, from the source's
    ``layer_types``; attention where it has none) and FFN (``"moe"`` or
    ``"dense"``)."""
    L = model["num_hidden_layers"]
    types = model.get("layer_types", ["attention"] * L)
    if len(types) != L:
        raise ValueError(f"layer_types gives {len(types)} layers, the "
                         f"file {L}")
    other = sorted(set(types) - set(MIXERS))
    if other:
        raise ValueError(f"layer_types {other}: the port runs only "
                         f"{sorted(MIXERS)}")
    return [{"mixer": MIXERS[t],
             "ffn": "moe" if layer_is_moe(model, i) else "dense"}
            for i, t in enumerate(types)]


def _periodic(flags: list, what: str) -> tuple:
    """(every, offset) such that ``flags[i]`` is ``i % every == offset``,
    with the shortest period that tiles the layers whole: the port's terms
    for a layer pattern."""
    first = flags.index(True)
    every = next((p for p in range(1, len(flags) + 1)
                  if len(flags) % p == 0
                  and all(f == (i % p == first) for i, f in enumerate(flags))),
                 None)
    if every is None:
        raise ValueError(f"the {what} layer pattern is not periodic in the "
                         f"port's every / offset terms")
    return every, first


# the source's Mamba-2 keys and the port's fields they set
MAMBA_FIELDS = {"mamba_d_state": "ssm_state", "mamba_d_head": "ssm_head_dim",
                "mamba_expand": "ssm_expand", "mamba_d_conv": "ssm_conv_width",
                "mamba_chunk_size": "ssm_chunk"}


def port_fields(model: dict) -> dict:
    """The ``ModelConfig`` fields that the file's published numbers set;
    ``port.fields`` (``{"<ModelConfig field>": "<source key>"}``) maps
    further published keys onto fields."""
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
                                    model["intermediate_size"]))
        if "n_shared_experts" in model:
            f["num_shared_experts"] = model["n_shared_experts"]
        kinds = [layer_is_moe(model, i) for i in range(f["num_layers"])]
        f["moe_every"], f["moe_offset"] = _periodic(kinds, "MoE")
    attn = [k["mixer"] == "attention" for k in layer_kinds(model)]
    f["attn_every"], f["attn_offset"] = (
        (0, 0) if all(attn) else _periodic(attn, "attention"))
    if not all(attn):
        missing = [k for k in MAMBA_FIELDS if k not in model]
        if missing:
            raise ValueError(f"Mamba-2 layers need the source's {missing}")
        if model.get("mamba_n_groups", 1) != 1:
            raise ValueError(f"mamba_n_groups {model['mamba_n_groups']}: the "
                             "port's Mamba-2 layers have one group of B and C")
        f.update({field: model[k] for k, field in MAMBA_FIELDS.items()})
    for field, key in model.get("port", {}).get("fields", {}).items():
        f[field] = model[key]
    return f


# fields set by the file's depth and layer pattern, not checked against the
# port's registered config
PATTERN_FIELDS = ("num_layers", "moe_every", "moe_offset", "attn_every",
                  "attn_offset", "rope_theta")


def build_model_config(model: dict):
    """The port's registered config for ``model["port"]["arch"]`` with the
    file's depth, layer pattern and capacity factor.  Every width must
    already be the port's: a configuration file that would change one is
    refused."""
    use_program_path()
    from repro_torch.configs import get_config
    base = get_config(model["port"]["arch"])
    fields = port_fields(model)
    arch = model["port"]["arch"]
    for k, v in fields.items():
        if k in PATTERN_FIELDS:
            continue
        if not hasattr(base, k):
            raise ValueError(f"{arch}: the port's config has no field {k}")
        have = getattr(base, k)
        if k == "head_dim":
            have = base.head_dim_
        if have != v:
            raise ValueError(f"{arch}: the port's {k} is {have}, the "
                             f"configuration file gives {v}")
    cfg = dataclasses.replace(
        base, **fields, capacity_factor=float(model["port"]["capacity_factor"]))
    if "mamba_n_heads" in model and any(k["mixer"] == "ssm"
                                        for k in cfg.layer_kinds()):
        if cfg.ssm_num_heads != model["mamba_n_heads"]:
            raise ValueError(f"{arch}: the port derives {cfg.ssm_num_heads} "
                             f"Mamba-2 heads, the configuration file gives "
                             f"{model['mamba_n_heads']}")
    return cfg


# --------------------------------------------------------------------------- #
# weights from the seed
# --------------------------------------------------------------------------- #
CHUNK = 1 << 28          # numbers drawn per generator call (1 GiB of f32)


def _uniform(z):
    """U[0, 1] from N(0, 1), through the normal's distribution function."""
    return 0.5 * (z * -(0.5 ** 0.5)).erfc()


def _log_uniform(z, lo: float, hi: float):
    return (math.log(lo) + _uniform(z) * (math.log(hi) - math.log(lo))).exp()


def _inverse_softplus(y):
    return y + (-(-y).expm1()).log()


# each leaf's distribution, by leaf name, written in place over its share z
# of the one N(0, 1) buffer (``shape``: the leaf's, the block axis first;
# the large leaves are scaled in place, never copied); every other leaf is
# a matrix, N(0, 1/fan_in) with the second-last dim as fan-in
RULES = {
    # token embeddings: N(0, 1)
    "tok": lambda z, shape: z,
    # norm scales, and Mamba-2's skip D and gated-norm scale: 1 + 0.1 N, so
    # that a dropped norm or skip shows
    **dict.fromkeys(("scale", "q_norm", "k_norm", "kv_norm", "D", "norm"),
                    lambda z, shape: z.mul_(0.1).add_(1.0)),
    # biases, the conv's among them: 0.1 N
    **dict.fromkeys(("bias", "bq", "bk", "bv", "bi", "bo", "conv_b"),
                    lambda z, shape: z.mul_(0.1)),
    # the depthwise conv filter [.., width, channels]: N(0, 1/width)
    "conv_w": lambda z, shape: z.mul_(shape[-2] ** -0.5),
    # Mamba-2's own initialisation: A = -exp(A_log) with -A ~ U[1, 16] per
    # head, and dt_bias = softplus^-1(dt), dt log-uniform on [1e-3, 1e-1]
    "A_log": lambda z, shape: z.copy_((1.0 + 15.0 * _uniform(z)).log()),
    "dt_bias": lambda z, shape: z.copy_(
        _inverse_softplus(_log_uniform(z, 1e-3, 1e-1))),
}


def _matrix(z, shape):
    return z.mul_(shape[-2] ** -0.5)


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
    device in 1 GiB calls, carved into the leaves in their order, each
    leaf's share z transformed by its rule (``RULES``), none of which
    depends on the number of blocks:

    - matrices N(0, 1/fan_in) (fan-in: the second-last dim); token
      embeddings N(0, 1);
    - norm scales, and Mamba-2's skip ``D`` and gated-norm scale ``norm``,
      1 + 0.1 N(0, 1); biases, the conv's ``conv_b`` among them,
      0.1 N(0, 1): so that a dropped norm, skip or bias shows;
    - the conv filter ``conv_w`` N(0, 1/width);
    - ``A_log`` = log U[1, 16] per head and ``dt_bias`` = softplus^-1 of dt,
      dt log-uniform on [1e-3, 1e-1] (Mamba-2's own initialisation, so that
      a state carries over a long context), the uniforms Phi(z).

    The head's columns past the vocabulary (a tied head's: the embeddings'
    rows) are 0, so no padded id can win the argmax.  The same tensors go to the program and to the
    reference."""
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
            RULES.get(path[-1], _matrix)(t, meta.shape)
            _set_path(params, path, t)
        head = params.get("head", {}).get("w")
        if head is not None:
            head[..., cfg.vocab_size:] = 0.0
        else:       # tied: the head is the token embeddings' transpose
            params["embed"]["tok"][cfg.vocab_size:] = 0.0
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

