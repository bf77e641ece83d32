"""The launch layer's dry run: every cell builds and runs on ``meta`` with
the output tree of the JAX package's ``jax.eval_shape`` of the same cell.

This file holds the decode and chunked-prefill cells (every config at
each applicable decode shape; fp8-weight and raw-fp8-pool decode cells;
multi-pod decode cells, dense and MoE) and the dry run's command line;
``test_torch_dryrun_train.py`` holds the train and prefill cells.  The
reference's trees come from one subprocess per file with 512 forced host
devices (the 2x16x16 production mesh), started once per module and run
beside the port's cells.  Decode cells are planned with the port's
latency model on the reference's hardware figures, so their dims must
equal the reference's too.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.serving.latency_model import HardwareModel as JHardwareModel
from repro_torch import configs
from repro_torch.launch import cells, dryrun, mesh
from repro_torch.serving.latency_model import HardwareModel, LatencyModel
from test_torch_launch import _one_thread  # noqa: F401

DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn}

# The reference's side: build each cell, ``jax.eval_shape`` its step.
_REF_TREES = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.launch.cells import build_cell
from repro.launch.mesh import make_production_mesh

def tree(x):
    if isinstance(x, dict):
        return {str(k): tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tree(v) for v in x]
    return [list(x.shape), str(x.dtype)]

out = {}
for key, (arch, shape, mp, kw) in json.loads(sys.argv[1]).items():
    kw = {k: getattr(jnp, v) if k.endswith("_dtype") else v
          for k, v in kw.items()}
    cell = build_cell(arch, shape, make_production_mesh(multi_pod=mp),
                      multi_pod=mp, **kw)
    meta = {k: v for k, v in cell.meta.items() if k != "chunk_ends"}
    out[key] = {"tree": tree(jax.eval_shape(cell.fn, *cell.args)),
                "meta": meta}
print(json.dumps(out, default=str))
"""


class ReferenceTrees:
    """The reference's cells for ``cases`` {key: (arch, shape, multi_pod,
    kw)}, built in a subprocess started at once (it runs while the port's
    cells do); ``[key]`` -> {"tree", "meta"}, waiting for it the first
    time."""

    def __init__(self, cases: dict):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=512",
                   PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                  / "src"))
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _REF_TREES, json.dumps(cases)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._trees = None

    def __getitem__(self, key):
        if self._trees is None:
            out, err = self._proc.communicate(timeout=900)
            assert self._proc.returncode == 0, err[-4000:]
            self._trees = json.loads(out.strip().splitlines()[-1])
        return self._trees[key]

    def close(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.communicate()


def _norm(t):
    """JSON-shaped trees: tuples and lists alike, keys as strings."""
    if isinstance(t, dict):
        return {str(k): _norm(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)) and len(t) == 2 and isinstance(t[1], str):
        return [list(t[0]), t[1]]
    return [_norm(v) for v in t]


def check_cell(case, refs, key) -> None:
    """The port's cell of ``case`` on meta: the reference's output tree
    (``refs[key]``), and for a decode cell its dims and CP histogram."""
    arch, shape, mp, kw = case
    kw = {k: DTYPES[v] if k.endswith("_dtype") else v for k, v in kw.items()}
    if configs.SHAPES[shape].kind == "decode":
        kw["latency_model"] = LatencyModel(
            configs.get_config(arch),
            hw=HardwareModel(**dataclasses.asdict(JHardwareModel())))
    cell = cells.build_cell(arch, shape, mesh.make_production_mesh(
        multi_pod=mp), multi_pod=mp, **kw)
    for t in dryrun._tensors(cell.args):
        assert t.device.type == "meta"
    out, flops = dryrun.run_meta(cell.fn, cell.args)
    ref = refs[key]
    assert _norm(dryrun.shape_tree(out)) == _norm(ref["tree"])
    assert flops > 0
    if cell.kind == "decode":
        assert cell.meta["dims"] == ref["meta"]["dims"]
        assert {str(k): v for k, v in cell.meta["cp_histogram"].items()} == \
            ref["meta"]["cp_histogram"]
    for k in ("num_micro", "remat", "chunk_tokens", "num_chunks"):
        if k in ref["meta"]:
            assert cell.meta[k] == ref["meta"][k], k


def _decode_cases() -> dict:
    out = {}
    for arch in (*configs.ASSIGNED, "deepseek-v3"):
        cfg = configs.get_config(arch)
        for shape in configs.applicable_shapes(cfg):
            kind = configs.SHAPES[shape].kind
            if kind == "decode":
                out[f"{arch}/{shape}"] = (arch, shape, False, {})
            elif (kind == "prefill" and cfg.has_attention
                  and not cfg.is_encoder_decoder
                  and cfg.family not in ("ssm", "hybrid")):
                out[f"{arch}/{shape}/chunked"] = (arch, shape, False,
                                                  {"chunked": True})
    fp8 = {"weight_dtype": "float8_e4m3fn"}
    out.update({
        "tinyllama-1.1b/decode_32k/fp8w": ("tinyllama-1.1b", "decode_32k",
                                           False, fp8),
        "deepseek-v3/decode_32k/fp8w": ("deepseek-v3", "decode_32k", False,
                                        fp8),
        "jamba-v0.1-52b/long_500k/fp8w": ("jamba-v0.1-52b", "long_500k",
                                          False, fp8),
        "tinyllama-1.1b/decode_32k/rawfp8": ("tinyllama-1.1b", "decode_32k",
                                             False,
                                             {"kv_dtype": "float8_e4m3fn"}),
        "tinyllama-1.1b/decode_32k/2pods": ("tinyllama-1.1b", "decode_32k",
                                            True, {}),
        "phi3.5-moe-42b-a6.6b/decode_32k/2pods": (
            "phi3.5-moe-42b-a6.6b", "decode_32k", True, {}),
    })
    return out


CASES = _decode_cases()


@pytest.fixture(scope="module")
def ref_trees():
    refs = ReferenceTrees(CASES)
    yield refs
    refs.close()


@pytest.mark.parametrize("key", sorted(CASES))
def test_cell_runs_on_meta_with_the_reference_tree(key, ref_trees):
    check_cell(CASES[key], ref_trees, key)


def test_dryrun_command_line_records(tmp_path):
    """``python -m repro_torch.launch.dryrun`` (here ``main``) on one
    decode shape both ways and one prefill: every record is ok, with its
    output tree, flops, argument bytes (per device from the specs for the
    prefill cell) and the note of what has no counterpart."""
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                 "prefill_32k", "--multi-pod", "both", "--out",
                 str(tmp_path)])
    recs = json.loads((tmp_path / "dryrun.json").read_text())
    assert [(r["shape"], r["mesh"]) for r in recs] == [
        ("decode_32k", "16x16"), ("decode_32k", "2x16x16"),
        ("prefill_32k", "16x16"), ("prefill_32k", "2x16x16")]
    for r in recs:
        assert r["ok"], r.get("trace")
        assert r["cost"]["flops"] > 0 and r["outputs"]
        assert r["build_s"] >= 0 and r["run_s"] >= 0
        assert "HLO" in r["not_measured"]
        if r["kind"] == "prefill":
            assert 0 < r["argument_bytes"]["per_device"] < \
                r["argument_bytes"]["total"]
        else:
            assert "per_device" not in r["argument_bytes"]
            assert r["meta"]["cp_histogram"]


def test_dryrun_fails_a_cell_that_leaves_meta():
    """A step that makes a tensor off the meta device fails its run."""
    def leaky(x):
        return x + torch.ones(3).sum()
    with pytest.raises(RuntimeError, match="made a tensor on cpu"):
        dryrun.run_meta(leaky, (torch.empty(3, device="meta"),))
