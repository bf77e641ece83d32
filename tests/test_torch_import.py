"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py``) import
neither JAX nor anything of the JAX package, and its entry points run on
CUDA unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n.startswith("jaxlib.") or n == "repro" or n.startswith("repro."))
assert not bad, bad
print(len(names))
"""


def test_import_leaves_jax_and_reference_out():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    # every module of the package was imported
    n_files = sum(1 for _ in PKG.rglob("*.py"))
    assert int(out.stdout.strip()) == n_files


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
                        r"from\s+jaxlib\b|import\s+repro\b(?!_)|"
                        r"from\s+repro(\.|\s)(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        [*PKG.rglob("*.py"),
                                         REPO / "chip_smoke.py"]))
def test_source_has_no_jax_or_reference_import(path):
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.search(src), path


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core import dcp
    from repro_torch.models import transformer
    from repro_torch.serving.engine import NanoCPEngine

    cfg = reduced(CONFIGS["tinyllama-1.1b"], num_layers=2, vocab_size=256)
    dims = dcp.DecodeDims(M=2, S=0, N=2, MB=4, W=1, num_frames=9, page=16,
                          data_size=1, tp=1)
    params = transformer.init_params(cfg, seed=0, device="cpu",
                                     dtype=torch.float32)
    kw = dict(num_instances=1, instances_per_node=1, kv_capacity_tokens=128,
              tp=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.forward(cfg, params, np.zeros((1, 4), np.int64))
    with pytest.raises(RuntimeError, match="CUDA"):
        dcp.init_serve_state(cfg, dims, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        NanoCPEngine(cfg, params, **kw)
    # the same calls on the CPU, when asked for
    logits, _ = transformer.forward(cfg, params, np.zeros((1, 4), np.int64),
                                    device="cpu")
    assert logits.device.type == "cpu"
    assert dcp.init_serve_state(cfg, dims, 1, device="cpu")["k_pool"].device.type == "cpu"
    eng = NanoCPEngine(cfg, params, device="cpu", **kw)
    assert eng.state["k_pool"].device.type == "cpu"


def test_unported_paths_raise_not_implemented():
    from dataclasses import replace

    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.models import transformer
    from repro_torch.serving.engine import NanoCPEngine

    cfg = reduced(CONFIGS["tinyllama-1.1b"], num_layers=2, vocab_size=256)
    params = transformer.init_params(cfg, seed=0, device="cpu",
                                     dtype=torch.float32)
    kw = dict(num_instances=1, instances_per_node=1, kv_capacity_tokens=128,
              tp=1, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        NanoCPEngine(cfg, params, **kw, kv_dtype="fp16")
    with pytest.raises(ValueError, match="backend"):
        NanoCPEngine(cfg, params, **kw, backend="nccl")
    eng = NanoCPEngine(cfg, params, **kw)
    with pytest.raises(NotImplementedError, match="item 12"):
        eng.add_audio_request(None, [])
    with pytest.raises(NotImplementedError, match="item 11"):
        transformer.init_params(replace(cfg, family="ssm"), device="cpu")



@pytest.mark.parametrize("arch,backend", [("minicpm3-4b", "routed"),
                                          ("minicpm3-4b", "dense"),
                                          ("tinyllama-1.1b", "dense")])
def test_mla_and_dense_backend_serve_on_cpu(arch, backend):
    """MLA and the dense all-gather backend are ported: the port's own
    random init serves two requests across a (2, 2) mesh on the CPU, and
    the dense backend returns the routed backend's tokens."""
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.bucketing import CPBuckets
    from repro_torch.models import transformer
    from repro_torch.serving.engine import NanoCPEngine

    cfg = reduced(CONFIGS[arch], num_layers=2, vocab_size=128)
    params = transformer.init_params(cfg, seed=0, device="cpu",
                                     dtype=torch.float32)
    prompts = [np.arange(70) % 128, np.arange(9, 30)]
    out = {}
    for be in {"routed", backend}:
        eng = NanoCPEngine(cfg, params, num_instances=2, instances_per_node=2,
                           kv_capacity_tokens=512, tp=2, backend=be,
                           buckets=CPBuckets(edges=(64,), degrees=(1, 2)),
                           device="cpu")
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
        out[be] = {r: g.tokens for r, g in eng.run(max_iters=20).items()}
        assert all(len(t) == 4 for t in out[be].values())
        assert ("kv_pool" in eng.state) == cfg.is_mla
    assert out[backend] == out["routed"]
