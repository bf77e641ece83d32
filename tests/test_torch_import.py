"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py`` and the
port's examples, ``examples/torch_*.py``) import neither JAX nor anything
of the JAX package, and its entry points run on CUDA unless the caller
asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_shared import load_example

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
                                         REPO / "chip_smoke.py",
                                         *(REPO / "examples").glob(
                                             "torch_*.py")]))
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
    serve, quickstart = (load_example("torch_serve_dcp"),
                         load_example("torch_quickstart"))
    prompts = [np.arange(20) % 256]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(cfg, params, prompts, new_tokens=2, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.run(cfg, params, steps=1)
    # the same calls on the CPU, when asked for
    logits, _ = transformer.forward(cfg, params, np.zeros((1, 4), np.int64),
                                    device="cpu")
    assert logits.device.type == "cpu"
    assert dcp.init_serve_state(cfg, dims, 1, device="cpu")["k_pool"].device.type == "cpu"
    eng = NanoCPEngine(cfg, params, device="cpu", **kw)
    assert eng.state["k_pool"].device.type == "cpu"
    res = serve.run(cfg, params, prompts, new_tokens=2, device="cpu", **kw)
    assert len(res["transcripts"][0]) == 2 and res["leaked_frames"] == 0
    res = quickstart.run(cfg, params, steps=1, device="cpu")
    assert len(res["losses"]) == 1 and res["latest_step"] == 0


def test_unported_paths_raise_not_implemented():
    """The engine's guards (a bad kv dtype or backend; an audio request to
    a decoder-only engine, a token request to an encoder-decoder one; a
    decoder prefix past the learned positions), and every archetype the
    reference serves builds: SSM and hybrid (item 11), and encoder-decoder
    whisper (item 12), whose engine enqueues an audio request."""
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.models import encdec, transformer
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
    with pytest.raises(ValueError, match="encoder-decoder"):
        eng.add_audio_request(np.zeros((4, cfg.d_model)), [1], 2)
    # SSM and hybrid configs are ported (item 11): both build and serve
    for arch in ("mamba2-370m", "jamba-v0.1-52b"):
        scfg = reduced(CONFIGS[arch], vocab_size=256)
        sparams = transformer.init_params(scfg, seed=0, device="cpu",
                                          dtype=torch.float32)
        NanoCPEngine(scfg, sparams, num_instances=2, instances_per_node=2,
                     kv_capacity_tokens=128, tp=2, device="cpu")
    # encoder-decoder (item 12): a reduced whisper engine builds, enqueues
    # an audio request, refuses token prompts and quantized pools
    wcfg = reduced(CONFIGS["whisper-base"], vocab_size=256)
    with pytest.raises(ValueError, match="encoder-decoder"):
        transformer.init_params(wcfg, device="cpu")
    wparams = encdec.init_params(wcfg, seed=0, device="cpu",
                                 dtype=torch.float32)
    wkw = dict(num_instances=2, instances_per_node=2, kv_capacity_tokens=256,
               tp=2, max_slots_per_instance=2, device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        NanoCPEngine(wcfg, wparams, **wkw, kv_dtype="fp8")
    weng = NanoCPEngine(wcfg, wparams, **wkw)
    rid = weng.add_audio_request(np.zeros((40, wcfg.d_model)), [1, 2, 3],
                                 max_new_tokens=4)
    assert [r.rid for r in weng.cluster.waiting] == [rid]
    assert weng.cluster.waiting[0].dec_prefix_len == 3
    with pytest.raises(ValueError, match="audio"):
        weng.add_request([1, 2, 3], max_new_tokens=4)
    with pytest.raises(ValueError, match="positions"):
        weng.add_audio_request(np.zeros((40, wcfg.d_model)), [1] * 60,
                               max_new_tokens=8)


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
