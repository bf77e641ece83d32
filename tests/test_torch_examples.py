"""The port's entry points held against the JAX package's on the CPU:
``repro_torch.models.forward`` against ``repro.models.forward``, and the
three examples (``examples/torch_{simulate_cluster,quickstart,serve_dcp}.py``)
against ``examples/{simulate_cluster,quickstart,serve_dcp}.py``.

  * simulate: the reference example runs in a subprocess at rate 20, ratio
    0.05; the port's ``run`` uses a ``LatencyModel`` built from the
    reference's ``HardwareModel`` fields (the port's defaults are the
    H100's).  The derived buckets, the workload line and every table row
    must be equal as printed.
  * quickstart: the reference's loop (``make_train_step(num_micro=2)``,
    lr 1e-2, 60 steps, an ``AsyncCheckpointer`` every 10 steps) and the
    port's ``run`` from the same JAX init cast to float32: every step's loss
    within 1e-4 relative, both latest checkpoints at step 50.  From the
    example's own bf16 init, the first 20 steps within 2^-8 relative (bf16's
    unit roundoff): 1e-4 holds at no bf16 step, since the two frameworks
    round bf16 products and sums differently from step 0's forward on.
  * serve: the reference ``NanoCPEngine`` with the example's exact
    arguments, on 8 forced host devices in a subprocess and without the
    example's per-token check, beside the port's ``run`` at the reduced
    config from the same weights: equal transcripts, equal AOT
    captured / lookups / hits, the port's greedy check exact, no frame
    leaked.

Every case runs torch on one intra-op thread.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.serving import latency_model as jlatency
from repro.training import (checkpoint as jcheckpoint, data as jdata,
                            optimizer as joptimizer, train_step as jtrain_step)
from repro_torch import models, params as P
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.serving.latency_model import HardwareModel, LatencyModel
from torch_shared import EXAMPLES, _one_thread, load_example  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"
LOSS_RTOL = 1e-4
BF16_LOSS_RTOL = 2.0 ** -8     # bf16's unit roundoff
BF16_STEPS = 20
FORWARD_TOL = 1e-5


def _reference(script: str, *args, devices: int = 1) -> subprocess.Popen:
    """Start a reference script (a path, or code for ``-c``) in its own
    process on ``devices`` forced host devices; read it with ``_finish``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    argv = ([str(EXAMPLES / script)] if script.endswith(".py")
            else ["-c", script])
    return subprocess.Popen([sys.executable, *argv, *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: int = 600) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def _f32_tree(jcfg, seed: int = 0):
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jmodels.init_params(jax.random.PRNGKey(seed), jcfg))


# --------------------------------------------------------------------------- #
# models.forward
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-base"])
def test_models_forward_matches_jax(arch):
    """The architecture dispatch: a decoder-only batch {"tokens"} and an
    encoder-decoder one {"frames", "tokens"} give JAX's logits within
    1e-5 from the same float32 weights and numpy inputs."""
    over = {"vocab_size": 256}
    if arch == "tinyllama-1.1b":
        over["num_layers"] = 2
    jcfg = jreduced(JCONFIGS[arch], **over)
    cfg = reduced(CONFIGS[arch], **over)
    np_tree = _f32_tree(jcfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (2, 24)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((2, 40, cfg.d_model)).astype(
            np.float32)
    want = np.asarray(jmodels.forward(
        jcfg, jax.tree.map(jnp.asarray, np_tree),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    got = models.forward(cfg, P.from_jax(np_tree, device="cpu"), batch,
                         device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FORWARD_TOL,
                               rtol=FORWARD_TOL)


# --------------------------------------------------------------------------- #
# examples/simulate_cluster.py
# --------------------------------------------------------------------------- #
def test_simulate_cluster_table_equals_reference():
    ex = load_example("torch_simulate_cluster")
    proc = _reference("simulate_cluster.py", 20, 0.05)
    lm = LatencyModel(get_config(ex.ARCH), hw=HardwareModel(
        **dataclasses.asdict(jlatency.HardwareModel())))
    rows = ex.run(20.0, 0.05, latency=lm)
    lines = _finish(proc).splitlines()
    ref_rows = [ln for ln in lines
                if ln.split(" ")[0] in {r["system"] for r in rows}]
    assert [ex.format_row(r) for r in rows] == ref_rows
    buckets = lines[0].split("derived CP buckets: ")[1]
    assert str(ex.derive_buckets(lm)) == buckets
    wl = ex.workload(20.0, 0.05)
    shares = {k: round(v, 3) for k, v in wl.interval_shares().items()}
    assert f"{len(wl.requests)} requests (shares: {shares})" in lines
    # the port's own H100 constants derive other buckets (modeled)
    h100 = LatencyModel(get_config(ex.ARCH))
    assert ex.derive_buckets(h100) != ex.derive_buckets(lm)


# --------------------------------------------------------------------------- #
# examples/quickstart.py
# --------------------------------------------------------------------------- #
def _jax_quickstart(jcfg, jparams, steps: int) -> tuple[list, int]:
    """The reference example's loop from ``jparams``: the per-step losses
    and the latest checkpoint step."""
    opt_cfg = joptimizer.AdamWConfig(lr=1e-2, warmup_steps=10,
                                     total_steps=200)
    opt = joptimizer.init_opt_state(jparams)
    ds = jdata.SyntheticTokens(jcfg, batch=8, seq_len=64)
    step_fn = jax.jit(jtrain_step.make_train_step(jcfg, opt_cfg, num_micro=2))
    losses = []
    with tempfile.TemporaryDirectory() as d:
        ck = jcheckpoint.AsyncCheckpointer(d)
        for step in range(steps):
            batch = {k: jnp.asarray(v) for k, v in ds.batch_at(step).items()}
            jparams, opt, stats = step_fn(jparams, opt, batch)
            losses.append(float(stats["loss"]))
            if step % 10 == 0:
                ck.submit(step, {"params": jparams, "opt": opt})
        ck.close()
        return losses, jcheckpoint.latest_step(d)


def test_quickstart_losses_match_jax():
    ex = load_example("torch_quickstart")
    jcfg = jreduced(JCONFIGS[ex.ARCH], num_layers=2)
    np_tree = _f32_tree(jcfg)
    res = ex.run(ex.reduced_config(), P.from_jax(np_tree, device="cpu"),
                 device="cpu")
    jlosses, jlatest = _jax_quickstart(
        jcfg, jax.tree.map(jnp.asarray, np_tree), 60)
    rel = np.abs(np.array(res["losses"]) - jlosses) / np.abs(jlosses)
    assert len(rel) == 60 and rel.max() <= LOSS_RTOL, rel
    assert res["latest_step"] == jlatest == 50
    assert res["losses"][50] < res["losses"][0] - 1.0


def test_quickstart_bf16_losses_match_jax():
    """The example's own dtypes: the JAX init as it comes (bf16 weights,
    f32 norm scales), converted leaf for leaf."""
    ex = load_example("torch_quickstart")
    jcfg = jreduced(JCONFIGS[ex.ARCH], num_layers=2)
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert {t.dtype for t in jax.tree.leaves(params)} == {torch.bfloat16,
                                                          torch.float32}
    res = ex.run(ex.reduced_config(), params, device="cpu", steps=BF16_STEPS)
    jlosses, _ = _jax_quickstart(jcfg, jparams, BF16_STEPS)
    rel = np.abs(np.array(res["losses"]) - jlosses) / np.abs(jlosses)
    assert len(rel) == BF16_STEPS and rel.max() <= BF16_LOSS_RTOL, rel


# --------------------------------------------------------------------------- #
# examples/serve_dcp.py
# --------------------------------------------------------------------------- #
_REFERENCE_ENGINE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import CONFIGS, reduced
from repro.core.bucketing import CPBuckets, ShapeBuckets
from repro.models import init_params
from repro.serving.engine import NanoCPEngine

# examples/serve_dcp.py up to its engine.run, without the per-token check
cfg = reduced(CONFIGS["phi3.5-moe-42b-a6.6b"], vocab_size=256,
              capacity_factor=8.0)
params = jax.tree.map(lambda x: x.astype(jnp.float32),
                      init_params(jax.random.PRNGKey(0), cfg))
mesh = compat.make_mesh((4, 2), ("data", "model"))
engine = NanoCPEngine(
    cfg, params, mesh, num_instances=4, instances_per_node=4,
    kv_capacity_tokens=2048, page_size=16,
    buckets=CPBuckets(edges=(100, 256), degrees=(1, 2, 3)),
    shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                               s_buckets=(0, 1, 2, 4), window=4))
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, (L,))
           for L in [50, 300, 120, 40, 200, 64]]
for p in prompts:
    engine.add_request(p, max_new_tokens=6)
results = engine.run(max_iters=40)
print(json.dumps({"transcripts": {r: g.tokens for r, g in results.items()},
                  "aot": engine.aot.stats.as_dict()}))
"""


def test_serve_example_equals_reference_engine():
    ex = load_example("torch_serve_dcp")
    proc = _reference(_REFERENCE_ENGINE, devices=8)
    cfg = ex.config(small=True)
    jcfg = jreduced(JCONFIGS[ex.ARCH], vocab_size=256, capacity_factor=8.0)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = P.from_jax(_f32_tree(jcfg), device="cpu")
    prompts = ex.make_prompts(cfg)
    res = ex.run(cfg, params, prompts, device="cpu")
    assert res["drained"] and res["leaked_frames"] == 0
    bad, ties = ex.greedy_check(cfg, params, prompts, res["transcripts"],
                                device="cpu")
    assert not bad and not ties
    ref = json.loads(_finish(proc).splitlines()[-1])
    assert res["transcripts"] == {int(r): t
                                  for r, t in ref["transcripts"].items()}
    assert all(len(t) == ex.NEW_TOKENS for t in res["transcripts"].values())
    for k in ("captured", "lookups", "hits"):
        assert res["aot"][k] == ref["aot"][k], (k, res["aot"], ref["aot"])
