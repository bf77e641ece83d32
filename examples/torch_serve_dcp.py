"""END-TO-END EXAMPLE of the PyTorch port: serve an MoE model with batched,
variable-length requests through the FULL NanoCP stack on one GPU --
dual-balanced scheduler, global page table, WaterFill splits, routing
tables, one CUDA graph per bucket, and the four-phase DCP decode step on a
virtual (4 instances x TP 2) mesh, with the hand-written paged-decode and
flash kernels.  Every generated token is checked against the port's
greedy ``transformer.forward``.

  PYTHONPATH=src python examples/torch_serve_dcp.py              # full width, CUDA
  PYTHONPATH=src python examples/torch_serve_dcp.py --reduced --device cpu

By default the model is Phi-3.5-MoE at its published widths, cut to 8 of
its 32 layers (about 43 GB of float32 weights on an 80 GB card), with
capacity factor 8 (no token dropped, so decode and prefill route alike)
and random weights from ``init_params(seed=0)``.  ``--reduced`` is the
JAX example's config: ``reduced(phi3.5-moe, vocab_size=256,
capacity_factor=8.0)``.  The greedy check is teacher-forced (one forward
per request over prompt + transcript).  At reduced size every token must
equal greedy.  At full width a token may differ only where greedy's top-2
logit gap is below 1e-4 (a near-tie between two float32 programs).  Any
other mismatch exits non-zero.
"""
import argparse
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.models import transformer
from repro_torch.serving.engine import NanoCPEngine

ARCH = "phi3.5-moe-42b-a6.6b"
FULL_LAYERS = 8              # of 32: the float32 weights fit one 80 GB card
CAPACITY_FACTOR = 8.0        # no expert drops a token
LENGTHS = (50, 300, 120, 40, 200, 64)
NEW_TOKENS = 6
MAX_ITERS = 40
GAP_TOL = 1e-4               # full width: near-ties tolerated below this gap
ENGINE_ARGS = dict(
    num_instances=4, tp=2, instances_per_node=4, kv_capacity_tokens=2048,
    page_size=16, buckets=CPBuckets(edges=(100, 256), degrees=(1, 2, 3)),
    shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4), s_buckets=(0, 1, 2, 4),
                               window=4))


def config(small: bool = False):
    """The JAX example's reduced config, or full width at FULL_LAYERS."""
    cfg = get_config(ARCH)
    if small:
        return reduced(cfg, vocab_size=256, capacity_factor=CAPACITY_FACTOR)
    return replace(cfg, num_layers=FULL_LAYERS,
                   capacity_factor=CAPACITY_FACTOR)


def make_prompts(cfg) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, (L,)) for L in LENGTHS]


def leaked_frames(eng: NanoCPEngine) -> int:
    """Frames still held, or missing from an alive instance's free list,
    once every request has finished (the prefix cache is off)."""
    pt = eng.cluster.page_table
    return sum(held + abs(pt.frames_per_instance - free - held)
               for free, held in pt.frame_audit().values())


def run(cfg, params, prompts, *, device="cuda", new_tokens: int = NEW_TOKENS,
        **engine_kw) -> dict:
    """Serve ``prompts`` through the engine with the example's arguments
    (``engine_kw`` overrides them) for at most MAX_ITERS engine steps.
    ``params`` live on ``device``.  Returns the transcripts by rid, the
    decode iterations, the step cache's stats, the frames left held once
    the run has drained, and one record per engine step: its host
    milliseconds, the prefill's share of them, whether it dispatched a
    decode step and how many rows, and whether it captured a bucket's
    graph."""
    dev = resolve_device(device)
    eng = NanoCPEngine(cfg, params, device=dev, **{**ENGINE_ARGS, **engine_kw})
    for p in prompts:
        eng.add_request(p, max_new_tokens=new_tokens)
    steps = []
    with torch.no_grad():
        while eng.pending and len(steps) < MAX_ITERS:
            captured = eng.aot.stats.captured
            t0 = time.perf_counter()
            eng.step()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "prefill_ms": eng.timings.get("prefill_us", 0.0)
                          / 1e3,
                          "dispatched": "dispatch_us" in eng.timings,
                          "rows": (int(eng.last_batch_sizes.sum())
                                   if "dispatch_us" in eng.timings else 0),
                          "captured": eng.aot.stats.captured > captured})
    out = {"transcripts": {rid: list(r.tokens)
                           for rid, r in eng.results.items()},
           "iterations": eng.iterations, "aot": eng.aot.stats.as_dict(),
           "drained": not eng.pending, "leaked_frames": leaked_frames(eng),
           "steps": steps}
    eng.close()
    return out


def greedy_check(cfg, params, prompts, transcripts, *, device="cuda",
                 gap_tol: float = 0.0) -> tuple[list, list]:
    """Each transcript against the greedy forward, teacher-forced.  Returns
    (failures, tolerated near-ties), each a list of (rid, position, engine
    token, greedy token, greedy's top-2 logit gap): a token off greedy is a
    near-tie where the gap is below ``gap_tol`` (0: none is)."""
    dev = resolve_device(device)
    bad, ties = [], []
    for rid, prompt in enumerate(prompts):
        toks = transcripts[rid]
        seq = np.concatenate([np.asarray(prompt), np.asarray(toks[:-1],
                                                             np.int64)])
        with torch.no_grad():
            logits, _ = transformer.forward(
                cfg, params, torch.as_tensor(seq, device=dev)[None],
                device=dev)
        lg = logits[0, len(prompt) - 1:].float()
        top2 = lg.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        for t, (got, want) in enumerate(zip(toks, lg.argmax(-1).tolist())):
            if got != want:
                (ties if gaps[t] < gap_tol else bad).append(
                    (rid, t, got, want, gaps[t]))
    return bad, ties


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the JAX example's reduced config")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = config(args.reduced)
    print(f"model: {'reduced ' if args.reduced else ''}{cfg.name} -- "
          f"{cfg.num_layers}L MoE {cfg.num_experts}e "
          f"top-{cfg.num_experts_per_tok}, d={cfg.d_model}, "
          f"vocab {cfg.vocab_size}, on {dev}")
    params = transformer.init_params(cfg, seed=0, device=dev,
                                     dtype=torch.float32)
    prompts = make_prompts(cfg)
    print(f"enqueued {len(prompts)} requests, lengths {list(LENGTHS)}")
    res = run(cfg, params, prompts, device=dev)
    print(f"decode iterations: {res['iterations']}, AOT stats: {res['aot']}")
    gap_tol = 0.0 if args.reduced else GAP_TOL
    bad, ties = greedy_check(cfg, params, prompts, res["transcripts"],
                             device=dev, gap_tol=gap_tol)
    for rid, toks in res["transcripts"].items():
        mine = [c for c in bad if c[0] == rid]
        print(f"  rid {rid} (len {LENGTHS[rid]:3d}) -> {toks} "
              + ("== greedy OK" if not mine else f"MISMATCH at {mine}"))
    for rid, t, got, want, gap in ties:
        print(f"  near-tie: rid {rid} token {t}: {got} vs greedy {want} "
              f"(top-2 gap {gap:.3g} < {gap_tol})")
    ok = (not bad and res["drained"] and res["leaked_frames"] == 0
          and all(len(t) == NEW_TOKENS for t in res["transcripts"].values()))
    if not ok:
        print(f"FAILED: {len(bad)} mismatches, drained {res['drained']}, "
              f"leaked frames {res['leaked_frames']}")
        sys.exit(1)
    print("all generations match greedy -- full stack verified")


if __name__ == "__main__":
    main()
