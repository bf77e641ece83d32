"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py              # every phase, then the result line
    python3 chip_smoke.py --kernels    # phases 1-2 only, no result line
    python3 chip_smoke.py --launch     # phases 1 and 17 only, no result line
    python3 chip_smoke.py --examples   # phases 1 and 10b only, no result line
    python3 chip_smoke.py --moe-experts  # phase 1 and 2's moe_experts rows only

Phases, each printing one JSON line:

  1. device  — the card (name, power limit), CUDA version, kernel build time
               (every kernel is built from src/repro_torch/csrc by nvcc).
  2. kernels — each Hopper kernel held against its plain torch version on
               the card, in float32 (atol = rtol = 1e-4) and bfloat16
               (atol = rtol = 2e-2), at the main path's shapes; kernel,
               plain and library device times (CUDA events, L2 flushed
               between launches) beside the bound.  The paged kernel also
               runs on fp8 and int8 quantized pages with per-page scales,
               for float32 and bfloat16 queries (same tolerances).  Each
               timed row carries its share of the bound (bound_ms / ms).
               Edge rows ("kernel-edge") hold both kernels at the split and
               tile boundaries, MB = 1, zero-length rows, v as a strided
               view of k (MLA's 40 / 32 head dims), bf16 head dims 16-256,
               kv_len inside one tile and Dk != Dv.  The routed expert
               FFN ("moe_experts" rows) runs one MoE layer's decode call of
               each benchmark cell (Phi-3.5-MoE, DeepSeek-V3: full widths,
               4 instances of M = 8 and 16 slots, the idle slots one row)
               in both types, beside its bound (the reached experts'
               weights once, rows in and out), its plain version and the
               bmm path over the capacity bins that it replaces.
  3. engine  — full-width TinyLlama-1.1B (random float32 weights, seed 0)
               through NanoCPEngine on a virtual (I=4, TP=2) mesh, pipelined
               and not.  Every engine run replays one CUDA graph per bucket
               (``core/aot.py``) unless it is the eager recorder run, the
               only one whose step the Python recorders can see (largest
               paged call, expert loads and routes).  Each model's (4, 2)
               runs go both ways ("parity" rows): the pipelined graph run
               gives the recorder run's tokens and bit-equal step logits,
               the non-pipelined one its tokens; the recorder run's
               transcripts are checked teacher-forced against the port's
               greedy forward on the card.  Launch counters are zeroed
               right before each run and read right after (a replay counts
               the launches its graph recorded).
  4. profile — a pipelined run each way: torch.profiler over 5 steady
               steps (device time by kernel, busy share, kernels and host
               launch calls per step), the unprofiled steady steps after
               them timed, and the paged kernel re-checked and re-timed on
               the largest call the main path made; then one prefill
               forward of the 2000-token prompt profiled (device time, the
               flash kernel's share).  A "graphs" row per model sets the
               numbers of both ways side by side with the card's name and
               power limit.
  5. quant   — the same engine and traffic with fp8, then int8 KV pools
               (codes plus per-page scales), pipelined, held to the
               reference's tolerance contract against the greedy forward
               teacher-forced on the engine's transcript: |dlogit| <= 1.5
               (fp8) / 0.5 (int8) at every decode step, an argmax miss only
               where the reference's top-2 margin is within that bound, such
               near-ties at most half the steps.  Every paged launch must be
               the quantized variant.  The quantized kernel is re-checked and
               re-timed on the largest call each run made.
  6. escalate — fp8 pools, one 40-token prompt decoding 24 tokens across a
               CP bucket edge at 48 on a (2, 2) mesh: the live re-shard moves
               quantized KV with its scales; the same contract holds.
  7. dense   — the main path's traffic with the dense all-gather backend
               (``backend="dense"``, both ways) beside its routed twin, the
               pipelined graph run of phase 3, both keeping their step
               logits: the tokens must be equal, the logits within 1e-4.
  8. spill   — TinyLlama on a (2, 2) mesh with a pool of a few pages per
               instance: the scheduler's own escalation off, so decode
               growth spills at table lowering and the engine's spill
               relief escalates the KV (``spill_escalations`` >= 1, tokens
               equal greedy); then a pool the whole node outgrows: a
               request-level OOM finish (``GenResult.oom``, tokens a prefix
               of greedy).  Then the main path's traffic at (4, 2) with one
               ``drain_instance`` and one ``compact`` mid-run (transcripts
               equal greedy, both counted).
  8b. chaos  — TinyLlama at (4, 2) with graphs: a kill between dispatch and
               harvest (recovered transcripts greedy), a kill then a join
               with prewarm (pools bit-equal across the prewarm;
               ``online_compiles`` flat after the join; a second cell where
               escalation recruits the joiner and a prewarmed graph
               replays), and a forced drain (fail semantics, a degraded
               greedy prefix).  No frame leaks.
  8c. serve  — TinyLlama, graphs on, pipelined: six requests sharing a
               1024-token prefix (staggered arrivals) with the prefix
               cache on and off, twice each way (equal greedy tokens; the
               cache hits and scatters fewer tokens; prefill ms per
               request, the forward covering the whole prompt either way);
               a fork mid-decode with a forced divergence token (both
               lineages greedy); pools of 12 frames at (2, 2) where spill
               relief evicts cache frames before any escalation; a crash
               of the instance holding the shared frames (both owners
               re-prefill); the reference's SLO cells shed, reject,
               preempt and parity on the virtual model clock
               (``slo.run_engine_clocked``: arrivals and deadlines in
               modeled iterations of the port's latency model, whose
               seconds are modeled, not the card's; one typed outcome per
               request, dropped requests token-free, parity with the
               simulator); and two prefill cells at (6, 1) streaming the
               main path's prompts in 256-token chunks, with and without
               a crash of the streaming cell, beside the colocated engine
               (equal tokens; no prefill cell in a decode binding), whose
               eager run gives the paged kernel's call at TP 1 (G 8) to
               check and time.  The prefix cache (cache on) and the
               prefill cells (no crash) also run with fp8 pools, held to
               phase 5's tolerance contract instead of token equality
               (the cache's hits and scatters equal float32's; every
               paged launch on fp8 pages).  Every cell: no frame leaked,
               no pool moved, each bucket's graph captured once and replayed
               under its in-place audit.  The TinyLlama weights are then
               freed.  (MiniCPM3-4B's prefill-cell cell runs in phase 9.)
  9. mla     — full-width MiniCPM3-4B (62 layers, random float32 weights,
               seed 0) through the engine: the main path's traffic at
               (I=4, TP=2) pipelined and not, at (2, 4) pipelined; fp8 and
               int8 latent pools at (4, 2) under the tolerance contract; the
               reference's ``mla`` escalation cell at (2, 2) with float32
               and fp8 pools.  Float32 transcripts are checked
               teacher-forced, as in phase 3.  Then the profile of phase 4
               at (4, 2), and the paged kernel re-checked and re-timed on
               the largest call the float32 and fp8 runs made (f32 and
               bf16 q), its bound counting the latent row once (v is the
               view k[..., :256] of the same bytes); the serve phase's
               MiniCPM3 cell: two prefill cells at (8, 1) over two nodes
               of 4, 32-token chunks, equal to the colocated engine and
               greedy.  Its weights are then freed.
 10. moe     — full-width Phi-3.5-MoE (8 of 32 layers, 16 experts top-2 of
               expert d_ff 6400, random float32 weights, seed 0, capacity
               factor 8.0: no token dropped) through the engine: the main
               path's traffic at (4, 2) pipelined and not and at (2, 4)
               pipelined, checked teacher-forced as in phase 3, with the
               rows per MoE binding (B_s) and the capacity C of every step.
               Then the profile of phase 4 at (4, 2), with the device time
               of the expert ``bmm``s, of the all-to-all index ops
               (dispatch and combine) and of routing, and the paged kernel
               re-checked and re-timed on the largest call the runs made.
 10b. examples — the entry points of ``examples/torch_*.py``: the serve
               example's ``run`` on the moe phase's weights (its config is
               that phase's: Phi-3.5-MoE, 8 of 32 layers, capacity factor
               8), with the example's engine arguments ((4, 2), 2,048 KV
               tokens per instance, ``ShapeBuckets((1, 2, 4), (0, 1, 2,
               4), window=4)``) and traffic (six prompts, 6 new tokens):
               greedy teacher-forced but for near-ties below GAP_TOL, both
               kernels launched (paged once per attention layer and step,
               flash once per attention layer and prompt), no frame
               leaked; its graph step ms and decode tokens/s.  Then the
               quickstart's ``run``: reduced TinyLlama (bf16, its 60 steps
               at lr 1e-2, a checkpoint every 10; the loss descends from
               step 0 to 50, latest checkpoint 50), and full-width
               TinyLlama-1.1B (f32, B 8 x S 64, 2 microbatches, lr 3e-5,
               10 steps): one step's gradients with 2 microbatches equal
               those with 1 within 1e-4 x max|g| per leaf; the loss of a
               fixed held-out batch, taken after each step, descends at
               every step (each step's own loss is on a fresh batch of
               512 tokens, whose noise is larger than a step's gain at
               this rate: it must only end below where it started); the
               flash kernel launched for every forward and remat
               recompute.  One row per run with the card's name and power
               limit, launches, step ms or tokens/s, and peak GB.
 11. qwen    — full-width Qwen1.5-0.5B (24 layers, q/k/v biases, tied
               embeddings, vocab 151,936; one q head per kv head) at (4, 2)
               pipelined and not and at (2, 4), checked teacher-forced.
               Each of phases 11-13 starts from ``init_params(seed=0)``
               with every bias drawn anew from N(0, 0.5) and every q/k
               norm scale from 1 + N(0, 0.3) (seeded), so that a dropped
               branch shows, and ends with the profile of phase 4 and the
               paged kernel re-checked and re-timed on the largest call the
               main path made.  Init and run peak memory, pool bytes, step
               ms, tokens/s, prefill ms and launches are in its rows.
 12. llama4  — Llama-4-Scout at full width, 4 of its 48 layers (qk-norm,
               16 experts top-1 plus a shared one, capacity factor 16), the
               same three runs; every MoE call's fullest bin against its
               capacity C at every prefill and decode step (a dropped token
               fails the run; all MoE phases).
 13. deepseek — DeepSeek-V3 at full width, 1 of its 60 layers (MLA with a
               576-wide latent at G 128, 256 experts top-8 plus a shared
               one, capacity factor 32): (4, 2) pipelined and not and
               (2, 4) pipelined, then fp8 and int8 latent pools under the
               tolerance contract, where a decode step whose router chose
               other experts than the forward's is counted, not held
               (``quant_contract``).
 14. ssm     — Mamba2-370M at full depth (48 SSD layers, no attention, no
               FFN: no pools and no kernel launch; DCP is inapplicable and
               placement is batch balance) and Jamba-v0.1 at full width,
               8 of its 32 layers (one period: 7 SSD layers, attention at
               layer 4, MoE on the odd layers, capacity factor 8), the SSD
               vectors of ``init_params(seed=0)`` perturbed (seeded).  Both
               pin SSM_SLOTS slots per instance.  Each runs the main path's
               traffic at (4, 2) both ways with the profiles (the eager one
               splits the step's device time into SSD layers, attention,
               MoE experts and the rest by ``record_function`` ranges), and
               the 2000-token prefill with its SSD scan's share.  Mamba2
               runs the reference's ``refusal`` cell at (2, 2): the drain
               raises ``UnsupportedDrainError`` and changes nothing, a crash
               degrades only the requests whose slot it held.  Jamba runs
               (2, 4) with graphs, and its paged call (G 4 over 4 kv heads
               of 128 per device) and prefill attention (32 q / 8 kv heads,
               S 2000) are re-checked and timed at the main path's inputs.
 15. whisper — whisper-base at full width and depth (6 encoder + 6
               decoder layers, d 512, 8 heads of 64, vocab 51,865; the
               conv/mel frontend a stub: frame embeddings in), random
               float32 weights (seed 0) with every q/k/v, MLP and layernorm
               bias drawn from N(0, 0.5) and every layernorm scale from
               1 + N(0, 0.3).  Six audio requests of 1500 (twice: one
               batched encode), 750, 300, 120 and 40 frames, each with a
               4-token decoder prefix and 16 new tokens, SSM_SLOTS pinned
               slots per instance; at (4, 2) the 1500-frame requests'
               cross-attention KV spreads over CP degree 3.  The (4, 2)
               runs go both ways with their profiles, then (2, 4) with
               graphs; every transcript equals greedy ``encode`` +
               ``decode_forward`` teacher-forced, the cross pools are
               bit-equal before and after the decode steps (read-only), no
               frame is left held, and flash launches split by mask kind
               (encoder "full", decoder "causal", "cross").  A crash cell
               at (4, 2) (graphs on): an instance holding a shard of
               request 0's cross KV dies after two steps; the requests it
               held finish degraded (never re-prefilled) with a greedy
               prefix, the others in full, the cross pools bit-equal, no
               frame held.  The prefill's encode and decoder-prefix device
               times per request, and the paged kernel (G 1, hd 64,
               read-only pools) and flash (the encoder's non-causal S
               1500, the cross-attention's Sq 4 x Skv 1500) re-checked and
               timed at the main path's inputs.
 16. train   — the flash op under autograd (the kernel forward, the
               ported ``flash_backward``) against autograd through the plain
               version at TinyLlama's train call (B 4 x S 2048), TinyLlama's
               and MiniCPM3's 2000-token prefill, whisper's encoder and a
               256 x 1500 cross-attention call, f32 and bf16, timed beside
               SDPA forward + backward and the bounds; full-width
               TinyLlama-1.1B (f32 weights, seed 0, ``SyntheticTokens`` B 4 x
               S 2048, seed 0) for 5 AdamW steps under remat "dots" (finite,
               descending losses, 44 flash launches a step), an
               ``AsyncCheckpointer`` save after step 3 resumed from disk into
               fresh tensors for steps 4-5 (equal losses, bit-equal
               parameters); one value-and-grad from the final state under
               "full", "dots" and "none" (equal losses, peak memory in that
               order); the kernel path against ``FORCE_IMPL = "ref"`` at B 1
               x S 2000 under "full" (loss 1e-5 relative, every leaf 1e-3 of
               its largest entry); bf16 weights with f32 moments for 5 steps
               and one profiled (flash's share of device time); one bf16
               train step of each of the 11 reduced configs, their f32 loss
               on the card within 1e-4 of the CPU's.
 17. launch  — the launch layer.  Its dry run (every assigned config and
               DeepSeek-V3 at each applicable shape, single pod, on the
               meta device: ``python -m repro_torch.launch.dryrun``) runs
               in six processes at once while the card idles; every cell
               must pass and the device allocator must not move.  Then three decode cells
               built by ``launch.cells.build_decode_cell`` on the virtual
               production mesh (I 16, TP 16) and materialised on the card
               (bf16 ``init_params(seed=0)``, seeded pools, the planner's
               tables): (a) TinyLlama-1.1B at 524,288 tokens x 2 requests
               (CP 8, 13 routing rounds), (b) TinyLlama ``decode_32k`` cut
               from 128 requests to 32 (CP 1; 128 need 108.6 GB of bf16
               pools), (c) DeepSeek-V3 (1 of 60 layers) at 524,288 x 2.
               Each runs bf16 and fp8 weights (``quantize_decode_weights``,
               cast to bf16 at use), (a) also raw fp8 pools without
               scales.  Gates per run: every paged call within 2e-2 x
               max|ref| of its plain version on the same inputs; the
               step's logits within 2e-2 x max|ref| of its ``FORCE_IMPL =
               "ref"`` twin, or within twice the step's own noise floor
               where that is larger (the plain step against itself with
               its attention outputs moved by about one bf16 ulp: 3.5-4.1%
               on TinyLlama's 22 bf16 layers); tokens equal but for
               near-ties; the model's attention layers in paged launches,
               pools written in place, the step repeated and a CUDA graph
               replay bit-equal to eager, and fp8 weights bit-equal to the
               same weights dequantized before the step.
               Rows: eager and replayed step ms, weight and pool bytes,
               peak GB, fp8's |dlogit| and token agreement against bf16,
               and the paged kernel at the cell's call (kernel, bound and
               plain ms).
 18. summary — the script's seconds, ``{"kernels": [...]}`` (with the
               flash op's row on the train path, its backward in the
               ``bwd_*`` keys, and the launch cells' paged rows), then the
               last line ``{"ok": true, "device": {...}}``.

The kernel phase also holds the paged kernel at MLA's latent shape (G 40
q heads over one latent head of Dk 288, Dv 256 as a view; f32/bf16 q,
f32/bf16/fp8/int8 pages; edge rows with zero-length rows, MB = 1 and a
split boundary) and flash at MLA's prefill shape (40 heads, Dk 96, Dv 64,
S 2000); both at Phi-3.5-MoE's head of 128 (paged G 4 over 4 kv heads
per device; flash 32 q / 8 kv heads, S 2000, timed; edge rows with split
boundaries, fp8 pages and ragged tails); and both at DeepSeek-V3's shapes
(paged over the 576-wide latent, v = k[..., :512], G 128 in four head
groups, f32/bf16/fp8/int8 pages, timed; flash at 128 heads of Dk 192 /
Dv 128, S 2000, timed), with edge rows at head-group boundaries (G 32,
33, 64, 128), Qwen1.5's G 1 of hd 64, and flash at DeepSeek-V3's,
Qwen1.5's and Llama-4-Scout's prefill heads; and whisper's edges: the
paged kernel at G 1 over 4 kv heads of 64 (split edges, MB = 1) with the
pools checked unchanged, non-causal flash at Sq 4 x Skv 1500 and 130 with
kv_len inside a tile, and at Sq = Skv = 1500 with ragged kv_len.

Any failed check exits non-zero before the last line.  Without CUDA, or
without the repository's ``src/`` beside it, the script fails.
"""
from __future__ import annotations

import atexit
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
             "False); this script only runs on the GPU")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import models  # noqa: E402
from repro_torch.configs import (ASSIGNED, CONFIGS, SHAPES,  # noqa: E402
                                 ShapeCfg, applicable_shapes, get_config,
                                 reduced)
from repro_torch.core import dcp, moe_parallel, routing  # noqa: E402
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets  # noqa: E402
from repro_torch.core.scheduler import (AdmissionController,  # noqa: E402
                                        DualBalancedScheduler, _mk_plan)
from repro_torch.kernels import build, ops, quant, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_experts  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import cells as launch_cells  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models import encdec, moe, ssm, transformer  # noqa: E402
from repro_torch.serving import slo  # noqa: E402
from repro_torch.serving.engine import (NanoCPEngine,  # noqa: E402
                                        UnsupportedDrainError)
from repro_torch.serving.simulator import ClusterSimulator  # noqa: E402
from repro_torch.serving.workload import TraceRequest, Workload  # noqa: E402
from repro_torch.training import (checkpoint, data, optimizer,  # noqa: E402
                                  train_step)
from repro_torch.training.tree import leaves, map_tree  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, and the peak
# operation rate for the inputs' type (f32 outside the tensor cores, bf16
# tensor cores).  A quantized paged call takes its products in q's type.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DEV = torch.device("cuda")

PROMPT_LENS = (50, 300, 120, 40, 200, 2000)
NEW_TOKENS = 16
# MiniCPM3-4B's decode latent: kv_lora 256 + rope 32, v the first 256 dims;
# 40 q heads on the one latent head; prefill q/k 96 (nope 64 + rope 32), v 64
MLA_G, MLA_DK, MLA_DV = 40, 288, 256
MLA_SCALE = (64 + 32) ** -0.5
# DeepSeek-V3's: kv_lora 512 + rope 64, v the first 512 dims, 128 q heads on
# the one latent head (four head groups of 32); prefill q/k 192 (nope 128 +
# rope 64), v 128
DS_G, DS_DK, DS_DV = 128, 576, 512
DS_SCALE = (128 + 64) ** -0.5
DENSE_LOGIT_TOL = 1e-4
# the reference's quantized-serving contract (tests/integration/engine_quant.py)
LOGIT_TOL = {"fp8": 1.5, "int8": 0.5}
CAPTURE_STEPS = 4     # steps whose paged calls are inspected (they sync)
GAP_TOL = 1e-4        # teacher-forced argmax ties tolerated below this gap
PROFILE_STEPS = 5
# Phi-3.5-MoE on one 80 GB card: 8 of its 32 layers (a layer is 1.30e9
# float32 parameters, 5.2 GB), capacity factor 8 so that no token drops
PHI_LAYERS = 8
PHI_CAPACITY_FACTOR = 8.0
JAMBA_LAYERS = 8                # one period: 7 SSD + 1 attention, 4 MoE
JAMBA_CAPACITY_FACTOR = 8.0     # E/k: no token dropped
SSM_SLOTS = 4                   # slots per instance of the SSM models and
                                # whisper (the reference's SSM and whisper
                                # cells' one M bucket)
# whisper's audio: 1500 frames is its 30-second window (twice, so that the
# admission batches an encode); 4-token decoder prefixes
WHISPER_FRAMES = (1500, 1500, 750, 300, 120, 40)
WHISPER_PREFIX = 4
# Llama-4-Scout: 4 of its 48 layers (a layer is 2.2e9 float32 parameters,
# 8.8 GB); capacity factor E/k = 16, so C >= T and no token drops.
# DeepSeek-V3: 1 of its 60 layers (its 256 experts are 45.1 GB in float32);
# capacity factor E/k = 32: decode rows of an instance never drop (C = M;
# at 8, C = ceil(M/4) = 1 would drop whenever two of an instance's rows
# share one of their 8 experts), and prefill runs only the filled slots of
# its C = T bins (``moe.moe_ffn``)
LLAMA4_LAYERS, LLAMA4_CAPACITY_FACTOR = 4, 16.0
DS_LAYERS, DS_CAPACITY_FACTOR = 1, 32.0
# the phases' overwrite of the init's zero biases and unit q/k norm scales,
# so that a dropped branch shows: N(0, BIAS_STD), 1 + N(0, NORM_STD)
BIAS_STD, NORM_STD = 0.5, 0.3
SHIELD_CYCLES = 4_000_000   # about 2 ms of device spin at the H100's clocks


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke.py: FAIL: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #
_FLUSH = None


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn`` (CUDA events), with the 50 MB L2 cache
    flushed before every timed launch, as the decode step finds it after
    the other layers' weights went through.  A spin kernel of about 2 ms
    runs before the start event, so the host has enqueued all of ``fn``
    (wrapper checks, allocation, launch) before the device reaches it: the
    events then time device work only, not the host's launch overhead."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _FLUSH.zero_()
        torch.cuda._sleep(SHIELD_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_close(name, got, want, dtype) -> float:
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err}, tolerance {tol})")
    return err


# --------------------------------------------------------------------------- #
# phase 2: kernels vs plain versions
# --------------------------------------------------------------------------- #
def paged_inputs(dtype, gen, kg: int = 2, hd: int = 64, G: int = 8):
    """The main path's paged call: TinyLlama at (I=4, TP=2) — every virtual
    device's rows in one launch, pools flattened to I*tp*F' pages of 16
    tokens, kg = 2 kv heads of hd 64 per device, G = 8 q heads per kv head;
    shard lengths up to ~700 tokens (a 2000-token prompt over three
    instances) and zero-length padding rows.  Phi-3.5-MoE's call at the
    same mesh has kg = 4 kv heads of hd 128 and G = 4."""
    I, tp, Fp, page = 4, 2, 257, 16
    rows, MB = 64, 44
    P = I * tp * Fp
    q = torch.randn(rows, kg * G, hd, device=DEV, generator=gen).to(dtype)
    k = torch.randn(P, page, kg, hd, device=DEV, generator=gen).to(dtype)
    v = torch.randn(P, page, kg, hd, device=DEV, generator=gen).to(dtype)
    lengths = torch.randint(1, 701, (rows,), device=DEV, generator=gen,
                            dtype=torch.int32)
    lengths[::4] = 0
    # each row reads pages of its own device's sub-pool
    dev_of = torch.randint(0, I * tp, (rows, 1), device=DEV, generator=gen)
    bt = (torch.randint(0, Fp - 1, (rows, MB), device=DEV, generator=gen)
          + dev_of * Fp).to(torch.int32)
    return q, k, v, bt, lengths


def quantize_pages(args, kv_dtype):
    """The float pages of a paged call as codes with per-page scales.  A
    latent pool (v a view of k) stays one pool with one scale per page."""
    q, k, v, bt, lengths = args[:5]
    qk = []
    for x in ((k,) if shares_storage(k, v) else (k, v)):
        sc = quant.amax_scale(x.float().reshape(x.shape[0], -1), kv_dtype)
        qk += [quant.quantize(x, sc[:, None, None, None], kv_dtype), sc]
    if len(qk) == 2:
        return (q, qk[0], qk[0][..., :v.shape[-1]], bt, lengths, qk[1], qk[1])
    return (q, qk[0], qk[2], bt, lengths, qk[1], qk[3])


def as_bf16_call(args):
    """A paged call's inputs with bfloat16 q, and bfloat16 pages where they
    are float (keeping v a view of k where it was one)."""
    q, k, v, bt, lengths, *scales = args
    if not k.is_floating_point() or k.element_size() == 1:
        return (q.to(torch.bfloat16), k, v, bt, lengths, *scales)
    kb = k.to(torch.bfloat16)
    vb = kb[..., :v.shape[-1]] if shares_storage(k, v) else v.to(torch.bfloat16)
    return (q.to(torch.bfloat16), kb, vb, bt, lengths)


def mla_paged_inputs(dtype, gen, G=MLA_G, Dk=MLA_DK, Dv=MLA_DV):
    """MLA's paged call at MiniCPM3-4B's width on the (I=4, TP=2) mesh: one
    latent pool of I*tp*F' = 8 * 129 pages of 16 tokens x 288, v its first
    256 dims as a view, G = 40 q heads on the one latent head; a row's
    stripe holds up to ~350 tokens (a 2000-token prompt over three
    instances, striped over two devices), and every fourth row is empty.
    DeepSeek-V3's: G 128, Dk 576, Dv 512."""
    rows, MB, P = 64, 24, 8 * 129
    q = torch.randn(rows, G, Dk, device=DEV, generator=gen).to(dtype)
    k = torch.randn(P, 16, 1, Dk, device=DEV, generator=gen).to(dtype)
    lengths = torch.randint(1, 351, (rows,), device=DEV, generator=gen,
                            dtype=torch.int32)
    lengths[::4] = 0
    bt = torch.randint(0, P, (rows, MB), device=DEV, generator=gen,
                       dtype=torch.int32)
    return q, k, k[..., :Dv], bt, lengths


def shares_storage(a, b) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def paged_cost(q, k, v, bt, lengths, k_scale=None, v_scale=None):
    """Bytes the call must move (only the valid tokens' K/V, and for a
    quantized pool the scales of every page a row reads) and its flops.
    Where v is a view of k (MLA's latent) each token's row, and each
    page's one scale, counts once."""
    Hkv, Dk, Dv, page = k.shape[2], k.shape[3], v.shape[3], k.shape[1]
    Hq = q.shape[1]
    toks = int(lengths.sum())
    latent = shares_storage(k, v)
    kv_bytes = toks * Hkv * (Dk if latent else Dk + Dv) * k.element_size()
    if k_scale is not None:
        kv_bytes += ((1 if latent else 2) * 4
                     * int(((lengths + page - 1) // page).sum()))
    out_bytes = q.shape[0] * Hq * (Dv * q.element_size() + 4)
    by = nbytes(q, bt, lengths) + kv_bytes + out_bytes
    return by, 2.0 * toks * Hq * (Dk + Dv)


def flash_cost(q, k, v, kv_len, q_offset, causal=True):
    B, Sq, Hq, Dk = q.shape
    Dv = v.shape[-1]
    kl = int(kv_len[0]) if kv_len is not None else k.shape[1]
    pairs = (sum(min(r + q_offset + 1, kl) for r in range(Sq)) if causal
             else Sq * kl)
    by = nbytes(q, k, v) + B * Sq * Hq * (Dv * q.element_size() + 4)
    return by, 2.0 * B * Hq * pairs * (Dk + Dv)


def paged_variant(k, v=None) -> str:
    """The kernel's name in the summary: ``_mla`` where v is a view of k
    (the latent pool), then its page type when quantized."""
    mla = "_mla" if v is not None and shares_storage(k, v) else ""
    return "paged_decode" + mla + {torch.float8_e4m3fn: "_fp8",
                                   torch.int8: "_int8"}.get(k.dtype, "")


def paged_row(args, dtype, label: str, scale=None, name=None) -> dict:
    """Hold the paged kernel against its plain version on ``args`` (q, k, v,
    block tables, lengths[, k_scale, v_scale]) and time both; returns the
    phase's JSON row.  ``dtype`` is q's type, which sets the tolerance;
    ``name`` overrides the variant's summary name."""
    dn = str(dtype).replace("torch.", "")
    q, k, v, bt, lengths = args[:5]
    kw = {} if len(args) == 5 else {"k_scale": args[5], "v_scale": args[6]}
    kw["scale"] = scale
    name = name or paged_variant(k, v)
    o, l = pa.paged_decode_attention(q, k, v, bt, lengths, **kw)
    o2, l2 = ref.paged_decode_attention(q, k, v, bt, lengths, **kw)
    torch.cuda.synchronize()
    err = max(check_close(f"{name} {dn} {label} out", o, o2, dtype),
              check_close(f"{name} {dn} {label} lse", l, l2, dtype))
    ms = time_ms(lambda: pa.paged_decode_attention(q, k, v, bt, lengths, **kw))
    plain = time_ms(lambda: ref.paged_decode_attention(q, k, v, bt, lengths,
                                                       **kw))
    b, f = paged_cost(*args)
    bms, by = bound_ms(b, f, dtype)
    return {"phase": "kernel", "name": name, "dtype": dn,
            "page_dtype": str(k.dtype).replace("torch.", ""), "inputs": label,
            "shape": {"rows": q.shape[0], "Hq": q.shape[1], "Hkv": k.shape[2],
                      "hd": q.shape[2], "dv": v.shape[3], "page": k.shape[1],
                      "pages": k.shape[0], "max_len": int(lengths.max()),
                      "kv_tokens": int(lengths.sum()),
                      "zero_rows": int((lengths == 0).sum())},
            "max_abs_err": err, "tol": TOL[dtype], "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "share_of_bound": bms / ms, "library_ms": None}


def flash_row(name: str, q, k, v, kl, qo, timed: bool,
              causal: bool = True) -> dict:
    """Hold flash against its plain version on (q, k, v, kv_len, q_offset),
    causal or not; with ``timed`` also time kernel, plain version and SDPA
    (where SDPA takes the shape), beside the bound."""
    dtype = q.dtype
    dn = str(dtype).replace("torch.", "")
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    o, l = fa.flash_attention(q, k, v, kv_len=kl, q_offset=qo, causal=causal)
    o2, l2 = ref.flash_attention(q, k, v, kv_len=kl, q_offset=qo,
                                 causal=causal)
    torch.cuda.synchronize()
    err = max(check_close(f"{name} {dn} Sq={Sq} out", o, o2, dtype),
              check_close(f"{name} {dn} Sq={Sq} lse", l, l2, dtype))
    row = {"phase": "kernel", "name": name, "dtype": dn,
           "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq, "Hkv": Hkv,
                     "hd": Dk, "dv": Dv,
                     "kv_len": None if kl is None else kl.tolist(),
                     "q_offset": qo, "causal": causal},
           "max_abs_err": err, "tol": TOL[dtype]}
    if timed:
        row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
        row["plain_ms"] = time_ms(lambda: ref.flash_attention(q, k, v,
                                                              causal=causal))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv)
        try:
            sdpa()
            torch.cuda.synchronize()
        except RuntimeError as exc:       # the yardstick, not the port
            row["library_ms"], row["library_error"] = None, str(exc)[:200]
        else:
            row["library_ms"] = time_ms(sdpa)
        b, f = flash_cost(q, k, v, kl, qo, causal)
        row["bound_ms"], row["bound_by"] = bound_ms(b, f, dtype)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    emit(row)
    return row


# one MoE layer's decode call of each benchmark cell: (experts, top k, D,
# F, live rows an instance) at 4 instances of M slots, the rest idle
MOE_EXPERT_CELLS = {"phi35moe": (16, 2, 4096, 6400, 7),
                    "dsv3": (256, 8, 7168, 2048, 8)}


def moe_experts_weights(cell: str, dtype) -> dict:
    E, _, D, F, _ = MOE_EXPERT_CELLS[cell]
    g = torch.Generator(device=DEV).manual_seed(E)
    return {n: torch.randn(shape, device=DEV, generator=g,
                           dtype=dtype).mul_(shape[1] ** -0.5)
            for n, shape in (("wi_gate", (E, D, F)), ("wi_up", (E, D, F)),
                             ("wo", (E, F, D)))}


def moe_experts_row(cell: str, M: int, p: dict) -> dict:
    """Hold the routed expert kernel against its plain version on one MoE
    layer's decode call (live rows random, the idle slots one row, routed
    by a random router at capacity C = M, as the cells' E/k capacity
    factor makes it) and time it beside its bound (each reached expert's
    weights once, the rows in and out), the plain version and the bmm
    path over the capacity bins (dispatch, three bmm, combine), which it
    replaces on the card."""
    E, k, D, F, live = MOE_EXPERT_CELLS[cell]
    I = 4
    dtype = p["wi_gate"].dtype
    dn = str(dtype).replace("torch.", "")
    g = torch.Generator(device=DEV).manual_seed(M)
    x = torch.randn(I, M, D, device=DEV, generator=g)
    x[:, live:] = x[0, 0]
    router = torch.randn(D, E, device=DEV, generator=g) * D ** -0.5
    w, idx = moe.router_topk(SimpleNamespace(num_experts_per_tok=k), router, x)
    src, slot_of = moe.group_by_expert(idx, E, M)
    x = x.to(dtype)
    fill = torch.empty((I, E), dtype=torch.int32, device=DEV)
    got = moe_experts.routed_experts(p, x, w, src, slot_of, fill)
    want = moe_experts.plain(p, x, w, src, slot_of)
    torch.cuda.synchronize()
    err = check_close(f"moe_experts {cell} {dn} M={M}", got, want, dtype)
    rows, touched = int(fill.sum()), int((fill.sum(0) > 0).sum())

    def bmm():
        out = moe.expert_ffn(p, moe_parallel._dispatch(x, src, E // I))
        return moe.combine(w, moe_parallel._combine(out, I), slot_of)
    torch.cuda.synchronize()
    check_close(f"moe_experts bmm path {cell} {dn} M={M}", bmm(), want, dtype)
    ms = time_ms(lambda: moe_experts.routed_experts(p, x, w, src, slot_of))
    plain_ms = time_ms(lambda: moe_experts.plain(p, x, w, src, slot_of),
                       iters=3, warmup=1)
    bmm_ms = time_ms(bmm, iters=3, warmup=1)
    es = x.element_size()
    b, f = touched * 3 * D * F * es + 2 * nbytes(x), 2 * 3 * D * F * rows
    bms, by = bound_ms(b, f, dtype)
    return {"phase": "kernel", "name": "moe_experts", "cell": cell,
            "dtype": dn, "inputs": "cell's decode call",
            "shape": {"I": I, "M": M, "E": E, "k": k, "D": D, "F": F,
                      "live_rows": I * live, "routed_rows": rows,
                      "padded_rows": E * I * M, "experts_touched": touched,
                      "largest_bin": int(fill.sum(0).max())},
            "max_abs_err": err, "tol": TOL[dtype], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "share_of_bound": bms / ms, "library_ms": bmm_ms,
            "library": "bmm over the capacity bins (the path it replaces)"}


def run_moe_experts_rows() -> list:
    rows = []
    for cell in MOE_EXPERT_CELLS:
        for dtype in (torch.float32, torch.bfloat16):
            p = moe_experts_weights(cell, dtype)
            for M in (8, 16):
                row = moe_experts_row(cell, M, p)
                emit(row)
                rows.append(row)
            del p
            free_memory()
    return rows


def run_kernel_phase(gen) -> dict:
    summary = {}

    def add(row):
        emit(row)
        summary.setdefault(row["name"], []).append(row)

    for dtype in (torch.float32, torch.bfloat16):
        # --- paged decode: pages in q's type, then fp8 and int8 codes ---
        args = paged_inputs(dtype, gen)
        for a in (args, quantize_pages(args, "fp8"),
                  quantize_pages(args, "int8")):
            add(paged_row(a, dtype, "synthetic"))
        # --- flash forward ---
        for Sq, kvl, qo in ((50, None, 0), (300, None, 0), (2000, None, 0),
                            (300, 200, 0), (256, None, 100)):
            Skv = Sq + qo
            q = torch.randn(1, Sq, 32, 64, device=DEV, generator=gen).to(dtype)
            k = torch.randn(1, Skv, 4, 64, device=DEV, generator=gen).to(dtype)
            v = torch.randn(1, Skv, 4, 64, device=DEV, generator=gen).to(dtype)
            kl = (None if kvl is None else
                  torch.tensor([kvl], dtype=torch.int32, device=DEV))
            summary.setdefault("flash_fwd", []).append(
                flash_row("flash_fwd", q, k, v, kl, qo,
                          timed=(Sq, kvl, qo) == (2000, None, 0)))
        # --- MLA: the latent paged call, and the materialised prefill ---
        args = mla_paged_inputs(dtype, gen)
        for a in (args, quantize_pages(args, "fp8"),
                  quantize_pages(args, "int8")):
            add(paged_row(a, dtype, "synthetic", scale=MLA_SCALE))
        q = torch.randn(1, 2000, 40, 96, device=DEV, generator=gen).to(dtype)
        k = torch.randn(1, 2000, 40, 96, device=DEV, generator=gen).to(dtype)
        v = torch.randn(1, 2000, 40, 64, device=DEV, generator=gen).to(dtype)
        summary.setdefault("flash_fwd_mla", []).append(
            flash_row("flash_fwd_mla", q, k, v, None, 0, timed=True))
        # --- Phi-3.5-MoE's prefill attention: 32 q / 8 kv heads of 128 ---
        q = torch.randn(1, 2000, 32, 128, device=DEV, generator=gen).to(dtype)
        k = torch.randn(1, 2000, 8, 128, device=DEV, generator=gen).to(dtype)
        v = torch.randn(1, 2000, 8, 128, device=DEV, generator=gen).to(dtype)
        summary.setdefault("flash_fwd_moe", []).append(
            flash_row("flash_fwd_moe", q, k, v, None, 0, timed=True))
    # --- DeepSeek-V3: the 576-wide latent call, and its prefill attention
    #     (128 heads, Dk 192, Dv 128); a generator of their own, so the
    #     rows above keep their inputs ---
    gen_ds = torch.Generator(device=DEV).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        args = mla_paged_inputs(dtype, gen_ds, DS_G, DS_DK, DS_DV)
        for a, sfx in ((args, ""), (quantize_pages(args, "fp8"), "_fp8"),
                       (quantize_pages(args, "int8"), "_int8")):
            add(paged_row(a, dtype, "synthetic", scale=DS_SCALE,
                          name="paged_decode_ds" + sfx))
        q = torch.randn(1, 2000, 128, 192, device=DEV, generator=gen_ds).to(dtype)
        k = torch.randn(1, 2000, 128, 192, device=DEV, generator=gen_ds).to(dtype)
        v = torch.randn(1, 2000, 128, 128, device=DEV, generator=gen_ds).to(dtype)
        summary.setdefault("flash_fwd_ds", []).append(
            flash_row("flash_fwd_ds", q, k, v, None, 0, timed=True))
        del q, k, v
    run_edge_checks(gen)
    run_wide_edge_checks()
    run_whisper_edge_checks()
    summary["moe_experts"] = run_moe_experts_rows()
    return summary


def edge_row(name: str, case: str, dtype, got, want) -> None:
    """Hold one edge case's (out, lse) against the plain version's."""
    dn = str(dtype).replace("torch.", "")
    torch.cuda.synchronize()
    err = max(check_close(f"{name} {dn} {case} out", got[0], want[0], dtype),
              check_close(f"{name} {dn} {case} lse", got[1], want[1], dtype))
    emit({"phase": "kernel-edge", "name": name, "dtype": dn, "case": case,
          "max_abs_err": err, "tol": TOL[dtype]})


def flash_edge(gen, dtype, B, Sq, Skv, Dk, Dv, kv_len=None, q_offset=0,
               causal=True, Hkv=4, Hq=32) -> None:
    """One flash edge case at ``Hq`` q / ``Hkv`` kv heads."""
    q = torch.randn(B, Sq, Hq, Dk, device=DEV, generator=gen).to(dtype)
    k = torch.randn(B, Skv, Hkv, Dk, device=DEV, generator=gen).to(dtype)
    v = torch.randn(B, Skv, Hkv, Dv, device=DEV, generator=gen).to(dtype)
    kl = (None if kv_len is None
          else torch.tensor(kv_len, dtype=torch.int32, device=DEV))
    kw = dict(causal=causal, kv_len=kl, q_offset=q_offset)
    edge_row("flash_fwd", f"B {B} Sq {Sq} Skv {Skv} Hq {Hq} Hkv {Hkv} Dk {Dk} Dv {Dv} "
             f"kv_len {kv_len} q_offset {q_offset} causal {causal}", dtype,
             fa.flash_attention(q, k, v, **kw), ref.flash_attention(q, k, v, **kw))


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def split_edges(args, label, kvs, dtype):
    """Rows on, one past and two splits past a split boundary, full rows
    between empty ones, and MB = 1; float pages, then ``kvs``.  Returns
    the inputs with their edited lengths."""
    q, k, v, bt, lengths = args
    N, MB, page = q.shape[0], bt.shape[1], k.shape[1]
    pps = pa.plan_split(N, k.shape[2], MB, _sms())
    edge = [pps * page, 2 * pps * page, pps * page + 1, MB * page, 0,
            MB * page, 0, 0, MB * page, 1]
    lengths[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device=DEV)
    full = (q, k, v, bt, lengths)
    one = (q, k, v, bt[:, :1], lengths.clamp(max=page))
    for kv in (None, *kvs):
        for case, a in ((f"{label}split edges (pps {pps})", full),
                        (f"{label}MB = 1", one)):
            a = a if kv is None else quantize_pages(a, kv)
            kw = {} if kv is None else {"k_scale": a[5], "v_scale": a[6]}
            edge_row(paged_variant(a[1]), case, dtype,
                     pa.paged_decode_attention(*a[:5], **kw),
                     ref.paged_decode_attention(*a[:5], **kw))
    return full


def latent_edge(dtype, case, args, scale, kv=None) -> None:
    """One latent-pool edge case (v a view of k), ``kv`` quantized or not;
    the plain version gets v as a copy."""
    a = args if kv is None else quantize_pages(args, kv)
    kw = {"scale": scale}
    if kv is not None:
        kw.update(k_scale=a[5], v_scale=a[6])
    edge_row(paged_variant(a[1], a[2]), case, dtype,
             pa.paged_decode_attention(*a[:5], **kw),
             ref.paged_decode_attention(*a[:2], a[2].contiguous(), *a[3:5],
                                        **kw))


def run_wide_edge_checks() -> None:
    """The edges of the shapes of DeepSeek-V3, Qwen1.5 and Llama-4-Scout,
    from a generator of their own: the 576-wide latent (v = k[..., :512],
    G 128 in four head groups) on split edges, MB = 1 and empty rows with
    f32/bf16 pages and fp8/int8 codes; head-group boundaries at G 32, 33,
    64 and 128; Qwen's G 1 of hd 64 (8 kv heads per device at (4, 2));
    flash at DeepSeek-V3's prefill heads (128, Dk 192 / Dv 128) causal with
    a q offset and a ragged tail, at Qwen's (16 of 64, MHA) and at
    Llama-4-Scout's (40 q / 8 kv of 128)."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bt, lengths = mla_paged_inputs(dtype, gen, DS_G, DS_DK, DS_DV)
        N, MB, page = q.shape[0], bt.shape[1], k.shape[1]
        gh = pa.plan_heads(DS_G, DS_DK, DS_DV, k.element_size(), True, MB)
        groups = -(-DS_G // gh)
        pps = pa.plan_split(N, groups, MB, _sms())
        edge = [0, pps * page, pps * page + 1, 2 * pps * page, MB * page, 0,
                1, page]
        lengths[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device=DEV)
        for kv in (None, "fp8", "int8"):
            latent_edge(dtype, f"DS Dk 576 split edges (pps {pps}, {groups} "
                        f"head groups of {gh})", (q, k, v, bt, lengths),
                        DS_SCALE, kv)
            latent_edge(dtype, "DS Dk 576 MB = 1",
                        (q, k, v, bt[:, :1], lengths.clamp(max=page)),
                        DS_SCALE, kv)
        # head-group boundaries on the latent view, full and empty rows
        for G in (32, 33, 64, 128):
            qg = torch.randn(12, G, DS_DK, device=DEV, generator=gen).to(dtype)
            ln = torch.tensor([0, 5 * page, 1, 3 * page + 7] * 3,
                              dtype=torch.int32, device=DEV)
            gh = pa.plan_heads(G, DS_DK, DS_DV, k.element_size(), True, 5)
            latent_edge(dtype, f"DS latent G {G} ({-(-G // gh)} head groups "
                        f"of {gh})", (qg, k, v, bt[:12, :5], ln), DS_SCALE,
                        None if dtype == torch.float32 else "fp8")
        # Qwen1.5 at (4, 2): 8 kv heads of 64 per device, G 1
        split_edges(paged_inputs(dtype, gen, kg=8, hd=64, G=1),
                    "Qwen G 1 hd 64 ", ("fp8",), dtype)
        flash_edge(gen, dtype, 1, 65, 129, 192, 128, q_offset=64, Hq=128,
                   Hkv=128)
        flash_edge(gen, dtype, 2, 150, 150, 192, 128, kv_len=[150, 77],
                   Hq=128, Hkv=128)
        flash_edge(gen, dtype, 1, 2001, 2001, 64, 64, Hq=16, Hkv=16)
        flash_edge(gen, dtype, 1, 200, 300, 128, 128, q_offset=100, Hq=40,
                   Hkv=8)


def run_whisper_edge_checks() -> None:
    """Whisper's shapes at their edges, from a generator of their own: the
    paged call at (4, 2) (4 kv heads of 64 per device, G 1) on split
    edges and MB = 1, float pages then fp8, with the pools bit-equal
    after the calls (the cross pools are read-only); non-causal flash at
    8 heads of 64 with Sq 4 against Skv 1500 and 130, kv_len inside a
    64-key tile, and the encoder's Sq = Skv = 1500 with a ragged kv_len."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bt, lengths = paged_inputs(dtype, gen, kg=4, hd=64, G=1)
        k0, v0 = k.clone(), v.clone()
        split_edges((q, k, v, bt, lengths), "whisper G 1 hd 64 read-only ",
                    ("fp8",), dtype)
        torch.cuda.synchronize()
        if not (torch.equal(k, k0) and torch.equal(v, v0)):
            fail("paged_decode: the kernel wrote its pools")
        for B, Sq, Skv, kv_len in ((2, 4, 1500, [1500, 37]),
                                   (1, 4, 130, [70]),
                                   (2, 1500, 1500, [1500, 1441])):
            flash_edge(gen, dtype, B, Sq, Skv, 64, 64, kv_len=kv_len,
                       causal=False, Hq=8, Hkv=8)


def run_edge_checks(gen) -> None:
    """The split-KV and tiled kernels at their edges, at the main path's
    widths (paged rows of 2 kv heads x G 8, hd 64; flash 32 q / 4 kv heads
    of 64): paged rows ending on a split boundary, spanning every split,
    zero rows between full ones, MB = 1, fp8/int8 through the split path,
    and v as a strided view of k at reduced MLA's head dims (40 / 32) and
    at MiniCPM3-4B's (288 / 256, G 40, f32/bf16/fp8 pages); flash at
    Sq/Skv one off the 64-row tiles, kv_len inside one tile, bf16 head dims
    16-256, and Dk != Dv."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bt, lengths = split_edges(paged_inputs(dtype, gen), "",
                                           ("fp8", "int8"), dtype)
        # Phi-3.5-MoE at (4, 2): 4 kv heads of 128 per device, G = 4
        split_edges(paged_inputs(dtype, gen, kg=4, hd=128, G=4),
                    "Phi Dk 128 G 4 ", ("fp8",), dtype)
        N, page = q.shape[0], k.shape[1]
        # MLA's layout: one latent pool, v = k[..., :32], copied by nobody,
        # on the split-edge lengths above
        lat = torch.randn(k.shape[0], page, 1, 40, device=DEV,
                          generator=gen).to(dtype)
        ql = torch.randn(N, 16, 40, device=DEV, generator=gen).to(dtype)
        edge_row("paged_decode", "v = k[..., :32] (Dk 40)", dtype,
                 pa.paged_decode_attention(ql, lat, lat[..., :32], bt, lengths),
                 ref.paged_decode_attention(ql, lat, lat[..., :32].contiguous(),
                                            bt, lengths))
        # ... and at MiniCPM3-4B's width: Dk 288, v = k[..., :256], G 40;
        # rows on and one past a split boundary, empty rows, MB = 1
        q, k, v, bt, lengths = mla_paged_inputs(dtype, gen)
        N, MB = q.shape[0], bt.shape[1]
        pps = pa.plan_split(N, 1, MB, _sms())
        edge = [0, pps * page, pps * page + 1, 2 * pps * page, MB * page, 0,
                1, page]
        lengths[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device=DEV)
        for kv in (None, "fp8"):
            for case, a in ((f"MLA Dk 288 split edges (pps {pps})",
                             (q, k, v, bt, lengths)),
                            ("MLA Dk 288 MB = 1",
                             (q, k, v, bt[:, :1], lengths.clamp(max=page)))):
                a = a if kv is None else quantize_pages(a, kv)
                kw = {"scale": MLA_SCALE}
                if kv is not None:
                    kw.update(k_scale=a[5], v_scale=a[6])
                edge_row(paged_variant(a[1], a[2]), case, dtype,
                         pa.paged_decode_attention(*a[:5], **kw),
                         ref.paged_decode_attention(
                             *a[:2], a[2].contiguous(), *a[3:5], **kw))
        for n in (63, 65, 127, 129):
            flash_edge(gen, dtype, 1, n, n, 64, 64)
        for causal in (True, False):
            flash_edge(gen, dtype, 2, 150, 150, 64, 64, kv_len=[17, 5],
                       causal=causal)
        flash_edge(gen, dtype, 1, 65, 129, 64, 64, q_offset=64)
        flash_edge(gen, dtype, 2, 70, 90, 64, 32, kv_len=[90, 33], q_offset=20)
        # Phi-3.5-MoE's prefill heads: 32 q / 8 kv of 128, ragged tails
        flash_edge(gen, dtype, 1, 2001, 2001, 128, 128, Hkv=8)
        flash_edge(gen, dtype, 2, 150, 150, 128, 128, kv_len=[150, 77], Hkv=8)
        flash_edge(gen, dtype, 1, 65, 129, 128, 128, q_offset=64, Hkv=8)
        if dtype == torch.bfloat16:
            for d in (16, 24, 40, 96, 256):
                flash_edge(gen, dtype, 2, 77, 77, d, d, kv_len=[77, 50])


# --------------------------------------------------------------------------- #
# phase 3: engine
# --------------------------------------------------------------------------- #
def teacher_forced_check(cfg, params, prompts, results, tag,
                         new_tokens: int | None = NEW_TOKENS,
                         start: int = 0) -> int:
    """Every transcript must equal the port's greedy forward: one forward
    per request over prompt + transcript, argmax at every generated
    position from ``start`` on.  A divergence is tolerated only where the
    reference's top-2 logit gap is below GAP_TOL; it is printed with both
    values.  With ``new_tokens`` None a transcript of any nonzero length
    must be a prefix of greedy (an OOM finish).  An encoder-decoder's
    prompt is (frames, decoder prefix): the greedy pass is ``encode`` of
    the frames alone, then ``decode_forward`` over prefix + transcript."""
    ties = 0
    for rid, prompt in enumerate(prompts):
        toks = results[rid].tokens
        if len(toks) != (new_tokens or len(toks)) or not toks:
            fail(f"{tag}: request {rid} emitted {len(toks)} tokens")
        if cfg.is_encoder_decoder:
            frames, prompt = prompt
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              device=DEV)[None]
        with torch.no_grad():
            if cfg.is_encoder_decoder:
                enc = encdec.encode(cfg, params,
                                    torch.as_tensor(frames, device=DEV)[None])
                logits, _ = encdec.decode_forward(cfg, params, seq, enc)
            else:
                logits, _ = transformer.forward(cfg, params, seq)
        lg = logits[0, len(prompt) - 1:].float()
        if not torch.isfinite(lg).all():
            fail(f"{tag}: non-finite reference logits for request {rid}")
        ref_tok = lg.argmax(-1).tolist()
        for t, (got, want) in enumerate(zip(toks, ref_tok)):
            if t < start or got == want:
                continue
            top2 = lg[t].topk(2).values
            gap = float(top2[0] - top2[1])
            diff = float(lg[t, want] - lg[t, got])
            emit({"phase": "engine", "run": tag, "tie": True, "rid": rid,
                  "pos": t, "engine": got, "reference": want,
                  "top2_gap": gap, "logit_diff": diff})
            if gap >= GAP_TOL:
                fail(f"{tag}: request {rid} token {t}: engine {got} != "
                     f"greedy {want} (top-2 gap {gap})")
            ties += 1
    return ties


def quant_contract(cfg, params, prompts, eng, kv_dtype: str, tag: str,
                   new_tokens: int, routes: dict | None = None) -> dict:
    """The reference's contract for quantized pools (engine_quant.py): the
    first token equals greedy forward's; every decode step's logits are
    within LOGIT_TOL of the forward teacher-forced on the engine's
    transcript; an emitted token differs from the forward's argmax only
    where its top-2 margin is within the bound, and such near-ties are at
    most half the steps.

    For an MoE model ``routes`` gives each request's expert choices at
    each decode step (a set per MoE layer).  A step whose router chose
    other experts than the forward's at that position (an expert flip: a
    random router moves its choice under a small change of its input, and
    one expert moves the logits past the bound) is counted and measured
    but held to neither rule; flips must stay at most half the steps."""
    tol = LOGIT_TOL[kv_dtype]
    worst, ties, total, flips, worst_flip = 0.0, 0, 0, 0, 0.0
    for rid, prompt in enumerate(prompts):
        toks = eng.results[rid].tokens
        if len(toks) != new_tokens:
            fail(f"{tag}: request {rid} emitted {len(toks)} tokens")
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              device=DEV)[None]
        with torch.no_grad(), ExpertLoads() as fwd:
            logits, _ = transformer.forward(cfg, params, seq)
        ref_lg = logits[0, len(prompt) - 1:].float()            # [new, V]
        if not torch.isfinite(ref_lg).all():
            fail(f"{tag}: non-finite reference logits for request {rid}")
        if toks[0] != int(ref_lg[0].argmax()):
            fail(f"{tag}: request {rid} first token {toks[0]} != greedy "
                 f"{int(ref_lg[0].argmax())}")
        steps = eng.step_logits.get(rid, [])
        if len(steps) != new_tokens - 1:
            fail(f"{tag}: request {rid} kept {len(steps)} step logits")
        got = torch.as_tensor(np.stack(steps), device=DEV)     # [new-1, Vp]
        ref_s = ref_lg[1:]
        if not torch.isfinite(got).all():
            fail(f"{tag}: non-finite engine logits for request {rid}")
        delta = (got - ref_s).abs().amax(dim=-1)
        held = torch.ones_like(delta, dtype=torch.bool)
        if routes is not None:
            if len(routes.get(rid, ())) != len(steps):
                fail(f"{tag}: request {rid} has routes for "
                     f"{len(routes.get(rid, ()))} of {len(steps)} steps")
            chosen = [idx[0] for _, _, _, _, idx in fwd.calls]  # [T, k] per layer
            for t in range(len(steps)):
                pos = len(prompt) + t
                held[t] = all(set(c[pos].tolist()) == e
                              for c, e in zip(chosen, routes[rid][t]))
            flips += int((~held).sum())
            if not held.all():
                worst_flip = max(worst_flip, float(delta[~held].max()))
        delta = torch.where(held, delta, torch.zeros_like(delta))
        worst = max(worst, float(delta.max()))
        if bool((delta > tol).any()):
            t = int(delta.argmax())
            fail(f"{tag}: request {rid} step {t}: |dlogit| {float(delta[t])} "
                 f"> {tol}")
        top2 = ref_s.topk(2, dim=-1)
        margin = top2.values[:, 0] - top2.values[:, 1]
        miss = held & (torch.as_tensor(toks[1:], device=DEV)
                       != top2.indices[:, 0])
        if bool((miss & (margin > tol)).any()):
            t = int((miss & (margin > tol)).nonzero()[0])
            fail(f"{tag}: request {rid} step {t}: token {toks[t + 1]} != "
                 f"reference argmax {int(top2.indices[t, 0])} at margin "
                 f"{float(margin[t])} > {tol}")
        ties += int(miss.sum())
        total += len(steps)
    if ties > total // 2:
        fail(f"{tag}: near-ties {ties} of {total} steps")
    if flips > total // 2:
        fail(f"{tag}: expert flips at {flips} of {total} steps")
    row = {"worst_dlogit": worst, "logit_tol": tol, "near_ties": ties,
           "steps_checked": total}
    if routes is not None:
        row.update(expert_flips=flips, worst_dlogit_at_flips=worst_flip)
    return row


class CrossPoolWatch:
    """Whisper's read-only cross pools: a copy of them after every prefill
    batch of ``eng``, and the count of encoder shape groups the batches
    made (one batched encode each).  Decode never writes the pools, so
    before each later prefill batch, and when the run ends, they must
    still equal the last copy; each comparison stays on the device (no
    sync in the pipelined loop) and ``check`` reads them all."""

    KEYS = ("cross_k_pool", "cross_v_pool")

    def __init__(self, eng):
        self.eng, self.copy, self.groups, self.batches = eng, None, 0, 0
        self.same = []
        self._prefill = eng._prefill_batch
        eng._prefill_batch = self._record

    def _compare(self) -> None:
        if self.copy is not None:
            self.same.extend((self.eng.state[k] == self.copy[k]).all()
                             for k in self.KEYS)

    def _record(self, reqs, now):
        self._compare()
        out = self._prefill(reqs, now)
        self.groups += len({self.eng._prompts[r.rid].shape for r in reqs})
        self.batches += 1
        self.copy = {k: self.eng.state[k].clone() for k in self.KEYS}
        return out

    def check(self, tag: str) -> dict:
        """Fails unless the pools were bit-equal to the last copy before
        every later prefill batch and at the end, and every frame was
        freed; returns the row's numbers."""
        eng = self.eng
        self._compare()
        if not all(bool(s) for s in self.same):
            fail(f"{tag}: the cross pools changed during decode (read-only "
                 f"pools)")
        audit = eng.cluster.page_table.frame_audit()
        held = {i: h for i, (_, h) in audit.items() if h}
        if held:
            fail(f"{tag}: frames still held after the run: {held}")
        self.copy = self.eng = self._prefill = None
        return {"cross_pools_unchanged": True, "leaked_frames": 0,
                "prefill_batches": self.batches,
                "pool_comparisons": len(self.same),
                "encoder_shape_groups": self.groups,
                "cross_pool_bytes": nbytes(*(eng.state[k]
                                             for k in self.KEYS)),
                "self_cache_bytes": nbytes(eng.state["self_k"],
                                           eng.state["self_v"])}


class LargestPagedCall:
    """While active, wraps ``pa.paged_decode_attention`` and keeps a frozen
    copy of the inputs (and the scale) of the call with the most kv tokens.
    A v that is a view of k (MLA's latent) stays a view of the copied k,
    and shared scales stay shared.  Each call it sees syncs the device (the
    token count is read on the host), so it stays active for a few steps
    only."""

    def __init__(self):
        self.tokens, self.args, self.scale = -1, None, None
        self._launch = pa.paged_decode_attention

    def _record(self, q, k, v, bt, lengths, *, scale=None, k_scale=None,
                v_scale=None):
        tokens = int(lengths.sum())
        if tokens > self.tokens:
            kc = k.clone()
            vc = (kc[..., :v.shape[-1]] if shares_storage(k, v)
                  else v.clone())
            sc = () if k_scale is None else (k_scale.clone(),)
            if sc:
                sc += (sc[0] if v_scale is k_scale else v_scale.clone(),)
            self.tokens, self.scale = tokens, scale
            self.args = (q.clone(), kc, vc, bt.clone(), lengths.clone()) + sc
        return self._launch(q, k, v, bt, lengths, scale=scale,
                            k_scale=k_scale, v_scale=v_scale)

    def __enter__(self):
        pa.paged_decode_attention = self._record
        return self

    def __exit__(self, *exc):
        pa.paged_decode_attention = self._launch


class ExpertLoads:
    """While active, wraps ``moe.group_by_expert`` and keeps, for each call
    (every MoE layer of a prefill forward, ``moe.moe_ffn``, or of a decode
    step), the rows of its fullest bin (a device scalar, read once after
    the run, so the steps do not wait on it) beside the capacity C: a token
    is dropped iff a bin holds more than C rows.  ``step`` tags the
    calls; each keeps its expert indices too."""

    def __init__(self):
        self.step, self.kind, self.calls = 0, "decode", []
        self._group, self._ffn = moe.group_by_expert, moe.moe_ffn

    def _record(self, topk_idx, num_experts, capacity):
        rows = moe.bin_rows(topk_idx, num_experts).amax()
        self.calls.append((self.step, self.kind, rows, capacity, topk_idx))
        return self._group(topk_idx, num_experts, capacity)

    def _prefill(self, *args, **kwargs):
        self.kind = "prefill"
        try:
            return self._ffn(*args, **kwargs)
        finally:
            self.kind = "decode"

    def __enter__(self):
        moe.group_by_expert, moe.moe_ffn = self._record, self._prefill
        return self

    def __exit__(self, *exc):
        moe.group_by_expert, moe.moe_ffn = self._group, self._ffn

    def decode_routes(self, dispatched: dict) -> dict:
        """Each request's expert choices at each of its decode steps (a set
        per MoE layer), from ``dispatched``: step -> the (rid, instance,
        slot) rows of the decode iteration that step dispatched."""
        layers = {}
        for step, kind, _, _, idx in self.calls:
            if kind == "decode":
                layers.setdefault(step, []).append(idx)
        routes = {}
        for step in sorted(dispatched):
            for rid, i, b in dispatched[step]:
                routes.setdefault(rid, []).append(
                    [set(idx[i, b].tolist()) for idx in layers[step]])
        return routes

    def by_step(self) -> list:
        """[{"step": i, "prefill": [[fullest bin, C], ...], "decode":
        [...]}, ...] for the steps that made MoE calls."""
        rows = torch.stack([c[2] for c in self.calls]).tolist()
        out = {}
        for (step, kind, _, cap, _), n in zip(self.calls, rows):
            out.setdefault(step, {"step": step}).setdefault(kind, []).append(
                [n, cap])
        return [out[k] for k in sorted(out)]


def moe_layers(cfg) -> int:
    """The model's MoE layers: each launches the routed expert kernel once
    per decode step (prefill keeps the bmm path)."""
    if cfg.is_encoder_decoder:
        return 0
    return cfg.num_blocks * sum(k["ffn"] == "moe" for k in cfg.block_pattern())


def attention_layers(cfg) -> int:
    """The model's attention layers: each launches the paged kernel once
    per decode step and flash once per prefilled request."""
    return sum(k["mixer"] == "attn" for k in cfg.layer_kinds())


def make_engine(cfg, params, prompts, pipeline: bool, *,
                new_tokens: int = NEW_TOKENS, **kw) -> NanoCPEngine:
    """The main path's engine: virtual (I=4, TP=2) mesh, the prompts queued.
    SSM models and whisper pin SSM_SLOTS slots per instance, the one M
    bucket of the reference's SSM and whisper cells; whisper's prompts are
    (frames, decoder prefix) audio requests.  ``kw`` overrides engine
    settings (kv dtype, the escalation cell's)."""
    args = dict(num_instances=4, instances_per_node=4,
                kv_capacity_tokens=4096, page_size=16, tp=2,
                buckets=CPBuckets(edges=(100, 256), degrees=(1, 2, 3)))
    if cfg.family in ("ssm", "hybrid") or cfg.is_encoder_decoder:
        args["max_slots_per_instance"] = SSM_SLOTS
    args.update(kw)
    eng = NanoCPEngine(cfg, params, pipeline=pipeline, device=DEV, **args)
    for p in prompts:
        if cfg.is_encoder_decoder:
            eng.add_audio_request(*p, max_new_tokens=new_tokens)
        else:
            eng.add_request(p, max_new_tokens=new_tokens)
    return eng


def zero_launches() -> None:
    """Set every kernel's launch count to 0 (after the queued work)."""
    torch.cuda.synchronize()
    pa.LAUNCHES = 0
    pa.LAUNCHES_BY_PAGE.clear()
    fa.LAUNCHES = 0
    fa.LAUNCHES_BY_KIND.clear()
    moe_experts.LAUNCHES = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {"paged_decode": pa.LAUNCHES, "flash_fwd": fa.LAUNCHES}


def free_memory() -> None:
    """Collect dropped engines and return their device memory: call after
    ``eng.close()`` (which frees the graphs and their pool) and ``del``."""
    gc.collect()        # the engine and its step cache form a cycle
    torch.cuda.empty_cache()


def run_engine(cfg, params, prompts, pipeline: bool, *, kv_dtype: str = "bf16",
               tag: str | None = None, new_tokens: int = NEW_TOKENS,
               escalate: bool = False, keep_logits: bool = False,
               mid_run=None, expect_stats: dict | None = None,
               oom: bool = False, cuda_graphs: bool = True,
               check: bool = True, **kw) -> dict:
    """One engine run, its launch counts zeroed right before and read right
    after.  The step replays one CUDA graph per bucket unless
    ``cuda_graphs`` is False: the eager run is the recorder run, the only
    one whose step the Python recorders can see (the largest paged call,
    every MoE call's bins and routes).  With ``check`` (else the caller
    holds the run to an eager twin): float32 pools' transcripts equal the
    greedy forward; quantized pools keep the tolerance contract.  Every
    run: the paged kernel launched once per attention layer per step (a
    replay counts the launches its graph recorded), every launch of the
    pools' page type, no pool moved.  Quantized pools also: the kv dtype
    in the bucket key, a clean frame audit and the live re-shard exercised
    (relaxations); with ``escalate`` (any pools) an escalation re-shard
    must have run.  The largest paged call of a quantized recorder run's
    first steps is kept in ``row["captured"]``; with ``keep_logits`` the
    step logits by request in ``row["step_logits"]`` and the transcripts in
    ``row["tokens"]`` (always kept).  ``mid_run(eng)`` runs once after the
    third step (a drain, a compaction); ``expect_stats`` gives minimums of
    ``hot_path_stats``; with ``oom`` every request must end in a
    request-level OOM with a greedy prefix.  MoE runs record the rows per
    MoE binding (B_s) of every dispatched step and its capacity C, and a
    recorder run, for every prefill and decode step, each MoE call's
    fullest bin against its C (``expert_load``); a dropped token fails the
    run."""
    quantized = quant.is_quantized(kv_dtype)
    recorder = not cuda_graphs
    tag = tag or ("pipelined" if pipeline else "non-pipelined")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    if quantized:
        kw.update(kv_dtype=kv_dtype, audit_donation_every_step=True)
    if quantized or keep_logits:
        kw["keep_logits"] = True
    if quantized and check and cfg.is_moe and not (recorder and pipeline):
        fail(f"{tag}: a quantized MoE run's contract reads its decode routes "
             "from the pipelined recorder run")
    eng = make_engine(cfg, params, prompts, pipeline, new_tokens=new_tokens,
                      cuda_graphs=cuda_graphs, **kw)
    cross = CrossPoolWatch(eng) if cfg.is_encoder_decoder else None
    zero_launches()
    cap = LargestPagedCall() if quantized and recorder else None
    step_ms, prefill_us, steady, host_us, rounds = [], 0.0, [], {}, 0
    moe_steps = []
    loads = ExpertLoads() if recorder else None
    dispatched = {}     # step -> (rid, instance, slot) of its decode rows
    t_run = time.perf_counter()
    with torch.no_grad(), (loads or contextlib.nullcontext()):
        while eng.pending and len(step_ms) < 200:
            inspect = cap is not None and len(step_ms) < CAPTURE_STEPS
            if mid_run is not None and len(step_ms) == 3:
                mid_run(eng)
            if loads is not None:
                loads.step = len(step_ms)
            t0 = time.perf_counter()
            if inspect:
                with cap:
                    eng.step()
            else:
                eng.step()
            dt = (time.perf_counter() - t0) * 1e3
            if quantized and cfg.is_moe and eng._inflight is not None:
                dispatched[len(step_ms)] = [(rid, i, b) for rid, _, i, b, _
                                            in eng._inflight.slots]
            step_ms.append(dt)
            rounds = max(rounds, eng.last_rounds_used)
            if cfg.is_moe and "dispatch_us" in eng.timings:
                b = eng.last_batch_sizes
                moe_steps.append({"max_rows": int(b.max()),
                                  "mean_rows": float(b.mean()),
                                  "capacity": moe.capacity(
                                      cfg, eng.last_bucket[0])})
            if "prefill_us" in eng.timings:
                prefill_us += eng.timings["prefill_us"]
            elif "dispatch_us" in eng.timings and not inspect:
                steady.append(dt)
                for k, v in eng.timings.items():
                    host_us.setdefault(k, []).append(v)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"paged_decode": pa.LAUNCHES, "flash_fwd": fa.LAUNCHES}
    by_page = dict(pa.LAUNCHES_BY_PAGE)
    by_kind = dict(fa.LAUNCHES_BY_KIND)
    steps = eng.hot_path_stats["steps"]
    n_attn = attention_layers(cfg)
    want = {"paged_decode": steps * n_attn, "flash_fwd": len(prompts) * n_attn}
    # decode's MoE layers go through the routed expert kernel, once a step
    launches["moe_experts"] = moe_experts.LAUNCHES
    want["moe_experts"] = steps * moe_layers(cfg)
    if cross is not None:
        # the encoder once per shape group of each admitted batch; the
        # decoder prefix's causal self-attention and its cross-attention
        # once per request and decoder layer
        want_kinds = {"full": cross.groups * cfg.num_encoder_layers,
                      "causal": len(prompts) * n_attn,
                      "cross": len(prompts) * n_attn}
        want["flash_fwd"] = sum(want_kinds.values())
        if by_kind != want_kinds:
            fail(f"{tag}: flash launches by kind {by_kind}, expected "
                 f"{want_kinds}")
    if launches != want:
        fail(f"{tag}: launches {launches}, expected {want} "
             f"(steps x attention layers, prompts x attention layers, "
             f"steps x MoE layers)")
    want_pages = {}
    if n_attn:
        pool = ("cross_k_pool" if cfg.is_encoder_decoder
                else "kv_pool" if cfg.is_mla else "k_pool")
        page_name = str(eng.state[pool].dtype).replace("torch.", "")
        want_pages[page_name] = want["paged_decode"]
    if by_page != want_pages:
        fail(f"{tag}: paged launches by page type {by_page}, expected "
             f"{want_pages}")
    st = eng.aot.stats
    if st.donation_copies:
        fail(f"{tag}: pools moved during a step: {st.as_dict()}")
    if cuda_graphs and (st.captured < 1 or st.hits < 1):
        fail(f"{tag}: no step replayed a captured graph: {st.as_dict()}")
    hp = eng.hot_path_stats
    row = {"phase": "engine", "model": cfg.name, "run": tag,
           "cuda_graphs": cuda_graphs, "kv_dtype": kv_dtype,
           "backend": eng._dims0.backend,
           "mesh": [eng.cluster.num_instances, eng.tp],
           "requests": len(prompts),
           "prompt_lens": [len(p[0] if cfg.is_encoder_decoder else p)
                           for p in prompts], "new_tokens": new_tokens,
           "steps": steps, "max_rounds_used": rounds, "launches": launches,
           "launches_by_page": by_page, "flash_launches_by_kind": by_kind}
    if cross is not None:
        row.update(cross.check(tag))
    if escalate:
        fin = eng.finished[0]
        if (hp["escalations"] < 1 or hp["reshard_tokens"] <= 0
                or len(fin.kv_binding) != 2):
            fail(f"{tag}: no escalation re-shard: {hp}, binding "
                 f"{fin.kv_binding}")
    for k, least in (expect_stats or {}).items():
        if hp[k] < least:
            fail(f"{tag}: hot_path_stats[{k!r}] = {hp[k]} < {least}: {hp}")
    if oom:
        short = [r for r, g in eng.results.items()
                 if not g.oom or len(g.tokens) >= new_tokens]
        if short:
            fail(f"{tag}: requests {short} did not end in an OOM finish")
    if quantized:
        if check:
            row.update(quant_contract(
                cfg, params, prompts, eng, kv_dtype, tag, new_tokens,
                loads.decode_routes(dispatched) if cfg.is_moe else None))
        if eng.last_bucket[-1] != kv_dtype:
            fail(f"{tag}: bucket key {eng.last_bucket} lacks the kv dtype")
        eng.cluster.page_table.frame_audit()
        if not escalate and hp["relaxations"] <= 0:
            fail(f"{tag}: the quantized re-shard never ran: {hp}")
        if cap is not None:
            row["captured_kv_tokens"] = cap.tokens
    elif check:
        row["ties_tolerated"] = teacher_forced_check(
            cfg, params, prompts, eng.results, tag,
            None if oom else new_tokens)
    if oom:
        row["tokens_before_oom"] = [len(g.tokens)
                                    for g in eng.results.values()]
    if moe_steps:
        row["moe_steps"] = moe_steps
        row["launches_per_step"] = {k: v / steps for k, v in launches.items()}
    if loads is not None and cfg.is_moe:
        # [fullest bin, C] of every MoE call, by step and kind
        row["expert_load"] = loads.by_step()
        dropped = [(e["step"], k, p) for e in row["expert_load"]
                   for k in ("prefill", "decode") for p in e.get(k, ())
                   if p[0] > p[1]]
        if dropped:
            fail(f"{tag}: tokens dropped (step, kind, [fullest bin, C]): "
                 f"{dropped}")
    decode_tokens = sum(len(r.tokens) - 1 for r in eng.results.values())
    decode_s = sum(step_ms) / 1e3 - prefill_us / 1e6
    row.update({
        "median_steady_step_ms": statistics.median(steady) if steady else None,
        "steady_steps": len(steady),
        # host clock, median over steady steps: table lowering, upload,
        # step enqueue (dispatch) and the wait for the previous step's
        # tokens (harvest; in the pipelined run this is where the host
        # waits for the device)
        "steady_host_us": {k: statistics.median(v)
                           for k, v in sorted(host_us.items())},
        "prefill_ms_per_request": prefill_us / 1e3 / len(prompts),
        "decode_tokens_per_s": decode_tokens / decode_s,
        "run_s": run_s, "hot_path_stats": hp,
        "aot": st.as_dict(),
        "last_bucket": list(eng.last_bucket),
        "pool_bytes": nbytes(*eng.state.values()),
        "ssm_state_bytes": nbytes(*(eng.state[k] for k in dcp.SSM_STATE
                                    if k in eng.state)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    row["tokens"] = {r: g.tokens for r, g in eng.results.items()}
    emit({k: v for k, v in row.items() if k != "tokens"})
    if cap is not None:
        row["captured"] = (cap.args, cap.scale)
    if keep_logits or quantized:
        row["step_logits"] = dict(eng.step_logits)
    eng.close()
    del eng
    free_memory()
    # the engine's pools, tables and graphs are gone (a recorder run keeps
    # the largest paged call's inputs)
    left = torch.cuda.memory_allocated() - mem0
    if cap is None and left > 64 * 2**20:
        fail(f"{tag}: {left / 2**20:.1f} MiB still allocated after the "
             "engine was dropped")
    return row


def run_pair(cfg, params, prompts, pipeline: bool, *, tag: str,
             keep_logits: bool = True, **kw) -> tuple:
    """The same run twice: eagerly (the recorder run, held to greedy or the
    tolerance contract) and with graphs, which must give equal tokens and,
    with ``keep_logits``, bit-equal step logits.  Returns (eager row,
    graph row)."""
    eager = run_engine(cfg, params, prompts, pipeline, tag=f"{tag} eager",
                       keep_logits=keep_logits, cuda_graphs=False, **kw)
    graph = run_engine(cfg, params, prompts, pipeline, tag=tag,
                       keep_logits=keep_logits, check=False, **kw)
    if graph["tokens"] != eager["tokens"]:
        fail(f"{tag}: graph tokens {graph['tokens']} != eager "
             f"{eager['tokens']}")
    worst = 0.0
    if "step_logits" in graph:
        for rid, steps in eager["step_logits"].items():
            got = graph["step_logits"][rid]
            if len(got) != len(steps):
                fail(f"{tag}: request {rid} kept {len(got)} graph step "
                     f"logits, {len(steps)} eager")
            for a, b in zip(got, steps):
                if not np.array_equal(a, b):
                    worst = max(worst, float(np.abs(a - b).max()))
        if worst:
            fail(f"{tag}: graph step logits differ from eager by {worst} "
                 "(not bit-equal)")
    emit({"phase": "parity", "model": cfg.name, "run": tag,
          "tokens_equal": True,
          "logits_bit_equal": True if "step_logits" in graph else None,
          "graph_replays": graph["aot"]["hits"]})
    return eager, graph


# the MoE pieces whose device time the profiles report, by range name
MOE_RANGES = {
    "moe.routing": ((moe, "router_topk"), (moe, "group_by_expert")),
    "moe.expert_ffn": ((moe, "expert_ffn"),),
    "moe.all_to_all": ((moe_parallel, "_dispatch"),
                       (moe_parallel, "_combine")),
    "moe.gate_combine": ((moe, "combine"),),
    "moe.routed_experts": ((moe_experts, "routed_experts"),),
}
# the bmm path's pieces, which decode on the card no longer runs (the
# routed expert kernel does their work), and the kernel prefill never runs
MOE_BMM_PATH = ("moe.expert_ffn", "moe.all_to_all", "moe.gate_combine")
# the decode step's mixers (an SSD layer; an attention layer, phases 1-4
# and its projections), for the SSM models' profiles.  ``build_decode_step``
# binds the attention layer when a bucket's step is built, so the ranges
# must be active from the engine's first step on.
LAYER_RANGES = {
    "layer.ssm": ((dcp, "_ssm_layer"),),
    "layer.attention": ((dcp, "_attn_layer"), (dcp, "_mla_layer")),
}
# the prefill's SSD blocks and, inside them, the chunked scan
SSD_RANGES = {
    "ssm.block": ((ssm, "ssm_block"),),
    "ssm.ssd_scan": ((ssm, "ssd_chunked"),),
}
# the train step's flash backward (plain torch, run by autograd)
BWD_RANGES = {"flash.backward": ((fa, "flash_backward"),)}
RANGE_NAMES = frozenset(MOE_RANGES) | frozenset(LAYER_RANGES) | frozenset(
    SSD_RANGES) | frozenset(BWD_RANGES)


class Ranges:
    """While active, runs each piece of ``ranges`` (name -> (module,
    attribute) sites) inside a ``torch.profiler.record_function`` range of
    its name, so a trace can give the device time of its kernels.  The
    pieces are swapped on their modules, so a call site that binds one by
    direct import escapes its range: ``range_device_ms`` fails then."""

    def __init__(self, *ranges: dict):
        self.ranges = {k: v for r in ranges for k, v in r.items()}

    def __enter__(self):
        self._saved = []
        for name, sites in self.ranges.items():
            for mod, attr in sites:
                fn = getattr(mod, attr)
                self._saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(name, fn))
        return self

    @staticmethod
    def _wrap(name, fn):
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return ranged

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def range_device_ms(prof, absent=(), ranges=MOE_RANGES) -> dict:
    """Device time (ms) of the kernels launched inside each range of
    ``ranges``: the host-side range's kernels and its children's.  (The
    range's device-side annotation spans from its first kernel to its
    last, idle gaps included, so it is not used.)  Fails if a range other
    than those the traced path does not run (``absent``) recorded no device
    time."""
    out = {name: 0.0 for name in ranges}
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] += float(e.device_time_total) / 1e3
    for name, ms in out.items():
        if ms <= 0 and name not in absent:
            fail(f"profile: range {name} recorded no device time "
                 f"(a call site no longer goes through "
                 f"{', '.join(attr for _, attr in ranges[name])})")
    return out


def kernel_events(prof) -> list:
    """The trace's kernels, averaged by name: a CPU op's entry repeats its
    kernels' device time, and a range's device-side annotation spans its
    kernels, so both are left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in RANGE_NAMES]


# CUDA API calls (``cuda*`` and ``cu*`` entry points) that put work on a
# stream, as the profiler names them on the host side
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                    "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                    "cudaMemsetAsync")


def profile_engine(cfg, params, prompts, cuda_graphs: bool) -> tuple:
    """A pipelined run of the same traffic, with graphs or eager.  The
    eager run keeps, during its first steps, a frozen copy of the inputs of
    the largest paged-decode call the main path makes (most kv tokens).
    Then ``torch.profiler`` traces PROFILE_STEPS steady steps: device time
    by kernel (CUPTI traces the kernels a graph replays), kernels and host
    launch calls per step, and the device's busy share of the traced
    window (the profiler's own host overhead lengthens the window, so the
    share is a lower bound).  An eager MoE model's trace also gives the
    device time of its MoE pieces (``MOE_RANGES``: Python ranges, which a
    replay does not run).  The steps after the window, unprofiled, give the
    median steady step time.  Returns (the captured call's (inputs, scale)
    or None, the row)."""
    eng = make_engine(cfg, params, prompts, pipeline=True,
                      cuda_graphs=cuda_graphs)
    cap = None if cuda_graphs else LargestPagedCall()
    with torch.no_grad(), (cap or contextlib.nullcontext()):
        for _ in range(CAPTURE_STEPS):      # admission + first decode steps
            eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ranges = contextlib.nullcontext() if cuda_graphs else Ranges(MOE_RANGES)
    with (torch.no_grad(), ranges,
          torch.profiler.profile(activities=acts) as prof):
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    steady = []
    with torch.no_grad():
        while eng.pending:
            captured = eng.aot.stats.captured
            t0 = time.perf_counter()
            eng.step()
            dt = (time.perf_counter() - t0) * 1e3
            if ("dispatch_us" in eng.timings and "prefill_us" not in
                    eng.timings and eng.aot.stats.captured == captured):
                steady.append(dt)
    torch.cuda.synchronize()

    def dev_us(e):
        return float(e.self_device_time_total)

    events = kernel_events(prof)
    device_us = sum(dev_us(e) for e in events)
    host_calls = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key in HOST_LAUNCH_APIS}
    top = sorted(events, key=dev_us, reverse=True)[:12]
    row = {"phase": "profile", "model": cfg.name, "run": "pipelined",
           "cuda_graphs": cuda_graphs, "steps": PROFILE_STEPS,
           "window_us": window_us, "device_us": device_us,
           "device_ms_per_step": device_us / 1e3 / PROFILE_STEPS,
           "device_busy_share": device_us / window_us,
           "kernel_launches": sum(e.count for e in events),
           "kernel_launches_per_step": sum(e.count for e in events)
                                       / PROFILE_STEPS,
           "host_launches_per_step": sum(host_calls.values()) / PROFILE_STEPS,
           "host_launch_calls": host_calls,
           "median_steady_step_ms": (statistics.median(steady) if steady
                                     else None),
           "unprofiled_steady_steps": len(steady),
           "aot": eng.aot.stats.as_dict(),
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "device_us": dev_us(e)} for e in top],
           # the paged kernel and its split merge
           "paged_share": sum(dev_us(e) for e in events
                              if "paged_split_kernel" in e.key
                              or "merge_kernel" in e.key) / device_us}
    if cfg.is_moe and not cuda_graphs:
        row["moe_share"] = {k: v * 1e3 / device_us for k, v in
                            range_device_ms(prof, MOE_BMM_PATH).items()}
    if cfg.family in ("ssm", "hybrid") and not cuda_graphs:
        # device ms per step by piece (the caller's LAYER_RANGES were on
        # from the engine's first step)
        absent = set(MOE_BMM_PATH) if cfg.is_moe else set(MOE_RANGES)
        if not cfg.has_attention:
            absent.add("layer.attention")
        ms = range_device_ms(prof, absent, {**LAYER_RANGES, **MOE_RANGES})
        split = {"ssm_layers": ms["layer.ssm"],
                 "attention": ms["layer.attention"],
                 "moe_experts": ms["moe.routed_experts"],
                 "moe_routing": ms["moe.routing"]}
        split["rest"] = device_us / 1e3 - sum(split.values())
        row["device_ms_per_step_split"] = {k: v / PROFILE_STEPS
                                           for k, v in split.items()}
    emit(row)
    eng.close()
    del eng
    free_memory()
    return (None if cap is None else (cap.args, cap.scale)), row


def both_ways(cfg, params, prompts, label: str) -> dict:
    """The model's main-path traffic at (4, 2) with graphs on and off: the
    pipelined pair (step logits kept, bit-equal), the non-pipelined pair
    (tokens equal) and a profile each way, then one row of the numbers
    side by side, marked with the card.  Returns the runs' rows by name
    and the eager profile's captured paged call."""
    pe, pg = run_pair(cfg, params, prompts, True, tag=f"{label} pipelined")
    ne, ng = run_pair(cfg, params, prompts, False,
                      tag=f"{label} non-pipelined", keep_logits=False)
    layers = (Ranges(LAYER_RANGES) if cfg.family in ("ssm", "hybrid")
              else contextlib.nullcontext())
    with layers:
        captured, prof_e = profile_engine(cfg, params, prompts,
                                          cuda_graphs=False)
    _, prof_g = profile_engine(cfg, params, prompts, cuda_graphs=True)
    side = {}
    for way, pipe, nopipe, prof in (("graphs", pg, ng, prof_g),
                                    ("eager", pe, ne, prof_e)):
        side[way] = {
            "step_ms_pipelined": prof["median_steady_step_ms"],
            "step_ms_non_pipelined": nopipe["median_steady_step_ms"],
            # the pipelined pair keeps its step logits (one [I, M, V] copy
            # to the host per step)
            "decode_tokens_per_s_pipelined": pipe["decode_tokens_per_s"],
            "steady_host_us_pipelined": pipe["steady_host_us"],
            "decode_tokens_per_s_non_pipelined":
                nopipe["decode_tokens_per_s"],
            "steady_host_us_non_pipelined": nopipe["steady_host_us"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "device_busy_share": prof["device_busy_share"],
            "host_launches_per_step": prof["host_launches_per_step"],
            "kernel_launches_per_step": prof["kernel_launches_per_step"],
            "graphs": prof["aot"]["captured"] if way == "graphs" else 0,
            "capture_s": (prof["aot"]["capture_seconds"]
                          if way == "graphs" else 0.0),
            "graph_pool_bytes": prof["aot"]["graph_pool_bytes"],
            "peak_mem_gb": max(pipe["peak_mem_gb"], nopipe["peak_mem_gb"])}
    emit({"phase": "graphs", "model": cfg.name, "card": nvidia_smi(),
          **side})
    return {"pipelined": pg, "pipelined eager": pe, "non-pipelined": ng,
            "non-pipelined eager": ne, "captured": captured}


def profile_prefill(cfg, params, prompt) -> dict:
    """Device time of one prefill forward (with KV collection, as the
    engine runs it) of the longest prompt, by ``torch.profiler``: all
    kernels, the flash kernel's share, for an MoE model the device time
    of its MoE pieces (``MOE_RANGES``), and for an SSM model that of its
    SSD blocks and, inside them, the chunked scan (``SSD_RANGES``)."""
    toks = torch.as_tensor(prompt, device=DEV)[None]
    with torch.no_grad():
        transformer.forward(cfg, params, toks, collect_kv=True, device=DEV)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with (Ranges(MOE_RANGES, SSD_RANGES),
              torch.profiler.profile(activities=acts) as prof):
            t0 = time.perf_counter()
            transformer.forward(cfg, params, toks, collect_kv=True, device=DEV)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    events = kernel_events(prof)
    flash = [e for e in events if "flash_fwd" in e.key]
    row = {"phase": "prefill", "model": cfg.name, "prompt_len": len(prompt),
           "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
           "flash_ms": sum(e.self_device_time_total for e in flash) / 1e3,
           "flash_launches": sum(e.count for e in flash),
           "kernel_launches": sum(e.count for e in events),
           "window_ms": window_us / 1e3}
    if cfg.is_moe:
        # prefill groups per request: no all-to-all
        row["moe_device_ms"] = ms = range_device_ms(
            prof, absent=("moe.all_to_all", "moe.routed_experts"))
        row["moe_share"] = {k: v / row["device_ms"] for k, v in ms.items()}
    if cfg.family in ("ssm", "hybrid"):
        ms = range_device_ms(prof, ranges=SSD_RANGES)
        row.update(ssm_block_ms=ms["ssm.block"], ssd_scan_ms=ms["ssm.ssd_scan"],
                   ssd_scan_share=ms["ssm.ssd_scan"] / row["device_ms"])
    emit(row)
    return row


def main() -> None:
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s})

    if "--launch" in sys.argv[1:]:
        run_launch_phase({})
        return      # launch phase only: no other phase, no result line
    if "--examples" in sys.argv[1:]:
        run_examples_phase()
        return      # examples phase only: no other phase, no result line
    if "--moe-experts" in sys.argv[1:]:
        run_moe_experts_rows()
        return      # the routed expert kernel's rows only: no result line
    gen = torch.Generator(device=DEV).manual_seed(0)
    ksum = run_kernel_phase(gen)
    if "--kernels" in sys.argv[1:]:
        return      # kernel phase only: no engine phases, no result line

    cfg = get_config("tinyllama-1.1b")
    params = transformer.init_params(cfg, seed=0, device=DEV,
                                     dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (L,)) for L in PROMPT_LENS]
    runs = both_ways(cfg, params, prompts, "tinyllama")
    main_args, _ = runs["captured"]
    profile_prefill(cfg, params, prompts[int(np.argmax(PROMPT_LENS))])
    # the paged kernel at the largest call the main path made (float32 pools)
    main_row = paged_row(main_args, torch.float32, "main path")
    emit(main_row)
    ksum["paged_decode"].append(main_row)

    # quantized pools: the main path's traffic, then the escalation cell
    qruns = {}
    for kv_dtype in ("fp8", "int8"):
        run, qruns[kv_dtype] = run_pair(cfg, params, prompts, True,
                                        kv_dtype=kv_dtype,
                                        tag=f"{kv_dtype} pipelined")
        # the quantized kernel at the largest call the recorder run made,
        # for the run's float32 queries and for bfloat16 ones
        args, _ = run.pop("captured")
        for a in (args, as_bf16_call(args)):
            row = paged_row(a, a[0].dtype, "main path")
            emit(row)
            ksum[row["name"]].append(row)
    escalation = dict(num_instances=2, instances_per_node=2, tp=2,
                      buckets=CPBuckets(edges=(48,), degrees=(1, 2)),
                      shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                 s_buckets=(0, 1, 2, 4),
                                                 window=2),
                      max_slots_per_instance=4)
    rng = np.random.default_rng(0)
    run_engine(cfg, params, [rng.integers(0, cfg.vocab_size, (40,))], True,
               kv_dtype="fp8", tag="fp8 escalate", new_tokens=24,
               escalate=True, **escalation)

    # the dense all-gather backend beside its routed twin (the main path's
    # pipelined graph run): same tokens, and logits within DENSE_LOGIT_TOL
    twin = runs["pipelined"]
    _, dense = run_pair(cfg, params, prompts, True, tag="dense pipelined",
                        backend="dense")
    if dense["max_rounds_used"] < 1:
        fail("dense pipelined: no step routed a row across instances")
    if dense["tokens"] != twin["tokens"]:
        fail(f"dense backend tokens {dense['tokens']} != routed "
             f"{twin['tokens']}")
    worst = max(float(np.abs(np.stack(dense["step_logits"][r])
                             - np.stack(twin["step_logits"][r])).max())
                for r in twin["step_logits"])
    if worst > DENSE_LOGIT_TOL:
        fail(f"dense backend logits differ from routed by {worst}")
    emit({"phase": "dense", "tokens_equal": True, "worst_dlogit": worst,
          "tol": DENSE_LOGIT_TOL,
          "median_steady_step_ms": dense["median_steady_step_ms"],
          "routed_median_steady_step_ms": twin["median_steady_step_ms"]})
    del twin, dense
    run_spill_phase(cfg, params, prompts)
    run_chaos_phase(cfg, params)
    serve = run_serve_phase(cfg, params, ksum)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # --- MLA: MiniCPM3-4B at full width ---
    mcfg = get_config("minicpm3-4b")
    t0 = time.perf_counter()
    mparams = transformer.init_params(mcfg, seed=0, device=DEV,
                                      dtype=torch.float32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(mparams))
    emit({"phase": "mla", "model": mcfg.name, "params": n_params,
          "param_gb": n_params * 4 / 2**30,
          "init_s": time.perf_counter() - t0})
    rng = np.random.default_rng(0)
    mprompts = [rng.integers(0, mcfg.vocab_size, (L,)) for L in PROMPT_LENS]
    mruns = both_ways(mcfg, mparams, mprompts, "mla")
    run_engine(mcfg, mparams, mprompts, True, tag="mla 2x4 pipelined",
               num_instances=2, instances_per_node=2, tp=4,
               buckets=CPBuckets(edges=(256,), degrees=(1, 2)))
    mq = {}
    for kv_dtype in ("fp8", "int8"):
        run, mq[kv_dtype] = run_pair(mcfg, mparams, mprompts, True,
                                     kv_dtype=kv_dtype,
                                     tag=f"mla {kv_dtype} pipelined")
        (args, sc) = run.pop("captured")
        for a in (args, as_bf16_call(args)):
            row = paged_row(a, a[0].dtype, "mla main path", scale=sc)
            emit(row)
            ksum[row["name"]].append(row)
    rng = np.random.default_rng(0)
    eprompt = [rng.integers(0, mcfg.vocab_size, (40,))]
    for kv_dtype in ("bf16", "fp8"):
        run_engine(mcfg, mparams, eprompt, True, kv_dtype=kv_dtype,
                   tag=f"mla {'f32' if kv_dtype == 'bf16' else kv_dtype} "
                       "escalate", new_tokens=24, escalate=True, **escalation)
    run_serve_mla(mcfg, mparams)
    margs, msc = mruns["captured"]
    profile_prefill(mcfg, mparams, mprompts[int(np.argmax(PROMPT_LENS))])
    for a in (margs, as_bf16_call(margs)):
        row = paged_row(a, a[0].dtype, "mla main path", scale=msc)
        emit(row)
        ksum[row["name"]].append(row)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()

    moe_runs, phi_params = run_moe_phase(ksum)
    run_examples_phase(phi_params)      # frees the moe phase's weights
    del phi_params
    mesh_2x4 = dict(num_instances=2, instances_per_node=2, tp=4,
                    buckets=CPBuckets(edges=(256,), degrees=(1, 2)))
    mesh_runs = (("2x4 pipelined", True, mesh_2x4),)
    qwen = run_archetype_phase("qwen", get_config("qwen1.5-0.5b"), ksum,
                               mesh_runs, name="paged_decode_qwen")
    llama4 = run_archetype_phase(
        "llama4", replace(get_config("llama4-scout-17b-a16e"),
                          num_layers=LLAMA4_LAYERS,
                          capacity_factor=LLAMA4_CAPACITY_FACTOR),
        ksum, mesh_runs, name="paged_decode_llama4")
    ds = run_archetype_phase(
        "deepseek", replace(get_config("deepseek-v3"), num_layers=DS_LAYERS,
                            capacity_factor=DS_CAPACITY_FACTOR),
        ksum, mesh_runs, name="paged_decode_ds", quant=("fp8", "int8"))
    jamba = run_ssm_phase(ksum)["jamba"]
    whisper = run_whisper_phase(ksum)
    run_train_phase(ksum)
    run_launch_phase(ksum)

    src, replaces = ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_attention.py:36")
    fsrc, freplaces = ("src/repro_torch/csrc/flash_fwd.cu",
                       "src/repro/kernels/flash_attention.py:27")
    kernels = []
    for name, source, repl, launches in (
            ("paged_decode", src, replaces,
             runs["pipelined"]["launches"]["paged_decode"]),
            ("paged_decode_fp8", src, replaces,
             qruns["fp8"]["launches"]["paged_decode"]),
            ("paged_decode_int8", src, replaces,
             qruns["int8"]["launches"]["paged_decode"]),
            ("flash_fwd", fsrc, freplaces, runs["pipelined"]["launches"]["flash_fwd"]),
            ("paged_decode_mla", src, replaces,
             mruns["pipelined"]["launches"]["paged_decode"]),
            ("paged_decode_mla_fp8", src, replaces,
             mq["fp8"]["launches"]["paged_decode"]),
            ("paged_decode_mla_int8", src, replaces,
             mq["int8"]["launches"]["paged_decode"]),
            ("flash_fwd_mla", fsrc, freplaces,
             mruns["pipelined"]["launches"]["flash_fwd"]),
            ("paged_decode_moe", src, replaces,
             moe_runs["pipelined"]["launches"]["paged_decode"]),
            ("flash_fwd_moe", fsrc, freplaces,
             moe_runs["pipelined"]["launches"]["flash_fwd"]),
            ("paged_decode_qwen", src, replaces,
             qwen["pipelined"]["launches"]["paged_decode"]),
            ("paged_decode_llama4", src, replaces,
             llama4["pipelined"]["launches"]["paged_decode"]),
            ("paged_decode_ds", src, replaces,
             ds["pipelined"]["launches"]["paged_decode"]),
            ("paged_decode_ds_fp8", src, replaces,
             ds["fp8"]["launches"]["paged_decode"]),
            ("paged_decode_ds_int8", src, replaces,
             ds["int8"]["launches"]["paged_decode"]),
            ("flash_fwd_ds", fsrc, freplaces,
             ds["pipelined"]["launches"]["flash_fwd"]),
            ("paged_decode_tp1", src, replaces,
             serve["launches"]["paged_decode"]),
            ("paged_decode_jamba", src, replaces,
             jamba["pipelined"]["launches"]["paged_decode"]),
            ("flash_fwd_jamba", fsrc, freplaces,
             jamba["pipelined"]["launches"]["flash_fwd"]),
            ("paged_decode_whisper", src, replaces,
             whisper["pipelined"]["launches"]["paged_decode"]),
            ("flash_fwd_whisper_enc", fsrc, freplaces,
             whisper["pipelined"]["flash_launches_by_kind"]["full"]),
            ("flash_fwd_whisper_cross", fsrc, freplaces,
             whisper["pipelined"]["flash_launches_by_kind"]["cross"])):
        rows = ksum[name]
        # the timing at the main path's shapes: the captured paged call, and
        # the 2000-token prompt's prefill attention; bf16 q beside it
        timed = [r for r in rows if r["dtype"] == "float32" and "ms" in r][-1]
        bf16 = [r for r in rows if r["dtype"] == "bfloat16" and "ms" in r][-1]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": repl,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["dtype"] == "float32"),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "share_of_bound": timed["share_of_bound"],
            "bf16_ms": bf16["ms"], "bf16_bound_ms": bf16["bound_ms"],
            "bf16_library_ms": bf16["library_ms"]})
    # the paged kernel at the launch phase's TP-16 decode cells (bf16 q;
    # raw fp8 pages without scales in ``_rawfp8``)
    for name in sorted(k for k in ksum if k.startswith("paged_decode_launch")):
        r = ksum[name][-1]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "share_of_bound": r["share_of_bound"],
            "dtype": r["dtype"], "page_dtype": r["page_dtype"]})
    # the routed expert FFN at each cell's decode call (M 8 and 16); its
    # launches are the Phi-3.5-MoE and DeepSeek-V3 phases' pipelined runs
    moe_launches = {"phi35moe": moe_runs["pipelined"]["launches"]["moe_experts"],
                    "dsv3": ds["pipelined"]["launches"]["moe_experts"]}
    for cell, M in ((c, m) for c in MOE_EXPERT_CELLS for m in (8, 16)):
        rows = [r for r in ksum["moe_experts"]
                if r["cell"] == cell and r["shape"]["M"] == M]
        f32, bf16 = (next(r for r in rows if r["dtype"] == d)
                     for d in ("float32", "bfloat16"))
        kernels.append({
            "name": f"moe_experts_{cell}_M{M}", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_experts.cu",
            "replaces": None, "launches": moe_launches[cell],
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "share_of_bound": f32["share_of_bound"], "bf16_ms": bf16["ms"],
            "bf16_bound_ms": bf16["bound_ms"],
            "bf16_library_ms": bf16["library_ms"]})
    # the flash op under autograd on the train path (its backward, plain
    # torch and not a kernel, in the bwd_* keys)
    kernels.append({"name": "flash_fwd_train", "route": "cuda",
                    "source": fsrc, "replaces": freplaces,
                    **ksum["flash_fwd_train"]})
    emit({"phase": "time", "script_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def run_spill_phase(cfg, params, prompts) -> None:
    """Phase 8 (TinyLlama): spill relief, the OOM finish, drain and
    compaction through the engine."""
    rng = np.random.default_rng(0)
    cell = dict(num_instances=2, instances_per_node=2, tp=2,
                shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                           s_buckets=(0, 1, 2, 4), window=2),
                max_slots_per_instance=4)
    # the scheduler's escalation off: growth spills at table lowering and
    # the engine's spill relief escalates the KV (the MoE binding stays)
    no_escalation = DualBalancedScheduler(
        buckets=CPBuckets(edges=(100_000,), degrees=(1, 2)),
        allow_rebalance=True, max_batch_per_instance=4, has_kv=True,
        kv_reserve=16, allow_escalation=False)
    spill = run_engine(cfg, params, [rng.integers(0, cfg.vocab_size, (40,))],
                       True, tag="spill relief", new_tokens=64,
                       kv_capacity_tokens=96, scheduler=no_escalation,
                       expect_stats={"spill_escalations": 1,
                                     "reshard_tokens": 1}, **cell)
    oom = run_engine(cfg, params, [rng.integers(0, cfg.vocab_size, (24,))],
                     True, tag="oom finish", new_tokens=100, oom=True,
                     kv_capacity_tokens=48,
                     buckets=CPBuckets(edges=(16,), degrees=(1, 2)),
                     expect_stats={"oom_finishes": 1}, **cell)

    def drain_then_compact(eng):
        cl = eng.cluster
        victim = int(np.bincount([r.moe_binding for r in cl.active.values()],
                                 minlength=cl.num_instances).argmax())
        if not eng.drain_instance(victim):
            fail("drain: nothing evacuated")
        if cl.page_table.instance_used_tokens(victim):
            fail(f"drain: instance {victim} still holds KV")
        eng.compact()

    maint = run_engine(cfg, params, prompts, True, tag="drain + compact",
                       mid_run=drain_then_compact,
                       expect_stats={"drains": 1, "compacts": 1})
    emit({"phase": "spill", "model": cfg.name,
          "spill_escalations": spill["hot_path_stats"]["spill_escalations"],
          "oom_tokens": oom["tokens_before_oom"],
          "drain_relaxations": maint["hot_path_stats"]["relaxations"],
          "ok": True})


def chaos_check(cfg, params, prompts, eng, tag: str,
                degraded_ok=()) -> dict:
    """The end of a chaos cell: the engine drained, no frame leaked or
    aliased, no pool moved, and every transcript full length and greedy
    (teacher-forced), or, for a request in ``degraded_ok`` that finished
    degraded, a greedy prefix.  Returns the cell's row."""
    cl = eng.cluster
    if cl.active or cl.waiting or eng._inflight is not None:
        fail(f"{tag}: the engine did not drain")
    fpi = cl.page_table.frames_per_instance
    for s, (free, held) in cl.page_table.frame_audit().items():
        ok = (held == 0 and free in (0, fpi) if s in cl.dead_instances
              else free + held == fpi)
        if not ok:
            fail(f"{tag}: instance {s} frames free {free} held {held}")
    for rid, res in eng.results.items():
        if res.recovered is False:
            if rid not in degraded_ok or not res.tokens:
                fail(f"{tag}: request {rid} finished degraded")
        elif len(res.tokens) != NEW_TOKENS:
            fail(f"{tag}: request {rid} emitted {len(res.tokens)} tokens")
    if eng.aot.stats.donation_copies:
        fail(f"{tag}: pools moved: {eng.aot.stats.as_dict()}")
    ties = teacher_forced_check(cfg, params, prompts, eng.results, tag, None)
    return {"phase": "chaos", "cell": tag, "hot_path_stats":
            dict(eng.hot_path_stats), "aot": eng.aot.stats.as_dict(),
            "tokens": [len(r.tokens) for r in eng.results.values()],
            "recovered": [r.recovered for r in eng.results.values()],
            "ties_tolerated": ties, "frames_leaked": 0}


def chaos_prompts(cfg, lens) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, (L,)) for L in lens]


def join_with_prewarm(eng, victim: int, tag: str) -> set:
    """``eng.join_instance(victim)``; the prewarm must capture a graph for
    each bucket it adds, none online, and leave every pool byte as it was.
    Returns the added bucket keys."""
    st = eng.aot.stats
    torch.cuda.synchronize()
    pools = {k: v.clone() for k, v in eng.state.items()}
    keys, captured, online = (set(eng.aot.cached_keys()), st.captured,
                              st.online_compiles)
    eng.join_instance(victim)
    torch.cuda.synchronize()
    new = set(eng.aot.cached_keys()) - keys
    if (not new or st.captured - captured != len(new)
            or st.online_compiles != online):
        fail(f"{tag}: the prewarm captured {st.captured - captured} graphs "
             f"for {new}")
    changed = [k for k, v in eng.state.items()
               if not torch.equal(v.view(torch.uint8),
                                  pools[k].view(torch.uint8))]
    if changed:
        fail(f"{tag}: the prewarm changed {changed}")
    return new


def run_chaos_phase(cfg, params) -> None:
    """TinyLlama at (4, 2) with graphs on: an instance killed between a
    step's dispatch and its harvest (the 2000-token request's MoE binding,
    at step 3 of the main path's traffic; its lost KV re-prefilled, every
    transcript greedy); a kill, then the instance's join with prewarm, in
    two cells: four 120-token requests (join at step 8: the prewarm
    captures the wider-ring graph, pools bit-equal across it, and
    ``online_compiles`` stays flat to the end) and three 250-token
    requests (join at step 4: escalation recruits the joiner and a
    prewarmed graph replays; captures the join makes on the hot path are
    counted); and a forced drain of the instance holding most of a
    600-token request's KV in pools of 256 tokens (fail semantics: it
    finishes degraded with a greedy prefix, the others full).  No frame
    leaks in any cell."""
    rows = []
    with torch.no_grad():
        # -- kill between dispatch and harvest --
        prompts = chaos_prompts(cfg, PROMPT_LENS)
        eng = make_engine(cfg, params, prompts, True)
        for step in range(200):
            if not eng.pending:
                break
            if step == 3:
                if eng._inflight is None:
                    fail("chaos kill: no step in flight")
                eng.fail_instance(eng.cluster.active[5].moe_binding)
            eng.step()
        hp = eng.hot_path_stats
        if (hp["failures"] != 1 or hp["degraded_finishes"]
                or hp["reprefill_tokens"] <= 0
                or eng.results[5].recovered is not True):
            fail(f"chaos kill: {hp}")
        rows.append(chaos_check(cfg, params, prompts, eng, "kill"))
        eng.close()
        del eng
        free_memory()

        # -- kill, then join with prewarm --
        for tag, lens, victim_rid, join_at in (("join", (120,) * 4, 0, 8),
                                               ("join recruit", (250,) * 3,
                                                1, 4)):
            prompts = chaos_prompts(cfg, lens)
            eng = make_engine(cfg, params, prompts, True)
            cl, st = eng.cluster, eng.aot.stats
            seen = {"loaded": False, "replayed": 0, "online": []}
            for step in range(200):
                if not eng.pending:
                    break
                if step == 2:
                    if eng._inflight is None:
                        fail(f"chaos {tag}: no step in flight")
                    victim = cl.active[victim_rid].moe_binding
                    eng.fail_instance(victim)
                if step == join_at:
                    new = join_with_prewarm(eng, victim, f"chaos {tag}")
                before = st.online_compiles
                eng.step()
                if step >= join_at:
                    seen["loaded"] |= cl.kv_load(victim) > 0
                    seen["replayed"] += eng.last_bucket in new
                    if st.online_compiles > before:
                        seen["online"].append(list(eng.last_bucket))
            if eng.hot_path_stats["joins"] != 1:
                fail(f"chaos {tag}: {eng.hot_path_stats}")
            if tag == "join" and seen["online"]:
                fail(f"chaos join: captures on the hot path after the join "
                     f"{seen['online']}")
            if tag == "join recruit" and not (seen["loaded"]
                                              and seen["replayed"]):
                fail(f"chaos join recruit: joiner loaded {seen['loaded']}, "
                     f"prewarmed replays {seen['replayed']}")
            row = chaos_check(cfg, params, prompts, eng, tag)
            row.update(prewarmed=sorted(map(list, new)),
                       joiner_loaded=seen["loaded"],
                       prewarmed_replays=seen["replayed"],
                       online_after_join=seen["online"])
            rows.append(row)
            eng.close()
            del eng
            free_memory()

        # -- forced drain: fail semantics for what cannot be evacuated --
        prompts = chaos_prompts(cfg, (600, 100, 48))
        eng = make_engine(cfg, params, prompts, True, kv_capacity_tokens=256)
        cl = eng.cluster
        eng.step()
        eng.step()
        if cl.waiting or eng._inflight is None:
            fail("chaos drain: requests waiting or no step in flight")
        shards = cl.page_table.shard_tokens(0)
        victim = max(shards, key=shards.get)
        eng.drain_instance(victim, force=True)
        if (victim not in cl.dead_instances
                or cl.page_table.instance_used_tokens(victim)
                or eng.results[0].recovered is not False):
            fail(f"chaos drain: {eng.hot_path_stats}")
        for _ in range(200):
            if not eng.pending:
                break
            eng.step()
        rows.append(chaos_check(cfg, params, prompts, eng, "forced drain",
                                degraded_ok=(0,)))
        eng.close()
        del eng
        free_memory()
    for row in rows:
        emit(row)
    emit({"phase": "chaos", "ok": True, "cells": len(rows)})


# --------------------------------------------------------------------------- #
# phase 8c: serve (SLO admission, prefix cache, prefill cells)
# --------------------------------------------------------------------------- #
SERVE_PREFIX = 1024                            # the shared prefix: 64 pages
SERVE_SUFFIXES = (40, 300, 120, 64, 200, 88)   # each request's own suffix
# TinyLlama's prefill-cell chunk: the 2000-token prompt streams in 8 chunks,
# each a causal forward over [0, end), so the recompute stays at 4.5x the
# prompt's tokens; MiniCPM3's cell keeps the reference's 32-token chunk
DISAGG_CHUNK, MLA_DISAGG_CHUNK = 256, 32
MLA_DISAGG_LENS = (24, 90, 180)                # the reference's MLA cell


def serve_engine(cfg, params, kv_dtype: str = "bf16", **kw) -> NanoCPEngine:
    """The serve phase's engine: (I=4, TP=2) unless ``kw`` says otherwise,
    graphs on, pipelined; every pool's address recorded.  Quantized pools
    keep every step's logits for the tolerance contract."""
    args = dict(num_instances=4, instances_per_node=4,
                kv_capacity_tokens=4096, page_size=16, tp=2,
                buckets=CPBuckets(edges=(100, 256), degrees=(1, 2, 3)))
    if quant.is_quantized(kv_dtype):
        args.update(kv_dtype=kv_dtype, keep_logits=True)
    args.update(kw)
    eng = NanoCPEngine(cfg, params, device=DEV, **args)
    eng.pool_ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    return eng


def count_scatters(eng) -> dict:
    """Count the KV tokens every in-place scatter of ``eng`` writes
    (prefill, chunk stream, re-prefill)."""
    n = {"tokens": 0}
    inner = eng._scatter.scatter_kv

    def scatter_kv(state, k, v, coords):
        n["tokens"] += int(coords.shape[1])
        return inner(state, k, v, coords)
    eng._scatter.scatter_kv = scatter_kv
    return n


def serve_drain(eng, on_step=None, max_steps: int = 400) -> dict:
    """Step ``eng`` until nothing is pending; returns the host-clock sums
    of its prefill and handoff timings."""
    t = {"prefill_us": 0.0, "handoff_us": 0.0, "steps": 0}
    for step in range(max_steps):
        if not eng.pending:
            return t
        if on_step is not None:
            on_step(step)
        eng.step()
        t["steps"] += 1
        for k in ("prefill_us", "handoff_us"):
            t[k] += eng.timings.get(k, 0.0)
    fail(f"serve: run exceeded {max_steps} steps")


def serve_audit(eng, tag: str) -> dict:
    """The end of a serve cell: drained, no frame leaked or aliased, no
    pool moved (every write outside the step landed in place), every
    bucket's graph captured once, at its first step, and replayed under
    its in-place audit (a moved pointer raises at the replay)."""
    cl = eng.cluster
    if cl.active or cl.waiting or cl.prefilling or eng._inflight is not None:
        fail(f"{tag}: the engine did not drain")
    fpi = cl.page_table.frames_per_instance
    for s, (free, held) in cl.page_table.frame_audit().items():
        ok = (held == 0 and free in (0, fpi) if s in cl.dead_instances
              else free + held == fpi)
        if not ok:
            fail(f"{tag}: instance {s} frames free {free} held {held}")
    if {k: v.data_ptr() for k, v in eng.state.items()} != eng.pool_ptrs:
        fail(f"{tag}: a pool moved")
    st = eng.aot.stats
    if (st.donation_copies or st.captured != eng.aot.num_graphs
            or st.online_compiles != eng.aot.num_graphs or st.hits < 1):
        fail(f"{tag}: graphs {eng.aot.num_graphs}, {st.as_dict()}")
    return {"graphs": eng.aot.num_graphs, "replays": st.hits,
            "frames_leaked": 0}


def serve_check(cfg, params, eng, prompts: list, tag: str, new_tokens: int,
                kv_dtype: str) -> dict:
    """Every transcript greedy (float32 pools), or held to the tolerance
    contract (quantized pools: tokens with the cache on and off, or with
    prefill cells and colocated, may then differ at near-ties), and every
    paged launch of the pools' page type."""
    pool = eng.state["kv_pool" if cfg.is_mla else "k_pool"]
    pages = str(pool.dtype).replace("torch.", "")
    if set(pa.LAUNCHES_BY_PAGE) != {pages}:
        fail(f"{tag}: paged launches by page type {dict(pa.LAUNCHES_BY_PAGE)}"
             f", pools {pages}")
    if quant.is_quantized(kv_dtype):
        return {"kv_dtype": kv_dtype, **quant_contract(
            cfg, params, prompts, eng, kv_dtype, tag, new_tokens)}
    return {"ties_tolerated": serve_greedy(
        cfg, params, eng, dict(enumerate(prompts)), tag,
        {r: new_tokens for r in range(len(prompts))})}


def serve_greedy(cfg, params, eng, prompts: dict, tag: str,
                 new_tokens: dict) -> int:
    """Transcripts of the requests in ``prompts`` ({rid: prompt}) full
    length (``new_tokens`` {rid: n}) and greedy, teacher-forced."""
    for rid, n in new_tokens.items():
        if len(eng.results[rid].tokens) != n:
            fail(f"{tag}: request {rid} emitted "
                 f"{len(eng.results[rid].tokens)} of {n} tokens")
    rids = sorted(prompts)
    return teacher_forced_check(cfg, params, [prompts[r] for r in rids],
                                {i: eng.results[r] for i, r in
                                 enumerate(rids)}, tag, None)


def serve_prefix_prompts(cfg, seed: int, suffixes) -> list:
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, (SERVE_PREFIX,))
    return [np.concatenate([shared, rng.integers(0, cfg.vocab_size, (n,))])
            for n in suffixes]


def serve_prefix_run(cfg, params, prompts, cache: bool,
                     kv_dtype: str = "bf16") -> dict:
    """The six sharers with staggered arrivals: request 0 prefills (and
    fills the cache) at the first step, then one request arrives before
    each step."""
    eng = serve_engine(cfg, params, kv_dtype, prefix_cache=cache)
    scattered = count_scatters(eng)

    def arrive(step):            # one more sharer before each later step
        if 0 < step < len(prompts):
            eng.add_request(prompts[step], NEW_TOKENS)
    zero_launches()
    eng.add_request(prompts[0], NEW_TOKENS)
    t = serve_drain(eng, on_step=arrive)
    launches = read_launches()
    tag = (f"serve prefix cache {'on' if cache else 'off'}"
           + (f" {kv_dtype}" if quant.is_quantized(kv_dtype) else ""))
    if len(eng.results) != len(prompts):
        fail(f"{tag}: {len(eng.results)} of {len(prompts)} requests arrived")
    hp = eng.hot_path_stats
    want = {"paged_decode": hp["steps"] * cfg.num_layers,
            "flash_fwd": len(prompts) * cfg.num_layers}
    if launches != want:
        fail(f"{tag}: launches {launches}, expected {want}")
    row = {"phase": "serve", "cell": tag, "model": cfg.name,
           "prompt_lens": [len(p) for p in prompts],
           "prefix_hit_tokens": hp["prefix_hit_tokens"],
           "prefix_inserts": hp["prefix_inserts"],
           "scattered_tokens": scattered["tokens"],
           "prefill_ms_per_request": t["prefill_us"] / 1e3 / len(prompts),
           "steps": t["steps"], "launches": launches,
           **serve_check(cfg, params, eng, prompts, tag, NEW_TOKENS,
                         kv_dtype),
           **serve_audit(eng, tag)}
    if cache:
        row["trie"] = eng.prefix_trie.stats()
    row["tokens"] = {r: g.tokens for r, g in eng.results.items()}
    eng.close()
    del eng
    free_memory()
    return row


def serve_fork(cfg, params) -> dict:
    """Fork request 0 mid-decode with a forced divergence token: the
    child shares the parent's full frames and clones the partial tail;
    both lineages are greedy over their own processed sequence."""
    tag = "serve fork"
    prompt = serve_prefix_prompts(cfg, 2, (12,))[0]    # a partial tail page
    eng = serve_engine(cfg, params, prefix_cache=True)
    eng.add_request(prompt, NEW_TOKENS)
    for _ in range(5):
        eng.step()
    if eng._inflight is not None:
        eng._harvest(eng._now())
    parent = eng.results[0].tokens
    k = len(parent)
    if not 3 <= k < NEW_TOKENS:
        fail(f"{tag}: the fork landed at token {k}")
    forced = (parent[-1] + 1) % cfg.vocab_size
    child = eng.fork_request(0, NEW_TOKENS, next_token=forced)
    serve_drain(eng)
    hp = eng.hot_path_stats
    toks, parent = eng.results[child].tokens, eng.results[0].tokens
    if (hp["forks"] != 1 or hp["copy_tokens"] <= 0
            or eng.cluster.page_table.cow_splits < 1):
        fail(f"{tag}: {hp}, cow splits {eng.cluster.page_table.cow_splits}")
    if toks[:k - 1] != parent[:k - 1] or toks[k - 1] != forced:
        fail(f"{tag}: child {toks} does not extend parent {parent[:k]}")
    ties = serve_greedy(cfg, params, eng, {0: prompt}, tag, {0: NEW_TOKENS})
    if len(toks) != NEW_TOKENS:
        fail(f"{tag}: the child emitted {len(toks)} tokens")
    ties += teacher_forced_check(cfg, params, [prompt], {0: eng.results[child]},
                                 f"{tag} child", None, start=k)
    row = {"phase": "serve", "cell": tag, "forked_at": k,
           "copy_tokens": hp["copy_tokens"],
           "cow_splits": eng.cluster.page_table.cow_splits,
           "ties_tolerated": ties, **serve_audit(eng, tag)}
    eng.close()
    del eng
    free_memory()
    return row


def serve_evict(cfg, params) -> dict:
    """Pools of 12 frames per instance at (2, 2): two short sharers finish
    and leave cache-held frames; two requests then grow by decode until
    they spill, and the spill relief evicts the cache's frames before any
    escalation."""
    tag = "serve evict"
    rng = np.random.default_rng(3)
    V = cfg.vocab_size
    shared = rng.integers(0, V, (32,))
    prompts = [np.concatenate([shared, rng.integers(0, V, (8,))]),
               np.concatenate([shared, rng.integers(0, V, (4,))]),
               rng.integers(0, V, (90,)), rng.integers(0, V, (90,))]
    news = [2, 2, 96, 96]
    eng = serve_engine(cfg, params, prefix_cache=True, num_instances=2,
                       instances_per_node=2, kv_capacity_tokens=192,
                       buckets=CPBuckets(edges=(64, 160), degrees=(1, 2, 2)),
                       shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                  s_buckets=(0, 1, 2, 4),
                                                  window=2),
                       max_slots_per_instance=4)
    eng.add_request(prompts[0], news[0])
    eng.step()
    eng.step()
    eng.add_request(prompts[1], news[1])
    serve_drain(eng)
    held = eng.prefix_trie.cached_frames()
    if eng.hot_path_stats["prefix_hit_tokens"] != 32 or held <= 0:
        fail(f"{tag}: hits {eng.hot_path_stats['prefix_hit_tokens']}, "
             f"cached frames {held}")
    eng.add_request(prompts[2], news[2])
    eng.add_request(prompts[3], news[3])
    first = {}

    def watch(step):
        if eng.prefix_trie.evicted_frames and "evict" not in first:
            first["evict"] = step
        if eng.hot_path_stats["spill_escalations"] and "spill" not in first:
            first["spill"] = step
    serve_drain(eng, on_step=watch)
    watch(10**9)
    hp = eng.hot_path_stats
    if ("evict" not in first or first["evict"] > first.get("spill", 10**9)
            or hp["oom_finishes"]):
        fail(f"{tag}: first eviction / spill escalation at {first}, {hp}")
    row = {"phase": "serve", "cell": tag, "cached_frames": held,
           "evicted_frames": eng.prefix_trie.evicted_frames,
           "first_eviction_step": first["evict"],
           "first_spill_escalation_step": first.get("spill"),
           "spill_escalations": hp["spill_escalations"],
           "ties_tolerated": serve_greedy(cfg, params, eng,
                                          dict(enumerate(prompts)), tag,
                                          dict(enumerate(news))),
           **serve_audit(eng, tag)}
    eng.close()
    del eng
    free_memory()
    return row


def serve_prefix_chaos(cfg, params) -> dict:
    """Two sharers of the 1024-token prefix; the instance holding the
    lowest replica of the shared frames is killed mid-decode (between a
    dispatch and its harvest): the trie forgets its replicas and both
    owners re-prefill their lost ranges and finish greedy."""
    tag = "serve prefix-chaos"
    prompts = serve_prefix_prompts(cfg, 4, (40, 120))
    eng = serve_engine(cfg, params, prefix_cache=True)
    eng.add_request(prompts[0], NEW_TOKENS)
    eng.step()
    eng.step()
    eng.add_request(prompts[1], NEW_TOKENS)
    for _ in range(16):
        if not (eng.cluster.waiting
                or eng.hot_path_stats["prefix_hit_tokens"] == 0):
            break
        eng.step()
    trie = eng.prefix_trie
    if eng.hot_path_stats["prefix_hit_tokens"] <= 0:
        fail(f"{tag}: the second request never hit the cache")
    victim = min(i for node in trie.nodes.values() for i in node.replicas)
    eng.step()
    eng.step()
    if eng._inflight is None:
        fail(f"{tag}: no step in flight")
    eng.fail_instance(victim)
    if any(victim in node.replicas for node in trie.nodes.values()):
        fail(f"{tag}: the trie kept replicas of the dead instance")
    serve_drain(eng)
    hp = eng.hot_path_stats
    if (hp["reprefill_tokens"] <= 0 or hp["degraded_finishes"]
            or not all(eng.results[r].recovered for r in (0, 1))):
        fail(f"{tag}: {hp}, recovered "
             f"{[eng.results[r].recovered for r in (0, 1)]}")
    row = {"phase": "serve", "cell": tag, "victim": victim,
           "prefix_hit_tokens": hp["prefix_hit_tokens"],
           "reprefill_tokens": hp["reprefill_tokens"],
           "recovered_tokens": hp["recovered_tokens"],
           "ties_tolerated": serve_greedy(cfg, params, eng,
                                          dict(enumerate(prompts)), tag,
                                          {0: NEW_TOKENS, 1: NEW_TOKENS}),
           **serve_audit(eng, tag)}
    eng.close()
    del eng
    free_memory()
    return row


# --- SLO admission on the virtual model clock ------------------------------ #
def slo_scheduler(buckets, admission, **kw) -> DualBalancedScheduler:
    return DualBalancedScheduler(buckets=buckets, max_batch_per_instance=8,
                                 admission=admission, **kw)


def modeled_iteration_s(cfg, cap: int, buckets) -> float:
    """The latency model's time (H100 datasheet constants) of one decode
    iteration with nothing resident on the cells' (2, 2) geometry: the
    unit of the SLO cells' arrivals and deadlines."""
    sim = ClusterSimulator(cfg, slo_scheduler(buckets, None),
                           num_instances=2, instances_per_node=2,
                           kv_capacity_tokens=cap, page_size=16)
    return sim._iteration_time(_mk_plan(sim.cluster))[0]


def slo_cell(cfg, params, mode: str, T: float) -> dict:
    """One of the reference's SLO cells (``engine_slo.py``) on the clocked
    engine (``slo.run_engine_clocked``): arrivals and deadlines are
    multiples of ``T``, the modeled iteration time; the clock advances by
    the latency model's price of each iteration the engine ran.  Each
    submitted request has exactly one typed outcome, a dropped one has no
    tokens, and every request that ran is greedy."""
    tag = f"serve slo {mode}"
    far = 1e9
    kw, relax_log = {}, []
    cap, slots = 256, 4
    buckets = CPBuckets(edges=(100_000,), degrees=(1, 2))
    if mode == "shed":
        adm = AdmissionController(ttft_slo=20 * T, ttft_slo_long=20 * T,
                                  long_threshold=100_000, preempt=False)
        trace = [(0.0, 200, 40), (0.0, 200, 40), (2 * T, 112, 4)]
    elif mode == "reject":
        adm = AdmissionController(ttft_slo=far, long_threshold=100_000,
                                  max_queue=1, preempt=False)
        trace = [(0.0, 200, 24), (0.0, 200, 24), (T, 112, 4),
                 (2 * T, 112, 4)]
    elif mode == "preempt":
        adm = AdmissionController(ttft_slo=far, long_threshold=100_000,
                                  preempt=True)
        kw = dict(kv_reserve=0, escalate_headroom=16, relax_guard=0,
                  relax_cooldown=64)
        trace = [(0.0, 128, 100), (0.0, 220, 45), (30 * T, 112, 4)]
    else:
        raise ValueError(mode)
    sched = slo_scheduler(buckets, adm, **kw)
    if mode == "preempt":
        orig_relax = sched.relax

        def relax(cluster, force=False, exclude=frozenset()):
            recs = orig_relax(cluster, force=force, exclude=exclude)
            for rec in recs:
                length = (cluster.active[rec.rid].length
                          if rec.rid in cluster.active else None)
                relax_log.append((force, length, rec))
            return recs
        sched.relax = relax
    eng = serve_engine(cfg, params, num_instances=2, instances_per_node=2,
                       kv_capacity_tokens=cap, buckets=buckets,
                       shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4, 8),
                                                  s_buckets=(0, 1, 2, 4),
                                                  window=2),
                       scheduler=sched, max_slots_per_instance=slots)
    wl = Workload(f"slo_{mode}", [TraceRequest(rid, t, n, m)
                                  for rid, (t, n, m) in enumerate(trace)])
    shadow = ClusterSimulator(cfg, slo_scheduler(buckets, None),
                              num_instances=2, instances_per_node=2,
                              kv_capacity_tokens=cap, page_size=16)
    zero_launches()
    fin, sub, now = slo.run_engine_clocked(eng, wl, shadow=shadow,
                                           max_iters=1000)
    launches = read_launches()
    oc = slo_outcomes(eng, fin, sub, tag)
    hp = eng.hot_path_stats
    want = {"shed": {"finished": 2, "shed": 1},
            "reject": {"finished": 3, "rejected": 1},
            "preempt": {"finished": 3}}[mode]
    if {k: v for k, v in oc.items() if v} != want:
        fail(f"{tag}: outcomes {oc}, expected {want}")
    if mode == "shed":
        late = {r.rid: r for r in fin}[2]
        if not late.finish_time > adm.deadline(late):
            fail(f"{tag}: shed before its deadline")
    if mode == "preempt":
        forced = [(ln, rec) for f, ln, rec in relax_log if f]
        if hp["preemptions"] < 1 or not forced:
            fail(f"{tag}: relax-before-reject never fired: {hp}")
        for length, rec in forced:
            if (not set(rec.new_binding) <= set(rec.old_binding)
                    or (length is not None and len(rec.new_binding)
                        < buckets.cp_degree(length))):
                fail(f"{tag}: preemption cut below the bucket degree: {rec}")
    if launches["paged_decode"] != hp["steps"] * cfg.num_layers:
        fail(f"{tag}: launches {launches}, {hp['steps']} steps")
    ran = {r.rid: trace[r.rid][1] for r in fin if r.status == "finished"}
    prompts = {rid: [1 + (rid * 31 + k) % 97 for k in range(trace[rid][1])]
               for rid in ran}
    row = {"phase": "serve", "cell": tag, "outcomes": oc,
           "modeled_iteration_s": T, "modeled_end_s": now,
           "clock": "latency model, H100 datasheet constants (not the card)",
           "shed": hp["shed"], "rejected": hp["rejected"],
           "preemptions": hp["preemptions"], "steps": hp["steps"],
           "launches": launches,
           "ties_tolerated": serve_greedy(
               cfg, params, eng, prompts, tag,
               {rid: trace[rid][2] for rid in ran}),
           **serve_audit(eng, tag)}
    eng.close()
    del eng
    free_memory()
    return row


def slo_outcomes(eng, fin, submitted: int, tag: str) -> dict:
    """Exactly one typed outcome per submitted request; a dropped request
    emitted nothing."""
    rids = [r.rid for r in fin]
    if len(rids) != submitted or len(set(rids)) != submitted:
        fail(f"{tag}: {len(set(rids))} outcomes for {submitted} requests")
    for r in fin:
        if r.status not in slo.OUTCOMES or r.finish_time < 0:
            fail(f"{tag}: request {r.rid} ended {r.status}")
        if r.status in ("shed", "rejected") and eng.results[r.rid].tokens:
            fail(f"{tag}: dropped request {r.rid} emitted tokens")
    return slo.outcome_counts(fin)


def slo_parity(cfg, params, T: float) -> dict:
    """The reference's parity cell: the same trace through the simulator
    and the clocked engine, both pricing with the port's latency model,
    give the same typed-outcome histogram (the shorts finish, the two
    never-placeable long prompts shed)."""
    tag = "serve slo parity"
    buckets = CPBuckets(edges=(128,), degrees=(1, 2))

    def sched():
        adm = AdmissionController(ttft_slo=24 * T, ttft_slo_long=96 * T,
                                  long_threshold=100, preempt=True)
        return slo_scheduler(buckets, adm, kv_reserve=16)

    def sim():
        return ClusterSimulator(cfg, sched(), num_instances=2,
                                instances_per_node=2, kv_capacity_tokens=192,
                                page_size=16)

    wl = slo.make_tiny_trace(6, 2, gap=2 * T, short_len=40, long_len=400,
                             decode=4)
    sim_fin, sim_sub, _ = slo.run_sim_trace(sim(), wl, horizon=5.0)
    eng = serve_engine(cfg, params, num_instances=2, instances_per_node=2,
                       kv_capacity_tokens=192, buckets=buckets,
                       shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4, 8),
                                                  s_buckets=(0, 1, 2, 4),
                                                  window=2),
                       scheduler=sched(), max_slots_per_instance=8)
    fin, sub, now = slo.run_engine_clocked(eng, wl, shadow=sim(),
                                           max_iters=1200)
    oc, sim_oc = slo_outcomes(eng, fin, sub, tag), slo.outcome_counts(sim_fin)
    if sim_sub != sub or oc != sim_oc or oc["finished"] != 6 \
            or oc["shed"] != 2:
        fail(f"{tag}: simulator {sim_oc} vs engine {oc}")
    trace = {t.rid: t for t in wl.requests}
    ran = [r.rid for r in fin if r.status == "finished"]
    prompts = {rid: [1 + (rid * 31 + k) % 97
                     for k in range(trace[rid].prompt_len)] for rid in ran}
    row = {"phase": "serve", "cell": tag, "outcomes": oc,
           "simulator_outcomes": sim_oc, "modeled_iteration_s": T,
           "modeled_end_s": now,
           "clock": "latency model, H100 datasheet constants (not the card)",
           "ties_tolerated": serve_greedy(
               cfg, params, eng, prompts, tag,
               {rid: trace[rid].max_new_tokens for rid in ran}),
           **serve_audit(eng, tag)}
    eng.close()
    del eng
    free_memory()
    return row


# --- disaggregated prefill cells -------------------------------------------- #
def serve_disagg(cfg, params, prompts, tag: str, *, I: int, tp: int, w: int,
                 chunk: int, cells: int, crash: bool = False,
                 new_tokens: int = NEW_TOKENS, record: bool = False,
                 kv_dtype: str = "bf16") -> dict:
    """One engine with ``cells`` prefill cells (0: colocated) on the
    prompts.  Every decode-time binding is decode-only; with ``crash`` the
    cell streaming the longest prompt dies once a chunk of it has landed.
    Host clock per request: from its admission step (staged or prefilled)
    to the end of its first decode dispatch.  ``record`` runs eagerly and
    keeps the largest paged call of the first steps."""
    eng = serve_engine(cfg, params, kv_dtype, num_instances=I,
                       instances_per_node=w, tp=tp, prefill_cells=cells,
                       chunk_tokens=chunk, cuda_graphs=not record)
    scattered = count_scatters(eng)
    for p in prompts:
        eng.add_request(p, new_tokens)
    cl = eng.cluster
    longest = int(np.argmax([len(p) for p in prompts]))
    seen, first_decode, crashed = {}, {}, {}
    handoff_us = 0.0
    cap = LargestPagedCall() if record else None
    zero_launches()
    t_run = time.perf_counter()
    with torch.no_grad():
        for step in range(400):
            if not eng.pending:
                break
            task = eng._handoff.get(longest)
            if (crash and not crashed and task is not None
                    and task.computed >= 1 and not task.done):
                crashed.update(cell=task.instance,
                               streamed=task.streamed_tokens,
                               novel=task.novel_tokens)
                eng.fail_instance(task.instance)
            t0 = time.perf_counter()
            if cap is not None and step < CAPTURE_STEPS:
                with cap:
                    eng.step()
            else:
                eng.step()
            handoff_us += eng.timings.get("handoff_us", 0.0)
            for rid in cl.prefilling:
                seen.setdefault(rid, t0)
            new = [rid for rid, *_ in (eng._inflight.slots if eng._inflight
                                       else ()) if rid not in first_decode]
            if new:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for rid in new:
                    first_decode[rid] = (t1 - seen.get(rid, t0)) * 1e3
            for req in cl.active.values():
                if any(cl.role_of(s) != "decode" for s in req.kv_binding):
                    fail(f"{tag}: request {req.rid} decodes on a prefill "
                         f"cell: {req.kv_binding}")
    launches = read_launches()
    run_s = time.perf_counter() - t_run
    hp = eng.hot_path_stats
    if crash and (not crashed or eng.results[longest].recovered is not True
                  or hp["reprefill_tokens"] <= 0):
        fail(f"{tag}: crash {crashed}, {hp}")
    if cells and (hp["staged"] < 1 or hp["handoff_tokens"]
                  < sum(len(p) for p in prompts)):
        fail(f"{tag}: {hp}")
    want_flash = ((hp["prefill_chunks"] if cells else len(prompts))
                  * cfg.num_layers)
    if (launches["paged_decode"] != hp["steps"] * cfg.num_layers
            or (not crash and launches["flash_fwd"] != want_flash)):
        fail(f"{tag}: launches {launches}, {hp['steps']} steps, flash "
             f"expected {want_flash}")
    row = {"phase": "serve", "cell": tag, "model": cfg.name,
           "mesh": [I, tp], "node_width": w, "prefill_cells": cells,
           "chunk_tokens": chunk if cells else None,
           "prompt_lens": [len(p) for p in prompts],
           "staged": hp["staged"], "prefill_chunks": hp["prefill_chunks"],
           "handoff_tokens": hp["handoff_tokens"],
           "handoff_ms": handoff_us / 1e3,
           "scattered_tokens": scattered["tokens"],
           "prefill_to_first_decode_ms": [first_decode.get(r) for r in
                                          range(len(prompts))],
           "steps": hp["steps"], "run_s": run_s, "launches": launches,
           "recovered": [eng.results[r].recovered
                         for r in range(len(prompts))],
           **serve_check(cfg, params, eng, prompts, tag, new_tokens,
                         kv_dtype)}
    if crash:
        row.update(crash=crashed, reprefill_tokens=hp["reprefill_tokens"])
    if record:
        row["captured"] = cap.args
    else:
        row.update(serve_audit(eng, tag))
    row["tokens"] = {r: g.tokens for r, g in eng.results.items()}
    eng.close()
    del eng
    free_memory()
    return row


def run_serve_phase(cfg, params, ksum: dict) -> dict:
    """Phase 8c (TinyLlama, graphs on, pipelined): the prefix cache on and
    off, fork, eviction under spill, a crash of the instance holding the
    shared frames, the SLO cells on the virtual model clock, and the
    prefill cells at (6, 1) (with a crash of the streaming cell) beside
    the colocated engine, whose eager run gives the paged kernel's call at
    TP 1 (G 8 over 4 kv heads per device) to check and time.  Returns the
    prefill cells' (6, 1) run's row."""
    card, t0 = nvidia_smi(), time.perf_counter()
    rows = []
    with torch.no_grad():
        # on, off, on, off: the first prefill of these lengths pays
        # one-time costs, so each way runs twice and both are reported
        prompts = serve_prefix_prompts(cfg, 1, SERVE_SUFFIXES)
        runs = [serve_prefix_run(cfg, params, prompts, cache)
                for cache in (True, False, True, False)]
        if any(r.pop("tokens") != runs[0]["tokens"] for r in runs[1:]):
            fail("serve prefix: the cache changed the tokens")
        runs[0].pop("tokens")
        for i, r in enumerate(runs):
            r["round"] = 1 + i // 2
        on, off = runs[2], runs[3]
        if (on["prefix_hit_tokens"] <= 0 or off["prefix_hit_tokens"]
                or off["scattered_tokens"] != sum(map(len, prompts))
                or on["scattered_tokens"] >= off["scattered_tokens"]):
            fail(f"serve prefix: on {on}, off {off}")
        # fp8 pools under the cache: the same hits and scatters, the
        # transcripts held to the tolerance contract
        fp8 = serve_prefix_run(cfg, params, prompts, True, kv_dtype="fp8")
        fp8.pop("tokens")
        if (fp8["prefix_hit_tokens"], fp8["scattered_tokens"]) != (
                on["prefix_hit_tokens"], on["scattered_tokens"]):
            fail(f"serve prefix fp8: hits and scatters {fp8} vs float32 {on}")
        rows += runs + [fp8, serve_fork(cfg, params), serve_evict(cfg, params),
                        serve_prefix_chaos(cfg, params)]
        T = modeled_iteration_s(cfg, 256, CPBuckets(edges=(100_000,),
                                                    degrees=(1, 2)))
        rows += [slo_cell(cfg, params, mode, T)
                 for mode in ("shed", "reject", "preempt")]
        rows.append(slo_parity(cfg, params, modeled_iteration_s(
            cfg, 192, CPBuckets(edges=(128,), degrees=(1, 2)))))
        rng = np.random.default_rng(0)
        dprompts = [rng.integers(0, cfg.vocab_size, (L,))
                    for L in PROMPT_LENS]
        geo = dict(I=6, tp=1, w=6, chunk=DISAGG_CHUNK)
        colo = serve_disagg(cfg, params, dprompts, "serve colocated 6x1",
                            cells=0, record=True, **geo)
        for tag, crash in (("serve disagg 6x1", False),
                           ("serve disagg 6x1 crash", True)):
            row = serve_disagg(cfg, params, dprompts, tag, cells=2,
                               crash=crash, **geo)
            if row.pop("tokens") != colo["tokens"]:
                fail(f"{tag}: tokens differ from the colocated engine's")
            rows.append(row)
            if not crash:
                disagg = row
        # fp8 pools with prefill cells: the chunk streams quantize as they
        # land, the transcripts held to the tolerance contract
        row = serve_disagg(cfg, params, dprompts, "serve disagg 6x1 fp8",
                           cells=2, kv_dtype="fp8", **geo)
        row.pop("tokens")
        rows.append(row)
        colo.pop("tokens")
        args = colo.pop("captured")
        rows.append(colo)
        for a in (args, as_bf16_call(args)):
            row = paged_row(a, a[0].dtype, "tp1 main path",
                            name="paged_decode_tp1")
            emit(row)
            ksum.setdefault("paged_decode_tp1", []).append(row)
    for row in rows:
        emit({**row, "card": card})
    emit({"phase": "serve", "ok": True, "cells": len(rows), "card": card,
          "seconds": time.perf_counter() - t0})
    return disagg


def run_serve_mla(cfg, params) -> None:
    """The serve phase's MiniCPM3-4B cell (the reference's MLA disagg
    cell): (8, 1) over two nodes of 4, two prefill cells streaming the
    latent in 32-token chunks, beside the colocated engine; both greedy
    and equal."""
    card, t0 = nvidia_smi(), time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (L,)) for L in MLA_DISAGG_LENS]
    geo = dict(I=8, tp=1, w=4, chunk=MLA_DISAGG_CHUNK)
    with torch.no_grad():
        colo = serve_disagg(cfg, params, prompts, "serve colocated mla 8x1",
                            cells=0, **geo)
        dis = serve_disagg(cfg, params, prompts, "serve disagg mla 8x1",
                           cells=2, **geo)
    if dis.pop("tokens") != colo.pop("tokens"):
        fail("serve disagg mla: tokens differ from the colocated engine's")
    for row in (colo, dis):
        emit({**row, "card": card})
    emit({"phase": "serve", "ok": True, "model": cfg.name, "card": card,
          "seconds": time.perf_counter() - t0})


def run_moe_phase(ksum: dict) -> tuple[dict, dict]:
    """Phase 10: Phi-3.5-MoE at full width, 8 of 32 layers.  Returns the
    (4, 2) runs' rows by name (``both_ways``) and the weights, which the
    serve example reuses."""
    cfg = replace(get_config("phi3.5-moe-42b-a6.6b"), num_layers=PHI_LAYERS,
                  capacity_factor=PHI_CAPACITY_FACTOR)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=DEV,
                                     dtype=torch.float32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit({"phase": "moe", "model": cfg.name, "layers": cfg.num_layers,
          "params": n_params, "param_gb": n_params * 4 / 1e9,
          "init_s": time.perf_counter() - t0,
          "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (L,)) for L in PROMPT_LENS]
    runs = both_ways(cfg, params, prompts, "moe")
    run_engine(cfg, params, prompts, True, tag="moe 2x4 pipelined",
               num_instances=2, instances_per_node=2, tp=4,
               buckets=CPBuckets(edges=(256,), degrees=(1, 2)))
    args, _ = runs["captured"]
    profile_prefill(cfg, params, prompts[int(np.argmax(PROMPT_LENS))])
    for a in (args, as_bf16_call(args)):
        row = paged_row(a, a[0].dtype, "moe main path", name="paged_decode_moe")
        emit(row)
        ksum.setdefault("paged_decode_moe", []).append(row)
    return runs, params


# --------------------------------------------------------------------------- #
# phase 10b: the three examples of examples/torch_*.py
# --------------------------------------------------------------------------- #
EXAMPLES_DIR = Path(__file__).resolve().parent / "examples"
QS_FULL_LR, QS_FULL_STEPS = 3e-5, 10   # ROADMAP queue 3's full-width rate
QS_GRAD_TOL = 1e-4                     # x max|g| per leaf, 2 vs 1 microbatch


def load_example(name: str):
    """Import ``examples/<name>.py`` (the folder is not a package)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_serve_example(params=None) -> dict:
    """The serve example's ``run`` at full width (Phi-3.5-MoE, 8 of 32
    layers, capacity factor 8, float32 ``init_params(seed=0)``: the moe
    phase's weights when given, else made here): one CUDA graph per
    bucket, both kernels launched (paged once per attention layer and
    decode step, flash once per attention layer and prompt), every token
    greedy or a near-tie below GAP_TOL (teacher-forced), drained with no
    frame leaked."""
    ex = load_example("torch_serve_dcp")
    cfg = ex.config()
    if (cfg.num_layers, cfg.capacity_factor) != (PHI_LAYERS,
                                                 PHI_CAPACITY_FACTOR):
        fail(f"serve example: config {cfg.num_layers} layers, capacity "
             f"factor {cfg.capacity_factor}, not the moe phase's")
    card, t0 = nvidia_smi(), time.perf_counter()
    if params is None:
        params = transformer.init_params(cfg, seed=0, device=DEV,
                                         dtype=torch.float32)
    prompts = ex.make_prompts(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t_run = time.perf_counter()
    res = ex.run(cfg, params, prompts, device=DEV)
    launches = read_launches()
    run_s = time.perf_counter() - t_run
    n_attn = attention_layers(cfg)
    want = {"paged_decode": res["iterations"] * n_attn,
            "flash_fwd": len(prompts) * n_attn}
    if launches != want or not all(launches.values()):
        fail(f"serve example: launches {launches}, expected {want}")
    bad, ties = ex.greedy_check(cfg, params, prompts, res["transcripts"],
                                device=DEV, gap_tol=ex.GAP_TOL)
    if bad:
        fail(f"serve example: tokens off greedy (rid, pos, engine, greedy, "
             f"gap): {bad}")
    if (not res["drained"] or res["leaked_frames"]
            or any(len(t) != ex.NEW_TOKENS
                   for t in res["transcripts"].values())):
        fail(f"serve example: drained {res['drained']}, leaked frames "
             f"{res['leaked_frames']}, transcripts {res['transcripts']}")
    aot = res["aot"]
    if aot["captured"] < 1 or aot["hits"] < 1 or aot["donation_copies"]:
        fail(f"serve example: graphs {aot}")
    steps = res["steps"]
    steady = [r for r in steps if r["dispatched"]
              and not r["prefill_ms"] and not r["captured"]]
    steady_ms = sum(r["ms"] for r in steady)
    decode_ms = sum(r["ms"] - r["prefill_ms"] for r in steps)
    decode_tokens = sum(len(t) - 1 for t in res["transcripts"].values())
    row = {"phase": "examples", "example": "examples/torch_serve_dcp.py",
           "model": cfg.name, "layers": cfg.num_layers,
           "capacity_factor": cfg.capacity_factor, "mesh": [4, 2],
           "prompt_lens": list(ex.LENGTHS), "new_tokens": ex.NEW_TOKENS,
           "card": card, "iterations": res["iterations"],
           "launches": launches, "aot": aot,
           "greedy": True, "near_ties": [list(t) for t in ties],
           "leaked_frames": 0,
           "median_graph_step_ms": (statistics.median(r["ms"] for r in
                                                      steady)
                                    if steady else None),
           "graph_steps": len(steady),
           "graph_tokens_per_s": (sum(r["rows"] for r in steady)
                                  / steady_ms * 1e3 if steady else None),
           "step_ms": [r["ms"] for r in steps],
           "prefill_ms": sum(r["prefill_ms"] for r in steps),
           "decode_tokens_per_s": decode_tokens / decode_ms * 1e3,
           "run_s": run_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def quickstart_row(ex, tag: str, cfg, res: dict, launches: int, card: str,
                   peak_gb: float, **extra) -> dict:
    steady = statistics.median(res["step_s"][1:]) * 1e3
    row = {"phase": "examples", "example": "examples/torch_quickstart.py",
           "run": tag, "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "batch": ex.BATCH, "seq": ex.SEQ,
           "num_micro": ex.NUM_MICRO, "card": card,
           "losses": res["losses"], "latest_step": res["latest_step"],
           "flash_launches": launches,
           "median_step_ms": steady,
           "tokens_per_s": ex.BATCH * ex.SEQ / steady * 1e3,
           "peak_gb": peak_gb, **extra}
    emit(row)
    return row


def run_quickstart_examples() -> dict:
    """The quickstart example's ``run`` twice on the card.  Reduced
    TinyLlama (2 layers, bf16 ``init_params(seed=0)``, the example's own
    60 steps at lr 1e-2, a checkpoint every 10): the loss descends from
    step 0 to step 50 and the latest checkpoint is step 50.  Full-width
    TinyLlama-1.1B (float32 weights, seed 0), the same loop at lr 3e-5 for
    10 steps, 2 microbatches: first one step's gradients with 2
    microbatches against 1 (every leaf within QS_GRAD_TOL of its largest
    entry), then the run: the loss of a fixed held-out batch after each
    step descends at every step, the last step's own loss is below the
    first's.  Both launch the flash kernel (forward and remat
    recompute)."""
    ex = load_example("torch_quickstart")
    card = nvidia_smi()
    CKPT_ROOT.mkdir(exist_ok=True)
    rows = {}
    ckdir = tempfile.mkdtemp(prefix="quickstart_", dir=CKPT_ROOT)
    try:
        cfg = ex.reduced_config()
        params = models.init_params(cfg, seed=0, device=DEV)
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        res = ex.run(cfg, params, device=DEV, ckpt_dir=ckdir)
        launches = read_launches()["flash_fwd"]
        rows["reduced"] = quickstart_row(
            ex, "reduced", cfg, res, launches, card,
            torch.cuda.max_memory_allocated() / 1e9)
        losses = res["losses"]
        if (not all(np.isfinite(losses)) or not losses[50] < losses[0]
                or res["latest_step"] != 50 or not launches):
            fail(f"quickstart reduced: losses {losses[0]} -> {losses[50]}, "
                 f"latest checkpoint {res['latest_step']}, flash launches "
                 f"{launches}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del params, res
    free_memory()

    cfg = get_config(ex.ARCH)
    params = models.init_params(cfg, seed=0, device=DEV, dtype=torch.float32)
    batch = data.SyntheticTokens(cfg, batch=ex.BATCH,
                                 seq_len=ex.SEQ).batch_at(0)
    loss_fn = train_step.make_loss_fn(cfg, device=DEV)
    l1, g1 = train_step.accumulate_grads(loss_fn, params, batch, num_micro=1)
    l2, g2 = train_step.accumulate_grads(loss_fn, params, batch,
                                         num_micro=ex.NUM_MICRO)
    worst, worst_leaf = 0.0, None
    for (path, a), b in zip(leaf_paths(g2), leaves(g1)):
        r = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        if r > worst:
            worst, worst_leaf = r, path
    grad_row = {"grad_leaves": len(leaves(g1)), "grad_worst_leaf": worst_leaf,
                "grad_worst_rel": worst, "grad_tol": QS_GRAD_TOL,
                "loss_micro1": float(l1), "loss_micro2": float(l2)}
    del g1, g2
    free_memory()
    if worst > QS_GRAD_TOL:
        fail(f"quickstart full width: {ex.NUM_MICRO}-microbatch grads off the "
             f"1-microbatch ones: {grad_row}")
    # beside each step's loss (on its own batch), the loss on one fixed
    # batch the run never trains on, after each step
    heldout, heldout_losses = data.SyntheticTokens(
        cfg, batch=ex.BATCH, seq_len=ex.SEQ, seed=1).batch_at(0), []

    def on_step(step, p, stats):
        with torch.no_grad():
            heldout_losses.append(float(models.loss_fn(cfg, p, heldout,
                                                       device=DEV)))
    ckdir = tempfile.mkdtemp(prefix="quickstart_", dir=CKPT_ROOT)
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        res = ex.run(cfg, params, device=DEV, steps=QS_FULL_STEPS,
                     lr=QS_FULL_LR, ckpt_dir=ckdir, on_step=on_step)
        launches = read_launches()["flash_fwd"] - QS_FULL_STEPS * \
            attention_layers(cfg)      # less the held-out forwards'
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    rows["full"] = quickstart_row(ex, "full width", cfg, res, launches, card,
                                  peak, lr=QS_FULL_LR,
                                  heldout_losses=heldout_losses, **grad_row)
    # each step's own loss is on a fresh batch (B 8 x S 64: batch noise of
    # a few hundredths); the held-out batch's loss after each step is the
    # one that must descend at every step
    losses = res["losses"]
    want = QS_FULL_STEPS * ex.NUM_MICRO * 2 * attention_layers(cfg)
    if (not all(np.isfinite(losses + heldout_losses))
            or not losses[-1] < losses[0]
            or any(b >= a for a, b in zip(heldout_losses, heldout_losses[1:]))
            or launches != want):
        fail(f"quickstart full width: losses {losses}, held-out losses "
             f"{heldout_losses}, flash launches {launches} (expected {want})")
    del params, res
    free_memory()
    return rows


def run_examples_phase(phi_params: dict | None = None) -> dict:
    """Phase 10b: the serve example on ``phi_params`` (the moe phase's
    weights, emptied here once it has run so that the quickstarts have the
    card; made anew under ``--examples``), then both quickstart runs."""
    t0 = time.perf_counter()
    with torch.no_grad():
        serve = run_serve_example(phi_params)
    if phi_params is not None:
        phi_params.clear()
    free_memory()
    qs = run_quickstart_examples()
    emit({"phase": "examples", "ok": True, "card": nvidia_smi(),
          "seconds": time.perf_counter() - t0})
    return {"serve": serve, **qs}


def perturb_attention(params) -> int:
    """Overwrite every q/k/v bias with N(0, BIAS_STD) and every q/k norm
    scale with 1 + N(0, NORM_STD), from a seeded generator: the init makes
    them 0 and 1, where a dropped branch would not show.  Returns the
    number of leaves overwritten."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    n = 0
    for lp in params["blocks"]["layers"]:
        for name, t in lp["mixer"].items():
            if name not in ("bq", "bk", "bv", "q_norm", "k_norm"):
                continue
            noise = torch.randn(t.shape, generator=gen, device=DEV)
            t.copy_(noise.mul_(BIAS_STD) if name[0] == "b"
                    else noise.mul_(NORM_STD).add_(1.0))
            n += 1
    return n


def run_archetype_phase(phase: str, cfg, ksum: dict, runs, *, name: str,
                        quant=()) -> dict:
    """Phases 11-13: one model at full width (depth as ``cfg`` cuts it),
    random float32 weights (seed 0) with perturbed biases and q/k norm
    scales, through the engine on the main path's traffic: the (4, 2) runs
    with graphs on and off and their profiles (``both_ways``), each of
    ``runs`` ((tag, pipeline, engine settings)) checked teacher-forced,
    each of ``quant``'s kv dtypes under the tolerance contract (recorder
    run) and bit-equal with graphs, its largest paged call re-checked and
    re-timed (summary name ``name``_kv), then the paged kernel re-checked
    and re-timed on the largest call the main path made (``name``).
    Returns the runs' rows by tag (and by kv dtype).  The weights are
    freed."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=DEV,
                                     dtype=torch.float32)
    perturbed = perturb_attention(params)
    torch.cuda.synchronize()
    if not perturbed and (cfg.qkv_bias or cfg.qk_norm or cfg.q_lora_rank):
        fail(f"{phase}: no bias or norm leaf to perturb")
    n_params = sum(t.numel() for t in _leaves(params))
    emit({"phase": phase, "model": cfg.name, "layers": cfg.num_layers,
          "capacity_factor": cfg.capacity_factor if cfg.is_moe else None,
          "params": n_params, "param_gb": n_params * 4 / 1e9,
          "perturbed_leaves": perturbed, "init_s": time.perf_counter() - t0,
          "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (L,)) for L in PROMPT_LENS]
    out = both_ways(cfg, params, prompts, phase)
    out.update({tag: run_engine(cfg, params, prompts, pipeline,
                                tag=f"{phase} {tag}", **kw)
                for tag, pipeline, kw in runs})

    def recheck(args, sc, label, row_name):
        for a in (args, as_bf16_call(args)):
            row = paged_row(a, a[0].dtype, label, scale=sc, name=row_name)
            emit(row)
            ksum.setdefault(row_name, []).append(row)

    for kv_dtype in quant:
        run, out[kv_dtype] = run_pair(cfg, params, prompts, True,
                                      kv_dtype=kv_dtype,
                                      tag=f"{phase} {kv_dtype} pipelined")
        recheck(*run.pop("captured"), f"{phase} main path",
                f"{name}_{kv_dtype}")
    args, sc = out["captured"]
    profile_prefill(cfg, params, prompts[int(np.argmax(PROMPT_LENS))])
    recheck(args, sc, f"{phase} main path", name)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


class LargestFlashCall:
    """While active, wraps ``fa.flash_attention`` and keeps a frozen copy of
    the (q, k, v) and the mask (``causal``) of the call with the largest
    ``key(q, k, causal)`` (by default the longest query: a prefill's
    attention at the main path's shape); calls whose key is None are
    passed over."""

    def __init__(self, key=lambda q, k, causal: q.shape[1]):
        self.args, self.causal, self.best = None, True, None
        self.key = key
        self._launch = fa.flash_attention

    def _record(self, q, k, v, **kw):
        causal = kw.get("causal", True)
        n = self.key(q, k, causal)
        if n is not None and (self.best is None or n > self.best):
            self.args, self.causal, self.best = ((q.clone(), k.clone(),
                                                  v.clone()), causal, n)
        return self._launch(q, k, v, **kw)

    def __enter__(self):
        fa.flash_attention = self._record
        return self

    def __exit__(self, *exc):
        fa.flash_attention = self._launch


def perturb_ssm(params) -> int:
    """Overwrite the SSD vectors the init makes 0, 1 or -2, from a seeded
    generator, so that a dropped term shows: A_log and dt_bias shifted by
    N(0, BIAS_STD), D and the gated norm's scale 1 + N(0, NORM_STD), the
    conv bias N(0, BIAS_STD).  Returns the number of leaves overwritten."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    n = 0
    for lp in params["blocks"]["layers"]:
        for name, t in lp["mixer"].items():
            if name not in ("A_log", "dt_bias", "D", "norm", "conv_b"):
                continue
            noise = torch.randn(t.shape, generator=gen, device=DEV)
            if name in ("A_log", "dt_bias"):
                t.add_(noise.mul_(BIAS_STD))
            elif name == "conv_b":
                t.copy_(noise.mul_(BIAS_STD))
            else:
                t.copy_(noise.mul_(NORM_STD).add_(1.0))
            n += 1
    return n


def run_refusal_cell(cfg, params) -> dict:
    """The reference's chaos ``refusal`` cell on an attention-free model at
    (2, 2), graphs on: ``drain_instance`` raises ``UnsupportedDrainError``
    and changes neither the cluster nor the serve state; ``fail_instance``
    of request 0's slot instance then finishes exactly the requests whose
    slot it held, degraded with a greedy prefix, and the others in full."""
    tag = f"{cfg.name} refusal"
    prompts = chaos_prompts(cfg, (24, 48))
    eng = make_engine(cfg, params, prompts, True, num_instances=2,
                      instances_per_node=2, tp=2,
                      buckets=CPBuckets(edges=(100_000,), degrees=(1, 1)))
    cl = eng.cluster
    with torch.no_grad():
        eng.step()
        eng.step()

        def snapshot():
            torch.cuda.synchronize()
            return (set(cl.dead_instances), dict(cl.slot_map),
                    {r: (q.moe_binding, list(q.kv_binding))
                     for r, q in cl.active.items()},
                    cl.page_table.frame_audit(), dict(eng.hot_path_stats),
                    {k: v.clone() for k, v in eng.state.items()})

        before = snapshot()
        try:
            eng.drain_instance(0)
        except UnsupportedDrainError as err:
            refusal = str(err)
        else:
            fail(f"{tag}: drain_instance did not refuse")
        after = snapshot()
        if after[:5] != before[:5] or any(
                not torch.equal(after[5][k], v) for k, v in before[5].items()):
            fail(f"{tag}: the refused drain changed the cluster or state")
        del before, after
        victim = cl.active[0].moe_binding
        on_victim = {r for r, (i, _) in cl.slot_map.items() if i == victim}
        degraded = eng.fail_instance(victim)
        if {r.rid for r in degraded} != on_victim or 0 not in on_victim:
            fail(f"{tag}: degraded {[r.rid for r in degraded]}, slots on "
                 f"the victim {on_victim}")
        for _ in range(NEW_TOKENS + 64):
            if not eng.pending:
                break
            eng.step()
    row = chaos_check(cfg, params, prompts, eng, tag, tuple(on_victim))
    row.update(refusal=refusal, victim=victim, degraded=sorted(on_victim))
    emit(row)
    eng.close()
    del eng
    free_memory()
    return row


def run_ssm_phase(ksum: dict) -> dict:
    """Phase 14: the SSM models.  Mamba2-370M at full depth (attention-free:
    no pools, no paged or flash launch; DCP inapplicable, placement is batch
    balance) and Jamba-v0.1 at full width, one period of its layers (7 SSD
    + 1 attention, MoE on the odd ones, capacity factor 8), random float32
    weights (seed 0) with the SSD vectors perturbed (``perturb_ssm``).
    Each: the main path's traffic at (4, 2) with graphs on and off and the
    profiles (``both_ways``; the eager profile splits the step's device
    time into SSD layers, attention, MoE experts and the rest), the
    2000-token prefill with its SSD scan's share; Mamba-2 the ``refusal``
    cell at (2, 2); Jamba (2, 4) with graphs, and its paged and flash calls
    re-checked and timed at the main path's inputs (``paged_decode_jamba``,
    ``flash_fwd_jamba``).  Returns the runs' rows by model."""
    out = {}
    for label, cfg in (
            ("mamba2", get_config("mamba2-370m")),
            ("jamba", replace(get_config("jamba-v0.1-52b"),
                              num_layers=JAMBA_LAYERS,
                              capacity_factor=JAMBA_CAPACITY_FACTOR))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, seed=0, device=DEV,
                                         dtype=torch.float32)
        perturbed = perturb_ssm(params)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        emit({"phase": "ssm", "model": cfg.name, "layers": cfg.num_layers,
              "attention_layers": attention_layers(cfg),
              "capacity_factor": cfg.capacity_factor if cfg.is_moe else None,
              "params": n_params, "param_gb": n_params * 4 / 1e9,
              "perturbed_leaves": perturbed,
              "init_s": time.perf_counter() - t0,
              "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, (L,)) for L in PROMPT_LENS]
        runs = out[label] = both_ways(cfg, params, prompts, label)
        longest = prompts[int(np.argmax(PROMPT_LENS))]
        profile_prefill(cfg, params, longest)
        if not cfg.has_attention:
            run_refusal_cell(cfg, params)
        else:
            runs["2x4 pipelined"] = run_engine(
                cfg, params, prompts, True, tag=f"{label} 2x4 pipelined",
                num_instances=2, instances_per_node=2, tp=4,
                buckets=CPBuckets(edges=(256,), degrees=(1, 2)))
            args, sc = runs["captured"]
            for a in (args, as_bf16_call(args)):
                row = paged_row(a, a[0].dtype, f"{label} main path",
                                scale=sc, name=f"paged_decode_{label}")
                emit(row)
                ksum.setdefault(row["name"], []).append(row)
            with torch.no_grad(), LargestFlashCall() as rec:
                transformer.forward(cfg, params,
                                    torch.as_tensor(longest, device=DEV)[None])
            for qkv in (rec.args, tuple(t.bfloat16() for t in rec.args)):
                ksum.setdefault(f"flash_fwd_{label}", []).append(
                    flash_row(f"flash_fwd_{label}", *qkv, None, 0, timed=True))
            del rec
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def perturb_encdec(params) -> int:
    """Overwrite every q/k/v bias, MLP bias (``bi``, ``bo``) and layernorm
    bias with N(0, BIAS_STD) and every layernorm scale with
    1 + N(0, NORM_STD), from a seeded generator: the init makes them 0 and
    1, where a dropped branch would not show.  Returns the number of
    leaves overwritten."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    n = 0

    def walk(tree):
        nonlocal n
        for name, t in tree.items():
            if isinstance(t, dict):
                walk(t)
                continue
            if name not in ("bq", "bk", "bv", "bi", "bo", "bias", "scale"):
                continue
            noise = torch.randn(t.shape, generator=gen, device=DEV)
            t.copy_(noise.mul_(NORM_STD).add_(1.0) if name == "scale"
                    else noise.mul_(BIAS_STD))
            n += 1
    walk(params)
    return n


def device_wall_ms(fn, iters: int = 5) -> tuple[float, float]:
    """(device ms, wall ms) of one call of ``fn`` after a warm-up: the
    profiler's kernel time, and the median over ``iters`` calls of host
    enqueue to device end.  For calls of many small kernels, whose host
    enqueue outlasts ``time_ms``'s shield."""
    fn()
    torch.cuda.synchronize()
    wall = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in kernel_events(prof)) / 1e3
    return device, statistics.median(wall)


def whisper_prefill_row(cfg, params, audio) -> dict:
    """Whisper's prefill pieces as the engine runs them, each as device
    and wall time (``device_wall_ms``): the encoder once per group of
    same-shape frame stacks (the two 1500-frame requests in one batch),
    then each request's decoder prefix teacher-forced with KV collection.
    Also how far the batched encode is from the encode of each request
    alone (the engine batches; the greedy check encodes each alone):
    cuBLAS picks its GEMM by M on the card, so a row may differ within
    f32 rounding, and more than ``TOL[float32]`` fails the run."""
    groups = {}
    for i, (frames, _) in enumerate(audio):
        groups.setdefault(frames.shape, []).append(i)
    enc, dec, batch_diff = {}, [], 0.0
    with torch.no_grad():
        for shape, idx in groups.items():
            stack = torch.as_tensor(np.stack([audio[i][0] for i in idx]),
                                    device=DEV)
            enc[f"{shape[0]} x {len(idx)}"] = device_wall_ms(
                lambda: encdec.encode(cfg, params, stack))
            states = encdec.encode(cfg, params, stack)
            for b, i in enumerate(idx):
                if len(idx) > 1:
                    one = encdec.encode(cfg, params, stack[b:b + 1])
                    batch_diff = max(batch_diff, float(
                        (one[0] - states[b]).abs().max()))
                toks = torch.as_tensor(audio[i][1], device=DEV)[None]
                dec.append(device_wall_ms(
                    lambda: encdec.decode_forward(cfg, params, toks,
                                                  states[b:b + 1],
                                                  collect_kv=True)))
    if batch_diff > TOL[torch.float32]:
        fail(f"whisper: the batched encode differs from the single one by "
             f"{batch_diff}")
    n = len(audio)
    row = {"phase": "prefill", "model": cfg.name,
           "frames": [len(f) for f, _ in audio],
           "encode_device_ms_by_group": {k: d for k, (d, _) in enc.items()},
           "encode_wall_ms_by_group": {k: w for k, (_, w) in enc.items()},
           "encode_device_ms_per_request": sum(d for d, _ in enc.values()) / n,
           "encode_wall_ms_per_request": sum(w for _, w in enc.values()) / n,
           "decoder_prefix_device_ms_per_request": sum(d for d, _ in dec) / n,
           "decoder_prefix_wall_ms_per_request": sum(w for _, w in dec) / n,
           "batched_encode_max_abs_diff": batch_diff,
           "batched_encode_bit_equal": batch_diff == 0.0}
    emit(row)
    return row


def run_whisper_crash(cfg, params, audio) -> dict:
    """Whisper under a crash at (4, 2), graphs on, pipelined: after two
    steps an instance holding a shard of request 0's cross KV (not its
    slot's instance) dies.  Every request whose cross KV or slot it held
    finishes degraded with a greedy prefix, never re-prefilled (the
    reference's rule for pinned slots); the others finish in full and
    greedy; the cross pools stay bit-equal to their copy after the
    prefill; no frame stays held and no pool moves."""
    tag = "whisper crash"
    eng = make_engine(cfg, params, audio, True)
    cross = CrossPoolWatch(eng)
    cl = eng.cluster
    pt = cl.page_table
    zero_launches()
    with torch.no_grad():
        eng.step()
        eng.step()
        victim = next((s for s, t in sorted(pt.shard_tokens(0).items())
                       if t > 0 and s != cl.slot_map[0][0]), None)
        if victim is None:
            fail(f"{tag}: request 0's cross KV sits on its slot's instance "
                 f"alone: {pt.shard_tokens(0)}")
        hit = {r for r in cl.active if pt.shard_tokens(r).get(victim, 0) > 0
               or cl.slot_map[r][0] == victim}
        eng.fail_instance(victim)
        for _ in range(NEW_TOKENS + 64):
            if not eng.pending:
                break
            eng.step()
    launches = read_launches()
    hp = dict(eng.hot_path_stats)
    degraded = {r for r, g in eng.results.items() if g.recovered is False}
    if degraded != hit or hp["reprefill_tokens"]:
        fail(f"{tag}: degraded {sorted(degraded)}, hit {sorted(hit)}, "
             f"re-prefilled {hp['reprefill_tokens']} tokens")
    if any(len(eng.results[r].tokens) >= NEW_TOKENS for r in hit):
        fail(f"{tag}: a degraded request emitted every token")
    row = chaos_check(cfg, params, audio, eng, tag, tuple(hit))
    row.update(phase="whisper", victim=victim, degraded=sorted(hit),
               launches=launches, **cross.check(tag))
    emit(row)
    eng.close()
    del eng
    free_memory()
    return row


def run_whisper_phase(ksum: dict) -> dict:
    """Phase 15: whisper-base at full width and depth, random float32
    weights (seed 0) with perturbed biases and layernorms
    (``perturb_encdec``), serving six audio requests (``WHISPER_FRAMES``
    frames, 4-token decoder prefixes, NEW_TOKENS new tokens): the (4, 2)
    runs both ways with their profiles (``both_ways``; every run checks
    the read-only cross pools and that no frame stays held), (2, 4) with
    graphs, the prefill's pieces timed, and the paged and flash kernels
    re-checked and timed at the main path's inputs
    (``paged_decode_whisper``, ``flash_fwd_whisper_enc``,
    ``flash_fwd_whisper_cross``).  Returns the runs' rows."""
    cfg = get_config("whisper-base")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = encdec.init_params(cfg, seed=0, device=DEV, dtype=torch.float32)
    perturbed = perturb_encdec(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit({"phase": "whisper", "model": cfg.name,
          "encoder_layers": cfg.num_encoder_layers,
          "decoder_layers": cfg.num_layers, "params": n_params,
          "param_gb": n_params * 4 / 1e9, "perturbed_leaves": perturbed,
          "init_s": time.perf_counter() - t0,
          "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    rng = np.random.default_rng(0)
    audio = [(rng.standard_normal((L, cfg.d_model)).astype(np.float32),
              rng.integers(0, cfg.vocab_size, (WHISPER_PREFIX,)))
             for L in WHISPER_FRAMES]
    runs = both_ways(cfg, params, audio, "whisper")
    if runs["pipelined"]["max_rounds_used"] < 1:
        fail("whisper: no step routed a query across instances")
    runs["2x4 pipelined"] = run_engine(
        cfg, params, audio, True, tag="whisper 2x4 pipelined",
        num_instances=2, instances_per_node=2, tp=4,
        buckets=CPBuckets(edges=(256,), degrees=(1, 2)))
    run_whisper_crash(cfg, params, audio)
    whisper_prefill_row(cfg, params, audio)
    args, sc = runs["captured"]
    for a in (args, as_bf16_call(args)):
        row = paged_row(a, a[0].dtype, "whisper main path", scale=sc,
                        name="paged_decode_whisper")
        emit(row)
        ksum.setdefault(row["name"], []).append(row)
    # the encoder's self-attention (the 1500-frame pair, batched) and a
    # 1500-frame request's cross-attention, at the main path's inputs
    stack = torch.as_tensor(np.stack([audio[0][0], audio[1][0]]), device=DEV)
    with torch.no_grad():
        with LargestFlashCall(key=lambda q, k, causal: None if causal or
                              q.shape[1] != k.shape[1] else q.shape[1]) as enc:
            states = encdec.encode(cfg, params, stack)
        with LargestFlashCall(key=lambda q, k, causal: None if causal or
                              q.shape[1] == k.shape[1] else k.shape[1]) as xat:
            encdec.decode_forward(cfg, params, torch.as_tensor(
                audio[0][1], device=DEV)[None], states[:1])
    for name, rec in (("flash_fwd_whisper_enc", enc),
                      ("flash_fwd_whisper_cross", xat)):
        for qkv in (rec.args, tuple(t.bfloat16() for t in rec.args)):
            ksum.setdefault(name, []).append(
                flash_row(name, *qkv, None, 0, timed=True, causal=False))
    del params, states, enc, xat
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------------------- #
# phase 16: training
# --------------------------------------------------------------------------- #
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5   # 2048: TinyLlama's context
TRAIN_SAVE_AFTER = 3
# the reference smoke test's schedule (warmup 2, total 10) at lr 3e-5: its
# lr 1e-3 is sized for 2-layer d-64 models; on an H100 at full width 1e-3
# raised the loss from 10.84 to 12.28 in 5 steps, 3e-4 to 13.42; 1e-4
# ended lower but not monotonically (10.84 ... 9.93); 3e-5 descends at
# every step
TRAIN_OPT = optimizer.AdamWConfig(lr=3e-5, warmup_steps=2, total_steps=10)
REMAT_LOSS_TOL = 1e-6            # relative, across "none" / "dots" / "full"
PARITY_LOSS_TOL, PARITY_GRAD_TOL = 1e-5, 1e-3
REDUCED_LOSS_TOL = 1e-4
# (name, B, Sq, Skv, Hq, Hkv, Dk, Dv, causal): the train step's own call
# (TinyLlama, B 4 x S 2048), TinyLlama's and MiniCPM3's 2000-token prefill,
# whisper's encoder and a cross-attention call (256: whisper-base's
# max_target_positions, over 1500 frames)
GRAD_SHAPES = (("tinyllama_train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 4,
                64, 64, True),
               ("tinyllama", 1, 2000, 2000, 32, 4, 64, 64, True),
               ("mla", 1, 2000, 2000, 40, 40, 96, 64, True),
               ("whisper_enc", 2, 1500, 1500, 8, 8, 64, 64, False),
               ("cross", 2, 256, 1500, 8, 8, 64, 64, False))
REDUCED_ARCHS = tuple(CONFIGS)          # all 11, deepseek-v3 included
CKPT_ROOT = Path(__file__).resolve().parent / "build"


def leaf_paths(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree in ``leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def flash_grad_row(gen, name, B, Sq, Skv, Hq, Hkv, Dk, Dv, causal,
                   dtype) -> dict:
    """The op's (dq, dk, dv) against autograd through the plain version on
    the same inputs and cotangent (f32: max|d| <= 1e-4 max|ref|; bf16
    2e-2); the op's forward + ported backward timed beside autograd
    through the plain version, SDPA forward + backward and the bounds (the
    backward's: 2.5x the forward's operations)."""
    dn = str(dtype).replace("torch.", "")
    mk = lambda *s: torch.randn(*s, device=DEV, generator=gen).to(dtype)
    q, k, v = mk(B, Sq, Hq, Dk), mk(B, Skv, Hkv, Dk), mk(B, Skv, Hkv, Dv)
    do = mk(B, Sq, Hq, Dv)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    zero_launches()
    out, lse = fa.flash_attention(*qkv, causal=causal)
    g_op = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    if fa.LAUNCHES != 1:
        fail(f"flash grad {name}: {fa.LAUNCHES} kernel launches, not 1")
    out_ref = ref.flash_attention(*qkv, causal=causal)[0]
    g_ref = torch.autograd.grad(out_ref, qkv, do)
    rel = [float((a.float() - b.float()).abs().max()
                 / b.float().abs().max()) for a, b in zip(g_op, g_ref)]
    with torch.no_grad():
        fwd_err = float((out.float() - out_ref.float()).abs().max())
        fwd_scale = float(out_ref.float().abs().max())
    if fwd_err > TOL[dtype] * fwd_scale:
        fail(f"flash fwd {name} {dn}: max|d| {fwd_err} > {TOL[dtype]} * "
             f"max|ref| {fwd_scale}")
    if max(rel) > TOL[dtype]:
        fail(f"flash grad {name} {dn}: max|d|/max|ref| {rel} > {TOL[dtype]}")
    del g_op, g_ref, out_ref
    od, lsed = out.detach(), lse.detach()
    scale = Dk ** -0.5
    row = {"phase": "train", "name": f"flash_grad_{name}", "dtype": dn,
           "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq, "Hkv": Hkv,
                     "hd": Dk, "dv": Dv, "causal": causal},
           "grad_rel_err": dict(zip(("dq", "dk", "dv"), rel)),
           "fwd_max_abs_err": fwd_err, "fwd_max_abs_ref": fwd_scale,
           "tol": TOL[dtype]}
    with torch.no_grad():          # as the backward pass runs it
        row["fwd_ms"] = time_ms(lambda: fa.flash_attention(q, k, v,
                                                           causal=causal))
        row["fwd_plain_ms"] = time_ms(lambda: ref.flash_attention(
            q, k, v, causal=causal))
        row["bwd_ms"] = time_ms(lambda: fa.flash_backward(
            q, k, v, od, lsed, do, scale=scale, causal=causal))
    row["fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        fa.flash_attention(*qkv, causal=causal)[0], qkv, do))
    row["fwd_bwd_plain_ms"] = time_ms(lambda: torch.autograd.grad(
        ref.flash_attention(*qkv, causal=causal)[0], qkv, do))
    st = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    dot = do.transpose(1, 2)

    def sdpa(backward: bool):
        o = torch.nn.functional.scaled_dot_product_attention(
            *st, is_causal=causal, enable_gqa=Hq != Hkv)
        return torch.autograd.grad(o, st, dot) if backward else o
    try:
        sdpa(True)
        torch.cuda.synchronize()
    except RuntimeError as exc:          # the yardstick, not the port
        row.update(fwd_library_ms=None, fwd_bwd_library_ms=None,
                   library_error=str(exc)[:200])
    else:
        with torch.no_grad():
            row["fwd_library_ms"] = time_ms(lambda: sdpa(False))
        row["fwd_bwd_library_ms"] = time_ms(lambda: sdpa(True))
    by, f = flash_cost(q, k, v, None, 0, causal)
    by_bwd = 2 * nbytes(q, k, v, od) + nbytes(lsed)    # in: q k v o do lse; out: dq dk dv
    row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(by, f, dtype)
    row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(by_bwd, 2.5 * f, dtype)
    row["fwd_bwd_bound_ms"], row["fwd_bwd_bound_by"] = bound_ms(
        by + by_bwd, 3.5 * f, dtype)
    emit(row)
    return row


def train_steps(step_fn, params, opt, batches, first: int, ckpt=None,
                save_after=None) -> tuple:
    """Run ``step_fn`` over ``batches``; returns (params, opt, per-step
    rows).  With ``ckpt``, submits the state after step ``save_after``."""
    rows = []
    for i, batch in enumerate(batches, start=first):
        zero_launches()
        t0 = time.perf_counter()
        params, opt, stats = step_fn(params, opt, batch)
        loss = float(stats["loss"])
        torch.cuda.synchronize()
        rows.append({"step": i, "loss": loss,
                     "grad_norm": float(stats["grad_norm"]),
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "flash_launches": fa.LAUNCHES})
        if not np.isfinite(loss):
            fail(f"train step {i}: loss {loss}")
        if ckpt is not None and i == save_after:
            t0 = time.perf_counter()
            ckpt.submit(i, {"params": params, "opt": opt})
            rows[-1]["submit_s"] = time.perf_counter() - t0
    return params, opt, rows


def grads_under(cfg, params, batch, remat: str) -> tuple:
    """(loss, grads, peak GB, ms, flash launches) of one value-and-grad."""
    loss_fn = train_step.make_loss_fn(cfg, remat=remat, device=DEV)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = train_step.value_and_grad(loss_fn, params, batch)
    loss = float(loss)
    torch.cuda.synchronize()
    return (loss, grads, torch.cuda.max_memory_allocated() / 1e9,
            (time.perf_counter() - t0) * 1e3, fa.LAUNCHES)


def train_params(cfg, dtype):
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=DEV, dtype=dtype)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def run_train_phase(ksum: dict) -> dict:
    """Phase 16: training.  Flash gradients at five shapes; full-width
    TinyLlama-1.1B (f32 weights, seed 0, ``SyntheticTokens`` B 4 x S 2048,
    seed 0) for 5 AdamW steps under "dots" with an async checkpoint after
    step 3, resumed from disk into fresh tensors for the last 2 (losses
    equal, parameters bit-equal); one value-and-grad from the final state
    under each remat policy (losses equal, peak memory full < dots < none);
    the kernel path against ``FORCE_IMPL = "ref"`` at B 1 x S 2000 under
    "full"; bf16 weights (f32 moments) for 5 steps, one profiled; and one
    train step of each of the 11 reduced configs (bf16; the f32 loss
    against the CPU's)."""
    gen = torch.Generator(device=DEV).manual_seed(21)
    grad_rows = {}
    for shape in GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            grad_rows[(shape[0], dtype)] = flash_grad_row(gen, *shape, dtype)
    free_memory()

    cfg = get_config("tinyllama-1.1b")
    params, init_s = train_params(cfg, torch.float32)
    t0 = time.perf_counter()
    ds = data.SyntheticTokens(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0)
    batches = [ds.batch_at(i) for i in range(TRAIN_STEPS)]
    data_s = time.perf_counter() - t0
    step_fn = train_step.make_train_step(cfg, TRAIN_OPT, remat="dots",
                                         device=DEV)
    opt = optimizer.init_opt_state(params)
    CKPT_ROOT.mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="train_ckpt_", dir=CKPT_ROOT)
    try:
        ckpt = checkpoint.AsyncCheckpointer(ckdir)
        torch.cuda.reset_peak_memory_stats()
        params, opt, rows = train_steps(step_fn, params, opt, batches, 1,
                                        ckpt, TRAIN_SAVE_AFTER)
        peak = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        ckpt.close()
        wait_s = time.perf_counter() - t0
        losses = [r["loss"] for r in rows]
        launches = [r["flash_launches"] for r in rows]
        want = 2 * attention_layers(cfg)
        if not losses[-1] < losses[0]:
            fail(f"train: losses {losses} do not descend")
        if launches != [want] * TRAIN_STEPS:
            fail(f"train: flash launches per dots step {launches}, not {want}")
        steady = statistics.median(r["ms"] for r in rows[1:])
        main = {"phase": "train", "model": cfg.name, "weights": "float32",
                "remat": "dots", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "init_s": init_s, "data_s": data_s, "steps": rows,
                "median_step_ms": steady,
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
                "peak_gb": peak, "flash_launches_per_step": want,
                "ckpt_wait_s": wait_s}
        emit(main)

        # the three remat policies from the final state: one value-and-grad
        batch = batches[-1]
        remat = {}
        for mode in ("full", "dots", "none"):
            loss, grads, pk, ms, nl = grads_under(cfg, params, batch, mode)
            remat[mode] = {"loss": loss, "peak_gb": pk, "ms": ms,
                           "flash_launches": nl}
            del grads
            free_memory()
        l0 = remat["none"]["loss"]
        for mode, r in remat.items():
            if abs(r["loss"] - l0) > REMAT_LOSS_TOL * abs(l0):
                fail(f"train remat {mode}: loss {r['loss']} vs none {l0}")
        pk = [remat[m]["peak_gb"] for m in ("full", "dots", "none")]
        if not pk[0] < pk[1] < pk[2]:
            fail(f"train remat: peak GB full/dots/none {pk} not increasing")
        emit({"phase": "train", "name": "remat", "model": cfg.name,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, **remat})

        # resume from the step-3 checkpoint into fresh tensors: the last two
        # steps again, the same losses and bit-equal parameters
        t0 = time.perf_counter()
        rest = checkpoint.restore(ckdir, {"params": params, "opt": opt},
                                  device=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if checkpoint.latest_step(ckdir) != TRAIN_SAVE_AFTER:
            fail("train checkpoint: LATEST is not the step-3 save")
        rp, _, rrows = train_steps(step_fn, rest["params"], rest["opt"],
                                   batches[TRAIN_SAVE_AFTER:],
                                   TRAIN_SAVE_AFTER + 1)
        del rest
        rl = [r["loss"] for r in rrows]
        bit_equal = all(torch.equal(a, b) for a, b in
                        zip(leaves(rp), leaves(params)))
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(ckdir) for f in fs)
        emit({"phase": "train", "name": "checkpoint", "saved_after_step":
              TRAIN_SAVE_AFTER, "gb": ckpt_bytes / 1e9,
              "submit_s": rows[TRAIN_SAVE_AFTER - 1]["submit_s"],
              "close_wait_s": wait_s, "restore_s": restore_s,
              "losses": rl, "continued_losses": losses[TRAIN_SAVE_AFTER:],
              "params_bit_equal": bit_equal, "deterministic_mode": False})
        if rl != losses[TRAIN_SAVE_AFTER:] or not bit_equal:
            fail(f"train checkpoint: resumed losses {rl} vs "
                 f"{losses[TRAIN_SAVE_AFTER:]}, params bit-equal {bit_equal}")
        del rp
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del opt
    free_memory()

    # the kernel path against the plain one, B 1 x S 2000 under "full"
    ds1 = data.SyntheticTokens(cfg, batch=1, seq_len=2000, seed=1)
    b1 = ds1.batch_at(0)
    loss_k, g_k, _, ms_k, nl = grads_under(cfg, params, b1, "full")
    ops.FORCE_IMPL = "ref"
    try:
        loss_r, g_r, _, ms_r, nl_r = grads_under(cfg, params, b1, "full")
    finally:
        ops.FORCE_IMPL = None
    worst, worst_leaf = 0.0, None
    for (path, a), b in zip(leaf_paths(g_k), leaves(g_r)):
        r = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        if r > worst:
            worst, worst_leaf = r, path
    del g_k, g_r
    row = {"phase": "train", "name": "parity", "model": cfg.name,
           "batch": 1, "seq": 2000, "remat": "full", "loss_kernel": loss_k,
           "loss_ref": loss_r, "loss_rel": abs(loss_k - loss_r) / abs(loss_r),
           "worst_leaf": worst_leaf, "worst_leaf_rel": worst,
           "kernel_ms": ms_k, "ref_ms": ms_r, "kernel_flash_launches": nl,
           "ref_flash_launches": nl_r}
    emit(row)
    if row["loss_rel"] > PARITY_LOSS_TOL or worst > PARITY_GRAD_TOL:
        fail(f"train parity: loss rel {row['loss_rel']}, worst leaf "
             f"{worst_leaf} {worst}")
    if nl != 2 * attention_layers(cfg) or nl_r != 0:
        fail(f"train parity: flash launches {nl} (kernel) / {nl_r} (ref)")
    del params
    free_memory()

    # bf16 weights, f32 moments: 5 steps under "dots", one more profiled
    bparams, binit_s = train_params(cfg, torch.bfloat16)
    bopt = optimizer.init_opt_state(bparams)
    torch.cuda.reset_peak_memory_stats()
    bparams, bopt, brows = train_steps(step_fn, bparams, bopt, batches, 1)
    bpeak = torch.cuda.max_memory_allocated() / 1e9
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with Ranges(BWD_RANGES), torch.profiler.profile(activities=acts) as prof:
        step_fn(bparams, bopt, batches[0])
        torch.cuda.synchronize()
    events = kernel_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    flash_ms = sum(e.self_device_time_total for e in events
                   if "flash_fwd" in e.key) / 1e3
    bwd_ms = sum(float(e.device_time_total) for e in prof.events()
                 if e.name == "flash.backward"
                 and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    bsteady = statistics.median(r["ms"] for r in brows[1:])
    emit({"phase": "train", "model": cfg.name, "weights": "bfloat16",
          "moments": "float32", "remat": "dots", "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "init_s": binit_s, "steps": brows,
          "median_step_ms": bsteady,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / bsteady * 1e3,
          "peak_gb": bpeak, "profiled_device_ms": device_ms,
          "flash_fwd_ms": flash_ms, "flash_fwd_share": flash_ms / device_ms,
          "flash_bwd_ms": bwd_ms, "flash_bwd_share": bwd_ms / device_ms})
    del bparams, bopt
    free_memory()

    run_reduced_train_steps()

    tr = grad_rows[("tinyllama_train", torch.float32)]
    tb = grad_rows[("tinyllama_train", torch.bfloat16)]
    ksum["flash_fwd_train"] = {
        "launches": sum(launches), "launches_per_step": want,
        "max_abs_err": max(r["fwd_max_abs_err"] for (n, d), r in
                           grad_rows.items() if d == torch.float32),
        "grad_rel_err": max(max(r["grad_rel_err"].values()) for (n, d), r in
                            grad_rows.items() if d == torch.float32),
        "ms": tr["fwd_ms"], "plain_ms": tr["fwd_plain_ms"],
        "bound_ms": tr["fwd_bound_ms"], "bound_by": tr["fwd_bound_by"],
        "library_ms": tr["fwd_library_ms"],
        "share_of_bound": tr["fwd_bound_ms"] / tr["fwd_ms"],
        "bf16_ms": tb["fwd_ms"], "bf16_bound_ms": tb["fwd_bound_ms"],
        "bf16_library_ms": tb["fwd_library_ms"],
        "bwd_route": "plain torch (flash_backward), not a kernel",
        "bwd_ms": tr["bwd_ms"], "bwd_bound_ms": tr["bwd_bound_ms"],
        "fwd_bwd_ms": tr["fwd_bwd_ms"],
        "fwd_bwd_plain_ms": tr["fwd_bwd_plain_ms"],
        "fwd_bwd_bound_ms": tr["fwd_bwd_bound_ms"],
        "fwd_bwd_library_ms": tr["fwd_bwd_library_ms"],
        "bf16_bwd_ms": tb["bwd_ms"], "bf16_bwd_bound_ms": tb["bwd_bound_ms"],
        "bf16_fwd_bwd_ms": tb["fwd_bwd_ms"],
        "bf16_fwd_bwd_library_ms": tb["fwd_bwd_library_ms"]}
    return main


def run_reduced_train_steps() -> None:
    """One bf16 train step of each of the 11 reduced configs on the card
    (the reference's smoke test: B 2 x S 64, whisper 32 decoder tokens over
    64 frames): finite loss and grad norm; then the f32 loss (the port's
    init in f32, made on the CPU) on the card against the CPU's."""
    rows = []
    for arch in REDUCED_ARCHS:
        cfg = reduced(CONFIGS[arch])
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)),
                 "targets": rng.integers(0, cfg.vocab_size, (2, 64))}
        if cfg.is_encoder_decoder:
            batch["frames"] = rng.standard_normal(
                (2, 64, cfg.d_model)).astype(np.float32)
            batch["tokens"] = batch["tokens"][:, :32]
            batch["targets"] = batch["targets"][:, :32]
        params = models.init_params(cfg, seed=0, device=DEV)
        step_fn = train_step.make_train_step(cfg, TRAIN_OPT, device=DEV)
        bf = dict(batch, frames=torch.as_tensor(batch["frames"], device=DEV)
                  .to(torch.bfloat16)) if "frames" in batch else batch
        opt = optimizer.init_opt_state(params)
        zero_launches()
        _, _, stats = step_fn(params, opt, bf)
        loss, gn = float(stats["loss"]), float(stats["grad_norm"])
        launches = fa.LAUNCHES
        p32 = models.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
        cpu = float(models.loss_fn(cfg, p32, batch, device="cpu"))
        card = float(models.loss_fn(cfg, map_tree(lambda t: t.to(DEV), p32),
                                    batch, device=DEV))
        row = {"arch": arch, "bf16_loss": loss, "bf16_grad_norm": gn,
               "flash_launches": launches, "f32_loss_card": card,
               "f32_loss_cpu": cpu, "f32_abs_diff": abs(card - cpu)}
        rows.append(row)
        if not (np.isfinite(loss) and np.isfinite(gn)):
            fail(f"reduced train {arch}: loss {loss}, grad norm {gn}")
        if abs(card - cpu) > REDUCED_LOSS_TOL:
            fail(f"reduced train {arch}: f32 loss {card} on the card vs "
                 f"{cpu} on the CPU")
        if cfg.family != "ssm" and launches == 0:
            fail(f"reduced train {arch}: no flash launch")
    emit({"phase": "train", "name": "reduced", "tol": REDUCED_LOSS_TOL,
          "rows": rows})


# --------------------------------------------------------------------------- #
# phase 17: launch — the dry run on meta, TP-16 decode cells on the card
# --------------------------------------------------------------------------- #
# The dry run's configs (every assigned one and DeepSeek-V3) in six
# processes of about equal work (each config's seconds alone on the card's
# host, PR 22: Jamba 13.1, DeepSeek-V3 11.7, Mamba2 10.8, whisper 8.1 of
# which ~5 is the first cell's warm-up, Llama-4 7.8, MiniCPM3 6.3, Phi 4.9,
# Chameleon 4.8, Qwen2.5 4.4, Qwen1.5 2.2, TinyLlama 1.9; 76 s in all)
DRYRUN_GROUPS = (
    ("jamba-v0.1-52b",),
    ("deepseek-v3",),
    ("mamba2-370m", "tinyllama-1.1b"),
    ("whisper-base", "qwen2.5-14b"),
    ("llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b"),
    ("minicpm3-4b", "chameleon-34b", "qwen1.5-0.5b"),
)
DRYRUN_ARCHS = (*ASSIGNED, "deepseek-v3")
LAUNCH_TOL = 2e-2                    # x max|ref|: the bf16 contract
# A one-ulp change in one bf16 attention output moves a random-weight
# stack's logits by a few ulps: the plain step against itself with its
# attention outputs moved by about one ulp (``ulp_noise``) differs by
# 3.5-4.1% of max|ref| on TinyLlama's 22 layers (0.8-1.0% on DeepSeek-V3's
# one).  The logits' gate is LAUNCH_TOL x max|ref| or FLOOR_FACTOR times
# that floor, whichever is larger; every paged call of the step is held to
# LAUNCH_TOL against its plain version on the same inputs.
FLOOR_FACTOR = 2.0
LAUNCH_TIMED = 10                    # steps timed (CUDA events, median)
LAUNCH_CELLS = (
    # (tag, arch, shape, depth cut, pool dtypes): the 512k x 2 cells plan
    # CP 8 over 13 rounds; decode_32k at its full batch of 128 needs 108.6
    # GB of bf16 pools, so it runs at 32 (CP 1, no routing)
    ("a", "tinyllama-1.1b", ShapeCfg("decode_512k_b2", "decode", 524_288, 2),
     None, (torch.float8_e4m3fn, None)),
    ("b", "tinyllama-1.1b", replace(SHAPES["decode_32k"], global_batch=32),
     None, (None,)),
    ("c", "deepseek-v3", ShapeCfg("decode_512k_b2", "decode", 524_288, 2),
     DS_LAYERS, (None,)),
)
_DRYRUN_SCRIPT = """
import json, sys, torch
torch.set_num_threads(1)
torch.cuda.init()
before = torch.cuda.memory_allocated()
from repro_torch.launch import dryrun
try:
    dryrun.main(sys.argv[2:])
    rc = 0
except SystemExit as e:
    rc = e.code or 0
print(json.dumps({"dryrun_rc": rc, "cuda_before": before,
                  "cuda_after": torch.cuda.memory_allocated()}))
sys.exit(rc)
"""


_CHILDREN: list = []         # processes the script started


def run_dryrun() -> dict:
    """The launch layer's dry run of every assigned config and DeepSeek-V3
    at each applicable shape (single pod) on the meta device, in the six
    processes of DRYRUN_GROUPS at once (one CPU thread each, while the card
    idles; beside the other phases it slowed their host-bound steps).
    Every cell must pass, no tensor may leave meta and the device
    allocator must not move."""
    if sorted(a for g in DRYRUN_GROUPS for a in g) != sorted(DRYRUN_ARCHS):
        fail("dry run: DRYRUN_GROUPS must hold each config once")
    root = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    jobs = []
    for i, group in enumerate(DRYRUN_GROUPS):
        out = root / "build" / "dryrun_torch" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "dryrun.log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-c", _DRYRUN_SCRIPT, "--", "--arch",
                 *group, "--out", str(out)], env=env, stdout=log,
                stderr=subprocess.STDOUT)
        _CHILDREN.append(proc)
        jobs.append((proc, out))
    recs, lasts = [], []
    for proc, out in jobs:
        proc.wait(timeout=900)
        text = (out / "dryrun.log").read_text()
        part = json.loads((out / "dryrun.json").read_text())
        bad = [f"{r['arch']}/{r['shape']}: {r.get('error')}" for r in part
               if not r["ok"]]
        if proc.returncode or bad:
            trace = next((r.get("trace", "") for r in part if not r["ok"]),
                         "")
            fail(f"dry run: rc {proc.returncode}, failed {bad}; first "
                 f"failure's trace {trace}; output tail {text[-2000:]}")
        recs += part
        lasts.append(json.loads(text.strip().splitlines()[-1]))
    secs = time.perf_counter() - t0
    want = sum(len(applicable_shapes(get_config(a))) for a in DRYRUN_ARCHS)
    if len(recs) != want:
        fail(f"dry run: {len(recs)} cells, want {want}")
    if any(x["cuda_after"] != x["cuda_before"] for x in lasts):
        fail(f"dry run allocated device memory: {lasts}")
    row = {"phase": "launch", "dryrun_cells": len(recs), "dryrun_s": secs,
           "dryrun_processes": len(jobs),
           "cuda_allocated_before": [x["cuda_before"] for x in lasts],
           "cuda_allocated_after": [x["cuda_after"] for x in lasts],
           "cell_s": {f"{r['arch']}/{r['shape']}": r["total_s"]
                      for r in recs}}
    emit(row)
    print(f"dry run: {len(recs)} cells on meta, all passed, "
          f"{secs:.1f} s", flush=True)
    return row


def stop_children() -> None:
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


class FirstPagedCall:
    """While active, wraps ``pa.paged_decode_attention`` and keeps the
    inputs of its first call: q, block tables and lengths copied, the
    pools by reference (a full-width cell's pools are tens of GB; every
    layer's call has the same shape)."""

    def __init__(self):
        self.args, self.scale = None, None
        self._launch = pa.paged_decode_attention

    def _record(self, q, k, v, bt, lengths, *, scale=None, k_scale=None,
                v_scale=None):
        if self.args is None:
            sc = () if k_scale is None else (k_scale, v_scale)
            self.args = (q.clone(), k, v, bt.clone(), lengths.clone()) + sc
            self.scale = scale
        return self._launch(q, k, v, bt, lengths, scale=scale,
                            k_scale=k_scale, v_scale=v_scale)

    def __enter__(self):
        pa.paged_decode_attention = self._record
        return self

    def __exit__(self, *exc):
        pa.paged_decode_attention = self._launch


def fill_pools(state: dict, seed: int) -> None:
    """Fill the serve state's pools with N(0, 1) values from a seeded
    generator, one layer at a time (an fp8 pool through a bf16 slice)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for name in ("k_pool", "v_pool", "kv_pool"):
        if name not in state:
            continue
        pool = state[name]
        for b in range(pool.shape[0]):
            for a in range(pool.shape[1]):
                sl = pool[b, a]
                if sl.dtype == torch.bfloat16:
                    sl.normal_(generator=gen)
                else:
                    sl.copy_(torch.randn(sl.shape, device=DEV, generator=gen,
                                         dtype=torch.bfloat16))


def gap_ok(got, want, tol_abs: float) -> tuple[int, int]:
    """(mismatched greedy tokens, of them those where the reference's top-2
    gap is at least ``tol_abs``: a real disagreement)."""
    top2 = want.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    diff = got.argmax(-1) != want.argmax(-1)
    return int(diff.sum()), int((diff & (gap >= tol_abs)).sum())


def append_rows(state: dict, tbl: dict, cfg, dims) -> list:
    """Where this step's KV lands in layer 0's pools: (pool name, index)
    for each active slot's append row on each device of its page stripe."""
    _, khs, ps = dcp.attn_tp_geometry(cfg, dims.tp)
    act = (tbl["slot_active"] != 0).nonzero().tolist()
    af = tbl["append_frame"].tolist()
    ao = tbl["append_off"].tolist()
    out = []
    for i, m in act:
        f, o = af[i][m], ao[i][m]
        for j in range(dims.tp):
            if j // khs == f % ps:
                out += [(name, (0, 0, i, j, f // ps, o)) for name in state
                        if name.endswith("pool")]
    return out


class PagedTwin:
    """While active, every paged launch is also run through its plain
    version on the same inputs; keeps the worst max|d| / max|ref| of out
    and lse over the calls (the kernel held against the plain version at
    each layer of the step)."""

    def __init__(self):
        self.worst = 0.0
        self._launch = pa.paged_decode_attention

    def _call(self, *args, **kw):
        o, l = self._launch(*args, **kw)
        o2, l2 = ref.paged_decode_attention(*args, **kw)
        for a, b in ((o, o2), (l, l2)):
            live = b > -1e29 if b is l2 else torch.ones_like(b, dtype=bool)
            d = (a.float() - b.float())[live].abs().max()
            m = b.float()[live].abs().max().clamp(min=1e-30)
            self.worst = max(self.worst, float(d / m))
        return o, l

    def __enter__(self):
        pa.paged_decode_attention = self._call
        return self

    def __exit__(self, *exc):
        pa.paged_decode_attention = self._launch


@contextlib.contextmanager
def ulp_noise(seed: int):
    """The plain paged version with its outputs moved by about one bf16 ulp
    (relative N(0, 2**-9) noise): the step's own sensitivity to a rounding
    change in attention, the floor for any two bf16 paths."""
    plain, gen = ref.paged_decode_attention, torch.Generator(
        device=DEV).manual_seed(seed)

    def noisy(*args, **kw):
        o, l = plain(*args, **kw)
        eps = torch.randn(o.shape, device=o.device, generator=gen)
        return (o.float() * (1 + 2.0 ** -9 * eps)).to(o.dtype), l
    ref.paged_decode_attention = noisy
    try:
        yield
    finally:
        ref.paged_decode_attention = plain


def launch_step_run(tag: str, step, dparams, state, tbl, n_attn: int,
                    page_name: str, rows: list) -> dict:
    """One decode cell's step on the card with its gates: paged launches
    per step, pools written in place (``rows``: this step's append rows,
    checked on a state's first step, when they still hold the fill),
    every paged call within LAUNCH_TOL x max|ref| of its plain version on
    the same inputs, the ``FORCE_IMPL = "ref"`` twin's logits within
    LAUNCH_TOL x max|ref| or FLOOR_FACTOR x the step's noise floor (tokens
    equal but for near-ties), the step repeated and a graph replay
    bit-equal to eager; and its times (eager and replayed)."""
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    before = [state[n][ix].clone() for n, ix in rows or ()]
    zero_launches()
    with FirstPagedCall() as rec:
        out_state, nxt, logits = step(dparams, state, tbl)
    launches = read_launches()["paged_decode"]
    by_page = dict(pa.LAUNCHES_BY_PAGE)
    if launches != n_attn or by_page.get(page_name) != n_attn:
        fail(f"launch {tag}: {launches} paged launches ({by_page}), want "
             f"{n_attn} of {page_name}")
    if any(out_state[k] is not state[k] or state[k].data_ptr() != ptrs[k]
           for k in state):
        fail(f"launch {tag}: the step moved or replaced its state")
    if rows is not None and (not rows or any(
            torch.equal(state[n][ix], b) for (n, ix), b in zip(rows, before))):
        fail(f"launch {tag}: the step's KV did not land in the pools")
    logits, nxt = logits.clone(), nxt.clone()
    ops.FORCE_IMPL = "ref"
    try:
        logits_ref = step(dparams, state, tbl)[2].clone()
        with ulp_noise(0):
            logits_noise = step(dparams, state, tbl)[2].clone()
    finally:
        ops.FORCE_IMPL = None
    with PagedTwin() as twin:
        step(dparams, state, tbl)
    scale = float(logits_ref.abs().max())
    dlogit = float((logits - logits_ref).abs().max())
    floor = float((logits_noise - logits_ref).abs().max())
    if twin.worst > LAUNCH_TOL:
        fail(f"launch {tag}: a paged call differs from its plain version "
             f"by {twin.worst} x max|ref|")
    tol = max(LAUNCH_TOL * scale, FLOOR_FACTOR * floor)
    if not dlogit <= tol:
        fail(f"launch {tag}: |dlogit| {dlogit} vs the plain twin > {tol} "
             f"({LAUNCH_TOL} x {scale}; noise floor {floor})")
    miss, real = gap_ok(logits, logits_ref, tol)
    if real:
        fail(f"launch {tag}: {real} greedy tokens differ from the plain twin "
             "beyond its top-2 gap")
    # the step again, eager, then captured and replayed: all bit-equal
    logits_eager = step(dparams, state, tbl)[2].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(dparams, state, tbl)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = step(dparams, state, tbl)
    graph.replay()
    torch.cuda.synchronize()
    if not (torch.equal(g_out[2], logits) and torch.equal(logits_eager,
                                                          logits)):
        fail(f"launch {tag}: the repeated or replayed step's logits are not "
             "bit-equal to the eager step's")
    eager_ms = time_ms(lambda: step(dparams, state, tbl), iters=LAUNCH_TIMED,
                       warmup=1)
    replay_ms = time_ms(graph.replay, iters=LAUNCH_TIMED)
    del graph, g_out
    return {"logits": logits, "tokens": nxt, "paged_call": rec.args,
            "paged_scale": rec.scale, "launches": launches,
            "twin_dlogit": dlogit, "twin_scale": scale,
            "noise_floor_dlogit": floor, "paged_calls_worst": twin.worst,
            "twin_token_real_misses": real,
            "twin_token_miss": miss, "eager_ms": eager_ms,
            "replay_ms": replay_ms}


def same_layout(a, b) -> bool:
    """Two trees of tensors with equal shapes and dtypes, leaf for leaf."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb))


def run_launch_cell(tag: str, arch: str, shape, layers, pool_dtypes,
                    ksum: dict) -> list:
    """Cell ``tag`` built by the port's ``build_decode_cell`` on the
    virtual production mesh (I 16, TP 16), then materialised on the card
    in the cell's layout: ``init_params(seed=0)`` in bf16,
    ``to_decode_params`` (then ``quantize_decode_weights`` for the fp8
    run); pools filled by a seeded generator; the tables of
    ``plan_decode_cell`` uploaded.  Each pool dtype runs bf16 weights; the
    bf16 pools (last) also run fp8 weights."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = replace(cfg, num_layers=layers)
    mesh = launch_mesh.make_production_mesh()
    cluster, tbl_np, dims = launch_cells.plan_decode_cell(
        cfg, shape, num_instances=launch_cells.INSTANCES_PER_POD,
        tp=mesh.shape["model"])
    n_attn = attention_layers(cfg)
    tbl = routing.DeviceTables(DEV).upload(tbl_np)
    step = dcp.build_decode_step(cfg, dims)
    torch.cuda.reset_peak_memory_stats()
    params = models.init_params(cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    dparams = dcp.to_decode_params(cfg, params, dims.tp)
    del params
    free_memory()
    base = dict(phase="launch", cell=tag, model=cfg.name,
                layers=cfg.num_layers, shape=shape.name,
                seq_len=shape.seq_len, batch=shape.global_batch,
                dims={k: getattr(dims, k) for k in
                      ("M", "S", "N", "MB", "MBT", "W", "num_frames",
                       "rounds_used")},
                cp_histogram={str(k): v for k, v in
                              launch_cells._cp_hist(cluster).items()},
                device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    out_rows = []
    for pool_dtype in pool_dtypes:
        kvd = pool_dtype or torch.bfloat16
        page = str(kvd).replace("torch.", "")
        state = dcp.init_serve_state(cfg, dims, dims.data_size, dtype=kvd,
                                     device=DEV)
        fill_pools(state, seed=1)
        rows = append_rows(state, tbl, cfg, dims)
        weights = ("bf16",) if pool_dtype is not None else ("bf16", "fp8")
        bf16_run = None
        for wname in weights:
            wdt = torch.float8_e4m3fn if wname == "fp8" else None
            cell = launch_cells.build_decode_cell(
                cfg, shape, mesh, kv_dtype=pool_dtype, weight_dtype=wdt)
            if wname == "fp8":
                dparams = dcp.quantize_decode_weights(dparams)
                free_memory()       # the bf16 copies of the cast leaves
            if not (same_layout(dparams, cell.args[0])
                    and same_layout(state, cell.args[1])
                    and cell.meta["dims"]["N"] == dims.N):
                fail(f"launch {tag}: the card's weights or state differ from "
                     "the cell's meta layout")
            label = f"{tag} {cfg.name} {shape.name} w{wname} pools {page}"
            r = launch_step_run(label, step, dparams, state, tbl, n_attn,
                                page, rows if bf16_run is None else None)
            row = {**base, "weights": wname, "pools": page,
                   "paged_launches": r["launches"],
                   "twin_dlogit": r["twin_dlogit"],
                   "twin_max_ref": r["twin_scale"],
                   "twin_token_misses_near_ties": r["twin_token_miss"],
                   "twin_token_real_misses": r["twin_token_real_misses"],
                   "noise_floor_dlogit": r["noise_floor_dlogit"],
                   "paged_calls_worst_rel_err": r["paged_calls_worst"],
                   "step_ms_eager": r["eager_ms"],
                   "step_ms_replay": r["replay_ms"],
                   "weight_bytes": nbytes(*_leaves(dparams)),
                   "pool_bytes": nbytes(*_leaves(state))}
            if wname == "fp8":
                # the cast at use is the only difference: the same step on
                # the fp8 weights dequantized before it is bit-equal
                deq = dcp.dequantize_at_use(dparams)
                if not torch.equal(step(deq, state, tbl)[2], r["logits"]):
                    fail(f"launch {label}: fp8 weights cast at use differ "
                         "from the same weights dequantized before the step")
                del deq
                act = tbl["slot_active"] != 0
                row.update(
                    fp8_bit_equal_to_dequantized=True,
                    fp8_vs_bf16_dlogit=float(
                        (r["logits"] - bf16_run["logits"]).abs().max()),
                    fp8_vs_bf16_max_ref=float(
                        bf16_run["logits"].abs().max()),
                    fp8_vs_bf16_token_agreement=float(
                        (r["tokens"] == bf16_run["tokens"])[act]
                        .float().mean()))
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            emit(row)
            out_rows.append(row)
            args = r.pop("paged_call")
            if wname == "bf16":
                name = f"paged_decode_launch_{tag}" + (
                    "_rawfp8" if pool_dtype is not None else "")
                krow = paged_row(args, args[0].dtype,
                                 f"launch {tag} largest call",
                                 scale=r["paged_scale"], name=name)
                krow["launches"] = r["launches"]
                emit(krow)
                ksum.setdefault(name, []).append(krow)
            del args, cell
            bf16_run = r
        del state, bf16_run, r
        free_memory()
    del dparams, tbl, step
    free_memory()
    return out_rows


def run_launch_phase(ksum: dict) -> dict:
    """Phase 17: the dry run, then decode cells (a), (b), (c)."""
    atexit.register(stop_children)
    t0 = time.perf_counter()
    dry = run_dryrun()
    t1 = time.perf_counter()
    cells_out = {tag: run_launch_cell(tag, arch, shape, layers, pools, ksum)
                 for tag, arch, shape, layers, pools in LAUNCH_CELLS}
    emit({"phase": "launch", "dryrun_s": t1 - t0,
          "cells_s": time.perf_counter() - t1})
    return {"cells": cells_out, "dryrun": dry}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
