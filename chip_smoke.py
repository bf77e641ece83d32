"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py              # every phase, then the result line
    python3 chip_smoke.py --kernels    # phases 1-2 only, no result line

Phases, each printing one JSON line:

  1. device  — the card (name, power limit), CUDA version, kernel build time
               (both kernels are built from src/repro_torch/csrc by nvcc).
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
               kv_len inside one tile and Dk != Dv.
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
               greedy prefix).  No frame leaks.  The TinyLlama weights are
               then freed.
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
               view k[..., :256] of the same bytes).  Its weights are then
               freed.
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
 14. summary — the script's seconds, ``{"kernels": [...]}``, then the last
               line
               ``{"ok": true, "device": {...}}``.

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
Qwen1.5's and Llama-4-Scout's prefill heads.

Any failed check exits non-zero before the last line.  Without CUDA, or
without the repository's ``src/`` beside it, the script fails.
"""
from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
             "False); this script only runs on the GPU")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import moe_parallel  # noqa: E402
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets  # noqa: E402
from repro_torch.core.scheduler import DualBalancedScheduler  # noqa: E402
from repro_torch.kernels import build, quant, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.serving.engine import NanoCPEngine  # noqa: E402

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


def flash_cost(q, k, v, kv_len, q_offset):
    B, Sq, Hq, Dk = q.shape
    Dv = v.shape[-1]
    kl = int(kv_len[0]) if kv_len is not None else k.shape[1]
    pairs = sum(min(r + q_offset + 1, kl) for r in range(Sq))
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


def flash_row(name: str, q, k, v, kl, qo, timed: bool) -> dict:
    """Hold flash against its plain version on (q, k, v, kv_len, q_offset);
    with ``timed`` also time kernel, plain version and SDPA (where SDPA
    takes the shape), beside the bound."""
    dtype = q.dtype
    dn = str(dtype).replace("torch.", "")
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    o, l = fa.flash_attention(q, k, v, kv_len=kl, q_offset=qo)
    o2, l2 = ref.flash_attention(q, k, v, kv_len=kl, q_offset=qo)
    torch.cuda.synchronize()
    err = max(check_close(f"{name} {dn} Sq={Sq} out", o, o2, dtype),
              check_close(f"{name} {dn} Sq={Sq} lse", l, l2, dtype))
    row = {"phase": "kernel", "name": name, "dtype": dn,
           "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq, "Hkv": Hkv,
                     "hd": Dk, "dv": Dv,
                     "kv_len": None if kl is None else kl.tolist(),
                     "q_offset": qo},
           "max_abs_err": err, "tol": TOL[dtype]}
    if timed:
        row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v))
        row["plain_ms"] = time_ms(lambda: ref.flash_attention(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=Hq != Hkv)
        try:
            sdpa()
            torch.cuda.synchronize()
        except RuntimeError as exc:       # the yardstick, not the port
            row["library_ms"], row["library_error"] = None, str(exc)[:200]
        else:
            row["library_ms"] = time_ms(sdpa)
        b, f = flash_cost(q, k, v, kl, qo)
        row["bound_ms"], row["bound_by"] = bound_ms(b, f, dtype)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    emit(row)
    return row


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
                         new_tokens: int | None = NEW_TOKENS) -> int:
    """Every transcript must equal the port's greedy forward: one forward
    per request over prompt + transcript, argmax at every generated
    position.  A divergence is tolerated only where the reference's top-2
    logit gap is below GAP_TOL; it is printed with both values.  With
    ``new_tokens`` None a transcript of any nonzero length must be a
    prefix of greedy (an OOM finish)."""
    ties = 0
    for rid, prompt in enumerate(prompts):
        toks = results[rid].tokens
        if len(toks) != (new_tokens or len(toks)) or not toks:
            fail(f"{tag}: request {rid} emitted {len(toks)} tokens")
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              device=DEV)[None]
        with torch.no_grad():
            logits, _ = transformer.forward(cfg, params, seq)
        lg = logits[0, len(prompt) - 1:].float()
        if not torch.isfinite(lg).all():
            fail(f"{tag}: non-finite reference logits for request {rid}")
        ref_tok = lg.argmax(-1).tolist()
        for t, (got, want) in enumerate(zip(toks, ref_tok)):
            if got == want:
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


def make_engine(cfg, params, prompts, pipeline: bool, *,
                new_tokens: int = NEW_TOKENS, **kw) -> NanoCPEngine:
    """The main path's engine: virtual (I=4, TP=2) mesh, the prompts queued.
    ``kw`` overrides engine settings (kv dtype, the escalation cell's)."""
    args = dict(num_instances=4, instances_per_node=4,
                kv_capacity_tokens=4096, page_size=16, tp=2,
                buckets=CPBuckets(edges=(100, 256), degrees=(1, 2, 3)))
    args.update(kw)
    eng = NanoCPEngine(cfg, params, pipeline=pipeline, device=DEV, **args)
    for p in prompts:
        eng.add_request(p, max_new_tokens=new_tokens)
    return eng


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
    torch.cuda.synchronize()
    pa.LAUNCHES = 0
    pa.LAUNCHES_BY_PAGE.clear()
    fa.LAUNCHES = 0
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
    steps = eng.hot_path_stats["steps"]
    want = {"paged_decode": steps * cfg.num_layers,
            "flash_fwd": len(prompts) * cfg.num_layers}
    if launches != want:
        fail(f"{tag}: launches {launches}, expected {want} "
             f"(steps x layers, prompts x layers)")
    page_name = str(eng.state["kv_pool" if cfg.is_mla else "k_pool"].dtype
                    ).replace("torch.", "")
    if by_page != {page_name: want["paged_decode"]}:
        fail(f"{tag}: paged launches by page type {by_page}, expected all "
             f"{want['paged_decode']} of {page_name}")
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
           "prompt_lens": [len(p) for p in prompts], "new_tokens": new_tokens,
           "steps": steps, "max_rounds_used": rounds, "launches": launches,
           "launches_by_page": by_page}
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
}


class MoERanges:
    """While active, runs each MoE piece of ``MOE_RANGES`` inside a
    ``torch.profiler.record_function`` range of its name, so a trace can
    give the device time of its kernels.  The ranges do not nest.  The
    pieces are swapped on their modules, so a call site that binds one by
    direct import escapes its range: ``range_device_ms`` fails then."""

    def __enter__(self):
        self._saved = []
        for name, sites in MOE_RANGES.items():
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


def range_device_ms(prof, absent=()) -> dict:
    """Device time (ms) of the kernels launched inside each MoE range: the
    host-side range's kernels and its children's.  (The range's device-side
    annotation spans from its first kernel to its last, idle gaps
    included, so it is not used.)  Fails if a range other than those the
    traced path does not run (``absent``) recorded no device time."""
    out = {name: 0.0 for name in MOE_RANGES}
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] += float(e.device_time_total) / 1e3
    for name, ms in out.items():
        if ms <= 0 and name not in absent:
            fail(f"profile: MoE range {name} recorded no device time "
                 f"(a call site no longer goes through "
                 f"{', '.join(attr for _, attr in MOE_RANGES[name])})")
    return out


def kernel_events(prof) -> list:
    """The trace's kernels, averaged by name: a CPU op's entry repeats its
    kernels' device time, and a range's device-side annotation spans its
    kernels, so both are left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in MOE_RANGES]


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
    ranges = contextlib.nullcontext() if cuda_graphs else MoERanges()
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
        row["moe_share"] = {k: v * 1e3 / device_us
                            for k, v in range_device_ms(prof).items()}
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
    captured, prof_e = profile_engine(cfg, params, prompts, cuda_graphs=False)
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
    kernels, the flash kernel's share, and for an MoE model the device time
    of its MoE pieces (``MOE_RANGES``)."""
    toks = torch.as_tensor(prompt, device=DEV)[None]
    with torch.no_grad():
        transformer.forward(cfg, params, toks, collect_kv=True, device=DEV)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with MoERanges(), torch.profiler.profile(activities=acts) as prof:
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
            prof, absent=("moe.all_to_all",))
        row["moe_share"] = {k: v / row["device_ms"] for k, v in ms.items()}
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
    margs, msc = mruns["captured"]
    profile_prefill(mcfg, mparams, mprompts[int(np.argmax(PROMPT_LENS))])
    for a in (margs, as_bf16_call(margs)):
        row = paged_row(a, a[0].dtype, "mla main path", scale=msc)
        emit(row)
        ksum[row["name"]].append(row)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()

    moe_runs = run_moe_phase(ksum)
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
             ds["pipelined"]["launches"]["flash_fwd"])):
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


def run_moe_phase(ksum: dict) -> dict:
    """Phase 10: Phi-3.5-MoE at full width, 8 of 32 layers.  Returns the
    (4, 2) runs' rows by name (``both_ways``)."""
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
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


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
