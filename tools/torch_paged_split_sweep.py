"""Time the port's paged-decode kernel against its pages-per-split.

    PYTHONPATH=src python3 tools/torch_paged_split_sweep.py

Needs an NVIDIA GPU.  For MLA's latent call at MiniCPM3-4B's width (G 40
q heads over one latent head of 288, v = k[..., :256]; f32 and bf16 pages,
fp8 codes) and for TinyLlama's main-path call, it prints one JSON line of
kernel times (ms, CUDA events, ``chip_smoke.time_ms``) per pages-per-split
beside the value ``paged_attention.plan_split`` picks.  The planner aims at
eight blocks per SM whatever a block's shared memory allows; the sweep
shows what that costs where only one block fits (MLA's q alone takes 46 KB).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402


def sweep(args, pps_values, **kw) -> dict:
    q, k, v, bt, lengths = args[:5]
    if len(args) == 7:
        kw.update(k_scale=args[5], v_scale=args[6])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = pa.plan_split(q.shape[0], k.shape[2], bt.shape[1], sms)
    plan, out = pa.plan_split, {"planned_pps": planned}
    try:
        for pps in pps_values:
            pa.plan_split = lambda *a, _p=pps: _p
            out[str(pps)] = cs.time_ms(
                lambda: pa.paged_decode_attention(q, k, v, bt, lengths, **kw))
    finally:
        pa.plan_split = plan
    return out


def main() -> None:
    print(cs.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, kv in ((torch.float32, None), (torch.bfloat16, None),
                      (torch.float32, "fp8")):
        args = cs.mla_paged_inputs(dtype, gen)
        if kv:
            args = cs.quantize_pages(args, kv)
        cs.emit({"call": "mla synthetic", "q": str(dtype), "pages": kv or str(dtype),
                 **sweep(args, (1, 2, 3, 4, 6, 8, 12, 24), scale=cs.MLA_SCALE)})
    cs.emit({"call": "tinyllama synthetic", "q": "torch.float32",
             **sweep(cs.paged_inputs(torch.float32, gen), (1, 2, 4, 5, 8, 44))})


if __name__ == "__main__":
    main()
