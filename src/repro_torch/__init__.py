"""PyTorch/CUDA port of the NanoCP serving system (``repro`` is the JAX
reference it is held against).

Same module layout as ``repro``: ``configs`` (model configs), ``kernels``
(hand-written Hopper kernels with their plain torch versions, ``ops``
dispatch by tensor device; the flash forward is an op with a gradient),
``models`` (the prefill and train forward and the loss of the dense GQA,
MLA, MoE, SSM and hybrid families, and the encoder-decoder's encode and
decoder passes), ``core`` (host control plane, the four-phase DCP decode
step on a virtual (instance, tp) mesh, prefill KV scatter, the
per-bucket step cache), ``serving`` (``NanoCPEngine``) and ``training``
(AdamW, the train steps with remat, microbatches and a virtual data
axis, checkpoints in the reference's format, synthetic data).  Imports
torch and numpy only.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for CPU.

    Raises when CUDA is asked for (the default) and absent — a run never
    falls back to the CPU silently.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain torch path")
    return dev
