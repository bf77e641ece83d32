"""Causal flash-attention forward with LSE: the Hopper kernel and its plain
version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::_fwd_kernel``
(wrappers ``_flash_fwd`` / ``flash_attention``).  The CUDA source is
``csrc/flash_fwd.cu``: one block per (q tile of 128 rows in bf16, 64 in
f32; q head; batch) loops over 64-key kv tiles with an online softmax, stops at the tile's causal
limit and at ``kv_len``, and masks ragged tails itself -- the Pallas
version's multiple-of-128 requirement on Sq/Skv does not exist here, and
the caller never pads.

What bounds it on an H100: operations.  A causal prefill over S tokens does
about 2*S*S*(Dk+Dv)/2 flops per head against O(S*(Dk+Dv)) bytes, far above
the card's flop/byte balance.  So the design keeps the products out of
shared memory: K/V tiles arrive through a ``cp.async`` ring, and
the accumulators stay in registers.  bfloat16 inputs run both products on
the tensor cores (``wgmma`` m64n64k16 from two warpgroups of 64 q rows,
operands in 128-byte-swizzled shared memory, f32 accumulate); float32
inputs run on CUDA cores with a 4x4 register micro-tile per thread and
16-byte shared-memory loads (TF32 would break the 1e-4 tolerance the f32
main path is held to).

Only the forward is ported: the reference's ``flash_backward`` is scanned
jnp (no Pallas) and belongs to the training slice (ROADMAP queue 1 item 15).

``plain`` is the plain torch version (``ref.flash_attention``); the wrapper
runs it for CPU tensors and launches the kernel for CUDA ones.
``LAUNCHES`` counts kernel launches (not plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import flash_attention as plain

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.cache
def _bind():
    lib = build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, kv_len: torch.Tensor | None = None):
    """See ``ref.flash_attention`` for the exact semantics.

    q [B, Sq, Hq, Dk]; k [B, Skv, Hkv, Dk]; v [B, Skv, Hkv, Dv]; any Sq and
    Skv; float32 or bfloat16.  Returns out [B, Sq, Hq, Dv] in q's dtype and
    lse [B, Hq, Sq] float32.  A row that sees no key (kv_len == 0) gets
    out = 0 from the kernel (the Pallas kernel's behaviour).
    """
    global LAUNCHES
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                     kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, Hq, Dk = q.shape
    _, Skv, Hkv, Dk2 = k.shape
    Dv = v.shape[-1]
    if (k.shape[0] != B or Dk2 != Dk or v.shape[:3] != (B, Skv, Hkv)
            or Hq % Hkv):
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if max(Dk, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim > {MAX_HEAD_DIM}")
    if kv_len is None:
        kv_len = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise TypeError("flash_attention: kv_len must be int32 [B]")
    devs = {t.device for t in (q, k, v, kv_len)}
    if len(devs) != 1:
        raise ValueError(f"flash_attention: tensors on {devs}")
    q, k, v, kv_len = q.contiguous(), k.contiguous(), v.contiguous(), kv_len.contiguous()
    scale = scale if scale is not None else Dk ** -0.5
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bind()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B, Sq, Skv, Hq, Hkv, Dk, Dv,
                 float(scale), int(causal), int(q_offset), _DTYPES[q.dtype],
                 stream)
    build.check(rc, "flash_fwd")
    LAUNCHES += 1
    return out, lse
