"""Flash-attention forward with LSE, causal or not: the Hopper kernel and its
plain version; and its gradient.

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

The forward is one op the dispatcher sees, ``repro_torch::flash_fwd``
(``torch.library.custom_op``), so that autograd and selective
checkpointing treat it as one node: its gradient is ``flash_backward``,
and a checkpoint's recompute runs the kernel again rather than replaying
a buffer that a bare ctypes call wrote.  The op's CPU implementation is
the plain forward, so its backward is tested without a card.  As in the
reference's ``custom_vjp``, the LSE output carries no gradient.

``flash_backward`` ports the reference's scanned jnp backward (jnp, not
Pallas: not a TPU kernel), in plain torch on both devices.  It walks kv
blocks of ``DEFAULT_BK`` keys, the last one partial (the reference asserts
Skv % 128 == 0; the forward here takes any Skv), and recomputes each
block's probabilities from the saved LSE under the causal and ``kv_len``
masks; a row that sees no key (``kv_len`` 0: out 0, lse -1e30) gets
probability 0 and no gradient.

``plain`` is the plain torch version (``ref.flash_attention``).
``LAUNCHES`` counts kernel launches (not plain-version calls; a
recompute's launch counts), and ``LAUNCHES_BY_KIND`` counts them by mask:
"causal", "full" (non-causal with Sq == Skv: an encoder's self-attention)
and "cross" (non-causal with Sq != Skv: a decoder's cross-attention over
encoder states).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import NEG_INF, _gqa_expand
from .ref import flash_attention as plain

LAUNCHES = 0
LAUNCHES_BY_KIND: dict = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
DEFAULT_BK = 128          # the backward's kv block, the reference's


@functools.cache
def _bind():
    lib = build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, kv_len, scale: float, causal: bool, q_offset: int):
    """Check what the kernel takes, allocate out/lse and launch it."""
    global LAUNCHES
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
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bind()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B, Sq, Skv, Hq, Hkv, Dk, Dv,
                 float(scale), int(causal), int(q_offset), _DTYPES[q.dtype],
                 stream)
    build.check(rc, "flash_fwd")
    LAUNCHES += 1
    kind = "causal" if causal else ("full" if Sq == Skv else "cross")
    LAUNCHES_BY_KIND[kind] = LAUNCHES_BY_KIND.get(kind, 0) + 1
    return out, lse


@torch.library.custom_op(
    "repro_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? kv_len, float scale, "
           "bool causal, int q_offset) -> (Tensor, Tensor)")
def flash_fwd(q, k, v, kv_len, scale, causal, q_offset):
    """(out, lse): the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                     kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, kv_len, scale, causal, q_offset)


@flash_fwd.register_fake
def _flash_fwd_shapes(q, k, v, kv_len, scale, causal, q_offset):
    B, Sq, Hq, _ = q.shape
    return (q.new_empty((B, Sq, Hq, v.shape[-1])),
            q.new_empty((B, Hq, Sq), dtype=torch.float32))


def _save(ctx, inputs, output):
    q, k, v, kv_len, scale, causal, q_offset = inputs
    ctx.save_for_backward(q, k, v, *output, kv_len)
    ctx.opts = dict(scale=scale, causal=causal, q_offset=q_offset)


def _grad(ctx, do, _dlse):
    q, k, v, out, lse, kv_len = ctx.saved_tensors
    dq, dk, dv = flash_backward(q, k, v, out, lse, do, kv_len=kv_len,
                                **ctx.opts)
    return dq, dk, dv, None, None, None, None


flash_fwd.register_autograd(_grad, setup_context=_save)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, kv_len: torch.Tensor | None = None):
    """See ``ref.flash_attention`` for the exact semantics.

    q [B, Sq, Hq, Dk]; k [B, Skv, Hkv, Dk]; v [B, Skv, Hkv, Dv]; any Sq and
    Skv; float32 or bfloat16.  Returns out [B, Sq, Hq, Dv] in q's dtype and
    lse [B, Hq, Sq] float32.  A row that sees no key (kv_len == 0) gets
    out = 0 from the kernel (the Pallas kernel's behaviour).
    Differentiable in q, k and v (``flash_backward``).
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return flash_fwd(q, k, v, kv_len, float(scale), bool(causal),
                     int(q_offset))


def flash_backward(q, k, v, o, lse, do, *, scale: float, causal: bool,
                   q_offset: int = 0, kv_len: torch.Tensor | None = None):
    """Block-scanned attention backward; returns (dq, dk, dv) in the inputs'
    dtypes.

    q [B, Sq, Hq, Dk]; k/v [B, Skv, Hkv, Dk(v)] (GQA grads sum over the
    group); o/do [B, Sq, Hq, Dv]; lse [B, Hq, Sq] float32 from the forward.
    Computes in float32: delta = sum(do * o), then per kv block
    p = exp(s - lse) under the masks, dv = p^T do, ds = p * (do v^T - delta),
    dq += ds k * scale, dk = ds^T q * scale.  A causal block skips the q
    rows that precede its first key (their p is 0).
    """
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    # [B, H, S, D] float32 layouts: every product below is a batched matmul
    qf = q.float().transpose(1, 2)
    dof = do.float().transpose(1, 2)
    ke = _gqa_expand(k, Hq).float().transpose(1, 2)
    ve = _gqa_expand(v, Hq).float().transpose(1, 2)
    delta = (dof * o.float().transpose(1, 2)).sum(-1)           # [B, Hq, Sq]
    if kv_len is None:
        kv_len = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    rpos = torch.arange(Sq, device=dev) + q_offset
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, Skv, Hkv, Dk), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Skv, Hkv, Dv), dtype=torch.float32, device=dev)
    g = Hq // Hkv
    for c0 in range(0, Skv, DEFAULT_BK):
        c1 = min(c0 + DEFAULT_BK, Skv)
        r0 = min(max(c0 - q_offset, 0), Sq) if causal else 0
        if r0 == Sq:
            continue
        ks, vs = ke[:, :, c0:c1], ve[:, :, c0:c1]
        qs, dos = qf[:, :, r0:], dof[:, :, r0:]
        cpos = torch.arange(c0, c1, device=dev)
        mask = (cpos[None, :] < kv_len[:, None])[:, None, None, :]
        if causal:
            mask = mask & (rpos[r0:, None] >= cpos[None, :])[None, None]
        s = (qs * scale) @ ks.transpose(-1, -2)                 # [B,H,q,k]
        p = torch.exp(torch.where(mask, s - lse[:, :, r0:, None], NEG_INF))
        dp = dos @ vs.transpose(-1, -2)
        ds = p * (dp - delta[:, :, r0:, None])
        dq[:, :, r0:] += (ds @ ks) * scale
        n = c1 - c0
        dv[:, c0:c1] = ((p.transpose(-1, -2) @ dos).transpose(1, 2)
                        .reshape(B, n, Hkv, g, Dv).sum(3))
        dk[:, c0:c1] = ((ds.transpose(-1, -2) @ qs * scale).transpose(1, 2)
                        .reshape(B, n, Hkv, g, Dk).sum(3))
    return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
