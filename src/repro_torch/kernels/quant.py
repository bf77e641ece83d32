"""Quantized paged-KV formats: storage dtypes, per-page scales, (de)quant
helpers (torch copy of ``repro/kernels/quant.py``).

    kv_dtype   storage dtype          qmax    bytes/value
    --------   --------------------   -----   -----------
    "bf16"     model dtype            -       2.0   (no quantization)
    "fp8"      torch.float8_e4m3fn    448.0   1.0
    "int8"     torch.int8             127.0   1.0

Quantization is symmetric per PAGE: one float32 scale per (layer, instance,
tp, frame) pool page, in the serve state's ``k_scale``/``v_scale``
``[nb, n_attn, I, tp, F']`` beside the pools.  A stored value decodes as
``x_q * scale``; encoding clips ``x / scale`` to ``[-qmax, qmax]``, then
rounds to nearest for int8 (the cast's own rounding for fp8).

The offset-0 rule: a write that lands at page offset 0 resets the page's
scale to the amax/qmax of this call's tokens for the page; a write at a
later offset clips into the page's existing scale.  Derived scales are
floored at ``SCALE_FLOOR``, so every live scale is positive.

Codes and scales equal the JAX package's bit for bit on the same float32
inputs, as that package runs them: inside ``jit`` (its decode step, prefill
scatter and re-shard), XLA turns ``amax / qmax`` into a multiply by the
float32 reciprocal of the constant, so ``amax_scale`` multiplies by it too.
``quantize`` divides by the scale tensor, as XLA does for a runtime divisor.
"""
from __future__ import annotations

import torch

SCALE_FLOOR = 1e-8

# kv_dtype -> (storage dtype or None for "keep model dtype", qmax, bytes/value)
KV_FORMATS: dict = {
    "bf16": (None, None, 2.0),
    "fp8": (torch.float8_e4m3fn, 448.0, 1.0),
    "int8": (torch.int8, 127.0, 1.0),
}


def check_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_FORMATS:
        raise ValueError(
            f"kv_dtype must be one of {sorted(KV_FORMATS)}, got {kv_dtype!r}")
    return kv_dtype


def is_quantized(kv_dtype: str) -> bool:
    return check_kv_dtype(kv_dtype) != "bf16"


def kv_storage_dtype(kv_dtype: str, model_dtype: torch.dtype) -> torch.dtype:
    """Pool element dtype for ``kv_dtype`` (the model dtype for "bf16")."""
    sdt = KV_FORMATS[check_kv_dtype(kv_dtype)][0]
    return model_dtype if sdt is None else sdt


def kv_qmax(kv_dtype: str) -> float:
    """Largest magnitude the storage dtype represents (the quant range)."""
    qmax = KV_FORMATS[check_kv_dtype(kv_dtype)][1]
    if qmax is None:
        raise ValueError("bf16 pools are not quantized")
    return qmax


def kv_bytes_per_value(kv_dtype: str) -> float:
    """Stored bytes per KV element (the ~1/page scale sidecar excluded)."""
    return KV_FORMATS[check_kv_dtype(kv_dtype)][2]


def amax_scale(x: torch.Tensor, kv_dtype: str, *, dim: int = -1) -> torch.Tensor:
    """Per-slice symmetric scale ``max|x| / qmax`` over ``dim`` (as a
    multiply by the float32 ``1 / qmax``), floored at ``SCALE_FLOOR``;
    float32 with ``dim`` reduced away."""
    amax = x.float().abs().amax(dim=dim)
    inv = torch.full_like(amax, 1.0 / kv_qmax(kv_dtype))
    return torch.clamp_min(amax * inv, SCALE_FLOOR)


def quantize(x: torch.Tensor, scale: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Encode ``x`` with the (broadcastable) float32 tensor ``scale``."""
    qmax = kv_qmax(kv_dtype)
    y = torch.clamp(x.float() / scale, -qmax, qmax)
    if kv_dtype == "int8":
        y = torch.round(y)
    return y.to(KV_FORMATS[kv_dtype][0])


def dequantize(x_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Decode stored values with their (broadcastable) page scale -> f32."""
    return x_q.float() * scale


def write_offset0(pool: torch.Tensor, pool_ix: tuple, scale: torch.Tensor,
                  scale_ix: tuple, x: torch.Tensor, fresh: torch.Tensor,
                  at0: torch.Tensor, kv_dtype: str) -> None:
    """Store float values ``x`` [..., d] into a quantized pool under the
    offset-0 rule, in place.

    ``scale[scale_ix]`` and ``pool[pool_ix]`` address each value's page and
    slot (index shape ``x.shape[:-1]``).  Where ``at0`` (the page takes an
    offset-0 write in this call) the page's scale becomes ``fresh``; elsewhere
    it keeps its scale and the value clips into it.  Every value of a page
    must see the same ``at0`` and ``fresh`` (repeated indices then write equal
    scales)."""
    s_eff = torch.where(at0, fresh, scale[scale_ix])
    scale[scale_ix] = s_eff
    pool[pool_ix] = quantize(x, s_eff[..., None], kv_dtype)


__all__ = ["KV_FORMATS", "SCALE_FLOOR", "check_kv_dtype", "is_quantized",
           "kv_storage_dtype", "kv_qmax", "kv_bytes_per_value", "amax_scale",
           "quantize", "dequantize", "write_offset0"]
