"""Public kernel entry points, dispatched by the tensor's device.

CUDA tensor -> the Hopper kernel (``paged_attention.py`` / ``flash_attention.py``);
               the call raises if the kernel cannot build or launch.
CPU tensor  -> the plain torch versions in ``ref.py``.

There is no platform probe and no fallback: a CUDA tensor never reaches
the plain version unless ``FORCE_IMPL = "ref"`` asks for it (tests and
measurement scripts use that to run the plain version on the card).
"""
from __future__ import annotations

from . import flash_attention as fa
from . import paged_attention as pa
from . import ref

FORCE_IMPL: str | None = None     # None (by device) | "ref"

# kv lengths at or above this use the blockwise plain path (no [Sq, Skv]
# score matrix), as ``repro.kernels.ops`` does
BLOCKWISE_THRESHOLD = 2048


def _plain(t) -> bool:
    return FORCE_IMPL == "ref" or t.device.type == "cpu"


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, kv_len=None):
    """Causal attention with LSE.  See ``ref.flash_attention``.

    q [B, Sq, Hq, Dk]; k/v [B, Skv, Hkv, D(v)] (GQA: Hkv divides Hq).
    """
    if _plain(q):
        if k.shape[1] >= BLOCKWISE_THRESHOLD and k.shape[1] % 512 == 0:
            return ref.flash_attention_blockwise(
                q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                kv_len=kv_len)
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset, kv_len=kv_len)
    return fa.flash_attention(q, k, v, causal=causal, scale=scale,
                              q_offset=q_offset, kv_len=kv_len)


def attention(q, k, v, **kw):
    """Attention without the LSE output (same contract as ``flash_attention``)."""
    return flash_attention(q, k, v, **kw)[0]


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           scale: float | None = None, k_scale=None,
                           v_scale=None):
    """Paged decode attention with LSE.  See ``ref.paged_decode_attention``.

    q [N, Hq, Dk]; pages [P, page, Hkv, D]; block_tables [N, MB] int32;
    lengths [N] int32; ``k_scale``/``v_scale`` [P] float32 for quantized
    (fp8/int8) pages.
    """
    if _plain(q):
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          lengths, scale=scale,
                                          k_scale=k_scale, v_scale=v_scale)
    return pa.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                     lengths, scale=scale, k_scale=k_scale,
                                     v_scale=v_scale)


def merge_lse(partial_out, partial_lse, mask=None):
    """CP-shard LSE merge: plain torch on every device (jnp in the reference)."""
    return ref.merge_lse(partial_out, partial_lse, mask)


__all__ = ["flash_attention", "attention", "paged_decode_attention",
           "merge_lse", "FORCE_IMPL"]
