"""Paged decode attention with LSE: the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::_kernel``
(wrapper ``paged_decode_attention``).  The CUDA source is
``csrc/paged_decode.cu``: one block per (work row, kv head); its warps
split the row's pages between them, each with its own online softmax in
float32 shared memory, and merge their states by log-sum-exp at the end.

What bounds it on an H100: the K/V bytes.  Each work row has one query
token, so the kernel does about 2*G flops per K/V element it reads (G = q
heads per kv head, 8 on the main path) — two orders of magnitude below the
flop/byte ratio at which the tensor cores would matter.  The design
therefore reads every K/V byte once per (row, kv head), stages it in shared
memory and computes on CUDA cores.  Split-KV across blocks and cp.async/TMA
staging are the later steps that get it near the bandwidth bound.

The DCP step calls it ONCE per attention layer for the whole virtual mesh:
the caller flattens the (instance, tp, frame) pool dims into one page axis
and offsets each device's block-table entries (``core/dcp.py``).

Quantized pools (fp8 e4m3 or int8 pages with per-page float32 scales,
``quant.py``) take the Pallas kernel's quantized branch: the kernel
dequantizes each page as it stages it, so the pool is never dequantized in
device memory.

``plain`` is the plain torch version (``ref.paged_decode_attention``);
the wrapper runs it for CPU tensors and launches the kernel for CUDA ones.
``LAUNCHES`` counts kernel launches (not plain-version calls), and
``LAUNCHES_BY_PAGE`` counts them by page dtype name, so a run can tell
which variant it went through.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import paged_decode_attention as plain

LAUNCHES = 0
LAUNCHES_BY_PAGE: dict = {}

_Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# page dtype of a quantized pool -> the C entry's kv_type code
_QUANT_PAGES = {torch.float8_e4m3fn: 1, torch.int8: 2}
MAX_HEAD_DIM = 256


@functools.cache
def _bind():
    lib = build.load("paged_decode")
    fn = lib.paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_scales(k_pages, k_scale, v_scale, device) -> int:
    """The kv_type code of the C entry for these pages and scales; raises
    on any mix the kernel does not take."""
    code = _QUANT_PAGES.get(k_pages.dtype)
    if code is None:
        if k_scale is not None or v_scale is not None:
            raise TypeError(f"paged_decode_attention: scales given for "
                            f"unquantized {k_pages.dtype} pages")
        return 0
    if k_scale is None or v_scale is None:
        raise TypeError(f"paged_decode_attention: {k_pages.dtype} pages "
                        "need both k_scale and v_scale")
    P = k_pages.shape[0]
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc.dtype != torch.float32 or sc.shape != (P,) or sc.device != device:
            raise TypeError(f"paged_decode_attention: {name} must be float32 "
                            f"[{P}] on {device}, got {sc.dtype} "
                            f"{tuple(sc.shape)} on {sc.device}")
    return code


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           scale: float | None = None, k_scale=None,
                           v_scale=None):
    """See ``ref.paged_decode_attention`` for the exact semantics.

    q [N, Hq, Dk]; k_pages [P, page, Hkv, Dk]; v_pages [P, page, Hkv, Dv];
    block_tables [N, MB] int32; lengths [N] int32.  q is float32 or
    bfloat16; the pages are in q's dtype, or fp8 e4m3 / int8 codes with
    ``k_scale``/``v_scale`` [P] float32.  Any head dims up to 256 (no
    padding).  Returns out [N, Hq, Dv] in q's dtype and lse [N, Hq] float32.
    """
    global LAUNCHES
    if q.device.type == "cpu":
        return plain(q, k_pages, v_pages, block_tables, lengths, scale=scale,
                     k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    N, Hq, Dk = q.shape
    P, page, Hkv, Dk2 = k_pages.shape
    Dv = v_pages.shape[-1]
    if (Dk2 != Dk or v_pages.shape[:3] != (P, page, Hkv) or Hq % Hkv
            or block_tables.shape[0] != N or lengths.shape != (N,)):
        raise ValueError(
            f"paged_decode_attention: bad shapes q{tuple(q.shape)} "
            f"k{tuple(k_pages.shape)} v{tuple(v_pages.shape)} "
            f"bt{tuple(block_tables.shape)} len{tuple(lengths.shape)}")
    kv_type = _check_scales(k_pages, k_scale, v_scale, q.device)
    if (q.dtype not in _Q_TYPES or v_pages.dtype != k_pages.dtype
            or (kv_type == 0 and k_pages.dtype != q.dtype)):
        raise TypeError(f"paged_decode_attention: q must be float32 or "
                        f"bfloat16 and k/v pages in q's dtype or both fp8 "
                        f"e4m3 / int8, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables/lengths must be int32")
    if max(Dk, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"paged_decode_attention: head dim > {MAX_HEAD_DIM}")
    devs = {t.device for t in (q, k_pages, v_pages, block_tables, lengths)}
    if len(devs) != 1:
        raise ValueError(f"paged_decode_attention: tensors on {devs}")
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    block_tables, lengths = block_tables.contiguous(), lengths.contiguous()
    ks_ptr = vs_ptr = None
    if kv_type:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    scale = scale if scale is not None else Dk ** -0.5
    out = torch.empty((N, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((N, Hq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bind()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 ks_ptr, vs_ptr, block_tables.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), N, Hq, Hkv, Dk, Dv, page,
                 block_tables.shape[1], float(scale), _Q_TYPES[q.dtype],
                 kv_type, stream)
    build.check(rc, "paged_decode")
    LAUNCHES += 1
    name = str(k_pages.dtype).replace("torch.", "")
    LAUNCHES_BY_PAGE[name] = LAUNCHES_BY_PAGE.get(name, 0) + 1
    return out, lse
