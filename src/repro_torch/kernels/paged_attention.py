"""Paged decode attention with LSE: the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::_kernel``
(wrapper ``paged_decode_attention``).  The CUDA source is
``csrc/paged_decode.cu``.

What bounds it on an H100: in principle the K/V bytes.  Each work row has
one query token, so the kernel does about 2*G flops per K/V element it
reads (G = q heads per kv head, 8 on the main path), two orders of
magnitude below the flop/byte ratio at which the tensor cores would
matter; the products stay on CUDA cores.  At decode sizes (a few MB per
call) its time is set by latency instead: each block walks its split's
units one after another, behind barriers, and two launches.  The design:

* split-KV and head groups: the grid is (rows, kv heads x head groups,
  splits); ``plan_heads`` picks the q heads per group and ``plan_split``
  the pages per split from the static shapes alone (no host sync).  A
  group holds all G q heads of its kv head unless their accumulators or
  q outgrow one block (DeepSeek-V3's latent: G 128 x Dv 512 takes 4 groups
  of 32, each reading the pages again); the splits give at least eight
  blocks per SM with full rows.  With more than one split the blocks write
  float32 partials into one scratch tensor that this wrapper allocates,
  and a second small kernel merges them by their log-sum-exp
  (``split_plain`` is the plain mirror of that partition);
* a shared-memory ring keeps up to three 32-token units of pages in
  flight per block, filled by 16-byte ``cp.async`` copies; each staged K
  value is read once, against 8 heads' q held in registers (4 past Dk
  384), and the output accumulators live in registers; scores and
  probabilities pass between the steps of a unit through shared memory;
* strided pools: the pages are passed with their own page, token and head
  strides for k and for v (v may be a view of k, as MLA's latent pool
  is: Dk 288, Dv 256 for MiniCPM3-4B, G = 40 q heads on one latent head;
  Dk 576, Dv 512, G 128 for DeepSeek-V3), never copied, and a latent row
  is staged once.  A pool's last dim must be contiguous and its base and
  strides multiples of 4 bytes (16 for full-width copies); any other
  layout raises.

The DCP step calls it ONCE per attention layer for the whole virtual mesh:
the caller flattens the (instance, tp, frame) pool dims into one page axis
and offsets each device's block-table entries (``core/dcp.py``).

Quantized pools (fp8 e4m3 or int8 pages with per-page float32 scales,
``quant.py``) take the Pallas kernel's quantized branch: the kernel reads
the codes from its ring and applies each page's two scales to the scores
and probabilities, so the pool is never dequantized in device memory.
fp8 or int8 pages passed without scales are raw codes: the same branch
reads them with a unit scale, as the Pallas kernel upcasts such pages.

``plain`` is the plain torch version (``ref.paged_decode_attention``);
the wrapper runs it for CPU tensors and launches the kernel for CUDA ones.
``LAUNCHES`` counts wrapper calls that launched the kernel (one per call,
whether or not the merge kernel ran too), and ``LAUNCHES_BY_PAGE`` counts
them by page dtype name, so a run can tell which variant it went through.
A call made while a CUDA graph is being captured launches nothing: it is
tallied in ``CAPTURED``, and the graph counts it at each replay
(``core/aot.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import merge_lse
from .ref import paged_decode_attention as plain

LAUNCHES = 0
LAUNCHES_BY_PAGE: dict = {}
# calls recorded into the graph under capture, by page dtype name
CAPTURED: dict = {}

_Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# page dtype of a quantized pool -> the C entry's kv_type code
_QUANT_PAGES = {torch.float8_e4m3fn: 1, torch.int8: 2}
# K rows are dotted in at most 5 four-value chunks per lane of 32 (the
# kernel's kMaxChunks): DeepSeek-V3's 576-wide latent fits
MAX_HEAD_DIM = 640
# the kernel's (head, 4-column) accumulators: 16 per thread, 256 threads
MAX_PAIRS = 16 * 256
# shared memory a block may opt in to on sm_90 (H100, H200): 227 KB
SMEM_OPTIN = 232_448
_KPS = 36          # the kernel's score row stride (kPS), in floats
# blocks per SM that ``plan_split`` aims for when every row is full: a
# split's units run one after another, so shorter splits finish sooner
BLOCKS_PER_SM = 8


def count_launches(name: str, n: int = 1) -> None:
    """Count ``n`` launches of the kernel on pages of dtype ``name``."""
    global LAUNCHES
    LAUNCHES += n
    LAUNCHES_BY_PAGE[name] = LAUNCHES_BY_PAGE.get(name, 0) + n


@functools.cache
def _bind():
    lib = build.load("paged_decode")
    fn = lib.paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plan_split(N: int, Hkv: int, MB: int, sms: int) -> int:
    """Pages per split for a call of N rows, Hkv kv heads (times their
    head groups) and MB block-table columns on a card with ``sms`` SMs.
    It takes the fewest splits that give BLOCKS_PER_SM blocks per SM when
    every row is full (one page per split where MB cannot reach that),
    then spreads MB evenly over them.  Static shapes only, so the decode
    step never waits on the device."""
    want = -(-BLOCKS_PER_SM * sms // max(N * Hkv, 1))
    if want <= 1:
        return MB
    if want >= MB:
        return 1
    widest = -(-MB // (want - 1)) - 1      # the most pages with >= want splits
    return -(-MB // -(-MB // widest))


def smem_bytes(gh: int, Dk: int, Dv: int, page_bytes: int, shared: bool,
               pps: int) -> int:
    """Shared memory of one block with the kernel's shallowest ring, as its
    ``launch`` counts it: q, scores and softmax state of ``gh`` heads, the
    split's page ids and scales, and two 32-token units of K rows (and V
    rows unless v is a view of k), each row padded by 16 bytes."""
    r16 = lambda x: -(-x // 16) * 16
    head = r16(4 * (gh * -(-Dk // 4) * 4 + gh * _KPS + 3 * gh + 3 * pps))
    rows = r16(Dk * page_bytes) + 16 + (0 if shared else r16(Dv * page_bytes) + 16)
    return head + max(2 * 32 * rows, 16 * 256)


def plan_heads(G: int, Dk: int, Dv: int, page_bytes: int, shared: bool,
               MB: int) -> int:
    """q heads per head group for kv heads of G q heads: the fewest groups
    (``ceil(G / gh)``, balanced) whose accumulators (gh * Dv/4 pairs) fit
    MAX_PAIRS and whose block fits SMEM_OPTIN with a two-stage ring
    (counting MB page ids, the most a split can hold).  Static shapes
    only."""
    for groups in range(1, G + 1):
        gh = -(-G // groups)
        if (gh * -(-Dv // 4) <= MAX_PAIRS and smem_bytes(
                gh, Dk, Dv, page_bytes, shared, MB) <= SMEM_OPTIN):
            return gh
    raise ValueError(f"paged_decode_attention: Dk {Dk} / Dv {Dv} rows of "
                     f"{page_bytes} bytes do not fit a block even one head "
                     f"at a time{'' if shared else ' (v is not a view of k)'}")


def split_plain(q, k_pages, v_pages, block_tables, lengths, pages_per_split,
                *, heads_per_group=None, scale=None, k_scale=None,
                v_scale=None):
    """The plain mirror of the kernel's partition: each (kv head, head
    group, split) block's (out, lse) over its q heads and its slice of the
    block table and of the lengths, then the splits' LSE merge.  Equals
    ``plain`` up to rounding; split s sees the tokens [s*pps*page,
    (s+1)*pps*page) of each row, group j of a kv head its q heads
    [j*gh, (j+1)*gh)."""
    Hkv = k_pages.shape[2]
    G = q.shape[1] // Hkv
    gh = heads_per_group or G
    if gh < G:
        parts = [split_plain(q[:, h * G + g0:h * G + min(g0 + gh, G)],
                             k_pages[:, :, h:h + 1], v_pages[:, :, h:h + 1],
                             block_tables, lengths, pages_per_split,
                             scale=scale, k_scale=k_scale, v_scale=v_scale)
                 for h in range(Hkv) for g0 in range(0, G, gh)]
        return (torch.cat([o for o, _ in parts], 1),
                torch.cat([l for _, l in parts], 1))
    page, MB = k_pages.shape[1], block_tables.shape[1]
    outs, lses = [], []
    for b0 in range(0, MB, pages_per_split):
        bt = block_tables[:, b0:b0 + pages_per_split]
        ln = (lengths - b0 * page).clamp(0, bt.shape[1] * page)
        o, l = plain(q, k_pages, v_pages, bt, ln.to(lengths.dtype),
                     scale=scale, k_scale=k_scale, v_scale=v_scale)
        outs.append(o)
        lses.append(l)
    return merge_lse(torch.stack(outs), torch.stack(lses))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _page_strides(name: str, pages) -> tuple:
    """The page, token and head strides of a pool, in elements; raises
    unless the last dim is contiguous and the base and strides are
    4-byte multiples (the kernel's narrowest copy)."""
    es = pages.element_size()
    # a dim of size 1 is never stepped over: its stride is moot
    st = tuple(0 if n == 1 else x for n, x in zip(pages.shape, pages.stride()))
    if (st[3] not in (0, 1) or pages.data_ptr() % 4
            or any(x * es % 4 for x in st[:3])):
        raise ValueError(
            f"paged_decode_attention: {name} needs a contiguous last dim and "
            f"4-byte aligned base and strides, got strides {st} at "
            f"{pages.data_ptr():#x} ({pages.dtype})")
    return st[:3]


def _check_scales(k_pages, k_scale, v_scale, device) -> int:
    """The kv_type code of the C entry for these pages and scales; raises
    on any mix the kernel does not take."""
    code = _QUANT_PAGES.get(k_pages.dtype)
    if code is None:
        if k_scale is not None or v_scale is not None:
            raise TypeError(f"paged_decode_attention: scales given for "
                            f"unquantized {k_pages.dtype} pages")
        return 0
    if k_scale is None and v_scale is None:
        return code                          # raw codes: a unit scale
    if k_scale is None or v_scale is None:
        raise TypeError(f"paged_decode_attention: {k_pages.dtype} pages "
                        "take both k_scale and v_scale, or neither")
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
    ``k_scale``/``v_scale`` [P] float32 (neither: a unit scale).  Any head
    dims up to ``MAX_HEAD_DIM`` = 640 (no padding).  The pools are used in
    place with their own strides (see the module note).  Returns out [N, Hq, Dv] in
    q's dtype and lse [N, Hq] float32.
    """
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
    k_st, v_st = _page_strides("k_pages", k_pages), _page_strides("v_pages", v_pages)
    # v a view of k (MLA's latent): the kernel stages each row once
    shared = (v_pages.data_ptr() == k_pages.data_ptr() and v_st == k_st
              and Dv <= Dk)
    q, block_tables, lengths = q.contiguous(), block_tables.contiguous(), lengths.contiguous()
    ks_ptr = vs_ptr = None
    if k_scale is not None:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    scale = scale if scale is not None else Dk ** -0.5
    MB = block_tables.shape[1]
    gh = plan_heads(Hq // Hkv, Dk, Dv, k_pages.element_size(), shared, MB)
    groups = -(-(Hq // Hkv) // gh)
    pps = plan_split(N, Hkv * groups, MB, _sm_count(q.device.index or 0))
    S = -(-MB // pps)
    out = torch.empty((N, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((N, Hq), dtype=torch.float32, device=q.device)
    scratch = (torch.empty(N * Hq * S * (Dv + 1), dtype=torch.float32,
                           device=q.device) if S > 1 and N else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bind()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 ks_ptr, vs_ptr, block_tables.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), lse.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 N, Hq, Hkv, Dk, Dv, page, MB, pps, gh, int(shared),
                 *k_st, *v_st,
                 float(scale), _Q_TYPES[q.dtype], kv_type, stream)
    build.check(rc, "paged_decode")
    name = str(k_pages.dtype).replace("torch.", "")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] = CAPTURED.get(name, 0) + 1
    else:
        count_launches(name)
    return out, lse
