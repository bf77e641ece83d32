"""The decode step's routed expert FFN over routed rows only: the Hopper
kernel and its plain version.

Replaces no TPU kernel: the JAX package leaves the decode experts to XLA
(``repro/core/moe_parallel.py::moe_decode_ffn``), and ``core/moe_parallel``
keeps that algorithm as the port's plain path (dispatch, three ``bmm``
over [E, I*C, D] capacity bins, combine).  The CUDA source is
``csrc/moe_experts.cu``.

What bounds it on an H100: the weights of the experts some row reached,
each read once.  The ``bmm`` path computed every slot of every bin, and
where no token may drop (capacity factor E/k) a bin holds C = M slots, the
slot bucket: I*C rows an expert where I*M*k/E are routed on average, and
every expert's weights read whether a row reached it or not.  The design:

* the routing stays in the graph: ``router_topk`` and ``group_by_expert``
  give ``src_token`` and ``slot_of`` as before, and a one-block plan kernel
  counts each (instance, expert) bin's rows on the device, scans them and
  lists the compact rows, expert after expert; no [E, I*C, D] buffer is
  made;
* gate, up and silu * mul in one kernel over (64-column tiles, experts),
  then ``wo`` likewise: a block whose expert has no row returns before it
  reads a weight byte; the others stream their weight tiles through a
  cp.async ring, FFMA against rows held in registers, float32 sums;
* the combine takes each row's k choices in order from the compact
  outputs: no atomics, the same result from run to run.

Row chunk and ring depth follow from the static I*C, D and F and the
weights' dtype (float32 or bfloat16); nothing reads the model's name.

``plain`` is the kernel's arithmetic in torch (the same plan, compact rows
and combine); ``routed_experts`` runs it for CPU tensors and launches the
kernel for CUDA ones.  ``LAUNCHES`` counts wrapper calls that launched
(one per call, four kernels).  A call made while a CUDA graph is being
captured launches nothing: it is tallied in ``CAPTURED`` by weight dtype
name, and the graph counts it at each replay (``core/aot.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

LAUNCHES = 0
# calls recorded into the graph under capture, by weight dtype name
CAPTURED: dict = {}

_TYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TOP_K = 64       # the combine kernel's choices per row (kMaxK)


def count_launches(name: str, n: int = 1) -> None:
    """Count ``n`` launches of the kernel (on weights of dtype ``name``)."""
    global LAUNCHES
    LAUNCHES += n


@functools.cache
def _bind():
    fn = build.load("moe_experts").moe_experts
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plan(src_token: torch.Tensor, T: int, num_experts: int, rows: int):
    """The plan kernel's tables from ``src_token`` [I, E*C] (T = an empty
    slot): (fill [I, E] int32, the kept rows of each bin; boff [E*I + 1]
    int32, where expert e's compact rows are [boff[e*I], boff[(e+1)*I]) and
    bin (i, e)'s slot j is compact row boff[e*I + i] + j; x_row [rows]
    int32, the x row i*T + t of each compact row, -1 past the last)."""
    I = src_token.shape[0]
    E = num_experts
    C = src_token.shape[1] // E
    dev = src_token.device
    src = src_token.reshape(I, E, C).long()
    kept = src < T                                        # a prefix of each bin
    fill = kept.sum(-1)
    boff = torch.zeros(E * I + 1, dtype=torch.long, device=dev)
    boff[1:] = fill.t().reshape(-1).cumsum(0)             # (expert, instance)
    bin_of = torch.arange(E, device=dev) * I + torch.arange(I, device=dev)[:, None]
    at = boff[bin_of][..., None] + torch.arange(C, device=dev)
    x_row = torch.full((rows,), -1, dtype=torch.long, device=dev)
    x_row[at[kept]] = (torch.arange(I, device=dev)[:, None, None] * T + src)[kept]
    return fill.to(torch.int32), boff.to(torch.int32), x_row.to(torch.int32)


def plain(p: dict, xi: torch.Tensor, w: torch.Tensor, src_token: torch.Tensor,
          slot_of: torch.Tensor, fill: torch.Tensor | None = None):
    """The kernel's arithmetic in torch.  xi [I, T, D]; w [I, T, k] float32;
    src_token [I, E*C] and slot_of [I, T, k] int32 (``group_by_expert``'s);
    ``p`` the experts ``wi_gate``/``wi_up`` [E, D, F], ``wo`` [E, F, D].
    Returns [I, T, D] in xi's dtype; writes each bin's kept rows into
    ``fill`` [I, E] when given.  Expert e's compact rows run through its
    FFN one expert at a time (h in the weights' dtype, its output kept in
    float32); each row then sums its k choices' outputs, weighted."""
    I, T, D = xi.shape
    E = p["wi_gate"].shape[0]
    k = slot_of.shape[-1]
    C = src_token.shape[1] // E
    R = I * T * k
    f, boff, x_row = plan(src_token, T, E, R)
    x = xi.reshape(I * T, D)
    y = torch.zeros((R, D), dtype=torch.float32, device=xi.device)
    bounds = boff.tolist()
    for e in range(E):
        a, b = bounds[e * I], bounds[(e + 1) * I]
        if a == b:
            continue
        xe = x[x_row[a:b].long()]
        h = F.silu(xe @ p["wi_gate"][e]) * (xe @ p["wi_up"][e])
        y[a:b] = (h @ p["wo"][e]).float()
    s = slot_of.reshape(I, T * k).long()
    kept = s < E * C
    ii = torch.arange(I, device=xi.device)[:, None]
    at = boff.long()[torch.where(kept, s // C * I + ii, 0)] + s % C
    g = torch.where(kept[..., None], y[torch.where(kept, at, 0)], 0.0)
    out = (w.reshape(I, T * k, 1).float() * g).reshape(I, T, k, D).sum(2)
    if fill is not None:
        fill.copy_(f)
    return out.to(xi.dtype)


def _check(p, xi, w, src_token, slot_of, fill):
    """The kernel's contract; raises on anything it does not take."""
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    I, T, D = xi.shape
    E, D2, Fe = wg.shape
    k = slot_of.shape[-1]
    if (D2 != D or wu.shape != wg.shape or wo.shape != (E, Fe, D)
            or w.shape != (I, T, k) or slot_of.shape != (I, T, k)
            or src_token.dim() != 2 or src_token.shape[0] != I
            or src_token.shape[1] % E or (fill is not None
                                          and fill.shape != (I, E))):
        raise ValueError(
            f"routed_experts: bad shapes x{tuple(xi.shape)} "
            f"wi_gate{tuple(wg.shape)} wo{tuple(wo.shape)} w{tuple(w.shape)} "
            f"src_token{tuple(src_token.shape)} slot_of{tuple(slot_of.shape)}")
    if (xi.dtype not in _TYPES or any(t.dtype != xi.dtype for t in (wg, wu, wo))
            or w.dtype != torch.float32 or src_token.dtype != torch.int32
            or slot_of.dtype != torch.int32
            or (fill is not None and fill.dtype != torch.int32)):
        raise TypeError(
            f"routed_experts: x and the weights must share float32 or "
            f"bfloat16, w float32, the tables int32; got x {xi.dtype}, "
            f"weights {wg.dtype}/{wu.dtype}/{wo.dtype}, w {w.dtype}, "
            f"{src_token.dtype}/{slot_of.dtype}")
    if D % 8 or Fe % 8 or k > MAX_TOP_K:
        raise ValueError(f"routed_experts: D {D} and F {Fe} must be multiples "
                         f"of 8 and k {k} at most {MAX_TOP_K}")
    ts = [xi, w, src_token, slot_of, wg, wu, wo] + ([] if fill is None
                                                    else [fill])
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"routed_experts: tensors on {({t.device for t in ts})}")
    if (any(not t.is_contiguous() for t in ts)
            or any(t.data_ptr() % 16 for t in (xi, wg, wu, wo))):
        raise ValueError("routed_experts: every tensor must be contiguous, x "
                         "and the weights 16-byte aligned (the weights are "
                         "never copied)")


def routed_experts(p: dict, xi: torch.Tensor, w: torch.Tensor,
                   src_token: torch.Tensor, slot_of: torch.Tensor,
                   fill: torch.Tensor | None = None) -> torch.Tensor:
    """See ``plain`` for the semantics (and the module note for the
    design).  A CPU tensor runs ``plain``; a CUDA tensor launches the
    kernel, which writes each bin's kept rows into ``fill`` (a scratch
    tensor when none is given)."""
    if xi.device.type == "cpu":
        return plain(p, xi, w, src_token, slot_of, fill)
    if xi.device.type != "cuda":
        raise ValueError(f"routed_experts: unsupported device {xi.device}")
    xi, w = xi.contiguous(), w.contiguous()
    src_token, slot_of = src_token.contiguous(), slot_of.contiguous()
    _check(p, xi, w, src_token, slot_of, fill)
    I, T, D = xi.shape
    E, _, Fe = p["wi_gate"].shape
    k = slot_of.shape[-1]
    C = src_token.shape[1] // E
    R = I * T * k
    dev = xi.device
    if fill is None:
        fill = torch.empty((I, E), dtype=torch.int32, device=dev)
    tables = torch.empty(E * I + 1 + R, dtype=torch.int32, device=dev)
    h = torch.empty((R, Fe), dtype=xi.dtype, device=dev)
    y = torch.empty((R, D), dtype=torch.float32, device=dev)
    out = torch.empty_like(xi)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bind()(xi.data_ptr(), w.data_ptr(), src_token.data_ptr(),
                 slot_of.data_ptr(), p["wi_gate"].data_ptr(),
                 p["wi_up"].data_ptr(), p["wo"].data_ptr(), fill.data_ptr(),
                 tables.data_ptr(), h.data_ptr(), y.data_ptr(), out.data_ptr(),
                 I, T, E, C, k, D, Fe, _TYPES[xi.dtype], stream)
    build.check(rc, "moe_experts")
    name = str(xi.dtype).replace("torch.", "")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] = CAPTURED.get(name, 0) + 1
    else:
        count_launches(name)
    return out
