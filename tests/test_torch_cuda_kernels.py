"""The port's hand-written CUDA kernels held against their plain torch
versions on the card, on wider grids than ``chip_smoke.py`` covers: head
dims that are not powers of two up to 256, Dk != Dv, several page sizes
and G, ragged Sq/Skv, ``kv_len`` and ``q_offset``, float32 and bfloat16
queries, and fp8 / int8 quantized pages with per-page scales; and MLA's
shapes at MiniCPM3-4B's width (paged decode over the 288-wide latent with
G = 40 and v = k[..., :256]; flash prefill at Dk 96 / Dv 64 / 40 heads),
DeepSeek-V3's (the 576-wide latent, v = k[..., :512], at G 128 in head
groups, and at the group boundaries G 32, 33, 64; flash prefill at 128
heads of Dk 192 / Dv 128) and Qwen1.5's MHA decode (G 1, hd 64).

These tests need an NVIDIA GPU and ``nvcc`` (marker ``cuda``); without a
card they skip.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerance: float32 atol = rtol = 1e-4, bfloat16 2e-2 (as in chip_smoke.py).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, paged_attention as pa, quant, ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,Hq,Hkv,Dk,Dv,page,MB", [
    (6, 16, 2, 64, 64, 16, 5),       # main path head geometry (G 8)
    (4, 8, 2, 16, 16, 16, 4),        # reduced tinyllama head dim
    (4, 8, 2, 40, 24, 16, 3),        # head dims not powers of two, Dk != Dv
    (3, 4, 1, 256, 128, 8, 3),       # widest head dim, MQA
    (5, 8, 8, 128, 128, 32, 2),      # MHA, bigger pages
    (2, 32, 1, 256, 256, 64, 2),     # G 32, page 64
    (4, 8, 2, 34, 18, 16, 3),        # rows of 8-byte (f32) / 4-byte (bf16) multiples
    (6, 16, 4, 128, 128, 16, 5),     # phi3.5-moe at tp 2 (G 4, hd 128)
])
def test_paged_decode_kernel_vs_plain(N, Hq, Hkv, Dk, Dv, page, MB, dtype):
    g = torch.Generator(device="cuda").manual_seed(N * 100 + Dk)
    P = 64
    q = torch.randn(N, Hq, Dk, device="cuda", generator=g).to(dtype)
    k = torch.randn(P, page, Hkv, Dk, device="cuda", generator=g).to(dtype)
    v = torch.randn(P, page, Hkv, Dv, device="cuda", generator=g).to(dtype)
    bt = torch.randint(0, P, (N, MB), device="cuda", generator=g,
                       dtype=torch.int32)
    ln = torch.randint(0, MB * page + 1, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    ln[0] = 0
    ln[-1] = MB * page
    n0 = pa.LAUNCHES
    o, l = pa.paged_decode_attention(q, k, v, bt, ln)
    o2, l2 = ref.paged_decode_attention(q, k, v, bt, ln)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == n0 + 1
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)


def _quantized_pages(Pn, page, H, d, kv_dtype, g):
    """Codes and per-page scales of random pages, made on the card."""
    x = torch.randn(Pn, page, H, d, device="cuda", generator=g)
    sc = quant.amax_scale(x.reshape(Pn, -1), kv_dtype)
    return quant.quantize(x, sc[:, None, None, None], kv_dtype), sc


@pytest.mark.parametrize("kv_dtype", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,Hq,Hkv,Dk,Dv,page,MB", [
    (6, 16, 2, 64, 64, 16, 5),       # main path head geometry (G 8)
    (4, 4, 4, 32, 32, 16, 2),        # tests/test_quant.py grids: gqa,
    (4, 4, 2, 32, 32, 16, 2),        # grouped,
    (4, 4, 1, 64, 48, 16, 2),        # mla (Dk != Dv)
    (3, 4, 1, 256, 128, 8, 3),       # widest head dim
    (2, 32, 1, 256, 256, 64, 2),     # G 32, page 64
    (6, 16, 4, 128, 128, 16, 5),     # phi3.5-moe at tp 2 (G 4, hd 128)
])
def test_quantized_paged_decode_kernel_vs_plain(N, Hq, Hkv, Dk, Dv, page, MB,
                                                dtype, kv_dtype):
    """The fused dequant against the plain gather-then-dequant on the same
    codes and scales; only the quantized variant launches."""
    g = torch.Generator(device="cuda").manual_seed(N * 100 + Dk + Dv)
    Pn = 64
    q = torch.randn(N, Hq, Dk, device="cuda", generator=g).to(dtype)
    k, ks = _quantized_pages(Pn, page, Hkv, Dk, kv_dtype, g)
    v, vs = _quantized_pages(Pn, page, Hkv, Dv, kv_dtype, g)
    bt = torch.randint(0, Pn, (N, MB), device="cuda", generator=g,
                       dtype=torch.int32)
    ln = torch.randint(0, MB * page + 1, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    ln[0] = 0
    ln[-1] = MB * page
    name = str(k.dtype).replace("torch.", "")
    n0, n_var = pa.LAUNCHES, pa.LAUNCHES_BY_PAGE.get(name, 0)
    o, l = pa.paged_decode_attention(q, k, v, bt, ln, k_scale=ks, v_scale=vs)
    o2, l2 = ref.paged_decode_attention(q, k, v, bt, ln, k_scale=ks,
                                        v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == n0 + 1
    assert pa.LAUNCHES_BY_PAGE[name] == n_var + 1
    assert o.dtype == dtype
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)


def test_quantized_paged_decode_rejects_bad_mixes():
    """Quantized pages launch only with both float32 [P] scales; scales
    with unquantized pages, or mixed page types, raise."""
    q = torch.randn(2, 8, 16, device="cuda")
    kf = torch.randn(4, 16, 2, 16, device="cuda")
    k8 = kf.to(torch.float8_e4m3fn)
    ki = kf.to(torch.int8)
    sc = torch.ones(4, device="cuda")
    bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    ln = torch.ones(2, dtype=torch.int32, device="cuda")
    n0 = pa.LAUNCHES
    with pytest.raises(TypeError, match="scale"):
        pa.paged_decode_attention(q, k8, k8, bt, ln)
    with pytest.raises(TypeError, match="scale"):
        pa.paged_decode_attention(q, ki, ki, bt, ln, k_scale=sc)
    with pytest.raises(TypeError, match="scale"):
        pa.paged_decode_attention(q, kf, kf, bt, ln, k_scale=sc, v_scale=sc)
    with pytest.raises(TypeError, match="float32"):
        pa.paged_decode_attention(q, k8, k8, bt, ln, k_scale=sc.double(),
                                  v_scale=sc)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, k8, ki, bt, ln, k_scale=sc, v_scale=sc)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q.half(), k8, k8, bt, ln, k_scale=sc,
                                  v_scale=sc)
    assert pa.LAUNCHES == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dk,Dv,kv_len,q_offset,causal", [
    (1, 50, 50, 32, 4, 64, 64, None, 0, True),
    (2, 300, 300, 8, 2, 16, 16, [300, 211], 0, True),
    (1, 40, 140, 8, 2, 64, 64, None, 100, True),
    (1, 128, 128, 4, 4, 96, 64, None, 0, True),    # Dk != Dv (MLA shape)
    (2, 77, 200, 4, 1, 40, 24, [150, 9], 0, False),
    (1, 33, 70, 2, 2, 256, 256, [60], 30, True),
    (2, 130, 130, 32, 8, 128, 128, [130, 71], 0, True),   # phi3.5-moe heads
])
def test_flash_kernel_vs_plain(B, Sq, Skv, Hq, Hkv, Dk, Dv, kv_len, q_offset,
                               causal, dtype):
    g = torch.Generator(device="cuda").manual_seed(Sq * 7 + Skv)
    q = torch.randn(B, Sq, Hq, Dk, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, Skv, Hkv, Dk, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, Skv, Hkv, Dv, device="cuda", generator=g).to(dtype)
    kl = (None if kv_len is None
          else torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
    n0 = fa.LAUNCHES
    o, l = fa.flash_attention(q, k, v, causal=causal, kv_len=kl,
                              q_offset=q_offset)
    o2, l2 = ref.flash_attention(q, k, v, causal=causal, kv_len=kl,
                                 q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == n0 + 1
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)


def test_ops_send_cuda_tensors_to_kernels():
    """``ops`` launches the kernels for CUDA tensors (counted), and the
    plain versions only when ``FORCE_IMPL = "ref"`` asks for them."""
    q = torch.randn(2, 8, 16, device="cuda")
    kp = torch.randn(4, 16, 2, 16, device="cuda")
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device="cuda")
    ln = torch.tensor([20, 0], dtype=torch.int32, device="cuda")
    fq = torch.randn(1, 9, 4, 16, device="cuda")
    fk = torch.randn(1, 9, 2, 16, device="cuda")
    n_pa, n_fa = pa.LAUNCHES, fa.LAUNCHES
    ops.paged_decode_attention(q, kp, kp, bt, ln)
    ops.attention(fq, fk, fk)
    assert (pa.LAUNCHES, fa.LAUNCHES) == (n_pa + 1, n_fa + 1)
    ops.FORCE_IMPL = "ref"
    try:
        ops.paged_decode_attention(q, kp, kp, bt, ln)
        ops.attention(fq, fk, fk)
    finally:
        ops.FORCE_IMPL = None
    assert (pa.LAUNCHES, fa.LAUNCHES) == (n_pa + 1, n_fa + 1)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.randn(2, 8, 700, device="cuda")
    kp = torch.randn(4, 16, 2, 700, device="cuda")
    bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    ln = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q, kp, kp, bt, ln)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode_attention(q[..., :64], kp[..., :64], kp[..., :64],
                                  bt.long(), ln)
    with pytest.raises(TypeError):
        fa.flash_attention(torch.randn(1, 4, 2, 16, device="cuda",
                                       dtype=torch.float16),
                           torch.randn(1, 4, 2, 16, device="cuda",
                                       dtype=torch.float16),
                           torch.randn(1, 4, 2, 16, device="cuda",
                                       dtype=torch.float16))


# --------------------------------------------------------------------------- #
# the split-KV paged kernel and the tiled flash kernel: their edges
# --------------------------------------------------------------------------- #
def _paged_case(N, Hq, Hkv, Dk, Dv, page, MB, dtype, seed, P=64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(N, Hq, Dk, device="cuda", generator=g).to(dtype)
    k = torch.randn(P, page, Hkv, Dk, device="cuda", generator=g).to(dtype)
    v = torch.randn(P, page, Hkv, Dv, device="cuda", generator=g).to(dtype)
    bt = torch.randint(0, P, (N, MB), device="cuda", generator=g,
                       dtype=torch.int32)
    return q, k, v, bt, g


def _pps(N, Hkv, MB):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pa.plan_split(N, Hkv, MB, sms)


def _allocations():
    return torch.cuda.memory_stats()["allocation.all.allocated"]


@pytest.mark.parametrize("kv_dtype", [None, "fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_split_edges(dtype, kv_dtype):
    """The main path's geometry with rows that end exactly on a split
    boundary, one split past it, span every split, and zero-length rows
    between full ones; float pages and fp8/int8 codes through the split
    path.  The call allocates out, lse and one scratch tensor, no more."""
    N, Hq, Hkv, D, page, MB = 64, 16, 2, 64, 16, 44
    pps = _pps(N, Hkv, MB)
    assert -(-MB // pps) > 1          # the split path, with its merge
    q, k, v, bt, g = _paged_case(N, Hq, Hkv, D, D, page, MB, dtype, seed=7)
    kw = {}
    if kv_dtype:
        k, ks = _quantized_pages(64, page, Hkv, D, kv_dtype, g)
        v, vs = _quantized_pages(64, page, Hkv, D, kv_dtype, g)
        kw = {"k_scale": ks, "v_scale": vs}
    ln = torch.randint(1, MB * page + 1, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    edge = [pps * page, 2 * pps * page, pps * page + 1, pps * page - 1,
            MB * page, 0, MB * page, 0, 0, MB * page, 1, page]
    ln[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    a0 = _allocations()
    o, l = pa.paged_decode_attention(q, k, v, bt, ln, **kw)
    assert _allocations() - a0 == 3
    o2, l2 = ref.paged_decode_attention(q, k, v, bt, ln, **kw)
    torch.cuda.synchronize()
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)
    assert (o[ln == 0] == 0).all() and (l[ln == 0] == -1e30).all()


@pytest.mark.parametrize("kv_dtype", [None, "fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_one_page_rows(dtype, kv_dtype):
    """MB = 1: one split, so the first kernel writes the result itself and
    no scratch is allocated."""
    N, Hq, Hkv, D, page = 5, 8, 2, 64, 16
    q, k, v, bt, g = _paged_case(N, Hq, Hkv, D, D, page, 1, dtype, seed=3)
    kw = {}
    if kv_dtype:
        k, ks = _quantized_pages(64, page, Hkv, D, kv_dtype, g)
        v, vs = _quantized_pages(64, page, Hkv, D, kv_dtype, g)
        kw = {"k_scale": ks, "v_scale": vs}
    ln = torch.tensor([16, 0, 1, 7, 16], dtype=torch.int32, device="cuda")
    assert _pps(N, Hkv, 1) == 1
    torch.cuda.synchronize()
    a0 = _allocations()
    o, l = pa.paged_decode_attention(q, k, v, bt, ln, **kw)
    assert _allocations() - a0 == 2
    o2, l2 = ref.paged_decode_attention(q, k, v, bt, ln, **kw)
    torch.cuda.synchronize()
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_dtype", [None, "fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_v_as_strided_view_of_k(dtype, kv_dtype):
    """MLA's layout: v is k[..., :Dv] of one latent pool (Dk 40, Dv 32,
    one kv head).  The wrapper passes both strides and copies nothing: the
    call allocates out, lse and the split scratch only."""
    N, Hq, page, MB, Dk, Dv = 6, 4, 16, 5, 40, 32
    q, k, _, bt, g = _paged_case(N, Hq, 1, Dk, Dv, page, MB, dtype, seed=11)
    kw = {}
    if kv_dtype:
        k, ks = _quantized_pages(64, page, 1, Dk, kv_dtype, g)
        kw = {"k_scale": ks, "v_scale": ks}
    v = k[..., :Dv]
    assert not v.is_contiguous()
    ln = torch.tensor([MB * page, 0, 17, 33, 1, MB * page], dtype=torch.int32,
                      device="cuda")
    S = -(-MB // _pps(N, 1, MB))
    torch.cuda.synchronize()
    a0 = _allocations()
    o, l = pa.paged_decode_attention(q, k, v, bt, ln, **kw)
    assert _allocations() - a0 == 2 + (S > 1)
    o2, l2 = ref.paged_decode_attention(q, k, v.contiguous(), bt, ln, **kw)
    torch.cuda.synchronize()
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)


def test_paged_rejects_layouts_it_cannot_copy():
    """A pool whose last dim is strided, or whose strides are not 4-byte
    multiples, raises instead of being copied."""
    q = torch.randn(2, 8, 16, device="cuda")
    kp = torch.randn(4, 16, 2, 32, device="cuda")
    bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    ln = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="contiguous last dim"):
        pa.paged_decode_attention(q, kp[..., ::2], kp[..., ::2], bt, ln)
    qb = q.to(torch.bfloat16)
    kb = torch.randn(4, 16, 2, 17, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_decode_attention(qb, kb[..., :16], kb[..., :16], bt, ln)


def _flash_case(B, Sq, Skv, Hq, Hkv, Dk, Dv, dtype, kv_len, q_offset, causal,
                seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, Hq, Dk, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, Skv, Hkv, Dk, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, Skv, Hkv, Dv, device="cuda", generator=g).to(dtype)
    kl = (None if kv_len is None
          else torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
    o, l = fa.flash_attention(q, k, v, causal=causal, kv_len=kl,
                              q_offset=q_offset)
    o2, l2 = ref.flash_attention(q, k, v, causal=causal, kv_len=kl,
                                 q_offset=q_offset)
    torch.cuda.synchronize()
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Sq,Skv,q_offset", [
    (63, 63, 0), (65, 65, 0), (127, 127, 0), (129, 129, 0),
    (65, 129, 64), (1, 129, 128),
])
def test_flash_one_off_the_tiles(Sq, Skv, q_offset, dtype):
    """Sq/Skv one off the 64-row and 64-key tiles, causal."""
    _flash_case(1, Sq, Skv, 8, 2, 64, 64, dtype, None, q_offset, True,
                seed=Sq + Skv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kv_len_inside_one_tile(causal, dtype):
    """kv_len shorter than one kv tile, ragged across the batch."""
    _flash_case(2, 150, 150, 4, 2, 64, 64, dtype, [17, 5], 0, causal,
                seed=17)


@pytest.mark.parametrize("D", [16, 24, 40, 96, 256])
def test_flash_bf16_tensor_core_head_dims(D):
    """The tensor-core path at head dims that pad to its instantiations,
    B = 2 with ragged kv_len."""
    _flash_case(2, 77, 77, 4, 2, D, D, torch.bfloat16, [77, 50], 0, True,
                seed=D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Dk,Dv", [(64, 32), (16, 128), (40, 24), (128, 200),
                                   (20, 12), (18, 10)])   # narrow copies
def test_flash_dk_neq_dv(Dk, Dv, dtype):
    _flash_case(2, 70, 90, 4, 1, Dk, Dv, dtype, [90, 33], 20, True,
                seed=Dk * Dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_row_without_keys(dtype):
    """kv_len == 0 gives out = 0 and lse = -1e30 (the Pallas kernel's
    contract); the other batch entry matches the plain version."""
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(2, 40, 4, 64, device="cuda", generator=g).to(dtype)
    k = torch.randn(2, 40, 2, 64, device="cuda", generator=g).to(dtype)
    v = torch.randn(2, 40, 2, 64, device="cuda", generator=g).to(dtype)
    kl = torch.tensor([0, 40], dtype=torch.int32, device="cuda")
    o, l = fa.flash_attention(q, k, v, kv_len=kl)
    o2, l2 = ref.flash_attention(q[1:], k[1:], v[1:])
    torch.cuda.synchronize()
    assert (o[0] == 0).all() and (l[0] == -1e30).all()
    _close(o[1:], o2, dtype)
    torch.testing.assert_close(l[1:], l2, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# MLA at MiniCPM3-4B's width: one latent head of kv_lora 256 + rope 32
# --------------------------------------------------------------------------- #
MLA_G, MLA_DK, MLA_DV = 40, 288, 256


@pytest.mark.parametrize("kv_dtype", [None, "fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_mla_latent_vs_plain(dtype, kv_dtype):
    """G = 40 q heads over one latent head of 288, v = k[..., :256] (a view,
    never copied; quantized pools pass one scale per page for both), the
    scale (nope + rope)^-0.5 of the decode step.  Rows of length 0, one
    token, one full page, on and one past a split boundary, and spanning
    every split."""
    N, page, MB, P = 24, 16, 20, 128
    pps = _pps(N, 1, MB)
    assert -(-MB // pps) > 1
    g = torch.Generator(device="cuda").manual_seed(288)
    q = torch.randn(N, MLA_G, MLA_DK, device="cuda", generator=g).to(dtype)
    kw = {}
    if kv_dtype:
        k, ks = _quantized_pages(P, page, 1, MLA_DK, kv_dtype, g)
        kw = {"k_scale": ks, "v_scale": ks}
    else:
        k = torch.randn(P, page, 1, MLA_DK, device="cuda", generator=g).to(dtype)
    v = k[..., :MLA_DV]
    bt = torch.randint(0, P, (N, MB), device="cuda", generator=g,
                       dtype=torch.int32)
    ln = torch.randint(1, MB * page + 1, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    edge = [0, 1, page, pps * page, pps * page + 1, MB * page, 0, 2 * page]
    ln[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device="cuda")
    scale = (64 + 32) ** -0.5
    torch.cuda.synchronize()
    a0 = _allocations()
    o, l = pa.paged_decode_attention(q, k, v, bt, ln, scale=scale, **kw)
    assert _allocations() - a0 == 3           # out, lse, split scratch
    o2, l2 = ref.paged_decode_attention(q, k, v.contiguous(), bt, ln,
                                        scale=scale, **kw)
    torch.cuda.synchronize()
    assert o.shape == (N, MLA_G, MLA_DV)
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)
    assert (o[ln == 0] == 0).all() and (l[ln == 0] == -1e30).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_mla_latent_one_page_rows(dtype):
    """MB = 1 at the latent's width: one split, no scratch."""
    N, page = 6, 16
    g = torch.Generator(device="cuda").manual_seed(289)
    q = torch.randn(N, MLA_G, MLA_DK, device="cuda", generator=g).to(dtype)
    k = torch.randn(32, page, 1, MLA_DK, device="cuda", generator=g).to(dtype)
    bt = torch.randint(0, 32, (N, 1), device="cuda", generator=g,
                       dtype=torch.int32)
    ln = torch.tensor([16, 0, 1, 7, 15, 16], dtype=torch.int32, device="cuda")
    o, l = pa.paged_decode_attention(q, k, k[..., :MLA_DV], bt, ln)
    o2, l2 = ref.paged_decode_attention(q, k, k[..., :MLA_DV].contiguous(),
                                        bt, ln)
    torch.cuda.synchronize()
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,kv_len", [(1, 77, None), (2, 333, [333, 150]),
                                        (1, 1000, None)])
def test_flash_mla_prefill_shape(B, S, kv_len, dtype):
    """MLA's materialised prefill: 40 heads, Dk 96 (nope 64 + rope 32) !=
    Dv 64, causal, at ragged lengths off the tiles."""
    _flash_case(B, S, S, 40, 40, 96, 64, dtype, kv_len, 0, True, seed=S)


# --------------------------------------------------------------------------- #
# DeepSeek-V3's latent: kv_lora 512 + rope 64, G 128 in head groups
# --------------------------------------------------------------------------- #
DS_DK, DS_DV = 576, 512


@pytest.mark.parametrize("kv_dtype", [None, "fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [128, 64, 33, 32])
def test_paged_ds_latent_head_groups(G, dtype, kv_dtype):
    """G q heads over one latent head of 576, v = k[..., :512] (a view,
    staged once; quantized pools pass one scale per page for both), the
    scale (nope + rope)^-0.5: the heads run in ``plan_heads`` groups (4 of
    32 at G 128, 2 of 17 at G 33, one at G 32).  Rows of length 0, one
    token, one full page, on and one past a split boundary, and spanning
    every split."""
    N, page, MB, P = 12, 16, 12, 96
    gh = pa.plan_heads(G, DS_DK, DS_DV, 1 if kv_dtype else
                       torch.tensor([], dtype=dtype).element_size(), True, MB)
    assert -(-G // gh) == {128: 4, 64: 2, 33: 2, 32: 1}[G]
    pps = _pps(N, -(-G // gh), MB)
    g = torch.Generator(device="cuda").manual_seed(576 + G)
    q = torch.randn(N, G, DS_DK, device="cuda", generator=g).to(dtype)
    kw = {}
    if kv_dtype:
        k, ks = _quantized_pages(P, page, 1, DS_DK, kv_dtype, g)
        kw = {"k_scale": ks, "v_scale": ks}
    else:
        k = torch.randn(P, page, 1, DS_DK, device="cuda", generator=g).to(dtype)
    v = k[..., :DS_DV]
    bt = torch.randint(0, P, (N, MB), device="cuda", generator=g,
                       dtype=torch.int32)
    ln = torch.randint(1, MB * page + 1, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    edge = [0, 1, page, pps * page, pps * page + 1, MB * page, 0]
    ln[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device="cuda")
    scale = (128 + 64) ** -0.5
    n0 = pa.LAUNCHES
    o, l = pa.paged_decode_attention(q, k, v, bt, ln, scale=scale, **kw)
    o2, l2 = ref.paged_decode_attention(q, k, v.contiguous(), bt, ln,
                                        scale=scale, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == n0 + 1
    assert o.shape == (N, G, DS_DV)
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)
    assert (o[ln == 0] == 0).all() and (l[ln == 0] == -1e30).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_ds_latent_one_page_rows(dtype):
    """MB = 1 at DeepSeek-V3's latent: one split, four head groups."""
    N, page = 6, 16
    g = torch.Generator(device="cuda").manual_seed(577)
    q = torch.randn(N, 128, DS_DK, device="cuda", generator=g).to(dtype)
    k = torch.randn(32, page, 1, DS_DK, device="cuda", generator=g).to(dtype)
    bt = torch.randint(0, 32, (N, 1), device="cuda", generator=g,
                       dtype=torch.int32)
    ln = torch.tensor([16, 0, 1, 7, 15, 16], dtype=torch.int32, device="cuda")
    o, l = pa.paged_decode_attention(q, k, k[..., :DS_DV], bt, ln)
    o2, l2 = ref.paged_decode_attention(q, k, k[..., :DS_DV].contiguous(),
                                        bt, ln)
    torch.cuda.synchronize()
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)
    assert (o[1] == 0).all() and (l[1] == -1e30).all()


def test_paged_ds_latent_needs_v_as_a_view():
    """A float32 576-wide K beside a separate 512-wide V does not fit a
    block even one head at a time: the wrapper raises before the launch."""
    q = torch.randn(2, 8, DS_DK, device="cuda")
    k = torch.randn(4, 16, 1, DS_DK, device="cuda")
    v = torch.randn(4, 16, 1, DS_DV, device="cuda")
    bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    ln = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="do not fit"):
        pa.paged_decode_attention(q, k, v, bt, ln)


@pytest.mark.parametrize("kv_dtype", [None, "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_qwen_mha_g1(dtype, kv_dtype):
    """Qwen1.5's decode at (4, 2): 8 kv heads of 64 per device with one q
    head each (G 1), rows on split edges, empty and full."""
    N, MB, page = 24, 10, 16
    q, k, v, bt, g = _paged_case(N, 8, 8, 64, 64, page, MB, dtype, seed=64)
    pps = _pps(N, 8, MB)
    ln = torch.randint(1, MB * page + 1, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    edge = [0, pps * page, pps * page + 1, MB * page, 1]
    ln[:len(edge)] = torch.tensor(edge, dtype=torch.int32, device="cuda")
    kw = {}
    if kv_dtype:
        k, ks = _quantized_pages(k.shape[0], page, 8, 64, kv_dtype, g)
        v, vs = _quantized_pages(k.shape[0], page, 8, 64, kv_dtype, g)
        kw = {"k_scale": ks, "v_scale": vs}
    o, l = pa.paged_decode_attention(q, k, v, bt, ln, **kw)
    o2, l2 = ref.paged_decode_attention(q, k, v, bt, ln, **kw)
    torch.cuda.synchronize()
    _close(o, o2, dtype)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,kv_len,q_offset", [
    (1, 65, 129, None, 64), (2, 150, 150, [150, 77], 0),
    (1, 300, 1000, None, 700)])
def test_flash_ds_prefill_shape(B, Sq, Skv, kv_len, q_offset, dtype):
    """DeepSeek-V3's materialised prefill: 128 heads, Dk 192 (nope 128 +
    rope 64) != Dv 128, causal with a nonzero q offset (a chunk's start)
    and ragged kv lengths."""
    _flash_case(B, Sq, Skv, 128, 128, 192, 128, dtype, kv_len, q_offset, True,
                seed=Sq + q_offset)
