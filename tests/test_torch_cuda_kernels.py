"""The port's hand-written CUDA kernels held against their plain torch
versions on the card, on wider grids than ``chip_smoke.py`` covers: head
dims that are not powers of two up to 256, Dk != Dv, several page sizes
and G, ragged Sq/Skv, ``kv_len`` and ``q_offset``, float32 and bfloat16
queries, and fp8 / int8 quantized pages with per-page scales.

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
    q = torch.randn(2, 8, 300, device="cuda")
    kp = torch.randn(4, 16, 2, 300, device="cuda")
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
