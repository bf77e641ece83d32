"""The port's plain kernel versions (what its wrappers run for CPU tensors)
held against the JAX package: the Pallas kernels in interpret mode and the
jnp oracles, on the grids of tests/test_kernels.py, plus ragged lengths,
``kv_len`` and ``q_offset``.  The Hopper kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.

Tolerance: float32 atol = rtol = 2e-5 (two implementations of the same f32
arithmetic, summed in different orders); bfloat16 inputs are compared in
float32 after the same rounding of the inputs, at 2e-2 (one bf16 ulp of
the outputs, which each side rounds at its own point).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import paged_decode_attention as jpaged
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, paged_attention as pa, ref

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _pair(a: np.ndarray, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if hasattr(got, "float")
                                          else got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("N,Hq,Hkv,Dk,Dv,page,MB,dtype", [
    (4, 8, 2, 128, 128, 16, 4, jnp.float32),     # GQA
    (3, 4, 1, 256, 128, 8, 3, jnp.bfloat16),     # MLA-like (Dk != Dv, MQA)
    (5, 8, 8, 64, 64, 32, 2, jnp.float32),       # MHA
    (2, 16, 4, 128, 128, 64, 2, jnp.bfloat16),   # wide GQA, big pages
    (1, 2, 1, 128, 128, 8, 1, jnp.float32),      # single row/page
    (6, 16, 2, 64, 64, 16, 5, jnp.float32),      # main-path head geometry
    (4, 8, 2, 40, 24, 16, 3, jnp.float32),       # head dims not powers of two
])
def test_paged_decode_plain_vs_jax(N, Hq, Hkv, Dk, Dv, page, MB, dtype):
    rng = np.random.default_rng(N * 100 + Dk)
    P = 64
    q, tq = _pair(rng.standard_normal((N, Hq, Dk)), dtype)
    kp, tk = _pair(rng.standard_normal((P, page, Hkv, Dk)), dtype)
    vp, tv = _pair(rng.standard_normal((P, page, Hkv, Dv)), dtype)
    bt_np = rng.integers(0, P, (N, MB)).astype(np.int32)
    len_np = rng.integers(0, MB * page + 1, (N,)).astype(np.int32)
    len_np[0] = 0                                   # inactive (CP padding) row
    if N > 1:
        len_np[1] = MB * page                       # full row
    o_t, l_t = pa.paged_decode_attention(tq, tk, tv, torch.from_numpy(bt_np),
                                         torch.from_numpy(len_np))
    o_r, l_r = jref.paged_decode_attention(q, kp, vp, jnp.asarray(bt_np),
                                           jnp.asarray(len_np))
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    _close(o_t, o_r, tol)
    _close(l_t, l_r, F32_TOL if dtype == jnp.float32 else 1e-3)
    if Dk % 8 == 0 and Dv % 8 == 0:
        o_k, l_k = jpaged(q, kp, vp, jnp.asarray(bt_np), jnp.asarray(len_np),
                          interpret=True)
        _close(o_t, o_k, tol)
        active = len_np > 0
        _close(l_t[active], np.asarray(l_k)[active],
               F32_TOL if dtype == jnp.float32 else 1e-3)


@pytest.mark.parametrize("kg,g_out", [(2, 2), (4, 1), (2, 1)])
def test_paged_decode_grouped_subpool_view(kg, g_out):
    """The head-grouped (tp < Hkv) device view: a flat sub-pool
    [F', page, kg*hd] viewed as [F', page, kg, hd] with kv-head-major q
    rows equals per-head attention (JAX oracle per head)."""
    rng = np.random.default_rng(kg * 10 + g_out)
    N, hd, page, P, MB = 3, 64, 8, 16, 2
    flat = rng.standard_normal((P, page, kg * hd)).astype(np.float32)
    vflat = rng.standard_normal((P, page, kg * hd)).astype(np.float32)
    q = rng.standard_normal((N, kg * g_out, hd)).astype(np.float32)
    bt = rng.integers(0, P, (N, MB)).astype(np.int32)
    lengths = rng.integers(1, MB * page + 1, (N,)).astype(np.int32)
    o, l = pa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(flat).reshape(P, page, kg, hd),
        torch.from_numpy(vflat).reshape(P, page, kg, hd),
        torch.from_numpy(bt), torch.from_numpy(lengths))
    kp = jnp.asarray(flat).reshape(P, page, kg, hd)
    vp = jnp.asarray(vflat).reshape(P, page, kg, hd)
    for h in range(kg):
        o_r, l_r = jref.paged_decode_attention(
            jnp.asarray(q[:, h * g_out:(h + 1) * g_out]), kp[:, :, h:h + 1],
            vp[:, :, h:h + 1], jnp.asarray(bt), jnp.asarray(lengths))
        _close(o[:, h * g_out:(h + 1) * g_out], o_r, F32_TOL)
        _close(l[:, h * g_out:(h + 1) * g_out], l_r, F32_TOL)


def _flash_inputs(rng, B, Sq, Skv, Hq, Hkv, Dk, Dv, dtype):
    q, tq = _pair(rng.standard_normal((B, Sq, Hq, Dk)), dtype)
    k, tk = _pair(rng.standard_normal((B, Skv, Hkv, Dk)), dtype)
    v, tv = _pair(rng.standard_normal((B, Skv, Hkv, Dv)), dtype)
    return (q, k, v), (tq, tk, tv)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,dtype", [
    (2, 128, 128, 4, 2, 64, True, jnp.float32),
    (1, 256, 256, 2, 1, 128, True, jnp.bfloat16),
    (2, 128, 256, 4, 4, 64, False, jnp.float32),
    (1, 128, 128, 8, 2, 128, True, jnp.float32),
])
def test_flash_plain_vs_pallas_interpret(B, Sq, Skv, Hq, Hkv, D, causal, dtype):
    rng = np.random.default_rng(Sq + Hq)
    (q, k, v), (tq, tk, tv) = _flash_inputs(rng, B, Sq, Skv, Hq, Hkv, D, D, dtype)
    kv_len = rng.integers(Skv // 2, Skv + 1, (B,)).astype(np.int32)
    o_t, l_t = fa.flash_attention(tq, tk, tv, causal=causal,
                                  kv_len=torch.from_numpy(kv_len))
    o_k, l_k = jflash(q, k, v, causal=causal, kv_len=jnp.asarray(kv_len),
                      interpret=True)
    tol = 3e-2 if dtype == jnp.bfloat16 else F32_TOL
    _close(o_t, o_k, tol)
    _close(l_t, l_k, F32_TOL if dtype == jnp.float32 else 1e-3)


def test_flash_mla_dv_neq_dk():
    """MLA train shape: Dk=96 (nope+rope), Dv=64."""
    rng = np.random.default_rng(96)
    (q, k, v), (tq, tk, tv) = _flash_inputs(rng, 1, 128, 128, 4, 4, 96, 64,
                                            jnp.float32)
    o_t, _ = fa.flash_attention(tq, tk, tv, causal=True)
    o_k, _ = jflash(q, k, v, causal=True, interpret=True)
    _close(o_t, o_k, F32_TOL)


@pytest.mark.parametrize("Sq,Skv,kv_len,q_offset", [
    (50, 50, None, 0),          # ragged prompt lengths of the main path
    (300, 300, None, 0),
    (120, 120, [77], 0),        # kv_len < Skv
    (40, 140, None, 100),       # chunked prefill: q_offset > 0
    (33, 70, [60], 30),
])
def test_flash_plain_vs_jax_ragged(Sq, Skv, kv_len, q_offset):
    rng = np.random.default_rng(Sq * 7 + Skv)
    (q, k, v), (tq, tk, tv) = _flash_inputs(rng, 1, Sq, Skv, 8, 2, 16, 16,
                                            jnp.float32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    o_t, l_t = fa.flash_attention(
        tq, tk, tv, q_offset=q_offset,
        kv_len=None if kl is None else torch.from_numpy(kl))
    o_r, l_r = jref.flash_attention(q, k, v, q_offset=q_offset,
                                    kv_len=None if kl is None else jnp.asarray(kl))
    _close(o_t, o_r, F32_TOL)
    _close(l_t, l_r, F32_TOL)


def test_blockwise_matches_dense():
    rng = np.random.default_rng(1024)
    B, Sq, Skv, Hq, Hkv, D = 2, 64, 1024, 4, 2, 32
    (q, k, v), (tq, tk, tv) = _flash_inputs(rng, B, Sq, Skv, Hq, Hkv, D, D,
                                            jnp.float32)
    kv_len = np.array([700, 1024], np.int32)
    o1, l1 = ref.flash_attention(tq, tk, tv, causal=False,
                                 kv_len=torch.from_numpy(kv_len))
    o2, l2 = ref.flash_attention_blockwise(tq, tk, tv, causal=False,
                                           kv_len=torch.from_numpy(kv_len),
                                           block_k=256)
    _close(o1, o2, F32_TOL)
    _close(l1, l2, F32_TOL)
    o3, l3 = jref.flash_attention_blockwise(q, k, v, causal=False,
                                            kv_len=jnp.asarray(kv_len),
                                            block_k=256)
    _close(o2, o3, F32_TOL)
    _close(l2, l3, F32_TOL)


@pytest.mark.parametrize("w,h,L,seed", [(1, 1, 2, 0), (3, 4, 37, 1),
                                        (4, 6, 64, 2), (2, 2, 5, 3)])
def test_merge_lse_split_invariance(w, h, L, seed):
    """Merging a length-split attention equals the unsplit attention, and
    the port's merge equals the JAX merge on the same partials."""
    rng = np.random.default_rng(seed)
    D = 16
    q = torch.from_numpy(rng.standard_normal((1, h, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, L, h, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, L, h, D)).astype(np.float32))
    full, _ = ref.decode_attention_dense(q, k, v, torch.tensor([L], dtype=torch.int32))
    cuts = sorted(rng.integers(0, L + 1, (w - 1,)).tolist())
    bounds = [0] + cuts + [L]
    parts, lses, mask = [], [], []
    for i in range(w):
        lo, hi = bounds[i], bounds[i + 1]
        kk = torch.zeros_like(k)
        vv = torch.zeros_like(v)
        kk[:, :hi - lo] = k[:, lo:hi]
        vv[:, :hi - lo] = v[:, lo:hi]
        o, l = ref.decode_attention_dense(q, kk, vv,
                                          torch.tensor([hi - lo], dtype=torch.int32))
        parts.append(o)
        lses.append(l)
        mask.append(hi > lo)
    po, pl = torch.stack(parts), torch.stack(lses)
    m = torch.tensor(mask)[:, None]
    merged, mlse = ops.merge_lse(po, pl, mask=m)
    _close(merged[0], full[0], 1e-4)
    j_merged, j_lse = jref.merge_lse(jnp.asarray(po.numpy()), jnp.asarray(pl.numpy()),
                                     mask=jnp.asarray(m.numpy()))
    _close(merged, j_merged, F32_TOL)
    _close(mlse, j_lse, F32_TOL)


def test_ops_send_cpu_tensors_to_plain_versions():
    """On CPU tensors the wrappers run the plain versions: no kernel launch
    is counted and the results are the plain versions' exactly."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((4, 16, 2, 16)).astype(np.float32))
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    ln = torch.tensor([20, 0], dtype=torch.int32)
    fq = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    fk = torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(np.float32))
    n_pa, n_fa = pa.LAUNCHES, fa.LAUNCHES
    got = ops.paged_decode_attention(q, kp, kp, bt, ln)
    want = ref.paged_decode_attention(q, kp, kp, bt, ln)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got = ops.flash_attention(fq, fk, fk)
    want = ref.flash_attention(fq, fk, fk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(ops.attention(fq, fk, fk), want[0])
    assert (pa.LAUNCHES, fa.LAUNCHES) == (n_pa, n_fa)
    assert pa.plain is ref.paged_decode_attention
    assert fa.plain is ref.flash_attention
