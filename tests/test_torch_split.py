"""The split-KV partition of the Hopper paged kernel, checked on the CPU.

``paged_attention.plan_split`` (the wrapper's pure-Python planner) and
``paged_attention.split_plain`` (the plain mirror of the partition: each
split's (out, lse) over its slice of the block table and lengths, then
``merge_lse``) must reproduce the unsplit plain version and JAX's
``repro.kernels.ref.paged_decode_attention`` on the shape grids of
``tests/test_torch_kernels.py``, for pages_per_split in {1, 2, 3, MB}.

Tolerance: float32 atol = rtol = 1e-5 (the same f32 arithmetic, with the
softmax sum taken per split and merged by log-sum-exp).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import paged_attention as pa, quant, ref

TOL = 1e-5

GRID = [   # N, Hq, Hkv, Dk, Dv, page, MB (test_paged_decode_plain_vs_jax)
    (4, 8, 2, 128, 128, 16, 4),
    (3, 4, 1, 256, 128, 8, 3),
    (5, 8, 8, 64, 64, 32, 2),
    (2, 16, 4, 128, 128, 64, 2),
    (1, 2, 1, 128, 128, 8, 1),
    (6, 16, 2, 64, 64, 16, 5),
    (4, 8, 2, 40, 24, 16, 3),
]


def _inputs(N, Hq, Hkv, Dk, Dv, page, MB, seed):
    rng = np.random.default_rng(seed)
    P = 64
    q = rng.standard_normal((N, Hq, Dk)).astype(np.float32)
    k = rng.standard_normal((P, page, Hkv, Dk)).astype(np.float32)
    v = rng.standard_normal((P, page, Hkv, Dv)).astype(np.float32)
    bt = rng.integers(0, P, (N, MB)).astype(np.int32)
    ln = rng.integers(0, MB * page + 1, (N,)).astype(np.int32)
    ln[0] = 0                                   # inactive (CP padding) row
    if N > 1:
        ln[1] = MB * page                       # full row
    if N > 2 and MB > 1:
        ln[2] = page                            # ends on a page boundary
    return q, k, v, bt, ln


@pytest.mark.parametrize("pps", [1, 2, 3, "MB"])
@pytest.mark.parametrize("N,Hq,Hkv,Dk,Dv,page,MB", GRID)
def test_split_mirror_matches_unsplit(N, Hq, Hkv, Dk, Dv, page, MB, pps):
    pps = MB if pps == "MB" else pps
    q, k, v, bt, ln = _inputs(N, Hq, Hkv, Dk, Dv, page, MB, N * 100 + Dk)
    tq, tk, tv, tbt, tln = map(torch.from_numpy, (q, k, v, bt, ln))
    o_s, l_s = pa.split_plain(tq, tk, tv, tbt, tln, pps)
    o_r, l_r = ref.paged_decode_attention(tq, tk, tv, tbt, tln)
    o_j, l_j = jref.paged_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(bt),
                                           jnp.asarray(ln))
    for want_o, want_l in ((o_r.numpy(), l_r.numpy()),
                           (np.asarray(o_j), np.asarray(l_j))):
        np.testing.assert_allclose(o_s.numpy(), want_o, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(l_s.numpy(), want_l, atol=TOL, rtol=TOL)
    assert (o_s[tln == 0] == 0).all() and (l_s[tln == 0] == ref.NEG_INF).all()


@pytest.mark.parametrize("kv_dtype", ["fp8", "int8"])
@pytest.mark.parametrize("pps", [1, 2, 3])
def test_split_mirror_quantized(kv_dtype, pps):
    """Quantized pages with per-page scales split the same way."""
    N, Hq, Hkv, D, page, MB = 6, 16, 2, 64, 16, 5
    q, k, v, bt, ln = _inputs(N, Hq, Hkv, D, D, page, MB, 3)
    tq, tbt, tln = map(torch.from_numpy, (q, bt, ln))
    pages = []
    for x in (k, v):
        t = torch.from_numpy(x)
        sc = quant.amax_scale(t.reshape(t.shape[0], -1), kv_dtype)
        pages += [quant.quantize(t, sc[:, None, None, None], kv_dtype), sc]
    kq, ks, vq, vs = pages
    o_s, l_s = pa.split_plain(tq, kq, vq, tbt, tln, pps, k_scale=ks,
                              v_scale=vs)
    o_r, l_r = ref.paged_decode_attention(tq, kq, vq, tbt, tln, k_scale=ks,
                                          v_scale=vs)
    np.testing.assert_allclose(o_s.numpy(), o_r.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(l_s.numpy(), l_r.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("N,Hkv,MB,sms", [
    (56, 2, 45, 132),       # the main path's largest call
    (64, 2, 44, 132),       # chip_smoke.py's synthetic call
    (6, 2, 5, 132),
    (1, 1, 1, 132),
    (1000, 8, 64, 132),     # more (row, head) pairs than the target
    (3, 1, 7, 16),
])
def test_plan_split(N, Hkv, MB, sms):
    """The fewest splits that reach BLOCKS_PER_SM blocks per SM with full
    rows (one page per split where MB cannot reach it), balanced."""
    pps = pa.plan_split(N, Hkv, MB, sms)
    S = -(-MB // pps)
    assert 1 <= pps <= MB and 1 <= S <= MB
    target = pa.BLOCKS_PER_SM * sms
    assert N * Hkv * S >= target or pps == 1
    for p in range(pps + 1, MB + 1):       # no fewer splits reach the target
        if -(-MB // p) < S:
            assert N * Hkv * -(-MB // p) < target
    assert pps == -(-MB // S)              # balanced over the S splits


def test_plan_split_on_the_main_path():
    """The main path's largest call (56 rows, 2 kv heads, 45 pages) splits
    twelve ways on an H100's 132 SMs, 4 pages each: 1,344 blocks, about 10
    per SM."""
    assert pa.plan_split(56, 2, 45, 132) == 4


# --------------------------------------------------------------------------- #
# head groups: DeepSeek-V3's latent (G 128, Dk 576, v = k[..., :512])
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("pps", [1, 2, "MB"])
@pytest.mark.parametrize("G,gh", [(128, None), (33, None), (8, 3)])
def test_head_group_mirror_matches_unsplit(G, gh, pps):
    """``split_plain`` with the kernel's head groups (``plan_heads``'s for
    the 576-wide latent, or 3 heads per group) over its split-KV partition
    equals the unsplit plain version and JAX's, with v a view of k and
    MLA's scale."""
    N, Dk, Dv, page, MB, P = 3, 576, 512, 4, 3, 16
    rng = np.random.default_rng(G)
    q = rng.standard_normal((N, G, Dk)).astype(np.float32)
    k = rng.standard_normal((P, page, 1, Dk)).astype(np.float32)
    bt = rng.integers(0, P, (N, MB)).astype(np.int32)
    ln = np.array([0, MB * page, page + 1], np.int32)
    gh = gh or pa.plan_heads(G, Dk, Dv, 4, True, MB)
    assert gh < G or G == 8
    pps = MB if pps == "MB" else pps
    tq, tk, tbt, tln = map(torch.from_numpy, (q, k, bt, ln))
    scale = (128 + 64) ** -0.5
    o_s, l_s = pa.split_plain(tq, tk, tk[..., :Dv], tbt, tln, pps,
                              heads_per_group=gh, scale=scale)
    o_r, l_r = ref.paged_decode_attention(tq, tk, tk[..., :Dv], tbt, tln,
                                          scale=scale)
    o_j, l_j = jref.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k[..., :Dv]),
        jnp.asarray(bt), jnp.asarray(ln), scale=scale)
    assert o_s.shape == (N, G, Dv)
    for want_o, want_l in ((o_r.numpy(), l_r.numpy()),
                           (np.asarray(o_j), np.asarray(l_j))):
        np.testing.assert_allclose(o_s.numpy(), want_o, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(l_s.numpy(), want_l, atol=TOL, rtol=TOL)
    assert (o_s[0] == 0).all() and (l_s[0] == ref.NEG_INF).all()


@pytest.mark.parametrize("G,Dk,Dv,page_bytes,shared,MB,want", [
    (128, 576, 512, 4, True, 30, 32),   # DeepSeek-V3, f32: 4 groups
    (128, 576, 512, 2, True, 30, 32),   # bf16: the accumulators bind
    (128, 576, 512, 1, True, 30, 32),   # fp8 / int8 codes
    (33, 576, 512, 4, True, 8, 17),     # one head past a group: 17 + 16
    (64, 576, 512, 4, True, 8, 32),
    (32, 576, 512, 4, True, 8, 32),
    (40, 288, 256, 4, True, 24, 40),    # MiniCPM3-4B: one group, as before
    (8, 64, 64, 4, False, 44, 8),       # TinyLlama
    (4, 128, 128, 4, False, 44, 4),     # Phi-3.5-MoE
    (5, 128, 128, 4, False, 44, 5),     # Llama-4-Scout
    (1, 64, 64, 4, False, 44, 1),       # Qwen1.5 (MHA)
])
def test_plan_heads(G, Dk, Dv, page_bytes, shared, MB, want):
    """The fewest balanced head groups whose accumulators fit MAX_PAIRS and
    whose block (q, scores, a two-stage ring) fits the 227 KB opt-in."""
    gh = pa.plan_heads(G, Dk, Dv, page_bytes, shared, MB)
    assert gh == want
    assert gh * -(-Dv // 4) <= pa.MAX_PAIRS
    assert pa.smem_bytes(gh, Dk, Dv, page_bytes, shared, MB) <= pa.SMEM_OPTIN
    groups = -(-G // gh)
    if groups > 1:                       # one group fewer does not fit
        wider = -(-G // (groups - 1))
        assert (wider * -(-Dv // 4) > pa.MAX_PAIRS or pa.smem_bytes(
            wider, Dk, Dv, page_bytes, shared, MB) > pa.SMEM_OPTIN)


def test_plan_heads_refuses_a_separate_wide_v():
    """A float32 576-wide K beside its own 512-wide V needs 280 KB of ring
    alone: no head grouping fits, and the wrapper's planner says so."""
    with pytest.raises(ValueError, match="do not fit"):
        pa.plan_heads(128, 576, 512, 4, False, 8)
