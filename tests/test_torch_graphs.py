"""CUDA graph replay of the decode step on the card (``core/aot.py``), at
reduced size: a graph engine against its eager twin, the in-place audit,
and the elastic-join prewarm.  These tests need an NVIDIA GPU and ``nvcc``
(marker ``cuda``); without a card they skip.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.aot import StepGraph
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.kernels import moe_experts, paged_attention as pa
from repro_torch.models import transformer
from repro_torch.serving.engine import NanoCPEngine

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _engine(arch, graphs, *, over=None, I=4, W=4, tp=2, cap=2048,
            edges=(100, 256), degrees=(1, 2, 3), prompts=(50, 300, 120, 40),
            new=8, **kw):
    cfg = reduced(CONFIGS[arch], vocab_size=256, **(over or {}))
    params = transformer.init_params(cfg, seed=0, device="cuda",
                                     dtype=torch.float32)
    eng = NanoCPEngine(cfg, params, num_instances=I, instances_per_node=W,
                       kv_capacity_tokens=cap, page_size=16, tp=tp,
                       buckets=CPBuckets(edges=edges, degrees=degrees),
                       shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                  s_buckets=(0, 1, 2, 4),
                                                  window=I),
                       max_slots_per_instance=4, cuda_graphs=graphs,
                       keep_logits=True, device="cuda", **kw)
    rng = np.random.default_rng(0)
    for L in prompts:
        eng.add_request(rng.integers(0, 256, (L,)), max_new_tokens=new)
    return eng


MOE = {"capacity_factor": 8.0}


@pytest.mark.parametrize("arch,over,kw", [
    ("tinyllama-1.1b", None, {}),
    ("minicpm3-4b", None, {}),
    ("phi3.5-moe-42b-a6.6b", MOE, {}),
    ("deepseek-v3", MOE, {}),
    ("tinyllama-1.1b", None, {"kv_dtype": "fp8"}),
    ("tinyllama-1.1b", None, {"backend": "dense"}),
], ids=["tinyllama", "minicpm3", "phi3.5-moe", "deepseek-v3", "fp8", "dense"])
@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_graph_replay_equals_eager(arch, over, kw, pipeline):
    """The same traffic through a graph engine and an eager one: equal
    tokens, bit-equal step logits, the paged kernel counted once per
    attention layer per step either way, and steady steps replayed."""
    runs = {}
    for graphs in (False, True):
        eng = _engine(arch, graphs, over=over, pipeline=pipeline, **kw)
        n0 = pa.LAUNCHES
        eng.run(max_iters=60)
        torch.cuda.synchronize()
        assert pa.LAUNCHES - n0 == (eng.hot_path_stats["steps"]
                                    * eng.cfg.num_layers)
        runs[graphs] = eng
    eager, graph = runs[False], runs[True]
    st = graph.aot.stats
    assert st.captured >= 1 and st.hits > st.captured
    assert st.graph_pool_bytes > 0 and eager.aot.stats.graph_pool_bytes == 0
    assert all(isinstance(graph.aot.lookup_key(k), StepGraph)
               for k in graph.aot.cached_keys())
    for rid, res in eager.results.items():
        assert graph.results[rid].tokens == res.tokens, rid
        for a, b in zip(graph.step_logits[rid], eager.step_logits[rid]):
            assert np.array_equal(a, b), rid
    graph.close()


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3"])
def test_moe_experts_counted_through_replays(arch):
    """A graph engine's MoE layers go through the routed expert kernel:
    its launch count rises by the MoE layers at every decode step, replays
    included, and the steps' expert bins hold every routed row."""
    eng = _engine(arch, True, over=MOE)
    n0 = moe_experts.LAUNCHES
    eng.run(max_iters=60)
    torch.cuda.synchronize()
    st = eng.aot.stats
    assert st.hits > st.captured >= 1
    moe_layers = eng.cfg.num_blocks * sum(
        k["ffn"] == "moe" for k in eng.cfg.block_pattern())
    assert moe_layers >= 1
    assert (moe_experts.LAUNCHES - n0
            == eng.hot_path_stats["steps"] * moe_layers)
    k = eng.cfg.num_experts_per_tok
    for key in eng.aot.cached_keys():
        bins = eng.aot.lookup_key(key).fn.expert_bins
        assert bins.shape[0] == moe_layers
        assert (bins.sum(dim=(1, 2)) == 4 * key[0] * k).all()
    eng.close()


def test_kernel_instance_first_met_under_capture():
    """A paged-kernel template instance (bf16 q, int8 pages) first met
    inside a capture, its shared-memory attribute set while the stream
    captures: the wrapper tallies the call as captured, not launched, and
    the graph's replay equals the plain version (bf16 tolerance)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    P, page, Hkv, Dk, Dv, N, MB = 32, 16, 2, 72, 56, 5, 3
    q = torch.randn(N, 4 * Hkv, Dk, device="cuda", generator=g).bfloat16()
    k = torch.randint(-100, 100, (P, page, Hkv, Dk), device="cuda",
                      generator=g).to(torch.int8)
    v = torch.randint(-100, 100, (P, page, Hkv, Dv), device="cuda",
                      generator=g).to(torch.int8)
    ks = torch.rand(P, device="cuda", generator=g) * 0.02 + 0.01
    vs = torch.rand(P, device="cuda", generator=g) * 0.02 + 0.01
    bt = torch.randint(0, P, (N, MB), device="cuda", generator=g,
                       dtype=torch.int32)
    lengths = torch.tensor([48, 1, 0, 30, 17], device="cuda",
                           dtype=torch.int32)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out, lse = pa.paged_decode_attention(q, k, v, bt, lengths,
                                             k_scale=ks, v_scale=vs)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    assert pa.CAPTURED == {"int8": 1}
    pa.CAPTURED.clear()
    n0 = pa.LAUNCHES
    graph.replay()
    torch.cuda.synchronize()
    assert pa.LAUNCHES == n0        # a replay by hand counts nothing
    want_o, want_l = pa.plain(q, k, v, bt, lengths, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_l, atol=2e-2, rtol=2e-2)


def test_moved_pool_pointer_raises():
    """A pool rebound to new storage between steps: the next replay's audit
    raises instead of writing the old storage."""
    eng = _engine("tinyllama-1.1b", True)
    for _ in range(4):
        eng.step()
    assert eng.aot.stats.captured >= 1
    key = eng.last_bucket
    eng.state["k_pool"] = eng.state["k_pool"].clone()
    with pytest.raises(RuntimeError, match="k_pool"):
        fn = eng.aot.lookup_key(key)
        fn(eng.decode_params, eng.state,
           eng._dev_tables.buffers(fn.table_shapes))


def test_join_prewarm_captures_off_the_hot_path():
    """A kill at (8, 1) in two nodes of four, then the rejoin: the prewarm
    captures the wider-ring graphs at once (no online capture), leaves the
    pools bit-equal, and the run ends with the eager twin's tokens."""
    runs = {}
    for graphs in (False, True):
        eng = _engine("tinyllama-1.1b", graphs, I=8, W=4, tp=1, cap=4096,
                      edges=(64, 160), prompts=(24, 90, 180), new=12)
        for _ in range(3):
            eng.step()
        victim = eng.cluster.active[2].moe_binding
        eng.fail_instance(victim)
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        before = {k: v.clone() for k, v in eng.state.items()}
        keys = set(eng.aot.cached_keys())
        online = eng.aot.stats.online_compiles
        eng.join_instance(victim)
        torch.cuda.synchronize()
        new = set(eng.aot.cached_keys()) - keys
        assert new and eng.aot.stats.online_compiles == online
        if graphs:
            assert all(eng.aot.lookup_key(k).graph is not None for k in new)
        for k, v in eng.state.items():
            assert torch.equal(v.view(torch.uint8),
                               before[k].view(torch.uint8)), k
        eng.run(max_iters=60)
        runs[graphs] = {r: g.tokens for r, g in eng.results.items()}
    assert runs[True] == runs[False]
