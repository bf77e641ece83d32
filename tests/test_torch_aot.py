"""The AOT graph engine on the CPU (``repro_torch/core/aot.py``): its cache
API against the reference's ``AOTGraphEngine`` on the same key sequence,
and the properties one CUDA graph per bucket relies on, checked without a
card:

  * the decode step is capturable: no op waits on the device or sizes its
    output by values (``NoHostSync``), for every decoder-only variant, SSM
    and hybrid included, and for the encoder-decoder (whisper) step;
  * the static-buffer contract: a step on the engine's own table buffers
    and state tensors, refilled in place, equals a step on fresh tensors;
  * the elastic-join prewarm leaves the pools bit-equal;
  * the in-place audit a replay runs raises on a moved pointer.

Graph capture and replay themselves run on the card
(``tests/test_torch_graphs.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.aot import AOTGraphEngine as JAOT
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core import routing
from repro_torch.core.aot import AOTGraphEngine, InPlaceAudit
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.models import init_params
from repro_torch.serving.engine import NanoCPEngine

aten = torch.ops.aten


# --------------------------------------------------------------------------- #
# (a) the cache API against the reference on one key sequence
# --------------------------------------------------------------------------- #
def test_aot_cache_api_matches_reference():
    """``capture``, ``lookup``, ``cached_keys``, ``num_graphs`` and the
    counters follow the reference's on the same keys, each side with a
    builder stub whose tables are one [M, MB] int32 array."""
    def jbuilder(key):
        M, _, MB = key[:3]
        return (jax.jit(lambda t: t + 1),
                (jax.ShapeDtypeStruct((M, MB), jnp.int32),))

    def builder(key):
        M, _, MB = key[:3]
        return (lambda *args: args), {"t": (M, MB)}

    for ladder in (None, (1, 2, 3)):
        ours = AOTGraphEngine(builder, r_ladder=ladder)
        ref = JAOT(jbuilder, r_ladder=ladder)
        keys = [ours.quantise(2, 1, 9, 4, 1), ours.quantise(4, 0, 20, 4, 0)]
        assert keys == [ref.quantise(2, 1, 9, 4, 1),
                        ref.quantise(4, 0, 20, 4, 0)]
        ours.capture(keys)
        ref.capture(keys)
        for M, S, MB, R in [(2, 1, 9, 1), (2, 1, 7, 1), (2, 1, 9, 3),
                            (4, 0, 20, 0), (1, 2, 40, 2), (2, 1, 9, 1),
                            (1, 2, 33, 2)]:
            ours.lookup(M, S, MB, 4, R)
            ref.lookup(M, S, MB, 4, R)
            assert ours.cached_keys() == ref.cached_keys()
            assert ours.num_graphs == ref.num_graphs
        mine, theirs = ours.stats.as_dict(), ref.stats.as_dict()
        for k in ("captured", "lookups", "hits", "online_compiles",
                  "buffer_bytes"):
            assert mine[k] == theirs[k], (k, mine, theirs)
        assert mine["graph_pool_bytes"] == 0
        assert mine["lookups"] == 7 and mine["hits"] > 0
        assert mine["online_compiles"] > 0


# --------------------------------------------------------------------------- #
# (b) the decode step is capturable
# --------------------------------------------------------------------------- #
# ops whose result the host must read, or whose output shape depends on
# tensor values: both break CUDA graph capture
_HOST_OPS = {aten._local_scalar_dense.default, aten.nonzero.default,
             aten.nonzero_numpy.default, aten.argwhere.default,
             aten.masked_select.default, aten.unique_dim.default,
             aten.unique_consecutive.default, aten._unique.default,
             aten._unique2.default, aten.repeat_interleave.Tensor,
             aten.bincount.default, aten.equal.default,
             aten.is_nonzero.default}
_INDEX_OPS = {aten.index.Tensor, aten.index_put.default,
              aten.index_put_.default, aten._index_put_impl_.default}


class NoHostSync(TorchDispatchMode):
    """Raises on any op that waits on the device or sizes its output by
    tensor values (boolean-mask indexing included)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_OPS:
            raise AssertionError(f"host sync or value-sized op: {func}")
        if func in _INDEX_OPS:
            for ix in args[1]:
                if ix is not None and ix.dtype in (torch.bool, torch.uint8):
                    raise AssertionError(f"boolean-mask index: {func}")
        return func(*args, **kwargs)


MOE_OVER = {"capacity_factor": 8.0}
# case: (arch, config overrides, engine settings)
CAPTURE_CASES = {
    "tinyllama": ("tinyllama-1.1b", {}, {}),
    "qwen1.5": ("qwen1.5-0.5b", {}, {}),
    "llama4-scout": ("llama4-scout-17b-a16e", MOE_OVER, {}),
    "minicpm3": ("minicpm3-4b", {}, {}),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", MOE_OVER, {}),
    "deepseek-v3": ("deepseek-v3", MOE_OVER, {}),
    "dense": ("tinyllama-1.1b", {}, {"backend": "dense"}),
    "fp8": ("tinyllama-1.1b", {}, {"kv_dtype": "fp8"}),
    "minicpm3-fp8": ("minicpm3-4b", {}, {"kv_dtype": "fp8"}),
    "mamba2": ("mamba2-370m", {}, {}),
    "jamba": ("jamba-v0.1-52b", MOE_OVER, {}),
    "whisper": ("whisper-base", {}, {}),
}


def _small_engine(arch, over, kw, pipeline=True):
    """(2, 2), a prompt past the CP edge (degree 2: rows route over the
    ring) and a short one, after one step (admission + the first decode
    dispatch).  SSM models and whisper keep the engine's one pinned M
    bucket; whisper's prompts are audio frames with 3-token decoder
    prefixes."""
    cfg = reduced(CONFIGS[arch], vocab_size=256, **over)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    pinned = cfg.family in ("ssm", "hybrid") or cfg.is_encoder_decoder
    eng = NanoCPEngine(cfg, params, num_instances=2, instances_per_node=2,
                       kv_capacity_tokens=1024, page_size=16, tp=2,
                       buckets=CPBuckets(edges=(48,), degrees=(1, 2)),
                       shape_buckets=None if pinned
                       else ShapeBuckets(m_buckets=(1, 2, 4),
                                         s_buckets=(0, 1, 2, 4), window=2),
                       max_slots_per_instance=4, pipeline=pipeline,
                       device="cpu", **kw)
    rng = np.random.default_rng(0)
    for L in (80, 20):
        if cfg.is_encoder_decoder:
            eng.add_audio_request(rng.standard_normal((L, cfg.d_model)),
                                  rng.integers(0, 256, (3,)),
                                  max_new_tokens=6)
        else:
            eng.add_request(rng.integers(0, 256, (L,)), max_new_tokens=6)
    eng.step()
    return eng


@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_decode_step_is_capturable(case):
    """One decode step of the engine's last bucket, on the tensors its
    graph would capture, runs under ``NoHostSync`` without raising (an
    attention-free model routes no rows)."""
    arch, over, kw = CAPTURE_CASES[case]
    eng = _small_engine(arch, over, kw)
    key = eng.last_bucket
    routes = key[1] > 0 and eng.last_rounds_used > 0
    assert routes == eng.cfg.has_attention, key
    fn, shapes = eng._build_step(key)
    params, state, tables = eng._graph_inputs(shapes)
    with torch.no_grad(), NoHostSync():
        _, toks, logits = fn(params, state, tables)
    assert toks.shape == tables["slot_token"].shape
    assert torch.isfinite(logits).all()
    # the probe itself catches a host read
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            int(toks.sum())


# --------------------------------------------------------------------------- #
# (c) the static-buffer contract
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["tinyllama", "minicpm3-fp8", "jamba"])
def test_step_on_refilled_buffers_equals_fresh_tensors(case):
    """A graph replays on the same table buffers and state tensors with new
    contents.  From the same pools and tables, the step on the engine's
    own buffers, refilled in place after other contents, equals the step
    on fresh tensors bit for bit, and no buffer moved."""
    arch, over, kw = CAPTURE_CASES[case]
    eng = _small_engine(arch, over, kw, pipeline=False)
    eng.step()
    key = eng.last_bucket
    fn, shapes = eng._build_step(key)
    params, state, tables = eng._graph_inputs(shapes)
    ptrs = InPlaceAudit(params, state, tables)
    tbl_np = {k: v.numpy().copy() for k, v in tables.items()}
    pools0 = {k: v.clone() for k, v in state.items()}

    fresh_state = {k: v.clone() for k, v in pools0.items()}
    fresh_tables = routing.DeviceTables("cpu").buffers(shapes)
    for k, v in fresh_tables.items():
        v.copy_(torch.from_numpy(tbl_np[k]))
    with torch.no_grad():
        _, toks_f, logits_f = fn(params, fresh_state, fresh_tables)

    # other contents first (a later step's pools and zeroed tables), then
    # refill the same storage in place: the state by copy, the tables by
    # the engine's own upload path
    with torch.no_grad():
        fn(params, state, tables)
    for t in tables.values():
        t.zero_()
    for k, v in state.items():
        v.copy_(pools0[k])
    dims = dict(W=2, M=key[0], S=key[1], N=tbl_np["work_src"].shape[1],
                MB=key[2], MBT=0, R=key[4])
    up = eng._dev_tables.upload(routing.RoutingTables(**dims, **tbl_np))
    assert all(up[k].data_ptr() == tables[k].data_ptr() for k in tables)
    with torch.no_grad():
        _, toks_r, logits_r = fn(params, state, tables)
    ptrs.check(params, state, tables)
    assert torch.equal(toks_r, toks_f)
    assert torch.equal(logits_r, logits_f)
    for k in state:
        assert torch.equal(state[k].view(torch.uint8),
                           fresh_state[k].view(torch.uint8)), k


# --------------------------------------------------------------------------- #
# (d) the join prewarm leaves the pools bit-equal
# --------------------------------------------------------------------------- #
def test_join_prewarm_leaves_pools_bit_equal():
    """A kill at (8, 1) in two nodes of four narrows the ring the steps
    route over; rejoining the instance prewarms the wider-ring buckets
    (new cache entries, none counted online) and leaves every pool byte
    as it was."""
    cfg = reduced(CONFIGS["tinyllama-1.1b"], vocab_size=256)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    eng = NanoCPEngine(cfg, params, num_instances=8, instances_per_node=4,
                       kv_capacity_tokens=4096, page_size=16, tp=1,
                       buckets=CPBuckets(edges=(64, 160), degrees=(1, 2, 3)),
                       max_slots_per_instance=4, device="cpu")
    rng = np.random.default_rng(0)
    for L in (24, 90, 180):
        eng.add_request(rng.integers(0, 256, (L,)), max_new_tokens=12)
    for _ in range(3):
        eng.step()
    victim = eng.cluster.active[2].moe_binding
    eng.fail_instance(victim)
    for _ in range(3):
        eng.step()
    before = {k: v.clone() for k, v in eng.state.items()}
    keys, online = set(eng.aot.cached_keys()), eng.aot.stats.online_compiles
    eng.join_instance(victim)
    new = set(eng.aot.cached_keys()) - keys
    assert new, "the join prewarmed no bucket"
    for k in new:       # each is a cached bucket at a wider ring reach
        assert any(j[:4] == k[:4] and j[4] < k[4] for j in keys), k
    assert eng.aot.stats.online_compiles == online
    for k, v in eng.state.items():
        assert torch.equal(v.view(torch.uint8), before[k].view(torch.uint8)), k
    eng.run(max_iters=40)
    assert all(len(r.tokens) == 12 for r in eng.results.values())


# --------------------------------------------------------------------------- #
# (e) the replay's in-place audit
# --------------------------------------------------------------------------- #
def test_in_place_audit_raises_on_moved_pointer():
    """What a replay checks before it launches: writes in place pass, and
    a state tensor, param or table buffer rebound to new storage raises,
    naming it."""
    params = {"embed": {"tok": torch.zeros(8, 4)},
              "blocks": {"layers": [{"wq": torch.zeros(4, 4)}]}, "head": {}}
    state = {"k_pool": torch.zeros(2, 4), "v_pool": torch.zeros(2, 4)}
    tables = {"slot_token": torch.zeros(2, 3, dtype=torch.int32)}
    audit = InPlaceAudit(params, state, tables)
    state["k_pool"].add_(1.0)
    tables["slot_token"].copy_(torch.ones(2, 3, dtype=torch.int32))
    params["blocks"]["layers"][0]["wq"][0, 0] = 2.0
    audit.check(params, state, tables)
    for tree, path, name in ((state, ("v_pool",), "/1/v_pool"),
                             (params, ("blocks", "layers", 0, "wq"),
                              "/0/blocks/layers/0/wq"),
                             (tables, ("slot_token",), "/2/slot_token")):
        node = tree
        for p in path[:-1]:
            node = node[p]
        old = node[path[-1]]
        node[path[-1]] = old.clone()
        with pytest.raises(RuntimeError, match=name):
            audit.check(params, state, tables)
        node[path[-1]] = old
    audit.check(params, state, tables)
    state["extra"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="tensor count"):
        audit.check(params, state, tables)


def test_graphs_are_cuda_only():
    """Asking a CPU engine for CUDA graphs raises; the CPU engine runs the
    eager step and its cache holds step functions."""
    cfg = reduced(CONFIGS["tinyllama-1.1b"], num_layers=2, vocab_size=128)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    kw = dict(num_instances=1, instances_per_node=1, kv_capacity_tokens=128,
              tp=1, device="cpu")
    with pytest.raises(ValueError, match="cuda_graphs"):
        NanoCPEngine(cfg, params, cuda_graphs=True, **kw)
    eng = NanoCPEngine(cfg, params, **kw)
    assert eng.aot.graph_inputs is None and eng.aot.pool is None
    eng.add_request(np.arange(20), max_new_tokens=3)
    eng.run(max_iters=10)
    assert eng.aot.num_graphs >= 1
    assert all(callable(eng.aot.lookup_key(k)) for k in eng.aot.cached_keys())
    eng.close()
    assert eng.aot.num_graphs == 0
