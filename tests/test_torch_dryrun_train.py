"""The launch layer's train and prefill cells on ``meta`` against the JAX
package's ``jax.eval_shape`` of the same cells (the decode cells and the
dry run's command line are in ``test_torch_dryrun.py``): every config at
``train_4k`` and ``prefill_32k``, and one train cell with
``hybrid_reduce`` (the port's data-shard step, bf16 compression)."""
import pytest

from repro_torch import configs
from test_torch_dryrun import ReferenceTrees, check_cell
from test_torch_launch import _one_thread  # noqa: F401

CASES = {f"{a}/{s}": (a, s, False, {})
         for a in (*configs.ASSIGNED, "deepseek-v3")
         for s in configs.applicable_shapes(configs.get_config(a))
         if configs.SHAPES[s].kind in ("train", "prefill")}
CASES["tinyllama-1.1b/train_4k/hybrid"] = ("tinyllama-1.1b", "train_4k",
                                           False, {"hybrid_reduce": True})


@pytest.fixture(scope="module")
def ref_trees():
    refs = ReferenceTrees(CASES)
    yield refs
    refs.close()


@pytest.mark.parametrize("key", sorted(CASES))
def test_cell_runs_on_meta_with_the_reference_tree(key, ref_trees):
    check_cell(CASES[key], ref_trees, key)
