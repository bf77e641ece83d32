"""The other six reduced configs' loss and gradients against
``jax.value_and_grad(repro.models.loss_fn)``: qkv bias (Qwen1.5, Qwen2.5),
qk-norm (Chameleon; Llama-4-Scout with MoE top-1 plus a shared expert),
DeepSeek-V3 (MLA with MoE) and the hybrid Jamba.  The check, its weights
(the JAX init with biases, norm scales and SSD vectors perturbed) and its
tolerances are tests/test_torch_train_models.py's; this file holds these
configs so that each file stays under a minute and the workers spread
them.
"""
import pytest

from test_torch_train_models import _one_thread, check_loss_and_grads  # noqa: F401

ARCHS = ["qwen1.5-0.5b", "qwen2.5-14b", "chameleon-34b",
         "llama4-scout-17b-a16e", "deepseek-v3", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
