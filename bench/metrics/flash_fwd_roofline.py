"""The flash forward kernel's share of its roofline (%): the least time of
every prefill attention call of the window (one per attention layer and
prompt; causal operations and q, k, v, output once, ``counts.flash_prefill``)
over the device time of the kernels of ``csrc/flash_fwd.cu``."""
from bench import counts

KERNELS = ("flash_fwd_f32", "flash_fwd_bf16")


def read(rec):
    t = sum(s for n, s in rec["kernel_s"].items()
            if any(k in n for k in KERNELS))
    model = rec["model"]
    layers = counts.attention_layers(model)
    least = sum(layers * counts.least_seconds(*counts.flash_prefill(model, S))
                for s in rec["steps"] for S in s["prefills"])
    return 100.0 * least / t if t and least else None
