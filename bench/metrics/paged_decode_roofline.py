"""The paged decode kernel's share of its roofline (%): the least time of
every paged call of the window's decode steps (one per attention layer;
bytes: each valid KV token's pool row once, q, output, log-sum-exp and
block tables, ``counts.paged_decode``) over the device time of the kernels
of ``csrc/paged_decode.cu`` (``paged_split_kernel``, ``merge_kernel``).
The KV tokens of a step are those of the requests still active after its
dispatch: a request that finished at that dispatch is left out, which only
lowers the share."""
from bench import counts

KERNELS = ("paged_split_kernel", "merge_kernel")


def read(rec):
    t = sum(s for n, s in rec["kernel_s"].items()
            if any(k in n for k in KERNELS))
    model = rec["model"]
    layers = counts.attention_layers(model)
    least = sum(layers * counts.least_seconds(*counts.paged_decode(
        model, s["rows"], s["kv_tokens"], rec["cell"]["engine"]["page_size"]))
        for s in rec["steps"] if s["decode"] and s["rows"])
    return 100.0 * least / t if t and least else None
