"""Hopper kernels for the decode and prefill hot spots, each beside its
plain torch version (``ref``); ``ops`` dispatches by tensor device.

  * ``paged_attention`` — paged decode attention with LSE (``csrc/paged_decode.cu``).
  * ``flash_attention`` — flash-attention forward with LSE (``csrc/flash_fwd.cu``),
                        an op whose gradient is the ported ``flash_backward``.
  * ``quant``           — fp8/int8 KV formats, per-page scales, (de)quant.
  * ``build``           — nvcc build + ctypes loading of ``csrc/*.cu``.
"""
