"""NanoCP core, ported: the numpy control plane (``page_table``, ``state``,
``scheduler``, ``waterfill``, ``bucketing``, ``routing``), the per-bucket
step cache (``aot``) and the data plane on a virtual (instance, tp) mesh
(``comm``, ``dcp``, ``moe_parallel``, ``migrate``)."""
