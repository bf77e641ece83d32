"""Dense decoder-only model (prefill forward), ported from ``repro.models``."""
