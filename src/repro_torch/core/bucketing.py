"""CP-degree length buckets (Alg. 1 l.8) + AOT shape buckets (Alg. 2).

``Bucket(len) -> cp_degree`` is derived from "offline profiling": we sweep
sequence lengths x candidate CP degrees under the analytic DCP latency model
(attention shard time + Q/Res routing + merge) and pick the argmin degree per
length range — the same procedure the paper runs on hardware, driven here by
the roofline-calibrated model in ``serving/latency_model.py``.

Shape buckets quantise the per-instance execution shape (M = local batch,
N = attention work rows, S = cross-instance send rows) to a bounded family so
the AOT engine pre-compiles a small set of executables (CUDA-Graph analogue).
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field


# --------------------------------------------------------------------------- #
# CP degree buckets
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class CPBuckets:
    """Monotone thresholds: length < edges[i] -> degree degrees[i]."""
    edges: tuple = (32_768, 131_072, 262_144)
    degrees: tuple = (1, 2, 4, 8)

    def __post_init__(self):
        assert len(self.degrees) == len(self.edges) + 1
        assert all(self.degrees[i] <= self.degrees[i + 1]
                   for i in range(len(self.degrees) - 1)), "degrees must be monotone"

    def cp_degree(self, length: int) -> int:
        return self.degrees[bisect.bisect_right(self.edges, length)]


DEFAULT_BUCKETS = CPBuckets()


def derive_buckets(latency_model, max_degree: int = 8,
                   lengths=(4_096, 16_384, 32_768, 65_536, 131_072, 262_144,
                            524_288, 1_048_576)) -> CPBuckets:
    """Offline profiling sweep: pick argmin-latency CP degree per length.

    ``latency_model`` must expose ``dcp_attention_latency(length, cp) -> sec``
    (attention over length/cp tokens + (cp-1)-hop Q/Res routing + merge).
    """
    best = []
    for L in lengths:
        cands = [d for d in (1, 2, 4, 8, 16) if d <= max_degree]
        lat = {d: latency_model.dcp_attention_latency(L, d) for d in cands}
        best.append(min(cands, key=lambda d: lat[d]))
    # enforce monotonicity (longer requests never get a smaller degree)
    for i in range(1, len(best)):
        best[i] = max(best[i], best[i - 1])
    edges, degrees = [], [best[0]]
    for L, d in zip(lengths[1:], best[1:]):
        if d != degrees[-1]:
            # threshold at the first length preferring the larger degree
            edges.append(L)
            degrees.append(d)
    return CPBuckets(tuple(edges), tuple(degrees))


# --------------------------------------------------------------------------- #
# AOT shape buckets
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeBuckets:
    """Quantisation grid for per-instance execution shapes.

    M: local decode slots; S: cross-instance send rows per routing round;
    N: attention work rows = M + received rows (bounded by M + (W-1)*S).
    """
    m_buckets: tuple = (1, 2, 4, 8, 16, 32, 64, 128, 256)
    s_buckets: tuple = (0, 1, 2, 4, 8, 16, 32)
    window: int = 8                      # W: max CP window (ring neighborhood)

    def round_m(self, m: int) -> int:
        return _round_to(self.m_buckets, max(m, 1))

    def round_s(self, s: int) -> int:
        return _round_to(self.s_buckets, s)

    def bucket(self, m: int, s: int) -> tuple[int, int, int]:
        """(M_hat, S_hat, N_hat) for observed max local batch m / send rows s."""
        mh = self.round_m(m)
        sh = self.round_s(s)
        return mh, sh, mh + (self.window - 1) * sh

    def family(self) -> list[tuple[int, int, int]]:
        """Every bucket the AOT engine may capture (Table-2 accounting)."""
        return [(m, s, m + (self.window - 1) * s)
                for m in self.m_buckets for s in self.s_buckets]


def _round_to(grid, x):
    for g in grid:
        if x <= g:
            return g
    raise ValueError(f"shape {x} exceeds the largest bucket {grid[-1]}; "
                     f"AOT family must bound the execution shape")


DEFAULT_SHAPE_BUCKETS = ShapeBuckets()
