"""Routing-based communication backend (§5.3) on a virtual mesh
(port of ``repro/core/comm.py``).

The JAX package runs one program per (instance, tp) device under
``shard_map`` and moves rows between instances with ``lax.ppermute`` ring
rotations.  The port runs the whole (I, tp) mesh in one process on one
GPU: every per-device tensor keeps leading ``[I, tp]`` dims, and a
rotation by ``delta`` within ``node``-sized ring segments becomes
``torch.roll`` along the instance dim — exactly the rows the ppermute
pairs of ``node_rotation_pairs`` deliver.

Rounds follow the ZIG-ZAG schedule of the reference: round r carries delta
+1, -1, +2, -2, … (``ring_delta``).  The dense all-gather baseline
(``allgather_backend``) gathers every instance's buffer; on the virtual
mesh the ``[I, ...]`` tensor already is that gathered buffer, so reading a
peer's rows is an index.
"""
from __future__ import annotations

import torch


def ring_delta(round_: int):
    """Zig-zag schedule: rounds 1, 2, 3, 4, … carry deltas +1, -1, +2, -2, …
    (round 0 = local, delta 0).  Works elementwise on integer arrays."""
    return (round_ + 1) // 2 * (2 * (round_ % 2) - 1)


def ring_round(offset: int, size: int) -> int:
    """Inverse of ``ring_delta`` within a ``size`` ring: the rotation round
    whose delta is congruent to ``offset`` (mod size).  Bijective over
    offsets 1..size-1 -> rounds 1..size-1; offset 0 -> round 0."""
    o = offset % size
    if o == 0:
        return 0
    back = size - o
    return 2 * o - 1 if o <= back else 2 * back


def node_local_rounds(node_width: int) -> int:
    """Highest zig-zag round a NODE-LOCAL binding can occupy: members within
    |offset| < W_node of their sender land in rounds <= 2*(W_node - 1)."""
    return max(2 * (node_width - 1), 0)


def node_rotation_pairs(axis_size: int, node: int, delta: int) -> list:
    """Cyclic rotation by ``delta`` within each ``node``-sized segment:
    (sender, receiver) pairs, as ``lax.ppermute`` takes them."""
    return [(a, (a // node) * node + ((a % node) + delta) % node)
            for a in range(axis_size)]


def rotate(buf: torch.Tensor, delta: int, node: int) -> torch.Tensor:
    """What each instance receives when every instance sends ``buf[a]`` by
    the pairs ``node_rotation_pairs(I, node, delta)``: receiver b gets the
    buffer of sender (b - delta) within its segment.  buf: [I, ...]."""
    I = buf.shape[0]
    seg = buf.reshape(I // node, node, *buf.shape[1:])
    return torch.roll(seg, shifts=delta, dims=1).reshape(buf.shape)


def route_rounds(payload_fn, send_idx: torch.Tensor, num_rounds: int, *,
                 node: int, reverse: bool = False) -> list:
    """Run the rotation rounds of the routing backend on the virtual mesh.

    payload_fn(d, idx) -> the [I, tp, S, ...] buffers every instance emits
      in round d (idx = send_idx[:, d-1] [I, S]; -1 entries give zero rows).
    Returns the received buffers, one [I, tp, S, ...] per round (round d's
    buffer came from the instance ``ring_delta(d)`` steps behind, or ahead
    if ``reverse``).
    """
    recvs = []
    for d in range(1, num_rounds + 1):
        buf = payload_fn(d, send_idx[:, d - 1])
        delta = int(ring_delta(d))
        recvs.append(rotate(buf, -delta if reverse else delta, node))
    return recvs


def gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-instance row gather: pool [I, tp, R, ...] at idx [I, S] (the same
    rows on every tp device of an instance), -1 -> zero rows.
    Returns [I, tp, S, ...]."""
    I, tp, R = pool.shape[:3]
    rest = pool.shape[3:]
    S = idx.shape[1]
    flat = pool.reshape(I, tp, R, -1)
    safe = idx.clamp(min=0).long()[:, None, :, None].expand(I, tp, S,
                                                            flat.shape[-1])
    rows = torch.gather(flat, 2, safe)
    rows = torch.where((idx >= 0)[:, None, :, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return rows.reshape(I, tp, S, *rest)


def allgather_backend(buf: torch.Tensor, peer: torch.Tensor,
                      row: torch.Tensor | None = None) -> torch.Tensor:
    """Dense all-gather baseline on the virtual mesh: what each instance
    reads of the gathered ``[I, ...]`` buffer.  buf: [I, tp, R, ...].

    ``peer`` [I]: instance i reads peer[i]'s whole buffer -> [I, tp, R, ...].
    ``peer``, ``row`` [I, *X]: instance i reads row row[i, x] of peer
    peer[i, x]'s buffer, on every tp device -> [I, tp, *X, ...].
    """
    if row is None:
        return buf[peer]
    tp = buf.shape[1]
    jt = torch.arange(tp, device=buf.device).reshape(1, tp,
                                                     *([1] * (peer.dim() - 1)))
    return buf[peer[:, None], jt, row[:, None]]


def routed_bytes(num_rounds: int, s_rows: int, row_bytes: int) -> int:
    """Per-instance traffic of the routed backend (one direction)."""
    return num_rounds * s_rows * row_bytes


def dense_bytes(axis_size: int, m_rows: int, row_bytes: int) -> int:
    """Per-instance traffic of the dense all-gather baseline."""
    return (axis_size - 1) * m_rows * row_bytes
