"""Analytic per-phase decode latency model (a port of
``repro/serving/latency_model.py`` retargeted to the NVIDIA H100).

The cluster simulator, the SLO harness's virtual model clock and the
Bucket(len) offline-profiling sweep run on this model.  Its formulas and
fields are the reference's; only ``HardwareModel``'s defaults differ: the
chip terms are the H100's published figures (see the class).  It keeps the
per-phase structure of the paper's Figure 4/13 decomposition:

  attention  — memory-bound KV sweep + per-row fixed overhead (Fig. 3a)
  dispatch/combine — per-rank all-to-all scaling with batch (Fig. 3b)
  DCP Q/Res routing — (W-1) rotation hops of bucketed small buffers
  expert FFN / dense FFN — compute-bound

All times are SECONDS for ONE decode layer unless noted.  They are modeled
seconds, not measured ones.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig


@dataclass(frozen=True)
class HardwareModel:
    """Chip and link constants.  ``peak_flops``, ``hbm_bw`` and ``link_bw``
    are the NVIDIA H100 SXM5 80GB datasheet's figures at 700 W: dense bf16
    tensor-core peak, HBM3 bandwidth, and NVLink bandwidth per direction
    (900 GB/s total over both directions).  The datasheet gives no value
    for the other fields (instance width, collective alphas, per-row and
    launch overheads, the inter-node link class); they keep the
    reference's values."""
    peak_flops: float = 989e12        # bf16 dense / chip
    hbm_bw: float = 3.35e12           # B/s / chip
    link_bw: float = 450e9            # B/s / chip, NVLink, one direction
    chips_per_instance: int = 16      # `model` axis within a DP instance
    hop_latency: float = 2e-6         # per collective hop (alpha)
    per_row_overhead: float = 1.5e-6  # decode attention fixed cost per row
    kernel_base: float = 4e-6         # kernel launch / fusion base cost
    # inter-node link class (DCN/IB): crossing a node boundary pays a far
    # thinner pipe and a fatter alpha — the reason the scheduler treats the
    # boundary as a cost and crosses it only as a last resort
    inter_link_bw: float = 12.5e9     # B/s / link, cross-node
    inter_hop_latency: float = 10e-6  # per cross-node hop (alpha)


@dataclass
class LatencyModel:
    cfg: ModelConfig
    hw: HardwareModel = HardwareModel()
    ep_size: int = 32                 # instances sharing the expert pool
    # paged-KV storage precision (kernels/quant.py): scales the KV byte
    # terms — pool sweeps, reshard payloads, scatter writes.  Weights stay
    # bf16 (kv_dtype only covers the paged pools).
    kv_dtype: str = "bf16"

    # ---------------- per-layer weight footprints (bf16 bytes) ----------
    @property
    def attn_weight_bytes(self) -> float:
        c = self.cfg
        if not c.has_attention:
            return 0.0
        if c.is_mla:
            p = (c.d_model * (c.q_lora_rank or 0)
                 + (c.q_lora_rank or c.d_model) * c.num_heads
                 * (c.qk_nope_head_dim + c.qk_rope_head_dim)
                 + c.d_model * (c.kv_lora_rank + c.qk_rope_head_dim)
                 + c.kv_lora_rank * c.num_heads
                 * (c.qk_nope_head_dim + c.v_head_dim)
                 + c.num_heads * c.v_head_dim * c.d_model)
        else:
            p = c.d_model * (c.num_heads + 2 * c.num_kv_heads) * c.head_dim_ \
                + c.num_heads * c.head_dim_ * c.d_model
        return 2.0 * p

    @property
    def expert_weight_bytes(self) -> float:
        return 2.0 * 3 * self.cfg.d_model * self.cfg.moe_d_ff_

    @property
    def dense_ffn_weight_bytes(self) -> float:
        mult = 3 if self.cfg.act == "silu" else 2
        return 2.0 * mult * self.cfg.d_model * self.cfg.d_ff

    def _sweep(self, nbytes: float) -> float:
        """HBM time to stream ``nbytes`` across the instance's chips."""
        return nbytes / (self.hw.hbm_bw * self.hw.chips_per_instance)

    # ---------------- per-token constants ----------------
    @property
    def kv_bytes_per_token(self) -> float:
        """KV bytes per token per attention layer at ``kv_dtype`` (bf16 = 2
        bytes/value, fp8/int8 = 1; per-page scales are amortized to ~0)."""
        from ..kernels.quant import kv_bytes_per_value
        b = kv_bytes_per_value(self.kv_dtype)
        c = self.cfg
        if c.is_mla:
            return b * (c.kv_lora_rank + c.qk_rope_head_dim)
        return b * 2 * c.num_kv_heads * c.head_dim_

    @property
    def q_row_bytes(self) -> float:
        c = self.cfg
        if c.is_mla:
            return 2.0 * c.num_heads * (c.kv_lora_rank + c.qk_rope_head_dim)
        return 2.0 * c.num_heads * c.head_dim_

    # ---------------- phases (one layer) ----------------
    def attention_time(self, kv_tokens: float, rows: float) -> float:
        """Paged decode attention over ``kv_tokens`` resident tokens with
        ``rows`` work rows on one instance (Fig. 3a shape).  Includes the
        per-layer attention weight sweep (decode is bandwidth-bound)."""
        sweep = kv_tokens * self.kv_bytes_per_token / (
            self.hw.hbm_bw * self.hw.chips_per_instance)
        return (self.hw.kernel_base + self._sweep(self.attn_weight_bytes)
                + sweep + rows * self.hw.per_row_overhead)

    @property
    def inst_link_bw(self) -> float:
        """Instance-to-instance bandwidth: every chip of the instance moves
        its own model-shard slice over its own links in parallel."""
        return self.hw.link_bw * self.hw.chips_per_instance

    @property
    def inst_link_bw_inter(self) -> float:
        """Cross-node instance-to-instance bandwidth (inter link class)."""
        return self.hw.inter_link_bw * self.hw.chips_per_instance

    def _link(self, inter: bool) -> tuple[float, float]:
        """(bandwidth, hop alpha) of a link class."""
        if inter:
            return self.inst_link_bw_inter, self.hw.inter_hop_latency
        return self.inst_link_bw, self.hw.hop_latency

    def a2a_link_times(self, batch: float,
                       inter_frac: float = 0.0) -> tuple[float, float]:
        """One all-to-all phase split by link class: (intra_s, inter_s) for
        ``batch`` tokens with ``inter_frac`` of the expert traffic crossing
        node boundaries (EP spanning nodes).  The classes overlap, so the
        phase time is their max plus the alphas."""
        if not self.cfg.is_moe or batch <= 0:
            return 0.0, 0.0
        bytes_ = batch * self.cfg.num_experts_per_tok * self.cfg.d_model * 2
        t_intra = bytes_ * (1.0 - inter_frac) / self.inst_link_bw
        t_inter = bytes_ * inter_frac / self.inst_link_bw_inter
        return t_intra, t_inter

    def a2a_time(self, batch: float, inter_frac: float = 0.0) -> float:
        """One all-to-all phase (dispatch OR combine) for ``batch`` tokens on
        the sending instance (Fig. 3b shape).  ``inter_frac`` is the share
        of expert traffic that crosses a node boundary."""
        if not self.cfg.is_moe or batch <= 0:
            return 0.0
        t_intra, t_inter = self.a2a_link_times(batch, inter_frac)
        alpha = self.hw.hop_latency * 2
        if inter_frac > 0:
            alpha += self.hw.inter_hop_latency * 2
        return alpha + max(t_intra, t_inter)

    def cp_route_time(self, rounds: int, rows: float,
                      inter: bool = False) -> float:
        """Q-routing or Res-routing: ``rounds`` rotation hops carrying
        ``rows`` bucketed rows each, over the given link class."""
        if rounds <= 0 or rows <= 0:
            return 0.0
        bw, alpha = self._link(inter)
        return rounds * (alpha + rows * self.q_row_bytes / bw)

    def dense_cp_route_time(self, group: int, batch: float) -> float:
        """Helix/NCCL-style uniform CP: all-gather the full batch to the
        group (both directions)."""
        if group <= 1:
            return 0.0
        bytes_ = (group - 1) * batch * self.q_row_bytes
        return (group - 1) * self.hw.hop_latency + bytes_ / self.inst_link_bw

    def ffn_time(self, tokens: float) -> float:
        """Dense FFN or per-instance expert compute for ``tokens`` tokens
        (``tokens`` = expert-tokens received on the instance for MoE).
        max(compute, weight sweep): decode batches are weight-BW-bound."""
        c = self.cfg
        if c.is_moe:
            flops = tokens * 6 * c.d_model * c.moe_d_ff_
            e_local = max(1, c.num_experts // self.ep_size)
            touched = min(e_local, max(tokens, 1.0))
            wbytes = touched * self.expert_weight_bytes
            if c.num_shared_experts:
                flops += tokens * 6 * c.d_model * c.moe_d_ff_ * c.num_shared_experts
                wbytes += c.num_shared_experts * self.expert_weight_bytes
        else:
            flops = tokens * 6 * c.d_model * c.d_ff
            wbytes = self.dense_ffn_weight_bytes
        return self.hw.kernel_base + max(
            flops / (self.hw.peak_flops * self.hw.chips_per_instance),
            self._sweep(wbytes))

    def qkv_time(self, tokens: float) -> float:
        c = self.cfg
        if c.is_mla:
            per_tok = 2 * (c.d_model * (c.q_lora_rank or c.d_model)
                           + c.kv_lora_rank * c.num_heads
                           * (c.qk_nope_head_dim + c.v_head_dim))
        else:
            per_tok = 2 * c.d_model * (c.num_heads + 2 * c.num_kv_heads) \
                * c.head_dim_
        return self.hw.kernel_base + tokens * per_tok / (
            self.hw.peak_flops * self.hw.chips_per_instance)

    @property
    def num_attn_layers(self) -> int:
        """TOTAL attention layers in the stack (block_pattern is ONE
        repeating block; the pools the re-shard moves are [nb, na, ...])."""
        per_block = sum(1 for k in self.cfg.block_pattern()
                        if k["mixer"] == "attn")
        return self.cfg.num_blocks * per_block

    def kv_reshard_time(self, tokens_moved: float,
                        inter: bool = False) -> float:
        """Live KV re-shard (mid-decode CP escalation): gather + scatter the
        moved tokens' KV for EVERY attention layer across instance links —
        one hop out of the donor, one into the receiver — plus the HBM sweep
        to read and rewrite the pages on both ends.  ``inter`` charges the
        cross-node link class for moves whose donor and receiver sit on
        different nodes."""
        if tokens_moved <= 0:
            return 0.0
        bw, alpha = self._link(inter)
        bytes_ = tokens_moved * self.kv_bytes_per_token * self.num_attn_layers
        return (2 * alpha + self.hw.kernel_base
                + bytes_ / bw
                + 2 * bytes_ / (self.hw.hbm_bw * self.hw.chips_per_instance))

    def reprefill_time(self, tokens: int) -> float:
        """Failure-recovery re-prefill: replay ``tokens`` lost positions
        through the full forward (prefill-class compute, FLOPs-bound at
        recovery chunk sizes) and scatter their KV into the replacement
        placement.  Charged once per recovery event — the cost knob that
        makes the simulator's chaos sweeps price partial-shard recovery
        against degraded finishes."""
        if tokens <= 0:
            return 0.0
        c = self.cfg
        # per-token forward FLOPs ~ 2 * activated params; attention's
        # quadratic term stays negligible at recovery chunk sizes
        if c.is_moe:
            ffn = 6 * c.d_model * c.moe_d_ff_ * (
                max(c.num_experts_per_tok, 1) + (c.num_shared_experts or 0))
        else:
            ffn = 6 * c.d_model * c.d_ff
        qkv = 2 * c.d_model * (c.num_heads + 2 * c.num_kv_heads) * c.head_dim_ \
            if c.has_attention and not c.is_mla else 4 * c.d_model * c.d_model
        flops = tokens * self.cfg.num_layers * (ffn + qkv)
        compute = flops / (self.hw.peak_flops * self.hw.chips_per_instance)
        # scatter the re-computed KV into the pools (HBM write, all layers)
        scatter = tokens * self.kv_bytes_per_token * self.num_attn_layers / (
            self.hw.hbm_bw * self.hw.chips_per_instance)
        return self.hw.kernel_base + compute + scatter

    def relax_breakeven_steps(self, tokens_moved: float, rounds_saved: int,
                              rows: float = 1.0,
                              inter: bool = False) -> float:
        """Decode steps after which a relaxation's ONE-TIME re-shard cost is
        repaid by the PER-STEP Q/Res routing rounds it removes (both
        directions, every attention layer).

        This is the analytic form of the relax cost gate: retracting a
        cross-node member pays for itself within a handful of steps (thin
        inter links make ``rounds_saved`` expensive), so the scheduler's
        structural gates (never below the profiled bucket degree; net frame
        reclaim for consolidation) approximate `breakeven << remaining
        decode'.  inf when nothing is saved (``rounds_saved == 0`` moves are
        pure defragmentation — gated on frame reclaim instead)."""
        saved = (2 * self.cp_route_time(rounds_saved, rows, inter=inter)
                 * self.num_attn_layers)
        if saved <= 0.0:
            return float("inf")
        return self.kv_reshard_time(tokens_moved, inter=inter) / saved

    # ---------------- composite: DCP attention for one request ----------
    def dcp_attention_latency(self, length: int, cp: int) -> float:
        """Offline-profiling objective for Bucket(len) derivation: one
        request's attention latency at CP degree ``cp`` (shard sweep +
        Q/Res routing + merge)."""
        shard = self.attention_time(length / cp, 1.0)
        route = 2 * self.cp_route_time(cp - 1, 1.0)     # Q out + results back
        merge = cp * 0.2e-6
        return shard + route + merge
