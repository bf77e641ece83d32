"""The paper's end-to-end comparison on a simulated 32-instance DeepSeek-V3
cluster, through the PyTorch port: NanoCP vs vLLM-style baselines under a
mixed ShareGPT-4o + GitHub-Issue workload.  The control plane is the
port's NanoCP scheduler; data-plane latencies come from its analytic
``LatencyModel``.  By default that model carries the NVIDIA H100 SXM5
datasheet's constants, so the derived CP buckets and every TPOT below are
modeled on those constants, not measured on a card.  Nothing here touches
a GPU.

  PYTHONPATH=src python examples/torch_simulate_cluster.py [rate] [long_ratio]
"""
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.bucketing import derive_buckets
from repro_torch.core.scheduler import (DualBalancedScheduler,
                                        LeastBatchScheduler,
                                        LeastCacheScheduler,
                                        UniformCPScheduler)
from repro_torch.serving import metrics
from repro_torch.serving.latency_model import LatencyModel
from repro_torch.serving.simulator import ClusterSimulator
from repro_torch.serving.workload import make_workload

ARCH = "deepseek-v3"
NUM_INSTANCES, INSTANCES_PER_NODE = 32, 8
DURATION, HORIZON, SEED = 20.0, 120.0, 0


def workload(rate: float, ratio: float):
    return make_workload("mixed", rate=rate, duration=DURATION,
                         long_ratio=ratio, seed=SEED)


def run(rate: float = 250.0, ratio: float = 0.05, *,
        latency: LatencyModel | None = None) -> list[dict]:
    """One simulated run per scheduler on the same workload: the table's
    rows (modeled TPOTs in seconds, SLO attainment, mean KV and batch
    imbalance in percent, the share of requests served at CP > 1).
    ``latency`` defaults to DeepSeek-V3 on the port's ``HardwareModel``
    (the H100 datasheet's)."""
    lm = latency or LatencyModel(get_config(ARCH))
    buckets = derive_buckets(lm)
    wl = workload(rate, ratio)
    rows = []
    for name, sched in [
        ("nanocp", DualBalancedScheduler(buckets=buckets)),
        ("least_batch", LeastBatchScheduler()),
        ("least_cache", LeastCacheScheduler()),
        ("uniform_cp8", UniformCPScheduler(cp=8)),
    ]:
        sim = ClusterSimulator(lm.cfg, sched, num_instances=NUM_INSTANCES,
                               instances_per_node=INSTANCES_PER_NODE,
                               kv_capacity_tokens=1_000_000, latency=lm,
                               multi_step=4)
        res = sim.run(wl, horizon=HORIZON)
        fin = res.finished
        total = sum(res.cp_degree_hist.values())
        multi = sum(v for k, v in res.cp_degree_hist.items() if k > 1)
        rows.append({
            "system": name,
            "mean_tpot_s": metrics.mean_tpot(fin),
            "p99_tpot_s": metrics.p99_tpot(fin),
            "slo": metrics.slo_attainment(fin),
            "kv_imbalance_pct": float(np.mean(
                [metrics.imbalance_pct(k) for k in res.kv_series])),
            "batch_imbalance_pct": float(np.mean(
                [metrics.imbalance_pct(b) for b in res.batch_series])),
            "cp_multi_share": multi / max(total, 1)})
    return rows


def format_row(row: dict) -> str:
    """One line of the table, in the reference example's format."""
    return (f"{row['system']:14s} {row['mean_tpot_s']*1e3:8.2f}ms "
            f"{row['p99_tpot_s']*1e3:8.2f}ms "
            f"{row['slo']:6.3f} {row['kv_imbalance_pct']:7.1f}% "
            f"{row['batch_imbalance_pct']:8.1f}% "
            f"{row['cp_multi_share']:6.2%}")


def main() -> None:
    rate = float(sys.argv[1]) if len(sys.argv) > 1 else 250.0
    ratio = float(sys.argv[2]) if len(sys.argv) > 2 else 0.05
    lm = LatencyModel(get_config(ARCH))
    hw = lm.hw
    print(f"DeepSeek-V3, {NUM_INSTANCES} instances, rate={rate}/s, "
          f"{ratio:.0%} long requests; derived CP buckets: "
          f"{derive_buckets(lm)}")
    print(f"modeled, not measured: LatencyModel on the H100 SXM5 datasheet "
          f"(peak {hw.peak_flops:.3g} FLOP/s bf16, HBM {hw.hbm_bw:.3g} B/s, "
          f"NVLink {hw.link_bw:.3g} B/s per direction)")
    wl = workload(rate, ratio)
    print(f"{len(wl.requests)} requests "
          f"(shares: { {k: round(v, 3) for k, v in wl.interval_shares().items()} })\n")
    print(f"{'system':14s} {'mean TPOT':>10s} {'P99 TPOT':>10s} {'SLO':>6s} "
          f"{'kv imb':>8s} {'batch imb':>9s} {'CP>1':>6s}   (TPOTs modeled)")
    for row in run(rate, ratio, latency=lm):
        print(format_row(row))
    print("\nexpected: nanocp sustains the SLO with the lowest P99 and the "
          "best joint KV/batch balance (paper Figs. 12/14/18)")


if __name__ == "__main__":
    main()
