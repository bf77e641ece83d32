"""The port's simulator tier (``serving/simulator.py``, ``latency_model``,
``workload``, ``slo``) held equal to the JAX package's: one seeded
workload per case runs through both packages' ``ClusterSimulator.run``,
the port's ``HardwareModel`` built from the reference's fields (the port's
own defaults are the H100's), and every ``SimResult`` counter, series and
per-request token time must be equal."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core.bucketing as jbucketing
import repro.core.scheduler as jscheduler
import repro.serving.chaos as jchaos
import repro.serving.latency_model as jlatency
import repro.serving.simulator as jsimulator
import repro.serving.slo as jslo
import repro.serving.workload as jworkload
import repro_torch.configs as configs
import repro_torch.core.bucketing as bucketing
import repro_torch.core.scheduler as scheduler
import repro_torch.serving.chaos as chaos
import repro_torch.serving.latency_model as latency
import repro_torch.serving.simulator as simulator
import repro_torch.serving.slo as slo
import repro_torch.serving.workload as workload

JAX = SimpleNamespace(configs=jconfigs, bucketing=jbucketing,
                      scheduler=jscheduler, chaos=jchaos, latency=jlatency,
                      simulator=jsimulator, slo=jslo, workload=jworkload)
PORT = SimpleNamespace(configs=configs, bucketing=bucketing,
                       scheduler=scheduler, chaos=chaos, latency=latency,
                       simulator=simulator, slo=slo, workload=workload)


def _latency(pkg, cfg):
    """The reference's hardware constants in both packages."""
    hw = pkg.latency.HardwareModel(
        **dataclasses.asdict(jlatency.HardwareModel()))
    return pkg.latency.LatencyModel(cfg, hw=hw)


def _plain(x):
    """Arrays, tuples and dataclasses as nested lists, comparable by ==."""
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.astuple(x))
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _digest(res) -> dict:
    """Every SimResult field but the control plane's wall time, with the
    finished requests as (rid, status, times, binding)."""
    d = {f.name: _plain(getattr(res, f.name))
         for f in dataclasses.fields(res)
         if f.name not in ("finished", "sched_wall")}
    d["finished"] = [(r.rid, r.status, r.arrival, r.start_time,
                      r.finish_time, list(r.token_times), r.generated,
                      list(r.kv_binding), r.moe_binding,
                      r.prefix_hit_tokens) for r in res.finished]
    return d


def _case(pkg, case: str):
    """Run one case through ``pkg``; returns (digest, extra rows)."""
    cfg = pkg.configs.get_config("deepseek-v3")
    lm = _latency(pkg, cfg)
    buckets = pkg.bucketing.derive_buckets(lm)
    sched = pkg.scheduler.DualBalancedScheduler(buckets=buckets)
    kw = dict(num_instances=16, instances_per_node=8,
              kv_capacity_tokens=1_000_000, latency=lm, multi_step=4)
    run = {}
    extra = [buckets.edges, buckets.degrees]
    if case == "mixed-chaos":
        wl = pkg.workload.make_workload("mixed", rate=60, duration=3.0,
                                        long_ratio=0.05, seed=0)
        ev = pkg.chaos.ChaosSchedule.seeded(3, 16, 40, kills=2, joins=1)
        run["chaos_events"] = ev.as_time_events(0.05)
    elif case == "prefix":
        wl = pkg.workload.make_workload("sharegpt4o", rate=60, duration=3.0,
                                        seed=1, shared_prefix_groups=3,
                                        shared_prefix_frac=0.6)
        kw.update(prefix_cache=True, charge_prefill=True)
        extra.append(wl.prefix_share())
    elif case == "disagg":
        wl = pkg.workload.make_workload("mixed", rate=30, duration=2.0,
                                        long_ratio=0.05, seed=2)
        kw.update(prefill_cells=2, chunk_tokens=8192, page_size=64)
    else:
        raise ValueError(case)
    sim = pkg.simulator.ClusterSimulator(cfg, sched, **kw)
    res = sim.run(wl, horizon=60.0, **run)
    extra.append(wl.interval_shares())
    extra.append(pkg.slo.summarize(res.finished, res.submitted, slo=0.05,
                                   ttft_slo=2.0, duration=res.sim_time))
    return _digest(res), extra


@pytest.mark.parametrize("case", ["mixed-chaos", "prefix", "disagg"])
def test_simulator_run_equals_reference(case):
    got, want = _case(PORT, case), _case(JAX, case)
    assert got[1] == want[1]
    for key in want[0]:
        assert got[0][key] == want[0][key], key
    d = got[0]
    assert d["submitted"] > 20 and len(d["finished"]) == d["submitted"]
    if case == "mixed-chaos":
        assert d["failures"] >= 1 and d["joins"] >= 1
    if case == "prefix":
        assert d["prefix_hit_tokens"] > 0
    if case == "disagg":
        assert d["staged"] > 0 and d["handoff_tokens"] > 0


def _slo_rows(pkg):
    """An admission-controlled trace on a small box (shedding and
    preemption both fire) and its ``summarize`` row."""
    cfg = pkg.configs.reduced(pkg.configs.CONFIGS["tinyllama-1.1b"],
                              vocab_size=256)
    adm = pkg.scheduler.AdmissionController(
        ttft_slo=0.005, ttft_slo_long=0.02, long_threshold=100, preempt=True)
    sched = pkg.scheduler.DualBalancedScheduler(
        buckets=pkg.bucketing.CPBuckets(edges=(128,), degrees=(1, 2)),
        max_batch_per_instance=8, kv_reserve=16, admission=adm)
    sim = pkg.simulator.ClusterSimulator(
        cfg, sched, num_instances=2, instances_per_node=2,
        kv_capacity_tokens=192, page_size=16, latency=_latency(pkg, cfg))
    wl = pkg.slo.make_tiny_trace(6, 2, gap=0.0004, short_len=40,
                                 long_len=400, decode=4)
    fin, sub, res = pkg.slo.run_sim_trace(sim, wl, horizon=5.0)
    row = pkg.slo.summarize(fin, sub, slo=0.002, ttft_slo=0.01,
                            duration=res.sim_time)
    return row, _digest(res)


def test_slo_summarize_rows_equal_reference():
    (row, res), (jrow, jres) = _slo_rows(PORT), _slo_rows(JAX)
    assert row == jrow and res == jres
    assert row["outcomes"]["shed"] == 2 and row["outcomes"]["finished"] == 6


def test_hardware_model_is_the_h100_datasheet():
    """The port's defaults: NVIDIA H100 SXM5 80GB at 700 W (dense bf16,
    HBM3, NVLink per direction); the fields without a datasheet value
    keep the reference's."""
    hw, ref = latency.HardwareModel(), jlatency.HardwareModel()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    assert [f.name for f in dataclasses.fields(hw)] == \
        [f.name for f in dataclasses.fields(ref)]
    for name in ("chips_per_instance", "hop_latency", "per_row_overhead",
                 "kernel_base", "inter_link_bw", "inter_hop_latency"):
        assert getattr(hw, name) == getattr(ref, name), name
