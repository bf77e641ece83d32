"""One run of a cell: set-up, the open loop that drives
``NanoCPEngine.add_request`` and ``NanoCPEngine.step``, the stamps of every
token, and what the reference is handed afterwards.

The engine's clock is the harness's: every ``add_request`` and ``step``
gets ``now`` from ``time.perf_counter``, and a request is added with its
due time as ``now``, however late the generator got to it.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from collections import deque

import numpy as np

from . import common
from .traffic.generate import Arrival, generate

# the served sample the reference checks: at least SAMPLE_MIN requests and
# the cell's ``sample_tokens`` served tokens, at most SAMPLE_MAX requests
SAMPLE_MIN, SAMPLE_MAX = 6, 64


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Harness:
    def __init__(self, cell: dict, seed: int, seconds: float, *,
                 device: str = "cuda", cfg=None):
        import torch
        self.torch = torch
        self.cell, self.model, self.seed = cell, cell["model"], int(seed)
        self.seconds = seconds
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.cfg = cfg
        self.reqs: dict = {}           # rid -> record
        self.live: set = set()
        self.steps: list = []          # per-step records while recording
        self.spans: list = []          # (start_ns, end_ns, label) likewise
        self.recording = False
        self.lateness: list = []

    # ------------------------------------------------------------------ #
    def setup(self) -> None:
        """Kernels, weights, engine, the sessions' prefill, a primer
        request, and every decode graph the run can meet."""
        common.use_program_path()
        from repro_torch.core.bucketing import CPBuckets
        from repro_torch.serving.engine import NanoCPEngine
        common.load_reference(self.model).set_precision(False)
        t0 = time.perf_counter()
        if self.cuda:
            self.torch.zeros(1, device=self.device)
            from repro_torch.kernels import build
            build.build_all()
        t1 = time.perf_counter()
        if self.cfg is None:
            self.cfg = common.build_model_config(self.model)
        self.params = common.make_weights(self.cfg, self.seed, self.device)
        self._sync()
        t2 = time.perf_counter()
        e = self.cell["engine"]
        self.eng = NanoCPEngine(
            self.cfg, self.params, num_instances=e["num_instances"],
            instances_per_node=e["instances_per_node"], tp=e["tp"],
            page_size=e["page_size"],
            kv_capacity_tokens=e["kv_capacity_tokens"],
            max_slots_per_instance=e["max_slots_per_instance"],
            buckets=CPBuckets(tuple(e["cp_edges"]), tuple(e["cp_degrees"])),
            device=self.device)
        mix = self.cell["mix"]
        self.arrivals = generate(
            mix, rate=self.cell["rate_per_s"], lead_in_s=self.cell["lead_in_s"],
            window_s=self.seconds, drain_s=self.cell["drain_s"],
            vocab=self.model["vocab_size"], seed=self.seed)
        self._sync()
        t3 = time.perf_counter()
        sessions = [a for a in self.arrivals if a.phase == "session"]
        for a in sessions:
            # one at a time: a prefill batch holds each prompt's KV until
            # its scatter
            rid = self.add(a, time.perf_counter())
            while not self.reqs[rid]["stamps"]:
                self.step()
        t4 = time.perf_counter()
        # a primer: every kernel of prefill and decode loaded before capture
        rng = np.random.default_rng([self.seed, 1])
        primer = Arrival(0.0, rng.integers(0, self.model["vocab_size"], 64),
                         4, "primer")
        rid = self.add(primer, time.perf_counter())
        while rid in self.live:
            self.step()
        t5 = time.perf_counter()
        captured = self.capture_family() if self.cuda else 0
        t6 = time.perf_counter()
        log(f"setup: device and kernels {t1 - t0:.2f} s, weights "
            f"{t2 - t1:.2f} s, engine and traffic {t3 - t2:.2f} s, sessions "
            f"{len(sessions)} prefilled {t4 - t3:.2f} s, primer "
            f"{t5 - t4:.2f} s, {captured} graphs captured {t6 - t5:.2f} s")

    def capture_family(self) -> int:
        """Capture, before the window, the decode graph of every bucket the
        run can reach: each M bucket up to the slots, each (S, R) already
        met (with sessions, their routing) and (0, 0), and each page-block
        bucket MB between the longest shard now (with sessions; else the
        smallest) and the longest context any request can reach."""
        from repro_torch.core.routing import _quantize_dim
        eng = self.eng
        e = self.cell["engine"]
        page = e["page_size"]
        aot = eng.aot
        keys = aot.cached_keys()
        mix = self.cell["mix"]
        s = mix.get("sessions")
        longest = max(p for _, p, _ in mix["prompt_intervals"])
        hi = longest + mix["output_tokens"][1]
        lo_mb = 4
        if s:
            lo_mb = max(k[2] for k in keys)
            hi = max(hi, lo_mb * page + s["max_new_tokens"])
        hi_mb = _quantize_dim(math.ceil(hi / page))
        mbs, v = [], 4
        while v <= hi_mb:
            if v >= lo_mb:
                mbs.append(v)
            v = _quantize_dim(v + 1)
        sr = {(k[1], k[4]) for k in keys} | {(0, 0)}
        W = eng.cluster.window
        want = []
        for m in eng.shape_buckets.m_buckets:
            if m > e["max_slots_per_instance"]:
                continue
            for S, R in sr:
                for mb in mbs:
                    want.append(aot.quantise(m, S, mb, W, R))
        new = [k for k in dict.fromkeys(want) if k not in set(keys)]
        self._sync()
        # the prefills' cached blocks back to the device: a graph's private
        # pool cannot reuse them
        self.torch.cuda.empty_cache()
        aot.capture(new)
        self._sync()
        return len(new)

    # ------------------------------------------------------------------ #
    def add(self, a: Arrival, due: float) -> int:
        rid = self.eng.add_request(a.prompt, a.max_new_tokens, now=due)
        self.reqs[rid] = {"phase": a.phase, "due": due, "prompt": a.prompt,
                          "stamps": [], "failed": False, "done": False}
        self.live.add(rid)
        return rid

    def step(self) -> None:
        eng = self.eng
        t0 = time.perf_counter_ns()
        done = eng.step(now=time.perf_counter())
        t = time.perf_counter()
        t1 = time.perf_counter_ns()
        firsts = []
        for rid in list(self.live):
            r = self.reqs[rid]
            n = len(eng.results[rid].tokens)
            have = len(r["stamps"])
            if n > have:
                if have == 0:
                    firsts.append(len(r["prompt"]))
                r["stamps"].extend([t] * (n - have))
        for req in done:
            r = self.reqs.get(req.rid)
            if r is None:
                continue
            res = eng.results[req.rid]
            r["failed"] = bool(res.oom or res.rejected or res.shed
                               or res.recovered is False)
            r["done"] = True
            self.live.discard(req.rid)
        if self.recording:
            tm = dict(eng.timings)
            decode = "dispatch_us" in tm
            bs = (eng.last_batch_sizes.tolist()
                  if decode and eng.last_batch_sizes is not None else [])
            kv = (sum(q.length for q in eng.cluster.active.values())
                  if decode else 0)
            self.steps.append({"timings": tm, "decode": decode,
                               "rows": int(sum(bs)), "kv_tokens": int(kv),
                               "batch_sizes": bs, "prefills": firsts,
                               "t0": t0, "t1": t1})
            self.spans.append((t0, t1, "engine.step with prefill" if firsts
                               else "engine.step"))

    def drive(self, queue: deque, until: float, stop=None) -> None:
        """The open loop up to host time ``until``, or until ``stop()``:
        add every request that is due, step while there is work, idle until
        the next arrival."""
        while True:
            now = time.perf_counter()
            if now >= until or (stop is not None and stop()):
                return
            while queue and queue[0][0] <= now:
                due, a = queue.popleft()
                self.lateness.append(now - due)
                self.add(a, due)
            if self.eng.pending:
                self.step()
            else:
                time.sleep(max(0.0, min(queue[0][0] if queue else until,
                                        until) - now))

    def owed(self, rid: int, tpot_until: float) -> bool:
        """Whether the window still waits on request ``rid``: for its first
        token, or, if it is due before ``tpot_until`` (so in the TPOT
        sample), for its last."""
        r = self.reqs[rid]
        return r["phase"] == "window" and not r["done"] and (
            not r["stamps"] or r["due"] < tpot_until)

    def finish(self, queue: deque, until: float, tpot_until: float) -> None:
        """After the window: drive the open loop on, the drain phase's
        arrivals keeping the load, until every request of the window has its
        first token and every one due before ``tpot_until`` has finished, or
        until host time ``until``.  A request owed then has failed; the
        rest still running are left."""
        waiting = [r for r in self.live if self.owed(r, tpot_until)]

        def stop():
            while waiting and not self.owed(waiting[-1], tpot_until):
                waiting.pop()
            return not waiting
        self.drive(queue, until, stop)
        for r in waiting:
            if self.owed(r, tpot_until):
                self.reqs[r]["failed"] = True

    def schedule(self, w0: float) -> deque:
        """The lead-in's, the window's and the drain's arrivals on the host
        clock, the window starting at ``w0``."""
        return deque(sorted(((w0 + a.due, a) for a in self.arrivals
                             if a.phase != "session"),
                            key=lambda x: x[0]))

    # ------------------------------------------------------------------ #
    def peak_bytes(self) -> int:
        return (self.torch.cuda.max_memory_allocated(self.device)
                if self.cuda else 0)

    def outputs(self, rids: list) -> list:
        return [(self.reqs[r]["prompt"], list(self.eng.results[r].tokens))
                for r in rids]

    def choose_sample(self) -> list:
        """From the seed: the window's finished request with the most
        served tokens and the one with the longest prompt, one session (its
        tokens so far), then others drawn from the seed until the sample
        holds SAMPLE_MIN requests and the cell's ``sample_tokens`` served
        tokens, or SAMPLE_MAX requests."""
        rng = np.random.default_rng([self.seed, 2])
        res = self.eng.results
        done = [r for r, q in self.reqs.items()
                if q["phase"] == "window" and q["done"] and not q["failed"]
                and res[r].tokens]
        if not done:
            return []
        pick = [max(done, key=lambda r: len(res[r].tokens)),
                max(done, key=lambda r: len(self.reqs[r]["prompt"]))]
        sessions = [r for r, q in self.reqs.items() if q["phase"] == "session"]
        if sessions:
            pick.append(int(rng.choice(sessions)))
        rest = [r for r in done if r not in pick]
        rng.shuffle(rest)
        pick = list(dict.fromkeys(pick))
        for r in rest:
            if len(pick) >= SAMPLE_MAX or (
                    len(pick) >= SAMPLE_MIN
                    and sum(len(res[p].tokens) for p in pick)
                    >= self.cell["sample_tokens"]):
                break
            pick.append(r)
        return pick

    def release_engine(self) -> None:
        """Drop the engine (pools, graphs); the weights stay for the
        reference."""
        self.eng.close()
        del self.eng
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()


def check_outputs(model: dict, params: dict, outputs: list, *,
                  router_tie: float, router_flip: float = 0.0,
                  tf32_control: bool = False) -> dict:
    """Run the configuration's reference (``common.load_reference``) over
    each sampled prompt with its served tokens: the widest gap of a served
    token below the reference's best over the positions whose router
    margin is at least ``router_tie`` (each request
    against the reference or its variant with one margin under
    ``router_flip`` routed the other way, whichever fits best), and with
    ``tf32_control`` the control's."""
    reference = common.load_reference(model)
    gap = ctrl = 0.0
    tokens = ties = judged = 0
    worst = None
    for i, (prompt, served) in enumerate(outputs):
        g = reference.gaps(model, params, prompt, served,
                           router_tie=router_tie, router_flip=router_flip,
                           tf32_control=tf32_control)
        judged += g.get("judged", 1)
        if worst is None or g["gap"] > gap:
            worst = dict(g["worst"] or {}, request=i, prompt=len(prompt),
                         served=len(served), gap=g["gap"])
        gap = max(gap, g["gap"])
        if g["control"] is not None:
            ctrl = max(ctrl, g["control"])
        tokens += g["positions"]
        ties += g["ties"]
    return {"max_logit_gap": gap, "control_max_logit_gap": ctrl,
            "requests": len(outputs), "tokens": tokens, "router_ties": ties,
            "reference_passes": judged,
            "worst": worst}
