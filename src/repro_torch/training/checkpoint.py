"""Fault-tolerant checkpointing: atomic, async, restorable onto any device
(port of ``repro/training/checkpoint.py``, in its on-disk format).

Layout:  <dir>/step_<N>/
            manifest.json        (tree structure, shapes, dtypes, step)
            leaf_<i>.npy         (one file per leaf, in JAX's flatten order:
                                  dict keys sorted, lists in order)
         <dir>/LATEST            (atomic pointer file)

Writes are atomic (tmp dir + rename), so a crash mid-write never corrupts
the latest checkpoint; ``AsyncCheckpointer`` moves serialization off the
training thread.  bfloat16 and fp8 leaves are stored as their raw bits
(uint16 / uint8) under the reference's logical dtype names, so a
checkpoint written by either package restores into the other bit for bit
(without ``ml_dtypes``, which the port does not use).
"""
from __future__ import annotations

import json
import os
import queue as queue_mod
import shutil
import threading

import numpy as np
import torch

from .. import resolve_device
from .tree import leaves, map_tree, treedef_str, unflatten

# torch dtypes that numpy lacks: (logical name, torch and numpy integer
# types of the same width to move the bits through, the stored type)
_RAW = {torch.bfloat16: ("bfloat16", torch.int16, np.int16, np.uint16),
        torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8, np.uint8),
        torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8, np.uint8)}
_BY_NAME = {raw[0]: (dt, raw[2]) for dt, raw in _RAW.items()}


def _host(leaf) -> tuple[np.ndarray, str]:
    """(array to write, logical dtype name) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _RAW:
            name, same, _, stored = _RAW[t.dtype]
            return t.view(same).numpy().view(stored), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree) -> str:
    """Blocking atomic save.  Returns the checkpoint path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": treedef_str(tree), "leaves": []}
    for i, leaf in enumerate(leaves(tree)):
        arr, logical = _host(leaf)
        name = f"leaf_{i:05d}"
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append({"name": name, "shape": list(arr.shape),
                                   "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    return int(name.split("_")[1])


def restore(ckpt_dir: str, like, device="cuda"):
    """Restore the latest step into the structure of ``like`` (a tree of
    tensors), as new tensors on ``device`` in each ``like`` leaf's dtype."""
    dev = resolve_device(device)
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = leaves(like)
    if len(manifest["leaves"]) != len(flat):
        raise ValueError(f"{path} holds {len(manifest['leaves'])} leaves, "
                         f"the tree {len(flat)}")
    out = []
    for entry, leaf in zip(manifest["leaves"], flat):
        arr = np.load(os.path.join(path, entry["name"] + ".npy"))
        if entry["dtype"] in _BY_NAME:               # raw-bits roundtrip
            dt, same = _BY_NAME[entry["dtype"]]
            t = torch.from_numpy(arr.view(same)).view(dt)
        else:
            t = torch.from_numpy(arr)
        if isinstance(leaf, torch.Tensor) and t.dtype != leaf.dtype:
            t = t.to(leaf.dtype)
        out.append(t.to(dev))
    return unflatten(like, out)


class AsyncCheckpointer:
    """Background-thread checkpoint writer (training never blocks on I/O).

    ``submit`` copies the tree to the host synchronously (a copy the
    writer owns, so training may go on changing the tensors) and queues
    it; the worker does the file I/O.  ``wait()`` drains the queue; at most
    one write is in flight -- a newer snapshot submitted while writing
    replaces the queued one."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=1)
        self._err = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree = item
            try:
                save(self.ckpt_dir, step, host_tree)
            except Exception as e:          # surfaced on next submit/wait
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree) -> None:
        if self._err:
            raise self._err
        host = map_tree(lambda t: t.detach().to("cpu", copy=True)
                        if isinstance(t, torch.Tensor) else np.array(t), tree)
        try:                                 # drop a stale queued snapshot
            self._q.get_nowait()
            self._q.task_done()
        except queue_mod.Empty:
            pass
        self._q.put((step, host))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._t.join(timeout=10)
