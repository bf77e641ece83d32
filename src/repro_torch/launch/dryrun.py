"""Dry run: build every (arch x shape x mesh) cell and run its step once on
the ``meta`` device (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for the production meshes
without hardware, and records XLA's memory and cost analyses and the
HLO.  The port's counterpart of that abstract evaluation is a run on
``meta`` tensors: every op computes its output's shape and dtype and
nothing else, so a cell proves that its step composes at full width and
full depth, and gives its output tree.  Per cell it records ``ok``,
``kind``, ``meta``, ``build_s``, ``run_s``, the output shape and dtype
tree, ``argument_bytes`` (total, and per device from the specs for the
train and prefill cells) and ``cost.flops`` (``FlopCounterMode`` over the
run).  There is no HLO and no temporary-memory figure: nothing is
compiled, and meta tensors have no allocator.  Every op's outputs are
checked to stay on ``meta`` (a tensor with elements made elsewhere fails
the cell).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape decode_32k --multi-pod both --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ASSIGNED, applicable_shapes, get_config

NOT_MEASURED = ("no HLO and no temporary-memory figure: nothing is compiled "
                "and meta tensors have no allocator")


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _stand_in(a):
    """A one-value CPU tensor of ``a``'s dtype (0-d for a 0-d tensor, so
    type promotion sees the same dimensionality class)."""
    if isinstance(a, torch.Tensor):
        return torch.ones((1,) * min(a.dim(), 1), dtype=a.dtype)
    if isinstance(a, (list, tuple)):
        return type(a)(_stand_in(x) for x in a)
    return a


def _sig(a):
    """What a pointwise op's result dtype depends on in ``a``: a tensor's
    dtype and whether it has dims, a Python number's kind, else the value
    (a dtype, a rounding mode)."""
    if isinstance(a, torch.Tensor):
        return a.dtype, a.dim() > 0
    if isinstance(a, (list, tuple)):
        return tuple(_sig(x) for x in a)
    if isinstance(a, (bool, int, float, complex)):
        return type(a)
    return a


def _broadcast(shapes):
    """The broadcast of integer shapes, or None where they do not."""
    n = max(len(s) for s in shapes)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    return None
                out[i] = d
    return tuple(out)


# pointwise ops that torch does not tag so
_UNTAGGED_POINTWISE = frozenset({torch.ops.aten.floor_divide.default,
                                 torch.ops.aten.floor_divide.Scalar})


class MetaRun(TorchDispatchMode):
    """The dry run's dispatch mode.

    It fails any op whose tensor output with elements is not on ``meta``,
    and counts the flops of the ops in ``torch.utils.flop_counter``'s
    registry (matrix products, convolutions, attention), as
    ``FlopCounterMode`` does.  It also shortens pointwise ops: torch
    computes a meta tensor's pointwise result through Python reference
    implementations (about 0.2-1.7 ms an op, so
    a 60-layer step of ~50,000 such ops would take minutes); here the
    output's shape is the broadcast of the inputs' shapes and its dtype
    that of the same op on one-value CPU stand-ins (kept per op and
    argument kinds), and in-place ops return their target.  Ops with an
    ``out`` argument, several outputs, or a stand-in that raises take
    torch's own meta path."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._dtypes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._pointwise(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        for t in _tensors(out):
            # a tensor of no elements holds no value (torch's checkpoint
            # makes one on the host as an autograd anchor)
            if t.device.type != "meta" and t.numel():
                raise RuntimeError(f"dry run: {func} made a tensor on "
                                   f"{t.device}")
        return out

    def _pointwise(self, func, args, kwargs):
        if ((torch.Tag.pointwise not in func.tags
             and func not in _UNTAGGED_POINTWISE) or "out" in kwargs
                or len(func._schema.returns) != 1):
            return None
        ts = [a for a in _tensors((args, kwargs))]
        if not ts or any(t.device.type != "meta" for t in ts):
            return None
        if func._schema.is_mutable:          # in place: the target's shape
            return args[0]
        shape = _broadcast([tuple(t.shape) for t in ts])
        key = (func, _sig(args), tuple((k, _sig(v)) for k, v in
                                       kwargs.items()))
        try:
            dtype = self._dtypes.get(key)
        except TypeError:                    # an argument that cannot key
            key, dtype = None, None
        if dtype is None:
            try:
                r = func(*_stand_in(args), **_stand_in(kwargs))
            except Exception:  # noqa: BLE001 — torch's meta path decides
                return None
            if not isinstance(r, torch.Tensor):
                return None
            dtype = r.dtype
            if key is not None:
                self._dtypes[key] = dtype
        if shape is None:
            return None
        return torch.empty(shape, dtype=dtype, device="meta")


def run_meta(fn, args):
    """``fn(*args)`` on meta tensors under ``MetaRun``: (outputs, flops)."""
    with MetaRun() as mode:
        out = fn(*args)
    return out, mode.flops


def shape_tree(tree):
    """Outputs as nested lists/dicts of [shape, dtype name] leaves."""
    if isinstance(tree, dict):
        return {str(k): shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shape_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return [list(tree.shape), str(tree.dtype).replace("torch.", "")]
    return tree


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, **kw) -> dict:
    from . import sharding
    from .cells import build_cell
    from .mesh import make_production_mesh
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "ok": False}
    t0 = time.perf_counter()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        cell = build_cell(arch, shape_name, mesh, multi_pod=multi_pod, **kw)
        t1 = time.perf_counter()
        out, flops = run_meta(cell.fn, cell.args)
        t2 = time.perf_counter()
        meta = {k: v for k, v in cell.meta.items() if k != "specs"}
        arg_bytes = {"total": _bytes(cell.args)}
        if "specs" in cell.meta:
            arg_bytes["per_device"] = sum(
                sharding.per_device_bytes(mesh, s, a)
                for s, a in zip(cell.meta["specs"], cell.args))
        rec.update(ok=True, kind=cell.kind, meta=meta,
                   build_s=round(t1 - t0, 3), run_s=round(t2 - t1, 3),
                   outputs=shape_tree(out), argument_bytes=arg_bytes,
                   cost={"flops": float(flops)},
                   not_measured=NOT_MEASURED)
    except Exception as e:  # noqa: BLE001 — the dry run reports per cell
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.perf_counter() - t0, 3)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None,
                    help="arch ids (default: all assigned)")
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--multi-pod", choices=("no", "yes", "both"), default="no")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = args.arch or ASSIGNED
    pods = {"no": [False], "yes": [True],
            "both": [False, True]}[args.multi_pod]
    results = []
    for arch in archs:
        cfg = get_config(arch)
        for shape in args.shape or applicable_shapes(cfg):
            for mp in pods:
                print(f"=== {arch} x {shape} x "
                      f"{'2x16x16' if mp else '16x16'}", flush=True)
                rec = run_cell(arch, shape, multi_pod=mp)
                status = "OK" if rec["ok"] else f"FAIL ({rec.get('error')})"
                extra = ""
                if rec["ok"]:
                    gib = rec["argument_bytes"]["total"] / 2**30
                    extra = (f" args={gib:.2f}GiB build={rec['build_s']}s "
                             f"run={rec['run_s']}s")
                print(f"    {status}{extra}", flush=True)
                results.append(rec)
                with open(os.path.join(args.out, "dryrun.json"), "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells passed")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
