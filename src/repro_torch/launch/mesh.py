"""The production mesh as a layout record (port of ``repro/launch/mesh.py``).

The JAX package builds a device mesh: single pod 16x16 = 256 chips over
(`data`, `model`); multi-pod 2x16x16 = 512 chips with a leading `pod`
axis.  The port runs one process on one card and keeps the (instance, tp)
mesh virtual (``core/dcp.py``), so a mesh here holds no devices and opens
no communicator: it records the axes and their sizes, which the cell
builders and the sharding rules read (``mesh.shape["model"]``,
``mesh.shape.get("pod", 1)``), and the log of the activation constraints
that the ``shard`` hook of ``launch/sharding.py`` would place on it.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Mesh:
    axis_names: tuple
    sizes: tuple
    # (name, shape, spec) per constraint the ``shard`` hook would place
    log: list = field(default_factory=list)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape: tuple, axes: tuple) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod (`data` 16, `model` 16), or two pods with a leading
    `pod` axis (each pod an independent serving group or data-parallel
    training replica)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(data: int = 4, model: int = 2, *, pod: int = 0) -> Mesh:
    """A small mesh for tests and examples."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))
