"""Production mesh construction.

The counterpart of ``repro/launch/mesh.py``.  A mesh here is abstract: its
axis names, their sizes and the devices it covers (``None`` for the
production meshes, which no machine of the port has).  Single pod: 16x16 =
256 chips (data, model); multi-pod: 2x16x16 = 512 chips (pod, data,
model).  The dry-run stand-in (`launch.dryrun`) sizes every leaf per device
against them; `parallel.pipeline_par` reads its stage count from one.  No
``torch.distributed`` process group is made: one card still shards
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.engine import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """``shape``: axis name -> size, in the order of ``axis_names``;
    ``devices``: the devices it covers (a list), or None."""

    shape: dict
    axis_names: tuple
    devices: list | None = None

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_mesh(axis_shapes, axis_names, *, devices=None) -> Mesh:
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} sizes for {len(axis_names)} "
                         f"axes")
    mesh = Mesh(dict(zip(axis_names, axis_shapes)), tuple(axis_names),
                None if devices is None else list(devices))
    if devices is not None and len(mesh.devices) != mesh.size:
        raise ValueError(f"a {tuple(axis_shapes)} mesh takes {mesh.size} "
                         f"devices, got {len(mesh.devices)}")
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1, device=None) -> Mesh:
    """Whatever-is-available mesh for local smoke runs: the card's devices
    (``torch.cuda.device_count()``; raises without a card), or the CPU for
    ``device="cpu"``."""
    dev = resolve_device("cuda" if device is None else device)
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())] \
        if dev.type == "cuda" else [dev]
    n = len(devices)
    model = min(model, n)
    return make_mesh((n // model, model), ("data", "model"),
                     devices=devices[:n // model * model])
