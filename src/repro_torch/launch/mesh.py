"""Production mesh construction and its elastic re-derivation (port of
`repro.launch.mesh`).

`make_production_mesh` is a function: importing this module touches no
device.  Single pod: 16 x 16 = 256 devices; multi-pod: 2 x 16 x 16 = 512.
The mesh is the port's single-process one (`distributed/sharding.py`):
entries may repeat a device.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed.sharding import (Mesh, make_mesh_compat,
                                              visible_devices)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, devices)


def mesh_from_devices(devices=None, model_parallel: int = 0) -> Mesh:
    """Elastic mesh: factor whatever devices are alive (default every
    visible card) into (data, model), the model axis the largest power of
    two <= sqrt(n) that divides n.  Used on restart after a device is
    lost: checkpoints are topology-agnostic, so training resumes on the
    survivors."""
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    if not n:
        raise ValueError("mesh_from_devices: no devices (no visible card; "
                         "pass the devices, e.g. [torch.device('cpu')])")
    if model_parallel <= 0:
        m = 1
        while m * 2 <= n and n % (m * 2) == 0 and (m * 2) ** 2 <= n:
            m *= 2
        model_parallel = m
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into a model axis of "
                         f"{model_parallel}")
    return Mesh(devices, ("data", "model"),
                shape=(n // model_parallel, model_parallel))


def mesh_axis_size(mesh: Optional[Mesh], name: str) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(name, 1)
