"""Production meshes (port of `repro.launch.mesh`), as `DeviceMesh`es.

The single-pod mesh is 16x16 = 256 ranks ("data", "model"); the
multi-pod mesh is 2x16x16 = 512 ranks ("pod", "data", "model").

Fabric mapping: one wafer-scale W-group hosts a pod; the "model" axis
rides the on-wafer C-group meshes, "data" the intra-W-group local links,
"pod" the global links of the switch-less Dragonfly.

Both functions need an initialised `torch.distributed` process group
whose world size is the mesh's size (the dry-run makes a `fake` group of
256 or 512 ranks in one process; the tests pass ``device_type="cpu"``
over `gloo` ranks).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or with `multi_pod` (2, 16, 16) ("pod",
    "data", "model"), over the process group's 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int | None = None, device_type: str = "cuda"):
    """A small ("data", "model") mesh over every rank of the process group:
    `model` ranks on the model axis (default 2 when the world size is even
    and above 1, else 1), the rest on data."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = model or (2 if n % 2 == 0 and n > 1 else 1)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
