"""Production mesh builders (port of `repro.launch.mesh`; functions only
— importing this module touches no device and no process group).

Single pod: 16 x 16 = 256 devices ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 devices ("pod", "data", "model") — the
"pod" axis carries extra data parallelism (per-pod FSDP groups; only
the gradient all-reduce crosses pods in training, nothing in serving).

`mesh_axes`, `batch_axes` and `axis_size` take a torch `DeviceMesh`
(`mesh_dim_names`, `size(i)`) or a structural mesh (`axis_names`, a
`shape` mapping) alike; the sharding rules read meshes through
`mesh_axes`.
"""
from __future__ import annotations

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """The production `DeviceMesh` of CUDA devices through
    `init_device_mesh`: needs an initialised process group of 256 (512
    with `multi_pod`) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_SHAPES[multi_pod]
    return init_device_mesh("cuda", shape, mesh_dim_names=names)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a structural mesh or a torch DeviceMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: mesh.shape[n] for n in mesh.axis_names}


def batch_axes(mesh) -> tuple:
    """Axis names over which the global batch is sharded."""
    return tuple(n for n in mesh_axes(mesh) if n in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)
