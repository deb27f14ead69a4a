"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py``: a function, not a module
constant, so importing this module touches no process group.

:func:`make_production_mesh` builds the reference's meshes as a
``DeviceMesh``: (16, 16) ``("data", "model")`` for one pod, (2, 16, 16)
``("pod", "data", "model")`` for two.  For the dry run
(``launch/dryrun.py``) it runs on a ``"fake"`` process group
(``torch.testing._internal.distributed.fake_pg.FakeStore``) of 256 or 512
ranks in one process: this process is rank 0, and a collective moves no
data.  ``backend="nccl"`` or ``"gloo"`` builds the same mesh on a default
group the caller has initialised with that many ranks.

The reference's ``TPU_PERF_FLAGS`` (XLA's async collective fusion and
overlap flags) have no counterpart: they are flags of the TPU compiler,
and no NCCL setting stands in for them here.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fake_mesh", "make_production_mesh", "mesh_desc", "mesh_shape"]


def mesh_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _fake_group(world: int) -> None:
    """This process as rank 0 of a fake default group of ``world`` ranks
    (an existing fake group of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a fake mesh needs the default group to be "
                               f"fake, not {dist.get_backend()!r}")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake default
    group of as many ranks, this process rank 0."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    _fake_group(n)
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, backend: str = "fake"):
    """(16, 16) data x model for one pod; (2, 16, 16) pod x data x model
    for two.  ``backend="fake"`` (the dry run) makes the default group a
    fake one of that many ranks; any other backend needs a default group
    of that many ranks already."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = mesh_shape(multi_pod)
    if backend == "fake":
        return fake_mesh(shape, axes)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"need a default {backend} group of {n} ranks "
                           f"for mesh {shape}")
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def mesh_desc(mesh) -> str:
    """The reference's description, e.g. ``"data:16xmodel:16"``."""
    return "x".join(f"{n}:{s}" for n, s in
                    zip(mesh.mesh_dim_names, mesh.mesh.shape))
