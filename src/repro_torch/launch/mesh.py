"""Production mesh builders, from ``repro.launch.mesh``.

``make_production_mesh`` builds the reference's shapes, 16 x 16
``("data", "model")`` (one pod of 256 devices) or 2 x 16 x 16
``("pod", "data", "model")`` (512), as a ``DeviceMesh`` over a fake
process group of that many ranks (``FakeStore``, backend ``"fake"``): this
process is rank 0 of a world that exists only on paper, its collectives
return at once, and the dry run traces on it under ``FakeTensorMode``.
Its device type is ``"cuda"`` where PyTorch has CUDA, else ``"cpu"``
(fake CUDA tensors need a CUDA build); no device memory is touched, since
every tensor the dry run puts on it is fake.  On a ``"cpu"`` mesh DTensor
would replace an all-to-all by an all-gather and a chunk; the dry run asks
for the all-to-all a CUDA mesh runs (``launch.dryrun``).

Importing this module touches no device and no process group: meshes are
built by functions, and ``production_mesh`` is a context that creates the
fake default group and destroys it on exit, so no group outlives its
caller.  ``make_debug_mesh`` builds a mesh over the devices that exist in
an already initialised default group.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def _shape(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def _device_type() -> str:
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 devices a pod; 2 pods = 512, multi-pod.  Starts the
    fake default process group of that size when none is running (the
    caller ends it: ``dist.destroy_process_group()``, or use
    ``production_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = _shape(multi_pod)
    world = 1
    for s in shape:
        world *= s
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if dist.get_world_size() != world:
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks is running; the mesh needs {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False):
    """``make_production_mesh`` on a fake group of its own, destroyed on
    exit (an exception's included)."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is running already; "
                           "the production mesh needs a fake one of its "
                           "own")
    try:
        yield make_production_mesh(multi_pod=multi_pod)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def make_debug_mesh(n_devices: int | None = None):
    """A ``(n, 1)`` ``("data", "model")`` mesh over the ranks of the
    running default group (all of them by default), on the card when
    there is one, else on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs a default process group "
                           "(torch.distributed.init_process_group)")
    n = n_devices or dist.get_world_size()
    return init_device_mesh("cuda" if torch.cuda.is_available() else "cpu",
                            (n, 1), mesh_dim_names=("data", "model"))
