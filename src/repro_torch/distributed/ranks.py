"""One process a shard: the rendezvous, the ``("shard",)`` mesh and the
launcher of the sharded plane's multi-process rendering.

The reference runs its mesh path as one program over a ``("shard",)``
device mesh (``jax.make_mesh((S,), ("shard",))``).  The port runs one
process a shard over ``torch.distributed``, SPMD: every rank calls the
same API with the same host arguments, as the reference's single program
replicates its host decisions.

* ``init_shard_mesh`` joins a rank to its process group at a ``FileStore``
  rendezvous (no port to collide with) under a collective timeout, and
  returns the 1-D mesh over all ranks.  NCCL runs one rank a card; gloo
  carries CPU tensors, and the CUDA tensors of several ranks that share
  one card (``collectives`` stages what gloo cannot carry).
* ``RankGroup`` starts the ranks with ``torch.multiprocessing``'s
  ``spawn`` method (a parent that has initialised CUDA cannot ``fork``)
  and waits for them under a deadline: a rank that fails ends the others,
  and a group that outlives the deadline is killed, and either raises, so
  a diverging rank cannot hang its caller.
"""
from __future__ import annotations

import datetime
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from ..core.device import resolve_device

SHARD_AXIS = "shard"
#: the collective timeout of a rank's process group, seconds
GROUP_TIMEOUT_S = 120
#: how long the ranks of a failed group get to exit on SIGTERM, seconds
KILL_GRACE_S = 5


def init_shard_mesh(rank: int, world: int, *, init_file: str,
                    backend: str = "nccl", device="cuda"):
    """Join ``rank`` of ``world`` to the default process group (``backend``
    at the ``FileStore`` ``init_file``, every collective bounded by
    ``GROUP_TIMEOUT_S``) and return the ``("shard",)`` ``DeviceMesh`` over
    all ranks.  ``device`` (``cuda`` unless the caller passes ``"cpu"``, or a
    card such as ``"cuda:1"``) becomes the rank's current device; the
    mesh's device type is its type."""
    dev = resolve_device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; expected 'nccl' "
                         "or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL carries CUDA tensors only; use gloo for "
                         "ranks on the CPU")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    store = dist.FileStore(init_file, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return DeviceMesh(dev.type, torch.arange(world),
                      mesh_dim_names=(SHARD_AXIS,))


def close_shard_mesh() -> None:
    """Leave the default process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


class RankGroup:
    """``world`` processes running ``fn(rank, world, *args)``, started by
    ``torch.multiprocessing.start_processes`` with the ``spawn`` method.
    ``fn`` must be importable (a module's top-level function) and its
    arguments picklable."""

    def __init__(self, fn: Callable, world: int, args: Sequence = (), *,
                 deadline_s: float):
        self.deadline = time.monotonic() + float(deadline_s)
        self.ctx = mp.start_processes(fn, (world,) + tuple(args),
                                      nprocs=world, join=False, daemon=True,
                                      start_method="spawn")
        self.procs = self.ctx.processes

    def wait(self) -> None:
        """Return when every rank has exited 0.  A rank that exits with
        another code ends the others; a deadline passed with ranks still
        running kills them; either raises ``RuntimeError``."""
        try:
            while not self.ctx.join(
                    timeout=max(0.0, self.deadline - time.monotonic()),
                    grace_period=KILL_GRACE_S):
                if time.monotonic() >= self.deadline:
                    alive = [r for r, p in enumerate(self.procs)
                             if p.is_alive()]
                    raise RuntimeError(f"ranks {alive} still running at "
                                       "the group's deadline: killed")
        except (mp.ProcessRaisedException,
                mp.ProcessExitedException) as e:
            raise RuntimeError(f"rank {e.error_index} failed: {e}") from None
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
            for p in self.procs:
                p.join(10)


__all__ = ["SHARD_AXIS", "GROUP_TIMEOUT_S", "init_shard_mesh",
           "close_shard_mesh", "RankGroup"]
