"""The client group: the port of ``commefficient_tpu/parallel/mesh.py``'s
1-D ``clients`` mesh (``default_client_mesh``), in PyTorch's idiom of one
process per GPU.

The world comes from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR``/``MASTER_PORT`` reach
``init_process_group`` through its ``env://`` default) or from the
caller. A rank's device is ``cuda:LOCAL_RANK``; the backend is ``nccl``
on the card and ``gloo`` where the caller asks for the CPU. A caller may
name another backend explicitly (a test running ``gloo`` on CUDA
tensors); nothing picks one at run time, and a process group that fails
to start raises.

The client group's size follows the JAX package's policy:
``min(--num_devices, world)`` (``-1``: the world), reduced to the largest
divisor of ``num_workers`` so the round's W slots split evenly. Ranks past
the group's size are idle (``ClientGroup.active`` is False), as the
devices past the JAX mesh are. A world of 1 keeps the process-group path
live, as the JAX package's 1-device mesh does.

Rank ``i`` of the group runs slots ``[i * W/n, (i + 1) * W/n)`` of every
round (``ClientGroup.slots``).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ClientGroup:
    """A process group over which the round's client slots are split.
    ``group`` is the torch process group (None: the default group),
    ``rank``/``size`` this process's position in it, ``device`` its
    device. ``active`` is False on a rank outside the group."""

    group: Any
    rank: int
    size: int
    device: torch.device
    active: bool = True

    def slots(self, W: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a round's ``W`` slots."""
        assert W % self.size == 0, (W, self.size)
        per = W // self.size
        return self.rank * per, (self.rank + 1) * per

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def world_from_env() -> Optional[Tuple[int, int, int]]:
    """``(rank, world_size, local_rank)`` from ``torchrun``'s environment,
    or None when ``WORLD_SIZE`` is unset."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rank))
    return rank, world, local


def init_distributed(device_type: str = "cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None) -> torch.device:
    """Start the default process group and return this rank's device.
    Missing ``rank``/``world_size``/``local_rank`` come from
    ``world_from_env``. ``backend`` defaults to ``nccl`` for ``cuda`` and
    ``gloo`` for ``cpu``. Any failure raises."""
    env = world_from_env()
    if rank is None or world_size is None:
        if env is None:
            raise RuntimeError(
                "init_distributed needs rank and world_size, or torchrun's "
                "RANK / WORLD_SIZE / LOCAL_RANK environment")
        rank = env[0] if rank is None else rank
        world_size = env[1] if world_size is None else world_size
        if local_rank is None:
            local_rank = env[2]
    if local_rank is None:
        local_rank = rank
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA requested but "
                               "torch.cuda.is_available() is False")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device type {device_type!r}")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return device


def destroy_distributed() -> None:
    """Tear the default process group down, if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def client_group_size(num_workers: int, num_devices: int, world: int) -> int:
    """The JAX package's clients-axis policy: ``min(num_devices, world)``
    (``num_devices <= 0``: the world), reduced to the largest divisor of
    ``num_workers``; a warning when it differs from an explicit
    request."""
    requested = num_devices if num_devices and num_devices > 0 else world
    n = max(1, min(requested, world))
    while num_workers % n:
        n -= 1
    if 0 < num_devices != n:
        warnings.warn(f"--num_devices {num_devices} reduced to {n} (must "
                      f"divide num_workers={num_workers}; world of "
                      f"{world})", stacklevel=2)
    return n


def make_client_group(num_workers: int, num_devices: int = -1,
                      device: Optional[torch.device] = None
                      ) -> Optional[ClientGroup]:
    """The client group of a running process group (None when none is
    initialized: the single-device round). Every rank must call it: a
    group smaller than the world is a new subgroup of the first ``n``
    ranks, and the other ranks get ``active=False``."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    rank = dist.get_rank()
    n = client_group_size(num_workers, num_devices, world)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return ClientGroup(group, rank, n, device, active=False)
    return ClientGroup(group, rank, n, device)


def start_client_group(args, init_method: Optional[str] = None
                       ) -> Optional[ClientGroup]:
    """An entry point's group: under ``torchrun`` (``WORLD_SIZE`` set) the
    process group on ``args.device`` (``cuda:LOCAL_RANK`` with NCCL, or
    gloo on the CPU; ``init_method`` defaults to ``env://``) and its
    client group; else None (one device)."""
    if world_from_env() is None:
        return None
    device = init_distributed(args.device, init_method=init_method)
    return make_client_group(args.num_workers, args.num_devices, device)


def main_first(fn, group: Optional[ClientGroup] = None):
    """Run ``fn`` on rank 0 before the other ranks run it (a dataset that
    writes its synthetic files on first use); without a process group,
    just ``fn()``."""
    if not (dist.is_available() and dist.is_initialized()):
        return fn()
    if dist.get_rank() == 0:
        out = fn()
        dist.barrier()
        return out
    dist.barrier()
    return fn()


def quiet_unless_main() -> None:
    """Only rank 0 of a process group prints: the others' standard output
    goes to ``os.devnull``."""
    import sys

    if dist.is_available() and dist.is_initialized() \
            and dist.get_rank() != 0:
        sys.stdout = open(os.devnull, "w")
