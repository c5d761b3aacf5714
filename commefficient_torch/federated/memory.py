"""Per-client state memory accounting and the placement tier: the port of
``commefficient_tpu/federated/memory.py``.

Per-client persistent state is the system's main memory cost (the
reference keeps it in host shared memory, fed_aggregator.py:105-129):
velocity and error arrays of ``(num_clients, d)`` rows in the dense modes
or ``(num_clients, r, c_pad)`` tables in sketch mode, plus ``(num_clients,
d)`` stale weights under ``--topk_down``. At ResNet9's width a sketch-mode
row of the published 5 x 500,096 table is 10,001,920 B, so the EMNIST
population (3,500 clients) with local momentum and local error holds
70,013,440,000 B (65.21 GiB) and 10^5 clients 2.0 TB.

``plan_client_state_memory`` accounts for every array the config
allocates (the conditions of ``rounds.init_client_states``) and picks the
tier, as the JAX package does:

  hbm   the state fits the device budget: tensors on the model's device;
  host  it does not, but the total fits the host RAM budget: CPU float32
        tensors, W rows streamed to the card around the round
        (``host_state.RowStreamer``);
  disk  the total busts host RAM too: the sparse row files of
        ``host_state.MemmapRowStore``, W rows a round.

The device budget is 50% of ``torch.cuda.mem_get_info()``'s total for the
model's device (the JAX package's 8 GiB default on the CPU); the RAM
budget 50% of physical memory (``sysconf``; 16 GiB when it cannot say).
Both probes run once per process; the JAX package's overrides
``COMMEFFICIENT_STATE_HBM_BUDGET`` and ``COMMEFFICIENT_STATE_HOST_BUDGET``
are read per call, so a test forces any tier at any size.

One deliberate difference from the JAX package: its client rows are
sharded over the ``clients`` mesh axis, so its ``per_device_bytes`` is the
total divided by the shard count. The port replicates every client row on
every rank of a client group (``rounds.client_step`` all-gathers the new
rows), so its ``num_shards`` is always 1 and ``per_device_bytes`` is the
total. In place of the JAX package's ``client_state_sharding`` the tier
names the rows' placement (``state_device``): the model's device, the
CPU, or no tensor at all for ``disk``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["ClientStateMemoryPlan", "plan_client_state_memory",
           "state_device"]

_F32 = 4


@dataclass(frozen=True)
class ClientStateMemoryPlan:
    """Byte accounting + placement decision for ClientStates arrays."""

    velocity_bytes: int
    error_bytes: int
    stale_weight_bytes: int
    total_bytes: int
    num_shards: int
    per_device_bytes: int
    placement: str  # "hbm" | "host" | "disk"
    row_bytes: int = 0  # bytes of ONE client's row in one state array

    def summary(self) -> str:
        gb = 1024 ** 3
        return (f"client state: {self.total_bytes / gb:.2f} GiB total "
                f"({self.velocity_bytes / gb:.2f} vel + "
                f"{self.error_bytes / gb:.2f} err + "
                f"{self.stale_weight_bytes / gb:.2f} stale), "
                f"{self.per_device_bytes / gb:.2f} GiB/device over "
                f"{self.num_shards} shard(s) → {self.placement}")


def _state_row_bytes(grad_size: int, wcfg, sketch) -> int:
    if wcfg.mode == "sketch" and sketch is not None:
        r, c_pad = sketch.table_shape
        return r * c_pad * _F32
    return grad_size * _F32


# the probes are calls into the CUDA runtime and libc: once per process
_PROBE_CACHE: dict = {}


def _device_hbm_budget(device=None) -> int:
    """50% of the total memory of ``device`` (a CUDA device) from
    ``torch.cuda.mem_get_info``; 8 GiB for the CPU. Probed once per
    process and device."""
    dev = torch.device(device if device is not None else "cpu")
    key = ("hbm", str(dev))
    if key not in _PROBE_CACHE:
        budget = None
        if dev.type == "cuda" and torch.cuda.is_available():
            _free, total = torch.cuda.mem_get_info(dev)
            budget = int(total) // 2
        _PROBE_CACHE[key] = budget if budget else 8 * 1024 ** 3
    return _PROBE_CACHE[key]


def _host_ram_budget() -> int:
    """50% of physical host RAM (16 GiB when sysconf can't say). Probed
    once per process."""
    if "ram" not in _PROBE_CACHE:
        budget = None
        try:
            budget = (os.sysconf("SC_PAGE_SIZE")
                      * os.sysconf("SC_PHYS_PAGES")) // 2
        except (ValueError, OSError, AttributeError):
            budget = None
        _PROBE_CACHE["ram"] = budget if budget else 16 * 1024 ** 3
    return _PROBE_CACHE["ram"]


def plan_client_state_memory(
    num_clients: int,
    grad_size: int,
    wcfg,
    sketch=None,
    device=None,
    hbm_budget_bytes: Optional[int] = None,
    host_budget_bytes: Optional[int] = None,
) -> ClientStateMemoryPlan:
    """Account for every ClientStates array this config allocates and
    decide the tier (module docstring). ``device`` is the model's device
    (its memory is the device budget's probe); the budgets default to the
    probes, and the two environment overrides win over both."""
    row = _state_row_bytes(grad_size, wcfg, sketch)
    vel = num_clients * row if wcfg.has_velocity else 0
    err = num_clients * row if wcfg.has_error else 0
    stale = num_clients * grad_size * _F32 if wcfg.do_topk_down else 0
    total = vel + err + stale
    # rows are replicated on every rank: one shard holds them all
    n_shards = 1
    per_device = total

    if hbm_budget_bytes is None:
        env = os.environ.get("COMMEFFICIENT_STATE_HBM_BUDGET")
        hbm_budget_bytes = int(env) if env else _device_hbm_budget(device)
    if host_budget_bytes is None:
        env = os.environ.get("COMMEFFICIENT_STATE_HOST_BUDGET")
        host_budget_bytes = int(env) if env else _host_ram_budget()

    if per_device <= hbm_budget_bytes:
        placement = "hbm"
    elif total <= host_budget_bytes:
        placement = "host"
    else:
        placement = "disk"
    return ClientStateMemoryPlan(
        velocity_bytes=vel, error_bytes=err, stale_weight_bytes=stale,
        total_bytes=total, num_shards=n_shards,
        per_device_bytes=per_device, placement=placement, row_bytes=row)


def state_device(plan: ClientStateMemoryPlan, device):
    """Where the tier keeps the rows: the model's ``device`` (``hbm``),
    the CPU (``host``), or None (``disk``: no tensor, the row files)."""
    if plan.placement == "hbm":
        return torch.device(device)
    if plan.placement == "host":
        return torch.device("cpu")
    return None
