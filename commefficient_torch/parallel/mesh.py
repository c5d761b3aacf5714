"""The client grid: the port of ``commefficient_tpu/parallel/mesh.py``'s
``clients`` mesh and its 2-D (clients x shard) server plane
(``default_client_mesh``, ``server_reduce_axes``, ``mesh_axis_placement``,
``maybe_init_distributed``), in PyTorch's idiom of one process per GPU.

The world comes from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``;
``MASTER_ADDR``/``MASTER_PORT`` reach ``init_process_group`` through its
``env://`` default), from the JAX package's cohort seam
(``COMMEFFICIENT_NUM_PROCS`` / ``COMMEFFICIENT_PROC_ID`` /
``COMMEFFICIENT_COORDINATOR``: one process a node, the coordinator's
``host:port`` the rendezvous) or from the caller. A rank's device is
``cuda:LOCAL_RANK``; the backend is ``nccl`` on the card and ``gloo``
where the caller asks for the CPU. A caller may name another backend
explicitly (a test running ``gloo`` on CUDA tensors); nothing picks one
at run time, and a process group that fails to start raises.

The grid follows the JAX package's policy (``grid_sizes``; ``grid_axes``
and ``grid_shape`` are its views): the ``model``, ``expert`` and ``seq``
axes are claimed first (below), then the ``shard`` axis
(``--shard_devices``), which must divide ``num_workers``; the
``clients`` axis is ``min(--num_devices, world // (shard x seq x model x
expert))`` (``-1``: all of it), reduced until ``clients x shard`` divides
``num_workers``. Ranks past the grid are idle (``ClientGroup.active`` is
False), as the devices past the JAX mesh are. A world of 1 keeps the
process-group path live, as the JAX package's 1-device mesh does.

Placement. Device ``i`` (torchrun's ``RANK``: node-major across nodes)
sits at ``c = i // n_shard``, ``s = i % n_shard``, so ``clients`` is the
axis that spans nodes, as JAX's leading axis spans hosts. The server
reduces over the ordered tuple ``("shard", "clients")``, whose index is
``p = s * n_clients + c`` (``tuple_index``); rank ``p`` runs slots ``[p *
W/N, (p + 1) * W/N)`` (``ClientGroup.slots``), starts its sketch chunks at
``t0 = p * ceil(T / N)`` and takes tile ``p`` of the server's DP noise.

The process group is started with ``rank = p``: gloo and NCCL associate
an n-rank sum in rank order, and ``new_group`` sorts its ranks, so with
the world numbered by ``p`` the flat tuple collective is the plain world
collective and adds the slots in the order of the 1-D plane (the fp32
2-D round is the 1-D round bit for bit). The axis subgroups come out in
axis order: ``{s * n_clients + c : s}`` (the ``shard`` axis of column
``c``) and ``{s * n_clients + c : c}`` (the ``clients`` axis of row
``s``); every rank creates all of them, in the same order.

The ``seq`` axis (``--seq_parallel ring|ulysses --seq_devices Q``, GPT-2's
sequence parallelism) is the JAX mesh's minor-most axis: device ``i`` sits
at ``q = i % Q`` and ``(c, s)`` as above from ``i // Q``, and its process
rank is ``p * Q + q``. Seq claims its ranks before the shard and clients
axes (JAX's priority), and shrinks with a warning when the world is too
small. The ``Q`` seq ranks of one tuple index ``p`` run the same client
slots and the same server step; the server reduce tuple of seq index
``q`` is ``{p * Q + q : p}`` (sorted by ``p``, so its sums keep the 1-D
order), and the seq axis of ``p`` is ``{p * Q + q : q}``
(``ClientGroup.seq``, ``ClientGroup.axis("seq")``). At ``Q = 1`` the
numbering is the grid's above, unchanged.

The ``model`` axis (``--model_devices M``, GPT-2's tensor parallelism),
the ``stage`` axis (``--pipeline_devices S``, GPT-2's pipeline,
``parallel/pipeline.py``) and the ``expert`` axis (``--expert_devices E``
with ``--n_experts``, expert parallelism of the MoE blocks) follow the JAX
mesh's axis order ``clients, shard, seq, model, stage, expert``, the last
varying fastest. JAX's ``make_mesh`` reshapes the device list row-major
into that shape, so device ``i`` sits at ``e = i % E``, ``st = (i // E)
% S``, ``m = (i // (E S)) % M``, ``q = (i // (E S M)) % Q`` and ``(c,
s)`` as above from ``i // (Q M S E)``, and its process rank is ``(((p *
Q + q) * M + m) * S + st) * E + e`` (``tuple_index``: ``p`` times the inner
size ``Q M S E`` plus the device's inner index). The axes claim their
devices in JAX's priority ``model > stage > expert > seq > clients``
(``grid_sizes``), each clamp with JAX's warning; the expert axis shrinks
to a divisor of ``--n_experts``. The ranks of one tuple index (all its
seq, model, stage and expert indices) run the same client slots and the
same server step; the server reduce tuple of inner index ``j`` is ``{p *
Q M S E + j : p}``, and the rank's group along ``model`` (``stage``,
``expert``) holds the ranks that differ from it in ``m`` (``st``, ``e``)
alone (``ClientGroup.axis("model")``, ``ClientGroup.axis("stage")``,
``ClientGroup.axis("expert")``). Every rank creates every subgroup, in
one order: the tuples, then the seq, model, stage and expert axes, then
the shard and clients axes.

``mesh_axis_placement``: ``clients`` rides ``dcn`` exactly when the world
spans more than one node (``LOCAL_WORLD_SIZE < WORLD_SIZE``), every other
axis ``ici``; ``COMMEFFICIENT_FORCE_DCN_AXIS=<axis>`` forces one axis to
``dcn``, as in the JAX package. On several nodes the clients axis must
divide by the node count (JAX's multi-host check).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

CLIENTS_AXIS = "clients"
SHARD_AXIS = "shard"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"
# the axes inside a tuple index, in the JAX mesh's order (the last varies
# fastest)
INNER_AXES = (SEQ_AXIS, MODEL_AXIS, STAGE_AXIS, EXPERT_AXIS)


@dataclass(frozen=True)
class ClientGroup:
    """A process group over which the round's client slots are split.
    ``group`` is the torch process group (None: the default group),
    ``rank``/``size`` this process's position in it (on the 2-D grid the
    tuple index ``p`` and ``clients x shard``), ``device`` its device.
    ``active`` is False on a rank outside the group.

    On the 2-D grid ``axes`` holds this rank's group along each server
    reduce axis, in level order (``(("shard", g_s), ("clients", g_c))``;
    ``g.rank`` is this rank's index along that axis); on the 1-D plane it
    is empty and the ``clients`` axis is the group itself. ``placement``
    is ``mesh_axis_placement``'s ``(axis, "ici" | "dcn")`` pairs and
    ``nodes`` the node count of the world. ``seq`` is this rank's group
    along the ``seq`` axis (its ``rank`` the seq index), None without
    one; ``model``, ``stage`` and ``expert`` its groups along those axes
    (None without them); ``backend`` the process group's backend name, fixed
    when the group is built (``parallel/ring.py`` picks its neighbour
    shift by it)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    active: bool = True
    axes: Tuple[Tuple[str, "ClientGroup"], ...] = ()
    placement: Tuple[Tuple[str, str], ...] = ()
    nodes: int = 1
    seq: Optional["ClientGroup"] = None
    backend: str = ""
    model: Optional["ClientGroup"] = None
    expert: Optional["ClientGroup"] = None
    stage: Optional["ClientGroup"] = None

    def slots(self, W: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a round's ``W`` slots."""
        assert W % self.size == 0, (W, self.size)
        per = W // self.size
        return self.rank * per, (self.rank + 1) * per

    def _inner(self):
        """``(axis, group)`` of the seq, model, stage and expert axes this
        rank has, in mesh order."""
        return tuple((name, g) for name, g in zip(
            INNER_AXES, (self.seq, self.model, self.stage, self.expert))
            if g is not None)

    @property
    def inner_size(self) -> int:
        """The ranks of one tuple index: the product of the seq, model,
        stage and expert axes."""
        n = 1
        for _, g in self._inner():
            n *= g.size
        return n

    @property
    def process_rank(self) -> int:
        """This process's rank in the world: ``rank`` times the inner size
        plus its index along the inner axes (row-major)."""
        j = 0
        for _, g in self._inner():
            j = j * g.size + g.rank
        return self.rank * self.inner_size + j

    @property
    def is_main(self) -> bool:
        """Rank 0 of the server reduce tuple, at index 0 of the seq,
        model, stage and expert axes."""
        return self.rank == 0 and all(g.rank == 0 for _, g in self._inner())

    @property
    def server_axes(self):
        """The axis (or ordered axis tuple) the server reduces over:
        ``clients``, or ``("shard", "clients")`` on the 2-D grid (the JAX
        package's ``server_reduce_axes``)."""
        if not self.axes:
            return CLIENTS_AXIS
        return tuple(name for name, _ in self.axes)

    @property
    def axis_sizes(self) -> dict:
        """``{axis: size}`` of the server reduce axes."""
        if not self.axes:
            return {CLIENTS_AXIS: self.size}
        return {name: g.size for name, g in self.axes}

    def axis(self, name: str) -> "ClientGroup":
        """This rank's group along server reduce axis ``name``, or along
        the ``seq``, ``model``, ``stage`` or ``expert`` axis."""
        for ax, g in self._inner():
            if ax == name:
                return g
        if not self.axes and name == CLIENTS_AXIS:
            return self
        for ax, g in self.axes:
            if ax == name:
                return g
        raise KeyError(f"no server reduce axis {name!r} (axes: "
                       f"{self.server_axes})")

    def prefix(self, j: int) -> "ClientGroup":
        """The group over reduce axes ``0..j`` that holds this rank: the
        axes after ``j`` fixed at this rank's indices. It tiles the axes
        first-name-major, as a JAX spec over ``axes[:j + 1]`` does."""
        levels = self.axes or ((CLIENTS_AXIS, self),)
        assert 0 <= j < len(levels), (j, len(levels))
        if j == len(levels) - 1:
            return self
        assert j == 0 and len(levels) == 2, \
            "the port's grid has at most two server reduce axes"
        return levels[0][1]

    def axis_placement(self) -> dict:
        """``{axis: "ici" | "dcn"}`` (``mesh_axis_placement``)."""
        return dict(self.placement) or {CLIENTS_AXIS: "ici"}

    def topology(self) -> dict:
        """The grid for the telemetry ``run_start`` event, in the JAX
        package's ``mesh`` schema: the axes in mesh order (``clients``
        first) with sizes and placements, and the process count."""
        sizes = dict(self.axis_sizes)
        place = self.axis_placement()
        names = [CLIENTS_AXIS] + [a for a in sizes if a != CLIENTS_AXIS]
        for name, g in self._inner():
            names.append(name)
            sizes[name] = g.size
        return {"process_count": int(self.size * self.inner_size),
                "nodes": int(self.nodes),
                "axes": [{"name": a, "size": int(sizes[a]),
                          "placement": place.get(a, "ici")}
                         for a in names]}


class World(NamedTuple):
    """A process's place in the launch: its launcher rank (node-major
    device index), the world size, its local rank and the processes on
    its node, and the rendezvous (None: ``env://``)."""

    rank: int
    size: int
    local_rank: int
    local_size: int
    init_method: Optional[str] = None

    @property
    def nodes(self) -> int:
        return max(1, self.size // max(1, self.local_size))


def world_from_env() -> Optional[World]:
    """This process's ``World`` from ``torchrun``'s environment, else from
    the JAX package's cohort seam (``COMMEFFICIENT_NUM_PROCS`` > 1: one
    process a node, rank ``COMMEFFICIENT_PROC_ID``, the rendezvous
    ``tcp://COMMEFFICIENT_COORDINATOR``), else None. A seam without a
    coordinator raises ``ValueError``, as the JAX package's
    ``maybe_init_distributed`` does."""
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        return World(rank, world, local, local_size)
    n = int(os.environ.get("COMMEFFICIENT_NUM_PROCS", "0") or 0)
    if n <= 1:
        return None
    coord = os.environ.get("COMMEFFICIENT_COORDINATOR", "")
    pid = int(os.environ.get("COMMEFFICIENT_PROC_ID", "0") or 0)
    if not coord:
        raise ValueError(
            "COMMEFFICIENT_NUM_PROCS is set but COMMEFFICIENT_COORDINATOR "
            "is not (expected host:port of process 0's coordinator)")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return World(pid, n, local, 1, f"tcp://{coord}")


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
        rank = env.rank if rank is None else rank
        world_size = env.size if world_size is None else world_size
        if local_rank is None:
            local_rank = env.local_rank
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


def grid_sizes(num_workers: int, num_devices: int = -1,
               shard_devices: int = 1, world: int = 1, seq_devices: int = 1,
               model_devices: int = 1, expert_devices: int = 1,
               n_experts: int = 0, pipeline_devices: int = 1) -> dict:
    """``{axis: size}`` of the grid over ``world`` devices: the JAX
    package's ``default_client_mesh`` policy, its clamps and warnings word
    for word. The axes claim devices in the priority ``model > stage >
    expert > seq > clients``: the model axis ``min(model_devices,
    world)``; the stage axis ``min(pipeline_devices, world // model)``;
    the expert axis next, reduced to a divisor of ``n_experts`` (when it
    is set); the seq axis;
    the shard axis, reduced to a divisor of ``num_workers``; the clients
    axis ``min(num_devices, world // (shard x seq x model x expert))``
    (``num_devices <= 0``: all of it), reduced until ``clients x shard``
    divides ``num_workers``. Keys in mesh order: ``clients``, ``shard``,
    ``seq``, ``model``, ``stage``, ``expert`` (every key present, 1 where
    the grid has no such axis)."""
    n_avail = world
    nm = max(1, min(model_devices, n_avail))
    if model_devices > nm:
        warnings.warn(f"--model_devices {model_devices} reduced to {nm} "
                      f"(only {n_avail} devices available)", stacklevel=2)
    npp = max(1, min(pipeline_devices, n_avail // nm))
    if pipeline_devices > npp:
        warnings.warn(f"--pipeline_devices {pipeline_devices} reduced to "
                      f"{npp} (only {n_avail} devices available)",
                      stacklevel=2)
    ne = max(1, min(expert_devices, n_avail // (nm * npp)))
    if n_experts > 0:
        # the expert axis must divide the expert count (the slice is E/ne)
        while n_experts % ne:
            ne -= 1
    if expert_devices > ne:
        warnings.warn(f"--expert_devices {expert_devices} reduced to "
                      f"{ne} (only {n_avail} devices available"
                      + (f"; must divide --n_experts {n_experts}"
                         if n_experts > 0 else "") + ")",
                      stacklevel=2)
    ns = max(1, min(seq_devices, n_avail // (nm * npp * ne)))
    if seq_devices > ns:
        warnings.warn(f"--seq_devices {seq_devices} reduced to {ns} "
                      f"(only {n_avail} devices available; {nm} model x "
                      f"{npp} stage x {ne} expert device(s) claimed first — "
                      f"axis priority model > stage > expert > seq)",
                      stacklevel=2)
    nsh = max(1, min(shard_devices, n_avail // (ns * nm * npp * ne)))
    while num_workers % nsh:
        nsh -= 1
    if shard_devices > nsh:
        warnings.warn(f"--shard_devices {shard_devices} reduced to {nsh} "
                      f"(must divide num_workers={num_workers}; "
                      f"{n_avail} devices available, {ns * nm * npp * ne} "
                      f"claimed by seq/model/stage/expert)", stacklevel=2)
    requested = num_devices if num_devices and num_devices > 0 \
        else n_avail
    n = max(1, min(requested, n_avail // (nsh * ns * nm * npp * ne)))
    while num_workers % (n * nsh):
        n -= 1
    if 0 < num_devices != n and num_devices != n * nsh * ns * nm * npp * ne:
        warnings.warn(
            f"--num_devices {num_devices} reduced to {n} on the clients axis "
            f"(must divide num_workers={num_workers}; {nsh} shard x {ns} seq "
            f"x {nm} model x {npp} stage x {ne} expert device(s) per client "
            f"shard; {n_avail} available devices)",
            stacklevel=2)
    return {CLIENTS_AXIS: n, SHARD_AXIS: nsh, SEQ_AXIS: ns, MODEL_AXIS: nm,
            STAGE_AXIS: npp, EXPERT_AXIS: ne}


def grid_axes(num_workers: int, num_devices: int = -1,
              shard_devices: int = 1, world: int = 1,
              seq_devices: int = 1) -> Tuple[int, int, int]:
    """``(n_clients, n_shard, n_seq)`` of ``grid_sizes`` without the model,
    stage and expert axes."""
    sizes = grid_sizes(num_workers, num_devices, shard_devices, world,
                       seq_devices)
    return sizes[CLIENTS_AXIS], sizes[SHARD_AXIS], sizes[SEQ_AXIS]


def grid_shape(num_workers: int, num_devices: int = -1,
               shard_devices: int = 1, world: int = 1,
               seq_devices: int = 1) -> Tuple[int, int]:
    """``(n_clients, n_shard)``: the server reduce axes of ``grid_axes``."""
    nc, nsh, _ = grid_axes(num_workers, num_devices, shard_devices, world,
                           seq_devices)
    return nc, nsh


def client_group_size(num_workers: int, num_devices: int, world: int) -> int:
    """The clients axis of the 1-D plane (``grid_shape`` with one shard)."""
    return grid_shape(num_workers, num_devices, 1, world)[0]


def tuple_index(device_index: int, n_clients: int, n_shard: int,
                n_seq: int = 1, n_model: int = 1, n_expert: int = 1,
                n_stage: int = 1) -> int:
    """The process rank ``p * I + j`` of the device at inner index ``j =
    i % I`` (``I = n_seq * n_model * n_stage * n_expert``: ``j = ((q *
    n_model + m) * n_stage + st) * n_expert + e``, the JAX mesh's
    row-major order of its minor axes), ``c = (i // I) // n_shard``, ``s =
    (i // I) % n_shard``, where ``p = s * n_clients + c`` is its index in
    the server reduce tuple (``p`` itself when ``I = 1``); a device past
    the grid keeps its index."""
    inner = n_seq * n_model * n_stage * n_expert
    if device_index >= n_clients * n_shard * inner:
        return device_index
    j, q = divmod(device_index, inner)
    c, s = divmod(j, n_shard)
    return (s * n_clients + c) * inner + q


def mesh_axis_placement(n_shard: int = 1, nodes: int = 1) -> dict:
    """``{axis: "ici" | "dcn"}``: ``clients`` is ``dcn`` when the world
    spans more than one node, every other axis ``ici``;
    ``COMMEFFICIENT_FORCE_DCN_AXIS=<axis>`` forces that axis to ``dcn``
    (the seam a one-node run uses to exercise the ``dcn`` legs)."""
    placement = {CLIENTS_AXIS: "dcn" if nodes > 1 else "ici"}
    if n_shard > 1:
        placement[SHARD_AXIS] = "ici"
    forced = os.environ.get("COMMEFFICIENT_FORCE_DCN_AXIS", "")
    if forced and forced in placement:
        placement[forced] = "dcn"
    return placement


def make_client_group(num_workers: int, num_devices: int = -1,
                      device: Optional[torch.device] = None,
                      shard_devices: int = 1, nodes: int = 1,
                      seq_devices: int = 1, model_devices: int = 1,
                      expert_devices: int = 1, n_experts: int = 0,
                      pipeline_devices: int = 1) -> Optional[ClientGroup]:
    """The client grid of a running process group whose ranks are
    numbered by ``tuple_index``, or None when none is initialized (the
    single-device round). Every rank must call it: a grid smaller than
    the world is a new subgroup of the first ``N`` ranks, the axis
    subgroups (and, with inner axes, each inner index's server reduce
    tuple and each tuple index's seq, model, stage and expert axes) are new
    groups, and the ranks past the grid get ``active=False``. ``nodes``:
    the world's node count (placement and the multi-node check)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    rank = dist.get_rank()
    sizes = grid_sizes(num_workers, num_devices, shard_devices, world,
                       seq_devices, model_devices, expert_devices, n_experts,
                       pipeline_devices)
    nc, nsh = sizes[CLIENTS_AXIS], sizes[SHARD_AXIS]
    dims = [sizes[a] for a in INNER_AXES]   # (Q, M, S, E)
    inner = int(np.prod(dims))
    n = nc * nsh
    total = n * inner
    if nodes > 1 and total == world and nc % nodes:
        raise ValueError(
            f"multi-node grid: the clients axis clients={nc} must be "
            f"divisible by the node count {nodes}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    backend = dist.get_backend()
    placement = tuple(mesh_axis_placement(nsh, nodes).items())
    active = rank < total
    p, j = divmod(rank, inner) if active else (rank, 0)

    def rank_of(pp: int, jj: int) -> int:
        return pp * inner + jj

    def unravel(jj: int):
        return [int(v) for v in np.unravel_index(jj, dims)]

    def ravel(idx) -> int:
        return int(np.ravel_multi_index(idx, dims))

    # every rank creates every group, in one order
    group = None
    if inner == 1:
        group = None if n == world else dist.new_group(list(range(n)))
    else:
        tuples = [dist.new_group([rank_of(pp, jj) for pp in range(n)])
                  for jj in range(inner)]
        group = tuples[j] if active else None
    inner_groups = {}
    for k, name in enumerate(INNER_AXES):
        if dims[k] == 1:
            continue
        # the groups along axis k: one for each tuple index and each
        # index of the other inner axes, in rank order
        made = {}
        for pp in range(n):
            for jj in range(inner):
                idx = unravel(jj)
                if idx[k]:
                    continue
                members = []
                for v in range(dims[k]):
                    idx[k] = v
                    members.append(rank_of(pp, ravel(idx)))
                made[(pp, jj)] = dist.new_group(members)
        if active:
            idx = unravel(j)
            pos = idx[k]
            idx[k] = 0
            inner_groups[name] = ClientGroup(made[(p, ravel(idx))], pos,
                                             dims[k], device,
                                             backend=backend)
    axes = ()
    if nsh > 1:
        shard_groups = [[dist.new_group([rank_of(s * nc + c, jj)
                                         for s in range(nsh)])
                         for c in range(nc)] for jj in range(inner)]
        client_groups = [[dist.new_group([rank_of(s * nc + c, jj)
                                          for c in range(nc)])
                          for s in range(nsh)] for jj in range(inner)]
        if active:
            s, c = divmod(p, nc)
            axes = ((SHARD_AXIS, ClientGroup(shard_groups[j][c], s, nsh,
                                             device, backend=backend)),
                    (CLIENTS_AXIS, ClientGroup(client_groups[j][s], c, nc,
                                               device, backend=backend)))
    return ClientGroup(group, p, n, device, active=active, axes=axes,
                       placement=placement, nodes=nodes,
                       seq=inner_groups.get(SEQ_AXIS), backend=backend,
                       model=inner_groups.get(MODEL_AXIS),
                       expert=inner_groups.get(EXPERT_AXIS),
                       stage=inner_groups.get(STAGE_AXIS))


def requested_seq_devices(args) -> int:
    """``--seq_devices`` under ``--seq_parallel ring|ulysses``, else 1."""
    if getattr(args, "seq_parallel", "none") == "none":
        return 1
    return int(getattr(args, "seq_devices", 1) or 1)


def requested_axes(args) -> dict:
    """The inner axes an entry point asks the grid for: ``seq_devices``
    (``requested_seq_devices``), ``model_devices`` (``--model_devices``),
    ``pipeline_devices`` (``--pipeline_devices``), ``expert_devices``
    (``--expert_devices`` when ``--n_experts`` is set, else 1, as the JAX
    package's ``gpt2_train`` asks) and ``n_experts``: the keywords of
    ``grid_sizes`` and ``make_client_group``."""
    n_experts = int(getattr(args, "n_experts", 0) or 0)
    return {"seq_devices": requested_seq_devices(args),
            "model_devices": int(getattr(args, "model_devices", 1) or 1),
            "pipeline_devices": int(getattr(args, "pipeline_devices", 1)
                                    or 1),
            "expert_devices": (int(getattr(args, "expert_devices", 1) or 1)
                               if n_experts else 1),
            "n_experts": n_experts}


def start_client_group(args, init_method: Optional[str] = None,
                       backend: Optional[str] = None
                       ) -> Optional[ClientGroup]:
    """An entry point's grid: under ``torchrun`` or the cohort seam
    (``world_from_env``) the process group on ``args.device``
    (``cuda:LOCAL_RANK`` with NCCL, or gloo on the CPU, unless the caller
    names ``backend``; ``init_method`` defaults to the launch's
    rendezvous), numbered by ``tuple_index``, and its grid (with the
    ``seq``, ``model``, ``stage`` and ``expert`` axes it asks for,
    ``requested_axes``);
    else None (one device)."""
    env = world_from_env()
    if env is None:
        return None
    shard = int(getattr(args, "shard_devices", 1) or 1)
    inner = requested_axes(args)
    with warnings.catch_warnings():
        # make_client_group warns once the group is up
        warnings.simplefilter("ignore")
        sizes = grid_sizes(args.num_workers, args.num_devices, shard,
                           env.size, **inner)
    device = init_distributed(
        args.device, backend=backend,
        init_method=init_method or env.init_method,
        rank=tuple_index(env.rank, sizes[CLIENTS_AXIS], sizes[SHARD_AXIS],
                         n_seq=sizes[SEQ_AXIS], n_model=sizes[MODEL_AXIS],
                         n_stage=sizes[STAGE_AXIS],
                         n_expert=sizes[EXPERT_AXIS]),
        world_size=env.size, local_rank=env.local_rank)
    return make_client_group(args.num_workers, args.num_devices, device,
                             shard_devices=shard, nodes=env.nodes, **inner)


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
